"""The port's model zip against the JAX package's, both ways, on the CPU.

- Configs: for six zoo models the port's `to_json()` is the JAX package's
  text, and each side's `from_json` reads the other's back to the same
  text. Every ported conf class has the JAX class's field names in the
  same order (this pins the `dist` and `max_num_line_search_iterations`
  repairs).
- Weights: a zip JAX's ModelSerializer writes in the test restores in the
  port, and one the port writes restores in JAX, with outputs equal to
  the writer's (float32, rtol 1e-5, atol 1e-6), for a MultiLayerNetwork
  and a ComputationGraph; the two zips hold the same entries, the same
  configuration text and the same arrays.
- Updater state (`updaterState.bin`, optax's `tree_leaves` order): JAX
  trains 3 steps and saves; both packages restore it and train 2 more, and
  their parameters agree within the Adam-rounding tolerance of
  test_torch_train.py (rtol 1e-4, atol 1e-5); the same the other way
  round; a 12-layer network pins the key order ("10" before "2").
- The committed zips: `regression_r3_mln.zip` (flat_head exact, pred
  within rtol 1e-5, Adam moments restored, ModelGuesser) and the
  pretrained LeNet on the 500 t10k images of the real-digit fixture
  (argmax exact, probabilities within rtol 1e-4).
- Refusals: a dtype other than float32,
  and the conf types JAX registers and the port lacks raise
  NotImplementedError.
"""
import dataclasses
import gzip
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import configuration as JC
from deeplearning4j_tpu.nn.conf import graph_configuration as JG
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer, _flatten_tree)
from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import configuration as TC
from deeplearning4j_tpu_torch.nn.conf import graph_configuration as TG
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import (ModelGuesser,
                                                            ModelSerializer)
from deeplearning4j_tpu_torch.util.params import params_to_flat

from torch_port_pairs import pair, pair_of

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)

ZOO = {"transformer_lm": dict(vocab_size=11, d_model=32, n_layers=2,
                              n_heads=2, use_pallas=True),
       "resnet50": dict(num_classes=10, image_size=32),
       "lenet_mnist": {}, "mlp_mnist": {}, "cifar_convnet": {},
       "char_rnn_lstm": {}}


def _conf_cls(text):
    graph = "ComputationGraph" in json.loads(text)["format"]
    return (TG.ComputationGraphConfiguration if graph
            else TC.MultiLayerConfiguration,
            JG.ComputationGraphConfiguration if graph
            else JC.MultiLayerConfiguration)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_config_json_is_jaxs_and_reads_both_ways(name):
    jtext = getattr(jzoo, name)(**ZOO[name]).conf.to_json()
    ttext = getattr(zoo, name)(**ZOO[name], device="cpu").conf.to_json()
    assert ttext == jtext
    tcls, jcls = _conf_cls(jtext)
    assert json.loads(tcls.from_json(jtext).to_json()) == json.loads(jtext)
    assert json.loads(jcls.from_json(ttext).to_json()) == json.loads(ttext)


def _conf_classes():
    pairs = [(JL._LAYER_REGISTRY[n], TL._LAYER_REGISTRY[n])
             for n in TL._LAYER_REGISTRY]
    pairs += [(JU._UPDATER_REGISTRY[n], TU._UPDATER_REGISTRY[n])
              for n in TU._UPDATER_REGISTRY]
    pairs += [(JC.MultiLayerConfiguration, TC.MultiLayerConfiguration),
              (JG.ComputationGraphConfiguration,
               TG.ComputationGraphConfiguration),
              (JG.GraphVertexSpec, TG.GraphVertexSpec)]
    return pairs


@pytest.mark.parametrize("jcls,tcls", _conf_classes(),
                         ids=lambda c: c.__name__)
def test_conf_classes_have_jaxs_fields(jcls, tcls):
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]


def test_dist_and_line_search_fields_serialize():
    lc = TL.DenseLayer(n_out=3, dist={"type": "normal", "std": 0.5})
    assert TL.layer_conf_from_dict(lc.to_dict()).dist == lc.dist
    assert "dist" in TL._INHERITED
    gconf = TG.ComputationGraphConfiguration(
        max_num_line_search_iterations=9)
    assert gconf.to_dict()["max_num_line_search_iterations"] == 9
    jconf = JG.ComputationGraphConfiguration.from_json(gconf.to_json())
    assert jconf.max_num_line_search_iterations == 9
    with pytest.raises(NotImplementedError, match="distribution"):
        MultiLayerNetwork(
            TC.NeuralNetConfiguration.builder().weight_init("distribution")
            .list().layer(TL.OutputLayer(n_in=2, n_out=2)).build(),
            device="cpu").init()


# ----------------------------------------------------------------- weights
def _cnn_conf(NC, L, IT, U):
    """The regression zip's shape of network: conv, pool, batch norm,
    dense, softmax output (a CnnToFeedForward in front of the dense). The
    convolution has no bias: batch norm would take its gradient to
    rounding noise, on which Adam's steps depend on the rounding."""
    return (NC.builder().seed(99).updater(U.Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(kernel_size=(3, 3), n_out=4,
                                      activation="relu",
                                      convolution_mode="same",
                                      has_bias=False))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.BatchNormalization())
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .input_type(IT.convolutional(6, 6, 1)).build())


def _cnn_pair():
    tnet = MultiLayerNetwork(_cnn_conf(TC.NeuralNetConfiguration, TL,
                                       InputType, TU), device="cpu")
    jnet = JMultiLayerNetwork(_cnn_conf(JC.NeuralNetConfiguration, JL,
                                        JInputType, JU))
    return pair_of(tnet, jnet, seed=5)


def _cnn_batch(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 6, 6, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _lm_batch(n=3, t=7, v=11, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(v, dtype=np.float32)
    ids = rng.integers(0, v, (n, t + 1))
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


MODELS = {"mln": (_cnn_pair, _cnn_batch),
          "graph": (lambda: pair("transformer_lm", seed=2,
                                 **ZOO["transformer_lm"]), _lm_batch)}


def _entries(path):
    """{entry: bytes or {array key: array}} of a zip: .bin entries as
    their arrays (np.savez stamps its members, so not as bytes)."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for n in zf.namelist():
            data = zf.read(n)
            if n.endswith(".bin"):
                npz = np.load(io.BytesIO(data))
                data = {k: npz[k] for k in npz.files}
            out[n] = data
    return out


def _states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_zips_cross_both_ways(kind, tmp_path):
    make, batch = MODELS[kind]
    jnet, tnet = make()
    x, y = batch()
    # one step each so every entry, the updater's too, holds non-zeros
    jnet.fit_batch(JDataSet(x, y))
    tnet.fit_batch(DataSet(x, y))
    jzip, tzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    JSerializer.write_model(jnet, str(jzip))
    ModelSerializer.write_model(tnet, str(tzip))

    t_from_j = ModelSerializer.restore(str(jzip), device="cpu")
    np.testing.assert_allclose(t_from_j.output(x).numpy(),
                               np.asarray(jnet.output(x)), **OUT_TOL)
    j_from_t = JSerializer.restore(str(tzip))
    np.testing.assert_allclose(np.asarray(j_from_t.output(x)),
                               tnet.output(x).numpy(), **OUT_TOL)

    je, te = _entries(jzip), _entries(tzip)
    assert list(je) == list(te)
    assert te["configuration.json"] == je["configuration.json"]
    assert te["format.json"] == je["format.json"]
    for name in ("coefficients.bin", "state.bin", "updaterState.bin"):
        assert sorted(te[name]) == sorted(je[name]), name
        for k in je[name]:
            assert te[name][k].shape == je[name][k].shape, (name, k)
            assert te[name][k].dtype == je[name][k].dtype, (name, k)
    # a zip restores to the arrays it holds, in either package
    _states_equal(params_to_flat(t_from_j), _flatten_tree(jnet.params))
    _states_equal(_flatten_tree(j_from_t.params), params_to_flat(tnet))


def _train(net, ds_cls, x, y, steps):
    for _ in range(steps):
        net.fit_batch(ds_cls(x, y))


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_updater_state_continues_training_alike(kind, writer, tmp_path):
    """The writer trains 3 steps and saves; JAX and the port each restore
    the zip and train 2 more steps; their parameters agree."""
    make, batch = MODELS[kind]
    jnet, tnet = make()
    x, y = batch()
    path = str(tmp_path / "m.zip")
    if writer == "jax":
        _train(jnet, JDataSet, x, y, 3)
        JSerializer.write_model(jnet, path)
    else:
        _train(tnet, DataSet, x, y, 3)
        ModelSerializer.write_model(tnet, path)
    j2 = JSerializer.restore(path)
    t2 = ModelSerializer.restore(path, device="cpu")
    assert t2._optimizer.count == 3
    _train(j2, JDataSet, x, y, 2)
    _train(t2, DataSet, x, y, 2)
    want, got = _flatten_tree(j2.params), params_to_flat(t2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TRAIN_TOL, err_msg=k)


def _deep_conf(NC, L, IT, U, updater):
    b = NC.builder().seed(7).updater(updater).list()
    for _ in range(11):
        b.layer(L.DenseLayer(n_out=4, activation="tanh"))
    b.layer(L.OutputLayer(n_out=3, activation="softmax"))
    return b.input_type(IT.feed_forward(5)).build()


@pytest.mark.parametrize("upd", ["Adam", "Nesterovs", "Sgd"])
def test_twelve_layer_leaf_order_is_optaxs(upd, tmp_path):
    """Twelve layers "0".."11": optax's leaves walk the layer dict in
    sorted string order ("10" and "11" before "2"); the port's leaves
    equal JAX's leaf for leaf, in both directions."""
    kw = {"Adam": dict(learning_rate=1e-2),
          "Nesterovs": dict(learning_rate=1e-2, momentum=0.9),
          "Sgd": dict(learning_rate=0.1)}[upd]
    tnet = MultiLayerNetwork(_deep_conf(
        TC.NeuralNetConfiguration, TL, InputType, TU,
        getattr(TU, upd)(**kw)), device="cpu")
    jnet = JMultiLayerNetwork(_deep_conf(
        JC.NeuralNetConfiguration, JL, JInputType, JU,
        getattr(JU, upd)(**kw)))
    jnet, tnet = pair_of(tnet, jnet, seed=1)
    rng = np.random.default_rng(0)
    x = rng.random((4, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    _train(jnet, JDataSet, x, y, 2)
    _train(tnet, DataSet, x, y, 2)
    import jax
    jleaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(
        jnet.opt_state)]
    tleaves = TU.opt_state_leaves(tnet)
    assert len(tleaves) == len(jleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, **TRAIN_TOL, err_msg=f"leaf{i}")
    path = str(tmp_path / "deep.zip")
    JSerializer.write_model(jnet, path)
    back = ModelSerializer.restore(path, device="cpu")
    for i, (a, b) in enumerate(zip(TU.opt_state_leaves(back), jleaves)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf{i}")
    ModelSerializer.write_model(tnet, path)
    jback = JSerializer.restore(path)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(
            jback.opt_state), tleaves)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"leaf{i}")


# -------------------------------------------------------- committed zips
def test_regression_zip_restores_in_the_port():
    path = str(FIX / "regression_r3_mln.zip")
    net = ModelSerializer.restore(path, device="cpu")
    exp = np.load(FIX / "regression_r3_expected.npz")
    np.testing.assert_array_equal(net.get_flat_params()[:32],
                                  exp["flat_head"])
    np.testing.assert_allclose(net.output(exp["x"]).numpy(), exp["pred"],
                               rtol=1e-5, atol=1e-6)
    moments = [a for a in TU.opt_state_leaves(net) if a.size > 1]
    assert any(float(np.abs(m).max()) > 0 for m in moments)
    with zipfile.ZipFile(path) as zf:
        npz = np.load(io.BytesIO(zf.read("updaterState.bin")))
        stored = [npz[f"leaf{i}"] for i in range(len(npz.files))]
    for i, (a, b) in enumerate(zip(TU.opt_state_leaves(net), stored)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf{i}")
    assert type(ModelGuesser.load_model_guess(
        path, device="cpu")).__name__ == "MultiLayerNetwork"
    assert "remat" not in json.loads(zipfile.ZipFile(path).read(
        "configuration.json"))
    assert net.conf.remat is None


def t10k_images():
    """The real-digit fixture's t10k images [n, 28, 28, 1] in [0, 1] and
    labels, read with gzip and numpy (the idx layout: a 16-byte header
    for images, 8 bytes for labels)."""
    d = FIX / "mnist_real"
    img = gzip.open(d / "t10k-images-idx3-ubyte.gz").read()
    n, h, w = np.frombuffer(img[4:16], ">i4")
    x = np.frombuffer(img[16:], np.uint8).reshape(n, h, w, 1)
    lab = gzip.open(d / "t10k-labels-idx1-ubyte.gz").read()
    return (x.astype(np.float32) / 255.0,
            np.frombuffer(lab[8:], np.uint8).astype(np.int64))


def test_pretrained_lenet_matches_jax():
    from deeplearning4j_tpu.zoo import load_pretrained as jload
    from deeplearning4j_tpu_torch.zoo import (available_pretrained,
                                              load_pretrained)
    assert "lenet_mnist_real" in available_pretrained()
    tnet, labels = load_pretrained("lenet_mnist_real", device="cpu")
    jnet, _ = jload("lenet_mnist_real")
    x, truth = t10k_images()
    assert len(x) == 500
    got, want = tnet.output(x).numpy(), np.asarray(jnet.output(x))
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    decoded = labels.decode_predictions(got[:3], top=2)
    assert [d[0][0] for d in decoded] == \
        [f"digit {i}" for i in got[:3].argmax(1)]
    assert (got.argmax(1) == truth).mean() >= 0.95
    with pytest.raises(FileNotFoundError, match="PRETRAINED_DIR"):
        load_pretrained("vgg16_imagenet", device="cpu")


# -------------------------------------------------------------- refusals
def _rewrite(src, dst, extra=None, fmt=None):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for n in zin.namelist():
            data = zin.read(n)
            if n == "format.json" and fmt:
                data = json.dumps({**json.loads(data), **fmt})
            zout.writestr(n, data)
        for n, data in (extra or {}).items():
            zout.writestr(n, data)


def test_normalizer_and_other_dtypes_are_refused(tmp_path):
    """A zip's normalizer is ported (tests/test_torch_normalizer.py holds
    it against the JAX package); a dtype other than float32 is still
    refused."""
    from deeplearning4j_tpu_torch.etl import NormalizerStandardize
    src = FIX / "regression_r3_mln.zip"
    raw = np.random.default_rng(5).normal(3.0, 2.0, (32, 4))
    nz = NormalizerStandardize().fit(DataSet(raw, raw))
    norm = tmp_path / "norm.zip"
    _rewrite(src, norm, extra={"normalizer.json": nz.to_json()})
    assert ModelSerializer.restore(str(norm), device="cpu") is not None
    assert ModelSerializer.restore_normalizer(str(norm)).to_json() == \
        nz.to_json()
    assert ModelSerializer.restore_normalizer(str(src)) is None
    half = tmp_path / "half.zip"
    _rewrite(src, half, fmt={"dtype": "float16"})
    with pytest.raises(NotImplementedError, match="float16"):
        ModelSerializer.restore(str(half), device="cpu")
    net = ModelSerializer.restore(str(src), device="cpu")
    ModelSerializer.write_model(net, str(tmp_path / "n.zip"), normalizer=nz)
    assert ModelSerializer.restore_normalizer(
        str(tmp_path / "n.zip")).to_json() == nz.to_json()
    plain = tmp_path / "plain.zip"
    plain.write_bytes(src.read_bytes())
    ModelSerializer.add_normalizer(str(plain), nz)
    ModelSerializer.add_normalizer(str(plain), nz)     # replaced, not twice
    with zipfile.ZipFile(plain) as zf:
        assert zf.namelist().count("normalizer.json") == 1
    assert ModelSerializer.restore_normalizer(str(plain)).to_json() == \
        nz.to_json()


@pytest.mark.parametrize("d,fn", [
    ({"type": "EmbeddingLayer", "n_in": 3, "n_out": 2},
     TL.layer_conf_from_dict),
    ({"type": "RmsProp"}, TU.updater_from_dict),
    ({"type": "MergeVertex"}, TG.vertex_from_dict),
    ({"type": "ZeroMeanPrePreProcessor"}, TP.preprocessor_from_dict)],
    ids=["layer", "updater", "vertex", "preprocessor"])
def test_unported_conf_types_raise(d, fn):
    with pytest.raises(NotImplementedError, match="not ported"):
        fn(d)
