"""The port's normalizers, their zip entry and /predict against the JAX
package's, on the CPU.

- `NormalizerStandardize` / `NormalizerMinMaxScaler` fitted on the same
  data (one DataSet, or streamed batch by batch through an iterator)
  give JAX's `to_json` text exactly, both ways round; `transform`,
  `revert`, `revert_labels` and `device_stats` are JAX's bit for bit
  (both are host numpy). `lower_normalizer` on a CPU tensor is within
  float32 rounding of the host formula (rtol 1e-6, atol 1e-6).
- A zip with `normalizer.json` written by either package loads in the
  other with its normalizer.
- /predict of a zip with a normalizer, from a scan_dir: the port's
  answers equal the JAX server's (rtol 1e-5, atol 1e-6), equal
  `output(transform(x))`, and differ from the raw forward; a
  `fit_labels` normalizer's served outputs are reverted; an integer-typed
  request is normalized in float32 (JAX test_serving.py:866-980).
"""
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JList
from deeplearning4j_tpu.etl import normalizer as jn
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.serving import ServingServer as JServingServer
from deeplearning4j_tpu.serving.registry import \
    ModelRegistry as JModelRegistry
from deeplearning4j_tpu.util.model_serializer import \
    ModelSerializer as JSerializer

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterator.base import \
    ListDataSetIterator
from deeplearning4j_tpu_torch.etl import device_transform as dt
from deeplearning4j_tpu_torch.etl import normalizer as tn
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.multilayer.network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import ServingServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util.http import request_json
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

from torch_port_pairs import pair_of

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _raw(n=64, f=6, seed=7, labels=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(50.0, 20.0, size=(n, f)).astype(np.float32)
    x[:, 2] = 4.0                              # a constant column
    y = (x.sum(1, keepdims=True) * 10 + 500).astype(np.float32)
    return x, np.repeat(y, labels, axis=1)


KINDS = {
    "standardize": lambda m, **kw: m.NormalizerStandardize(**kw),
    "min_max": lambda m, **kw: m.NormalizerMinMaxScaler(**kw),
    "min_max_range": lambda m, **kw: m.NormalizerMinMaxScaler(
        lo=-1.0, hi=2.0, **kw),
}


def _fitted(kind, streamed, fit_labels):
    x, y = _raw()
    j = KINDS[kind](jn, fit_labels=fit_labels)
    t = KINDS[kind](tn, fit_labels=fit_labels)
    if streamed:
        j.fit(JList(JDataSet(x, y).batch_by(10)))
        t.fit(ListDataSetIterator(DataSet(x, y).batch_by(10)))
    else:
        j.fit(JDataSet(x, y))
        t.fit(DataSet(torch.from_numpy(x), torch.from_numpy(y)))
    return j, t


@pytest.mark.parametrize("fit_labels", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_normalizer_matches_jax(kind, streamed, fit_labels):
    j, t = _fitted(kind, streamed, fit_labels)
    assert t.to_json() == j.to_json()
    assert tn.DataNormalizer.from_json(j.to_json()).to_json() == j.to_json()
    assert jn.DataNormalizer.from_json(t.to_json()).to_json() == t.to_json()
    x, y = _raw(n=9, seed=8)
    jt, tt = j.transform(JDataSet(x, y)), t.transform(DataSet(x, y))
    np.testing.assert_array_equal(tt.features, jt.features)
    np.testing.assert_array_equal(tt.labels, jt.labels)
    jr, tr = j.revert(jt), t.revert(tt)
    np.testing.assert_array_equal(tr.features, jr.features)
    np.testing.assert_array_equal(t.revert_labels(y), j.revert_labels(y))
    np.testing.assert_array_equal(t.transform_features(torch.from_numpy(x)),
                                  j.transform_features(x))
    for labels in ((False, True) if fit_labels else (False,)):
        for a, b in zip(t.device_stats(labels), j.device_stats(labels)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", list(KINDS))
def test_lower_normalizer_is_the_host_formula(kind):
    _, t = _fitted(kind, False, True)
    x, y = _raw(n=9, seed=9)
    apply, revert = dt.lower_normalizer(t, device="cpu")
    got = apply(x.astype(np.int64))          # integer input, float32 out
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               t.transform_features(x.astype(np.int64)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(revert(got).numpy(),
                               x.astype(np.int64).astype(np.float32),
                               rtol=1e-5, atol=1e-3)
    lapply, _ = dt.lower_normalizer(t, labels=True, device="cpu")
    np.testing.assert_allclose(lapply(torch.from_numpy(y)).numpy(),
                               t.transform(DataSet(x, y)).labels,
                               rtol=1e-6, atol=1e-6)


def test_lower_normalizer_defaults_to_the_card():
    """Like every entry point of the port, `lower_normalizer` places its
    stats on the card unless the caller passes `device="cpu"`; without a
    visible card the default raises instead of running on the host."""
    _, t = _fitted("standardize", False, False)
    x, _ = _raw(n=3, seed=3)
    apply, revert = dt.lower_normalizer(t, device="cpu")
    assert apply(x).device.type == "cpu" and revert(x).device.type == "cpu"
    if torch.cuda.is_available():
        apply, revert = dt.lower_normalizer(t)
        assert apply(x).device.type == "cuda"
        assert revert(x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dt.lower_normalizer(t)


def test_registry_lowers_the_normalizer_at_registration():
    """A version's normalizer is lowered once, on its model's device, when
    it is registered: an unfitted one is refused there, not on every
    batch, and a fitted one runs as torch ops on the model's device."""
    _, t = _fitted("standardize", False, False)
    x, _ = _raw(n=4, seed=4)

    class OnHost:
        device = torch.device("cpu")

    reg = ModelRegistry(device="cpu")
    with pytest.raises(RuntimeError, match="not fitted"):
        reg.register("raw", OnHost(), transform=tn.NormalizerStandardize())
    assert [v["version"] for v in reg.versions()] == []
    reg.register("v1", OnHost(), transform=t)
    got = reg.get("v1").transform_features_device(x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), t.transform_features(x),
                               rtol=1e-6, atol=1e-6)


def test_unfitted_normalizer_raises_like_jax():
    for m in (jn, tn):
        with pytest.raises(RuntimeError, match="not fitted"):
            m.NormalizerStandardize().transform_features(np.zeros((1, 2)))
    with pytest.raises(ValueError, match="unknown normalizer"):
        tn.DataNormalizer.from_json(json.dumps({"kind": "nope"}))


def _conf(NC, L, IT, seed=0):
    return (NC.builder().seed(seed).list()
            .layer(L.DenseLayer(n_out=8, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax"))
            .input_type(IT.feed_forward(6)).build())


def _net_pair(seed=0):
    return pair_of(MultiLayerNetwork(_conf(NeuralNetConfiguration, TL,
                                           InputType, seed), device="cpu"),
                   JMLN(_conf(JNC, JL, JInputType, seed)), seed=seed)


def test_zip_normalizer_crosses_both_ways(tmp_path):
    jnet, tnet = _net_pair()
    j, t = _fitted("standardize", True, False)
    JSerializer.write_model(jnet, str(tmp_path / "j.zip"), normalizer=j)
    ModelSerializer.write_model(tnet, str(tmp_path / "t.zip"), normalizer=t)
    assert ModelSerializer.restore_normalizer(
        str(tmp_path / "j.zip")).to_json() == j.to_json()
    assert JSerializer.restore_normalizer(
        str(tmp_path / "t.zip")).to_json() == t.to_json()
    back = ModelSerializer.restore(str(tmp_path / "j.zip"), device="cpu")
    x = _raw(n=4, seed=3)[0]
    np.testing.assert_allclose(back.output(t.transform_features(x)).numpy(),
                               np.asarray(jnet.output(
                                   j.transform_features(x))), **TOL)
    JSerializer.add_normalizer(str(tmp_path / "t.zip"),
                               jn.NormalizerMinMaxScaler().fit(
                                   JDataSet(x, x)))
    assert ModelSerializer.restore_normalizer(
        str(tmp_path / "t.zip")).to_dict()["kind"] == "min_max"


def test_predict_applies_the_zip_normalizer_like_jax(tmp_path):
    jnet, tnet = _net_pair()
    j, t = _fitted("standardize", False, False)
    JSerializer.write_model(jnet, str(tmp_path / "norm.zip"), normalizer=j)
    JSerializer.write_model(jnet, str(tmp_path / "raw.zip"))
    jsrv = JServingServer(scan_dir=str(tmp_path)).start()
    tsrv = ServingServer(scan_dir=str(tmp_path), device="cpu").start()
    x = _raw(n=3, seed=11)[0]
    try:
        infos = {m["version"]: m["normalizer"]
                 for m in request_json(tsrv.url + "/models", None, 10)[1]
                 ["models"]}
        assert infos == {"norm": "NormalizerStandardize", "raw": None}
        bodies = {}
        for version in ("norm", "raw"):
            for key, srv in (("jax", jsrv), ("port", tsrv)):
                assert request_json(srv.url + "/deploy",
                                    {"version": version}, 60)[0] == 200
                status, body = request_json(srv.url + "/predict",
                                            {"data": x.tolist()}, 60)
                assert status == 200
                bodies[key, version] = np.asarray(body["prediction"])
        for version in ("norm", "raw"):
            np.testing.assert_allclose(bodies["port", version],
                                       bodies["jax", version], **TOL)
        want = tnet.output(t.transform_features(x)).numpy()
        np.testing.assert_allclose(bodies["port", "norm"], want, **TOL)
        assert not np.allclose(bodies["port", "norm"],
                               bodies["port", "raw"], atol=1e-3)
        # the observed key is the post-transform batch: float32
        assert (((6,), "float32"), 4) in tsrv.batcher.observed
    finally:
        jsrv.stop()
        tsrv.stop()


def test_integer_request_is_normalized_in_float32_like_jax(tmp_path):
    jnet, tnet = _net_pair(seed=1)
    raw = np.arange(60, dtype=np.float32).reshape(10, 6) * 7 + 3
    j = jn.NormalizerStandardize().fit(JDataSet(raw, raw))
    t = tn.NormalizerStandardize().fit(DataSet(raw, raw))
    JSerializer.write_model(jnet, str(tmp_path / "n.zip"), normalizer=j)
    jreg, treg = JModelRegistry(), ModelRegistry(device="cpu")
    jreg.load("v1", str(tmp_path / "n.zip"))
    treg.load("v1", str(tmp_path / "n.zip"))
    jsrv = JServingServer(registry=jreg).start()
    tsrv = ServingServer(registry=treg).start()
    try:
        jsrv.deploy("v1")
        tsrv.deploy("v1")
        x_int = np.asarray(raw[:2], np.int64)
        tout = tsrv.predict(x_int)["prediction"]
        jout = jsrv.predict(x_int)["prediction"]
        np.testing.assert_allclose(tout, np.asarray(jout), **TOL)
        np.testing.assert_allclose(
            tout, tnet.output(t.transform_features(
                x_int.astype(np.float32))).numpy(), **TOL)
    finally:
        jsrv.stop()
        tsrv.stop()


def test_fit_labels_normalizer_reverts_served_outputs_like_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) * 100.0 + 500.0).astype(np.float32)
    j = jn.NormalizerStandardize(fit_labels=True).fit(JDataSet(x, y))
    t = tn.NormalizerStandardize(fit_labels=True).fit(DataSet(x, y))
    norm_y = t.transform(DataSet(x, y)).labels
    keys = t.transform_features(x)

    class Oracle:
        """Predicts the normalized label of a known (normalized) row."""

        def output(self, xx):
            xx = np.asarray(xx.cpu() if torch.is_tensor(xx) else xx)
            out = np.zeros((xx.shape[0], 1), np.float32)
            for i in range(xx.shape[0]):
                hit = np.where(np.abs(keys - xx[i]).sum(1) < 1e-4)[0]
                if hit.size:
                    out[i] = norm_y[hit[0]]
            return out

    jreg, treg = JModelRegistry(), ModelRegistry(device="cpu")
    jreg.register("v1", Oracle(), transform=j)
    treg.register("v1", Oracle(), transform=t)
    jsrv = JServingServer(registry=jreg).start()
    tsrv = ServingServer(registry=treg).start()
    try:
        jsrv.deploy("v1")
        tsrv.deploy("v1")
        tout = tsrv.predict(x[:5])["prediction"]
        np.testing.assert_allclose(tout, y[:5], rtol=1e-4)
        np.testing.assert_allclose(tout, jsrv.predict(x[:5])["prediction"],
                                   rtol=1e-5)
    finally:
        jsrv.stop()
        tsrv.stop()
