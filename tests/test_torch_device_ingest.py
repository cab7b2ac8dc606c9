"""The port's device-side ingest against the JAX package, on the CPU.

- Every op lowerer: `apply_features(prepare_host(records))` against the
  port's own `host_reference` and the JAX package's `jit_apply_features`,
  float32 to 1e-6 (the labels likewise through `apply_labels`), with the
  normalizer kinds, `fit_labels` label stats and mirrored labels of JAX's
  tests/test_device_ingest.py; `prepare_host`'s narrow arrays equal JAX's
  in dtype and value; the chain split and wire dtype are JAX's.
- The one-hot of an id outside [0, N) (and of a negative one) is an
  all-zero row, as `jax.nn.one_hot` gives.
- `ImageScalerPreProcessor` on uint8 pixels against JAX's, float32 and
  bf16 compute (bitwise), and in a MultiLayerNetwork's output; its conf
  JSON crosses both ways.
- JAX's `test_set_ingest_trains_identically_to_host_path` and
  `test_graph_multi_output_ingest_trains_identically`, each run in both
  packages from the same parameters: the port's ingest path equal to its
  wide path bitwise where the wide batch holds the same float32 values
  (the tabular host reference widens in float64, so its batches are held
  within JAX's bar instead), and to JAX within rtol 2e-4 / atol 2e-4
  (JAX's own bar). The port has no MSE loss yet (ROADMAP queue 1, nn
  core), so the graph's second head is an MCXENT head on float64 soft
  labels, which still exercises the cast of every label head.
- `fit(steps_per_execution=K)` keeps ONE plan for a signature across its
  groups, epochs and calls, and trains bitwise as a plan a group did; it
  keeps the plans of the MAX_PLANS most recently used signatures.
- The card's K-step path (`_run_on_card`, its streams stubbed and its
  capture recorded) captures a fixed-rate plan's second group, and under
  a scheduled rate never captures: each group runs eagerly and trains as
  K `fit_batch` calls, bitwise.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.datasets.iterator.base import \
    ListDataSetIterator as JListDataSetIterator
from deeplearning4j_tpu.etl import (DeviceIngest as JDeviceIngest,
                                    NormalizerMinMaxScaler as JMinMax,
                                    NormalizerStandardize as JStandardize,
                                    Schema as JSchema,
                                    TransformProcess as JTransformProcess)
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import preprocessors as JP
from deeplearning4j_tpu.nn.conf.configuration import (
    MultiLayerConfiguration as JMultiLayerConfiguration,
    NeuralNetConfiguration as JNeuralNetConfiguration)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer.network import \
    MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.nn.updaters import Adam as JAdam

from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator.base import \
    ListDataSetIterator
from deeplearning4j_tpu_torch.etl import (DeviceIngest, NormalizerMinMaxScaler,
                                          NormalizerStandardize, Schema,
                                          TransformProcess)
from deeplearning4j_tpu_torch.etl.device_transform import one_hot
from deeplearning4j_tpu_torch.nn import multistep
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as TP
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from torch_port_pairs import pair_of

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-6)
JAX_BAR = dict(rtol=2e-4, atol=2e-4)


def _schema(S):
    return (S.builder().add_numeric("a", "b")
            .add_categorical("color", ["red", "green", "blue"])
            .add_integer("label").build())


def _records(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return [[float(rng.uniform(0, 10)), float(rng.normal()),
             ["red", "green", "blue"][int(c)], int(c)]
            for c in rng.integers(0, 3, n)]


def _both(chain, schema=_schema):
    return (chain(TransformProcess.builder(schema(Schema))).build(),
            chain(JTransformProcess.builder(schema(JSchema))).build())


def _nz_pair(kind, **kw):
    if kind == "standardize":
        return NormalizerStandardize(**kw), JStandardize(**kw)
    return NormalizerMinMaxScaler(lo=-1, hi=1, **kw), \
        JMinMax(lo=-1, hi=1, **kw)


def _assert_parity(chain, records=None, label_columns=("label",),
                   one_hot_labels=3, nz=None, schema=_schema):
    """The port's device functions against its host reference and against
    JAX's lowering; the narrow wire arrays against JAX's."""
    tp, jp = _both(chain, schema)
    records = records if records is not None else _records()
    tnz = jnz = None
    if nz is not None:
        tnz, jnz = _nz_pair(*nz[:1], **nz[1])
        probe = DeviceIngest(tp, label_columns=list(label_columns),
                             one_hot_labels=one_hot_labels)
        ref = probe.host_reference(records)
        tnz.fit(ref)
        jnz.fit(JDataSet(ref.features, ref.labels))
    t = DeviceIngest(tp, normalizer=tnz, label_columns=list(label_columns),
                     one_hot_labels=one_hot_labels)
    j = JDeviceIngest(jp, normalizer=jnz, label_columns=list(label_columns),
                      one_hot_labels=one_hot_labels)
    assert repr(t) == repr(j) and t.wire_dtype == j.wire_dtype
    assert t.bytes_per_row() == j.bytes_per_row()
    narrow, jnarrow = t.prepare_host(records), j.prepare_host(records)
    for a, b in ((narrow.features, jnarrow.features),
                 (narrow.labels, jnarrow.labels)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref = t.host_reference(records)
    x = t.apply_features(torch.from_numpy(narrow.features))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), ref.features, **F32)
    np.testing.assert_allclose(
        x.numpy(), np.asarray(j.jit_apply_features(
            jnp.asarray(jnarrow.features))), **F32)
    y = t.apply_labels(torch.from_numpy(narrow.labels))
    np.testing.assert_allclose(y.numpy(), ref.labels, **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(j.jit_apply_labels(
            jnp.asarray(jnarrow.labels))), **F32)
    assert t.jit_apply_features == t.apply_features
    return t, narrow, ref


LOWERED = {
    "one_hot": lambda b: b.categorical_to_one_hot("color"),
    "to_integer": lambda b: b.categorical_to_integer("color"),
    "min_max": lambda b: (b.categorical_to_integer("color")
                          .min_max_normalize("a", 0.0, 10.0, -1.0, 1.0)),
    "standardize": lambda b: (b.categorical_to_one_hot("color")
                              .standardize("b", 0.3, 1.7)),
    "filter_rows_host_prefix": lambda b: (b.filter_rows("b", "lt", -0.5)
                                          .categorical_to_one_hot("color")),
    "remove_rename": lambda b: (b.categorical_to_one_hot("color")
                                .remove_columns("color[green]")
                                .rename_column("a", "alpha")),
    "derived_mul": lambda b: (b.categorical_to_integer("color")
                              .derived_column("ab", "mul", ["a", "b"])),
    "derived_sub_scalar": lambda b: (b.categorical_to_integer("color")
                                     .derived_column("c", "sub", ["a"],
                                                     0.1)),
    "derived_log": lambda b: (b.categorical_to_integer("color")
                              .derived_column("l", "log", ["a"])),
    "derived_abs": lambda b: (b.categorical_to_integer("color")
                              .derived_column("m", "abs", ["b"])),
}


@pytest.mark.parametrize("name", list(LOWERED))
def test_lowered_op_parity(name):
    t, _, _ = _assert_parity(LOWERED[name])
    if name == "filter_rows_host_prefix":
        assert [type(o).__name__ for o in t._host_ops] == ["FilterRows"]


def test_sequence_window_parity():
    def schema(S):
        return S.builder().add_numeric("a", "b").build()
    rng = np.random.default_rng(1)
    recs = [[float(a), float(b)] for a, b in rng.normal(size=(20, 2))]
    _assert_parity(lambda b: b.sequence_window(4, 2), records=recs,
                   label_columns=(), one_hot_labels=None, schema=schema)


FULL = (lambda b: b.filter_rows("b", "lt", -2.5)
        .categorical_to_one_hot("color")
        .derived_column("ab", "mul", ["a", "b"])
        .min_max_normalize("a", 0.0, 10.0)
        .standardize("b", 0.0, 1.0)
        .rename_column("ab", "prod"))


@pytest.mark.parametrize("kind", ["standardize", "min_max"])
def test_full_chain_parity_with_normalizer_kinds(kind):
    _assert_parity(FULL, nz=(kind, {}))


def test_fit_labels_normalizer_with_label_columns():
    _, narrow, ref = _assert_parity(
        lambda b: b.categorical_to_one_hot("color"), one_hot_labels=None,
        nz=("standardize", {"fit_labels": True}))
    assert not np.allclose(np.asarray(narrow.labels, np.float32), ref.labels)


@pytest.mark.parametrize("fit_labels", [False, True])
def test_mirrored_labels_with_normalizer(fit_labels):
    def schema(S):
        return (S.builder().add_numeric("a", "b")
                .add_categorical("color", ["red", "green", "blue"]).build())
    recs = [r[:3] for r in _records(seed=13)]
    tp, jp = _both(lambda b: b.categorical_to_one_hot("color"), schema)
    tnz, jnz = _nz_pair("standardize", fit_labels=fit_labels)
    ref = DeviceIngest(tp).host_reference(recs)
    tnz.fit(ref)
    jnz.fit(JDataSet(ref.features, ref.labels))
    t, j = DeviceIngest(tp, normalizer=tnz), JDeviceIngest(jp, normalizer=jnz)
    narrow = t.prepare_host(recs)
    got = t.apply_labels(torch.from_numpy(narrow.labels)).numpy()
    np.testing.assert_allclose(got, t.host_reference(recs).labels, **F32)
    np.testing.assert_allclose(got, np.asarray(j.jit_apply_labels(
        jnp.asarray(narrow.labels))), **F32)


def test_one_hot_of_ids_out_of_range_is_zero_as_in_jax():
    ids = np.array([0, 2, 3, 255, 1], np.uint8)
    got = DeviceIngest(one_hot_labels=3).apply_labels(torch.from_numpy(ids))
    want = np.asarray(JDeviceIngest(one_hot_labels=3).jit_apply_labels(
        jnp.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2].sum() == 0 and got[3].sum() == 0
    neg = np.array([[-1], [2], [7]], np.int32)     # [n, 1] ids squeezed
    got = DeviceIngest(one_hot_labels=4).apply_labels(torch.from_numpy(neg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JDeviceIngest(one_hot_labels=4).jit_apply_labels(jnp.asarray(neg))))
    assert got.shape == (3, 4) and got[0].sum() == 0 and got[2].sum() == 0
    assert one_hot(torch.tensor([1, 5]), 5).tolist() == \
        [[0, 1, 0, 0, 0], [0, 0, 0, 0, 0]]


def test_image_ingest_without_transform_keeps_the_wire_batch():
    x = np.arange(24, dtype=np.uint8).reshape(4, 6)
    ing = DeviceIngest()
    assert ing.apply_features(torch.from_numpy(x)).dtype == torch.uint8
    assert ing.bytes_per_row() is None and ing.wire_dtype is None
    with pytest.raises(ValueError):
        ing.prepare_host([[1]])
    with pytest.raises(ValueError):
        DeviceIngest(_both(FULL)[0], label_columns=["a", "b"],
                     one_hot_labels=3)


# ------------------------------------------------------ image scaler

@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_image_scaler_on_uint8_matches_jax(compute):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (8, 36), dtype=np.uint8)
    t, j = TP.ImageScalerPreProcessor(-1.0, 1.0), \
        JP.ImageScalerPreProcessor(-1.0, 1.0)
    if compute is None:
        got, want = t(torch.from_numpy(x)), j(jnp.asarray(x))
    else:
        got = t(torch.from_numpy(x).to(torch.bfloat16)).float()
        want = j(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def conf(NNC, L, IT, P):
        return (NNC.builder().seed(2).list()
                .layer(L.DenseLayer(n_out=8, activation="relu"))
                .layer(L.OutputLayer(n_out=3, activation="softmax",
                                     loss="MCXENT"))
                .input_preprocessor(0, P.ImageScalerPreProcessor(0.0, 1.0))
                .input_type(IT.feed_forward(36)).build())
    tc = conf(NeuralNetConfiguration, TL, InputType, TP)
    jc = conf(JNeuralNetConfiguration, JL, JInputType, JP)
    tc.compute_dtype = jc.compute_dtype = compute
    assert isinstance(MultiLayerConfiguration.from_json(jc.to_json())
                      .input_preprocessors[0], TP.ImageScalerPreProcessor)
    assert isinstance(JMultiLayerConfiguration.from_json(tc.to_json())
                      .input_preprocessors[0], JP.ImageScalerPreProcessor)
    jnet, tnet = pair_of(MultiLayerNetwork(tc, device="cpu"),
                         JMultiLayerNetwork(jc))
    got = tnet.output(x).numpy()
    want = np.asarray(jnet.output(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **(
        dict(rtol=1e-5, atol=1e-6) if compute is None
        else dict(rtol=0, atol=2e-2)))


# ------------------------------------------------------------ fused fit

def _tabular(NNC, L, IT, U, n_features, seed=0):
    return (NNC.builder().seed(seed).updater(U(1e-2)).list()
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="MCXENT"))
            .input_type(IT.feed_forward(n_features)).build())


def _flat(net):
    return {f"{n}/{k}": np.asarray(v.detach().numpy() if
                                   isinstance(v, torch.Tensor) else v)
            for n, ps in net.params.items() for k, v in ps.items()}


def test_set_ingest_trains_identically_to_host_path():
    """JAX's test on both packages: raw narrow batches + the fused ingest
    give the wide batches' parameters, through the K-step plans."""
    tp, jp = _both(lambda b: b.categorical_to_one_hot("color")
                   .min_max_normalize("a", 0.0, 10.0))
    ing = DeviceIngest(tp, label_columns=["label"], one_hot_labels=3)
    jing = JDeviceIngest(jp, label_columns=["label"], one_hot_labels=3)
    recs = _records(192, seed=5)
    chunks = [recs[i * 32:(i + 1) * 32] for i in range(6)]
    narrow = [ing.prepare_host(c) for c in chunks]
    wide = [ing.host_reference(c) for c in chunks]
    n = wide[0].features.shape[-1]

    def make():
        return pair_of(MultiLayerNetwork(_tabular(
            NeuralNetConfiguration, TL, InputType, Adam, n), device="cpu"),
            JMultiLayerNetwork(_tabular(JNeuralNetConfiguration, JL,
                                        JInputType, JAdam, n)))
    # the same float32 features widened ahead of the step: the host
    # reference's float64 arithmetic rounds some a few ulps away
    lowered = [DataSet(ing.apply_features(torch.from_numpy(d.features)),
                       w.labels) for d, w in zip(narrow, wide)]
    jdev, dev = make()
    _, host = make()
    _, same = make()
    dev.set_ingest(ing).fit(ListDataSetIterator(narrow), epochs=2,
                            steps_per_execution=3)
    host.fit(ListDataSetIterator(wide), epochs=2, steps_per_execution=3)
    same.fit(ListDataSetIterator(lowered), epochs=2, steps_per_execution=3)
    assert len(dev._plans) == 1 and \
        next(iter(dev._plans.values())).batch[1].dtype == torch.uint8
    jdev.set_ingest(jing)
    jdev.fit(JListDataSetIterator([JDataSet(d.features, d.labels)
                                   for d in narrow]),
             epochs=2, steps_per_execution=3)
    got, same_p, wide_p, want = _flat(dev), _flat(same), _flat(host), \
        _flat(jdev)
    for k in want:
        np.testing.assert_array_equal(got[k], same_p[k], err_msg=k)
        np.testing.assert_allclose(got[k], wide_p[k], **JAX_BAR, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], **JAX_BAR, err_msg=k)


def test_graph_multi_output_ingest_trains_identically():
    def conf(NNC, L, IT, U):
        return (NNC.builder().seed(42).updater(U(1e-2)).graph_builder()
                .add_inputs("in")
                .add_layer("dense", L.DenseLayer(n_out=16,
                                                 activation="relu"), "in")
                .add_layer("cls", L.OutputLayer(n_out=3, activation="softmax",
                                                loss="MCXENT"), "dense")
                .add_layer("soft", L.OutputLayer(
                    n_out=2, activation="softmax", loss="MCXENT"), "dense")
                .set_outputs("cls", "soft")
                .set_input_types(IT.feed_forward(4)).build())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    ids = rng.integers(0, 3, 64).astype(np.int32)
    y_cls = np.eye(3, dtype=np.float32)[ids]
    p = rng.uniform(0.1, 0.9, 64)
    y_soft = np.stack([p, 1 - p], -1)               # float64: the cast
    targs = (NeuralNetConfiguration, TL, InputType, Adam)
    jargs = (JNeuralNetConfiguration, JL, JInputType, JAdam)
    jing, ting = pair_of(ComputationGraph(conf(*targs), device="cpu"),
                         JGraph(conf(*jargs)))
    _, tref = pair_of(ComputationGraph(conf(*targs), device="cpu"),
                      JGraph(conf(*jargs)))
    tref.fit([MultiDataSet([x], [y_cls, y_soft])], epochs=3)
    ting.set_ingest(DeviceIngest(one_hot_labels=3))
    ting.fit([MultiDataSet([x], [ids, y_soft])], epochs=3)
    jing.set_ingest(JDeviceIngest(one_hot_labels=3))
    jing.fit([JMultiDataSet([x], [ids, y_soft])], epochs=3)
    got, wide, want = _flat(ting), _flat(tref), _flat(jing)
    for k in want:
        np.testing.assert_array_equal(got[k], wide[k], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], **JAX_BAR, err_msg=k)


def test_fit_groups_reuse_one_plan_bitwise_as_a_plan_a_group():
    """`fit(steps_per_execution=K)` copies every group after the first
    into the signature's one plan (across epochs and calls), and trains
    exactly as one fresh `prepare_steps` plan a group did; a new shape is
    a second plan, a ragged tail goes batch by batch."""
    rng = np.random.default_rng(3)
    sets = [DataSet(rng.normal(size=(8, 5)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(7)]

    def net():
        return MultiLayerNetwork(_tabular(NeuralNetConfiguration, TL,
                                          InputType, Adam, 5),
                                 device="cpu").init()
    reused, fresh = net(), net()
    made = []
    orig = multistep.StepPlan.__init__

    def spy(self, *a, **kw):
        made.append(self)
        orig(self, *a, **kw)
    multistep.StepPlan.__init__ = spy
    try:
        reused.fit(ListDataSetIterator(sets), epochs=2,
                   steps_per_execution=3)
        reused.fit(ListDataSetIterator(sets[:3]), steps_per_execution=3)
    finally:
        multistep.StepPlan.__init__ = orig
    assert len(made) == 1 and list(reused._plans.values()) == made
    for _ in range(2):
        for g in (sets[0:3], sets[3:6]):
            fresh.fit_prepared(fresh.prepare_steps(g))
        fresh.fit_batch(sets[6])
    fresh.fit_prepared(fresh.prepare_steps(sets[:3]))
    assert reused.iteration_count == fresh.iteration_count == 17
    a, b = _flat(reused), _flat(fresh)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    small = [DataSet(s.features[:4], s.labels[:4]) for s in sets[:3]]
    reused.fit(ListDataSetIterator(small), steps_per_execution=3)
    assert len(reused._plans) == 2
    epoch = reused._graph_epoch
    reused.set_ingest(None)                 # the same ingest: plans kept
    assert len(reused._plans) == 2 and reused._graph_epoch == epoch
    reused.set_ingest(DeviceIngest())       # another one: plans dropped
    assert reused._plans == {} and reused._graph_epoch == epoch + 1


def test_fit_keeps_the_plans_of_the_most_recent_signatures():
    """Each new signature beyond MAX_PLANS drops the least recently used
    plan (its stacks and graph); a reused signature counts as used."""
    rng = np.random.default_rng(5)
    net = MultiLayerNetwork(_tabular(NeuralNetConfiguration, TL, InputType,
                                     Adam, 5), device="cpu").init()

    def groups(rows):
        return [DataSet(rng.normal(size=(rows, 5)).astype(np.float32),
                        np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
                for _ in range(2)]

    def rows_kept():
        return [key[0][0][1][0][0] for key in net._plans]
    sizes = list(range(2, 3 + multistep.MAX_PLANS))
    for rows in sizes:
        net.fit(ListDataSetIterator(groups(rows)), steps_per_execution=2)
    assert rows_kept() == sizes[1:]
    net.fit(ListDataSetIterator(groups(sizes[1])), steps_per_execution=2)
    net.fit(ListDataSetIterator(groups(1)), steps_per_execution=2)
    assert rows_kept() == sizes[3:] + [sizes[1], 1]


class _Captured(Exception):
    pass


class _NoStream:
    def wait_stream(self, other):
        pass


def _card_path(monkeypatch, net):
    """`net`'s groups through the card's K-step path on the host: the
    streams are no-ops and a capture raises `_Captured`."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())

    def capture(plan, stream):
        raise _Captured
    monkeypatch.setattr(net, "_capture", capture)

    def fit_groups(groups):
        for g in groups:
            net._run_on_card(net._group_plan(g))
    return fit_groups


def _step_schedule(net):
    """Every layer's rate halved every 2 steps, as the JAX package's
    `lr_policy="step"` gives (the port builds only the fixed policy)."""
    opt = net._optimizer
    opt._layers = {name: (lambda step, lr=sched(0): lr * 0.5 ** (step // 2),
                          tensors, o)
                   for name, (sched, tensors, o) in opt._layers.items()}
    opt.fixed = False
    return net


def test_scheduled_rate_runs_each_group_eagerly_on_the_card(monkeypatch):
    rng = np.random.default_rng(6)
    sets = [DataSet(rng.normal(size=(8, 5)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(6)]

    def net():
        return MultiLayerNetwork(_tabular(NeuralNetConfiguration, TL,
                                          InputType, Adam, 5),
                                 device="cpu").init()
    fixed = net()
    with pytest.raises(_Captured):
        _card_path(monkeypatch, fixed)([sets[0:2], sets[2:4]])
    sched, ref, flat = _step_schedule(net()), _step_schedule(net()), net()
    _card_path(monkeypatch, sched)([sets[0:2], sets[2:4], sets[4:6]])
    assert len(sched._plans) == 1 and sched._optimizer.count == 6
    for ds in sets:
        ref.fit_batch(ds)
        flat.fit_batch(ds)
    got, want, unscheduled = _flat(sched), _flat(ref), _flat(flat)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(not np.array_equal(got[k], unscheduled[k]) for k in want)
