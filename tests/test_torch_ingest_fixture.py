"""The JAX reference fixture that ties phase 14's reference-smoke leg on the
card to the JAX package: tests/fixtures/torch_port_ingest.json.

It holds tools/smoke_ingest.py's two legs (at its test's size:
chip_smoke.INGEST_LEGS, 256 rows, 5 epochs, batches of 32, seed 0) as the
JAX package computes them on the CPU, from initial parameters stored in
the fixture (the port's `synthetic_params(seed=0)` of each dense net):

- tabular: the smoke's CSV -> CSVRecordReader -> its TransformProcess,
  through JSON -> ParallelPipelineExecutor(device_ingest=True, workers=2,
  ordered) -> DevicePrefetcher(queue_size=2) -> the dense net with the
  pipeline's ingest set, `fit(epochs=1, steps_per_execution=2)` an epoch;
- image: the smoke's uint8 pixels and int32 classes ->
  DevicePrefetcher(transfer_dtype=uint8) -> the dense net with
  DeviceIngest(normalizer=min-max, one_hot_labels=3), likewise;

each leg's score after every epoch, and the argmax and top-2 gap of its
`output` on 96 held-out rows made with seed 1. No accuracy bar: the
reference's own smoke misses its 0.9 on the image leg at this size.

The first test regenerates the fixture with JAX and requires the
committed file to equal it (rtol 1e-6), so it cannot go stale. The
second runs chip_smoke.py's leg (`ingest_legs`, `ingest_fixture_check`)
with the port on the CPU, held as the card is: scores within
INGEST_FIXTURE_RTOL = 1e-4, the argmax JAX's wherever JAX's top-2 gap is
at least INGEST_ARGMAX_GAP = 1e-3.

Regenerate with `python tests/test_torch_ingest_fixture.py`.
"""
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parent)]
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)


def initial_params():
    """{leg: {"layer/key": array}}: the port's synthetic_params(seed=0)
    of each leg's dense net (5 and 36 features, 24 hidden, 3 classes)."""
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    shapes = {
        "tabular": {"0/W": (5, 24), "0/b": (24,), "1/W": (24, 3),
                    "1/b": (3,)},
        "image": {"0/W": (36, 24), "0/b": (24,), "1/W": (24, 3),
                  "1/b": (3,)}}
    return {leg: synthetic_params(s, seed=0) for leg, s in shapes.items()}


def jax_legs(params):
    """chip_smoke.ingest_legs with the JAX package."""
    from deeplearning4j_tpu.datasets.dataset import DataSet
    from deeplearning4j_tpu.datasets.iterator.base import ListDataSetIterator
    from deeplearning4j_tpu.datasets.records import CSVRecordReader
    from deeplearning4j_tpu.etl import (
        DeviceIngest, DevicePrefetcher, NormalizerMinMaxScaler,
        ParallelPipelineExecutor, Schema, TransformProcess)
    from deeplearning4j_tpu.nn.conf import layers as L
    from deeplearning4j_tpu.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.multilayer.network import MultiLayerNetwork
    from deeplearning4j_tpu.nn.updaters import Adam
    from deeplearning4j_tpu.telemetry.registry import MetricsRegistry
    from torch_port_pairs import jax_tree
    n, epochs, bs, seed, held = (cs.INGEST_LEGS[k] for k in (
        "n_rows", "epochs", "batch_size", "seed", "held"))

    def net(n_features, lr, flat):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Adam(lr)).list()
                .layer(L.DenseLayer(n_out=24, activation="relu"))
                .layer(L.OutputLayer(n_out=3, activation="softmax",
                                     loss="MCXENT"))
                .input_type(InputType.feed_forward(n_features)).build())
        m = MultiLayerNetwork(conf)
        m.init()
        m.init(params=jax_tree(m, {k: np.asarray(v, np.float32)
                                   for k, v in flat.items()}))
        return m

    def epochs_of(model, pf):
        scores = []
        for _ in range(epochs):
            model.fit(pf, epochs=1, steps_per_execution=2)
            scores.append(float(model.score_value))
        pf.close()
        return scores

    reg = MetricsRegistry()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/train.csv"
        cs.smoke_csv(path, n, seed)
        tp = cs.smoke_transform(Schema, TransformProcess)
        pipe = ParallelPipelineExecutor(
            CSVRecordReader().initialize(path), tp, batch_size=bs,
            workers=2, ordered=True, label_columns=["label"],
            one_hot_labels=3, device_ingest=True, name="smoke_ingest",
            registry=reg)
        ing = pipe.ingest
        model = net(len(ing._final_feature_names), 1e-2, params["tabular"])
        model.set_ingest(ing)
        scores = epochs_of(model, DevicePrefetcher(
            pipe, queue_size=2, name="smoke_ingest", registry=reg))
        pipe.close()
        cs.smoke_csv(f"{tmp}/held.csv", held, seed + 1)
        recs = CSVRecordReader().initialize(f"{tmp}/held.csv")
        rows = [recs.next_record() for _ in range(held)]
        ref = ing.host_reference(rows)
        am, gap = cs.top2(np.asarray(model.output(ref.features)))
        out["tabular"] = {"scores": scores, "argmax": am, "gap": gap,
                          "wire_dtype": str(ing.wire_dtype),
                          "bytes_per_row": ing.bytes_per_row()}
    x, y = cs.smoke_pixels(n, seed)
    nz = NormalizerMinMaxScaler().fit(DataSet(x.astype(np.float32), None))
    sets = [DataSet(x[s:s + bs], y[s:s + bs]) for s in range(0, n, bs)]
    model = net(x.shape[1], 3e-2, params["image"])
    model.set_ingest(DeviceIngest(normalizer=nz, one_hot_labels=3))
    scores = epochs_of(model, DevicePrefetcher(
        ListDataSetIterator(sets), queue_size=2, transfer_dtype=np.uint8,
        name="smoke_image", registry=reg))
    hx, _ = cs.smoke_pixels(held, seed + 1)
    am, gap = cs.top2(np.asarray(model.output(
        nz.transform_features(hx.astype(np.float32)))))
    out["image"] = {"scores": scores, "argmax": am, "gap": gap}
    return out


def make_fixture():
    params = initial_params()
    run = jax_legs(params)
    return {"legs": cs.INGEST_LEGS, "param_seed": 0,
            "params": {leg: {k: np.asarray(v).tolist() for k, v in p.items()}
                       for leg, p in params.items()},
            "tabular": run["tabular"], "image": run["image"]}


def test_fixture_is_what_jax_computes():
    committed = json.loads(cs.INGEST_FIXTURE.read_text())
    computed = make_fixture()
    assert committed["legs"] == computed["legs"]
    for leg in ("tabular", "image"):
        for k, v in computed["params"][leg].items():
            np.testing.assert_array_equal(committed["params"][leg][k], v)
        np.testing.assert_allclose(committed[leg]["scores"],
                                   computed[leg]["scores"], rtol=1e-6)
        np.testing.assert_allclose(committed[leg]["gap"],
                                   computed[leg]["gap"], rtol=1e-6,
                                   atol=1e-9)
        assert committed[leg]["argmax"] == computed[leg]["argmax"]
        assert computed[leg]["scores"][-1] < computed[leg]["scores"][0]
    assert committed["tabular"]["wire_dtype"] == "float32"


def test_port_reproduces_fixture_on_cpu():
    """chip_smoke.py's leg (c) of phase 14, run on the CPU."""
    fx = json.loads(cs.INGEST_FIXTURE.read_text())
    run = cs.ingest_legs(fx["params"], device="cpu")
    gaps = cs.ingest_fixture_check(run, fx)
    for leg in ("tabular", "image"):
        assert gaps[f"{leg} scores"] <= cs.INGEST_FIXTURE_RTOL, gaps
        assert gaps[f"{leg} argmax"] == 0, gaps
    assert run["tabular"]["wire_dtype"] == fx["tabular"]["wire_dtype"]
    assert run["tabular"]["bytes_per_row"] == \
        fx["tabular"]["bytes_per_row"]
    # narrow bytes crossed, every epoch: f0, f1 and the level's code as
    # float32 + a uint8 id a row (the one-hot and both affines run on the
    # device); 36 uint8 pixels + an int32 id a row
    legs = cs.INGEST_LEGS
    assert run["tabular"]["bytes_per_row"] == 3 * 4 + 1
    assert run["h2d_bytes"] == {
        "smoke_ingest": legs["epochs"] * legs["n_rows"] * (3 * 4 + 1),
        "smoke_image": legs["epochs"] * legs["n_rows"] * (36 + 4)}


if __name__ == "__main__":
    import jax
    # the settings tests/conftest.py gives every test
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    cs.INGEST_FIXTURE.write_text(json.dumps(make_fixture()) + "\n")
    print(f"wrote {cs.INGEST_FIXTURE}")
