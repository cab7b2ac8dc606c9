"""The JAX reference fixture of the /predict plane.

tests/fixtures/torch_port_predict.json holds, for the full-width
`transformer_lm` (vocab 256, d_model 256, 4 layers, 4 heads) with
`synthetic_params(seed=0)`:

- 32 requests drawn with numpy from seed 0: 1-3 rows of token ids each,
  lengths 5-128, so that one request alone falls in each of the length
  buckets 8, 16, 32, 64 and 128;
- the JAX package's argmax at every position of every row, computed on
  its plain blockwise attention path (use_pallas=False: the function K1
  computes) with the rows padded to 128 under the [rows, 128] validity
  mask, as the batcher pads them; and, where the top-2 gap is under
  1e-6 (a tie), the runner-up, which the card may answer instead;
- the pretrained LeNet's labels for the 500 t10k images of the real-digit
  fixture, the images whose top-2 gap is under 1e-4, and its accuracy.

The first test regenerates it with JAX and requires the committed file to
be equal (the smallest gap to 1e-8), so it cannot go stale; the second sends the requests through
the port's ServingServer on the CPU (admission queue, batcher, masked
length buckets; the kernels' plain versions) and requires the fixture's
argmax, and the pretrained LeNet's labels through the same server.
chip_smoke.py's phase_predict holds the card to the same fixture.

Regenerate the file with `python tests/test_torch_predict_fixture.py`.
"""
import gzip
import json
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
FIXTURE = FIX / "torch_port_predict.json"
MODEL = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
REQUEST_SEED = 0
N_REQUESTS = 32
MAX_LEN = 128
TIE_GAP = 1e-6
LENET_GAP = 1e-4


def predict_requests():
    """N_REQUESTS lists of token-id rows (1-3 rows, one length each,
    5-128), drawn from REQUEST_SEED."""
    rng = np.random.default_rng(REQUEST_SEED)
    out = []
    for _ in range(N_REQUESTS):
        rows, t = int(rng.integers(1, 4)), int(rng.integers(5, MAX_LEN + 1))
        out.append(rng.integers(0, MODEL["vocab_size"], (rows, t)).tolist())
    return out


def one_hot(rows, vocab=MODEL["vocab_size"]):
    return np.eye(vocab, dtype=np.float32)[np.asarray(rows)]


def t10k():
    """The real-digit fixture's t10k images [n, 28, 28, 1] in [0, 1] and
    their labels (idx layout: 16-byte image header, 8-byte label
    header)."""
    d = FIX / "mnist_real"
    img = gzip.open(d / "t10k-images-idx3-ubyte.gz").read()
    n, h, w = (int(v) for v in np.frombuffer(img[4:16], ">i4"))
    x = np.frombuffer(img[16:], np.uint8).reshape(n, h, w, 1)
    lab = gzip.open(d / "t10k-labels-idx1-ubyte.gz").read()
    return (x.astype(np.float32) / 255.0,
            np.frombuffer(lab[8:], np.uint8).astype(np.int64))


def _top2(probs):
    """(argmax, runner-up, top-2 gap) over the last axis."""
    order = np.argsort(probs, axis=-1)
    first, second = order[..., -1], order[..., -2]
    gap = np.take_along_axis(probs, first[..., None], -1)[..., 0] - \
        np.take_along_axis(probs, second[..., None], -1)[..., 0]
    return first, second, gap


def make_fixture():
    """The fixture as the JAX package computes it."""
    from deeplearning4j_tpu.util.model_serializer import _flatten_tree
    from deeplearning4j_tpu.zoo import load_pretrained
    from deeplearning4j_tpu.zoo.models import transformer_lm
    from deeplearning4j_tpu_torch.util.params import synthetic_params
    from torch_port_pairs import nested
    net = transformer_lm(**MODEL, use_pallas=False)
    shapes = {k: v.shape for k, v in _flatten_tree(net.init().params).items()}
    net.init(params=nested(synthetic_params(shapes, seed=0)))
    requests = predict_requests()
    rows = [r for req in requests for r in req]
    lengths = [len(r) for r in rows]
    x = np.zeros((len(rows), MAX_LEN, MODEL["vocab_size"]), np.float32)
    mask = np.zeros((len(rows), MAX_LEN), np.float32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = one_hot(r)
        mask[i, :len(r)] = 1.0
    first, second, gap = _top2(np.asarray(net.output(x, mask=mask)))
    argmax, ties, i = [], [], 0
    for q, req in enumerate(requests):
        argmax.append([first[i + j, :lengths[i + j]].tolist()
                       for j in range(len(req))])
        for j in range(len(req)):
            for t in np.nonzero(gap[i + j, :lengths[i + j]] < TIE_GAP)[0]:
                ties.append([q, j, int(t), int(second[i + j, t])])
        i += len(req)
    valid = np.concatenate([gap[k, :n] for k, n in enumerate(lengths)])

    lenet, _ = load_pretrained("lenet_mnist_real")
    images, truth = t10k()
    lfirst, _, lgap = _top2(np.asarray(lenet.output(images)))
    return {"model": MODEL, "param_seed": 0, "request_seed": REQUEST_SEED,
            "requests": requests, "argmax": argmax, "ties": ties,
            "min_top2_gap": round(float(valid.min()), 10),
            "lenet": {"images": len(images), "labels": lfirst.tolist(),
                      "low_gap": np.nonzero(lgap < LENET_GAP)[0].tolist(),
                      "accuracy": float((lfirst == truth).mean())}}


def test_fixture_is_what_jax_computes():
    committed = json.loads(FIXTURE.read_text())
    fresh = make_fixture()
    gap = committed.pop("min_top2_gap")
    assert abs(fresh.pop("min_top2_gap") - gap) <= 1e-8
    assert committed == fresh
    lengths = [len(req[0]) for req in committed["requests"]]
    buckets = {1 << max(0, (n - 1).bit_length()) for n in lengths}
    assert buckets == {8, 16, 32, 64, 128}
    assert committed["lenet"]["images"] == 500


def test_port_predict_plane_matches_fixture(tmp_path):
    """The requests through the port's ServingServer on the CPU (zips in a
    scan_dir, /deploy, coalesced masked batches): the fixture's argmax at
    every valid position (the runner-up where JAX's gap is a tie), and the
    pretrained LeNet's labels, deployed by path (all 500 images in one
    request: chunks of max_batch_size rows)."""
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.model_serializer import \
        ModelSerializer
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    fx = json.loads(FIXTURE.read_text())
    net = transformer_lm(**MODEL, use_pallas=True, device="cpu")
    net.init(params=params_from_jax(synthetic_params(net.param_shapes(),
                                                     seed=0), device="cpu"))
    ModelSerializer.write_model(net, str(tmp_path / "v1.zip"))
    srv = ServingServer(scan_dir=str(tmp_path), device="cpu",
                        max_batch_size=32, max_latency_ms=50)
    srv.batcher.start()
    try:
        srv.deploy("v1")
        futs = [srv.submit(one_hot(req)) for req in fx["requests"]]
        answers = [f.result(timeout=600) for f in futs]
        snap = srv.metrics.snapshot()
        # another input contract: the warm-up must not replay the
        # transformer's shapes (as in the JAX package)
        srv.batcher.reset_observed()
        srv.deploy("lenet", path=str(FIX / "pretrained" /
                                     "lenet_mnist_real.zip"))
        images, _ = t10k()
        lenet = srv.predict(images, wait_s=600)
    finally:
        srv.stop()
    ties = {(q, j, t): second for q, j, t, second in fx["ties"]}
    for q, (res, want) in enumerate(zip(answers, fx["argmax"])):
        assert res["version"] == "v1"
        got = res["prediction"].argmax(-1)
        assert got.shape == (len(want), len(want[0]))
        for j, row in enumerate(want):
            for t, (a, b) in enumerate(zip(got[j], row)):
                assert a == b or ties.get((q, j, t)) == a, (q, j, t)
    assert snap["batches"] < snap["requests"] == N_REQUESTS
    assert lenet["version"] == "lenet"
    labels = lenet["prediction"].argmax(-1)
    low = set(fx["lenet"]["low_gap"])
    assert all(a == b for i, (a, b) in enumerate(
        zip(labels, fx["lenet"]["labels"])) if i not in low)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    FIXTURE.write_text(json.dumps(make_fixture()) + "\n")
    print(f"wrote {FIXTURE}")
