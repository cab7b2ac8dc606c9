"""The port's ServingServer(decode=True) on the CPU: POST /generate answers
with the JAX server's status contract, and concurrent greedy requests
return exactly the tokens the JAX package generates on the same weights
(weights through `params_from_jax`; greedy tokens are compared exactly).
"""
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from deeplearning4j_tpu.decode import DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.util.model_serializer import _flatten_tree
from deeplearning4j_tpu.zoo.models import transformer_lm as jax_transformer_lm

from deeplearning4j_tpu_torch.serving import ServingServer
from deeplearning4j_tpu_torch.util.http import request_json
from deeplearning4j_tpu_torch.util.params import params_from_jax
from deeplearning4j_tpu_torch.zoo import transformer_lm

# tiny shapes: one intra-op thread is fastest, and more only contend
# with XLA's thread pool in the same test process
torch.set_num_threads(1)

V = 11


@pytest.fixture(scope="module")
def nets():
    jnet = jax_transformer_lm(vocab_size=V, d_model=32, n_layers=2,
                              n_heads=2, seed=3, use_pallas=True).init()
    tnet = transformer_lm(vocab_size=V, d_model=32, n_layers=2, n_heads=2,
                          seed=3, use_pallas=True, device="cpu")
    tnet.init(params=params_from_jax(_flatten_tree(jnet.params),
                                     device="cpu"))
    return jnet, tnet


@pytest.fixture
def server(nets):
    srv = ServingServer(nets[1], decode=True, decode_slots=4,
                        decode_max_len=64, decode_queue_capacity=8).start()
    yield srv
    srv.stop(timeout=30)


def test_concurrent_generate_matches_jax(nets, server):
    jnet, _ = nets
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [0]]
    n_new = 9
    jeng = JaxDecodeEngine(jnet, slots=1, max_len=64)
    want = [jeng.generate(p, n_new) for p in prompts]
    url = server.url + "/generate"
    with ThreadPoolExecutor(len(prompts)) as pool:
        answers = list(pool.map(
            lambda p: request_json(url, {"prompt": p,
                                         "max_new_tokens": n_new}, 60),
            prompts))
    assert [s for s, _ in answers] == [200] * len(prompts)
    assert [body["tokens"] for _, body in answers] == want
    for (_, body), p in zip(answers, prompts):
        assert body["n_prompt"] == len(p) and body["version"] == "v1"
        assert body["finish_reason"] == "length"
    status, health = request_json(server.url + "/healthz", timeout=10)
    assert status == 200 and health["health"] == "healthy"
    assert health["decode"]["requests"] == len(prompts)


def test_generate_status_contract(server):
    url = server.url + "/generate"
    assert request_json(url, {"prompt": []}, 10)[0] == 400
    assert request_json(url, {"prompt": "abc"}, 10)[0] == 400
    assert request_json(url, {"prompt": [1], "temperature": "hot"},
                        10)[0] == 400
    # prompt + max_new_tokens beyond the cache: unservable, 400
    assert request_json(url, {"prompt": [1] * 60, "max_new_tokens": 10},
                        10)[0] == 400
    assert request_json(server.url + "/nope", {"prompt": [1]}, 10)[0] == 404
    # the deadline passes before a slot frees: 504
    assert request_json(url, {"prompt": [1, 2], "timeout_ms": 0},
                        30)[0] == 504
    status, body = request_json(url, {"prompt": [1, 2], "max_new_tokens": 5,
                                      "temperature": 0.8, "seed": 5}, 30)
    again = request_json(url, {"prompt": [1, 2], "max_new_tokens": 5,
                               "temperature": 0.8, "seed": 5}, 30)
    assert status == 200 and again[0] == 200
    assert again[1]["tokens"] == body["tokens"]
    assert all(0 <= t < V for t in body["tokens"])


def test_generate_404_without_decode_503_without_model_429_when_shed(nets):
    plain = ServingServer(nets[1]).start()
    try:
        status, body = request_json(plain.url + "/generate",
                                    {"prompt": [1, 2]}, 10)
        assert status == 404 and "decode=True" in body["error"]
    finally:
        plain.stop()
    empty = ServingServer(decode=True, decode_max_len=64).start()
    try:
        assert request_json(empty.url + "/generate", {"prompt": [1]},
                            30)[0] == 503
        assert request_json(empty.url + "/healthz", timeout=10)[0] == 503
    finally:
        empty.stop(timeout=30)
    full = ServingServer(nets[1], decode=True, decode_max_len=64,
                         decode_queue_capacity=0).start()
    try:
        status, body = request_json(full.url + "/generate", {"prompt": [1]},
                                    10)
        assert status == 429 and "queue full" in body["error"]
    finally:
        full.stop(timeout=30)
