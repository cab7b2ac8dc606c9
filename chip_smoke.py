#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Card and toolchain: prints `nvidia-smi`'s name and power limit and the
   torch/CUDA versions, turns TF32 off for matmuls and cuDNN, and builds
   every hand kernel from the sources in this checkout (nvcc, sm_90a, one
   process per source, all at once), printing ptxas's registers, shared
   memory and spills.
2. Kernels against their plain PyTorch versions, on the card: `flash_fwd`
   at the prefill shapes, at the training shape with its log-sum-exp and
   at a shape large enough to time; `flash_decode` at the decode-step
   shape and a large cache; the backward pair `flash_bwd_dq` and
   `flash_bwd_dkv` at the training shape (causal, with and without a
   ragged key mask), at T=37 not causal with Tq != Tk, and at B=4 T=4096
   H=8 causal. Forward: max abs error <= 1e-4 (outputs are O(1); the only
   difference is the order of sums). Backward: allclose(rtol=2e-4,
   atol=2e-5), the bar tests/test_kernels.py holds the Pallas backward
   to, with the forward kernel's LSE checked against the plain LSE first;
   then the training case runs twice and its gradients must be bitwise
   equal. Times are CUDA-event medians and profiler device times;
   `bound_ms` is the larger of bytes over 3.35 TB/s and operations over
   67 TFLOP/s (f32 off the tensor cores, TF32 being off), operations
   counted per unmasked (q, k) pair (4*D forward, 6*D dq, 8*D dk/dv);
   `library_ms` times `scaled_dot_product_attention` on the same inputs
   (for the backward pair: `torch.autograd.grad` through it, the forward
   taken untimed; it computes dq, dk and dv in one call, so both rows
   carry it as the pair's time).
3. The serving path: `transformer_lm` at full width (vocab 256, d_model
   256, 4 layers, 4 heads) with `use_pallas=True` and
   `synthetic_params(seed=0)`, served by
   `ServingServer(decode=True, decode_slots=8, decode_max_len=256)`. Eight
   concurrent greedy `POST /generate` requests (prompts of 5-64 tokens,
   32 new tokens). All must answer 200, both kernels' launch counters must
   rise during the burst, the tokens must equal the same model run with
   the plain attention on the card (a differing token must sit on a true
   tie, top-2 gap < 1e-6), and the tokens of the fixture prompts must
   equal the JAX package's greedy tokens in
   tests/fixtures/torch_port_greedy.json.
4. The training path: the same model at full width, Adam(3e-4), float32.
   First the JAX fixture (tests/fixtures/torch_port_train.json: 5 steps on
   a [4, 128] batch) with `use_pallas=True`: per-step scores to rtol 1e-4.
   Then 10 `fit` steps at batch 16, seq 512 (the model, batch and length
   of `bench.py`'s transformer bench) on the kernel path and on the plain
   path: per-step scores agree to rtol 1e-4, the score falls, `flash_fwd`,
   `flash_bwd_dq` and `flash_bwd_dkv` each launch 4 x 10 times on the
   kernel path and nothing launches on the plain path. Prints the median
   step time, tokens/s of both paths and the device busy share of one
   profiled step with its top kernels.
5. One line `{"kernels": [...]}` with each kernel's numbers, then the last
   line `{"ok": true, "device": {...}}`.

It exits non-zero without printing a result when no CUDA device is visible
or when the package is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_greedy.json"
TRAIN_FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_train.json"
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
TOL = 1e-4
BWD_TOL = dict(rtol=2e-4, atol=2e-5)
SCORE_RTOL = 1e-4
TIE_GAP = 1e-6
SERVE = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
N_NEW = 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 512, 10
TRAIN_CASE = f"train B={TRAIN_BATCH} T={TRAIN_SEQ} H=4 D=64"
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, reps=30, warmup=3):
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=20):
    """Device time per call of fn(): the kernels' own time summed by the
    profiler (CUPTI), without the host's launch overhead. None when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) or 0
                   for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def bound(nbytes, flops):
    """(bound_ms, bound_by, bytes_ms, ops_ms) against the card's peaks."""
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms


# ------------------------------------------------------------------ phase 1
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" | tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    from deeplearning4j_tpu_torch.kernels import build
    seconds, logs = build.build_timed(verbose=True)
    print(f"kernel build: {seconds:.2f} s ({len(logs)} libraries built)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                print(f"  ptxas {name}: {line.split(' for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name}:   {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _valid_pairs(B, Tq, Tk, H, causal, km):
    """Unmasked (q, k) pairs: what the kernels' operations scale with."""
    import torch
    ok = torch.ones((B, Tq, Tk), dtype=torch.bool, device=DEVICE)
    if km is not None:
        ok &= (km > 0)[:, None, :]
    if causal:
        ok &= torch.ones((Tq, Tk), dtype=torch.bool, device=DEVICE).tril()
    return int(ok.sum()) * H


def _key_mask(B, T, valid):
    """[B, T] float32 validity of a prefix of `valid[b]` keys, or None."""
    import torch
    if valid is None:
        return None
    return (torch.arange(T)[None, :] < torch.as_tensor(valid)[:, None]
            ).to(torch.float32).to(DEVICE)


def _fwd_case(label, B, T, H, D, valid, gen, lse=False):
    """One flash_fwd case: causal, key mask from `valid` (per-batch valid
    prefix length or None), with the log-sum-exp output when `lse` (the
    training forward). Returns its record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain)
    dev = torch.device(DEVICE)
    q, k, v = (torch.randn((B, T, H, D), generator=gen).to(dev)
               for _ in range(3))
    km = _key_mask(B, T, valid)
    run = lambda: flash_attention(q, k, v, causal=True, key_mask=km,
                                  return_lse=lse)
    plain = lambda: flash_attention_plain(q, k, v, causal=True, key_mask=km,
                                          return_lse=lse)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    if lse:
        (out, out_lse), (ref, ref_lse) = out, ref
        lse_err = float((out_lse - ref_lse).abs().max())
        check(lse_err <= TOL, f"flash_fwd {label}: lse max abs err "
                              f"{lse_err} > {TOL}")
    check(bool(torch.isfinite(out).all()), f"flash_fwd {label}: non-finite")
    err = float((out - ref).abs().max())
    check(err <= TOL, f"flash_fwd {label}: max abs err {err} > {TOL}")
    sdpa_q, sdpa_k, sdpa_v = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_mask = None
    if km is not None:   # boolean [B, 1, Tq, Tk]: causal AND key-valid
        causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        sdpa_mask = causal[None, None] & (km > 0)[:, None, None, :]
    if sdpa_mask is None:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, is_causal=True)
    else:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, attn_mask=sdpa_mask)
    lib_ref = library().transpose(1, 2)
    lib_err = float((lib_ref - ref).abs().max())
    pairs = _valid_pairs(B, T, T, H, True, km)
    nbytes = 4 * (4 * B * T * H * D + (B * H * T if lse else 0)
                  + (B * T if km is not None else 0))
    b_ms, by, bytes_ms, ops_ms = bound(nbytes, 4 * D * pairs)
    rec = {"name": "flash_fwd", "case": label,
           "shape": [B, T, H, D], "causal": True, "lse": lse,
           "key_mask": km is not None, "max_abs_err": err,
           "library_max_abs_err": lib_err,
           "ms": median_ms(run), "plain_ms": median_ms(plain),
           "library_ms": median_ms(library), "bound_ms": b_ms,
           "bound_by": by, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "device_ms": device_ms(run),
           "plain_device_ms": device_ms(plain),
           "library_device_ms": device_ms(library)}
    return rec


def _decode_case(label, S, C, H, D, lengths, gen):
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_decode,
                                                  flash_decode_plain)
    dev = torch.device(DEVICE)
    q = torch.randn((S, 1, H, D), generator=gen).to(dev)
    k, v = (torch.randn((S, C, H, D), generator=gen).to(dev)
            for _ in range(2))
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(dev)
    run = lambda: flash_decode(q, k, v, lens)
    plain = lambda: flash_decode_plain(q, k, v, lens)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"flash_decode {label}: "
                                           "non-finite")
    err = float((out - ref).abs().max())
    check(err <= TOL, f"flash_decode {label}: max abs err {err} > {TOL}")
    library = library_ms = library_device_ms = lib_err = None
    if min(lengths) >= 1:
        # one SDPA call computes the same function when every slot has a
        # valid key: a boolean mask position < lengths, built untimed
        # (a slot with no valid key is the reference's uniform average,
        # which a masked SDPA row does not give)
        sdpa_q, sdpa_k, sdpa_v = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None]
                )[:, None, None, :]
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sdpa_q, sdpa_k, sdpa_v, attn_mask=mask)
        lib_err = float((library().transpose(1, 2) - ref).abs().max())
        check(lib_err <= TOL, f"SDPA {label}: max abs err {lib_err} vs plain")
        library_ms = median_ms(library)
        library_device_ms = device_ms(library)
    n = sum(C if x <= 0 else min(int(x), C) for x in lengths)
    nbytes = 4 * (2 * n * H * D + 2 * S * H * D + S)
    b_ms, by, bytes_ms, ops_ms = bound(nbytes, 4 * D * H * n)
    return {"name": "flash_decode", "case": label, "shape": [S, C, H, D],
            "lengths": ("random 1..C" if len(lengths) > 16
                        else list(lengths)),
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": median_ms(run), "plain_ms": median_ms(plain),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": by,
            "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
            "device_ms": device_ms(run), "plain_device_ms": device_ms(plain),
            "library_device_ms": library_device_ms}


def _bwd_case(label, B, Tq, Tk, H, D, causal, valid, gen, repeat=False):
    """The backward pair at one shape: q, k, v and dO ~ N(0, 1), out and
    lse from the plain forward (the forward kernel's LSE is checked
    against it first). Both kernels against their plain versions and
    against `flash_attention_bwd_plain`; with `repeat`, the pair runs twice
    more and must give the same bits. Returns the two records."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (
        attention_delta, flash_attention, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    dev = torch.device(DEVICE)
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev)
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(dev)
            for _ in range(2))
    g = torch.randn((B, Tq, H, D), generator=gen).to(dev)
    km = _key_mask(B, Tk, valid)
    kw = dict(causal=causal, key_mask=km)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    _, kernel_lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    lse_err = float((kernel_lse - lse).abs().max())
    check(lse_err <= TOL, f"flash_fwd {label}: lse max abs err {lse_err}")
    delta = attention_delta(out, g)
    runs = {
        "flash_bwd_dq": (lambda: flash_bwd_dq(q, k, v, g, lse, delta, **kw),
                         lambda: flash_bwd_dq_plain(q, k, v, g, lse, delta,
                                                    **kw)),
        "flash_bwd_dkv": (lambda: flash_bwd_dkv(q, k, v, g, lse, delta,
                                                **kw),
                          lambda: flash_bwd_dkv_plain(q, k, v, g, lse,
                                                      delta, **kw))}
    got = (runs["flash_bwd_dq"][0](),) + runs["flash_bwd_dkv"][0]()
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(a).all()), f"{label} {name}: non-finite")
        errs[name] = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, **BWD_TOL)),
              f"{label} {name}: not allclose to plain {BWD_TOL} (max abs "
              f"err {errs[name]})")
    if km is not None:
        dead = km == 0
        check(bool((got[1][dead] == 0).all() and (got[2][dead] == 0).all()),
              f"{label}: a masked key's dk/dv row is not exactly 0")
    if repeat:
        for _ in range(2):
            again = flash_attention_bwd(q, k, v, out, lse, g, **kw)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{label}: gradients differ bitwise between runs")
    # the library: autograd through SDPA, its forward taken untimed
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sg = g.transpose(1, 2).contiguous()
    if km is None:
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=causal)
    else:
        allowed = (km > 0)[:, None, None, :]
        if causal:
            allowed = allowed & torch.ones((Tq, Tk), dtype=torch.bool,
                                           device=dev).tril()
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=allowed)
    library = lambda: torch.autograd.grad(lib_out, (sq, sk, sv), sg,
                                          retain_graph=True)
    lib_err = max(float((a.transpose(1, 2) - b).abs().max())
                  for a, b in zip(library(), want))
    lib_ms, lib_device_ms = median_ms(library), device_ms(library)
    pairs = _valid_pairs(B, Tq, Tk, H, causal, km)
    reads = 4 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + 2 * B * H * Tq
                 + (B * Tk if km is not None else 0))
    recs = []
    for name, writes, ops, err in (
            ("flash_bwd_dq", 4 * B * Tq * H * D, 6 * D * pairs, errs["dq"]),
            ("flash_bwd_dkv", 8 * B * Tk * H * D, 8 * D * pairs,
             max(errs["dk"], errs["dv"]))):
        run, plain = runs[name]
        b_ms, by, bytes_ms, ops_ms = bound(reads + writes, ops)
        recs.append({
            "name": name, "case": label, "shape": [B, Tq, Tk, H, D],
            "causal": causal, "key_mask": km is not None,
            "max_abs_err": err, "lse_max_abs_err": lse_err,
            "library_max_abs_err": lib_err, "ms": median_ms(run),
            "plain_ms": median_ms(plain), "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": by, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "device_ms": device_ms(run),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": lib_device_ms,
            "bitwise_repeat": repeat})
    return recs


def phase_kernels():
    import torch
    gen = torch.Generator().manual_seed(0)
    cases = []
    # prefill shapes: one prompt, buckets 16/64/256, ragged valid length
    for L in (16, 64, 256):
        cases.append(_fwd_case(f"prefill L={L}", 1, L, 4, 64,
                               [L - L // 4 + 1], gen))
    # the training forward: with the log-sum-exp the backward reads
    cases.append(_fwd_case(TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, 4, 64, None,
                           gen, lse=True))
    cases.append(_fwd_case("T=4096", 4, 4096, 8, 64, None, gen))
    # the backward pair: the training shape (twice: bitwise), with a
    # ragged key mask, ragged lengths with Tq != Tk not causal (head dims
    # 16, 64 and 128), and the long shape of bench.py's kernel bench
    cases += _bwd_case(TRAIN_CASE, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 4, 64,
                       True, None, gen, repeat=True)
    cases += _bwd_case("train, ragged key mask", TRAIN_BATCH, TRAIN_SEQ,
                       TRAIN_SEQ, 4, 64, True,
                       [TRAIN_SEQ - 29 * b for b in range(TRAIN_BATCH)], gen)
    for D in (64, 16, 128):
        cases += _bwd_case(f"Tq=37 Tk=53 D={D}", 2, 37, 53, 4, D, False,
                           [53, 20], gen)
    cases += _bwd_case("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None,
                       gen)
    # decode step shape: lengths mixing 1, ragged values and C
    cases.append(_decode_case("step S=8 C=256", 8, 256, 4, 64,
                              [1, 17, 100, 256, 3, 64, 200, 255], gen))
    cases.append(_decode_case("lengths with 0", 4, 256, 4, 64,
                              [0, 1, 256, 37], gen))
    rng = np.random.default_rng(0)
    big = rng.integers(1, 4097, size=64)
    big[0], big[1] = 1, 4096
    cases.append(_decode_case("S=64 C=4096", 64, 4096, 8, 64,
                              [int(x) for x in big], gen))
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    for c in cases:
        lib = "" if c["library_ms"] is None else \
            f" library {c['library_ms']:.4f} ms (device " \
            f"{fmt(c['library_device_ms'])})"
        print(f"{c['name']:<14}{c['case']:<24} err {c['max_abs_err']:.2e} "
              f"kernel {c['ms']:.4f} ms (device {fmt(c['device_ms'])}) "
              f"plain {c['plain_ms']:.4f} ms (device "
              f"{fmt(c['plain_device_ms'])}){lib} bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']})")
    print(json.dumps({"kernel_cases": cases}))
    return cases


# ------------------------------------------------------------------ phase 3
def _full_width_net(use_pallas):
    """`transformer_lm` at the served and trained width, weights from
    `synthetic_params(seed=0)`."""
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm
    net = transformer_lm(**SERVE, use_pallas=use_pallas, device=DEVICE)
    return net.init(params=params_from_jax(
        synthetic_params(net.param_shapes(), seed=0), device=DEVICE))


def _greedy_rows(engine, prompt, n):
    """Greedy decode on slot 0 collecting each emitted token's probs."""
    cache = engine.init_cache()
    cache, nid, probs = engine.prefill(cache, 0, prompt)
    out, rows = [nid], [probs]
    ids = np.zeros((engine.slots,), np.int32)
    while len(out) < n:
        ids[0] = out[-1]
        cache, nxt, p = engine.step(cache, ids)
        out.append(int(nxt[0]))
        rows.append(p[0])
    return out, rows


def _burst(url, prompts):
    """All prompts as concurrent greedy /generate requests: (answers,
    wall seconds)."""
    from deeplearning4j_tpu_torch.util.http import request_json
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(request_json, url,
                            {"prompt": p, "max_new_tokens": N_NEW}, 300)
                for p in prompts]
        answers = [f.result() for f in futs]
    return answers, time.perf_counter() - t0


def phase_serving():
    import torch
    from deeplearning4j_tpu_torch.decode import DecodeEngine
    from deeplearning4j_tpu_torch.kernels import (launch_counts,
                                                  reset_launch_counts)
    from deeplearning4j_tpu_torch.serving import ServingServer
    from deeplearning4j_tpu_torch.util.http import request_json
    from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                      synthetic_params)
    from deeplearning4j_tpu_torch.zoo import transformer_lm

    fixture = json.loads(FIXTURE.read_text())
    check(fixture["model"] == SERVE and fixture["param_seed"] == 0,
          "fixture model differs from the served model")
    rng = np.random.default_rng(1)
    prompts = [list(p) for p in fixture["prompts"]] + [
        [int(t) for t in rng.integers(0, SERVE["vocab_size"], size=n)]
        for n in (8, 16, 33, 57)]

    net = _full_width_net(True)
    plain_net = _full_width_net(False)
    # the repo's own check on a small input: the kernel model's output
    # equals the plain model's, finite, of the expected shape
    x = np.eye(SERVE["vocab_size"], dtype=np.float32)[prompts[1]][None]
    y, y_plain = net.output(x), plain_net.output(x)
    check(tuple(y.shape) == (1, len(prompts[1]), SERVE["vocab_size"])
          and bool(torch.isfinite(y).all()), "output(): bad shape or values")
    out_err = float((y - y_plain).abs().max())
    check(out_err <= 1e-5, f"output(): kernel vs plain max err {out_err}")

    srv = ServingServer(net, decode=True, decode_slots=8,
                        decode_max_len=256).start()
    try:
        url = srv.url + "/generate"
        status, _ = request_json(url, {"prompt": prompts[0],
                                       "max_new_tokens": 4}, timeout=300)
        check(status == 200, f"warm-up request answered {status}")
        srv.decode.ttft_ms.clear()
        srv.decode.itl_ms.clear()
        reset_launch_counts()
        answers, wall = _burst(url, prompts)
        counts = launch_counts()
        snap = srv.decode.snapshot()
        # a second, traced burst: where the device time goes (the numbers
        # above come from the untraced one)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced, traced_wall = _burst(url, prompts)
            torch.cuda.synchronize()
    finally:
        srv.stop()
    check([b["tokens"] for _, b in traced] == [b["tokens"] for _, b in answers],
          "the traced burst generated other tokens")
    kernels_us = sorted(((e.key, float(e.self_device_time_total), e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy_ms = sum(t for _, t, _ in kernels_us) / 1e3
    profile_summary = {
        "wall_ms": traced_wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (traced_wall * 1e3),
        "top_kernels": [{"kernel": k[:72], "device_ms": t / 1e3,
                         "count": n} for k, t, n in kernels_us[:8]]}
    statuses = [s for s, _ in answers]
    check(statuses == [200] * len(prompts), f"statuses {statuses}")
    served = [body["tokens"] for _, body in answers]
    check(all(len(t) == N_NEW for t in served), "short generations")
    for name in ("flash_fwd", "flash_decode"):
        check(counts[name] > 0,
              f"kernel {name} never launched on the serving path")
    check(counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0,
          "a backward kernel launched on the serving path")

    eng = DecodeEngine(plain_net, slots=8, max_len=256)
    for i, (p, got) in enumerate(zip(prompts, served)):
        want, rows = _greedy_rows(eng, p, N_NEW)
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                top2 = np.sort(rows[t])[-2:]
                gap = float(top2[1] - top2[0])
                print(f"request {i}: token {t} differs ({a} vs plain {b}),"
                      f" top-2 gap {gap:.3e}")
                check(gap < TIE_GAP, f"request {i} token {t}: kernel path "
                                     f"{a} != plain path {b} (gap {gap})")
                break
    n_fix = fixture["max_new_tokens"]
    for i, want in enumerate(fixture["tokens"]):
        check(served[i][:n_fix] == want,
              f"fixture prompt {i}: served {served[i][:n_fix]} != JAX "
              f"{want}")
    n_tok = sum(len(t) for t in served)
    summary = {"requests": len(prompts), "status_200": statuses.count(200),
               "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
               "ttft_ms_p50": float(np.median([b["ttft_ms"]
                                               for _, b in answers])),
               "itl_ms_p50": snap["itl_ms_p50"], "launches": counts,
               "output_err_vs_plain": out_err,
               "fixture_prompts_match": len(fixture["tokens"])}
    print(json.dumps({"serving": summary}))
    print(json.dumps({"serving_profile": profile_summary}))
    return summary


# ------------------------------------------------------------------ phase 4
def _one_hot_batch(batch, seq):
    """Next-token one-hot (x, y) on the card, ids from
    np.random.default_rng(0) of shape [batch, seq + 1] (bench.py:501-505
    and tests/test_torch_train_fixture.py)."""
    import torch
    ids = np.random.default_rng(0).integers(0, SERVE["vocab_size"],
                                            size=(batch, seq + 1))
    ids = torch.as_tensor(ids, device=DEVICE)
    eye = torch.eye(SERVE["vocab_size"], dtype=torch.float32, device=DEVICE)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def phase_training():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.kernels import (launch_counts,
                                                  reset_launch_counts)
    fixture = json.loads(TRAIN_FIXTURE.read_text())
    check(fixture["model"] == SERVE and fixture["param_seed"] == 0
          and fixture["data_seed"] == 0,
          "training fixture model differs from the trained model")
    # the card against the JAX package: the fixture's per-step scores
    net = _full_width_net(True)
    x, y = _one_hot_batch(fixture["batch"], fixture["seq"])
    fix_scores = []
    for _ in fixture["scores"]:
        net.fit(x, y)
        fix_scores.append(net.score_value)
    check(np.allclose(fix_scores, fixture["scores"], rtol=SCORE_RTOL, atol=0),
          f"training fixture: card scores {fix_scores} != JAX "
          f"{fixture['scores']}")

    x, y = _one_hot_batch(TRAIN_BATCH, TRAIN_SEQ)
    runs = {}
    for use_pallas in (True, False):
        net = _full_width_net(use_pallas)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        scores, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            net.fit(x, y)
            scores.append(net.score_value)      # waits for the step
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[use_pallas] = dict(net=net, scores=scores, times=times,
                                launches=launch_counts(),
                                peak_mb=torch.cuda.max_memory_allocated()
                                / 2**20)
    kern, plain = runs[True], runs[False]
    want = TRAIN_STEPS * SERVE["n_layers"]
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(kern["launches"][name] == want,
              f"{name} launched {kern['launches'][name]} times in "
              f"{TRAIN_STEPS} steps, not {want}")
    check(kern["launches"]["flash_decode"] == 0,
          "flash_decode launched on the training path")
    check(set(plain["launches"].values()) == {0},
          f"the plain path launched kernels: {plain['launches']}")
    check(all(np.isfinite(kern["scores"])), "non-finite training score")
    check(np.allclose(kern["scores"], plain["scores"], rtol=SCORE_RTOL,
                      atol=0),
          f"kernel path scores {kern['scores']} != plain path "
          f"{plain['scores']}")
    check(kern["scores"][-1] < kern["scores"][0],
          f"the score did not fall: {kern['scores']}")

    # one more step on the kernel path, traced: where the device time goes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern["net"].fit(x, y)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels_us = sorted(((e.key, float(e.self_device_time_total), e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda e: -e[1])
    busy_ms = sum(t for _, t, _ in kernels_us) / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step = {p: float(np.median(r["times"])) for p, r in runs.items()}
    summary = {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "scores_kernel_path": kern["scores"],
        "scores_plain_path": plain["scores"],
        "max_score_rel_diff": float(np.max(
            np.abs(np.subtract(kern["scores"], plain["scores"]))
            / np.abs(plain["scores"]))),
        "fixture_scores_card": fix_scores,
        "fixture_scores_jax": fixture["scores"],
        "step_ms_p50_kernel_path": step[True] * 1e3,
        "step_ms_p50_plain_path": step[False] * 1e3,
        "step_ms_kernel_path": [t * 1e3 for t in kern["times"]],
        "step_ms_plain_path": [t * 1e3 for t in plain["times"]],
        "tokens_per_s_kernel_path": tokens / step[True],
        "tokens_per_s_plain_path": tokens / step[False],
        "peak_mb_kernel_path": kern["peak_mb"],
        "peak_mb_plain_path": plain["peak_mb"],
        "launches": kern["launches"],
        "profiled_step": {
            "wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / traced_ms,
            "top_kernels": [{"kernel": k[:72], "device_ms": t / 1e3,
                             "count": n} for k, t, n in kernels_us[:10]]}}
    print(json.dumps({"training": summary}))
    return summary


# ------------------------------------------------------------------ main
_FA = "deeplearning4j_tpu/kernels/flash_attention.py"
REPLACES = {
    "flash_fwd": f"{_FA}:84 (_flash_kernel, pallas_call :206, via "
                 "flash_attention :512; with the LSE under its custom_vjp "
                 ":430-450 on the training path)",
    "flash_decode": f"{_FA}:84 (_flash_kernel, pallas_call :206, via "
                    "flash_decode :604)",
    "flash_bwd_dq": f"{_FA}:226 (_bwd_dq_kernel, pallas_call :366, via "
                    "the custom_vjp of flash_attention :430-450)",
    "flash_bwd_dkv": f"{_FA}:276 (_bwd_dkv_kernel, pallas_call :388, via "
                     "the custom_vjp of flash_attention :430-450)",
}
_CSRC = "deeplearning4j_tpu_torch/kernels/csrc"
SOURCES = {"flash_fwd": f"{_CSRC}/flash_fwd.cu",
           "flash_decode": f"{_CSRC}/flash_decode.cu",
           "flash_bwd_dq": f"{_CSRC}/flash_bwd.cu",
           "flash_bwd_dkv": f"{_CSRC}/flash_bwd.cu"}
# each kernel's main path and the case whose shape that path runs
MAIN_PATH = {"flash_fwd": ("training", TRAIN_CASE),
             "flash_decode": ("serving", "step S=8 C=256"),
             "flash_bwd_dq": ("training", TRAIN_CASE),
             "flash_bwd_dkv": ("training", TRAIN_CASE)}


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    smi = phase_card()
    cases = phase_kernels()
    launches = {"serving": phase_serving()["launches"],
                "training": phase_training()["launches"]}
    kernels = []
    for name, (path, case) in MAIN_PATH.items():
        c = next(c for c in cases if c["name"] == name and c["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[path][name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "main_path": path, "case": case,
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "device_ms": c["device_ms"],
            "plain_device_ms": c["plain_device_ms"],
            "library_device_ms": c["library_device_ms"]})
    print(smi)              # the card's name and power limit, again
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
