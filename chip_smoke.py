#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Card and toolchain: prints `nvidia-smi`'s name and power limit and the
   torch/CUDA versions, turns TF32 off for matmuls and cuDNN, and builds
   every hand kernel from the sources in this checkout (nvcc, sm_90a).
2. Kernels against their plain PyTorch versions, on the card: `flash_fwd`
   at the prefill shapes and at a shape large enough to time, and
   `flash_decode` at the decode-step shape and a large cache. Max abs
   error <= 1e-4 (outputs are O(1); the only difference is the order of
   sums). Times are CUDA-event medians; `bound_ms` is the larger of bytes
   over 3.35 TB/s and operations over 67 TFLOP/s (f32 off the tensor
   cores, TF32 being off); `library_ms` times
   `scaled_dot_product_attention` on the same inputs (for `flash_decode`
   with a boolean length mask, where every slot has a valid key).
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
4. One line `{"kernels": [...]}` with each kernel's numbers, then the last
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
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12      # H100 SXM f32 outside the tensor cores
TOL = 1e-4
TIE_GAP = 1e-6
SERVE = dict(vocab_size=256, d_model=256, n_layers=4, n_heads=4)
N_NEW = 32


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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return smi


# ------------------------------------------------------------------ phase 2
def _fwd_case(label, B, T, H, D, valid, gen):
    """One flash_fwd case: causal, key mask from `valid` (per-batch valid
    prefix length or None). Returns its record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain)
    dev = torch.device("cuda")
    q, k, v = (torch.randn((B, T, H, D), generator=gen).to(dev)
               for _ in range(3))
    km = None
    if valid is not None:
        km = (torch.arange(T)[None, :] < torch.as_tensor(valid)[:, None]
              ).to(torch.float32).to(dev)
    run = lambda: flash_attention(q, k, v, causal=True, key_mask=km)
    plain = lambda: flash_attention_plain(q, k, v, causal=True, key_mask=km)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    torch.cuda.synchronize()
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
    n_valid = [T] * B if valid is None else list(valid)
    pairs = sum(min(i + 1, n) for n in n_valid for i in range(T)) * H
    nbytes = 4 * (4 * B * T * H * D) + (4 * B * T if km is not None else 0)
    b_ms, by, bytes_ms, ops_ms = bound(nbytes, 4 * D * pairs)
    rec = {"name": "flash_fwd", "case": label,
           "shape": [B, T, H, D], "causal": True,
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
    dev = torch.device("cuda")
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


def phase_kernels():
    import torch
    gen = torch.Generator().manual_seed(0)
    cases = []
    # prefill shapes: one prompt, buckets 16/64/256, ragged valid length
    for L in (16, 64, 256):
        cases.append(_fwd_case(f"prefill L={L}", 1, L, 4, 64,
                               [L - L // 4 + 1], gen))
    cases.append(_fwd_case("T=4096", 4, 4096, 8, 64, None, gen))
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
        print(f"{c['name']:<13}{c['case']:<17} err {c['max_abs_err']:.2e} "
              f"kernel {c['ms']:.4f} ms (device {fmt(c['device_ms'])}) "
              f"plain {c['plain_ms']:.4f} ms (device "
              f"{fmt(c['plain_device_ms'])}){lib} bound "
              f"{c['bound_ms']:.5f} ms ({c['bound_by']})")
    print(json.dumps({"kernel_cases": cases}))
    return cases


# ------------------------------------------------------------------ phase 3
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

    def make(use_pallas):
        net = transformer_lm(**SERVE, use_pallas=use_pallas)
        params = synthetic_params(net.param_shapes(), seed=0)
        return net.init(params=params_from_jax(params))

    net = make(True)
    plain_net = make(False)
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
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the serving path")

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


# ------------------------------------------------------------------ main
REPLACES = {
    "flash_fwd": "deeplearning4j_tpu/kernels/flash_attention.py:84 "
                 "(_flash_kernel, pallas_call :206, via flash_attention "
                 ":512)",
    "flash_decode": "deeplearning4j_tpu/kernels/flash_attention.py:84 "
                    "(_flash_kernel, pallas_call :206, via flash_decode "
                    ":604)",
}
SOURCES = {"flash_fwd": "deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
           "flash_decode":
               "deeplearning4j_tpu_torch/kernels/csrc/flash_decode.cu"}
# the case of each kernel whose shape the serving path runs
MAIN_PATH_CASE = {"flash_fwd": "prefill L=64", "flash_decode": "step S=8 C=256"}


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
    phase_card()
    cases = phase_kernels()
    serving = phase_serving()
    kernels = []
    for name in ("flash_fwd", "flash_decode"):
        c = next(c for c in cases
                 if c["name"] == name and c["case"] == MAIN_PATH_CASE[name])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serving["launches"][name],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
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
