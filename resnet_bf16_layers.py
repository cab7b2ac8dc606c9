#!/usr/bin/env python3
"""Where ResNet-50's bf16 compute departs from float32, vertex by vertex.

    python3 resnet_bf16_layers.py [--device cuda|cpu] [--out FILE]

The model and data of the JAX fixture tests/fixtures/torch_port_resnet50.json
(full-depth `resnet50(num_classes=1000, image_size=64)`, weights from
`synthetic_params(seed=0)`, running statistics from `synthetic_states(seed=0)`,
the fixture's batches of 4 and 32) through the port's first training step:
the training-mode forward, its score and the gradient of every parameter.
Float32 (TF32 off) is the reference. bf16 compute (`compute_dtype=
"bfloat16"`) runs in two variants of its products:
- "native": as the port runs them (on the card cuDNN's bf16 convolutions);
- "rounded": every bf16 product computed on the float32 operands and its
  result rounded once, the host's rule in `device.bf16_product`, here
  forced on any device.
On the host the two are the same computation. Per batch it prints (JSON):
- each variant's first score, its relative gap to float32 and to JAX's
  bf16 score in the fixture;
- each variant's per-parameter gradient norms scaled to the first update
  (lr · (1 + momentum) · |g|, Nesterovs' first step) against float32's
  and against JAX's bf16 `update_norms_step1` in the fixture, and at the
  batch of 4 float32's against JAX's float32 ones: the largest relative
  gap (and its key), the median, the output layer's, the medians over the
  last stage and over the stem and first stage; beside them JAX's own
  gaps under its input scaled by 1 + 1e-6 (the fixture's
  `update_norms_step1_input_scaled`);
- per vertex, the relative L2 gap of each variant's activation to the
  float32 one (accumulated along the graph) and the gap between the two
  variants;
- per layer vertex, the local gap: the layer run on the float32 input cast
  to bf16, each variant against the float32 layer on the float32 input,
  and for the convolutions the share of outputs where the variants differ
  and the share where they differ by more than one bf16 unit in the last
  place (of the larger: a sum that cancels can differ by several).
The per-vertex rows go to FILE (default chiprun_out/resnet_bf16_layers.json).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_resnet50.json"
RUNS = {4: "bfloat16", 32: "bfloat16_batch32"}     # fixture runs by batch


def _rel(a, b):
    """Relative L2 gap of tensor a to reference b (float64)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _ulps(a, b):
    """(share of elements that differ, share that differ by more than one
    unit in the last place of the larger of the two) of two bf16
    tensors."""
    import torch
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return (float((diff > 0).double().mean()),
            float((diff > ulp).double().mean()))


def _rounded(fn, a, b):
    """The host's bf16 product rule on any device."""
    import torch
    if a.dtype == b.dtype == torch.bfloat16:
        return fn(a.float(), b.float()).to(torch.bfloat16)
    return fn(a, b)


class _Products:
    """Context: the port's bf16 products in `variant` ("native" leaves
    them as they are)."""

    def __init__(self, variant):
        self.variant = variant

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn.layers import base, convolution
        self.mods = (base, convolution)
        self.saved = [m.bf16_product for m in self.mods]
        if self.variant == "rounded":
            for m in self.mods:
                m.bf16_product = _rounded

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.bf16_product = f


def _net(compute_dtype, model, device):
    """chip_smoke's ResNet-50 (synthetic weights and running statistics,
    Nesterovs(0.05, 0.9)) on `device`."""
    import chip_smoke
    chip_smoke.DEVICE = device
    return chip_smoke._resnet(compute_dtype, **model)


def _acts(net, x):
    """Every vertex's activation of the training-mode forward."""
    import torch
    with torch.no_grad():
        params, xs = net._cast_for_compute(net.params, [x])
        acts, _, _ = net._forward(params, net.states, xs, train=True,
                                  skip=net._loss_only)
    return acts


def _step(net, x, y):
    """(first score, {key: lr (1 + m) |g|}) of the training step."""
    from chip_smoke import RESNET_LR, RESNET_MOMENTUM
    score, grads, _ = net._value_and_grad([x], [y], None, None, train=True)
    scale = RESNET_LR * (1 + RESNET_MOMENTUM)
    return float(score), {f"{n}/{k}": scale * float(g.double().norm())
                          for n, gs in grads.items() for k, g in gs.items()}


def _gaps(upd, ref):
    """Relative gaps of update norms `upd` to the fixture's `ref`: the
    largest (and its key), the median, the output layer's largest, and the
    medians over the last stage (s5) and over the stem and first stage."""
    gap = {k: abs(upd[k] - ref[k]) / ref[k] for k in sorted(ref)}
    worst = max(gap, key=gap.get)
    part = lambda *pre: float(np.median([g for k, g in gap.items()
                                         if k.startswith(pre)]))
    return {"max": gap[worst], "worst": worst,
            "median": float(np.median(list(gap.values()))),
            "out": max(g for k, g in gap.items() if k.startswith("out/")),
            "s5_median": part("s5"), "stem_s2_median": part("stem", "s2")}


def _local(net16, ref, name, variant):
    """Vertex `name` of the bf16 net on the float32 inputs cast to bf16."""
    import torch
    spec = net16.conf.vertices[name]
    params, _ = net16._cast_for_compute(net16.params, [])
    xs = [ref[i].to(torch.bfloat16) for i in spec.inputs]
    with torch.no_grad(), _Products(variant):
        if spec.kind == "layer":
            return net16.layers[name].forward(
                params[name], net16.states[name], xs[0], train=True)[0]
        return spec.vertex_conf.apply(xs)


def probe(batch, device):
    import torch
    fixture = json.loads(FIXTURE.read_text())
    want = fixture[RUNS[batch]]
    model = fixture["model"]
    from chip_smoke import _image_batch
    x, y = (torch.as_tensor(a, device=device)
            for a in _image_batch(batch, model["image_size"]))
    net32 = _net(None, model, device)
    net16 = _net("bfloat16", model, device)
    ref = _acts(net32, x)
    score32, upd32 = _step(net32, x, y)
    variants = ("native",) if device == "cpu" else ("native", "rounded")
    acts, summary = {}, {"batch": batch, "score_f32": score32,
                         "score_jax_bf16": want["scores"][0],
                         "score_jax_f32": fixture["float32"]["scores"][0]
                         if batch == 4 else None}
    jax_upd = want["update_norms_step1"]
    for v in variants:
        with _Products(v):
            acts[v] = _acts(net16, x)
            score, upd = _step(net16, x, y)
        summary[v] = {"score": score,
                      "score_gap_f32": abs(score - score32) / score32,
                      "score_gap_jax_bf16": abs(score - want["scores"][0])
                      / want["scores"][0],
                      "update_gap_f32": _gaps(upd, upd32),
                      "update_gap_jax_bf16": _gaps(upd, jax_upd)}
    summary["jax_bf16_own_update_gap_input_scaled"] = _gaps(
        want["update_norms_step1_input_scaled"], jax_upd)
    if batch == 4:
        jax32 = fixture["float32"]
        summary["f32_update_gap_jax_f32"] = _gaps(
            upd32, jax32["update_norms_step1"])
        summary["jax_f32_own_update_gap_input_scaled"] = _gaps(
            jax32["update_norms_step1_input_scaled"],
            jax32["update_norms_step1"])
    rows = []
    for name in net16.order:
        if name not in acts["native"] or net16.conf.vertices[
                name].kind == "input":
            continue
        row = {"vertex": name, "kind": type(
            net16.layers[name].conf).__name__ if name in net16.layers
            else "add"}
        for v in variants:
            row[f"acc_{v}"] = _rel(acts[v][name], ref[name])
            row[f"local_{v}"] = _rel(_local(net16, ref, name, v),
                                     ref[name])
        if "rounded" in variants:
            row["acc_native_vs_rounded"] = _rel(acts["native"][name],
                                                acts["rounded"][name])
            if row["kind"] == "ConvolutionLayer":
                shares = _ulps(_local(net16, ref, name, "native"),
                               _local(net16, ref, name, "rounded"))
                row["local_differ_share"] = shares[0]
                row["local_over_1ulp_share"] = shares[1]
        rows.append(row)
    for v in variants:
        summary[v]["acc_gap_last"] = rows[-1][f"acc_{v}"]
        for kind in ("ConvolutionLayer", "BatchNormalization"):
            loc = [r[f"local_{v}"] for r in rows if r["kind"] == kind]
            summary[v][f"local_{kind}_median"] = float(np.median(loc))
    if "rounded" in variants:
        conv = [r for r in rows if r["kind"] == "ConvolutionLayer"]
        summary["conv_differ_share_median"] = float(np.median(
            [r["local_differ_share"] for r in conv]))
        summary["conv_differ_share_max"] = float(max(
            r["local_differ_share"] for r in conv))
        summary["conv_over_1ulp_share_max"] = float(max(
            r["local_over_1ulp_share"] for r in conv))
    return summary, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "resnet_bf16_layers.json"))
    args = ap.parse_args()
    import torch
    if args.device != "cpu":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device is visible; pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    result = {}
    for batch in RUNS:
        summary, rows = probe(batch, args.device)
        print(json.dumps({"summary": summary}), flush=True)
        result[batch] = {"summary": summary, "vertices": rows}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
