"""Sampled decoding: temperature / top-k / top-p with per-request seeds
(counterpart of deeplearning4j_tpu/decode/sampling.py).

The per-slot parameters travel as [slots]-shaped numpy operands, as in the
JAX package, so greedy and sampled requests share one step:

  temperature f32[slots]   <= 0 means greedy (argmax) for that slot
  top_k       i32[slots]   <= 0 means off (full vocab)
  top_p       f32[slots]   >= 1 means off; always keeps the top-1 token
  seed        u32[slots]   per-request seed
  step        i32[slots]   index of the token being sampled

Top-k / top-p use the same sort/cumsum filter at the logit level with the
finite NEG_INF. Slot s draws token t from a `torch.Generator` seeded from
(seed[s], step[s]), so a sampled stream reproduces within the port; it is
not JAX's `fold_in` stream and is never compared with it.

`filter_probs_np` is the numpy mirror of the same filter (the JAX
package's, copied), for host-side consumers: the speculative engine's
accept/rejection math runs on the filtered distributions.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


class SamplerConfig:
    """One request's sampling parameters. The default config is greedy."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF
        if not np.isfinite(self.temperature):
            raise ValueError("temperature must be finite")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")
        if not (0.0 <= self.top_p):
            raise ValueError("top_p must be >= 0")

    @property
    def is_greedy(self):
        return self.temperature <= 0.0

    @classmethod
    def from_request(cls, d):
        """Build from a /generate JSON body; None when the body carries no
        sampling field."""
        if not any(k in d for k in ("temperature", "top_k", "top_p", "seed")):
            return None
        return cls(temperature=d.get("temperature", 0.0),
                   top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
                   seed=d.get("seed", 0))

    def to_dict(self):
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}

    def __repr__(self):
        return (f"SamplerConfig(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, seed={self.seed})")


GREEDY = SamplerConfig()


def batch_operands(slots, configs=None, steps=None):
    """The step's sampling operand dict of numpy [slots] arrays. configs:
    {slot: SamplerConfig} (missing slots decode greedily); steps: {slot:
    index of the token being sampled}."""
    ops = {"temperature": np.zeros((slots,), np.float32),
           "top_k": np.zeros((slots,), np.int32),
           "top_p": np.ones((slots,), np.float32),
           "seed": np.zeros((slots,), np.uint32),
           "step": np.zeros((slots,), np.int32)}
    for slot, cfg in (configs or {}).items():
        if cfg is None:
            continue
        ops["temperature"][slot] = cfg.temperature
        ops["top_k"][slot] = cfg.top_k
        ops["top_p"][slot] = cfg.top_p
        ops["seed"][slot] = cfg.seed
    for slot, t in (steps or {}).items():
        ops["step"][slot] = int(t)
    return ops


def slot_operands(config, step):
    """[1]-shaped operand dict for the prefill (one slot at a time)."""
    cfg = config if config is not None else GREEDY
    return batch_operands(1, {0: cfg}, {0: step})


def keep_mask(probs, top_k, top_p):
    """[S, V] bool mask of tokens that survive top-k AND top-p (the JAX
    package's filter: top-k keeps probs >= the k-th largest, top-p keeps
    the descending prefix whose exclusive cumsum is < p, top-1 always)."""
    V = probs.shape[-1]
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    k = torch.clamp(top_k, 1, V).to(torch.int64)
    kth = torch.gather(sorted_p, 1, (k - 1)[:, None])
    k_on = ((top_k > 0) & (top_k < V))[:, None]
    keep_k = torch.where(k_on, probs >= kth, torch.ones_like(k_on))
    excl = torch.cumsum(sorted_p, dim=-1) - sorted_p
    pos0 = torch.arange(V, device=probs.device)[None, :] == 0
    keep_sorted = (excl < top_p[:, None]) | pos0
    min_kept = torch.where(keep_sorted, sorted_p,
                           torch.full_like(sorted_p, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    keep_p = torch.where((top_p < 1.0)[:, None], probs >= min_kept,
                         torch.ones_like(k_on))
    return keep_k & keep_p


def _draw_seed(seed, step):
    return (int(seed) << 32) | (int(step) & 0xFFFFFFFF)


def sample_tokens(probs, operands):
    """[S, V] f32 probs + the operand dict -> [S] int32 ids (a tensor on
    the probs' device). Greedy slots take the argmax; sampled slots draw
    from softmax(logits / T) with the top-k/top-p mask at the logit
    level."""
    greedy = torch.argmax(probs, dim=-1).to(torch.int32)
    temperature = np.asarray(operands["temperature"], np.float32)
    sampled = np.nonzero(temperature > 0)[0]
    if sampled.size == 0:
        return greedy
    dev = probs.device
    keep = keep_mask(probs,
                     torch.as_tensor(operands["top_k"], device=dev),
                     torch.as_tensor(operands["top_p"], device=dev))
    t = torch.as_tensor(np.maximum(temperature, 1e-6), device=dev)[:, None]
    logits = torch.log(torch.clamp(probs, min=1e-30)) / t
    logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    rows = torch.softmax(logits[torch.as_tensor(sampled, device=dev)]
                         .double().cpu(), dim=-1)
    out = greedy.cpu().clone()
    for i, s in enumerate(sampled):
        g = torch.Generator().manual_seed(
            _draw_seed(operands["seed"][s], operands["step"][s]))
        out[int(s)] = int(torch.multinomial(rows[i], 1, generator=g))
    return out.to(dev)


def filter_probs_np(probs, config):
    """The normalized float64 distribution a sampled slot draws from:
    `probs` through the top-k / top-p filter and the temperature, in numpy
    (JAX sampling.py:187-213); a greedy config gives the one-hot argmax
    row."""
    p = np.asarray(probs, np.float64).reshape(-1)
    V = p.shape[0]
    if config is None or config.is_greedy:
        out = np.zeros_like(p)
        out[int(np.argmax(p))] = 1.0
        return out
    order = np.argsort(-p, kind="stable")
    sorted_p = p[order]
    keep = np.ones((V,), bool)
    if 0 < config.top_k < V:
        keep &= p >= sorted_p[config.top_k - 1]
    if config.top_p < 1.0:
        excl = np.cumsum(sorted_p) - sorted_p
        keep_sorted = excl < config.top_p
        keep_sorted[0] = True
        keep &= p >= sorted_p[keep_sorted].min()
    logits = np.log(np.clip(p, 1e-30, None)) / max(config.temperature, 1e-6)
    logits[~keep] = -np.inf
    logits -= logits.max()
    e = np.exp(logits)
    return e / e.sum()
