"""Rematerialization of the training forward (counterpart of
deeplearning4j_tpu/nn/remat.py).

The JAX package wraps the training forward in `jax.checkpoint` under a
named policy; the port wraps it in `torch.utils.checkpoint.checkpoint`
(non-reentrant). A policy decides which forward values the backward keeps
and which it recomputes:

- "full": nothing inside is kept but the inputs; the backward re-runs the
  whole forward (`jax.checkpoint` without a policy).
- "dots": the products are kept, everything else is recomputed
  (`checkpoint_dots` keeps every `dot_general`).
- "dots_no_batch": only the products without a batch dimension are kept
  (`checkpoint_dots_with_no_batch_dims`).
- "convs_and_dots": the products and the convolutions are kept (JAX
  keeps `conv_general_dilated` and `dot_general`).

The three selective policies run on torch's selective checkpointing
(`create_selective_checkpoint_contexts`): an op of the policy's list is
MUST_SAVE, any other PREFER_RECOMPUTE. The lists name the ATen ops the
port's forwards reach at dispatch, on the host and on the card:
`torch.matmul` of an activation and a kernel (`nn/layers/base.matmul`)
reaches `mm` (the batch folded into the rows), `einsum` and a batched
matmul `bmm`, `F.linear` `addmm`, a batched product with a bias
`baddbmm`; `F.conv2d` reaches `convolution` (the backend's kernels,
`cudnn_convolution` and the others, run beneath it and are listed for
torch builds that dispatch them). A hand-written attention kernel is no
ATen op: its autograd Function re-runs in the recompute under every
policy, as a `pallas_call` is no `dot_general` in JAX. (On the host the
plain version inside that Function dispatches `bmm`, which the two
batched policies keep like any other product.)

The backward re-runs a checkpointed function in full (no early stop), so
the recompute makes the same random draws as the forward did: a
`recompute_rng` (a layer's dropout draws) is switched to its twin
generator for the recompute and back, so that dropout draws the same
masks twice (`nn/layers/base.LayerDraws`); torch's own RNG state is not
stashed (`preserve_rng_state=False`): nothing in the port's forwards
draws from the default generators, and their state cannot be read while
a CUDA graph captures. The graph checkpoints each layer on its own
(`ComputationGraph._loss` says why)."""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

_aten = torch.ops.aten


def _ops(*names):
    """The `.default` overloads of the named ATen ops this torch has."""
    return tuple(getattr(_aten, n).default for n in names if hasattr(_aten, n))


DOTS_NO_BATCH = _ops("mm", "addmm")
DOTS = DOTS_NO_BATCH + _ops("bmm", "baddbmm")
CONVS = _ops("convolution", "_convolution", "cudnn_convolution",
             "mkldnn_convolution", "miopen_convolution",
             "convolution_overrideable")

# the ops each selective policy keeps; "full" keeps none
POLICIES = {"full": None, "dots": DOTS, "dots_no_batch": DOTS_NO_BATCH,
            "convs_and_dots": DOTS + CONVS}


def _policy(saved):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _contexts(saved, recompute_rng):
    """(forward context, recompute context) of one checkpointed call: the
    selective policy's dispatch modes (none for "full") and, around them,
    the dropout stream's forward and recompute draws."""
    fwd, rec = ((contextlib.nullcontext(), contextlib.nullcontext())
                if saved is None else
                create_selective_checkpoint_contexts(_policy(saved)))
    if recompute_rng is None:
        return fwd, rec
    return (_stack(recompute_rng.forward_region(), fwd),
            _stack(recompute_rng.recompute_region(), rec))


@contextlib.contextmanager
def _stack(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def maybe_checkpoint(fn, mode, recompute_rng=None):
    """`fn` wrapped in a non-reentrant checkpoint under the named policy;
    `fn` itself when `mode` is falsy. An unknown mode raises ValueError, as
    the JAX package does (a typo training without remat would pass
    unseen). `recompute_rng`: the dropout draws the recompute must
    repeat (None: `fn` draws nothing)."""
    if not mode:
        return fn
    if mode not in POLICIES:
        raise ValueError(f"unknown remat mode {mode!r}; "
                         f"one of {sorted(POLICIES)}")
    context_fn = functools.partial(_contexts, POLICIES[mode], recompute_rng)

    @functools.wraps(fn)
    def checkpointed(*args, **kwargs):
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=context_fn, **kwargs)
    return checkpointed
