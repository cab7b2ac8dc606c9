#!/usr/bin/env python3
"""A/B of the attention kernels between two checkouts on one GPU.

    python3 chip_ab.py run ROOT LABEL [f32|decode|wide|wide_bwd|rank]
    python3 chip_ab.py run ROOT LABEL wide_bwd_bf16
    python3 chip_ab.py run ROOT LABEL d256
    python3 chip_ab.py run ROOT LABEL d256_bwd
    python3 chip_ab.py run ROOT LABEL d128_bwd
    python3 chip_ab.py run ROOT LABEL d32_bwd_bf16
    python3 chip_ab.py run ROOT LABEL d32_fwd_bf16
    python3 chip_ab.py run ROOT LABEL padded_bwd_bf16
    python3 chip_ab.py run ROOT LABEL padded_fwd
    python3 chip_ab.py run ROOT LABEL d32_bwd_f32
    python3 chip_ab.py run ROOT LABEL padded_bwd_f32
    python3 chip_ab.py run ROOT LABEL SET --no-gates   # any set above
    python3 chip_ab.py summary LOG...         # table of the turns
    python3 chip_ab.py sweep ROOT LABEL       # decode at each cluster size

`run` imports ROOT's own `chip_smoke.py` and port package (ROOT first on
sys.path), builds ROOT's kernels (phase 1: ptxas's report), and runs one
set of cases through ROOT's own case functions. By default the bf16
kernels: phase 2's `_bf16_case` at the train case (bitwise twice), with a
ragged key mask, at Tq=37 Tk=53 (D=64, 16, 128), B=4 T=4096 H=8, B=2
T=4096 H=8 D=128 and B=2 T=200 H=4 D=128 with a ragged key mask, then
phase 7's `_lse_case` on the ring's bf16 shard (diagonal and past, each
with and without a ragged key mask, and offsets 0/512). With `f32`, the
float32 kernels: phase 2's `_fwd_case` at the prefill shapes (B=1 L=16,
64, 256 H=4, a ragged key mask), at the train case with the LSE and at
B=4 T=4096 H=8; the backward pair's `_bwd_case` at the train case
(bitwise twice), with a ragged key mask, at Tq=37 Tk=53 (D=64, 16, 128)
and B=4 T=4096 H=8; then phase 7's `_lse_case` on the float32 shard
(B=1 T=1024 H=4, the same five offset and mask cases; it times the
forward too). With `decode`, the two decode kernels: phase 2's
`_decode_case` at the serving step (S=8 C=256 H=4 D=64), with a length
0, at S=64 C=4096 H=8 and at bench_decode_paged's shape (S=4 C=128 H=4
D=32), and `_paged_case` at the served step (block size 16, 16 blocks a
slot), at block sizes 8 and 64, at S=64 with 256 blocks of 16 and at
bench_decode_paged's shape; a checkout whose case functions time the
decode grid's launch floor and count the kernels a call launches adds
them to each record. With `wide`, the forward above head dim 256 in
float32 and bfloat16 (`_forward_case` below, the same measurement on
either checkout, through ROOT's `flash_attention`): the D=320 model's
training shape (B=4 T=128 H=2, causal, with the LSE), B=2 T=200 H=4
causal with a ragged key mask at D=264, 320, 512 and 1024, and the long
causal shapes with the LSE, B=2 T=4096 H=4 D=512 and B=1 T=4096 H=4
D=1024; then phase 2b's `_wide_decode_case` (the f32 decode step through
the wide forward, S=8 C=256 H=4 D=320, slab and paged with blocks of
16). With `wide_bwd`, the float32 backward pair above head dim 256
(phase 2's `_bwd_case`, gated against the plain versions) at the same
causal shapes: the D=320 model's training shape, the ragged cases at
D=264, 320, 512 and 1024 and the two long shapes. With
`wide_bwd_bf16`, the bfloat16 kernels above head dim 256 at the same
seven shapes (phase 2's `_bf16_case`: the forward with the LSE, then the
pair, gated against the plain versions). With `d256`, the float32
forward at head dim 256 (`_forward_case`, the same code on either
checkout): causal with the LSE unless named, the train case B=16 T=512
H=1, B=2 T=200 H=4 with a ragged key mask at D=256 and at D=192 (zero-
padded to 256), the long B=2 T=4096 H=4, the prefill shape B=1 L=64 H=4
with a key mask and no LSE, Tq=37 Tk=53 not causal with a key mask,
B=8 T=512 H=4 with a ragged key mask (every grid over one wave), and
`flash_attention_lse` at B=1 T=1024 H=2 on a diagonal shard, a past one
and offsets 0/512 (rows 0..511 see no key: out 0, lse <= -1e29). With
`d256_bwd`, the float32 backward pair at head dim 256, dq and dk/dv timed
apart through phase 2's `_bwd_case` (gated against the plain versions,
bitwise twice more at the train case): causal unless named, the train
case B=16 T=512 H=1, B=2 T=200 H=4 with a ragged key mask at D=256 and at
D=192 (zero-padded to 256), Tq=37 Tk=53 not causal with a key mask, the
D=256 model's training shape B=4 T=128 H=2, B=8 T=512 H=4 with a ragged
key mask (every grid over one wave), the long B=2 T=4096 H=4; then phase 7's `_lse_case` (`flash_attention_lse`
with an LSE cotangent, the forward timed too) at B=1 T=1024 H=2 on a
diagonal shard, a past one and offsets 0/512. With `d128_bwd`, the
float32 backward pair at head dim 128 the same way, dq and dk/dv timed
apart through `_bwd_case` (bitwise twice more at the train case): causal
unless named, the train case B=16 T=512 H=2, B=2 T=200 H=4 with a ragged
key mask at D=128 and at D=96 and 80 (zero-padded to 128), Tq=37 Tk=53
not causal with a key mask, the D=128 model's training shape B=4 T=128
H=2, B=8 T=512 H=4 with a ragged key mask (every grid over one wave), the
long B=2 T=4096 H=8; then `_lse_case` at B=1 T=1024 H=2 D=128 on a
diagonal shard, a past one and offsets 0/512 (D128_LSE, kept here so that
a checkout without them times the same cases). With `d32_bwd_bf16`, the
bf16 pair at head dim 32 through phase 2's `_bf16_case` (the forward
with the LSE, then dq and dk/dv, each timed apart and gated against the
plain versions, bitwise twice more at the train case and the model's
shape): causal unless named, the train case B=16 T=512 H=8, B=2 T=200
H=4 with a ragged key mask at D=32 and at D=24 (zero-padded to 32),
Tq=37 Tk=53 not causal with a key mask, B=8 T=512 H=4 with a ragged key
mask, bench_decode_paged's model's training shape B=4 T=128 H=4, the
long B=4 T=4096 H=8, at D=16 the train case B=16 T=512 H=16 and Tq=37
Tk=53, and phase 2's head-count cases at D=32 (B=16385 H=4 T=16, B=1
H=65536 T=2); then `_lse_case` in
bf16 at B=1 T=1024 H=2 D=32 on a diagonal shard, a past one and offsets
0/512 (D32_BWD_BF16 and D32_LSE, kept here so that a parent checkout
times the same cases). With `d32_fwd_bf16`, the bf16 forward at head dim
32 alone (`_forward_case`, the same code on either checkout): causal with
the LSE unless named, the train case B=16 T=512 H=8 and at D=16 H=16, the
long B=4 T=4096 H=8, B=2 T=200 H=4 with a ragged key mask at D=32, 24
(zero-padded to 32), 16 and 8 (zero-padded to 16), Tq=37 Tk=53 not causal
with a key mask at D=32 and 16, B=8 T=512 H=4 with a ragged key mask,
bench_decode_paged's model's training shape B=4 T=128 H=4, the head-count
cases B=16385 H=4 T=16 and B=1 H=65536 T=2, bench_decode_paged's prefill
B=1 L=24 H=4 with a key mask and no LSE, and `flash_attention_lse` on
D32_LSE's shard, diagonal, past and offsets 0/512 (rows 0..511 see no key:
out 0, lse <= -1e29). With `padded_bwd_bf16`, the bf16 pair at head dims
no kernel is compiled at, through `_bf16_case` (the forward with the
LSE, then dq and dk/dv, each timed apart and gated against the plain
versions), each beside the same shape at its compiled width: B=2 T=200
H=4 causal with a ragged key mask at D=8, 24 (width 32), 40, 48, 56
(64), 72, 80, 96, 120 (128), 136, 200, 248 (256) and at 32, 64, 128 and
256; B=4 T=4096 H=8 causal at D=96 and 128 (bitwise twice more at 96);
then `_lse_case` in bf16 at B=1 T=1024 H=2 on a diagonal shard, a past
one and offsets 0/512 at D=136 and 256 (PADDED_BWD_BF16 and
PADDED_LSE_DIMS, kept here so that a parent checkout times the same
cases). Each backward record also carries the kernels one call of its
entry launches, counted from a CUDA graph (`_kernels_per_call` of ROOT's
chip_smoke.py), and the MiB the call allocates at its peak, on inputs of
the same shape (`_entry_calls`): the pad and slice copies a parent makes
around the kernel show there. With `d32_bwd_f32`, the float32 pair at
head dim 32 through phase 2's `_bwd_case` (dq and dk/dv timed apart and
gated against the plain versions, bitwise twice more at the train case
and the model's shape), each record with `_entry_calls`: causal unless
named, the train case B=16 T=512 H=8 and at D=16 H=16, B=2 T=200 H=4
with a ragged key mask at D=24 and 8, Tq=37 Tk=53 not causal with a key
mask, bench_decode_paged's model's training shape B=4 T=128 H=4, the long
B=4 T=4096 H=8 and the head-count case B=16385 H=4 T=16; then
`_lse_case` in float32 on D32_LSE's shard, diagonal, past and offsets
0/512 (D32_BWD_F32, chip_smoke.py's D32_F32_CASES kept here). With
`padded_bwd_f32`, the float32 pair the same way at head dims no kernel is
compiled at, each beside its compiled width: B=2 T=200 H=4 causal with a
ragged key mask at D=8, 24 (32), 40, 48, 56 (64), 72, 80, 96, 120 (128),
136, 192, 200, 248 (256) and at 32, 64, 128 and 256; B=4 T=4096 H=8
causal at D=96 (bitwise twice more) and 128; then `_lse_case` in float32
at B=1 T=1024 H=2 on a diagonal shard, a past one and offsets 0/512 at
D=136 and 256 (PADDED_BWD_F32). With `padded_fwd`, both
forwards at head dims no kernel is compiled at (`_forward_case`, the same
code on either checkout), each beside the same shape at its compiled
width, in float32 and bf16: B=2 T=200 H=4 causal with a ragged key mask,
with and without the LSE, at D=8, 24 (width 32), 40, 48, 56 (64), 72, 80,
96, 120 (128), 136, 192, 200, 248 (256) and at 32, 64, 128 and 256; B=4
T=4096 H=8 causal with the LSE at D=96 and 128; `flash_attention_lse` in
float32 at B=1 T=1024 H=2 on a diagonal shard, a past one and offsets
0/512 at D=136 and 256; and the bf16 decode route (`_bf16_decode_case`:
the bf16 forward under the length mask) at the serving step S=8 C=256
H=4, slab and paged on blocks of 16, at D=48 and 64 (PADDED_FWD,
PADDED_FWD_LSE_DIMS and PADDED_FWD_DECODE, kept here so that a parent
checkout times the same cases). Every forward and decode record carries
the kernels one call launches (`_kernels_per_call` of ROOT's
chip_smoke.py): the pad and slice copies of a parent show there. With
`rank`, the kernels no PR has redesigned yet (RANK), once each at the
train case (B=16 T=512 causal, H so that H * D = 256); RANK is empty, so
the turn says so and times nothing. Inputs come from
fixed seeds, so both checkouts see the same tensors, and every gate of
those functions holds in each turn. It prints one line `{"ab": LABEL, "cases":
[...]}` with each kernel's device time (the profiler's, per call),
CUDA-event time, operation count, bounds, error and SDPA's device time on
the same inputs. The bounds are recomputed here from the operation count
and the bytes, so that two checkouts whose chip_smoke.py count them
against other peaks compare alike: `bound_ms` against the tensor cores
(bf16 989 TFLOP/s; f32 165, three TF32 products per f32 product) and,
for f32, `simt_bound_ms` against the CUDA cores' 67 TFLOP/s. A record
from a chip_smoke.py that does not give `ops` has it from its
`ops_bound_ms` and that checkout's own peak.

With `--no-gates` a turn runs the same cases with ROOT's `check`
replaced by one that records each failed gate instead of raising, and
its line carries them under `"gates_failed"`: for diagnostic copies of a
tree whose results are wrong on purpose (a stage of a kernel taken out),
whose times show what that stage costs. A turn without the flag stops at
the first failed gate.

`sweep` runs the `decode` cases of ROOT once with the wrappers' split
plan (`decode_split`) replaced, for that process only, by each fixed n
of 1, 2, 4 and 8, then once with the plan, and prints one line
`{"sweep": LABEL, "cases": [...]}` with each case's device time per n
(every gate of the case functions holds at each n).

Run each turn in its own process, on one card, in the order parent,
change, change, parent: the card's clocks drift within a call, so each
side gets an early and a late turn, and the spread of the parent's two
turns is the noise a difference must beat. `summary` reads the `{"ab":
...}` lines of the logs and prints, per kernel and case, each side's
turns, the parent's own spread, the change/parent ratio, each side's
TFLOP/s and share of `bound_ms` (from its mean device time and the
case's own `ops`; f32 also the share of the CUDA-core bound), SDPA's
mean device time over all turns, the change/SDPA ratio, and each side's
mean `kernel_ms` (CUDA events around the wrapper: device time plus the
host's launch cost).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

# (label, B, Tq, Tk, H, D, causal, valid key lengths or None, repeat)
PHASE2 = [
    ("train B=16 T=512 H=4 D=64", 16, 512, 512, 4, 64, True, None, True),
    ("train, ragged key mask", 16, 512, 512, 4, 64, True,
     [512 - 29 * b for b in range(16)], False),
    ("Tq=37 Tk=53 D=64", 2, 37, 53, 4, 64, False, [53, 20], False),
    ("Tq=37 Tk=53 D=16", 2, 37, 53, 4, 16, False, [53, 20], False),
    ("Tq=37 Tk=53 D=128", 2, 37, 53, 4, 128, False, [53, 20], False),
    ("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None, False),
    ("B=2 T=4096 H=8 D=128", 2, 4096, 4096, 8, 128, True, None, False),
    ("B=2 T=200 H=4 D=128, ragged key mask", 2, 200, 200, 4, 128, True,
     [200, 137], False),
]
# float32 backward pair: (label, B, Tq, Tk, H, D, causal, valid, repeat)
PHASE2_F32 = [
    ("train B=16 T=512 H=4 D=64", 16, 512, 512, 4, 64, True, None, True),
    ("train, ragged key mask", 16, 512, 512, 4, 64, True,
     [512 - 29 * b for b in range(16)], False),
    ("Tq=37 Tk=53 D=64", 2, 37, 53, 4, 64, False, [53, 20], False),
    ("Tq=37 Tk=53 D=16", 2, 37, 53, 4, 16, False, [53, 20], False),
    ("Tq=37 Tk=53 D=128", 2, 37, 53, 4, 128, False, [53, 20], False),
    ("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None, False),
]
# float32 forward: (label, B, T, H, D, valid key lengths or None, lse)
FWD_F32 = [
    ("prefill L=16", 1, 16, 4, 64, [13], False),
    ("prefill L=64", 1, 64, 4, 64, [49], False),
    ("prefill L=256", 1, 256, 4, 64, [193], False),
    ("train B=16 T=512 H=4 D=64", 16, 512, 4, 64, None, True),
    ("T=4096", 4, 4096, 8, 64, None, False),
    # the other widths: bench_decode_paged's prefill (bench.py:724-748,
    # d_model 128 over 4 heads, 24-token prompts), the train case and a
    # long shape at D=32 and 128, and D=16
    ("bench_decode_paged prefill B=1 L=24 H=4 D=32", 1, 24, 4, 32, [24],
     False),
    ("train B=16 T=512 H=8 D=32", 16, 512, 8, 32, None, True),
    ("train B=16 T=512 H=2 D=128", 16, 512, 2, 128, None, True),
    ("B=4 T=4096 H=8 D=32", 4, 4096, 8, 32, None, False),
    ("B=2 T=4096 H=8 D=128", 2, 4096, 8, 128, None, False),
    ("B=16 T=512 H=16 D=16", 16, 512, 16, 16, None, True),
]
# decode: ("slab", label, S, C, H, D, lengths) or ("paged", label, S, bs,
# nb, H, D, lengths)
_STEP = [1, 17, 100, 256, 3, 64, 200, 255]
_BIG = [1, 4096] + [int(x) for x in
                    np.random.default_rng(0).integers(1, 4097, size=64)[2:]]
DECODE = [
    ("slab", "step S=8 C=256", 8, 256, 4, 64, _STEP),
    ("slab", "lengths with 0", 4, 256, 4, 64, [0, 1, 256, 37]),
    ("slab", "S=64 C=4096", 64, 4096, 8, 64, _BIG),
    ("slab", "bench_decode_paged shape", 4, 128, 4, 32, [25, 48, 37, 30]),
    ("paged", "step S=8 bs=16 nb=16", 8, 16, 16, 4, 64, _STEP),
    ("paged", "bs=8 S=4 nb=32", 4, 8, 32, 4, 64, [0, 1, 256, 37]),
    ("paged", "bs=64 S=4 nb=4", 4, 64, 4, 4, 64, [0, 1, 256, 37]),
    ("paged", "S=64 nb=256 bs=16 H=8", 64, 16, 256, 8, 64, _BIG),
    ("paged", "bench_decode_paged shape", 4, 16, 8, 4, 32, [25, 48, 37, 30]),
]
# the wide forward: (label, B, T, H, D, valid key lengths or None, lse),
# causal
WIDE_FWD = [
    ("D=320 train B=4 T=128 H=2", 4, 128, 2, 320, None, True),
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 4, D, [200, 137],
       False) for D in (264, 320, 512, 1024)),
    ("B=2 T=4096 H=4 D=512", 2, 4096, 4, 512, None, True),
    ("B=1 T=4096 H=4 D=1024", 1, 4096, 4, 1024, None, True),
]
# the backward pair above head dim 256, float32 (`wide_bwd`) and bfloat16
# (`wide_bwd_bf16`): (label, B, T, H, D, valid key lengths or None), causal
WIDE_BWD = [(lab, B, T, H, D, valid) for lab, B, T, H, D, valid, _ in WIDE_FWD]
# the f32 decode step through the wide forward: (label, S, H, D, block
# size or None for the slab)
WIDE_DECODE = [("decode step S=8 C=256 H=4 D=320", 8, 4, 320, None),
               ("paged decode step S=8 C=256 H=4 D=320 bs=16", 8, 4, 320,
                16)]
# the float32 forward at head dim 256 (`d256`): (label, B, Tq, Tk, H, D,
# causal, valid key lengths or None, with the LSE, (q_off, k_off) through
# `flash_attention_lse` or None): chip_smoke.py's D256_CASES (the train
# case of `rank`, B=2 T=200 H=4 with a ragged key mask at D=256 and 192,
# the prefill shape, Tq=37 Tk=53, B=8 T=512 H=4 with a ragged key mask)
# and its D256_LSE shard under each of
# D256_LSE_OFFSETS, and a long causal shape
D256 = [
    ("D=256 train B=16 T=512 H=1", 16, 512, 512, 1, 256, True, None, True,
     None),
    ("D=256 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 256, True,
     [200, 137], True, None),
    ("D=192 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 192, True,
     [200, 137], True, None),
    ("D=256 prefill B=1 L=64 H=4, key mask", 1, 64, 64, 4, 256, True, [49],
     False, None),
    ("D=256 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 256, False, [53, 20],
     True, None),
    ("D=256 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 256, True,
     [512, 449, 388, 301, 256, 197, 130, 63], True, None),
    ("D=256 long B=2 T=4096 H=4", 2, 4096, 4096, 4, 256, True, None, True,
     None),
    *((lab, 1, 1024, 1024, 2, 256, True, None, True, offs)
      for lab, offs in (("D=256 diagonal", (1024, 1024)),
                        ("D=256 past", (1024, 0)),
                        ("D=256 rows without keys", (0, 512)))),
]
# the float32 backward pair at head dim 256 (`d256_bwd`): `_bwd_case`
# (label, B, Tq, Tk, H, D, causal, valid key lengths or None, a bitwise
# repeat); then `_lse_case` on chip_smoke.py's D256_LSE shard under each
# of its D256_LSE_OFFSETS
D256_BWD = [
    ("D=256 train B=16 T=512 H=1", 16, 512, 512, 1, 256, True, None, True),
    ("D=256 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 256, True,
     [200, 137], False),
    ("D=192 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 192, True,
     [200, 137], False),
    ("D=256 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 256, False, [53, 20],
     False),
    ("D=256 model B=4 T=128 H=2", 4, 128, 128, 2, 256, True, None, False),
    ("D=256 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 256, True,
     [512, 449, 388, 301, 256, 197, 130, 63], False),
    ("D=256 long B=2 T=4096 H=4", 2, 4096, 4096, 4, 256, True, None, False),
]
# the float32 backward pair at head dim 128 (`d128_bwd`): `_bwd_case`
# (label, B, Tq, Tk, H, D, causal, valid key lengths or None, a bitwise
# repeat): chip_smoke.py's D128_CASES, the D=128 model's training shape
# and a long one; then `_lse_case`
# on D128_LSE under each of D128_LSE_OFFSETS (chip_smoke.py's too)
D128_BWD = [
    ("D=128 train B=16 T=512 H=2", 16, 512, 512, 2, 128, True, None, True),
    ("D=128 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 128, True,
     [200, 137], False),
    ("D=96 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 96, True,
     [200, 137], False),
    ("D=80 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 80, True,
     [200, 137], False),
    ("D=128 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 128, False, [53, 20],
     False),
    ("D=128 model B=4 T=128 H=2", 4, 128, 128, 2, 128, True, None, False),
    ("D=128 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 128, True,
     [512, 449, 388, 301, 256, 197, 130, 63], False),
    ("D=128 long B=2 T=4096 H=8", 2, 4096, 4096, 8, 128, True, None, False),
]
D128_LSE = (1, 1024, 2, 128)
D128_LSE_OFFSETS = (("D=128 diagonal", (1024, 1024)),
                    ("D=128 past", (1024, 0)),
                    ("D=128 rows without keys", (0, 512)))
# the bf16 pair at head dim 32 (`d32_bwd_bf16`): `_bf16_case` (label, B,
# Tq, Tk, H, D, causal, valid key lengths or None, a bitwise repeat):
# chip_smoke.py's D32_BF16_CASES (bench_decode_paged's model's training
# shape among them), then phase 2's head-count cases at D=32 (a 64-row
# tile a quarter full at T=16, 1/32 at T=2); then `_lse_case` in bf16 on
# D32_LSE under each of D32_LSE_OFFSETS (chip_smoke.py's too)
D32_BWD_BF16 = [
    ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True),
    ("D=32 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 32, True,
     [200, 137], False),
    ("D=24 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 24, True,
     [200, 137], False),
    ("D=32 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 32, False, [53, 20],
     False),
    ("D=32 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 32, True,
     [512, 449, 388, 301, 256, 197, 130, 63], False),
    ("D=32 model B=4 T=128 H=4", 4, 128, 128, 4, 32, True, None, True),
    ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, False),
    ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None, False),
    ("D=16 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 16, False, [53, 20],
     False),
    ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, False),
    ("D=32 B=1 H=65536 T=2", 1, 2, 2, 65536, 32, True, None, False),
]
D32_LSE = (1, 1024, 2, 32)
D32_LSE_OFFSETS = (("D=32 diagonal", (1024, 1024)),
                   ("D=32 past", (1024, 0)),
                   ("D=32 rows without keys", (0, 512)))
# the bf16 forward at head dim 32 (`d32_fwd_bf16`): `_forward_case` (label,
# B, Tq, Tk, H, D, causal, valid key lengths or None, with the LSE, (q_off,
# k_off) through `flash_attention_lse` or None): the train case at D=32
# (H=8) and D=16 (H=16), the long case, chip_smoke.py's ragged, Tq=37 Tk=53
# and head-count shapes, its no-LSE prefill, and the D32_LSE shard under
# each of D32_LSE_OFFSETS
D32_FWD_BF16 = [
    ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True,
     None),
    ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None, True,
     None),
    ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, True,
     None),
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, D, True,
       [200, 137], True, None) for D in (32, 24, 16, 8)),
    *((f"D={D} Tq=37 Tk=53, key mask", 2, 37, 53, 4, D, False, [53, 20],
       True, None) for D in (32, 16)),
    ("D=32 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 32, True,
     [512, 449, 388, 301, 256, 197, 130, 63], True, None),
    ("D=32 model B=4 T=128 H=4", 4, 128, 128, 4, 32, True, None, True, None),
    ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, True, None),
    ("D=32 B=1 H=65536 T=2", 1, 2, 2, 65536, 32, True, None, True, None),
    ("bf16 prefill B=1 L=24 H=4 D=32, key mask", 1, 24, 24, 4, 32, True,
     [24], False, None),
    *((lab, 1, 1024, 1024, 2, 32, True, None, True, offs)
      for lab, offs in D32_LSE_OFFSETS),
]
# the bf16 pair at padded head dims beside their compiled widths
# (`padded_bwd_bf16`): `_bf16_case` (label, B, Tq, Tk, H, D, causal, valid
# key lengths or None, a bitwise repeat): chip_smoke.py's
# PADDED_BF16_BWD_CASES, D=48 and 80 (PERF.md's padded rows) and each
# compiled width at the same shapes; then `_lse_case` in bf16 at
# B=1 T=1024 H=2 under D32_LSE_OFFSETS' offsets at each of PADDED_LSE_DIMS
PADDED_BWD_BF16 = [
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, D, True,
       [200, 137], False)
      for D in (8, 24, 32, 40, 48, 56, 64, 72, 80, 96, 120, 128, 136, 200,
                248, 256)),
    ("D=96 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 96, True, None, True),
    ("D=128 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 128, True, None, False),
]
PADDED_LSE_DIMS = (136, 256)
# both forwards at padded head dims beside their compiled widths
# (`padded_fwd`): `_forward_case` (label, dtype, B, T, H, D, valid key
# lengths or None, the LSE), causal: chip_smoke.py's PADDED_FWD_CASES, D=48,
# 80 and 192 (PERF.md's padded rows) and each compiled width at the same
# shapes, and the long shape at D=96 beside D=128; then
# `flash_attention_lse` in float32 at B=1 T=1024 H=2 under D32_LSE_OFFSETS'
# offsets at each of PADDED_FWD_LSE_DIMS; then the bf16 decode route at
# PADDED_FWD_DECODE (label, S, C, H, lengths, block size) at D=48 and 64
PADDED_FWD = [
    *((f"D={D} B=2 T=200 H=4, ragged key mask" + (", LSE" if lse else ""),
       dtype, 2, 200, 4, D, [200, 137], lse)
      for dtype in ("float32", "bfloat16")
      for D in (8, 24, 32, 40, 48, 56, 64, 72, 80, 96, 120, 128, 136, 192,
                200, 248, 256)
      for lse in (True, False)),
    *((f"D={D} long B=4 T=4096 H=8, LSE", dtype, 4, 4096, 8, D, None, True)
      for dtype in ("float32", "bfloat16") for D in (96, 128)),
]
PADDED_FWD_LSE_DIMS = (136, 256)
PADDED_FWD_DECODE = ("step S=8 C=256", 8, 256, 4, _STEP, 16)
# the float32 pair at head dim 32 (`d32_bwd_f32`): `_bwd_case` (label, B,
# Tq, Tk, H, D, causal, valid key lengths or None, a bitwise repeat):
# chip_smoke.py's D32_F32_CASES, kept here so that a checkout without them
# times the same cases, each with its entries' kernels a call and peak MiB
# (`_entry_calls`); then `_lse_case` in float32 on D32_LSE under each of
# D32_LSE_OFFSETS
D32_BWD_F32 = [
    ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True),
    ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None, False),
    ("D=24 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 24, True,
     [200, 137], False),
    ("D=8 B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, 8, True,
     [200, 137], False),
    ("D=32 Tq=37 Tk=53, key mask", 2, 37, 53, 4, 32, False, [53, 20],
     False),
    ("D=32 model B=4 T=128 H=4", 4, 128, 128, 4, 32, True, None, True),
    ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, False),
    ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, False),
]
# the float32 pair at padded head dims beside their compiled widths
# (`padded_bwd_f32`): `_bwd_case` as above, each with `_entry_calls`, at
# B=2 T=200 H=4 causal with a ragged key mask at every padded head dim
# (PADDED_BWD_BF16's, and 48, 80 and 192: PERF.md's padded rows) and each
# compiled width, head dims ascending, and the long B=4 T=4096 H=8 at D=96
# beside D=128; then `_lse_case` in float32 at B=1 T=1024 H=2 under
# D32_LSE_OFFSETS' offsets at each of PADDED_LSE_DIMS
PADDED_BWD_F32 = [
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, D, True,
       [200, 137], False)
      for D in (8, 24, 32, 40, 48, 56, 64, 72, 80, 96, 120, 128, 136, 192,
                200, 248, 256)),
    ("D=96 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 96, True, None, True),
    ("D=128 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 128, True, None, False),
]
# the kernels not yet redesigned, at the train case with H * D = 256:
# (case function, D). None: the f32 pair at D=32 (and D=8 to 24 on it) was
# the last kernel on its first design.
RANK = []
SHARD = dict(B=4, T=1024, H=8, D=64)
SHARD_F32 = dict(B=1, T=1024, H=4, D=64)
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor cores
PEAK_F32_TC_FLOPS = 495e12 / 3   # three TF32 products per f32 product
PEAK_F32_FLOPS = 67e12      # f32 on the CUDA cores


def _bounds(rec, cs):
    """The A/B fields of one chip_smoke record: its operation count (from
    `ops`, else from `ops_bound_ms` and the peak of the checkout `cs` that
    computed it) and both bounds recomputed from it and the bytes."""
    bf16 = rec["name"].endswith("_bf16")
    ops = rec.get("ops")
    if ops is None:
        ops = rec["ops_bound_ms"] * 1e-3 * (
            cs.PEAK_BF16_FLOPS if bf16 else cs.PEAK_F32_FLOPS)
    out = {"ops": ops, "bytes_bound_ms": rec["bytes_bound_ms"],
           "bound_ms": max(rec["bytes_bound_ms"], ops / (
               PEAK_BF16_FLOPS if bf16 else PEAK_F32_TC_FLOPS) * 1e3)}
    if not bf16:
        out["simt_bound_ms"] = max(rec["bytes_bound_ms"],
                                   ops / PEAK_F32_FLOPS * 1e3)
    return out


def _forward_case(cs, label, dtype, B, T, H, D, valid, lse, gen, Tk=None,
                  causal=True, offsets=None):
    """The forward alone (causal or not, key mask from `valid`, the LSE when
    `lse`; Tq = T, Tk = `Tk` or T) through ROOT's `flash_attention`, or
    under causal `offsets` (q_off, k_off) through its
    `flash_attention_lse`, held to ROOT's bars against its plain version
    (f32: TOL on out and LSE; bf16: BF16_OUT_TOL, BF16_LSE_TOL; a row that
    sees no key: out 0, lse <= -1e29), timed beside the plain version and
    SDPA on the same inputs (TF32 off: phase_card; no SDPA where a row sees
    no key, where it gives NaN, or past SDPA_MAX_HEADS heads, which it
    refuses), with the kernels one call launches (ROOT's
    `_kernels_per_call`) and the MiB it allocates at its peak. Returns the
    record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_lse,
                                                  flash_attention_plain)
    bf16 = dtype == torch.bfloat16
    Tk = Tk or T
    q_off, k_off = offsets or (0, 0)
    q = torch.randn((B, T, H, D), generator=gen).to(cs.DEVICE, dtype)
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(cs.DEVICE, dtype)
            for _ in range(2))
    km = cs._key_mask(B, Tk, valid)
    kw = dict(causal=causal, key_mask=km)
    if offsets is None:
        run = lambda: flash_attention(q, k, v, return_lse=lse, **kw)
    else:
        kw.update(q_offset=q_off, k_offset=k_off)
        run = lambda: flash_attention_lse(q, k, v, **kw)
    plain = lambda: flash_attention_plain(q, k, v, return_lse=lse, **kw)
    got, want = (r if lse else (r,) for r in (run(), plain()))
    torch.cuda.synchronize()
    name = "flash_fwd_bf16" if bf16 else "flash_fwd"
    out_tol, lse_tol = ((cs.BF16_OUT_TOL, cs.BF16_LSE_TOL) if bf16
                        else (cs.TOL, cs.TOL))
    err = float((got[0].float() - want[0].float()).abs().max())
    cs.check(got[0].dtype == dtype and bool(torch.isfinite(
        got[0].float()).all()) and err <= out_tol,
             f"{name} {label}: {got[0].dtype}, max abs err {err}")
    if lse:
        lse_err = float((got[1] - want[1]).abs().max())
        cs.check(lse_err <= lse_tol, f"{name} {label}: lse max abs err "
                                     f"{lse_err}")
    vis = torch.ones((T, Tk), dtype=torch.bool, device=q.device)
    if causal:
        vis = cs._causal_visible(T, Tk, q_off, k_off)
    none = ~vis.any(-1)
    cs.check(not bool(none.any()) or bool(
        (got[0][:, none] == 0).all() and (got[1][:, :, none] <= -1e29).all()),
        f"{name} {label}: a row that sees no key is not out 0, lse <= -1e29")
    library = None
    if not bool(none.any()) and H <= cs.SDPA_MAX_HEADS:
        sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
        is_causal = causal and km is None and q_off == k_off and T == Tk
        mask = None
        if not is_causal and not bool(vis.all()):
            mask = vis[None, None]
        if km is not None:
            mask = (km > 0)[:, None, None, :] & (
                vis[None, None] if causal else True)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, is_causal=is_causal, attn_mask=mask)
    size = 2 if bf16 else 4
    nbytes = size * 2 * H * D * (B * T + B * Tk) + 4 * (
        (B * H * T if lse else 0) + (B * Tk if km is not None else 0))
    pairs = cs._valid_pairs(B, T, Tk, H, causal, km, q_off, k_off)
    return cs.rate_fields({
        "name": cs.kernel_name(name, D), "case": label,
        "shape": [B, T, Tk, H, D], "lse": lse, "key_mask": km is not None,
        "offsets": [q_off, k_off], "max_abs_err": err,
        "ms": cs.median_ms(run), "plain_ms": cs.median_ms(plain),
        "library_ms": library and cs.median_ms(library),
        **cs.bound(nbytes, 4 * D * pairs, bf16=bf16),
        "device_ms": cs.device_ms(run), "plain_device_ms": cs.device_ms(plain),
        "library_device_ms": library and cs.device_ms(library),
        "kernels_per_call": cs._kernels_per_call(run)[0],
        "peak_mib": _peak_mib(run)})


def _peak_mib(fn):
    """MiB that one call of fn allocates on the card at its peak, above
    what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _wide(cs):
    import torch
    gen = torch.Generator().manual_seed(8)
    recs = [_forward_case(cs, lab, dtype, B, T, H, D, valid, lse, gen)
            for dtype in (torch.float32, torch.bfloat16)
            for lab, B, T, H, D, valid, lse in WIDE_FWD]
    recs += [cs._wide_decode_case(lab, S, H, D, cs.STEP_LENGTHS, gen, bs=bs)
             for lab, S, H, D, bs in WIDE_DECODE]
    return recs


def _wide_bwd(cs, bf16=False):
    import torch
    gen = torch.Generator().manual_seed(12 if bf16 else 10)
    case = cs._bf16_case if bf16 else cs._bwd_case
    recs = []
    for lab, B, T, H, D, valid in WIDE_BWD:
        recs += case(lab, B, T, T, H, D, True, valid, gen)
    return recs


def _d256(cs):
    import torch
    gen = torch.Generator().manual_seed(17)
    return [_forward_case(cs, lab, torch.float32, B, Tq, H, D, valid, lse,
                          gen, Tk=Tk, causal=causal, offsets=offs)
            for lab, B, Tq, Tk, H, D, causal, valid, lse, offs in D256]


def _d256_bwd(cs):
    import torch
    gen = torch.Generator().manual_seed(18)
    recs = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D256_BWD:
        recs += cs._bwd_case(lab, B, Tq, Tk, H, D, causal, valid, gen,
                             repeat=repeat)
    B, T, H, D = cs.D256_LSE
    for lab, offs in cs.D256_LSE_OFFSETS:
        recs += cs._lse_case(lab, torch.float32, B, T, H, D, offs, None, gen)
    return recs


def _d128_bwd(cs):
    import torch
    gen = torch.Generator().manual_seed(19)
    recs = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D128_BWD:
        recs += cs._bwd_case(lab, B, Tq, Tk, H, D, causal, valid, gen,
                             repeat=repeat)
    B, T, H, D = D128_LSE
    for lab, offs in D128_LSE_OFFSETS:
        recs += cs._lse_case(lab, torch.float32, B, T, H, D, offs, None, gen)
    return recs


def _d32_bwd_bf16(cs):
    import torch
    gen = torch.Generator().manual_seed(20)
    recs = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in D32_BWD_BF16:
        recs += cs._bf16_case(lab, B, Tq, Tk, H, D, causal, valid, gen,
                              repeat=repeat)
    B, T, H, D = D32_LSE
    for lab, offs in D32_LSE_OFFSETS:
        recs += cs._lse_case(lab, torch.bfloat16, B, T, H, D, offs, None,
                             gen)
    return recs


def _d32_fwd_bf16(cs):
    import torch
    gen = torch.Generator().manual_seed(21)
    return [_forward_case(cs, lab, torch.bfloat16, B, Tq, H, D, valid, lse,
                          gen, Tk=Tk, causal=causal, offsets=offs)
            for lab, B, Tq, Tk, H, D, causal, valid, lse, offs
            in D32_FWD_BF16]


def _entry_calls(cs, dtype, B, Tq, Tk, H, D, causal, valid, gen):
    """{kernel: {"kernels_per_call": n, "peak_mib": m}} of ROOT's backward
    entries (dq, dk/dv) on seeded `dtype` inputs of one shape: the kernels
    one call launches, from the call captured in a CUDA graph by ROOT's
    `_kernels_per_call` (the entries ran at this head dim before, so
    nothing loads during the capture), and the MiB the call allocates at
    its peak (`_peak_mib`: its outputs and any padded copies)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (
        attention_delta, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)
    q, g = (torch.randn((B, Tq, H, D), generator=gen).to(cs.DEVICE, dtype)
            for _ in range(2))
    k, v = (torch.randn((B, Tk, H, D), generator=gen).to(cs.DEVICE, dtype)
            for _ in range(2))
    kw = dict(causal=causal, key_mask=cs._key_mask(B, Tk, valid))
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = attention_delta(out, g)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    calls = {}
    for name, fn in (("flash_bwd_dq", flash_bwd_dq),
                     ("flash_bwd_dkv", flash_bwd_dkv)):
        call = lambda fn=fn: fn(q, k, v, g, lse, delta, **kw)
        calls[name + suffix] = {
            "kernels_per_call": cs._kernels_per_call(call)[0],
            "peak_mib": _peak_mib(call)}
    return calls


def _bwd_turn(cs, case, cases, dtype, gen):
    """`case` (ROOT's `_bwd_case` or `_bf16_case`) at each of `cases`,
    each record with its entry's `_entry_calls`."""
    recs = []
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in cases:
        got = case(lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat)
        calls = _entry_calls(cs, dtype, B, Tq, Tk, H, D, causal, valid, gen)
        recs += [{**r, **calls.get(r["name"], {})} for r in got]
    return recs


def _padded_bwd_bf16(cs):
    import torch
    gen = torch.Generator().manual_seed(22)
    recs = _bwd_turn(cs, cs._bf16_case, PADDED_BWD_BF16, torch.bfloat16, gen)
    for D in PADDED_LSE_DIMS:
        for lab, offs in D32_LSE_OFFSETS:
            recs += cs._lse_case(lab.replace("D=32", f"D={D}"),
                                 torch.bfloat16, 1, 1024, 2, D, offs, None,
                                 gen)
    return recs


def _d32_bwd_f32(cs):
    import torch
    gen = torch.Generator().manual_seed(24)
    recs = _bwd_turn(cs, cs._bwd_case, D32_BWD_F32, torch.float32, gen)
    B, T, H, D = D32_LSE
    for lab, offs in D32_LSE_OFFSETS:
        recs += cs._lse_case(lab, torch.float32, B, T, H, D, offs, None, gen)
    return recs


def _padded_bwd_f32(cs):
    import torch
    gen = torch.Generator().manual_seed(25)
    recs = _bwd_turn(cs, cs._bwd_case, PADDED_BWD_F32, torch.float32, gen)
    for D in PADDED_LSE_DIMS:
        for lab, offs in D32_LSE_OFFSETS:
            recs += cs._lse_case(lab.replace("D=32", f"D={D}"),
                                 torch.float32, 1, 1024, 2, D, offs, None,
                                 gen)
    return recs


def _padded_fwd(cs):
    import torch
    gen = torch.Generator().manual_seed(23)
    recs = [_forward_case(cs, lab, getattr(torch, dtype), B, T, H, D, valid,
                          lse, gen)
            for lab, dtype, B, T, H, D, valid, lse in PADDED_FWD]
    for D in PADDED_FWD_LSE_DIMS:
        for lab, offs in D32_LSE_OFFSETS:
            recs.append(_forward_case(
                cs, lab.replace("D=32", f"D={D}"), torch.float32, 1, 1024, 2,
                D, None, True, gen, offsets=offs))
    lab, S, C, H, lengths, bs = PADDED_FWD_DECODE
    for D in (48, 64):
        for paged in (False, True):
            recs.append(_bf16_decode_case(
                cs, f"{lab} D={D}" + (f" bs={bs}" if paged else ""), S, C,
                H, D, lengths, bs if paged else None, gen))
    return recs


def _bf16_decode_case(cs, label, S, C, H, D, lengths, bs, gen):
    """One bf16 decode call of ROOT's entries (slab, or with `bs` paged on
    a shuffled table of blocks of `bs`), the bf16 forward under the length
    mask, held to BF16_OUT_TOL of its plain version and timed beside it
    and SDPA under the length mask (paged: on the gathered slab), with
    the kernels one call launches (ROOT's `_kernels_per_call`). The same
    code on either checkout: the routes it counts are not gated, so that a
    parent that pads is timed too. Returns the record."""
    import torch
    from deeplearning4j_tpu_torch import kernels as K
    bf = torch.bfloat16
    q = torch.randn((S, 1, H, D), generator=gen).to(cs.DEVICE, bf)
    lens = torch.as_tensor(lengths, dtype=torch.int32).to(cs.DEVICE)
    if bs is None:
        k, v = (torch.randn((S, C, H, D), generator=gen).to(cs.DEVICE, bf)
                for _ in range(2))
        run = lambda: K.flash_decode(q, k, v, lens)
        plain = lambda: K.flash_decode_plain(q, k, v, lens)
    else:
        nb = C // bs
        pk, pv = (torch.randn((1 + S * nb, bs, H, D), generator=gen)
                  .to(cs.DEVICE, bf) for _ in range(2))
        table = (1 + torch.randperm(S * nb, generator=gen)).reshape(
            S, nb).to(torch.int32).to(cs.DEVICE)
        k = pk[table.long()].reshape(S, C, H, D)
        v = pv[table.long()].reshape(S, C, H, D)
        run = lambda: K.flash_decode_paged(q, pk, pv, table, lens)
        plain = lambda: K.flash_decode_paged_plain(q, pk, pv, table, lens)
    out = run()
    torch.cuda.synchronize()
    err = float((out.float() - plain().float()).abs().max())
    name = "flash_decode_bf16" if bs is None else "flash_decode_paged_bf16"
    cs.check(out.dtype == bf and err <= cs.BF16_OUT_TOL,
             f"{name} {label}: {out.dtype}, max abs err {err}")
    sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(C, device=q.device)[None, :] < lens[:, None]
            )[:, None, None, :]
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask)
    valid = sum(min(int(x), C) for x in lengths)
    nbytes = 2 * (2 * valid * H * D + 2 * S * H * D) + 4 * S
    return cs.rate_fields({
        "name": name, "case": label, "shape": [S, C, H, D],
        "block_size": bs, "max_abs_err": err, "ms": cs.median_ms(run),
        "plain_ms": cs.median_ms(plain), "library_ms": cs.median_ms(library),
        **cs.bound(nbytes, 4 * D * H * valid, bf16=True),
        "device_ms": cs.device_ms(run), "plain_device_ms": cs.device_ms(plain),
        "library_device_ms": cs.device_ms(library),
        "kernels_per_call": cs._kernels_per_call(run)[0]})


def _rank(cs):
    import torch
    if not RANK:
        print("rank: every kernel of the port is on a redesigned design; "
              "nothing to time")
    gen = torch.Generator().manual_seed(9)
    recs = []
    for case, D in RANK:
        H = 256 // D
        lab = f"train B=16 T=512 H={H} D={D}"
        fn = cs._bwd_case if case == "bwd" else cs._bf16_case
        recs += fn(lab, 16, 512, 512, H, D, True, None, gen)
    return recs


def run(root, label, dtype="bf16", gates=True):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    import deeplearning4j_tpu_torch as port
    for mod in (cs, port):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from "
                             f"{mod.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    cs.phase_card()
    failed = None
    if not gates:
        failed = []
        cs.check = lambda cond, msg: cond or failed.append(msg)
    sets = {"wide": _wide, "wide_bwd": _wide_bwd,
            "wide_bwd_bf16": lambda cs: _wide_bwd(cs, bf16=True),
            "d256": _d256, "d256_bwd": _d256_bwd, "d128_bwd": _d128_bwd,
            "d32_bwd_bf16": _d32_bwd_bf16, "d32_fwd_bf16": _d32_fwd_bf16,
            "padded_bwd_bf16": _padded_bwd_bf16, "padded_fwd": _padded_fwd,
            "d32_bwd_f32": _d32_bwd_f32, "padded_bwd_f32": _padded_bwd_f32,
            "rank": _rank}
    if dtype in sets:
        _print_turn(label, root, sets[dtype](cs), cs, failed)
        return
    if dtype == "decode":
        gen = torch.Generator().manual_seed(5)
        recs = [cs._decode_case(*c[1:], gen) if c[0] == "slab"
                else cs._paged_case(*c[1:], gen) for c in DECODE]
        _print_turn(label, root, recs, cs, failed)
        return
    f32 = dtype == "f32"
    recs = []
    if f32:
        gen = torch.Generator().manual_seed(3)
        for lab, B, T, H, D, valid, lse in FWD_F32:
            recs.append(cs._fwd_case(lab, B, T, H, D, valid, gen, lse=lse))
    gen = torch.Generator().manual_seed(0 if f32 else 1)
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in (
            PHASE2_F32 if f32 else PHASE2):
        case = cs._bwd_case if f32 else cs._bf16_case
        recs += case(lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat)
    gen = torch.Generator().manual_seed(2)
    shard = SHARD_F32 if f32 else SHARD
    B, T, H, D = shard["B"], shard["T"], shard["H"], shard["D"]
    dt = torch.float32 if f32 else torch.bfloat16
    ragged = [T - 97 * (b + 1) for b in range(B)]
    for lab, offs in (("diagonal", (T, T)), ("past", (T, 0))):
        for valid in (None, ragged):
            recs += cs._lse_case(
                "lse " + lab + (", ragged key mask" if valid else ""),
                dt, B, T, H, D, offs, valid, gen)
    recs += cs._lse_case("lse rows without keys", dt, B, T, H, D,
                         (0, T // 2), None, gen)
    _print_turn(label, root, recs, cs, failed)


def _print_turn(label, root, recs, cs, failed=None):
    extra = {} if failed is None else {"gates_failed": failed}
    print(json.dumps({"ab": label, "root": str(root), **extra, "cases": [
        {**{k: r.get(k) for k in ("name", "case", "device_ms", "ms",
                                  "max_abs_err", "library_device_ms",
                                  "kernels_per_call", "ctas_per_pair",
                                  "launch_floor_device_ms", "peak_mib")},
         **_bounds(r, cs)}
        for r in recs]}))


def sweep(root, label):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import importlib
    import chip_smoke as cs
    import torch
    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    if root not in Path(fa.__file__).resolve().parents:
        raise SystemExit(f"{fa.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    cs.phase_card()
    plan = fa.decode_split
    times = {}
    for n in (1, 2, 4, 8, None):
        fa.decode_split = plan if n is None else (lambda *a, n=n: n)
        gen = torch.Generator().manual_seed(5)
        for c in DECODE:
            rec = (cs._decode_case(*c[1:], gen) if c[0] == "slab"
                   else cs._paged_case(*c[1:], gen))
            times.setdefault((rec["name"], rec["case"]), {})[
                "plan" if n is None else f"n={n}"] = rec["device_ms"]
    fa.decode_split = plan
    print(json.dumps({"sweep": label, "root": str(root), "cases": [
        {"name": k[0], "case": k[1], **v} for k, v in times.items()]}))


def summary(logs):
    turns = []
    for path in logs:
        for line in Path(path).read_text().splitlines():
            if line.startswith('{"ab"'):
                turns.append(json.loads(line))
    sides, walls, cases, libs, per_call, peaks = {}, {}, {}, {}, {}, {}
    for t in turns:
        for c in t["cases"]:
            key = (c["name"], c["case"])
            sides.setdefault(key, {}).setdefault(t["ab"], []).append(
                c["device_ms"])
            if c.get("kernels_per_call") is not None:
                per_call.setdefault(key, {})[t["ab"]] = c["kernels_per_call"]
            if c.get("peak_mib") is not None:
                peaks.setdefault(key, {})[t["ab"]] = c["peak_mib"]
            walls.setdefault(key, {}).setdefault(t["ab"], []).append(
                c.get("ms"))
            cases[key] = c
            libs.setdefault(key, []).append(c.get("library_device_ms"))
    labels = list(dict.fromkeys(t["ab"] for t in turns))
    if len(labels) != 2:
        raise SystemExit(f"expected two labels, got {labels}")
    base, new = labels
    print(f"{'kernel':<20}{'case':<30}{base + ' runs':>22}{new + ' runs':>22}"
          f"{base + ' spread':>14}{'ratio':>8}{'TFLOP/s':>16}{'of bound':>14}"
          f"{'of CUDA-core bound':>20}{'SDPA':>9}{'/SDPA':>7}"
          f"{'kernel_ms':>18}")
    rows = []
    for (name, case), by in sides.items():
        a, b = by.get(base, []), by.get(new, [])
        if not a or not b or None in a + b:
            continue
        ma, mb = sum(a) / len(a), sum(b) / len(b)
        spread = (max(a) - min(a)) / ma
        c = cases[(name, case)]
        row = {"name": name, "case": case, base: a, new: b,
               "spread": spread, "ratio": mb / ma}
        wall = {x: [w for w in walls[(name, case)].get(x, []) if w is not None]
                for x in (base, new)}
        if all(wall.values()):
            row["kernel_ms"] = {x: sum(w) / len(w) for x, w in wall.items()}
        means = ((base, ma), (new, mb))
        if c.get("ops") is not None:
            row["tflops"] = {x: c["ops"] / (t * 1e-3) / 1e12
                             for x, t in means}
        if c.get("bound_ms"):
            row["bound_share"] = {x: c["bound_ms"] / t for x, t in means}
        if c.get("simt_bound_ms"):
            row["simt_bound_share"] = {x: c["simt_bound_ms"] / t
                                       for x, t in means}
        lib = [x for x in libs.get((name, case), []) if x is not None]
        row["sdpa_device_ms"] = sum(lib) / len(lib) if lib else None
        row["vs_sdpa"] = mb / row["sdpa_device_ms"] if lib else None
        calls = per_call.get((name, case), {})
        if calls:
            row["kernels_per_call"] = calls
        peak = peaks.get((name, case), {})
        if peak:
            row["peak_mib"] = peak
        rows.append(row)
        pair = lambda d, n: (" / ".join(f"{d[x]:.{n}f}" for x in (base, new))
                             if d else "-")
        sdpa = (f"{row['sdpa_device_ms']:>9.4f}{row['vs_sdpa']:>7.2f}"
                if lib else f"{'-':>9}{'-':>7}")
        print(f"{name:<20}{case:<30}"
              f"{' / '.join(f'{x:.4f}' for x in a):>22}"
              f"{' / '.join(f'{x:.4f}' for x in b):>22}"
              f"{spread:>14.3f}{mb / ma:>8.3f}"
              f"{pair(row.get('tflops'), 0):>16}"
              f"{pair(row.get('bound_share'), 3):>14}"
              f"{pair(row.get('simt_bound_share'), 3):>20}{sdpa}"
              f"{pair(row.get('kernel_ms'), 4):>18}"
              + (" | kernels a call " + " / ".join(
                  str(calls.get(x, "-")) for x in (base, new))
                 if calls else "")
              + (" | peak MiB " + " / ".join(
                  f"{peak[x]:.2f}" if x in peak else "-" for x in (base, new))
                 if peak else ""))
    print(json.dumps({"ab_summary": rows}))


if __name__ == "__main__":
    if len(sys.argv) in (4, 5) and sys.argv[1] == "run" \
            and sys.argv[4:] in ([], ["f32"], ["bf16"], ["decode"],
                                 ["wide"], ["wide_bwd"], ["wide_bwd_bf16"],
                                 ["d256"], ["d256_bwd"], ["d128_bwd"],
                                 ["d32_bwd_bf16"], ["d32_fwd_bf16"],
                                 ["padded_bwd_bf16"], ["padded_fwd"],
                                 ["d32_bwd_f32"], ["padded_bwd_f32"],
                                 ["rank"]):
        run(*sys.argv[2:])
    elif len(sys.argv) >= 3 and sys.argv[1] == "summary":
        summary(sys.argv[2:])
    elif len(sys.argv) == 6 and sys.argv[1] == "run" \
            and sys.argv[5] == "--no-gates":
        run(*sys.argv[2:5], gates=False)
    elif len(sys.argv) == 4 and sys.argv[1] == "sweep":
        sweep(*sys.argv[2:])
    else:
        raise SystemExit(__doc__)
