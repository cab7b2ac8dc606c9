"""DecodeEngine: KV-cache decode for the port's models (counterpart of
deeplearning4j_tpu/decode/engine.py), on a slab or a paged cache.

- ``prefill`` runs a prompt, padded to a power-of-two bucket (floored at
  MIN_PREFILL_BUCKET), as one masked full-sequence forward — causal
  attention in the prefill kernel (`kernels.flash_attention`) — and writes
  each attention layer's K/V into the slot's cache rows. Pad positions
  write K/V past `length`, as in the JAX package; the length mask keeps
  every later step from attending to them.
- ``step`` advances every slot one token: each attention layer appends the
  token's K/V at `pos = clip(lengths, 0, C-1)` and attends with the decode
  kernel (`kernels.flash_decode`) over `kv_valid = pos + 1` entries.

The JAX engine threads its cache functionally and donates it to each
executable. Here the K/V tensors and the length vector are updated IN
PLACE: `prefill` and `step` return the same cache dict they were given,
its tensors written where the JAX engine would have produced new ones.
Everything runs under `torch.inference_mode()`.

Paged (`paged=True`, decode/paged.py): each attention layer's K/V live in
one pool [num_blocks, block_size, H, Dh] shared by the slots, and a block
table [slots, max_blocks] maps a slot's logical blocks to pool blocks
(block 0 is scratch). Prefill scatters the bucket's positions chunk by
chunk into the slot's table row (pad chunks land in scratch); the step
writes the token at (table[s, pos // bs], pos % bs) and attends with
`kernels.flash_decode_paged`, which reads K/V through the table. The table
is the caller's host array (`table=`, default `full_table()`); the cache
keeps one int32 copy on the device and refreshes it only when a row
changed, so a step adds no host-to-device copy of it.

Decode runs in the model's param dtype. Speculative `verify` is a later
slice (ROADMAP queue 1) and raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import (flash_decode, flash_decode_paged,
                       flash_decode_paged_plain, flash_decode_plain)
from ..nn.layers.convolution import LayerNormalizationModule
from ..nn.layers.feedforward import DenseLayerModule, RnnOutputLayerModule
from ..nn.layers.recurrent import SelfAttentionLayerModule
from . import sampling as _sampling
from .paged import make_table


class DecodeUnsupported(TypeError):
    """The model contains a construct with no token-streaming semantics."""


# layers whose forward is a per-position map: safe in both decode legs
_POSITIONWISE = (DenseLayerModule, RnnOutputLayerModule,
                 LayerNormalizationModule)
_POSITIONWISE_VERTICES = ("ElementWiseVertex",)

MIN_PREFILL_BUCKET = 16


def bucket_for_len(n, capacity):
    """Smallest power of two >= n, floored at MIN_PREFILL_BUCKET and capped
    at the cache capacity: the prefill length bucket."""
    b = MIN_PREFILL_BUCKET
    while b < n:
        b <<= 1
    return min(b, capacity)


class _Node:
    __slots__ = ("name", "kind", "inputs", "module", "vertex")

    def __init__(self, name, kind, inputs=(), module=None, vertex=None):
        self.name = name
        self.kind = kind            # "input" | "layer" | "vertex"
        self.inputs = tuple(inputs)
        self.module = module
        self.vertex = vertex


def _check_layer(name, module):
    if isinstance(module, SelfAttentionLayerModule):
        if not module.conf.causal:
            raise DecodeUnsupported(
                f"layer {name!r}: non-causal attention attends to future "
                "positions and cannot decode incrementally")
        return
    if isinstance(module, _POSITIONWISE):
        return
    raise DecodeUnsupported(f"layer {name!r} ({type(module).__name__}) has "
                            "no per-token decode semantics")


def build_plan(model):
    """(nodes, input_name, output_name, vocab) for a single-input,
    single-output ComputationGraph."""
    from ..nn.graph.graph import ComputationGraph
    if not isinstance(model, ComputationGraph):
        raise DecodeUnsupported(f"cannot decode a {type(model).__name__}")
    conf = model.conf
    if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
        raise DecodeUnsupported(
            "decode requires a single-input/single-output graph")
    vocab = int(conf.input_types[0].size) if conf.input_types \
        else int(conf.vertices[model.order[1]].layer_conf.n_in)
    nodes = []
    for name in model.order:
        spec = conf.vertices[name]
        if spec.kind == "input":
            nodes.append(_Node(name, "input"))
        elif spec.kind == "layer":
            module = model.layers[name]
            _check_layer(name, module)
            nodes.append(_Node(name, "layer", spec.inputs, module=module))
        else:
            vc = spec.vertex_conf
            if type(vc).__name__ not in _POSITIONWISE_VERTICES:
                raise DecodeUnsupported(
                    f"vertex {name!r} ({type(vc).__name__}) is not a "
                    "per-position map")
            nodes.append(_Node(name, "vertex", spec.inputs, vertex=vc))
    return nodes, conf.network_inputs[0], conf.network_outputs[0], vocab


class DecodeEngine:
    def __init__(self, model, *, slots=4, max_len=128, paged=False,
                 block_size=16, num_blocks=None):
        self.model = model
        self.slots = int(slots)
        self.capacity = int(max_len)
        self.paged = bool(paged)
        self.block_size = int(block_size)
        if self.paged:
            bs = self.block_size
            if bs < 1 or bs & (bs - 1):
                raise ValueError(f"block_size must be a power of two, got "
                                 f"{bs}")
            # capacity in whole blocks: the table addresses nothing finer
            self.capacity = -(-self.capacity // bs) * bs
            self.max_blocks = self.capacity // bs
            # default pool: every slot fully backed, + the scratch block
            # (the scheduler passes a smaller pool to oversubscribe)
            self.num_blocks = (self.slots * self.max_blocks + 1
                               if num_blocks is None else int(num_blocks))
            if self.num_blocks < 2:
                raise ValueError("paged cache needs >= 2 blocks "
                                 "(block 0 is scratch)")
        else:
            self.max_blocks = 0
            self.num_blocks = 0
        self.nodes, self.input_name, self.output_name, self.vocab = \
            build_plan(model)
        if model.params is None:
            model.init()
        self.device = model.device
        self._dtype = model._dtype
        self._greedy_step_ops = _sampling.batch_operands(self.slots)
        self._greedy_slot_ops = _sampling.slot_operands(None, 0)

    # ------------------------------------------------------------ cache
    def _attention_nodes(self):
        return [n for n in self.nodes if n.kind == "layer"
                and isinstance(n.module, SelfAttentionLayerModule)]

    @torch.inference_mode()
    def init_cache(self):
        """Fresh all-zero cache {"lengths": int32[slots], "layers": {name:
        {"k", "v": [slots, capacity, H, Dh]}}} on the model's device. Paged:
        the K/V are pools [num_blocks, block_size, H, Dh], and the cache
        also holds the device block table "table" int32 [slots,
        max_blocks] with "table_host", the host copy it was last set
        from."""
        layers = {}
        for node in self._attention_nodes():
            c = node.module.conf
            H = int(c.n_heads)
            rows = ((self.num_blocks, self.block_size) if self.paged
                    else (self.slots, self.capacity))
            shape = rows + (H, int(c.n_out) // H)
            layers[node.name] = {
                "k": torch.zeros(shape, dtype=self._dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self._dtype, device=self.device)}
        cache = {"lengths": torch.zeros((self.slots,), dtype=torch.int32,
                                        device=self.device),
                 "layers": layers}
        if self.paged:
            cache["table_host"] = make_table(self.slots, self.max_blocks)
            cache["table"] = torch.zeros((self.slots, self.max_blocks),
                                         dtype=torch.int32,
                                         device=self.device)
        return cache

    def cache_bytes(self):
        """Device bytes of a cache: K/V (slab rows or pools), lengths and,
        paged, the block table."""
        item = torch.empty((), dtype=self._dtype).element_size()
        rows = (self.num_blocks * self.block_size if self.paged
                else self.slots * self.capacity)
        total = self.slots * 4 + self.slots * self.max_blocks * 4
        for node in self._attention_nodes():
            total += 2 * rows * int(node.module.conf.n_out) * item
        return total

    def full_table(self):
        """Fully backed block table (paged only): slot s owns blocks
        [1 + s * max_blocks, ...) contiguously, the static layout of
        `generate` and of callers that pass no table. Entries a smaller
        pool cannot back stay on scratch."""
        if not self.paged:
            raise ValueError("full_table() is paged-mode only")
        nb = self.max_blocks
        want = 1 + np.arange(self.slots * nb, dtype=np.int32).reshape(
            self.slots, nb)
        return np.where(want < self.num_blocks, want, 0).astype(np.int32)

    def _device_table(self, cache, table):
        """The cache's device block table, first set from the host `table`
        (default `full_table()`) when that differs from what it holds."""
        table = self.full_table() if table is None else np.asarray(table)
        host = cache["table_host"]
        if table.shape != host.shape:
            raise ValueError(f"block table must be {host.shape}, got "
                             f"{table.shape}")
        if not np.array_equal(host, table):
            np.copyto(host, table)
            cache["table"].copy_(torch.from_numpy(host))
        return cache["table"]

    def _scatter_prefill(self, pool, t, blocks):
        """Write a [L, H, Dh] sequence into `pool` at the slot's first
        len(blocks) table blocks, block_size positions each (a bucket
        shorter than one block is zero-padded to it). Pad chunks address
        scratch block 0; duplicate targets are plain writes, never
        accumulated."""
        bs = self.block_size
        L = t.shape[0]
        chunks = blocks.shape[0]
        if chunks * bs != L:
            t = F.pad(t, (0, 0, 0, 0, 0, chunks * bs - L))
        pool[blocks] = t.reshape(chunks, bs, *t.shape[1:]).to(pool.dtype)

    # ------------------------------------------------------------ walks
    def _walk(self, x0, mask, attention):
        """Forward over the plan; `attention(node, q, k, v)` runs one
        attention layer's cache write and attention and returns its
        context [b, t, H, Dh]."""
        acts = {self.input_name: x0}
        for node in self.nodes:
            if node.kind == "input":
                continue
            if node.kind == "vertex":
                acts[node.name] = node.vertex.apply(
                    [acts[i] for i in node.inputs])
                continue
            m = node.module
            p = self.model.params[node.name]
            x = acts[node.inputs[0]]
            if isinstance(m, SelfAttentionLayerModule):
                q, k, v = m.project_qkv(p, x)
                y = m.finish(p, attention(node, q, k, v), mask)
            else:
                y = m.forward(p, self.model.states[node.name], x,
                              mask=mask)[0]
            acts[node.name] = y
        return acts[self.output_name]

    # ------------------------------------------------------------- api
    @torch.inference_mode()
    def prefill(self, cache, slot, prompt_ids, sampling=None, step_index=0,
                table=None):
        """Run `prompt_ids` into cache slot `slot`; returns (cache, first
        generated id, last-position probs [vocab] as numpy). The cache is
        updated in place and returned. `step_index` is the sampling index
        of the emitted token: 0 on a fresh admission, the number of tokens
        already generated on a re-prefill after preemption. `table`: the
        paged block table (default `full_table()`)."""
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        n = ids.shape[0]
        if n < 1:
            raise ValueError("empty prompt")
        if n >= self.capacity:
            raise ValueError(
                f"prompt of {n} tokens does not fit the cache "
                f"(capacity {self.capacity}, needs room for >=1 new token)")
        slot = int(slot)
        L = bucket_for_len(n, self.capacity)
        padded = np.zeros((L,), np.int64)
        padded[:n] = ids
        x0 = F.one_hot(torch.as_tensor(padded, device=self.device)[None],
                       self.vocab).to(self._dtype)             # [1, L, V]
        valid = (torch.arange(L, device=self.device) < n).to(
            self._dtype)[None]                                 # [1, L]
        layers = cache["layers"]
        if self.paged:
            blocks = self._device_table(cache, table)[
                slot, :-(-L // self.block_size)].long()

        def attention(node, q, k, v):
            entry = layers[node.name]
            # in place: the slot's first L positions, pad positions included
            if self.paged:
                self._scatter_prefill(entry["k"], k[0], blocks)
                self._scatter_prefill(entry["v"], v[0], blocks)
            else:
                entry["k"][slot, :L] = k[0]
                entry["v"][slot, :L] = v[0]
            return node.module.attend(q, k, v, valid)

        y = self._walk(x0, valid, attention)
        probs = y[0, n - 1].to(torch.float32)
        cache["lengths"][slot] = n
        if sampling is None and step_index == 0:
            samp = self._greedy_slot_ops
        else:
            samp = _sampling.slot_operands(sampling, step_index)
        nid = _sampling.sample_tokens(probs[None], samp)[0]
        return cache, int(nid), probs.cpu().numpy()

    @torch.inference_mode()
    def step(self, cache, last_ids, sampling=None, table=None):
        """Advance every slot one token. `last_ids`: [slots] token ids
        (inactive slots may carry any id). Returns (cache, next ids
        [slots] np.int32, probs [slots, vocab] np.float32); the cache is
        updated in place and returned. `table`: the paged block table
        (default `full_table()`)."""
        ids = torch.as_tensor(np.asarray(last_ids, np.int64).reshape(
            self.slots), device=self.device)
        C = self.capacity
        lengths = cache["lengths"]
        pos = torch.clamp(lengths, 0, C - 1).to(torch.int64)
        kv_valid = (pos + 1).to(torch.int32)
        x0 = F.one_hot(ids[:, None], self.vocab).to(self._dtype)  # [S,1,V]
        layers = cache["layers"]
        if self.paged:
            # the append position's pool block and row in it, on the
            # device; a slot with no block there (a released slot) writes
            # scratch
            tbl = self._device_table(cache, table)
            rows = tbl.gather(1, (pos // self.block_size)[:, None])[:, 0]
            rows, cols = rows.long(), pos % self.block_size
        else:
            rows, cols = torch.arange(self.slots, device=self.device), pos

        def attention(node, q, k, v):
            entry = layers[node.name]
            entry["k"][rows, cols] = k[:, 0]        # in-place append
            entry["v"][rows, cols] = v[:, 0]
            kernel = node.module.conf.use_pallas
            if self.paged:
                attend = (flash_decode_paged if kernel
                          else flash_decode_paged_plain)
                return attend(q, entry["k"], entry["v"], tbl, kv_valid)
            attend = flash_decode if kernel else flash_decode_plain
            return attend(q, entry["k"], entry["v"], kv_valid)

        y = self._walk(x0, None, attention)
        probs = y[:, -1].to(torch.float32)
        torch.clamp(lengths + 1, max=C, out=lengths)
        samp = self._greedy_step_ops if sampling is None else sampling
        nxt = _sampling.sample_tokens(probs, samp)
        return cache, nxt.cpu().numpy().astype(np.int32), \
            probs.cpu().numpy()

    def verify(self, cache, slot, tokens, start):
        raise NotImplementedError(
            "speculative verify is not ported yet (ROADMAP queue 1)")

    def generate(self, prompt_ids, max_new_tokens=20, stop_id=None,
                 sampler=None):
        """Single-request decode on slot 0; greedy unless `sampler` (a
        SamplerConfig) says otherwise; a paged engine runs on
        `full_table()`. Returns the generated token ids."""
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        n_prompt = len(np.asarray(prompt_ids).reshape(-1))
        cache = self.init_cache()
        cache, nid, _ = self.prefill(cache, 0, prompt_ids, sampling=sampler)
        out = [nid]
        ids = np.zeros((self.slots,), np.int32)
        while len(out) < int(max_new_tokens) and out[-1] != stop_id \
                and n_prompt + len(out) < self.capacity:
            ids[0] = out[-1]
            samp = None
            if sampler is not None:
                samp = _sampling.batch_operands(self.slots, {0: sampler},
                                                {0: len(out)})
            cache, nxt, _ = self.step(cache, ids, sampling=samp)
            out.append(int(nxt[0]))
        return out
