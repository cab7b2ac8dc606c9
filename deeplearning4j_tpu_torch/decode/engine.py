"""DecodeEngine: KV-cache decode for the port's models (counterpart of
deeplearning4j_tpu/decode/engine.py), on a slab or a paged cache.

- ``prefill`` runs a prompt, padded to a power-of-two bucket (floored at
  MIN_PREFILL_BUCKET), as one masked full-sequence forward — causal
  attention in the prefill kernel (`kernels.flash_attention`) — and writes
  each attention layer's K/V into the slot's cache rows. Pad positions
  write K/V past `length`, as in the JAX package; the length mask keeps
  every later step from attending to them. A recurrent layer (GravesLSTM,
  LSTM) runs the bucket under its mask from zero carries; masked steps
  carry the state through, so its final (h, c), written into the slot's
  carry rows, is the state after `length` real steps.
- ``step`` advances every slot one token: each attention layer appends the
  token's K/V at `pos = clip(lengths, 0, C-1)` and attends with the decode
  kernel (`kernels.flash_decode`) over `kv_valid = pos + 1` entries; each
  recurrent layer runs one step from its carry rows and writes them back.
- ``verify`` (speculative decoding, decode/speculative.py) appends a
  W-token window at row offset `start` of one slot and returns all W
  next-token distributions in one pass. The window attends over the
  slot's whole cache row through `kernels.flash_attention_lse` with the
  global causal offset `q_offset = start` (query start+i sees keys
  [0, start+i]; rows past the window, stale from a longer rolled-back
  window, are masked by the causal rule). Attention-only and slab only:
  rollback is a length reset (`set_length`), and carries cannot rewind.

The JAX engine threads its cache functionally and donates it to each
executable. Here the K/V and carry tensors and the length vector are
updated IN PLACE: `prefill`, `step`, `verify`, `set_length` and
`carry_restore` return the same cache dict they were given, its tensors
written where the JAX engine would have produced new ones, and
`carry_snapshot` returns host copies. Everything runs under
`torch.inference_mode()`.

Paged (`paged=True`, decode/paged.py): each attention layer's K/V live in
one pool [num_blocks, block_size, H, Dh] shared by the slots, and a block
table [slots, max_blocks] maps a slot's logical blocks to pool blocks
(block 0 is scratch). Prefill scatters the bucket's positions chunk by
chunk into the slot's table row (pad chunks land in scratch); the step
writes the token at (table[s, pos // bs], pos % bs) and attends with
`kernels.flash_decode_paged`, which reads K/V through the table. The table
is the caller's host array (`table=`, default `full_table()`); the cache
keeps one int32 copy on the device and refreshes it only when a row
changed, so a step adds no host-to-device copy of it. Recurrent carries
stay slot rows in both layouts.

Decode runs in the model's param dtype; carries in float32."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import (flash_attention_lse, flash_attention_plain,
                       flash_decode, flash_decode_paged,
                       flash_decode_paged_plain, flash_decode_plain)
from ..nn.layers.convolution import LayerNormalizationModule
from ..nn.layers.feedforward import (DenseLayerModule, OutputLayerModule,
                                     RnnOutputLayerModule)
from ..nn.layers.misc import ActivationLayerModule, DropoutLayerModule
from ..nn.layers.recurrent import (GravesBidirectionalLSTMModule,
                                   SelfAttentionLayerModule, _BaseLSTMModule)
from . import sampling as _sampling
from .paged import make_table


class DecodeUnsupported(TypeError):
    """The model contains a construct with no token-streaming semantics."""


# layers whose forward is a per-position map: safe in both decode legs
# (the JAX package's also holds Embedding and LossLayer, not ported yet)
_POSITIONWISE = (DenseLayerModule, RnnOutputLayerModule, OutputLayerModule,
                 ActivationLayerModule, DropoutLayerModule,
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
    if isinstance(module, GravesBidirectionalLSTMModule):
        raise DecodeUnsupported(
            f"layer {name!r}: bidirectional recurrence needs future tokens "
            "and cannot stream")
    if isinstance(module, SelfAttentionLayerModule):
        if not module.conf.causal:
            raise DecodeUnsupported(
                f"layer {name!r}: non-causal attention attends to future "
                "positions and cannot decode incrementally")
        return
    if isinstance(module, (_BaseLSTMModule,) + _POSITIONWISE):
        return
    raise DecodeUnsupported(f"layer {name!r} ({type(module).__name__}) has "
                            "no per-token decode semantics")


def build_plan(model):
    """(nodes, input_name, output_name, vocab) for a MultiLayerNetwork or a
    single-input, single-output ComputationGraph."""
    from ..nn.graph.graph import ComputationGraph
    from ..nn.multilayer.network import MultiLayerNetwork
    if isinstance(model, MultiLayerNetwork):
        it = model.conf.input_type
        vocab = int(it.size) if it is not None and hasattr(it, "size") \
            else int(model.conf.layers[0].n_in)
        if any(model.conf.input_preprocessors.get(i) is not None
               for i in range(len(model.layers))):
            raise DecodeUnsupported(
                "input preprocessors have no per-token semantics")
        nodes = [_Node("__in__", "input")]
        prev = "__in__"
        for i, module in enumerate(model.layers):
            _check_layer(str(i), module)
            nodes.append(_Node(str(i), "layer", (prev,), module=module))
            prev = str(i)
        return nodes, "__in__", prev, vocab
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
            if spec.preprocessor is not None:
                raise DecodeUnsupported(
                    f"vertex {name!r}: preprocessors have no per-token "
                    "semantics")
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
        # carries in the accumulation dtype: float32 for the port's float32
        # params, as JAX :222-226 keeps them (it widens sub-32-bit ones)
        self._acc_dtype = torch.float32
        self._greedy_step_ops = _sampling.batch_operands(self.slots)
        self._greedy_slot_ops = _sampling.slot_operands(None, 0)

    # ------------------------------------------------------------ cache
    def _entry_specs(self):
        """{layer: {key: (shape, dtype)}} of the cache's per-layer tensors:
        an attention layer's "k" / "v" (slab rows [slots, capacity, H, Dh]
        or a pool [num_blocks, block_size, H, Dh]), a recurrent layer's
        carry rows "h" / "c" [slots, n_out]."""
        specs = {}
        for node in self.nodes:
            if node.kind != "layer":
                continue
            c = node.module.conf
            if isinstance(node.module, SelfAttentionLayerModule):
                H = int(c.n_heads)
                rows = ((self.num_blocks, self.block_size) if self.paged
                        else (self.slots, self.capacity))
                shape = rows + (H, int(c.n_out) // H)
                specs[node.name] = dict.fromkeys(("k", "v"),
                                                 (shape, self._dtype))
            elif isinstance(node.module, _BaseLSTMModule):
                specs[node.name] = dict.fromkeys(
                    ("h", "c"), ((self.slots, int(c.n_out)), self._acc_dtype))
        return specs

    def has_recurrent(self):
        return any(node.kind == "layer"
                   and isinstance(node.module, _BaseLSTMModule)
                   for node in self.nodes)

    @torch.inference_mode()
    def init_cache(self):
        """Fresh all-zero cache {"lengths": int32[slots], "layers": {name:
        entry}} on the model's device: an attention layer's entry {"k",
        "v": [slots, capacity, H, Dh]}, a recurrent layer's {"h", "c":
        [slots, n_out]}. Paged: the K/V are pools [num_blocks, block_size,
        H, Dh], and the cache also holds the device block table "table"
        int32 [slots, max_blocks] with "table_host", the host copy it was
        last set from."""
        layers = {name: {key: torch.zeros(shape, dtype=dt, device=self.device)
                         for key, (shape, dt) in entry.items()}
                  for name, entry in self._entry_specs().items()}
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
        """Device bytes of a cache: K/V (slab rows or pools), carries,
        lengths and, paged, the block table."""
        total = self.slots * 4 + self.slots * self.max_blocks * 4
        for entry in self._entry_specs().values():
            for shape, dt in entry.values():
                total += int(np.prod(shape)) * \
                    torch.empty((), dtype=dt).element_size()
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
    def _walk(self, x0, mask, attention, recurrent=None):
        """Forward over the plan; `attention(node, q, k, v)` runs one
        attention layer's cache write and attention and returns its
        context [b, t, H, Dh]; `recurrent(node, params, x)` runs one
        recurrent layer from and into its carry rows and returns its
        output."""
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
            elif isinstance(m, _BaseLSTMModule):
                y = recurrent(node, p, x)
            else:
                y = m.forward(p, self.model.states[node.name], x,
                              mask=mask)[0]
            acts[node.name] = y
        return acts[self.output_name]

    def _one_hot(self, ids):
        return F.one_hot(ids, self.vocab).to(self._dtype)

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
        x0 = self._one_hot(torch.as_tensor(padded, device=self.device)[None])
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

        def recurrent(node, p, x):
            # from zero carries; masked pad steps carry the state through
            zeros = node.module.init_carry(1, self._dtype, self.device)
            y, _, _, (h, c) = node.module.forward(
                p, self.model.states[node.name], x, mask=valid,
                initial_state=zeros, return_state=True)
            entry = layers[node.name]
            entry["h"][slot] = h[0]
            entry["c"][slot] = c[0]
            return y

        y = self._walk(x0, valid, attention, recurrent)
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
        x0 = self._one_hot(ids[:, None])                       # [S, 1, V]
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

        def recurrent(node, p, x):
            entry = layers[node.name]
            y, _, _, (h, c) = node.module.forward(
                p, self.model.states[node.name], x,
                initial_state=(entry["h"], entry["c"]), return_state=True)
            entry["h"].copy_(h)                     # in place
            entry["c"].copy_(c)
            return y

        y = self._walk(x0, None, attention, recurrent)
        probs = y[:, -1].to(torch.float32)
        torch.clamp(lengths + 1, max=C, out=lengths)
        samp = self._greedy_step_ops if sampling is None else sampling
        nxt = _sampling.sample_tokens(probs, samp)
        return cache, nxt.cpu().numpy().astype(np.int32), \
            probs.cpu().numpy()

    @torch.inference_mode()
    def verify(self, cache, slot, tokens, start):
        """Speculative verify: append the W-token window `tokens` at row
        offset `start` of `slot` (in place) and return (cache, probs [W,
        vocab] np.float32), the next-token distribution after each window
        position, all W in one pass; `lengths` stays as it was (the caller
        commits the accepted length with `set_length`). Each attention
        layer attends the window over the slot's whole cache row with the
        global causal offset `start` (`flash_attention_lse`; the plain
        version for a use_pallas=False layer). Attention-only, slab
        only."""
        if self.paged:
            raise DecodeUnsupported(
                "speculative verify runs on the slab layout (the paged "
                "scheduler path and the verify window are separate tiers)")
        if self.has_recurrent():
            raise DecodeUnsupported(
                "verify needs rewind-free state: recurrent carries cannot "
                "roll back to `start` after a rejected draft")
        ids = np.asarray(tokens, np.int64).reshape(-1)
        W, start, slot = ids.shape[0], int(start), int(slot)
        if W < 1:
            raise ValueError("empty verify window")
        if start + W > self.capacity:
            raise ValueError(
                f"verify window [{start}, {start + W}) exceeds capacity "
                f"{self.capacity}")
        x0 = self._one_hot(torch.as_tensor(ids, device=self.device)[None])
        layers = cache["layers"]

        def attention(node, q, k, v):
            entry = layers[node.name]
            entry["k"][slot, start:start + W] = k[0]
            entry["v"][slot, start:start + W] = v[0]
            krow = entry["k"][slot:slot + 1]         # [1, C, H, Dh]
            vrow = entry["v"][slot:slot + 1]
            if node.module.conf.use_pallas:
                return flash_attention_lse(q, krow, vrow, causal=True,
                                           q_offset=start, k_offset=0)[0]
            return flash_attention_plain(q, krow, vrow, causal=True,
                                         q_offset=start, k_offset=0)

        y = self._walk(x0, None, attention)
        return cache, y[0].to(torch.float32).cpu().numpy()

    @torch.inference_mode()
    def set_length(self, cache, slot, n):
        """Commit `slot`'s length (the speculative accept / rollback
        primitive: rows past it become dead weight the causal mask and
        the length mask hide), written into the cache's length tensor;
        returns the cache."""
        cache["lengths"][int(slot)] = int(n)
        return cache

    def carry_snapshot(self, cache):
        """Host copies of the recurrent carries and the lengths ([slots,
        n_out] a layer, no K/V): the speculative engine snapshots a
        recurrent draft before proposing and restores it on rollback."""
        copy = lambda t: t.cpu().numpy().copy()
        return {"lengths": copy(cache["lengths"]),
                "layers": {name: {k: copy(t) for k, t in entry.items()}
                           for name, entry in cache["layers"].items()
                           if "h" in entry}}

    @torch.inference_mode()
    def carry_restore(self, cache, snap):
        """Rewind the recurrent carries and the lengths to a snapshot,
        written into the cache's tensors; returns the cache."""
        for name, entry in snap["layers"].items():
            for k, a in entry.items():
                cache["layers"][name][k].copy_(torch.from_numpy(a))
        cache["lengths"].copy_(torch.from_numpy(snap["lengths"]))
        return cache

    def warmup(self, buckets=()):
        """Run the prefill at each given length bucket and one step on a
        scratch cache (a deploy's warm-up: the hot-swapped model meets its
        first request with its kernels built and its memory allocated)."""
        cache = self.init_cache()
        for L in sorted(set(int(b) for b in buckets)):
            L = min(max(L, MIN_PREFILL_BUCKET), self.capacity)
            # an (L-1)-token prompt maps to bucket L
            cache, _, _ = self.prefill(cache, 0, np.zeros((max(L - 1, 1),),
                                                          np.int64))
        self.step(cache, np.zeros((self.slots,), np.int64))
        return self

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
