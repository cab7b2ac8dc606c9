"""steps_per_execution: K optimizer steps per call (counterpart of
deeplearning4j_tpu/nn/multistep.py).

The JAX package rolls K training steps into one executable (`lax.scan`
over K batches staged on the device), so a call costs one dispatch. The
port's counterpart on the card is one CUDA graph of the K steps, unrolled:
forward, backward (the hand attention kernels among them), gradient
normalization, the per-layer optimizer updates, the layer states and the
dropout draws, replayed with one `replay()`. The semantics are those of K
`fit_batch` calls: the states thread from step to step, the optimizer's
step count advances by K, dropout draws new masks at every step, and the
scores of the K steps come back as `last_scores`.

- `prepare_steps(group)` stacks a group of same-shaped DataSets on the
  device, one `[K, ...]` tensor per leaf, into a `StepPlan`; None when
  shapes or the structure of the masks differ within the group, or when
  the model's `_windows` sends the group batch by batch (JAX's
  `_multi_step_mode` returning None: a ComputationGraph's truncated-BPTT
  batches, a MultiLayerNetwork's whose sequence the window does not
  tile, a flat solver's model, a listener that wants gradients). A plan
  is reusable; `fit_prepared` never writes its batch.
- Truncated BPTT (a MultiLayerNetwork's sequence of T = W·L steps under
  windows of L): each of the K batches takes W optimizer steps, one a
  window, from zero carries at its first window (JAX
  network.py:428-471); a batch's score is the mean of its windows'
  (:513). The plan runs the model's `_tbptt_step`, the window loop
  `fit_batch` runs, so on the card the K·W steps are one CUDA graph.
- `fit_prepared(plan)` runs its K steps. On the host every call runs them
  eagerly. On the card a plan's first call runs them eagerly, on the side
  stream its capture uses: that call is the warm-up (the optimizer state,
  the kernels' builds, cuBLAS's and cuDNN's workspaces). Its second call
  captures the K (K·W) steps into one `torch.cuda.CUDAGraph` held by the
  plan and replays it; every later call is one replay. A failed capture
  or replay raises; no call runs the eager steps in its place. A model
  whose learning rate or momentum follows a schedule never captures (a
  graph would bake in the rate of its capture): every call runs its steps
  eagerly, as the warm-up does, reading the rate from the step count as
  `fit_batch` does (the JAX package's scan reads it so too). The graphs
  of a model share one memory pool. `init`, a rebuilt updater and
  `set_ingest` make every captured graph stale: a stale plan warms up and
  captures again.
- `_fit_grouped(it, K)` (what `fit(steps_per_execution=K)` runs): full
  groups go through the model's ONE plan for their signature (each
  leaf's shape, dtype and None pattern, and the windows), as the JAX
  package compiles the K steps once and reuses the executable. The first
  group of a signature stacks a new plan; every later one is copied into
  the plan's stacked tensors with `copy_` on the current stream (the
  stream a replay runs on, after a prefetched batch's event), so on the
  card the first group warms up, the second captures and every later
  group replays, across `fit` calls and epochs. The stacks keep the wire
  dtypes under an ingest (a uint8 K=4 ResNet-50 stack is 154 MB, a
  float32 one would be 617 MB), so the cast and the one-hot run inside
  the graph. The model keeps the plans of its MAX_PLANS most recently
  used signatures (variable shapes, such as length buckets, would
  otherwise keep every signature's stacks and graph on the card). A
  ragged tail and a group that cannot run as one run `fit_batch` batch by
  batch.

What a captured step needs (`ComputationGraph` and `MultiLayerNetwork`
provide it): the parameters, the layer states and the optimizer state
updated in place (so the next replay reads what the last one wrote); no
read of a device value on the host inside a step; a fixed learning rate
and momentum (`PerLayerOptimizer.fixed`; else no capture, above); the model's
dropout generators registered with the graph. A replay adds its graph's
recorded kernel launches to `launch_counts()`
(`kernels.add_graph_counts`) and its K·W optimizer steps to the
optimizer's count (`StepPlan.updates`). The listeners fire once per
plan, as the JAX package's fire once per execution
(nn/multistep.py:205-209): `record_batch_size(K·B)` and one
`iteration_done`, on the host after the replay; nothing of a listener
enters the graph.
"""
from __future__ import annotations

import torch

from ..kernels import add_graph_counts, graph_counts

MAX_PLANS = 4       # `_fit_grouped`'s plans a model keeps, by recent use


class StepPlan:
    """K batches stacked on the model's device for `fit_prepared`:
    `batch` is the model's prepared batch (a ComputationGraph's inputs,
    labels, masks and label masks, each a list; a MultiLayerNetwork's x,
    y, mask and label mask) with `[K, ...]` tensors in place of its
    tensors (None entries kept); `windows` the optimizer steps each batch
    takes (1, or W truncated-BPTT windows). On the card it also holds its
    captured graph, the `[K]` scores the graph writes and the kernel
    launches one replay makes."""

    def __init__(self, model, batch, K, windows=1):
        self.model = model
        self.batch = batch
        self.K = int(K)
        self.windows = int(windows)
        self.updates = self.K * self.windows
        self.warm = False
        self.graph = None
        self.scores = None
        self.launches = {}
        self.epoch = None

    def steps(self):
        """The K per-batch prepared batches, of views into the stacked
        tensors."""
        def pick(part, i):
            if isinstance(part, list):
                return [None if t is None else t[i] for t in part]
            return None if part is None else part[i]
        return [tuple(pick(part, i) for part in self.batch)
                for i in range(self.K)]


_MISMATCH = object()


def _stack_leaf(leaf):
    """A `[K, ...]` stack of K tensors (None for K Nones), or _MISMATCH
    where their shapes, types or presence differ."""
    if leaf[0] is None:
        return None if all(t is None for t in leaf) else _MISMATCH
    if any(t is None or t.shape != leaf[0].shape
           or t.dtype != leaf[0].dtype for t in leaf):
        return _MISMATCH
    return torch.stack(leaf)


def _signature(prepped):
    """The group's leaf signature (each part a tensor, None or a list of
    them: shapes, dtypes, None pattern), or None where its batches
    differ."""
    def leaf(t):
        return None if t is None else (tuple(t.shape), t.dtype)

    def part(p):
        return tuple(leaf(t) for t in p) if isinstance(p, list) \
            else ("one", leaf(p))
    sigs = {tuple(part(p) for p in batch) for batch in prepped}
    return sigs.pop() if len(sigs) == 1 else None


def _refill(stacked, prepped):
    """Copy the prepared batches into a plan's `[K, ...]` stacks."""
    with torch.no_grad():
        for j, st in enumerate(stacked):
            for i, batch in enumerate(prepped):
                if isinstance(st, list):
                    for s, t in zip(st, batch[j]):
                        if s is not None:
                            s[i].copy_(t)
                elif st is not None:
                    st[i].copy_(batch[j])


def _stack(prepped):
    """The prepared batches with one `[K, ...]` tensor per leaf (a part
    is a tensor, None or a list of them), or None where the group's
    shapes, types or mask structure differ."""
    parts = []
    for part in zip(*prepped):
        if isinstance(part[0], list):
            if any(not isinstance(p, list) or len(p) != len(part[0])
                   for p in part):
                return None
            stacked = [_stack_leaf(leaf) for leaf in zip(*part)]
            if any(t is _MISMATCH for t in stacked):
                return None
        else:
            stacked = _stack_leaf(part)
            if stacked is _MISMATCH:
                return None
        parts.append(stacked)
    return tuple(parts)


class MultiStepTrainable:
    """K-step training for a model that provides `params`, `init`,
    `conf`, `_iteration_done`,
    `_prep_batch`, `_windows` (a prepared batch's optimizer steps in a
    plan: 1, W truncated-BPTT windows, or None to go batch by batch),
    `_train_step` (one step's forward, backward,
    update and states on a prepared batch; returns the score tensor),
    `_tbptt_step` where `_windows` can exceed 1 (a batch's W windows;
    returns their mean score), `fit_batch`, `_optimizer`, `_dropout` and
    `device`, and keeps `_graph_epoch` (raised where captured graphs go
    stale), `_plans` ({signature: plan} of `_fit_grouped`, the MAX_PLANS most
    recently used, emptied by `init` and `set_ingest`) and `_graph_pool` / `_capture_stream` (None
    until the first capture)."""

    def _prepped(self, group):
        """(the group's prepared batches, the windows of each), or None
        where the group runs batch by batch."""
        if self.params is None:
            self.init()
        if self.conf.optimization_algo != "sgd":
            return None
        # decided on the first batch, before the others are staged
        first = self._prep_batch(group[0])
        windows = self._windows(first)
        if windows is None:
            return None
        return [first] + [self._prep_batch(ds) for ds in group[1:]], windows

    def prepare_steps(self, group):
        staged = self._prepped(group)
        if staged is None:
            return None
        stacked = _stack(staged[0])
        return None if stacked is None else StepPlan(
            self, stacked, len(group), staged[1])

    def fit_prepared(self, plan):
        """Run a plan's K steps: `last_scores` becomes their [K] scores
        (a device tensor), the score the last of them, `iteration_count`
        advances by K, then the listeners hear of K·B rows once."""
        if plan.model is not self:
            raise ValueError("the plan was prepared by another model")
        if self.device.type == "cuda":
            scores = self._run_on_card(plan)
        else:
            scores = self._run_steps(plan)
        self.last_scores = scores
        self._score = scores[-1]
        self.iteration_count += plan.K
        first = plan.batch[0][0] if isinstance(plan.batch[0], list) \
            else plan.batch[0]
        self._iteration_done(plan.K * first.shape[1])
        return self

    def _run_steps(self, plan):
        step = self._train_step if plan.windows == 1 else self._tbptt_step
        return torch.stack([step(*batch) for batch in plan.steps()])

    def _run_on_card(self, plan):
        if plan.epoch != self._graph_epoch:
            plan.warm, plan.graph, plan.scores = False, None, None
            plan.epoch = self._graph_epoch
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        if not plan.warm or not self._optimizer.fixed:
            # the warm-up, and every call under a scheduled rate or
            # momentum (a graph would replay the rate of its capture)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                scores = self._run_steps(plan)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            plan.warm = True
            return scores
        if plan.graph is None:
            self._capture(plan, stream)
        self._dropout.sync()
        plan.graph.replay()
        self._optimizer.count += plan.updates
        add_graph_counts(plan.launches)
        return plan.scores.clone()

    def _capture(self, plan, stream):
        """Capture the plan's K steps into one CUDA graph (nothing runs:
        the optimizer's count and the kernel counts the capture made are
        taken back). The capture is thread-local: a DevicePrefetcher's
        worker (etl/prefetch.py) keeps pinning, copying on its side
        streams and waiting on its events meanwhile, which a global
        capture would take for an illegal call and abort."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self._dropout.generators():
            graph.register_generator_state(gen)
        self._dropout.sync()
        count, before = self._optimizer.count, graph_counts()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                scores = self._run_steps(plan)
        finally:
            self._optimizer.count = count
            launches = graph_counts(before)
            add_graph_counts(launches, -1)
        plan.graph, plan.scores, plan.launches = graph, scores, launches

    def _group_plan(self, group):
        """The model's plan for the group's signature with the group
        copied into its stacks (a new plan for a new signature, dropping
        the least recently used beyond MAX_PLANS), or None where the group
        cannot run as one (as `prepare_steps`)."""
        staged = self._prepped(group)
        sig = None if staged is None else _signature(staged[0])
        if sig is None:
            return None
        prepped, windows = staged
        key = (sig, len(group), windows)
        plan = self._plans.pop(key, None)
        if plan is not None:
            _refill(plan.batch, prepped)
        else:
            plan = StepPlan(self, _stack(prepped), len(group), windows)
            while len(self._plans) >= MAX_PLANS:
                del self._plans[next(iter(self._plans))]
        self._plans[key] = plan     # the most recently used goes last
        return plan

    def _fit_grouped(self, it, K):
        """One epoch: full groups of K through the signature's plan
        (`_group_plan`) and `fit_prepared`; a ragged tail and a group that
        cannot run as one batch by batch through `fit_batch`."""
        group = []

        def flush(group):
            plan = self._group_plan(group) if len(group) == K else None
            if plan is not None:
                self.fit_prepared(plan)
            else:
                for ds in group:
                    self.fit_batch(ds)

        for ds in it:
            group.append(ds)
            if len(group) == K:
                flush(group)
                group = []
        if group:
            flush(group)
