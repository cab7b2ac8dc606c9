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
  is reusable; its batch is never written.
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
  plan and replays it; every later call is one replay. (A plan used once, as
  `fit(steps_per_execution=K)` makes one per group, is never captured.)
  A failed capture or replay raises; no call runs the eager steps in
  its place. The graphs of a model share one memory pool. `init` and a
  rebuilt updater make every captured graph stale: a stale plan warms up
  and captures again.
- `_fit_grouped(it, K)`: full groups go through a plan; a ragged tail and
  a group that cannot run as one run `fit_batch` batch by batch.

What a captured step needs (`ComputationGraph` and `MultiLayerNetwork`
provide it): the parameters, the layer states and the optimizer state
updated in place (so the next replay reads what the last one wrote); no
read of a device value on the host inside a step; a learning rate fixed
for the capture (`PerLayerOptimizer.check_capturable`); the model's
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
    stale) and `_graph_pool` / `_capture_stream` (None until the first
    capture)."""

    def prepare_steps(self, group):
        if self.params is None:
            self.init()
        if self.conf.optimization_algo != "sgd":
            return None
        # decided on the first batch, before the others are staged
        first = self._prep_batch(group[0])
        windows = self._windows(first)
        if windows is None:
            return None
        stacked = _stack([first] + [self._prep_batch(ds)
                                    for ds in group[1:]])
        return None if stacked is None else StepPlan(
            self, stacked, len(group), windows)

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
        if not plan.warm:
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
        taken back)."""
        self._optimizer.check_capturable()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self._dropout.generators():
            graph.register_generator_state(gen)
        self._dropout.sync()
        count, before = self._optimizer.count, graph_counts()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=stream):
                scores = self._run_steps(plan)
        finally:
            self._optimizer.count = count
            launches = graph_counts(before)
            add_graph_counts(launches, -1)
        plan.graph, plan.scores, plan.launches = graph, scores, launches

    def _fit_grouped(self, it, K):
        """One epoch: full groups of K through `prepare_steps` /
        `fit_prepared`; a ragged tail and a group that cannot run as one
        batch by batch through `fit_batch`."""
        group = []

        def flush(group):
            plan = self.prepare_steps(group) if len(group) == K else None
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
