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
  shapes or the structure of the masks differ within the group. (JAX's
  `_multi_step_mode` also sends the flat solvers and TBPTT batch by
  batch; the port refuses both before, in `_check_trainable`.) A plan is
  reusable; its batch is never written.
- `fit_prepared(plan)` runs its K steps. On the host every call runs them
  eagerly. On the card a plan's first call runs them eagerly, on the side
  stream its capture uses: that call is the warm-up (the optimizer state,
  the kernels' builds, cuBLAS's and cuDNN's workspaces). Its second call
  captures the K steps into one `torch.cuda.CUDAGraph` held by the plan
  and replays it; every later call is one replay. (A plan used once, as
  `fit(steps_per_execution=K)` makes one per group, is never captured.)
  A failed capture or replay raises; no call runs the eager steps in
  its place. The graphs of a model share one memory pool. `init` and a
  rebuilt updater make every captured graph stale: a stale plan warms up
  and captures again.
- `_fit_grouped(it, K)`: full groups go through a plan; a ragged tail and
  a group that cannot run as one run `fit_batch` batch by batch.

What a captured step needs (`ComputationGraph` provides it): the
parameters, the layer states and the optimizer state updated in place
(so the next replay reads what the last one wrote); no read of a device
value on the host inside a step; a learning rate fixed for the capture
(`PerLayerOptimizer.check_capturable`); the model's dropout generators
registered with the graph. A replay adds its graph's recorded kernel
launches to `launch_counts()` (`kernels.add_graph_counts`). The JAX
package fires its listeners once per execution (nn/multistep.py:205-209);
the port has no listeners yet (ROADMAP queue 1, nn core), so none fire.
"""
from __future__ import annotations

import torch

from ..kernels import add_graph_counts, graph_counts


class StepPlan:
    """K batches stacked on the model's device for `fit_prepared`:
    `batch` is (inputs, labels, masks, label masks), each a list of
    `[K, ...]` tensors (or None, and None entries kept). On the card it
    also holds its captured graph, the `[K]` scores the graph writes and
    the kernel launches one replay makes."""

    def __init__(self, model, batch, K):
        self.model = model
        self.batch = batch
        self.K = int(K)
        self.warm = False
        self.graph = None
        self.scores = None
        self.launches = {}
        self.epoch = None

    def steps(self):
        """The K per-step batches, each (inputs, labels, masks, label
        masks) of views into the stacked tensors."""
        def pick(ts, i):
            return None if ts is None else \
                [None if t is None else t[i] for t in ts]
        return [tuple(pick(part, i) for part in self.batch)
                for i in range(self.K)]


def _stack(prepped):
    """One `[K, ...]` tensor per leaf of the prepared batches, or None
    where the group's shapes, types or mask structure differ."""
    parts = []
    for part in zip(*prepped):
        if part[0] is None:
            if any(p is not None for p in part):
                return None
            parts.append(None)
            continue
        if any(p is None or len(p) != len(part[0]) for p in part):
            return None
        leaves = []
        for leaf in zip(*part):
            if leaf[0] is None:
                if any(t is not None for t in leaf):
                    return None
                leaves.append(None)
                continue
            if any(t is None or t.shape != leaf[0].shape
                   or t.dtype != leaf[0].dtype for t in leaf):
                return None
            leaves.append(torch.stack(leaf))
        parts.append(leaves)
    return tuple(parts)


class MultiStepTrainable:
    """K-step training for a model that provides `params`, `init`,
    `_check_trainable`, `_prep_batch`, `_train_step`
    (one step's forward, backward, update and states; returns the score
    tensor), `fit_batch`, `_optimizer`, `_dropout` and `device`, and
    keeps `_graph_epoch` (raised where captured graphs go stale) and
    `_graph_pool` / `_capture_stream` (None until the first capture)."""

    def prepare_steps(self, group):
        if self.params is None:
            self.init()
        self._check_trainable()
        stacked = _stack([self._prep_batch(ds) for ds in group])
        return None if stacked is None else StepPlan(self, stacked,
                                                      len(group))

    def fit_prepared(self, plan):
        """Run a plan's K steps: `last_scores` becomes their [K] scores
        (a device tensor), the score the last of them, and
        `iteration_count` advances by K."""
        if plan.model is not self:
            raise ValueError("the plan was prepared by another model")
        self._check_trainable()
        if self.device.type == "cuda":
            scores = self._run_on_card(plan)
        else:
            scores = self._run_steps(plan)
        self.last_scores = scores
        self._score = scores[-1]
        self.iteration_count += plan.K
        return self

    def _run_steps(self, plan):
        return torch.stack([self._train_step(*step)
                            for step in plan.steps()])

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
        self._optimizer.count += plan.K
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
