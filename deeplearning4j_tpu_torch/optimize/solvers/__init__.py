"""Solvers: line search, conjugate gradient, LBFGS (counterpart of
deeplearning4j_tpu/optimize/solvers/__init__.py).

Each solver works on ONE flat parameter vector on the model's device, in
the JAX package's leaf order (`jax.tree_util.tree_leaves` of the
{layer: {key: array}} tree: layer names, then keys, each in sorted string
order), so a flat vector from the JAX package loads into the port. One
loss-and-gradient closure over the current minibatch serves every
line-search probe: a probe views the vector as the parameter tree
(`_unravel`, no copy) and runs the model's loss at inference (no dropout),
so the objective is fixed within a step. After the iterations the vector
is written into the parameters IN PLACE (the per-layer optimizers hold
those tensors) and one training-mode pass, without dropout, refreshes the
layer states (batch norm's running statistics), as in the JAX package.

Reference: optimize/Solver.java (the factory on OptimizationAlgorithm),
optimize/solvers/{BackTrackLineSearch, LineGradientDescent,
ConjugateGradient, LBFGS}.java.
"""
from __future__ import annotations

import math

import torch

from ...nn.conf.configuration import OptimizationAlgorithm


def _leaves(params):
    """(layer, key) of every parameter in the JAX package's leaf order."""
    return [(name, k) for name in sorted(params) for k in sorted(params[name])]


def _ravel(params):
    """The parameters as one flat vector (a copy), in leaf order."""
    ts = [params[n][k].reshape(-1) for n, k in _leaves(params)]
    return torch.cat(ts) if ts else torch.zeros(0)


def _unravel(vec, params):
    """A {layer: {key: view of `vec`}} tree shaped like `params`."""
    out, off = {name: {} for name in params}, 0
    for n, k in _leaves(params):
        t = params[n][k]
        out[n][k] = vec[off:off + t.numel()].view(t.shape)
        off += t.numel()
    return out


def _vdot(a, b):
    return float(torch.dot(a, b))


class BackTrackLineSearch:
    """Backtracking line search with Armijo sufficient decrease."""

    def __init__(self, score_fn, max_iterations=5, c1=1e-4, rho=0.5):
        self.score_fn = score_fn          # vec -> score
        self.max_iterations = int(max_iterations)
        self.c1 = c1
        self.rho = rho

    def optimize(self, w, f0, g, direction, initial_step=1.0):
        """A step along `direction` with sufficient decrease, or 0.0 when
        none is found (or `direction` does not descend)."""
        slope = _vdot(g, direction)
        if slope >= 0:
            return 0.0
        step = initial_step
        for _ in range(self.max_iterations):
            f_new = float(self.score_fn(w + step * direction))
            if math.isfinite(f_new) and f_new <= f0 + self.c1 * step * slope:
                return step
            step *= self.rho
        return 0.0


class BaseFlatSolver:
    """The flat vector's loss and gradient on the current minibatch, and
    the write-back after the iterations."""

    def __init__(self, model, max_iterations=1, line_search_iterations=5):
        self.model = model
        self.max_iterations = int(max_iterations)
        self.line_search_iterations = int(line_search_iterations)

    def _call_loss(self, p, x, y, mask, label_mask, train):
        """(score, new states) of the model's loss; a list of inputs is a
        ComputationGraph's batch. No dropout, in either mode."""
        m = self.model
        if isinstance(x, list):
            return m._loss(p, m.states, x, y, train=train, masks=mask,
                           label_masks=label_mask, dropout=False)
        return m._loss(p, m.states, x, y, train=train, mask=mask,
                       label_mask=label_mask, dropout=False)

    def _fns(self, x, y, mask, label_mask):
        """(vg, score): w -> (score tensor, gradient vector) and w -> score
        tensor, over this minibatch at inference."""
        params = self.model.params

        def vg(w):
            w = w.detach().requires_grad_()
            with torch.enable_grad():
                s, _ = self._call_loss(_unravel(w, params), x, y, mask,
                                       label_mask, False)
                g, = torch.autograd.grad(s, w, allow_unused=True)
            return s.detach(), torch.zeros_like(w) if g is None else g

        def score(w):
            with torch.no_grad():
                return self._call_loss(_unravel(w, params), x, y, mask,
                                       label_mask, False)[0]
        return vg, score

    def optimize(self, x, y, mask=None, label_mask=None):
        raise NotImplementedError

    def _finish(self, w, score, x, y, mask=None, label_mask=None):
        m = self.model
        with torch.no_grad():
            src = _unravel(w, m.params)
            for n, k in _leaves(m.params):
                m.params[n][k].copy_(src[n][k])
            # one training-mode pass refreshes the layer states
            _, states = self._call_loss(m.params, x, y, mask, label_mask,
                                        True)
            for name, s in states.items():
                for key, t in s.items():
                    if t is not m.states[name][key]:
                        m.states[name][key].copy_(t)
        m._score = float(score)


class LineGradientDescent(BaseFlatSolver):
    """Steepest descent with a backtracking line search."""

    def optimize(self, x, y, mask=None, label_mask=None):
        vg, score_fn = self._fns(x, y, mask, label_mask)
        w = _ravel(self.model.params)
        ls = BackTrackLineSearch(score_fn, self.line_search_iterations)
        for _ in range(self.max_iterations):
            f, g = vg(w)
            step = ls.optimize(w, float(f), g, -g)
            if step == 0.0:
                break
            w = w - step * g
        self._finish(w, score_fn(w), x, y, mask, label_mask)
        return self.model


class ConjugateGradient(BaseFlatSolver):
    """Nonlinear CG (Polak-Ribiere+), restarting on steepest descent once
    when a direction finds no step."""

    def optimize(self, x, y, mask=None, label_mask=None):
        vg, score_fn = self._fns(x, y, mask, label_mask)
        w = _ravel(self.model.params)
        ls = BackTrackLineSearch(score_fn, self.line_search_iterations)
        g_prev = None
        d = None
        for _ in range(self.max_iterations):
            f, g = vg(w)
            if g_prev is None:
                d = -g
            else:
                beta = _vdot(g, g - g_prev) / _vdot(g_prev, g_prev)
                d = -g + max(0.0, beta) * d     # PR+ restart
            step = ls.optimize(w, float(f), g, d)
            if step == 0.0:
                d = -g
                step = ls.optimize(w, float(f), g, d)
                if step == 0.0:
                    break
            w = w + step * d
            g_prev = g
        self._finish(w, score_fn(w), x, y, mask, label_mask)
        return self.model


class LBFGS(BaseFlatSolver):
    """Limited-memory BFGS by the two-loop recursion, memory m = 4 (the
    reference's default)."""

    def __init__(self, model, max_iterations=1, line_search_iterations=5,
                 m=4):
        super().__init__(model, max_iterations, line_search_iterations)
        self.m = int(m)

    def optimize(self, x, y, mask=None, label_mask=None):
        vg, score_fn = self._fns(x, y, mask, label_mask)
        w = _ravel(self.model.params)
        ls = BackTrackLineSearch(score_fn, self.line_search_iterations)
        s_hist, y_hist = [], []
        f, g = vg(w)
        for _ in range(self.max_iterations):
            q = g
            alphas = []
            for s, yv in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / _vdot(yv, s)
                a = rho * _vdot(s, q)
                alphas.append((a, rho, s, yv))
                q = q - a * yv
            if y_hist:
                q = (_vdot(s_hist[-1], y_hist[-1])
                     / _vdot(y_hist[-1], y_hist[-1])) * q
            for a, rho, s, yv in reversed(alphas):
                b = rho * _vdot(yv, q)
                q = q + (a - b) * s
            d = -q
            step = ls.optimize(w, float(f), g, d)
            if step == 0.0:
                d = -g
                step = ls.optimize(w, float(f), g, d)
                if step == 0.0:
                    break
            w_new = w + step * d
            f_new, g_new = vg(w_new)
            s_hist.append(w_new - w)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            w, f, g = w_new, f_new, g_new
        self._finish(w, f, x, y, mask, label_mask)
        return self.model


_SOLVERS = {
    OptimizationAlgorithm.LINE_GRADIENT_DESCENT: LineGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
}


def make_solver(algo, model, max_iterations=1, line_search_iterations=5):
    """The flat solver of `algo` for `model`."""
    if algo not in _SOLVERS:
        raise ValueError(f"no flat solver for {algo}")
    return _SOLVERS[algo](model, max_iterations=max_iterations,
                          line_search_iterations=line_search_iterations)
