"""Speculative decoding (counterpart of
deeplearning4j_tpu/decode/speculative.py): a cheap DRAFT proposes K
tokens, the TARGET verifies all K in one batched pass (arXiv 2211.17192's
accept/rollback).

The decode step is bound by memory traffic: each target step reads the
whole KV cache and weight set to emit one token. The verify pass
(`DecodeEngine.verify`) reads the same bytes once but scores a K+1-token
window, so every accepted draft token amortizes the target's traffic; a
draft that agrees with the target a fraction `r` of the time yields ~(1 +
r·K) tokens per target pass.

Contract: GREEDY speculative output is token-for-token target-only greedy
decoding. A draft token survives only when it is the target's argmax, the
first mismatch is replaced by the target's argmax, and a fully accepted
window earns a bonus token from the window's last distribution.

Sampled mode runs the standard rejection scheme on the FILTERED
distributions (`sampling.filter_probs_np`): accept draft token x with
probability min(1, p_t(x) / p_d(x)); on the first rejection resample from
normalize(max(p_t - p_d, 0)). The output is distributed as target-only
sampling, but it is another draw from that distribution, reproducible for
a given seed.

Rollback, per model family:
- target: attention-only, slab layout. The verify pass writes the whole
  window into the cache; rollback is NOT advancing the slot's length past
  the accepted prefix (`DecodeEngine.set_length`, written into the
  cache's length tensor). Stale K/V past the accepted length is causally
  masked. A recurrent target raises DecodeUnsupported.
- draft: any decodable model. An attention draft rolls back by length
  too; a recurrent draft snapshots its carries before proposing
  (`carry_snapshot`: host copies, since the engine writes its cache in
  place) and restores them (`carry_restore`) and replays the accepted
  tokens on rejection.
"""
from __future__ import annotations

import numpy as np

from .engine import DecodeEngine, DecodeUnsupported
from .sampling import filter_probs_np


class SpeculativeEngine:
    """A draft and target pair decoding one request at a time (slot 0 of
    two single-slot engines, each on its model's device). `k` is the
    proposal window; `stats()` counts proposals, acceptances, rounds and
    emitted tokens."""

    def __init__(self, draft_model, target_model, *, k=4, max_len=128):
        if draft_model is target_model:
            raise ValueError("draft and target must be distinct models "
                             "(a self-draft verifies nothing)")
        self.k = int(k)
        if self.k < 1:
            raise ValueError("k must be >= 1")
        self.capacity = int(max_len)
        self.target = DecodeEngine(target_model, slots=1, max_len=max_len)
        if self.target.has_recurrent():
            raise DecodeUnsupported(
                "speculative target must be attention-only: verify rollback "
                "is a length reset and recurrent carries cannot rewind")
        self.draft = DecodeEngine(draft_model, slots=1, max_len=max_len)
        if self.draft.vocab != self.target.vocab:
            raise ValueError(
                f"draft vocab {self.draft.vocab} != target vocab "
                f"{self.target.vocab}: accept/rollback compares token ids")
        self._draft_recurrent = self.draft.has_recurrent()
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0
        self.emitted = 0

    @classmethod
    def from_registry(cls, model_registry, draft_version, target_version,
                      **kwargs):
        raise NotImplementedError(
            "building from registry versions needs a lookup by version, "
            "which the in-memory serving registry does not have (ROADMAP "
            "queue 1 item 5: serving, the rest)")

    def acceptance_rate(self):
        return self.accepted / max(self.proposed, 1)

    def stats(self):
        return {"proposed": self.proposed, "accepted": self.accepted,
                "acceptance_rate": self.acceptance_rate(),
                "rounds": self.rounds, "emitted": self.emitted}

    # --------------------------------------------------------------- decode
    def generate(self, prompt_ids, max_new_tokens=20, stop_id=None,
                 sampler=None):
        """Speculative decode; returns the generated token ids (greedy
        unless `sampler`; greedy output is exactly
        `DecodeEngine(target).generate(...)`)."""
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if len(prompt) + 1 > self.capacity:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room in "
                f"capacity {self.capacity}")
        greedy = sampler is None or sampler.is_greedy
        rng = None if greedy else np.random.default_rng(sampler.seed)

        tc = self.target.init_cache()
        dc = self.draft.init_cache()
        # prefill both; the TARGET's emission is the first output token
        # (the draft's is discarded: it only primes the draft cache)
        tc, first, _ = self.target.prefill(tc, 0, prompt, sampling=sampler)
        dc, _, _ = self.draft.prefill(dc, 0, prompt)
        # toks = prompt + emitted. Between rounds the target cache holds
        # toks[:fed_t] with fed_t == len(toks) - 1 (the draft catches up
        # lazily); toks[-1] is the pending token neither model has
        # consumed yet.
        toks = prompt + [first]
        fed_t = len(toks) - 1
        fed_d = len(prompt)
        out = [first]
        ids1 = np.zeros((1,), np.int32)

        def done():
            return len(out) >= int(max_new_tokens) or \
                (stop_id is not None and out[-1] == stop_id)

        while not done():
            # window sizing: verify appends W = kk + 1 tokens at fed_t
            kk = min(self.k, self.capacity - len(toks))
            if kk < 1:
                break                                    # capacity reached
            # ---- draft catch-up: feed the tokens accepted last round
            while fed_d < len(toks) - 1:
                ids1[0] = toks[fed_d]
                dc, _, _ = self.draft.step(dc, ids1)
                fed_d += 1
            snap = self.draft.carry_snapshot(dc) if self._draft_recurrent \
                else None
            # ---- propose: kk draft steps from the pending token
            drafts, draft_dists = [], []
            nxt = toks[-1]
            for _ in range(kk):
                ids1[0] = nxt
                dc, step_nxt, dp = self.draft.step(dc, ids1)
                fed_d += 1
                if greedy:
                    nxt = int(step_nxt[0])
                else:
                    dist = filter_probs_np(dp[0], sampler)
                    draft_dists.append(dist)
                    nxt = int(rng.choice(dist.shape[0], p=dist))
                drafts.append(nxt)
            # ---- verify: one batched target pass over the whole window
            window = [toks[-1]] + drafts                 # W = kk + 1
            tc, vprobs = self.target.verify(tc, 0, window, fed_t)
            # vprobs[i]: the target's next-token distribution after
            # window position i, the one drafts[i] must come from
            accepted = 0
            emitted = []
            for i, d in enumerate(drafts):
                if greedy:
                    t = int(np.argmax(vprobs[i]))
                    if d == t:
                        accepted += 1
                        emitted.append(d)
                        continue
                    emitted.append(t)                    # the correction
                    break
                pt = filter_probs_np(vprobs[i], sampler)
                pd = draft_dists[i]
                if rng.random() < min(1.0, pt[d] / max(pd[d], 1e-30)):
                    accepted += 1
                    emitted.append(d)
                    continue
                resid = np.maximum(pt - pd, 0.0)
                tot = resid.sum()
                pr = resid / tot if tot > 0 else pt
                emitted.append(int(rng.choice(pr.shape[0], p=pr)))
                break
            else:
                # full accept: the window's last distribution is a bonus
                # token no extra pass pays for
                if greedy:
                    emitted.append(int(np.argmax(vprobs[kk])))
                else:
                    pb = filter_probs_np(vprobs[kk], sampler)
                    emitted.append(int(rng.choice(pb.shape[0], p=pb)))
            # ---- commit + rollback
            toks.extend(emitted)
            out.extend(emitted)
            # target: accepted prefix = pending + accepted drafts
            fed_t += 1 + accepted
            tc = self.target.set_length(tc, 0, fed_t)
            # draft: attention rolls back by length; recurrent restores the
            # pre-proposal carries (the accepted tokens replay in the next
            # round's catch-up)
            if accepted < len(drafts):
                if self._draft_recurrent:
                    dc = self.draft.carry_restore(dc, snap)
                    fed_d = len(toks) - 1 - len(emitted)
                else:
                    # the draft cache's first len(old toks) + accepted
                    # entries are exactly toks[:-1] (the correction token
                    # is pending)
                    fed_d = len(toks) - 1
                    dc = self.draft.set_length(dc, 0, fed_d)
            # full accept: the draft holds toks up to the last draft;
            # fed_d is len(toks) - 2 (the bonus pending, its predecessor
            # unfed): the next catch-up feeds it
            self.rounds += 1
            self.proposed += len(drafts)
            self.accepted += accepted
            self.emitted += len(emitted)
        # over-emission past max_new_tokens / stop is trimmed, so output
        # length semantics match the plain decode loop
        if stop_id is not None and stop_id in out:
            out = out[:out.index(stop_id) + 1]
        return out[:int(max_new_tokens)]
