"""Draft proposers for speculative decoding, copied from the JAX package's
``inference/v2/spec/proposer.py`` (numpy only).

The verify step (``ragged_model.build_verify_step``) accepts a draft token
only where it equals the greedy argmax the full model computes in the same
pass, so any proposal is safe: a bad draft costs verify rows, never a
wrong token. The proposer is a throughput knob behind one method:

- :class:`NGramProposer` (the default): prompt-lookup decoding. Match the
  longest recent suffix of the sequence's own history against earlier
  history and propose the continuation of the most recent match. No second
  model and no device work: repetitive or templated text drafts itself.
- A draft *model* slots into the same interface; the pipeline only calls
  ``propose``.
"""

from __future__ import annotations

import numpy as np


class DraftProposer:
    """Interface: propose up to ``k`` draft tokens continuing ``history``.

    ``history`` is the sequence's token ids so far (prompt + emitted
    generation, int32, host-side); implementations return an int32 array of
    length <= k — empty means "no proposal" and the verify step degenerates
    to a plain decode step for that row. Called once per live row per
    pipeline step, on the host hot loop: keep it allocation-light.
    """

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramProposer(DraftProposer):
    """Prompt-lookup / n-gram drafting over the sequence's own history.

    For n from ``max_ngram`` down to ``min_match``: take the history's
    n-token suffix, find its most recent earlier occurrence, and propose the
    k tokens that followed it. Longer matches are tried first (they predict
    better). Among a suffix's occurrences, the most recent one with a FULL
    k-token continuation wins: the very latest occurrence sits near the end
    of history with almost nothing after it, and a truncated draft wastes
    verify rows the budget already paid for (in a loop of period p every
    occurrence continues identically, so preferring an older full one loses
    nothing). O(len(history) * n) per call via one vectorised window
    comparison, fine at serving history lengths.
    """

    def __init__(self, min_match: int = 2, max_ngram: int = 4):
        if min_match < 1 or max_ngram < min_match:
            raise ValueError(f"need 1 <= min_match <= max_ngram, got "
                             f"({min_match}, {max_ngram})")
        self.min_match = min_match
        self.max_ngram = max_ngram

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32)
        T = len(h)
        if k < 1:
            return h[:0]
        for n in range(self.max_ngram, self.min_match - 1, -1):
            if T < n + 1:
                continue
            suffix = h[T - n:]
            # all n-windows strictly before the suffix itself
            win = np.lib.stride_tricks.sliding_window_view(h, n)[:T - n]
            hits = np.nonzero((win == suffix).all(axis=1))[0]
            if len(hits):
                full = hits[hits + n + k <= T]
                start = int(full[-1] if len(full) else hits[-1]) + n
                cont = h[start:start + k]
                if len(cont):
                    return cont
        return h[:0]
