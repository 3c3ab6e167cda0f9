"""Model-free speculative drafting by n-gram prompt lookup
(``repro.runtime.drafter``, the port's own copy).

A decode step sweeps every weight for one token per sequence; a verify
step scores ``k`` drafted tokens plus one more in a single sweep.  The
drafts come from the sequence's own history (prompt + generated tokens):
the continuation of the most recent earlier occurrence of its trailing
n-gram.  That costs no model and no device memory.  A wrong draft costs
compute, never correctness: the verify step accepts only drafts equal to
the model's own choice, so greedy speculative decode gives plain greedy
decode's tokens.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class NgramDrafter:
    """Propose ``k`` draft tokens per call by n-gram prompt lookup.

    For ``n = ngram_max .. ngram_min``: find the most recent earlier
    occurrence of the history's trailing n-gram; if found, propose the ``k``
    tokens that followed it (padded by repeating the continuation's last
    token when the match sits near the end of history).  Longer n-grams are
    tried first.  With no match at any n, the last token is repeated: when
    every draft is rejected the verify step still emits one token, so the
    floor is plain decode.
    """

    def __init__(self, k: int, ngram_max: int = 3, ngram_min: int = 1):
        if k < 1:
            raise ValueError("drafter needs k >= 1")
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.k = k
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    @staticmethod
    def _last_match(hist: np.ndarray, n: int) -> Optional[int]:
        """Start of the most recent occurrence of ``hist[-n:]`` that ends
        before the final position (so a continuation exists), or None."""
        if len(hist) <= n:
            return None
        pat = hist[-n:]
        # windows start at 0..len-n; the last one is the pattern itself
        win = np.lib.stride_tricks.sliding_window_view(hist, n)[:-1]
        matches = np.nonzero((win == pat).all(axis=1))[0]
        return int(matches[-1]) if matches.size else None

    def propose(self, history: np.ndarray) -> np.ndarray:
        """history (prompt + generated so far, most recent last) -> (k,)
        int32 draft tokens continuing it."""
        hist = np.asarray(history, dtype=np.int64).ravel()
        if len(hist) == 0:
            raise ValueError("cannot draft from an empty history")
        for n in range(min(self.ngram_max, len(hist) - 1), self.ngram_min - 1, -1):
            i = self._last_match(hist, n)
            if i is None:
                continue
            cont = hist[i + n:i + n + self.k]
            if len(cont) < self.k:
                cont = np.concatenate([cont, np.full(self.k - len(cont), cont[-1])])
            return cont.astype(np.int32)
        return np.full(self.k, hist[-1], np.int32)

    def propose_many(self, histories) -> np.ndarray:
        """Drafts for a batch of histories -> (len(histories), k) int32."""
        if not len(histories):
            return np.zeros((0, self.k), np.int32)
        return np.stack([self.propose(h) for h in histories])
