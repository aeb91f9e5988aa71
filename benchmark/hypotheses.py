"""RANSAC hypotheses the benchmark draws itself and injects into the program
(``DatasetProblem.precompute_pair_alignments(hyp_idx=)``), so that the
program and the plain reference fit the same ones."""

from __future__ import annotations

import numpy as np


def pair_matches(state_ids, point_ids, K: int) -> list:
    """Each consecutive pair's matched observation rows ``(rows at k-1,
    rows at k)``, by landmark id in increasing order (index 0 unused), the
    order in which the program numbers a pair's matches."""
    of_state = [np.nonzero(state_ids == k)[0] for k in range(K)]
    pairs = [None]
    for k in range(1, K):
        a, b = of_state[k - 1], of_state[k]
        _, ia, ib = np.intersect1d(point_ids[a], point_ids[b], return_indices=True)
        pairs.append((a[ia], b[ib]))
    return pairs


def draw(pairs, iters: int, g: np.random.Generator) -> np.ndarray:
    """``[K, iters, 3]``: three distinct matches of each pair, uniformly."""
    hyp = np.tile(np.arange(3), (len(pairs), iters, 1))
    for k in range(1, len(pairs)):
        n = pairs[k][0].size
        if n >= 3:
            hyp[k] = np.argpartition(g.random((iters, n)), 3, axis=-1)[:, :3]
    return hyp
