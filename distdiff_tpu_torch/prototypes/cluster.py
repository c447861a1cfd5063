"""Average-linkage agglomerative clustering in numpy (port of
``distdiff_tpu/prototypes/cluster.py``; the port's own copy).

The reference's original uses ``sklearn.cluster.AgglomerativeClustering(
n_clusters=K, linkage='average')``. Classes hold tens to a few hundred
samples, so the O(n^3) Lance-Williams update on the host is fast enough.
"""

from __future__ import annotations

import numpy as np


def agglomerative_average(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """Cluster the rows of ``x [N, D]`` into ``n_clusters`` groups by
    Euclidean average linkage (UPGMA); integer labels ``[N]`` from 0."""
    n = x.shape[0]
    if n_clusters >= n:
        return np.arange(n)
    sq = np.sum(x * x, axis=1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0))
    np.fill_diagonal(d, np.inf)
    active = list(range(n))
    sizes = {i: 1 for i in range(n)}
    members = {i: [i] for i in range(n)}
    while len(active) > n_clusters:
        sub = d[np.ix_(active, active)]
        ai, aj = np.unravel_index(np.argmin(sub), sub.shape)
        i, j = sorted((active[ai], active[aj]))
        # Lance-Williams: d(i u j, k) = (|i| d(i, k) + |j| d(j, k)) / (|i| + |j|)
        ni, nj = sizes[i], sizes[j]
        for k in active:
            if k not in (i, j):
                d[i, k] = d[k, i] = (ni * d[i, k] + nj * d[j, k]) / (ni + nj)
        sizes[i] = ni + nj
        members[i].extend(members[j])
        active.remove(j)
        d[j, :] = np.inf
        d[:, j] = np.inf
    labels = np.empty(n, np.int64)
    for li, root in enumerate(active):
        labels[members[root]] = li
    return labels
