"""Monotone dimension-level pruning: exact scores and the τ prewarm.

S_k²(p,q) = Σ_{j≤k} d_j²(p,q) is non-decreasing in k, so once
S_k² > τ ≥ (final kth-best distance), p can never enter the top-K. τ
starts at the kth-best distance of a sample of real candidates, an upper
bound, so pruning changes work and never results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import IVFIndex


def exact_scores(x: torch.Tensor, q: torch.Tensor, metric: str = "l2"
                 ) -> torch.Tensor:
    """Full-dimension scores, ascending-better. [NQ, N]."""
    if metric == "l2":
        return ((q * q).sum(1)[:, None] - 2.0 * (q @ x.T)
                + (x * x).sum(1)[None, :])
    elif metric == "ip":
        return -(q @ x.T)
    raise ValueError(metric)


def prewarm_tau(
    index: IVFIndex,
    q: np.ndarray,
    probes: np.ndarray,
    k: int,
    samples_per_cluster: int = 4,
    metric: str = "l2",
    dead_rows: Optional[np.ndarray] = None,
) -> np.ndarray:
    """PrewarmHeap (Alg. 1, lines 1–5): exactly score the first
    ``samples_per_cluster`` rows of every probed cluster; the kth-smallest
    sampled distance is a valid initial τ. ``dead_rows`` (bool [NB],
    packed-row tombstones) leaves dead rows out of the sample.

    The sample table is host bookkeeping; the rows are gathered and
    scored on the index's device, in the difference form Σ(x−q)² as in
    the reference. Returns tau0 [NQ] float32 (+inf where the sample was
    smaller than K).
    """
    nq = q.shape[0]
    take = np.minimum(index.sizes, samples_per_cluster)
    sample_rows_per_cluster = [
        np.arange(index.offsets[c], index.offsets[c] + take[c], dtype=np.int64)
        for c in range(index.nlist)
    ]
    all_rows = [
        np.concatenate([sample_rows_per_cluster[c] for c in probes[i]])
        if probes.shape[1]
        else np.zeros((0,), np.int64)
        for i in range(nq)
    ]
    width = max((len(r) for r in all_rows), default=0)
    tau0 = np.full((nq,), np.inf, np.float32)
    if width == 0:
        return tau0
    mat = np.zeros((nq, width), np.int64)
    msk = np.zeros((nq, width), bool)
    for i, rows in enumerate(all_rows):
        mat[i, : len(rows)] = rows
        msk[i, : len(rows)] = True
    if dead_rows is not None:
        msk &= ~dead_rows[mat]
    dev = index.device
    cand = index.x[torch.as_tensor(mat, device=dev)]          # [NQ, W, D]
    qt = torch.as_tensor(np.asarray(q, np.float32)).to(dev)
    if metric == "l2":
        diff = cand - qt[:, None, :]
        sc = (diff * diff).sum(2)
    else:
        sc = -(cand * qt[:, None, :]).sum(2)
    sc = torch.where(torch.as_tensor(msk, device=dev), sc, torch.inf)
    counts = msk.sum(axis=1)
    if width < k:
        return tau0
    kth = torch.sort(sc, dim=1).values[:, k - 1].cpu().numpy()
    return np.where(counts >= k, kth, np.inf).astype(np.float32)
