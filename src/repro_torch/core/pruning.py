"""Monotone dimension-level pruning: exact scores, the τ prewarm and the
host engine's heap merge.

S_k²(p,q) = Σ_{j≤k} d_j²(p,q) is non-decreasing in k, so once
S_k² > τ ≥ (final kth-best distance), p can never enter the top-K. τ
starts at the kth-best distance of a sample of real candidates, an upper
bound, so pruning changes work and never results.

``TopKHeap`` and ``partial_scores_block`` serve the host engine
(``harmony_search``) and the host merge; they are numpy, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import IVFIndex


@dataclass
class TopKHeap:
    """Vectorized per-query top-K state (scores ascending, -1 padded ids)."""

    scores: np.ndarray   # [NQ, K] float32, +inf padded
    ids: np.ndarray      # [NQ, K] int64, -1 padded

    @classmethod
    def empty(cls, nq: int, k: int) -> "TopKHeap":
        return cls(np.full((nq, k), np.inf, np.float32), np.full((nq, k), -1, np.int64))

    @property
    def tau(self) -> np.ndarray:
        """Current per-query pruning threshold = kth best so far (+inf if
        the heap is not full)."""
        return self.scores[:, -1].copy()

    def merge_rows(self, rows: np.ndarray, new_scores: np.ndarray, new_ids: np.ndarray):
        """Merge candidates [m, C] into the heaps of the queries ``rows``
        [m] (a partial sort, then a stable sort of the kept K)."""
        if rows.size == 0 or new_scores.shape[1] == 0:
            return
        k = self.scores.shape[1]
        cat_s = np.concatenate([self.scores[rows], new_scores.astype(np.float32)], axis=1)
        cat_i = np.concatenate([self.ids[rows], new_ids.astype(np.int64)], axis=1)
        part = np.argpartition(cat_s, kth=k - 1, axis=1)[:, :k]
        take_s = np.take_along_axis(cat_s, part, axis=1)
        take_i = np.take_along_axis(cat_i, part, axis=1)
        order = np.argsort(take_s, axis=1, kind="stable")
        self.scores[rows] = np.take_along_axis(take_s, order, axis=1)
        self.ids[rows] = np.take_along_axis(take_i, order, axis=1)


def partial_scores_block(
    x_blk: np.ndarray,
    q_blk: np.ndarray,
    xnorm2_blk: np.ndarray,
    metric: str = "l2",
) -> np.ndarray:
    """One dimension block's contribution d_b² (or −partial dot), [NQ, N]:
    ‖p‖²_b − 2 p·q|_b + ‖q‖²_b (L2) or −p·q|_b (IP). Summing over blocks
    gives the exact score."""
    if metric == "l2":
        qn = np.sum(q_blk * q_blk, axis=1)[:, None]
        return (qn - 2.0 * (q_blk @ x_blk.T) + xnorm2_blk[None, :]).astype(np.float32)
    elif metric == "ip":
        return (-(q_blk @ x_blk.T)).astype(np.float32)
    raise ValueError(metric)


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
