"""Search paths that run as plain PyTorch on the index's device:

* :func:`search_oracle`, the exact IVF oracle (single-node Faiss-like
  scan), the ground truth the ring search is held against;
* :func:`two_stage_search`, the int8 tier's counterpart (int8 scan,
  then an exact fp32 re-rank), the ground truth of the executor's
  ``precision="int8"``.

The staged engine ``harmony_search`` and the merges of the reference
come with a later slice.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.index import IVFIndex, assign_queries
from repro_torch.core.types import SearchResult


def search_oracle(
    index: IVFIndex,
    q: np.ndarray,
    k: Optional[int] = None,
    nprobe: Optional[int] = None,
    chunk: int = 128,
    dead_rows: Optional[np.ndarray] = None,
) -> SearchResult:
    """Exact top-k over probed clusters (masked full scan, ``chunk``
    queries at a time) on the index's device.

    ``dead_rows`` (bool [NB], packed-row tombstones) leaves rows out of
    the candidate set. Ties go to the lowest packed row (a stable sort).
    """
    cfg = index.cfg
    k = k or cfg.topk
    q = np.asarray(q, np.float32)
    probes = assign_queries(index, q, nprobe)
    nq = q.shape[0]
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    t0 = time.perf_counter()
    dev = index.device
    cluster_of = torch.as_tensor(index.cluster_of.astype(np.int64), device=dev)
    live = (None if dead_rows is None
            else ~torch.as_tensor(np.asarray(dead_rows, bool), device=dev))
    xn2 = index.xnorm2 if cfg.metric == "l2" else None
    qt_all = torch.as_tensor(q).to(dev)
    kk = min(k, index.nb)
    for lo in range(0, nq, chunk):
        hi = min(nq, lo + chunk)
        member = np.zeros((hi - lo, index.nlist), bool)
        member[np.arange(hi - lo)[:, None], probes[lo:hi]] = True
        mask = torch.as_tensor(member, device=dev)[:, cluster_of]   # [m, NB]
        if live is not None:
            mask &= live[None, :]
        qt = qt_all[lo:hi]
        if cfg.metric == "l2":
            d = (qt * qt).sum(1)[:, None] - 2.0 * (qt @ index.x.T) + xn2[None, :]
        else:
            d = -(qt @ index.x.T)
        d = torch.where(mask, d, torch.inf)
        s, pos = torch.sort(d, dim=1, stable=True)
        s = s[:, :kk].cpu().numpy()
        pos = pos[:, :kk].cpu().numpy()
        out_s[lo:hi, :kk] = s
        out_i[lo:hi, :kk] = index.ids[pos]
        out_i[lo:hi][out_s[lo:hi] == np.inf] = -1
    dt = time.perf_counter() - t0
    return SearchResult(ids=out_i, scores=out_s, stats={"wall_s": dt})


def rerank_exact(index: IVFIndex, qt: torch.Tensor, rows: torch.Tensor,
                 valid: torch.Tensor, k: int):
    """Exact fp32 L2 distances of the packed ``rows`` [m, K'] to the
    queries ``qt`` [m, D], +inf where not ``valid``, and the ``k`` best
    per query in ascending order (a stable sort, so ties keep their
    stage-1 rank). Returns (scores [m, k], positions in K' [m, k])."""
    xg = index.x[rows]                                       # [m, K', D]
    d = ((qt * qt).sum(1)[:, None]
         - 2.0 * torch.einsum("md,mkd->mk", qt, xg) + index.xnorm2[rows])
    d = torch.where(valid, d, torch.inf)
    sc, sel = torch.sort(d, dim=1, stable=True)
    return sc[:, :k], sel[:, :k]


def two_stage_search(
    index: IVFIndex,
    q: np.ndarray,
    k: Optional[int] = None,
    nprobe: Optional[int] = None,
    probes: Optional[np.ndarray] = None,
    rerank_factor: Optional[int] = None,
    dead_rows: Optional[np.ndarray] = None,
    quant_blocks: Optional[int] = None,
    chunk: int = 128,
) -> SearchResult:
    """Two-stage quantized search on the index's device.

    Stage 1 scores the probed, live candidate set with the index's int8
    codes (:meth:`Int8Quant.device_scores`, bit-identical to the
    reference's ``Int8Quant.scores``) and keeps the best
    ``K' = k·rerank_factor`` rows per query; stage 2 gathers those rows'
    fp32 vectors and rescores them exactly, so every returned score is a
    true fp32 distance. Both selections are stable sorts (ties go to the
    lowest packed row, then the best stage-1 rank). Once K' covers the
    whole probed set the result is :func:`search_oracle`'s. L2 only.
    """
    cfg = index.cfg
    if cfg.metric != "l2":
        raise ValueError("int8 two-stage search supports metric='l2' only")
    k = k or cfg.topk
    rerank_factor = rerank_factor or cfg.rerank_factor
    quant = index.int8_quant(quant_blocks or cfg.quant_blocks)
    q = np.asarray(q, np.float32)
    if probes is None:
        probes = assign_queries(index, q, nprobe)
    nq = q.shape[0]
    kp = min(max(k, k * rerank_factor), index.nb)
    nk = min(k, kp)
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    t0 = time.perf_counter()
    dev = index.device
    q_codes = quant.encode(q)
    cluster_of = torch.as_tensor(index.cluster_of.astype(np.int64), device=dev)
    live = (None if dead_rows is None
            else ~torch.as_tensor(np.asarray(dead_rows, bool), device=dev))
    qt_all = torch.as_tensor(q).to(dev)
    survivors = 0
    for lo in range(0, nq, chunk):
        hi = min(nq, lo + chunk)
        m = hi - lo
        member = np.zeros((m, index.nlist), bool)
        if probes.shape[1]:
            member[np.arange(m)[:, None], probes[lo:hi]] = True
        mask = torch.as_tensor(member, device=dev)[:, cluster_of]   # [m, NB]
        if live is not None:
            mask &= live[None, :]
        # stage 1: quantized distances over the masked candidate set
        d8 = torch.where(mask, quant.device_scores(q_codes[lo:hi], dev), torch.inf)
        s8, part = torch.sort(d8, dim=1, stable=True)
        part = part[:, :kp]                                     # packed rows
        valid = torch.isfinite(s8[:, :kp])
        survivors += int(valid.sum())
        # stage 2: exact fp32 re-rank of the survivors
        sc, sel = rerank_exact(index, qt_all[lo:hi], part, valid, nk)
        rows = torch.gather(part, 1, sel).cpu().numpy()
        out_s[lo:hi, :nk] = sc.cpu().numpy()
        out_i[lo:hi, :nk] = index.ids[rows]
        out_i[lo:hi][out_s[lo:hi] == np.inf] = -1
    dt = time.perf_counter() - t0
    return SearchResult(
        ids=out_i,
        scores=out_s,
        stats={
            "wall_s": dt,
            "precision": "int8",
            "rerank_k": kp,
            "stage1_survivors": survivors,
        },
    )
