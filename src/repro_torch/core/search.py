"""The exact IVF oracle (single-node Faiss-like scan), in PyTorch on the
device. It is the ground truth the ring search is held against.

The host engine ``harmony_search`` and the merges of the reference come
with a later slice.
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
