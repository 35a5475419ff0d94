"""The work a batch of IVF-Flat queries needs, counted from the inputs.

Not what the program launches: what any implementation has to do. A
query needs its distance to every row of its probed lists (2 D FLOPs a
row); a batch needs each row of the union of its queries' lists read
once, its queries read once and its top-k (a float32 score and an
int32 row a slot) written once. The lists are the reference's and the
probes are worked out here, both in float64 from the inputs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Optional[dict]:
    """The data-sheet peaks of a card by its ``torch.cuda`` name, or None
    for a card the table does not hold."""
    table = json.loads(PEAKS.read_text())["cards"]
    return table.get(kind)


def list_sizes(of_row: torch.Tensor, nlist: int) -> torch.Tensor:
    return torch.bincount(of_row, minlength=nlist)


QUERY_BLOCK = 1 << 14


def probes(q: torch.Tensor, cent: torch.Tensor, nprobe: int) -> torch.Tensor:
    """[nq, nprobe]: each query's ``nprobe`` nearest centroids by float64
    squared L2, a block of queries at a time."""
    c64 = cent.double()
    cn = (c64 * c64).sum(1)[None, :]
    out = torch.empty((q.shape[0], nprobe), dtype=torch.long, device=q.device)
    for lo in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[lo:lo + QUERY_BLOCK].double()
        out[lo:lo + qb.shape[0]] = torch.topk(cn - 2.0 * (qb @ c64.T), nprobe, dim=1,
                                              largest=False).indices
    return out


def batch_work(probes: torch.Tensor, sizes: torch.Tensor, dim: int, k: int) -> tuple:
    """(FLOPs, bytes) of one batch whose queries probe ``probes`` [nq,
    nprobe] (of :func:`probes`), over lists of ``sizes`` [nlist] rows."""
    flops = 2.0 * dim * float(sizes[probes].sum())
    union = torch.zeros_like(sizes, dtype=torch.bool)
    union[probes.flatten()] = True
    nq = probes.shape[0]
    nbytes = 4.0 * dim * float(sizes[union].sum()) + 4.0 * dim * nq + 8.0 * k * nq
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card takes for the work: the larger of its
    FLOP time at the float32 peak and its byte time at the memory peak."""
    return max(flops / peak["fp32_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
