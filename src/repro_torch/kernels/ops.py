"""Dispatch between the CUDA kernels and their plain versions.

A CUDA tensor goes to the kernel (which launches or raises); a CPU
tensor goes to the plain PyTorch version of :mod:`repro_torch.kernels.ref`.
Nothing else chooses the route, and nothing falls back.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import distance, distance_int8, ref, topk_update
from repro_torch.kernels import tau_prewarm as _tau_prewarm


def partial_distance_update(
    x: torch.Tensor,
    xn2: torch.Tensor,
    q: torch.Tensor,
    qn2: torch.Tensor,
    acc: torch.Tensor,
    tau: torch.Tensor,
    *,
    prune: bool = True,
    metric: str = "l2",
    tile_m: int = 128,
    tile_n: int = 128,
    tile_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """acc' = acc + partial_distance_block, pruned against τ.

    Returns (acc' [M,N] f32, tile_skip_map [m_tiles, n_tiles] int32).
    """
    if x.is_cuda:
        return distance.partial_distance_update(
            x, xn2, q, qn2, acc, tau, prune=prune, metric=metric,
            tile_m=tile_m, tile_n=tile_n, tile_k=tile_k,
        )
    out = ref.partial_distance_update_ref(
        x, xn2, q, qn2, acc, tau, prune=prune, metric=metric, tile_k=tile_k
    )
    return out, _tile_skip_map(acc, tile_m, tile_n)


def int8_partial_distance_update(
    x: torch.Tensor,
    xn2: torch.Tensor,
    q: torch.Tensor,
    qn2: torch.Tensor,
    scale2: torch.Tensor,
    acc: torch.Tensor,
    tau: torch.Tensor,
    *,
    prune: bool = True,
    tile_m: int = 128,
    tile_n: int = 128,
    tile_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized stage-1 scoring: acc' = acc + s²·‖Q−P‖²_b, pruned vs τ.

    ``x``/``q`` are int8 codes on a shared per-dimension-block grid;
    ``xn2``/``qn2`` carry the pre-scaled s²·Σcode² norms (f32). L2 only.
    Returns (acc' [M,N] f32, tile_skip_map [m_tiles, n_tiles] int32).
    """
    if x.is_cuda:
        return distance_int8.int8_partial_distance_update(
            x, xn2, q, qn2, scale2, acc, tau, prune=prune,
            tile_m=tile_m, tile_n=tile_n, tile_k=tile_k,
        )
    out = ref.int8_partial_distance_update_ref(
        x, xn2, q, qn2, scale2, acc, tau, prune=prune, tile_k=tile_k
    )
    return out, _tile_skip_map(acc, tile_m, tile_n)


def _tile_skip_map(acc: torch.Tensor, tile_m: int, tile_n: int) -> torch.Tensor:
    """Which [tile_m, tile_n] tiles were fully pruned on entry (post-hoc)."""
    m, n = acc.shape
    mp, np_ = -(-m // tile_m) * tile_m, -(-n // tile_n) * tile_n
    a = F.pad(acc, (0, np_ - n, 0, mp - m), value=float("inf"))
    a = a.reshape(mp // tile_m, tile_m, np_ // tile_n, tile_n)
    alive = torch.isfinite(a).any(dim=3).any(dim=1)
    return (~alive).to(torch.int32)


def running_topk_update(
    scores: torch.Tensor,      # [M, C] f32, +inf = invalid
    ids: torch.Tensor,         # [M, C] i32
    run_s: torch.Tensor,       # [M, K] f32 ascending
    run_i: torch.Tensor,       # [M, K] i32
    *,
    k: int,
    tile_m: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a candidate chunk into the per-query running top-K."""
    if scores.is_cuda:
        return topk_update.running_topk_update(
            scores, ids, run_s, run_i, k=k, tile_m=tile_m
        )
    return ref.running_topk_ref(scores, ids, run_s, run_i, k=k)


def masked_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Ascending top-k of finite entries, id −1 at +inf (the plain
    version on any device, as the reference backs it with its oracle)."""
    return ref.masked_topk_ref(scores, ids, k)


def tau_prewarm(
    table: torch.Tensor,       # [T, D] f32 or bf16
    offs: torch.Tensor,        # [nlist + 1] i32
    q: torch.Tensor,           # [NQ, D] f32
    probes: torch.Tensor,      # [NQ, P] i32
    s: int,
    k: int,
    live: Optional[torch.Tensor] = None,     # [T] bool
) -> torch.Tensor:
    """τ0 [NQ] f32: the k-th smallest Σ(x − q)² over each query's live
    sample rows of its distinct probed lists (+inf below k of them)."""
    if table.is_cuda:
        return _tau_prewarm.tau_prewarm(table, offs, q, probes, s, k, live)
    _tau_prewarm.check(table, offs, q, probes, s, k, live)
    return ref.tau_prewarm_ref(table, offs, q, probes, s, k, live)


def launch_counts() -> Dict[str, int]:
    """Kernel launches and plain-version calls since the last reset. A
    kernel's count takes every launch; ``partial_distance_update_bf16``,
    ``running_topk_update_large_k`` and ``running_topk_update_huge_k`` count
    again those of its bf16-row route, its route 2 (256 < K <= 12288) and
    its route 3 (K > 12288)."""
    return {
        "partial_distance_update": distance.partial_distance_update.launches,
        "int8_partial_distance_update":
            distance_int8.int8_partial_distance_update.launches,
        "running_topk_update": topk_update.running_topk_update.launches,
        "partial_distance_update_bf16":
            distance.partial_distance_update.bf16_launches,
        "running_topk_update_large_k":
            topk_update.running_topk_update.large_k_launches,
        "running_topk_update_huge_k":
            topk_update.running_topk_update.huge_k_launches,
        "tau_prewarm": _tau_prewarm.tau_prewarm.launches,
        "partial_distance_update_ref": ref.partial_distance_update_ref.calls,
        "int8_partial_distance_update_ref":
            ref.int8_partial_distance_update_ref.calls,
        "running_topk_ref": ref.running_topk_ref.calls,
        "tau_prewarm_ref": ref.tau_prewarm_ref.calls,
    }


def reset_launch_counts() -> None:
    distance.partial_distance_update.launches = 0
    distance_int8.int8_partial_distance_update.launches = 0
    topk_update.running_topk_update.launches = 0
    distance.partial_distance_update.bf16_launches = 0
    topk_update.running_topk_update.large_k_launches = 0
    topk_update.running_topk_update.huge_k_launches = 0
    ref.partial_distance_update_ref.calls = 0
    ref.int8_partial_distance_update_ref.calls = 0
    ref.running_topk_ref.calls = 0
    _tau_prewarm.tau_prewarm.launches = 0
    ref.tau_prewarm_ref.calls = 0
