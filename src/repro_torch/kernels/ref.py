"""Plain PyTorch versions of the port's CUDA kernels.

They define the semantics the kernels must match, run the CPU path of
``kernels.ops``, and are what ``chip_smoke.py`` holds each kernel against
on the card. Each keeps a plain integer count of its calls
(``<function>.calls``), so a run can show that the serving path never
took them on the card.
"""

from __future__ import annotations

import torch


def partial_distance_update_ref(
    x: torch.Tensor,       # [N, Db]  candidate rows (f32 or bf16), this block
    xn2: torch.Tensor,     # [N]      per-row squared norm of this block
    q: torch.Tensor,       # [M, Db]  query rows, this dimension block
    qn2: torch.Tensor,     # [M]      per-query squared norm of this block
    acc: torch.Tensor,     # [M, N]   running partial distances; +inf = pruned
    tau: torch.Tensor,     # [M]      per-query pruning threshold
    *,
    prune: bool = True,
    metric: str = "l2",
    tile_k: int = 128,
) -> torch.Tensor:
    """acc' = acc + d_b²  (or −partial dot), then prune acc' > τ → +inf.

    In the TPU kernel's order: ``(acc + qn2) + xn2`` (L2) or ``acc``
    (IP), then once per ``tile_k``-wide chunk of the contraction
    ``out −= scale·dot_chunk`` (scale 2 for L2, 1 for IP), then the
    alive mask and the prune. +inf entries stay +inf (pruned pairs never
    resurrect). bf16 rows are widened to f32 first (exact), as the TPU
    kernel's ``x.astype(f32)``; the rest is the f32 arithmetic.
    """
    partial_distance_update_ref.calls += 1
    x = x.float()
    if metric == "l2":
        out, scale = (acc + qn2[:, None]) + xn2[None, :], 2.0
    elif metric == "ip":
        out, scale = acc, 1.0
    else:
        raise ValueError(metric)
    for k0 in range(0, x.shape[1], tile_k):
        out = out - scale * (q[:, k0:k0 + tile_k] @ x[:, k0:k0 + tile_k].T)
    out = torch.where(torch.isfinite(acc), out, torch.inf)
    if prune:
        out = torch.where(out > tau[:, None], torch.inf, out)
    return out


partial_distance_update_ref.calls = 0


def int8_partial_distance_update_ref(
    x: torch.Tensor,       # [N, Db]  int8 corpus codes, this dimension block
    xn2: torch.Tensor,     # [N]      f32, s²·Σcode² of this block
    q: torch.Tensor,       # [M, Db]  int8 query codes (same grid as corpus)
    qn2: torch.Tensor,     # [M]      f32, s²·Σcode² of this block
    scale2: torch.Tensor,  # []/[1]   f32, shared s² of this block
    acc: torch.Tensor,     # [M, N]   running partial distances; +inf = pruned
    tau: torch.Tensor,     # [M]      per-query pruning threshold
    *,
    prune: bool = True,
    tile_k: int = 128,
) -> torch.Tensor:
    """Quantized-L2 analogue of :func:`partial_distance_update_ref`, in
    the TPU kernel's order: ``(acc + qn2) + xn2``, then once per
    ``tile_k``-wide chunk of the contraction ``out −= (2·s²)·dot_chunk``,
    then the alive mask and the prune. Each chunk's dot is taken in
    float64, where every partial sum of int8 products is exact, so the
    result is bit-identical to the CUDA kernel's int32 ``__dp4a`` sums.
    """
    int8_partial_distance_update_ref.calls += 1
    alive = torch.isfinite(acc)
    out = (acc + qn2[:, None]) + xn2[None, :]
    two_s2 = 2.0 * scale2.reshape(())
    qd, xd = q.double(), x.double()
    for k0 in range(0, x.shape[1], tile_k):
        dot = (qd[:, k0:k0 + tile_k] @ xd[:, k0:k0 + tile_k].T).float()
        out = out - two_s2 * dot
    out = torch.where(alive, out, torch.inf)
    if prune:
        out = torch.where(out > tau[:, None], torch.inf, out)
    return out


int8_partial_distance_update_ref.calls = 0


def masked_topk_ref(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Ascending top-k of finite scores per row; +inf/invalid → (-1, +inf).
    Ties go to the lowest column, as ``lax.top_k`` orders them."""
    s, pos = torch.sort(scores, dim=1, stable=True)
    top_scores = s[:, :k]
    top_ids = torch.gather(ids, 1, pos[:, :k])
    top_ids = torch.where(torch.isfinite(top_scores), top_ids, -1)
    return top_scores, top_ids


def running_topk_ref(scores, ids, run_s, run_i, k: int):
    """Merge candidate (scores, ids) into the running ascending top-K.
    scores [M,C] (+inf invalid), run_s/run_i [M,K]. Returns (s', i')."""
    running_topk_ref.calls += 1
    cat_s = torch.cat([run_s, scores], dim=1)
    cat_i = torch.cat([run_i, ids.to(run_i.dtype)], dim=1)
    return masked_topk_ref(cat_s, cat_i, k)


running_topk_ref.calls = 0


def tau_prewarm_ref(table, offs, q, probes, s: int, k: int, live=None):
    """τ0 [NQ] f32: each query's k-th smallest score over the sample rows of
    its probed lists, +inf where fewer than k rows were scored. List c's
    rows are ``table[offs[c]:offs[c + 1]]`` (at most s of them). A probe < 0
    or >= nlist is skipped, a probe equal to an earlier probe of the same
    query is taken once, and the rows t of a list with ``live[t]`` (all rows
    without ``live``) are scored as Σ_d (table[t, d] − q[d])² in f32 (bf16
    rows widened first, exact): the host route of
    ``core.pruning.prewarm_tau``, in the same arithmetic."""
    tau_prewarm_ref.calls += 1
    nlist = offs.shape[0] - 1
    nq, p = probes.shape
    inf = torch.full((nq,), float("inf"), dtype=torch.float32, device=q.device)
    if nq == 0 or p * s < k or table.shape[0] == 0:
        return inf
    pr = probes.long()
    earlier = torch.ones(p, p, dtype=torch.bool, device=pr.device).tril(-1)
    repeat = ((pr[:, :, None] == pr[:, None, :]) & earlier).any(2)
    valid = (pr >= 0) & (pr < nlist) & ~repeat                    # [NQ, P]
    c = torch.where(valid, pr, 0)
    o = offs.long()
    lo = o[c]
    rows = torch.arange(s, device=pr.device)
    ok = valid[:, :, None] & (rows < (o[c + 1] - lo)[:, :, None])  # [NQ, P, s]
    t = (lo[:, :, None] + rows).clamp(max=table.shape[0] - 1)
    if live is not None:
        ok &= live[t]
    diff = table[t].float() - q[:, None, None, :]
    sc = torch.where(ok, (diff * diff).sum(3), float("inf")).reshape(nq, p * s)
    kth = torch.sort(sc, dim=1).values[:, k - 1]
    return torch.where(ok.reshape(nq, -1).sum(1) >= k, kth, inf)


tau_prewarm_ref.calls = 0
