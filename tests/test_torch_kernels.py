"""The port's kernel layer against the JAX package.

On the CPU the plain PyTorch versions (``repro_torch.kernels.ref``) are
held against the reference's jnp oracles and its Pallas kernels in
interpret mode, over the sweeps of ``tests/kernels/``. The CUDA kernels
themselves run only on the card: the ``cuda`` case holds each against its
plain version there and skips elsewhere.

Tolerances are the reference's fp32 rule: finite entries agree at
rtol = atol = 1e-4; the +inf pattern matches except where the value is
within 1e-4·(1 + |τ|) of τ (the two sides group the sum differently);
skip maps are equal; top-K ids are equal except across exact score ties.
The int8 kernel's plain version keeps the TPU kernel's order of f32
operations, so against Pallas interpret mode it is held at rtol = 1e-6,
atol = 1e-5, and against the reference's jnp oracle (which groups the sum
differently) at rtol = 1e-5, atol = 1e-4; on the card the kernel equals
its plain version bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.distance import partial_distance_update as pallas_distance
from repro.kernels.distance_int8 import int8_partial_distance_update as pallas_int8
from repro.kernels.ops import _tile_skip_map as r_skip_map
from repro.kernels.topk_update import running_topk_update as pallas_topk
from repro_torch.kernels import distance, distance_int8, ops, ref, topk_update

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4


def _mk(m, n, d, seed=0, frac_pruned=0.3, dead_tile=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    xn2 = (x ** 2).sum(1)
    qn2 = (q ** 2).sum(1)
    acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
    acc[rng.random((m, n)) < frac_pruned] = np.inf
    if dead_tile is not None:
        acc[:, dead_tile] = np.inf
    tau = rng.uniform(d * 0.5, d * 3.0, size=(m,)).astype(np.float32)
    return x, xn2, q, qn2, acc, tau


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_distance_close(got, want, tau, rtol=TOL, atol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    tau = np.asarray(tau)[:, None]
    boundary = np.abs(np.where(np.isfinite(want), want, tau) - tau) <= TOL * (
        1 + np.abs(tau))
    mismatch_inf = np.isfinite(got) != np.isfinite(want)
    assert not (mismatch_inf & ~boundary).any(), "inf pattern diverges beyond fp ties"
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=rtol, atol=atol)


def _mk_int8(m, n, d, seed=0, frac_pruned=0.3, dead_tile=None, extreme=False,
             tight=None):
    """int8 codes on one shared grid (s² = 0.01), their pre-scaled norms,
    an accumulator with +inf holes and τ around the median distance.
    ``extreme`` puts codes at ±127; ``tight`` (a row) gets τ = 0.5."""
    rng = np.random.default_rng(seed)
    lo, hi = (-127, 128) if not extreme else (-127, -126)
    x = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.integers(lo, hi, (m, d)).astype(np.int8)
    if extreme:
        x[::2] = 127
    s2 = np.float32(0.01)
    xn2 = (s2 * (x.astype(np.int64) ** 2).sum(1)).astype(np.float32)
    qn2 = (s2 * (q.astype(np.int64) ** 2).sum(1)).astype(np.float32)
    acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
    acc[rng.random((m, n)) < frac_pruned] = np.inf
    if dead_tile is not None:
        acc[:, dead_tile] = np.inf
    typical = float(s2) * 2 * 5376 * d
    tau = (rng.uniform(0.8, 1.1, size=(m,)) * typical).astype(np.float32)
    if tight is not None:
        tau[tight] = 0.5
    return x, xn2, q, qn2, s2, acc, tau


def assert_topk_close(gs, gi, ws, wi):
    gs, gi, ws, wi = map(np.asarray, (gs, gi, ws, wi))
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    diff = gi != wi
    if diff.any():
        r, c = np.nonzero(diff)
        assert np.allclose(gs[r, c], ws[r, c]), "id mismatch beyond ties"


SHAPES = [
    (8, 16, 32),      # all smaller than tiles
    (128, 128, 128),  # exact tile multiples
    (130, 257, 96),   # ragged everything
    (1, 300, 64),     # single query
    (64, 1, 128),     # single candidate
    (64, 256, 64),    # the ring's shape at B = 2
]


@pytest.mark.parametrize("m,n,d", SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("prune", [True, False])
def test_distance_plain_matches_reference_and_pallas(m, n, d, metric, prune):
    arrs = _mk(m, n, d, seed=m * 31 + n, dead_tile=slice(0, 64))
    tau = arrs[5]
    got, skip = ops.partial_distance_update(
        *_t(*arrs), prune=prune, metric=metric, tile_m=64, tile_n=64, tile_k=64)
    want = r_ref.partial_distance_update_ref(
        *map(jnp.asarray, arrs), prune=prune, metric=metric)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_distance_close(got.numpy(), want, tau)
    p_out, p_skip = pallas_distance(
        *map(jnp.asarray, arrs), prune=prune, metric=metric, interpret=True,
        tile_m=64, tile_n=64, tile_k=64)
    assert_distance_close(got.numpy(), p_out, tau)
    assert skip.dtype == torch.int32
    np.testing.assert_array_equal(skip.numpy(), np.asarray(p_skip))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("tile_k", [32, 64])
def test_distance_plain_folds_per_tile_k_chunk_like_pallas(metric, tile_k):
    """Db = 96 in chunks of 32 (three) or 64 (two, the second ragged): the
    plain version subtracts scale·dot once per chunk, as the TPU kernel
    does, and meets Pallas interpret mode at the fp32 rule."""
    arrs = _mk(130, 257, 96, seed=5, dead_tile=slice(0, 64))
    got, skip = ops.partial_distance_update(
        *_t(*arrs), metric=metric, tile_m=64, tile_n=64, tile_k=tile_k)
    p_out, p_skip = pallas_distance(
        *map(jnp.asarray, arrs), metric=metric, interpret=True,
        tile_m=64, tile_n=64, tile_k=tile_k)
    assert_distance_close(got.numpy(), p_out, arrs[5])
    np.testing.assert_array_equal(skip.numpy(), np.asarray(p_skip))
    x, xn2, q, qn2, acc, tau = _t(*arrs)
    out = (acc + qn2[:, None]) + xn2[None, :] if metric == "l2" else acc
    for k0 in range(0, 96, tile_k):
        dot = q[:, k0:k0 + tile_k] @ x[:, k0:k0 + tile_k].T
        out = out - (2.0 if metric == "l2" else 1.0) * dot
    out = torch.where(torch.isfinite(acc), out, torch.inf)
    out = torch.where(out > tau[:, None], torch.inf, out)
    assert torch.equal(got, out)


@pytest.mark.parametrize("m,n,tm,tn", [(8, 16, 128, 128), (130, 257, 64, 32),
                                       (64, 256, 128, 128), (5, 300, 4, 100)])
def test_tile_skip_map_matches_reference(m, n, tm, tn):
    rng = np.random.default_rng(m + n)
    acc = rng.uniform(size=(m, n)).astype(np.float32)
    acc[rng.random((m, n)) < 0.97] = np.inf
    acc[:, : min(n, tn)] = np.inf
    got = ops._tile_skip_map(torch.from_numpy(acc), tm, tn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_skip_map(jnp.asarray(acc), tm, tn)))


def test_skip_map_marks_dead_tiles():
    m, n, d, t = 64, 128, 32, 32
    x, xn2, q, qn2, acc, tau = _mk(m, n, d, frac_pruned=0.0)
    acc[:, :t] = np.inf
    got, skip = ops.partial_distance_update(*_t(x, xn2, q, qn2, acc, tau + 1e9),
                                            tile_m=t, tile_n=t, tile_k=t)
    skip = skip.numpy()
    assert skip.shape == (m // t, n // t)
    assert (skip[:, 0] == 1).all() and (skip[:, 1:] == 0).all()
    assert (~torch.isfinite(got[:, :t])).all()


def test_inf_never_resurrects_and_prune_false_keeps_finite():
    x, xn2, q, qn2, acc, tau = _mk(32, 48, 64, frac_pruned=0.5)
    got, _ = ops.partial_distance_update(*_t(x, xn2, q, qn2, acc, tau + 1e9))
    assert (~torch.isfinite(got))[torch.from_numpy(~np.isfinite(acc))].all()
    x, xn2, q, qn2, acc, tau = _mk(32, 48, 64, frac_pruned=0.0)
    got, _ = ops.partial_distance_update(*_t(x, xn2, q, qn2, acc, tau * 0),
                                         prune=False)
    assert torch.isfinite(got).all()


def test_accumulation_reconstructs_exact_distance():
    rng = np.random.default_rng(0)
    m, n, d, B = 16, 40, 96, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    acc = torch.zeros((m, n))
    tau = torch.full((m,), torch.inf)
    per = d // B
    for b in range(B):
        xb = np.ascontiguousarray(x[:, b * per:(b + 1) * per])
        qb = np.ascontiguousarray(q[:, b * per:(b + 1) * per])
        acc, _ = ops.partial_distance_update(
            *_t(xb, (xb ** 2).sum(1), qb, (qb ** 2).sum(1)), acc, tau)
    want = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(acc.numpy(), want, rtol=2e-4, atol=2e-4)


INT8_CASES = [
    # (m, n, d, tile_m, tile_n, tile_k, extreme, dead tile, tight row)
    (16, 48, 24, 8, 16, 8, False, None, 5),          # the reference's case
    (8, 16, 32, 8, 16, 32, True, slice(0, 16), None),  # ±127, all dead
    (130, 257, 96, 128, 128, 32, False, slice(0, 128), 3),  # ragged, 3 chunks
    (5, 300, 30, 8, 16, 16, True, slice(16, 48), 0),  # ragged Db, 2 chunks
    (128, 256, 128, 128, 128, 128, False, slice(128, 256), 7),  # 1x1 ring
    (64, 256, 64, 32, 64, 128, False, None, None),    # 2x2 ring, small tiles
]


@pytest.mark.parametrize("m,n,d,tm,tn,tk,extreme,dead,tight", INT8_CASES)
@pytest.mark.parametrize("prune", [True, False])
def test_int8_plain_matches_pallas_and_reference(m, n, d, tm, tn, tk, extreme,
                                                 dead, tight, prune):
    x, xn2, q, qn2, s2, acc, tau = _mk_int8(m, n, d, seed=m * 7 + n,
                                            dead_tile=dead, extreme=extreme,
                                            tight=tight)
    got, skip = ops.int8_partial_distance_update(
        *_t(x, xn2, q, qn2), torch.tensor(s2), *_t(acc, tau), prune=prune,
        tile_m=tm, tile_n=tn, tile_k=tk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert skip.dtype == torch.int32
    jx = [jnp.asarray(a) for a in (x, xn2, q, qn2, s2, acc, tau)]
    p_out, p_skip = pallas_int8(*jx, prune=prune, tile_m=tm, tile_n=tn,
                                tile_k=tk, interpret=True)
    assert_distance_close(got.numpy(), p_out, tau, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(p_skip))
    want = r_ref.int8_partial_distance_update_ref(*jx, prune=prune)
    assert_distance_close(got.numpy(), want, tau, rtol=1e-5, atol=1e-4)
    if dead is not None:
        assert not torch.isfinite(got[:, dead]).any()
    if tight is not None and prune:
        assert not torch.isfinite(got[tight]).any()


def test_int8_chunked_fold_is_the_tpu_kernels_order():
    """One subtract per tile_k chunk: the plain version equals an explicit
    numpy replay of the TPU kernel's f32 operations bit for bit."""
    x, xn2, q, qn2, s2, acc, tau = _mk_int8(9, 40, 70, seed=4)
    got = ref.int8_partial_distance_update_ref(
        *_t(x, xn2, q, qn2), torch.tensor(s2), *_t(acc, tau), tile_k=32)
    out = (acc + qn2[:, None]) + xn2[None, :]
    two_s2 = np.float32(2.0) * s2
    for k0 in range(0, 70, 32):
        dot = q[:, k0:k0 + 32].astype(np.int32) @ x[:, k0:k0 + 32].astype(np.int32).T
        out = out - two_s2 * dot.astype(np.float32)
    out = np.where(np.isfinite(acc), out, np.inf)
    out = np.where(out > tau[:, None], np.inf, out)
    assert got.numpy().tobytes() == out.astype(np.float32).tobytes()


def test_int8_accumulation_reconstructs_quantized_distance():
    """Summed over the ring's blocks, each with its own s², the updates
    give Σ_b s_b²·‖Q_b − P_b‖²."""
    rng = np.random.default_rng(1)
    m, n, B, per = 12, 33, 4, 8
    x = rng.integers(-127, 128, (n, B * per)).astype(np.int8)
    q = rng.integers(-127, 128, (m, B * per)).astype(np.int8)
    s2 = rng.uniform(1e-4, 1e-3, B).astype(np.float32)
    acc = torch.zeros((m, n))
    tau = torch.full((m,), torch.inf)
    want = np.zeros((m, n))
    for b in range(B):
        xb = np.ascontiguousarray(x[:, b * per:(b + 1) * per])
        qb = np.ascontiguousarray(q[:, b * per:(b + 1) * per])
        xn2 = (s2[b] * (xb.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        qn2 = (s2[b] * (qb.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        acc, _ = ops.int8_partial_distance_update(
            *_t(xb, xn2, qb, qn2), torch.tensor(s2[b]), acc, tau)
        diff = qb[:, None, :].astype(np.int64) - xb[None, :, :]
        want += float(s2[b]) * (diff ** 2).sum(-1)
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-5, atol=1e-4)


def _mk_topk(m, c, k, seed=0, frac_invalid=0.2, run_filled=True, ties=False,
             kind="uniform"):
    """Candidates and a running list. ``kind`` shapes the candidates after
    what the CUDA kernel branches on: ``uniform``; ``path``, the ring's
    chunks, where most rows are all +inf and the rest hold one to three
    candidates below run_s[K-1] beside entries equal to it; ``run_last``,
    candidates copied from the row's run entries, its last one included;
    ``finite_chunk``, no +inf candidate, under a run that is +inf from K/2
    on (``run_filled``) or all +inf (not ``run_filled``)."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
    if ties:
        scores = np.round(scores / 10).astype(np.float32)   # many exact ties
    if kind != "finite_chunk":
        scores[rng.random((m, c)) < frac_invalid] = np.inf
    ids = rng.integers(0, 10_000, size=(m, c)).astype(np.int32)
    if run_filled:
        run_s = np.sort(rng.uniform(0, 100, size=(m, k)).astype(np.float32), axis=1)
        if ties:
            run_s = np.sort(np.round(run_s / 10).astype(np.float32), axis=1)
        run_i = rng.integers(10_000, 20_000, size=(m, k)).astype(np.int32)
    else:
        run_s = np.full((m, k), np.inf, np.float32)
        run_i = np.full((m, k), -1, np.int32)
    if kind == "path":
        last = run_s[:, -1:]
        live = (rng.random((m, 1)) < 0.25) & (rng.random((m, c)) < 3 / c)
        scores = np.where(live, scores * 0.01 * np.where(np.isfinite(last), last, 1.0),
                          np.inf).astype(np.float32)
        scores[:, ::5] = np.where(rng.random((m, 1)) < 0.25, last, scores[:, ::5])
    elif kind == "run_last":
        scores = np.where(np.isfinite(scores), np.take_along_axis(
            run_s, rng.integers(0, k, size=(m, c)), axis=1), np.inf)
        scores[:, ::3] = run_s[:, -1:]
    elif kind == "finite_chunk" and run_filled:
        run_s[:, k // 2:] = np.inf
        run_i[:, k // 2:] = -1
    return scores.astype(np.float32), ids, run_s, run_i


# (m, c, k, kind): the uniform sweep, then the kernel's branches (rows
# without a survivor, candidates equal to run entries, an empty or
# half-empty run under an all-finite chunk) and C == K, the shape of
# merge_topk(fused=True)
TOPK_CASES = [(1, 8, 4, "uniform"), (8, 64, 10, "uniform"), (13, 100, 5, "uniform"),
              (4, 16, 16, "uniform"), (64, 256, 10, "uniform"), (4, 256, 40, "uniform"),
              (16, 256, 10, "path"), (8, 64, 40, "run_last"), (4, 256, 40, "finite_chunk"),
              (8, 64, 10, "finite_chunk"), (10, 10, 10, "uniform"), (4, 40, 40, "uniform"),
              # K above 64: the int8 ring at k = 20 (K' = 80) and the limit, 256
              (4, 96, 80, "uniform"), (2, 256, 256, "uniform"), (2, 256, 256, "finite_chunk"),
              # K above 256, the CUDA kernel's second route: the int8 ring at
              # k = 65 (K' = 260 > 257), and K = 512
              (4, 300, 257, "uniform"), (2, 64, 512, "uniform")]


@pytest.mark.parametrize("m,c,k,kind", [
    pytest.param(*case, id="-".join(map(str, case[:3] if case[3] == "uniform" else case)))
    for case in TOPK_CASES])
@pytest.mark.parametrize("run_filled", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_plain_matches_reference_and_pallas(m, c, k, kind, run_filled, ties):
    arrs = _mk_topk(m, c, k, seed=m * c + k, run_filled=run_filled, ties=ties, kind=kind)
    gs, gi = ops.running_topk_update(*_t(*arrs), k=k)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    ws, wi = r_ref.running_topk_ref(*map(jnp.asarray, arrs), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the stable sort orders ties as lax.top_k does: ids equal exactly
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    ps, pi = pallas_topk(*map(jnp.asarray, arrs), k=k, tile_m=4, interpret=True)
    pi = np.where(np.isfinite(np.asarray(ps)), np.asarray(pi), -1)
    assert_topk_close(gs.numpy(), gi.numpy(), ps, pi)


def test_topk_all_invalid_chunk_keeps_running():
    scores = torch.full((3, 10), torch.inf)
    ids = torch.full((3, 10), -1, dtype=torch.int32)
    run_s = torch.from_numpy(np.sort(np.random.default_rng(0).uniform(0, 1, (3, 5)),
                                     axis=1).astype(np.float32))
    run_i = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    got_s, got_i = ops.running_topk_update(scores, ids, run_s, run_i, k=5)
    assert torch.equal(got_s, run_s) and torch.equal(got_i, run_i)


def test_topk_broadcast_ids_row():
    """The ring passes one chunk's ids to every row as an expanded view."""
    s, ids, rs, ri = _mk_topk(6, 32, 4, seed=9)
    row = torch.from_numpy(ids[0])
    a = ops.running_topk_update(*_t(s), row.expand(6, 32), *_t(rs, ri), k=4)
    b = ops.running_topk_update(*_t(s, np.broadcast_to(ids[0], (6, 32)), rs, ri), k=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_masked_topk_matches_reference():
    rng = np.random.default_rng(3)
    s = rng.uniform(size=(5, 30)).astype(np.float32)
    s[rng.random((5, 30)) < 0.8] = np.inf
    ids = rng.integers(0, 99, size=(5, 30)).astype(np.int32)
    gs, gi = ref.masked_topk_ref(*_t(s, ids), 7)
    ws, wi = r_ref.masked_topk_ref(jnp.asarray(s), jnp.asarray(ids), 7)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_ops_on_cpu_use_plain_versions_only():
    ops.reset_launch_counts()
    arrs = _mk(8, 16, 32)
    ops.partial_distance_update(*_t(*arrs))
    ops.running_topk_update(*_t(*_mk_topk(8, 16, 4)), k=4)
    x8, xn2, q8, qn2, s2, acc, tau = _mk_int8(8, 16, 32)
    ops.int8_partial_distance_update(*_t(x8, xn2, q8, qn2), torch.tensor(s2),
                                     *_t(acc, tau))
    counts = ops.launch_counts()
    assert counts == {"partial_distance_update": 0,
                      "int8_partial_distance_update": 0,
                      "running_topk_update": 0,
                      "partial_distance_update_bf16": 0,
                      "running_topk_update_large_k": 0,
                      "running_topk_update_huge_k": 0,
                      "tau_prewarm": 0,
                      "partial_distance_update_ref": 1,
                      "int8_partial_distance_update_ref": 1,
                      "running_topk_ref": 1,
                      "tau_prewarm_ref": 0}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA tensors or raise; they never compute on
    the CPU themselves (and raise before any build is attempted)."""
    with pytest.raises(ValueError, match="CUDA"):
        distance.partial_distance_update(*_t(*_mk(4, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        topk_update.running_topk_update(*_t(*_mk_topk(4, 8, 3)), k=3)
    k = topk_update.MAX_K + 1          # route 3 takes it: the device check refuses
    with pytest.raises(ValueError, match="CUDA"):
        topk_update.running_topk_update(*_t(*_mk_topk(4, 8, k)), k=k)
    with pytest.raises(ValueError, match="k=0"):
        topk_update.running_topk_update(*_t(*_mk_topk(4, 8, 0)), k=0)
    x, xn2, q, qn2, s2, acc, tau = _mk_int8(4, 8, 16)
    args = (*_t(x, xn2, q, qn2), torch.tensor(s2), *_t(acc, tau))
    with pytest.raises(ValueError, match="CUDA"):
        distance_int8.int8_partial_distance_update(*args)
    for tile_k in (0, 1025):
        with pytest.raises(ValueError, match="tile_k"):
            distance_int8.int8_partial_distance_update(*args, tile_k=tile_k)


def test_topk_limits_raise_before_any_launch():
    """The top-K kernel takes any C and any K up to its int index,
    2^31 - 1: route 1 up to K = WARP_MAX_K (64, where route 2 starts to
    win), route 2 up to MAX_K = 12288 (what its shared memory holds:
    16 K + 16 W bytes with a 1024-column window, 208 KB of the H100's
    227 KB), route 3 above it (the list in global memory).
    K < 1, and K or C past the int index, raise ``ValueError`` before any
    launch, on every device, with no switch to the plain version; the
    executor (its ring's K, k·rerank_factor in the int8 tier) and the fused
    merge check that first. Above MAX_K both serve."""
    from repro_torch.config import HarmonyConfig
    from repro_torch.core import build_ivf, merge_topk
    from repro_torch.serve import ExecutorConfig, SpmdExecutor

    big = 2 ** 31 - 1
    assert (topk_update.MAX_K, topk_update.MAX_C, topk_update.MAX_INDEX) == (12288, big, big)
    assert topk_update.plan(1, 4096, topk_update.MAX_K).smem_bytes == 16 * 12288 + 16 * 1024
    assert topk_update.plan(1, 4096, topk_update.MAX_K).smem_bytes <= 232_448 - 1024
    assert topk_update.WARP_MAX_K == 64
    assert [topk_update.route(k) for k in (1, 64, 65, 256, 257, 12288, 12289, big)] == \
        [1, 1, 2, 2, 2, 2, 3, 3]
    topk_update.check_limits(12289, 8)
    topk_update.check_limits(big, big)
    for k, c in ((0, 8), (big + 1, 8), (10, 0), (10, big + 1)):
        with pytest.raises(ValueError, match=str(big) if c == 8 else "C="):
            topk_update.check_limits(k, c)
    with pytest.raises(ValueError, match="CUDA"):     # C past 4096 is taken
        topk_update.running_topk_update(*_t(*_mk_topk(2, 4097, 8)), k=8)
    with pytest.raises(ValueError, match="CUDA"):     # and K past 12288
        topk_update.running_topk_update(*_t(*_mk_topk(2, 8, 12289)), k=12289)
    x = np.random.default_rng(0).normal(size=(600, 8)).astype(np.float32)
    cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=5, kmeans_iters=2)
    index = build_ivf(x, cfg, device="cpu")
    ops.reset_launch_counts()
    int8 = SpmdExecutor(index, ExecutorConfig(precision="int8"), device="cpu")
    assert int8.search_batch(x[:2], k=65).stats["rerank_k"] == 260
    assert int8.search_batch(x[:2], k=150).stats["rerank_k"] == 600    # K' = nb
    fp32 = SpmdExecutor(index, device="cpu")
    assert fp32.search_batch(x[:2], k=257).ids.shape == (2, 257)
    huge = fp32.search_batch(x[:2], k=12289)       # more than the 600 rows
    assert huge.ids.shape == (2, 12289)
    assert ((huge.ids >= 0).sum(1) <= 600).all() and (huge.ids[:, 600:] == -1).all()
    merged = merge_topk([(np.zeros((2, 8), np.float32), np.arange(16).reshape(2, 8))],
                        12289, fused=True, device="cpu")
    assert merged[1].shape == (2, 12289) and (merged[1][:, 8:] == -1).all()
    calls = ops.launch_counts()["running_topk_ref"]
    with pytest.raises(ValueError, match=str(big)):
        fp32.search_batch(x[:2], k=big + 1)
    with pytest.raises(ValueError, match=str(big)):
        fp32.warmup(k=big + 1)
    with pytest.raises(ValueError, match=str(big)):
        merge_topk([(np.zeros((2, 8), np.float32), np.zeros((2, 8), np.int64))],
                   big + 1, fused=True, device="cpu")
    assert ops.launch_counts()["running_topk_ref"] == calls


@pytest.mark.cuda
def test_cuda_topk_above_64_and_merge_shapes():
    """K = 80 and 256 (route 2 since the boundary moved to 64; route 1 held
    them with four and eight list entries a lane), the served merge's shape
    (C = K = k) and K at the boundary, bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cases = [(130, c, k) for k in (80, 256) for c in (80, 256, 4096)]
    cases += [(m, k, k) for m in (1, 128, 160) for k in (10, 20)]
    cut = topk_update.WARP_MAX_K         # the route 1/2 boundary, route 1's side
    cases += [(128, 256, cut), (128, cut, cut)]
    for m, c, k in cases:
        for kind in ("uniform", "path", "run_last", "finite_chunk"):
            for run_filled in (True, False):
                s, ids, rs, ri = (a.to(dev) for a in _t(*_mk_topk(
                    m, c, k, seed=m + c + k, kind=kind, run_filled=run_filled,
                    ties=kind == "uniform")))
                for ids_form in (ids, ids[0].expand(m, c)):
                    gs, gi = topk_update.running_topk_update(s, ids_form, rs, ri, k=k)
                    ws, wi = ref.running_topk_ref(s, ids_form, rs, ri, k=k)
                    assert torch.equal(gs, ws) and torch.equal(gi, wi), (m, c, k, kind)


def _cuda_topk_equal(cases, kinds, dev):
    """Each (m, c, k) at each input kind of ``test_torch_topk_plan._mk``,
    with full and broadcast ids, bit-equal to the plain version."""
    from test_torch_topk_plan import _mk as _mk_branch

    for m, c, k in cases:
        for kind in kinds:
            s, ids, rs, ri = (a.to(dev) for a in _t(*_mk_branch(m, c, k, kind, seed=m + c + k)))
            for ids_form in (ids, ids[0].expand(m, c)):
                gs, gi = topk_update.running_topk_update(s, ids_form, rs, ri, k=k)
                ws, wi = ref.running_topk_ref(s, ids_form, rs, ri, k=k)
                assert torch.equal(gs, ws) and torch.equal(gi, wi), (m, c, k, kind)


@pytest.mark.cuda
def test_cuda_huge_k_route():
    """The top-K kernel's route 3 (K > 12288: tiles of output positions a
    CTA; above 2048 columns, window runs merged in passes through a
    scratch) bit-equal to the plain version, with full and broadcast ids;
    also ascending candidates (the merge's), survivors at and one above the
    one-warp cut, and rows with no survivor beside full ones, at the
    merge's C = K for M = 1, 8, 128, past one merge pass and past one
    chunk of columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    for k in (12289, 16384, 20000):
        for c in (256, 4096, 12289):
            for kind in ("uniform", "path", "run_last", "finite_chunk"):
                for run_filled in (True, False):
                    s, ids, rs, ri = (a.to(dev) for a in _t(*_mk_topk(
                        3, c, k, seed=c + k, kind=kind, run_filled=run_filled,
                        ties=kind == "uniform")))
                    for ids_form in (ids, ids[0].expand(3, c)):
                        gs, gi = topk_update.running_topk_update(s, ids_form, rs, ri, k=k)
                        ws, wi = ref.running_topk_ref(s, ids_form, rs, ri, k=k)
                        assert torch.equal(gs, ws) and torch.equal(gi, wi), (c, k, kind)
    _cuda_topk_equal([(m, c, c) for m in (1, 8, 128) for c in (12289, 16384)]
                     + [(3, 256, 12289), (3, 4096, 20000)],
                     ("ascending", "few", "mixed"), dev)
    # two and three merge passes (3 and 5 windows of 8192 columns), and two
    # chunks of 2^18 columns (the second through the scratch list)
    _cuda_topk_equal([(8, 20000, 20000), (3, 40000, 12289), (1, 300_000, 12289)],
                     ("ascending", "few", "mixed"), dev)
    counts = ops.launch_counts()
    assert counts["running_topk_update_huge_k"] == counts["running_topk_update"] > 0


@pytest.mark.cuda
def test_cuda_large_k_route_and_bf16_rows():
    """The top-K kernel's route 2 (K above ``WARP_MAX_K``: one CTA a row,
    the list in shared memory, C in windows of up to 2048) bit-equal to the
    plain version, up to its limit, also on ascending candidates, survivors
    at and one above the one-warp cut, rows with no survivor beside full
    ones, the merge's C = K at M = 1, 8, 128 and K one above the boundary;
    and the distance kernel's bf16-row route against its plain version at
    the f32 route's rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    cases = [(130, c, k) for k in (257, 320, 1024, 4096) for c in (256, 4096, 8192)]
    cases += [(1, 300, 300), (128, 300, 300), (2, 100, topk_update.MAX_K)]
    for m, c, k in cases:
        for kind in ("uniform", "path", "run_last", "finite_chunk"):
            for run_filled in (True, False):
                s, ids, rs, ri = (a.to(dev) for a in _t(*_mk_topk(
                    m, c, k, seed=m + c + k, kind=kind, run_filled=run_filled,
                    ties=kind == "uniform")))
                for ids_form in (ids, ids[0].expand(m, c)):
                    gs, gi = topk_update.running_topk_update(s, ids_form, rs, ri, k=k)
                    ws, wi = ref.running_topk_ref(s, ids_form, rs, ri, k=k)
                    assert torch.equal(gs, ws) and torch.equal(gi, wi), (m, c, k, kind)
    cut = topk_update.WARP_MAX_K
    _cuda_topk_equal([(m, c, c) for m in (1, 8, 128) for c in (300, 4096)]
                     + [(128, 256, cut + 1), (128, cut + 1, cut + 1), (130, 8192, 4096)],
                     ("ascending", "few", "mixed"), dev)
    assert ops.launch_counts()["running_topk_update_large_k"] == \
        ops.launch_counts()["running_topk_update"] > 0
    for m, n, d, tm, tn, tk in [(128, 256, 128, 128, 128, 128), (64, 256, 64, 128, 128, 128),
                                (130, 257, 96, 32, 64, 32), (64, 256, 30, 4, 100, 128)]:
        for metric in ("l2", "ip"):
            x, xn2, q, qn2, acc, tau = _mk(m, n, d, seed=m + d, dead_tile=slice(128, 256))
            xb = torch.from_numpy(x).to(torch.bfloat16)
            xn2 = (xb.float() ** 2).sum(1)
            arrs = [a.to(dev) for a in (xb, xn2, *_t(q, qn2, acc, tau))]
            got, skip = distance.partial_distance_update(
                *arrs, metric=metric, tile_m=tm, tile_n=tn, tile_k=tk)
            want = ref.partial_distance_update_ref(*arrs, metric=metric, tile_k=tk)
            assert_distance_close(got.cpu().numpy(), want.cpu().numpy(),
                                  arrs[5].cpu().numpy())
            assert torch.equal(skip, ops._tile_skip_map(arrs[4], tm, tn))
    assert ops.launch_counts()["partial_distance_update_bf16"] == 8


def test_kernel_modules_import_without_building():
    code = (
        "import repro_torch.kernels.distance, repro_torch.kernels.topk_update\n"
        "import repro_torch.kernels.distance_int8\n"
        "import repro_torch.kernels.ops, repro_torch.serve\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs and not _build.build_log\n"
        "print('LAZY_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="",
               CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LAZY_OK" in proc.stdout


def _one_subtile_alive(acc):
    """acc [128, 384] on 128 x 128 tiles: tile 0 alive only at (100, 90),
    in sub-tile (6, 2) of the kernels' 16 x 32 grid; tile 1 only at
    (3, 130), in its sub-tile (0, 0); tile 2 dead. Skip map [[0, 0, 1]]."""
    acc[:] = np.inf
    acc[100, 90] = 1.0
    acc[3, 130] = 2.0
    return acc


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    # (m, n, d, tile_m, tile_n, tile_k): the ring's shapes, tiles that are
    # not multiples of the 16 x 32 sub-tile, chunked and unaligned Db
    fp32_cases = [(4, 256, 32, 128, 128, 128), (64, 256, 64, 128, 128, 128),
                  (128, 256, 128, 128, 128, 128), (130, 257, 96, 128, 128, 128),
                  (130, 257, 96, 32, 64, 32), (130, 257, 96, 4, 100, 64),
                  (64, 256, 30, 4, 100, 128)]
    for m, n, d, tm, tn, tk in fp32_cases:
        for metric in ("l2", "ip"):
            arrs = [a.to(dev) for a in _t(*_mk(m, n, d, seed=m + d,
                                               dead_tile=slice(128, 256)))]
            got, skip = distance.partial_distance_update(
                *arrs, metric=metric, tile_m=tm, tile_n=tn, tile_k=tk)
            want = ref.partial_distance_update_ref(*arrs, metric=metric, tile_k=tk)
            assert_distance_close(got.cpu().numpy(), want.cpu().numpy(),
                                  arrs[5].cpu().numpy())
            assert torch.equal(skip, ops._tile_skip_map(arrs[4], tm, tn))
    x, xn2, q, qn2, acc, tau = _mk(128, 384, 128, seed=11)
    arrs = [a.to(dev) for a in _t(x, xn2, q, qn2, _one_subtile_alive(acc),
                                  np.full_like(tau, 1e30))]
    got, skip = distance.partial_distance_update(*arrs)
    assert skip.tolist() == [[0, 0, 1]]
    assert torch.isfinite(got).nonzero().tolist() == [[3, 130], [100, 90]]
    assert_distance_close(got.cpu().numpy(),
                          ref.partial_distance_update_ref(*arrs).cpu().numpy(),
                          arrs[5].cpu().numpy())
    int8_cases = INT8_CASES + [
        # (m, n, d, tile_m, tile_n, tile_k, extreme, dead tile, tight row)
        (130, 257, 70, 4, 100, 32, False, slice(0, 128), 3),   # unaligned Db
        (130, 257, 64, 32, 64, 64, False, None, None),
        (64, 256, 64, 128, 128, 24, False, None, None),        # unaligned chunks
    ]
    for m, n, d, tm, tn, tk, extreme, dead, tight in int8_cases:
        x, xn2, q, qn2, s2, acc, tau = _mk_int8(m, n, d, seed=d, dead_tile=dead,
                                                extreme=extreme, tight=tight)
        args = [a.to(dev) for a in (*_t(x, xn2, q, qn2), torch.tensor(s2),
                                    *_t(acc, tau))]
        got, skip = distance_int8.int8_partial_distance_update(
            *args, tile_m=tm, tile_n=tn, tile_k=tk)
        want = ref.int8_partial_distance_update_ref(*args, tile_k=tk)
        assert torch.equal(got, want)
        assert torch.equal(skip, ops._tile_skip_map(args[5], tm, tn))
    x, xn2, q, qn2, s2, acc, tau = _mk_int8(128, 384, 128, seed=12)
    args = [a.to(dev) for a in (*_t(x, xn2, q, qn2), torch.tensor(s2),
                                *_t(_one_subtile_alive(acc), np.full_like(tau, np.inf)))]
    got, skip = distance_int8.int8_partial_distance_update(*args)
    assert skip.tolist() == [[0, 0, 1]]
    assert torch.isfinite(got).nonzero().tolist() == [[3, 130], [100, 90]]
    assert torch.equal(got, ref.int8_partial_distance_update_ref(*args))
    for m, c, k in [(4, 256, 10), (64, 256, 40), (3, 4096, 64)]:
        for ties in (False, True):
            arrs = [a.to(dev) for a in _t(*_mk_topk(m, c, k, seed=c, ties=ties))]
            gs, gi = topk_update.running_topk_update(*arrs, k=k)
            ws, wi = ref.running_topk_ref(*arrs, k=k)
            assert torch.equal(gs, ws) and torch.equal(gi, wi)
    # the top-K kernel's branches, as chip_smoke.py checks them: M in
    # {1, 130}, K in {1, 64}, C in {1, 10, 40, 257, 4096} (K = C for
    # merge_topk's shape), with the full and the broadcast ids
    branch = [(1, 256, 10), (130, 256, 1), (130, 256, 64), (130, 1, 1), (130, 10, 10),
              (130, 40, 40), (130, 257, 64), (64, 4096, 40)]
    for m, c, k in branch:
        for kind in ("uniform", "path", "run_last", "finite_chunk"):
            for run_filled in (True, False):
                s, ids, rs, ri = _t(*_mk_topk(m, c, k, seed=m + c + k, kind=kind,
                                              run_filled=run_filled, ties=kind == "uniform"))
                s, ids, rs, ri = (a.to(dev) for a in (s, ids, rs, ri))
                for ids_form in (ids, ids[0].expand(m, c)):
                    gs, gi = topk_update.running_topk_update(s, ids_form, rs, ri, k=k)
                    ws, wi = ref.running_topk_ref(s, ids_form, rs, ri, k=k)
                    assert torch.equal(gs, ws) and torch.equal(gi, wi), (m, c, k, kind)
