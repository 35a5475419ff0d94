"""The running top-K kernel's host side: its route boundary, its launch
plan, and the plain version on the inputs the redesigned routes 2 and 3
branch on, against the JAX package.

What the CUDA kernel itself does with these inputs is held on the card
(the ``cuda`` cases of ``test_torch_kernels.py`` and ``chip_smoke.py``).
Here :func:`topk_update.plan` is checked for every (M, C, K) class the
served paths and the checks launch, and ``running_topk_ref`` is held
against the reference's ``running_topk_ref`` exactly and its Pallas
kernel in interpret mode (ids equal but across exact ties), as
``test_topk_plain_matches_reference_and_pallas`` holds the uniform sweep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.topk_update import running_topk_update as pallas_topk
from repro_torch.kernels import ops, topk_update
from repro_torch.serve import ExecutorConfig

SMEM_PER_BLOCK = 232_448        # the H100's shared memory for one block
FEW_CUT = 32                    # survivors one warp ranks alone


def test_route_boundary():
    """Route 1 up to ``WARP_MAX_K`` (the measured crossover, 64), route 2
    from one above it to ``MAX_K``, route 3 above."""
    cut = topk_update.WARP_MAX_K
    assert cut == 64
    big = 2 ** 31 - 1
    ks = (1, cut, cut + 1, 300, 400, topk_update.MAX_K, topk_update.MAX_K + 1, big)
    assert [topk_update.route(k) for k in ks] == [1, 1, 2, 2, 2, 2, 3, 3]


@pytest.mark.parametrize("precision,k,route", [
    ("fp32", 10, 1), ("int8", 10, 1), ("int8", 20, 2), ("fp32", 300, 2), ("int8", 100, 2),
    ("fp32", 12289, 3), ("int8", 3073, 3)])
def test_served_rings_take_their_routes(precision, k, route):
    """The ring's K of each served (precision, k): k, or k·rerank_factor in
    the int8 tier (K' = 80 at k = 20, route 2 since the boundary moved)."""
    kr = k * (ExecutorConfig().rerank_factor if precision == "int8" else 1)
    assert topk_update.route(kr) == topk_update.plan(128, 256, kr).route == route


# (M, C, K): the ring (C = 256) at the int8 main path's K' = 40, the
# boundary and one above it, k = 300 and K' = 400; the fused merge (C = K)
# at M = 1, 8, 128 on routes 2 and 3; past one route 3 window, past one
# merge pass and past one chunk
PLAN_CASES = ([(128, 256, k) for k in (40, topk_update.WARP_MAX_K,
                                       topk_update.WARP_MAX_K + 1, 300, 400)]
              + [(m, k, k) for m in (1, 8, 128) for k in (300, 4096, 12289, 16384)]
              + [(8, 256, 12292), (8, 256, 16384), (3, 2048, 12289), (3, 2049, 12289),
                 (130, 8192, 4096), (2, 100, topk_update.MAX_K), (8, 20000, 20000),
                 (3, 40000, 12289), (1, 300_000, 12289)])


@pytest.mark.parametrize("m,c,k", PLAN_CASES)
def test_plan(m, c, k):
    """What the design promises at each class: routes 1 and 2 launch once
    with a CTA a row and no scratch; route 2's window is a power of two of
    256..2048 that covers C unless the list leaves no room, and fits the
    card's shared memory; route 3 keeps one wave of 132 CTAs (or its
    largest tile), at least 64 at M = 8, launches once with no scratch up
    to ``FUSE_C`` columns and otherwise needs a scratch and two launches
    or more (the window runs and the tiles, a merge pass between)."""
    p = topk_update.plan(m, c, k)
    assert p.route == topk_update.route(k)
    assert p.smem_bytes + 2048 <= SMEM_PER_BLOCK
    if p.route in (1, 2):
        assert (p.ctas, p.launches, p.scratch_bytes) == (m, 1, 0)
    if p.route == 2:
        assert 256 <= p.window <= 2048 and p.window & (p.window - 1) == 0
        wider = topk_update.plan(m, 2 * p.window, k)
        assert p.window >= min(c, 2048) or wider.window == p.window
        return
    if p.route == 1:
        return
    assert p.ctas <= 132 or p.ctas == m * -(-k // 4096)
    assert m != 8 or p.ctas >= 64
    if c <= topk_update.FUSE_C:
        assert (p.launches, p.scratch_bytes) == (1, 0) and p.window >= c
    else:
        assert p.launches >= 2 and p.scratch_bytes > 0


def test_plan_of_the_served_shapes():
    """The numbers the source note and PERF.md quote."""
    assert topk_update.plan(8, 12289, 12289).launches == 3      # runs, 1 pass, tiles
    assert topk_update.plan(8, 12289, 12289).ctas == 8 * 13        # tiles of 1024
    assert topk_update.plan(8, 256, 16384).ctas == 128
    assert topk_update.plan(1, 12289, 12289).ctas == 49            # tiles of 256
    assert topk_update.plan(128, 256, 400).window == 256
    assert topk_update.plan(128, 4096, 4096).window == 2048
    assert topk_update.plan(2, 100, topk_update.MAX_K).window == 256
    assert topk_update.plan(2, 4096, topk_update.MAX_K).window == 1024  # 208 KB
    assert topk_update.plan(8, 20000, 20000).launches == 2 + 2      # 3 windows, 2 passes
    assert topk_update.plan(1, 300_000, 12289).launches == (2 + 5) + (2 + 3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mk(m, c, k, kind, seed):
    """(scores, ids, run_s, run_i) aimed at the branches of routes 2 and 3.
    ``ascending``: each row's candidates ascending with a +inf tail, as the
    fused merge passes them, on 12 integer scores shared with the run, so
    equal scores span windows and equal run entries; every other row's run
    all +inf (the merge's first part). ``few``: rows in turn with
    ``FEW_CUT``, ``FEW_CUT + 1`` and no survivor below run_s[K-1], the rest
    equal to it or +inf. ``mixed``: rows with no survivor beside rows whose
    every candidate survives."""
    rng = np.random.default_rng(seed)
    run_s = np.sort(rng.integers(1, 12, size=(m, k)), axis=1).astype(np.float32)
    run_i = rng.integers(10_000, 20_000, size=(m, k)).astype(np.int32)
    ids = rng.integers(0, 10_000, size=(m, c)).astype(np.int32)
    thr = run_s[:, -1:]
    if kind == "ascending":
        s = rng.integers(0, 12, size=(m, c)).astype(np.float32)
        s[rng.random((m, c)) < 0.2] = np.inf
        s = np.sort(s, axis=1)
        run_s[::2] = np.inf
        run_i[::2] = -1
    elif kind == "few":
        s = np.where(rng.random((m, c)) < 0.5, thr, np.inf).astype(np.float32)
        for r in range(m):
            n = min(c, (FEW_CUT, FEW_CUT + 1, 0)[r % 3])
            s[r, rng.choice(c, size=n, replace=False)] = np.floor(
                thr[r, 0] * rng.uniform(0, 0.999, size=n))
    elif kind == "mixed":
        s = (thr * rng.uniform(0, 0.999, size=(m, c))).astype(np.float32)
        s[::2] = np.where(rng.random((len(s[::2]), c)) < 0.5, thr[::2], np.inf)
    else:
        raise ValueError(kind)
    return s.astype(np.float32), ids, run_s, run_i


# (m, c, k): the cut's two sides need C > 33; K below, at and above C
KIND_CASES = [(m, c, k, kind) for kind in ("ascending", "few", "mixed")
              for m, c, k in ((6, 40, 8), (6, 64, 40), (4, 40, 40), (3, 80, 100))]


@pytest.mark.parametrize("m,c,k,kind", KIND_CASES)
def test_topk_plain_matches_reference_on_route_branches(m, c, k, kind):
    arrs = _mk(m, c, k, kind, seed=m * c + k)
    gs, gi = ops.running_topk_update(*_t(*arrs), k=k)
    ws, wi = r_ref.running_topk_ref(*map(jnp.asarray, arrs), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    ps, pi = pallas_topk(*map(jnp.asarray, arrs), k=k, tile_m=4, interpret=True)
    ps, pi = np.asarray(ps), np.asarray(pi)
    np.testing.assert_array_equal(gs.numpy(), ps)
    diff = (gi.numpy() != np.where(np.isfinite(ps), pi, -1))
    if diff.any():
        r, col = np.nonzero(diff)
        assert np.allclose(gs.numpy()[r, col], ps[r, col]), "id mismatch beyond ties"


def test_kinds_reach_their_branches():
    """The inputs do what their names say: survivors per row at the cut
    and one above it, rows with none beside full ones, ascending rows."""
    s, _, run_s, _ = _mk(6, 40, 8, "few", 1)
    assert [(s[r] < run_s[r, -1]).sum() for r in range(6)] == [32, 33, 0] * 2
    s, _, run_s, _ = _mk(4, 40, 40, "mixed", 1)
    assert [(s[r] < run_s[r, -1]).sum() for r in range(4)] == [0, 40, 0, 40]
    s, *_ = _mk(4, 64, 40, "ascending", 1)
    assert (s[:, 1:] >= s[:, :-1]).all()
