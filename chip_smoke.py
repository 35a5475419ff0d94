#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``ok`` line):

1. Print the card (``nvidia-smi`` name and power limit), the PyTorch and
   CUDA versions; build the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` with ``nvcc`` and print the build time and ``ptxas`` report.
2. Kernels: hold each kernel against its plain PyTorch version on the
   card at every shape the serving phases give it (M = QG in
   {4, 8, 16, 32, 64, 128}; fp32 distance at the CPU tests' tolerances,
   the int8 distance and the top-K bit for bit, identical skip maps),
   and at the distance kernels' awkward geometries: logical tiles that
   are not multiples of their 16 x 32 sub-tiles, chunked and unaligned
   contractions, a tile alive in one sub-tile only; the top-K kernel
   also at inputs aimed at its branches (``mk_topk_branch``), M in
   {1, 130}, K in {1, 64}, C up to 4096, with full and broadcast ids.
   Then time kernel, plain version, a PyTorch library yardstick and the
   bytes/operations bound at the main path's shapes (CUDA events), with
   each kernel's grid size (``ctas``) and each distance kernel's time
   when no tile is dead.
3. Serving, fp32: build a SIFT1M-shaped IVF index on the card (1M × 128
   fp32 rows, nlist 1024, nprobe 16, top-10) and serve batches of
   1, 8, 32, 128 and 160 queries through ``SpmdExecutor.search_batch`` on
   the virtual meshes 1×1 and 2×2; every batch must equal the exact
   ``search_oracle`` on the card, and the kernels' launch counters must
   grow on that path while the plain versions stay at 0.
4. Serving, int8 (``ExecutorConfig(precision="int8")``): the same batches
   on the same index and meshes through the quantized stage 1 and the
   fp32 re-rank. Every score must be the fp32 distance of its id, every
   row must equal ``two_stage_search`` on the card but for ties (see
   ``check_int8``), recall@10 against the fp32 oracle must be ≥ 0.98, and
   the int8 and top-K kernels must launch while the fp32 distance kernel
   and every plain version stay at 0.

After each tier and mesh, one more 128-query batch is served with the
ring's top-K call wrapped (``survivor_split``): how many candidates per
(row, launch) lie below the row's K-th score. The profile lines give the
top-K kernel's device ms and launches. Then the top-K kernel is timed
on inputs that follow each measured split (``time_topk_path_shaped``).

5. Serving through the entry point (``serve_engine``): the same index as
   segment 0 of a ``SegmentedIndex`` behind ``HarmonyServer(n_nodes=4,
   backend="spmd")``. A write burst (fresh ids, overwrites, deletes), the
   batches above; a delta-only seal, a second burst, the batches again
   (three parts per merge). Every batch must equal an oracle built without
   the ring or the merge kernel (``engine_oracle``), hold no deleted id,
   and launch the top-K kernel exactly once per part beyond the ring's
   launches (``RingTopkLaunches``). Then an int8 server on the same data
   at k = 10 and k = 20 (K' = 80: exact fp32 scores, live distinct ids,
   recall ≥ 0.98 against the fp32 server), a per-batch precision override
   on each server (served by executors of that precision, equal to the
   other server's batch; no host-engine layout is ever built on spmd),
   the host backend on request (equal to the spmd batch, no kernel
   launched) and an int64 id (first at distance 0, on the card: in the
   delta, and once sealed). The top-K kernel is timed at the merge's
   shapes and at K = 80, 256 (``time_merge_shapes``).
6. Print the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
INT8_OP_PER_S = 1979e12       # H100 SXM, dense int8 tensor-core rate
TOL = 1e-4                    # the CPU tests' fp32 rule


def log(**kw):
    print(json.dumps(kw, default=float), flush=True)


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    tb = nbytes / HBM_BYTES_PER_S
    tf = flops / FP32_FLOP_PER_S + int8_ops / INT8_OP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def port_on_path() -> bool:
    """Put the checkout's ``src/`` first on the path; False without the port."""
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's package is missing under {src}",
              file=sys.stderr)
        return False
    sys.path.insert(0, str(src))
    return True


def build_kernels() -> None:
    """Build every ``csrc/*.cu`` (in parallel) and print ptxas's report:
    registers, shared memory and spills of each kernel."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("partial_distance")
    log(phase="build", seconds=time.perf_counter() - t0,
        per_source=_build.build_seconds)
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"ptxas[{name}]: {line.strip()}", flush=True)


def _one_subtile_alive(acc):
    """acc [128, 384] on 128 x 128 tiles: tile 0 alive only at (100, 90),
    in sub-tile (6, 2) of the kernels' 16 x 32 grid; tile 1 only at
    (3, 130), in its sub-tile (0, 0); tile 2 dead. Skip map [[0, 0, 1]]."""
    acc[:] = float("inf")
    acc[100, 90] = 1.0
    acc[3, 130] = 2.0
    return acc


def check_kernels(dev):
    """Hold each kernel against its plain version on the card; returns
    (max |err| per kernel, number of cases)."""
    import numpy as np
    import torch

    from repro_torch.kernels import distance, distance_int8, ops, ref, topk_update

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def dist_err(got, want, tau):
        got, want, tau = got.cpu().numpy(), want.cpu().numpy(), tau.cpu().numpy()[:, None]
        boundary = np.abs(np.where(np.isfinite(want), want, tau) - tau) <= TOL * (1 + np.abs(tau))
        bad = (np.isfinite(got) != np.isfinite(want)) & ~boundary
        assert not bad.any(), "partial_distance: +inf pattern differs beyond ties"
        both = np.isfinite(got) & np.isfinite(want)
        np.testing.assert_allclose(got[both], want[both], rtol=TOL, atol=TOL)
        return float(np.abs(got[both] - want[both]).max()) if both.any() else 0.0

    errs = {"partial_distance_update": 0.0, "int8_partial_distance_update": 0.0,
            "running_topk_update": 0.0}
    n_checked = 0
    # M = QG = qb / B: qb in {8, 32, 128} on 1x1 and 2x2 gives every M here
    ring_ms = (4, 8, 16, 32, 64, 128)
    # (m, n, d, tiles, tile_k): the ring's shapes at both tilings, then
    # logical tiles that are not multiples of the 16 x 32 sub-tile, Db = 96
    # in chunks of 32 and 64, and Db = 30 (the unaligned staging path)
    dist_cases = [(m, 256, d, tiles, 128) for m in ring_ms for d in (32, 64, 128)
                  for tiles in ((128, 128), (32, 64))]
    dist_cases += [(130, 257, 96, tiles, tk) for tiles in ((128, 128), (32, 64), (4, 100))
                   for tk in (32, 64)]
    dist_cases += [(128, 256, 128, (4, 100), 128), (64, 256, 30, (128, 128), 128),
                   (64, 256, 30, (4, 100), 32)]
    for m, n, d, tiles, tk in dist_cases:
        for metric in ("l2", "ip"):
            x = rng.normal(size=(n, d)).astype(np.float32)
            q = rng.normal(size=(m, d)).astype(np.float32)
            acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
            acc[rng.random((m, n)) < 0.3] = np.inf
            acc[:, 128:256] = np.inf          # one whole 128-wide tile dead
            tau = rng.uniform(d * 0.5, d * 3.0, size=(m,)).astype(np.float32)
            a = [t(v) for v in (x, (x ** 2).sum(1), q, (q ** 2).sum(1), acc, tau)]
            got, skip = distance.partial_distance_update(
                *a, metric=metric, tile_m=tiles[0], tile_n=tiles[1], tile_k=tk)
            want = ref.partial_distance_update_ref(*a, metric=metric, tile_k=tk)
            torch.cuda.synchronize()
            errs["partial_distance_update"] = max(
                errs["partial_distance_update"], dist_err(got, want, a[5]))
            assert torch.equal(skip, ops._tile_skip_map(a[4], *tiles)), \
                f"partial_distance: skip map differs at {(m, n, d, tiles, tk)}"
            n_checked += 1
    # a logical tile alive in one sub-tile only: its skip bit stays 0
    x = rng.normal(size=(384, 128)).astype(np.float32)
    q = rng.normal(size=(128, 128)).astype(np.float32)
    acc = _one_subtile_alive(np.zeros((128, 384), np.float32))
    a = [t(v) for v in (x, (x ** 2).sum(1), q, (q ** 2).sum(1), acc,
                        np.full(128, 1e30, np.float32))]
    got, skip = distance.partial_distance_update(*a)
    want = ref.partial_distance_update_ref(*a)
    assert skip.tolist() == [[0, 0, 1]], f"partial_distance: one-sub-tile skip {skip}"
    assert torch.isfinite(got).nonzero().tolist() == [[3, 130], [100, 90]], \
        "partial_distance: a dead sub-tile came back finite"
    errs["partial_distance_update"] = max(errs["partial_distance_update"],
                                          dist_err(got, want, a[5]))
    n_checked += 1

    def mk_int8(m, n, d, extreme=False, tight=False, acc=None):
        x = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        q = rng.integers(-127, 128, size=(m, d)).astype(np.int8)
        if extreme:                            # codes at the clip, ±127
            x[::4] = 127
            q[1::3] = -127
        s2 = np.float32(0.0123)
        xn2 = (s2 * (x.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        qn2 = (s2 * (q.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        if acc is None:
            acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
            acc[rng.random((m, n)) < 0.3] = np.inf
            acc[:, 128:256] = np.inf           # one whole 128-wide tile dead
        tau = (rng.uniform(0.8, 1.1, size=(m,)) * 2 * 5376 * d * float(s2)).astype(np.float32)
        if extreme:                            # keep the far pairs finite
            tau[:] = np.inf
        if tight:
            tau[0] = 0.5                       # prunes the whole row
        return [t(x), t(xn2), t(q), t(qn2), torch.tensor(s2, device=dev), t(acc), t(tau)]

    # int8: M = QG as above, Db = 128/B; the ring folds the dot per tile_k.
    # Then ragged and 4 x 100 tiles, unaligned Db (30, 70) and an unaligned
    # chunk (24): the word-at-a-time staging path.
    int8_cases = [(m, 256, d, tiles, 128, False, False) for m in ring_ms
                  for d in (32, 64, 128) for tiles in ((128, 128), (32, 64))]
    int8_cases += [(130, 257, 96, (128, 128), 32, True, True),   # ragged, 3 chunks
                   (130, 257, 70, (4, 100), 32, False, True),
                   (130, 257, 30, (128, 128), 16, True, False),
                   (130, 257, 64, (32, 64), 64, False, False),
                   (128, 256, 128, (4, 100), 128, False, True),
                   (64, 256, 64, (128, 128), 24, False, False)]
    for m, n, d, tiles, tk, extreme, tight in int8_cases:
        a = mk_int8(m, n, d, extreme, tight)
        got, skip = distance_int8.int8_partial_distance_update(
            *a, tile_m=tiles[0], tile_n=tiles[1], tile_k=tk)
        want = ref.int8_partial_distance_update_ref(*a, tile_k=tk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"int8 distance differs at {(m, n, d, tiles, tk)}"
        assert torch.isfinite(want).any(), "int8: no finite value to compare"
        assert torch.equal(skip, ops._tile_skip_map(a[5], *tiles)), "int8 skip map differs"
        assert not torch.isfinite(got[:, 128:256]).any(), "int8: a dead tile came back"
        if tight:
            assert not torch.isfinite(got[0]).any(), "int8: tight tau kept a value"
        n_checked += 1
    a = mk_int8(128, 384, 128, extreme=True,
                acc=_one_subtile_alive(np.zeros((128, 384), np.float32)))
    got, skip = distance_int8.int8_partial_distance_update(*a)
    assert torch.equal(got, ref.int8_partial_distance_update_ref(*a)), \
        "int8 distance differs with one alive sub-tile"
    assert skip.tolist() == [[0, 0, 1]], f"int8: one-sub-tile skip {skip}"
    assert torch.isfinite(got).nonzero().tolist() == [[3, 130], [100, 90]], \
        "int8: a dead sub-tile came back finite"
    n_checked += 1

    def mk_topk(m, c, k, ties):
        s = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
        if ties:
            s = np.round(s / 10).astype(np.float32)
        s[rng.random((m, c)) < 0.2] = np.inf
        s[0] = np.inf                          # an all-invalid row
        ids = rng.integers(0, 10_000, size=(m, c)).astype(np.int32)
        run_s = np.sort(np.round(rng.uniform(0, 100, size=(m, k))), axis=1).astype(np.float32)
        run_i = rng.integers(10_000, 20_000, size=(m, k)).astype(np.int32)
        return [t(a) for a in (s, ids, run_s, run_i)]

    for m in ring_ms:
        for k in (10, 40):
            for ties in (False, True):
                a = mk_topk(m, 256, k, ties)
                gs, gi = topk_update.running_topk_update(*a, k=k)
                ws, wi = ref.running_topk_ref(*a, k=k)
                torch.cuda.synchronize()
                assert torch.equal(gs, ws), "running_topk: scores differ"
                assert torch.equal(gi, wi), "running_topk: ids differ"
                # the ring's form: one chunk's ids broadcast over the rows
                row_ids = a[1][0].expand(m, 256)
                bs, bi = topk_update.running_topk_update(a[0], row_ids, a[2], a[3], k=k)
                bws, bwi = ref.running_topk_ref(a[0], row_ids, a[2], a[3], k=k)
                assert torch.equal(bs, bws) and torch.equal(bi, bwi), \
                    "running_topk: broadcast ids differ"
                errs["running_topk_update"] = max(
                    errs["running_topk_update"],
                    float((gs - ws)[torch.isfinite(ws)].abs().max().item())
                    if torch.isfinite(ws).any() else 0.0)
                n_checked += 1
    # the redesigned kernel's branches: rows with no survivor, one survivor,
    # candidates equal to run entries, an empty or half-empty run under an
    # all-finite chunk, ties across 256-column windows; K = C is the shape of
    # merge_topk(fused=True)
    branch_shapes = [(1, 256, 10), (130, 256, 40), (130, 256, 1), (130, 256, 64),
                     (130, 1, 1), (130, 10, 10), (130, 40, 40), (130, 257, 64),
                     (64, 4096, 40), (3, 4096, 64)]
    # K above 64 (4 and 8 list entries a lane; K' = 80 is the int8 tier at
    # k = 20), and the served merge's shapes: M = nq, C = K = k
    branch_shapes += [(m, c, k) for k in (80, 128, 256) for c in (80, 256, 4096)
                      for m in ((130, 3) if c == 4096 else (130,))]
    branch_shapes += [(m, k, k) for m in (1, 8, 32, 128, 160) for k in (10, 20)]
    for m, c, k in branch_shapes:
        for kind in TOPK_KINDS:
            a = [t(v) for v in mk_topk_branch(rng, m, c, k, kind)]
            for ids in (a[1], a[1][0].expand(m, c)):
                gs, gi = topk_update.running_topk_update(a[0], ids, a[2], a[3], k=k)
                ws, wi = ref.running_topk_ref(a[0], ids, a[2], a[3], k=k)
                torch.cuda.synchronize()
                assert torch.equal(gs, ws) and torch.equal(gi, wi), \
                    f"running_topk differs at {(m, c, k, kind)}, ids stride {ids.stride(0)}"
            n_checked += 1
    log(phase="kernels_checked", cases=n_checked, max_abs_err=errs)
    return errs, n_checked


TOPK_KINDS = ("path", "run_entries", "run_inf", "run_part", "windows")


def mk_topk_branch(rng, m, c, k, kind):
    """(scores, ids, run_s, run_i) as numpy arrays aimed at one branch of
    the top-K kernel. ``path``: rows in turn all +inf, one survivor below
    run_s[K-1], a few survivors beside entries equal to run_s[K-1], and only
    such equal entries (none enters). ``run_entries``: candidates copied
    from the row's run entries, the last one included, with +inf holes.
    ``run_inf`` / ``run_part``: a run all +inf or +inf from K/2 on, under an
    all-finite chunk. ``windows``: 300 distinct integer scores over the row,
    so equal scores fall in different 256-column windows."""
    import numpy as np

    run_s = np.sort(np.round(rng.uniform(1, 100, size=(m, k))), axis=1).astype(np.float32)
    run_i = rng.integers(10_000, 20_000, size=(m, k)).astype(np.int32)
    ids = rng.integers(0, 10_000, size=(m, c)).astype(np.int32)
    thr = run_s[:, -1:]
    if kind == "path":
        s = np.full((m, c), np.inf, np.float32)
        below = (thr * rng.uniform(0, 0.999, size=(m, c))).astype(np.float32)
        pick = rng.random((m, c))
        one = np.arange(m) % 4 == 1
        s[one, rng.integers(0, c, size=int(one.sum()))] = below[one, 0]
        few = np.arange(m) % 4 == 2
        s[few] = np.where(pick[few] < 3 / c, below[few], s[few])
        eq = np.arange(m) % 4 >= 2
        s[eq] = np.where((pick[eq] > 0.9) & ~np.isfinite(s[eq]),
                         np.broadcast_to(thr, (m, c))[eq], s[eq])
    elif kind == "run_entries":
        run_s = np.sort(np.round(run_s / 10), axis=1).astype(np.float32)
        s = np.take_along_axis(run_s, rng.integers(0, k, size=(m, c)), axis=1)
        s[:, ::7] = run_s[:, -1:]
        s[rng.random((m, c)) < 0.2] = np.inf
    elif kind in ("run_inf", "run_part"):
        s = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
        half = 0 if kind == "run_inf" else (k + 1) // 2
        run_s[:, half:] = np.inf
        run_i[:, half:] = -1
    elif kind == "windows":
        s = rng.integers(0, 300, size=(m, c)).astype(np.float32)
        run_s = np.sort(rng.integers(0, 300, size=(m, k)), axis=1).astype(np.float32)
    else:
        raise ValueError(kind)
    return s.astype(np.float32), ids, run_s, run_i


def time_ms(fn, reps=100):
    """(device ms per call, host wall ms per call). The device time is
    taken between CUDA events with the stream held in a spin while all
    ``reps`` calls are queued, so launch overhead stays out of it; the
    wall time per call includes it."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / reps * 1e3
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))          # ~0.1 s: the host queues ahead
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps, call_ms


def time_kernels(dev, smi):
    """Time each kernel, its plain version and a PyTorch library call at
    the main path's shapes; returns the first (1x1) row of each kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import distance, distance_int8, ops, ref

    rng = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def acc_tau(m, n, lo, hi):
        acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
        acc[rng.random((m, n)) < 0.3] = np.inf
        acc[:, 128:256] = np.inf              # one whole 128-wide tile dead
        return t(acc), t(rng.uniform(lo, hi, size=(m,)).astype(np.float32))

    def revive(acc):
        """acc with its dead tile given tile 0's values: every tile alive,
        so no skip-map scan (``kernel_ms_all_alive``)."""
        live = acc.clone()
        live[:, 128:256] = acc[:, :128]
        return live

    timed = {}
    # the main path's shapes: QG = qb/B rows per group, chunk = 256, Db = 128/B
    for (m, d, label) in ((128, 128, "mesh1x1_qb128"), (64, 64, "mesh2x2_qb128")):
        x = rng.normal(size=(256, d)).astype(np.float32)
        q = rng.normal(size=(m, d)).astype(np.float32)
        a = [t(x), t((x ** 2).sum(1)), t(q), t((q ** 2).sum(1)),
             *acc_tau(m, 256, d * 0.5, d * 3.0)]
        alive_tiles = int((ops._tile_skip_map(a[4], 128, 128) == 0).sum())
        base = a[4] + a[3][:, None] + a[1][None, :]
        live = revive(a[4])
        (ms, call), (plain, plain_call), (lib, lib_call), (ms_live, _) = (
            time_ms(lambda: distance.partial_distance_update(*a)),
            time_ms(lambda: ref.partial_distance_update_ref(*a)),
            time_ms(lambda: torch.addmm(base, a[2], a[0].T, alpha=-2)),
            time_ms(lambda: distance.partial_distance_update(*a[:4], live, a[5])))
        nbytes = 4 * (256 * d + 256 + m * d + m + 2 * m * 256 + m) + 4 * 2
        flops = 2 * min(m, 128) * 128 * d * alive_tiles + 4 * m * 256
        b, by = bound_ms(nbytes, flops)
        row = dict(kernel="partial_distance_update", shape=label, M=m, N=256, Db=d,
                   ctas=distance.ctas(m, 256), kernel_ms=ms,
                   kernel_ms_all_alive=ms_live, plain_ms=plain,
                   library_ms=lib, bound_ms=b, bound_by=by, kernel_call_ms=call,
                   plain_call_ms=plain_call, library_call_ms=lib_call, card=smi)
        log(**row)
        timed.setdefault("partial_distance_update", row)
    for (m, d, label) in ((128, 128, "mesh1x1_qb128"), (64, 64, "mesh2x2_qb128")):
        x = rng.integers(-127, 128, size=(256, d)).astype(np.int8)
        q = rng.integers(-127, 128, size=(m, d)).astype(np.int8)
        s2 = np.float32(0.0123)
        xn2 = (s2 * (x.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        qn2 = (s2 * (q.astype(np.int64) ** 2).sum(1)).astype(np.float32)
        lo = 0.8 * 2 * 5376 * d * float(s2)
        a = [t(x), t(xn2), t(q), t(qn2), torch.tensor(s2, device=dev),
             *acc_tau(m, 256, lo, lo * 1.1 / 0.8)]
        alive_tiles = int((ops._tile_skip_map(a[5], 128, 128) == 0).sum())
        base = a[5] + a[3][:, None] + a[1][None, :]
        two_s2 = 2.0 * a[4]
        xt = a[0].T                      # column-major, as _int_mm takes it
        live = revive(a[5])
        (ms, call), (plain, plain_call), (lib, lib_call), (ms_live, _) = (
            time_ms(lambda: distance_int8.int8_partial_distance_update(*a)),
            time_ms(lambda: ref.int8_partial_distance_update_ref(*a)),
            time_ms(lambda: base - two_s2 * torch._int_mm(a[2], xt).float()),
            time_ms(lambda: distance_int8.int8_partial_distance_update(*a[:5], live, a[6])))
        nbytes = 256 * d + m * d + 4 * (256 + 2 * m + 2 * m * 256) + 4
        int8_ops = 2 * min(m, 128) * 128 * d * alive_tiles
        b, by = bound_ms(nbytes, 4 * m * 256, int8_ops)
        row = dict(kernel="int8_partial_distance_update", shape=label, M=m, N=256,
                   Db=d, ctas=distance_int8.ctas(m, 256), kernel_ms=ms,
                   kernel_ms_all_alive=ms_live,
                   plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                   library_call="torch._int_mm(q, x.T) + f32 combine",
                   kernel_call_ms=call, plain_call_ms=plain_call,
                   library_call_ms=lib_call, card=smi)
        log(**row)
        timed.setdefault("int8_partial_distance_update", row)
    for (m, k, label) in ((128, 10, "mesh1x1_qb128"), (64, 10, "mesh2x2_qb128"),
                          (128, 40, "mesh1x1_qb128_int8"), (64, 40, "mesh2x2_qb128_int8")):
        c = 256
        s = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
        s[rng.random((m, c)) < 0.2] = np.inf
        run_s = np.sort(np.round(rng.uniform(0, 100, size=(m, k))), axis=1).astype(np.float32)
        row = time_topk(rng, dev, s, run_s, label, smi)
        timed.setdefault("running_topk_update", row)
    return timed


def time_topk(rng, dev, s, run_s, label, smi, **extra):
    """Time the top-K kernel, its plain version and ``torch.topk`` of the
    [M, K+C] concatenation on scores ``s`` [M, C] and the ascending list
    ``run_s`` [M, K] (numpy), with one broadcast ids row as the ring
    passes it; check the kernel against the plain version there first."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref, topk_update

    (m, c), k = s.shape, run_s.shape[1]
    s, run_s = (torch.from_numpy(v).to(dev) for v in (s, run_s))
    ids_row = torch.from_numpy(rng.integers(0, 10_000, size=(c,)).astype(np.int32)
                               ).to(dev).expand(m, c)
    run_i = torch.from_numpy(rng.integers(10_000, 20_000, size=(m, k)).astype(np.int32)
                             ).to(dev)
    gs, gi = topk_update.running_topk_update(s, ids_row, run_s, run_i, k=k)
    ws, wi = ref.running_topk_ref(s, ids_row, run_s, run_i, k=k)
    assert torch.equal(gs, ws) and torch.equal(gi, wi), f"running_topk differs at {label}"
    cat = torch.cat([run_s, s], dim=1)
    (ms, call), (plain, plain_call), (lib, lib_call) = (
        time_ms(lambda: topk_update.running_topk_update(s, ids_row, run_s, run_i, k=k)),
        time_ms(lambda: ref.running_topk_ref(s, ids_row, run_s, run_i, k=k)),
        time_ms(lambda: torch.topk(cat, k, dim=1, largest=False)))
    nbytes = 4 * (m * c + c + 2 * m * k) + 4 * 2 * m * k
    b, by = bound_ms(nbytes, m * k * c)
    row = dict(kernel="running_topk_update", shape=label, M=m, C=c, K=k, ctas=m, **extra,
               kernel_ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
               kernel_call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
               card=smi)
    log(**row)
    return row


def survivor_split(ex, queries, k):
    """Serve ``queries`` once with the ring's top-K call wrapped here, and
    count over its (row, launch) pairs how many candidates lie below the
    row's run_s[K-1]: the survivors the kernel merges (it drops the rest
    after one vote). Returns the split and the histogram of the counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, topk_update

    hist = torch.zeros(topk_update.MAX_C + 1, dtype=torch.int64, device=ex.device)
    thr_inf = torch.zeros((), dtype=torch.int64, device=ex.device)
    wrapped = ops.running_topk_update

    def counting(scores, ids, run_s, run_i, **kw):
        n = (scores < run_s[:, -1:]).sum(1)
        hist.add_(torch.bincount(n, minlength=hist.numel()))
        thr_inf.add_(torch.isinf(run_s[:, -1]).sum())
        return wrapped(scores, ids, run_s, run_i, **kw)

    ops.running_topk_update = counting
    try:
        ex.search_batch(queries)
    finally:
        ops.running_topk_update = wrapped
    h = hist.cpu().numpy()
    n = np.arange(h.size)
    lo = min(32, k)
    bins = {"0": int(h[0]), f"1-{lo}": int(h[1:lo + 1].sum())}
    if k > lo:
        bins[f"{lo + 1}-{k}"] = int(h[lo + 1:k + 1].sum())
    bins[f">{k}"] = int(h[k + 1:].sum())
    pairs = int(h.sum())
    split = dict(pairs=pairs, bins=bins, share={b: v / pairs for b, v in bins.items()},
                 mean_survivors=float((n * h).sum() / pairs),
                 max_survivors=int(n[h > 0].max()),
                 share_run_not_full=int(thr_inf.item()) / pairs)
    return split, h


def time_topk_path_shaped(dev, smi, splits):
    """Time the top-K kernel on inputs that follow the survivor split the
    serving path measured (``survivor_split``) for each (tier, mesh): each
    row draws its survivor count from that histogram and puts as many
    scores below its (finite) run_s[K-1] at random columns, +inf elsewhere.
    Same bound and ``torch.topk`` yardstick as the 20 %-+inf rows."""
    import numpy as np

    rng = np.random.default_rng(2)
    c = 256
    for (tier, mesh, m, k), hist in splits.items():
        counts = rng.choice(hist.size, size=m, p=hist / hist.sum())
        run_s = np.sort(rng.uniform(0, 100, size=(m, k)), axis=1).astype(np.float32)
        s = np.full((m, c), np.inf, np.float32)
        for r, n in enumerate(counts):
            cols = rng.choice(c, size=n, replace=False)
            s[r, cols] = run_s[r, -1] * rng.uniform(0, 0.999, size=n)
        time_topk(rng, dev, s, run_s, f"mesh{mesh}_qb128_{tier}_path", smi,
                  input="path-shaped",
                  survivors_drawn={int(n): int(r) for n, r in
                                   zip(*np.unique(counts, return_counts=True))})


def assert_topk_matches(scores, ids, want_s, want_i, what):
    """The ROADMAP tolerance: the same +inf pattern, scores at rtol = atol =
    1e-3, ids equal except across exact ties (a row whose ids differ must
    hold the same sorted scores)."""
    import numpy as np

    finite = np.isfinite(want_s)
    assert scores.shape == want_s.shape and ids.dtype == np.int64, what
    assert np.array_equal(np.isfinite(scores), finite), f"{what}: valid pattern differs"
    np.testing.assert_allclose(scores[finite], want_s[finite], rtol=1e-3, atol=1e-3,
                               err_msg=what)
    diff = (ids != want_i) & finite
    for r in np.unique(np.nonzero(diff)[0]):
        assert np.allclose(np.sort(scores[r]), np.sort(want_s[r]), rtol=1e-3, atol=1e-3), (
            f"{what}: row {r} ids {ids[r]} vs {want_i[r]} beyond a tie")


class RingTopkLaunches:
    """Counts the top-K kernel launches made inside
    ``SpmdExecutor.search_batch`` (the ring's), so that a served batch's
    launches split into the ring's and the merge's. A batch the executor
    splits counts once, at its outer call."""

    def __init__(self):
        from repro_torch.serve.executor import SpmdExecutor

        self.cls, self.orig = SpmdExecutor, SpmdExecutor.search_batch
        self.depth = self.ring = 0

    def __enter__(self):
        from repro_torch.kernels import ops

        def wrapped(ex, *a, **kw):
            if self.depth:
                return self.orig(ex, *a, **kw)
            self.depth += 1
            before = ops.launch_counts()["running_topk_update"]
            try:
                return self.orig(ex, *a, **kw)
            finally:
                self.depth -= 1
                self.ring += ops.launch_counts()["running_topk_update"] - before

        self.cls.search_batch = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.search_batch = self.orig


def executors_wall(srv):
    """Summed ``wall_s`` of every executor the server has built."""
    return sum(ex.wall_s for st in srv._seg_states.values()
               for ex in st.executors.values())


def engine_oracle(dev, snap, q, k):
    """The served batch's answer, built without the ring or the merge
    kernel: per sealed segment ``search_oracle`` with its tombstones, an
    exact float64 top-k over the live delta rows on the card, merged by a
    stable sort (parts in snapshot order, the delta last)."""
    import numpy as np
    import torch

    from repro_torch.core import search_oracle

    nq = q.shape[0]
    parts_s, parts_i = [], []
    for seg in snap.segments:
        o = search_oracle(seg.index, q, k=k, dead_rows=snap.dead_rows[seg.seg_id])
        parts_s.append(o.scores.astype(np.float64))
        parts_i.append(o.ids)
    live = np.nonzero(snap.delta_live)[0]
    if live.size:
        xd = torch.as_tensor(snap.delta_x[live]).to(dev).double()
        qd = torch.as_tensor(q).to(dev).double()
        d = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ xd.T) + (xd * xd).sum(1)[None, :]
        sd, pos = torch.sort(d, dim=1, stable=True)
        kk = min(k, live.size)
        ds_ = np.full((nq, k), np.inf)
        di = np.full((nq, k), -1, np.int64)
        ds_[:, :kk] = sd[:, :kk].cpu().numpy()
        di[:, :kk] = snap.delta_ids[live][pos[:, :kk].cpu().numpy()]
        parts_s.append(ds_)
        parts_i.append(di)
    cat_s, cat_i = np.concatenate(parts_s, 1), np.concatenate(parts_i, 1)
    order = np.argsort(cat_s, axis=1, kind="stable")[:, :k]
    want_s = np.take_along_axis(cat_s, order, axis=1).astype(np.float32)
    want_i = np.take_along_axis(cat_i, order, axis=1)
    want_i[~np.isfinite(want_s)] = -1
    return want_s, want_i


def time_merge_shapes(dev, smi):
    """The top-K kernel at the served merge's shapes (M = nq, C = K = k):
    the first part, which meets an all-+inf list, and a later one, which
    meets a full list; each part's scores ascending, as a top-k is. Then
    K = 80 and 256 at the ring's C = 256."""
    import numpy as np

    rng = np.random.default_rng(3)
    rows = []
    for m, k in ((128, 10), (160, 10), (128, 20)):
        s = np.sort(rng.uniform(0, 100, size=(m, k)), axis=1).astype(np.float32)
        later = np.sort(rng.uniform(0, 100, size=(m, k)), axis=1).astype(np.float32)
        for part, run_s in (("first", np.full((m, k), np.inf, np.float32)), ("later", later)):
            rows.append(time_topk(rng, dev, s, run_s, f"merge_{part}_M{m}_K{k}", smi,
                                  caller="merge_topk(fused=True)"))
    for k in (80, 256):
        m, c = 128, 256
        s = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
        s[rng.random((m, c)) < 0.2] = np.inf
        run_s = np.sort(np.round(rng.uniform(0, 100, size=(m, k))), axis=1).astype(np.float32)
        rows.append(time_topk(rng, dev, s, run_s, f"ring_M{m}_K{k}", smi))
    return rows


def serve_engine(dev, smi, index, ds, q_all, sizes):
    """Phase 5: ``HarmonyServer`` over the mutable segmented data plane
    (the SIFT1M-shaped index as segment 0). Returns the kernel launches of
    its path (counts set to 0 just before it)."""
    import numpy as np
    import torch

    from repro_torch.core import SegmentedIndex
    from repro_torch.data import make_dataset, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.serve import ExecutorConfig, HarmonyServer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(4)
    nb = index.nb
    fresh = make_dataset(nb=7_000, dim=128, n_components=256, spread=0.6, seed=2).x
    data = SegmentedIndex.from_static(index)
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig())
    log(phase="serve_engine_setup", seconds=time.perf_counter() - t_phase,
        plan=[srv.plan.v_shards, srv.plan.d_blocks])

    def near(rows, noise):
        return (ds.x[rows] + noise * rng.standard_normal((len(rows), 128))).astype(np.float32)

    deleted = set()

    def burst(tag, fresh_ids, fresh_x, overwrite_ids, overwrite_x, delete_ids):
        t0 = time.perf_counter()
        srv.upsert(fresh_ids, fresh_x)
        srv.upsert(overwrite_ids, overwrite_x)
        removed = srv.delete(delete_ids)
        deleted.difference_update(np.concatenate([fresh_ids, overwrite_ids]).tolist())
        deleted.update(np.asarray(delete_ids).tolist())
        log(phase="serve_engine_writes", burst=tag, upserts=len(fresh_ids) + len(overwrite_ids),
            deletes=len(delete_ids), deleted_live=removed, seconds=time.perf_counter() - t0,
            segments=data.n_segments, delta_live=data.delta_len, nb_live=data.nb_live)

    def serve_batches(tag, n_parts):
        lo = 0
        for n in sizes:
            q = q_all[lo:lo + n]
            exec_wall = executors_wall(srv)
            before = ops.launch_counts()
            with RingTopkLaunches() as ring:
                res = srv.search_batch(q)
            after = ops.launch_counts()
            exec_wall = executors_wall(srv) - exec_wall
            launches = {k: after[k] - before[k] for k in after}
            merge = launches["running_topk_update"] - ring.ring
            want_s, want_i = engine_oracle(dev, data.snapshot(), q, 10)
            assert_topk_matches(res.scores, res.ids, want_s, want_i, f"serve_engine {tag} nq={n}")
            assert not np.isin(res.ids, list(deleted)).any(), f"{tag}: a deleted id came back"
            assert merge == n_parts, f"{tag} nq={n}: {merge} merge launches for {n_parts} parts"
            assert res.stats["segments"] == n_parts - 1
            log(phase="serve_engine", burst=tag, nq=n, wall_ms=res.stats["wall_s"] * 1e3,
                executors_wall_ms=exec_wall * 1e3,
                server_overhead_ms=(res.stats["wall_s"] - exec_wall) * 1e3,
                parts=n_parts, ring_topk_launches=ring.ring, merge_topk_launches=merge,
                launches=launches, delta_candidates=res.stats["delta_candidates"],
                summary={k: v for k, v in srv.stats.summary().items() if v})
            lo += n

    ops.reset_launch_counts()
    # 1. burst A: fresh ids, overwrites near corpus rows (and one near each
    # query, so every query's top-10 meets the delta), deletes incl. fresh ids
    fresh_a = np.arange(nb, nb + 5_000)
    nq_all = q_all.shape[0]
    over_a = rng.choice(nb, size=5_000, replace=False)
    over_x = near(rng.choice(nb, size=5_000), 0.05)
    over_x[:nq_all] = q_all + 0.01 * rng.standard_normal(q_all.shape).astype(np.float32)
    keep = np.setdiff1d(np.arange(nb), over_a)
    del_a = np.concatenate([rng.choice(keep, size=4_500, replace=False),
                            rng.choice(fresh_a, size=500, replace=False)])
    burst("A", fresh_a, fresh[:5_000], over_a, over_x, del_a)
    serve_batches("A", n_parts=2)
    # 2. seal the delta (a second sealed segment), then burst B
    t0 = time.perf_counter()
    data.compact_inline()
    log(phase="serve_engine_seal", seconds=time.perf_counter() - t0,
        segments=[s.nb for s in data.segments], generation=data.generation)
    fresh_b = np.arange(2 * nb, 2 * nb + 1_000)
    live_a = np.setdiff1d(np.concatenate([fresh_a, over_a]), del_a)
    over_b = np.concatenate([rng.choice(live_a, size=500, replace=False),
                             rng.choice(keep, size=500, replace=False)])
    keep_b = np.setdiff1d(np.concatenate([keep, live_a]), over_b)
    del_b = np.concatenate([rng.choice(keep_b, size=900, replace=False),
                            rng.choice(fresh_b, size=100, replace=False)])
    burst("B", fresh_b, fresh[5_000:6_000], over_b, near(rng.choice(nb, size=1_000), 0.05),
          del_b)
    serve_batches("B", n_parts=3)
    assert srv.stats.generation_swaps == 1 and srv.generation == 1

    # 3. int8 server on the same data: k = 10, and k = 20 (K' = 80)
    q128 = q_all[sum(sizes[:3]):sum(sizes[:3]) + 128]
    t0 = time.perf_counter()
    srv8 = HarmonyServer(data, n_nodes=4, backend="spmd", precision="int8",
                         executor_cfg=ExecutorConfig())
    setup8 = time.perf_counter() - t0
    live_ids, live_x = data.live_vectors()
    res8_by_k, res32_by_k = {}, {}
    for k in (10, 20):
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res8 = srv8.search_batch(q128, k=k)
        after = ops.launch_counts()
        res32 = srv.search_batch(q128, k=k)
        ids = res8.ids
        assert (ids >= 0).all(), "int8: a row came back short of k"
        assert all(len(set(r.tolist())) == k for r in ids), "int8: repeated id"
        pos = np.searchsorted(live_ids, ids)
        assert np.array_equal(live_ids[np.clip(pos, 0, live_ids.size - 1)], ids), \
            "int8: an id that is not live"
        xv = torch.as_tensor(live_x[pos]).to(dev).double()
        qd = torch.as_tensor(q128).to(dev).double()[:, None, :]
        exact = ((xv - qd) ** 2).sum(2).cpu().numpy()
        np.testing.assert_allclose(res8.scores, exact, rtol=1e-3, atol=1e-3)
        recall = recall_at_k(ids, res32.ids)
        assert recall >= 0.98, f"int8 server recall@{k} vs fp32 {recall}"
        res8_by_k[k], res32_by_k[k] = res8, res32
        log(phase="serve_engine_int8", nq=128, k=k, rerank_k=k * 4, setup_s=setup8,
            wall_ms=res8.stats["wall_s"] * 1e3, recall_vs_fp32_server=recall,
            ring_topk_launches=ring.ring,
            merge_topk_launches=after["running_topk_update"] - before["running_topk_update"]
            - ring.ring,
            launches={n: after[n] - before[n] for n in after})
    # a per-batch precision override: served by the segments' executors of
    # that precision (built on first use), equal to the other server's batch
    for srv_a, prec, k, want in ((srv, "int8", 20, res8_by_k[20]),
                                 (srv8, "fp32", 10, res32_by_k[10])):
        before = ops.launch_counts()
        res_o = srv_a.search_batch(q128, k=k, precision=prec)
        after = ops.launch_counts()
        assert_topk_matches(res_o.scores, res_o.ids, want.scores, want.ids,
                            f"precision override {prec}")
        dist = "int8_partial_distance_update" if prec == "int8" else "partial_distance_update"
        assert after[dist] > before[dist], f"override {prec}: no {dist} launch"
        assert all(prec in st.executors for st in srv_a._seg_states.values())
        log(phase="serve_engine_override", precision=prec, nq=128, k=k,
            wall_ms=res_o.stats["wall_s"] * 1e3,
            launches={n: after[n] - before[n] for n in after})
    assert all(st.corpus is None for s_ in (srv, srv8) for st in s_._seg_states.values()), \
        "the spmd backend built a host-engine layout"
    counts = ops.launch_counts()
    for name in ("partial_distance_update", "int8_partial_distance_update",
                 "running_topk_update"):
        assert counts[name] > 0, f"serve_engine: {name} never launched"
    for name in ("partial_distance_update_ref", "int8_partial_distance_update_ref",
                 "running_topk_ref"):
        assert counts[name] == 0, f"serve_engine: the plain {name} ran"
    del srv8
    torch.cuda.empty_cache()

    # 4. the host backend (harmony_search and the host merge): no kernel
    q8 = q_all[1:9]
    res_s = srv.search_batch(q8)
    before = ops.launch_counts()
    res_h = srv.search_batch(q8, backend="host")
    after = ops.launch_counts()
    assert all(after[n] == before[n] for n in after), "the host backend launched a kernel"
    assert_topk_matches(res_h.scores, res_h.ids, res_s.scores, res_s.ids, "host vs spmd")
    log(phase="serve_engine_host", nq=8, wall_ms=res_h.stats["wall_s"] * 1e3,
        spmd_wall_ms=res_s.stats["wall_s"] * 1e3)

    # 5. an int64 id: served first at distance 0, on the card, in the delta
    # (the merge carries columns) and once sealed (the ring carries rows)
    big = 3_000_000_000
    vec = q_all[:1] + 0.5
    srv.upsert([big], vec)
    for where in ("delta", "sealed"):
        if where == "sealed":
            data.compact_inline()
        n_parts = data.n_segments + (data.delta_len > 0)
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res = srv.search_batch(vec)
        after = ops.launch_counts()
        merge = after["running_topk_update"] - before["running_topk_update"] - ring.ring
        assert int(res.ids[0, 0]) == big and abs(float(res.scores[0, 0])) <= 1e-3, \
            f"int64 id ({where}): {res.ids[0]} {res.scores[0]}"
        assert ring.ring > 0 and merge == n_parts, \
            f"int64 id ({where}): ring {ring.ring}, merge {merge} for {n_parts} parts"
        log(phase="serve_engine_int64", id=big, where=where, score=float(res.scores[0, 0]),
            parts=n_parts, ring_topk_launches=ring.ring, merge_topk_launches=merge)
    sealed = srv._seg_states[max(srv._seg_states)]
    assert big in sealed.segment.index.ids and sealed.executors and sealed.corpus is None
    counts = ops.launch_counts()
    log(phase="serve_engine_path", seconds=time.perf_counter() - t_phase, counts=counts,
        summary={k: v for k, v in srv.stats.summary().items() if v})
    assert counts["running_topk_ref"] == 0 and counts["partial_distance_update_ref"] == 0
    del srv
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not port_on_path():
        return 3
    import numpy as np

    from repro_torch._device import resolve_device
    from repro_torch.config import HarmonyConfig
    from repro_torch.core import assign_queries, build_ivf, search_oracle, two_stage_search
    from repro_torch.data import brute_force_topk, make_dataset, make_queries, recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.serve import ExecutorConfig, SpmdExecutor

    # the plain versions and the yardsticks in full fp32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    log(phase="env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=kind, count=torch.cuda.device_count())

    build_kernels()                                     # 1. build
    errs, _ = check_kernels(dev)                        # 2. kernels
    timed = time_kernels(dev, smi)

    # ---------------------------------------------------------- 3. serving
    nb, nlist, ncomp = 1_000_000, 1024, 256
    t0 = time.perf_counter()
    ds = make_dataset(nb=nb, dim=128, n_components=ncomp, spread=0.6, seed=0)
    sizes = (1, 8, 32, 128, 160)
    lo128 = sum(sizes[:3])                # where the 128-query batch starts
    q_all = make_queries(ds, nq=sum(sizes), skew=0.3, seed=1)
    t_data = time.perf_counter() - t0
    cfg = HarmonyConfig(dim=128, nlist=nlist, nprobe=16, topk=10)
    t0 = time.perf_counter()
    index = build_ivf(ds.x, cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = search_oracle(index, q_all)
    true_idx, _ = brute_force_topk(ds.x, q_all, 10)
    log(phase="index", nb=nb, dim=128, nlist=nlist, nprobe=16, topk=10,
        data_s=t_data, build_s=t_build, oracle_and_truth_s=time.perf_counter() - t0,
        resident_mb=index.x.numel() * 4 / 2 ** 20,
        oracle_recall_at_10=recall_at_k(oracle.ids, true_idx))

    def check(res, lo, hi):
        want_s, want_i = oracle.scores[lo:hi], oracle.ids[lo:hi]
        finite = np.isfinite(want_s)
        assert res.scores.shape == want_s.shape and res.ids.dtype == np.int64
        assert np.array_equal(np.isfinite(res.scores), finite), "valid pattern differs"
        np.testing.assert_allclose(res.scores[finite], want_s[finite], rtol=1e-3, atol=1e-3)
        diff = (res.ids != want_i) & finite
        for r in np.unique(np.nonzero(diff)[0]):
            assert np.allclose(np.sort(res.scores[r]), np.sort(want_s[r]),
                               rtol=1e-3, atol=1e-3), (res.ids[r], want_i[r])

    def profile_128(ex, mesh, walls, precision):
        """Where the time of one 128-query batch goes: device busy share."""
        before = ops.launch_counts()["running_topk_update"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = ex.search_batch(q_all[lo128:lo128 + 128])
        topk_launches = ops.launch_counts()["running_topk_update"] - before
        busy_us = {}      # device kernels only (an aten op repeats its kernels' time)
        topk_us, topk_events = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                busy_us[ev.key[:60]] = ev.self_device_time_total
                if "topk_update_kernel" in ev.key:
                    topk_us += ev.self_device_time_total
                    topk_events += ev.count
        wall_us = walls[128]             # the same batch, unprofiled
        top = sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]
        log(phase="profile", mesh=f"{mesh[0]}x{mesh[1]}", precision=precision,
            nq=128, wall_ms=wall_us / 1e3, profiled_wall_ms=res.stats["wall_s"] * 1e3,
            device_busy_ms=sum(busy_us.values()) / 1e3,
            device_idle_share=(1 - sum(busy_us.values()) / wall_us
                               if busy_us else "not measured"),
            topk_kernel_ms=topk_us / 1e3, topk_launches=topk_launches,
            topk_kernel_events=topk_events,
            topk_ms_per_launch=(topk_us / 1e3 / topk_events if topk_events
                                else "not measured"),
            top_device_us=dict(top))

    served = {"partial_distance_update": 0, "int8_partial_distance_update": 0,
              "running_topk_update": 0}
    splits = {}               # (tier, mesh, M, K) → survivor histogram
    for mesh in ((1, 1), (2, 2)):
        mb_before = torch.cuda.memory_allocated() / 2 ** 20
        ex = SpmdExecutor(index, ExecutorConfig(d_blocks=mesh[1]), mesh=mesh)
        executor_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb_before
        ops.reset_launch_counts()
        t_mesh = time.perf_counter()
        lo, walls = 0, {}
        for n in sizes:
            before = ops.launch_counts()
            res = ex.search_batch(q_all[lo:lo + n])
            after = ops.launch_counts()
            walls[n] = res.stats["wall_s"] * 1e6
            check(res, lo, lo + n)
            log(phase="serve", mesh=f"{mesh[0]}x{mesh[1]}", nq=n,
                wall_ms=res.stats["wall_s"] * 1e3, buckets=res.stats["buckets"],
                splits=res.stats["splits"],
                tile_skip_frac=res.stats["tile_skipped"] / max(res.stats["tile_total"], 1),
                recall_at_10=recall_at_k(res.ids, true_idx[lo:lo + n]),
                launches={k: after[k] - before[k] for k in after})
            lo += n
        counts = ops.launch_counts()
        log(phase="serve_path", mesh=f"{mesh[0]}x{mesh[1]}",
            seconds=time.perf_counter() - t_mesh, counts=counts,
            executor_resident_mb=executor_mb,
            summary=ex.stats_summary())
        assert counts["partial_distance_update"] > 0, "distance kernel never launched"
        assert counts["running_topk_update"] > 0, "top-K kernel never launched"
        assert counts["int8_partial_distance_update"] == 0, "int8 kernel ran on fp32"
        assert counts["partial_distance_update_ref"] == 0, "plain distance ran"
        assert counts["running_topk_ref"] == 0, "plain top-K ran"
        for k in served:
            served[k] += counts[k]
        profile_128(ex, mesh, walls, "fp32")
        split, hist = survivor_split(ex, q_all[lo128:lo128 + 128], 10)
        splits[("fp32", f"{mesh[0]}x{mesh[1]}", 128 // mesh[1], 10)] = hist
        log(phase="topk_survivors", mesh=f"{mesh[0]}x{mesh[1]}", precision="fp32",
            nq=128, K=10, **split)
        del ex
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- 4. serving, int8
    order = np.argsort(index.ids, kind="stable")
    sorted_ids = index.ids[order]

    def packed_rows(ids):
        return order[np.searchsorted(sorted_ids, ids)]

    def check_int8(ids, scores, ts, quant, kp):
        """Each row: (1) every score is the fp32 distance of its id (float64
        on the card) and ids are distinct; (2) the row equals
        ``two_stage_search``'s, or its sorted scores agree (an fp32 tie), or
        every id in the symmetric difference is a stage-1 boundary tie (its
        quantized score within 1e-4·(1+|t|) of the row's K'-th quantized
        score t over its probed rows) or no better than the other side's
        k-th fp32 score (displaced by such a tie). Returns how many rows
        each rule settled."""
        ok = ids >= 0
        assert ok.all(), "int8: a row came back short of k"
        rows = torch.as_tensor(packed_rows(ids)).to(dev)
        x64 = index.x[rows].double()
        q64 = torch.as_tensor(q_all).to(dev).double()[:, None, :]
        exact = ((x64 - q64) ** 2).sum(2).cpu().numpy()
        np.testing.assert_allclose(scores, exact, rtol=1e-3, atol=1e-3)
        assert all(len(set(r.tolist())) == len(r) for r in ids), "int8: repeated id"
        settled = {"equal": 0, "fp32_tie": 0, "stage1_tie": 0}
        for r in range(len(ids)):
            if np.array_equal(ids[r], ts.ids[r]):
                settled["equal"] += 1
                continue
            if np.allclose(np.sort(scores[r]), np.sort(ts.scores[r]), rtol=1e-3, atol=1e-3):
                settled["fp32_tie"] += 1
                continue
            probed = np.concatenate([np.arange(*index.cluster_rows(int(c)))
                                     for c in assign_queries(index, q_all[r:r + 1])[0]])
            qc = quant.encode(q_all[r:r + 1])
            t8 = np.sort(quant.scores(qc, rows=probed)[0])[kp - 1]
            mine, theirs = set(ids[r].tolist()), set(ts.ids[r].tolist())
            for e in mine ^ theirs:
                s8 = quant.scores(qc, rows=packed_rows(np.array([e])))[0, 0]
                if abs(s8 - t8) <= 1e-4 * (1 + abs(t8)):
                    continue
                own, other = ((scores[r], ts.scores[r]) if e in mine
                              else (ts.scores[r], scores[r]))
                row_ids = ids[r] if e in mine else ts.ids[r]
                d_e = own[list(row_ids).index(e)]
                assert d_e >= other[-1] - 1e-3 * (1 + abs(other[-1])), (
                    f"int8 row {r}: id {e} differs from two_stage_search "
                    f"beyond a tie ({ids[r]} vs {ts.ids[r]})")
            settled["stage1_tie"] += 1
        return settled

    for mesh in ((1, 1), (2, 2)):
        B = mesh[1]
        mb_before = torch.cuda.memory_allocated() / 2 ** 20
        t_ex = time.perf_counter()
        ex = SpmdExecutor(index, ExecutorConfig(d_blocks=B, precision="int8"), mesh=mesh)
        executor_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb_before
        setup_s = time.perf_counter() - t_ex
        ops.reset_launch_counts()
        t_mesh = time.perf_counter()
        lo, walls, parts = 0, {}, []
        for n in sizes:
            before = ops.launch_counts()
            res = ex.search_batch(q_all[lo:lo + n])
            after = ops.launch_counts()
            walls[n] = res.stats["wall_s"] * 1e6
            assert res.stats["precision"] == "int8" and res.stats["rerank_k"] == 40
            parts.append(res)
            log(phase="serve_int8", mesh=f"{mesh[0]}x{mesh[1]}", nq=n,
                wall_ms=res.stats["wall_s"] * 1e3, buckets=res.stats["buckets"],
                splits=res.stats["splits"], rerank_k=res.stats["rerank_k"],
                tile_skip_frac=res.stats["tile_skipped"] / max(res.stats["tile_total"], 1),
                recall_at_10=recall_at_k(res.ids, true_idx[lo:lo + n]),
                launches={k: after[k] - before[k] for k in after})
            lo += n
        counts = ops.launch_counts()
        serve_s = time.perf_counter() - t_mesh
        assert counts["int8_partial_distance_update"] > 0, "int8 kernel never launched"
        assert counts["running_topk_update"] > 0, "top-K kernel never launched"
        assert counts["partial_distance_update"] == 0, "fp32 distance ran on int8"
        assert counts["int8_partial_distance_update_ref"] == 0, "plain int8 distance ran"
        assert counts["partial_distance_update_ref"] == 0, "plain distance ran"
        assert counts["running_topk_ref"] == 0, "plain top-K ran"
        for k in served:
            served[k] += counts[k]
        ids = np.concatenate([p.ids for p in parts])
        scores = np.concatenate([p.scores for p in parts])
        t0 = time.perf_counter()
        ts = two_stage_search(index, q_all, quant_blocks=B)
        settled = check_int8(ids, scores, ts, index.int8_quant(B), ts.stats["rerank_k"])
        recall_fp32 = recall_at_k(ids, oracle.ids)
        assert recall_fp32 >= 0.98, f"int8 recall@10 vs fp32 {recall_fp32}"
        log(phase="serve_path_int8", mesh=f"{mesh[0]}x{mesh[1]}", setup_s=setup_s,
            seconds=serve_s, check_s=time.perf_counter() - t0, counts=counts,
            executor_resident_mb=executor_mb,
            index_rows_mb=index.x.numel() * 4 / 2 ** 20,
            recall_at_10_vs_fp32_oracle=recall_fp32,
            recall_at_10_vs_truth=recall_at_k(ids, true_idx),
            rows_vs_two_stage=settled, summary=ex.stats_summary())
        profile_128(ex, mesh, walls, "int8")
        split, hist = survivor_split(ex, q_all[lo128:lo128 + 128], 40)
        splits[("int8", f"{mesh[0]}x{mesh[1]}", 128 // B, 40)] = hist
        log(phase="topk_survivors", mesh=f"{mesh[0]}x{mesh[1]}", precision="int8",
            nq=128, K=40, **split)
        del ex
        torch.cuda.empty_cache()

    time_topk_path_shaped(dev, smi, splits)

    # ---------------------------------------------------------- 5. serve_engine
    counts = serve_engine(dev, smi, index, ds, q_all, sizes)
    for k in served:
        served[k] += counts[k]
    time_merge_shapes(dev, smi)

    # ---------------------------------------------------------- 6. report
    sources = {
        "partial_distance_update": ("src/repro_torch/kernels/csrc/partial_distance.cu",
                                    "src/repro/kernels/distance.py:127"),
        "int8_partial_distance_update": (
            "src/repro_torch/kernels/csrc/partial_distance_int8.cu",
            "src/repro/kernels/distance_int8.py:139"),
        "running_topk_update": ("src/repro_torch/kernels/csrc/topk_update.cu",
                                "src/repro/kernels/topk_update.py:93"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served[name], max_abs_err=errs[name], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
