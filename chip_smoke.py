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
2b. The τ prewarm kernel (``prewarm_kernel``) at the served cells'
   shapes: NQ 8,000 queries, 16 probes, 4 samples a list, nlist 1024,
   D 128 and 960, f32 and bf16 rows, through executors at ``d_blocks`` 1
   and 4 over a small index of those lists. τ0 of the card route must lie
   within ``2 (D + 3) 2^-24 (‖q‖² + max ‖x‖²)`` of the plain version's on
   the card (the same +inf), with repeated and -1 probes and tombstones
   too; the kernel, the plain version and the host route are timed
   (device ms by CUDA events), and one 8,000-query batch must launch the
   kernel once and the plain version never.
3. Serving, fp32: build a SIFT1M-shaped IVF index for the card (1M × 128
   fp32 rows, nlist 1024, nprobe 16, top-10; the k-means runs on the
   card, the rows stay in pinned host memory, and the card must hold
   under 5 % of their bytes before any executor is built) and serve
   batches of
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

4b. The whole-mesh step (``spmd_search``): one 128-query batch through
    ``build_spmd_inputs`` and ``make_spmd_search`` over
    ``VirtualMesh(data=2, model=2)`` (every row of both shards scanned in
    256-row chunks), fp32 and int8 (K' = 40 from τ0 = +inf, then an exact
    fp32 re-rank), each against the oracle rows (scores at 1e-3, ids but
    for ties); the tier's distance kernel and the top-K kernel launch.

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
   launches and probe selection's (``RingTopkLaunches``); probe selection
   runs on the card, one distance and one top-K launch per sealed segment
   of each unfiltered batch. Then an int8 server on the same data
   at k = 10 and k = 20 (K' = 80: exact fp32 scores, live distinct ids,
   recall ≥ 0.98 against the fp32 server), a per-batch precision override
   on each server (served by executors of that precision, equal to the
   other server's batch; no host-engine layout is ever built on spmd),
   the host backend on request (equal to the spmd batch, no kernel
   launched) and an int64 id (first at distance 0, on the card: in the
   delta, and once sealed). The top-K kernel is timed at the merge's
   shapes and at K = 80, 256 (``time_merge_shapes``).
6. Large k (``serve_engine_large_k``): on the plane phase 5 left, an fp32
   server at k = 300 and an int8 server at k = 100 (K' = 400), each
   against ``engine_oracle``, every launch above the route 1/2 boundary
   (K > 64) on the top-K kernel's route 2 (``running_topk_update_large_k``). Then k above 12288
   (``serve_engine_huge_k``): 8 queries at k = 12289 (fp32) and k = 3073
   (int8, K' = 12292) on route 3 (``running_topk_update_huge_k``).
7. bf16 rows (``serve_bf16``): an executor with ``x_dtype="bfloat16"`` on
   the 1×1 mesh against an exact oracle over the bf16-rounded corpus; it
   must hold under 0.6× the fp32 executor's device memory.
8. Filtered and hybrid (``serve_engine_filtered``): the index with seeded
   metadata (``u`` uniform, ~8-word texts) and a delta burst, 128-query
   batches under ``NumRange("u", 0, 0.5)`` and ``NumRange("u", 0, 0.02)``
   (nprobe widened 4×), each also with ``hybrid_text``, against an oracle
   built from the definitions (``filtered_oracle``, ``bm25_topk_plain``,
   ``rrf_plain``); merge launches = parts, each bucket built once.
9. Host tier (``serve_engine_tiered``): the segment demoted by
   prepare / swap / adopt, three batches (the second prefetched, the
   third the second again without) equal to the device tier's bit for
   bit, then promoted back.

10. Durability (``durable``, ``durable_torn``), on the plane phases 5–6
    left: a WAL (``sync=True``) under ``build/``, a write burst, a
    checkpoint, a burst in the WAL only; a "crash" that drops the server
    and the plane (the card's memory must fall by the executors' rows),
    ``recover_segmented_index`` for the card (the recovered plane's rows
    stay on the host) and a fresh server, whose 128-query batch must equal the
    pre-crash batch bit for bit and ``engine_oracle``; then a write torn
    mid-record, a second crash and recovery, equal to the oracle of every
    write but the torn one.
11. The compactor (``compactor``) on the recovered plane: a seal
    (``delta_full``), a merge of every segment into one (the retired
    executors must be freed at the adopt), a crash at ``compactor.commit``
    rolled forward by ``recover()``, and a cycle on the background thread
    while batches are served; each step's batch against ``engine_oracle``.
12. Placement (``placement``): ``plan_placement`` at 25 % of the plane's
    ``segment_device_bytes``, ``apply_placement``; a batch bit-identical to
    the device tier's, and the memory report beside the card's memory: the
    card's memory must fall by at least the report's device bytes, and no
    row of a demoted segment stays on the card.

The kernel checks of phase 2 also hold the top-K kernel's route 2 (K in
{320, 512, 1024, 4096} × C in {256, 4096, 8192}, the merge at k = 300) and
route 3 (K in {12289, 16384, 20000} × C in {256, 4096, 12289}, and the
served shapes) bit for bit, each at the input kinds of ``mk_topk_branch``
(ascending candidates as the merge passes them, survivors at and one
above the one-warp cut, rows with no survivor beside full ones among
them), the merge's C = K in {300, 4096, 12289, 16384} at M in {1, 8, 128},
and K at the route 1/2 boundary and one above; and the distance kernel's
bf16-row route at the f32 route's rule; phase 2's timing covers every
route; every top-K shape checked or timed launches as
``topk_update.plan`` says (the source's ``topk_update_plan``). After
phase 4b the top-K kernel is also timed on path-shaped rows of the served
k = 300 and int8 k = 100 rings. Each of phases 3–22 resets the launch
counts before it and reads them after it.

13-16. The serving plane (``serve_plane``) on a plane of the index as one
    sealed segment (spmd executors, ``n_nodes=8``), with one 2048-request
    trace (``examples/serve_anns.py``'s: Poisson, skew 0.0 then 0.85 on
    4 % of the clusters) and its ``engine_oracle``: the scheduler at 0.7x
    and 1.5x the warm server's sustained rate with node 3 failed halfway,
    then ``HarmonyServer.serve`` on the 0.7x trace (``serve_sched``); the
    query cache over 512 requests with repeats, near-duplicates and an
    upsert burst (``serve_cache``); a two-replica fleet with a replica
    fault (``serve_fleet``); the live front-end over that fleet and over
    one replica, open loop on the wall clock (``serve_frontend``). Every
    row equals the oracle; each phase's counts are set to 0 before it.
17. ``python -m repro_torch.launch.serve`` at 1M rows in a subprocess
    (``launch``).
18. The LM substrate's serving path (``serve_lm``), which runs no
    hand-written kernel (its launch counts must stay 0). (a) In fp32 with
    TF32 off, at the published widths and reduced depth, each at
    rtol = atol = 1e-3 (``lm_fp32``): Qwen1.5-4B at 2 layers, the card's
    ``forward`` against the CPU's on the same params (2 × 64 tokens) and
    teacher-forced ``decode_step`` against the card's ``forward`` at every
    position; Gemma3-27B at 8 layers (one 5 + 1 unit and 2 tail locals,
    window 1024), decode against ``forward`` over 1088 positions, so the
    ring buffers wrap; Qwen2-VL-7B (M-RoPE patch positions) and
    HuBERT-XLarge (frames) at 2 layers, card against CPU. (b) Qwen1.5-4B at
    its published width and depth in bf16 from the seeded init: 8 prompts
    of 1024 tokens through ``prefill``, a 1152-position cache filled by
    teacher-forced decode over the prompts' first 256 tokens (its last
    logits against a prefill of those), 64 greedy steps with finite
    logits, 8 more under the profiler. One
    ``{"lm": ...}`` line: times, tokens/s, bytes, peak memory, the idle
    share and the bounds (prefill: 2 · N · tokens + attention over the
    989 TFLOP/s bf16 rate; a decode step: weights + attended KV over
    3.35 TB/s).
19. The MoE serving path (``serve_lm_moe``), dense and expert-parallel
    over ``VirtualMesh(data=ep)`` (one card, the ranks a tensor
    dimension); no hand-written kernel, launch counts 0. (a) OLMoE-1B-7B
    at its published width, 2 layers, fp32 (``lm_moe_fp32``): card
    against CPU through both paths (logits and aux), teacher-forced decode
    against ``forward``, each layer's EP at capacity 8 against its dense
    layer. (b) OLMoE-1B-7B as published, bf16: the ``lm`` run of phase 18
    through ``RunCtx()``, then ``VirtualMesh(8)`` at capacity 1.5: prefill
    with its dropped slots per layer, 8 decode steps held against the
    dense steps. (c) Kimi K2 at its published width, 1 layer, bf16 (19.4 B
    params): both paths' logits finite and equal where no slot dropped.
    One ``{"lm_moe": ...}`` line, with the bounds by path (prefill: expert
    rows E · B · S dense, E · cap_e on EP, B · S · k routed).
20. The recurrent families (``serve_lm_recurrent``); no hand-written
    kernel, launch counts 0. (a) xLSTM-1.3B at 8 layers (7 mLSTM + 1
    sLSTM) and Zamba2-2.7B at 6 (6 Mamba2 and the shared block), published
    widths, fp32 (``lm_recurrent_fp32``): card against CPU and decode
    against ``forward`` over 2 × 64 tokens in chunks of 16, at 1e-3 in
    units of the logits' RMS (at least 1; ``logit_scale``). (b) Each as
    published in bf16 (``lm_recurrent``): the ``lm`` run of phase 18 with
    the fill over the prompts' first 256 tokens, held against a prefill of
    those by ``recurrent_fill_rule`` (max |Δ| ≤ 0.2 in units of the
    logits' RMS, or the fill no further than 1.5× prefill's distance from
    the same weights' fp32 ``forward``; a row whose argmax moves must be a
    near tie); 8 steps at the end of a fresh 4224-position cache; one
    sLSTM layer's prefill time. One ``{"lm_recurrent": ...}`` line with
    the bounds (bf16 GEMMs at 989 TFLOP/s plus the f32 chunk work at 67;
    a step reads the weights and reads and writes the recurrent state).
21. The training path (``serve_lm_train``); no hand-written kernel, launch
    counts 0. (a) Qwen1.5-4B and OLMoE-1B-7B at 2 layers and xLSTM-1.3B
    at 8, published widths, fp32 with TF32 off (``train_fp32``): the
    card's ``loss_fn`` and every gradient leaf against the CPU's on the
    same params and 2 × 64 tokens, at 1e-3 in units of the leaf's max |g|
    (at least 1e-4 of the tree's); one AdamW and one Adafactor
    ``opt_update`` on the card against the CPU's from the same gradients
    (1e-5); μ after a step at 2 microbatches against 1. (b) Qwen1.5-4B as
    published in bf16 with AdamW and remat (``lm_train``): 2 warm-up, 8
    timed, 1 split in its halves and 2 profiled steps of ``train_loop``'s
    in-place step on
    ``TokenPipeline(151936, 1024, 4)``; finite losses and grad norms, the
    last 3 losses below the first; step time, tokens/s, peak memory
    beside its prediction, the idle share and the bound (4 × the prefill
    FLOPs at 989 TFLOP/s plus the optimizer's bytes at 3.35 TB/s). (c)
    ``python -m repro_torch.launch.train --arch qwen1.5-4b --smoke`` for 20
    steps, then 10 more resumed from its checkpoint (``train_launch``).
    One ``{"train": ...}`` line.
22. The analysis layer (``serve_dryrun``, ~30 s): (a) the dry run
    (``launch.dryrun.trace_cell``, on ``meta``, nothing allocated on the
    card, no launch) of the cells phases 18 and 21 ran: Qwen1.5-4B's bf16
    prefill at B = 8, S = 1024 and its AdamW train step at B = 4, S =
    1024; each bound equal to the one the phase logged (one code,
    ``launch.roofline``), each predicted peak within 10 % of the peak the
    phase measured (the timed prefill's own, ``prefill_peak_allocated_
    bytes``; the train phase's), the FLOPs counted beside ``lm_bounds``'.
    (b) The pod step: the SIFT1M-shaped index split into two super-shards
    of two vector shards, one 128-query batch through ``make_spmd_search``
    over ``VirtualMesh(data=2, model=2, pod=2)`` in fp32 and int8 (with
    phase 4b's re-rank) under the profiler, against the oracle rows; the
    tier's distance kernel and the top-K kernel launch, no plain version
    runs. (c) ``calibrate_hardware`` from phase 2's distance kernel, phase
    3's host ms a launch and a device-to-device copy; ``plan_cost`` of the
    1x1 and 2x2 plans under ``H100_SXM`` and the calibrated model beside
    phase 3's walls, the calibrated model ranking them as measured. One
    ``{"dryrun": ...}`` line.
23. Print the ``{"kernels": [...]}`` line (one entry per kernel route),
    then ``{"ok": true, ...}`` last.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TOL = 1e-4                    # the CPU tests' fp32 rule


def log(**kw):
    print(json.dumps(kw, default=float), flush=True)


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
    # K above 64 (route 2 above the boundary; K' = 80 is the int8 tier at k = 20),
    # and the served merge's shapes: M = nq, C = K = k
    branch_shapes += [(m, c, k) for k in (80, 128, 256) for c in (80, 256, 4096)
                      for m in ((130, 3) if c == 4096 else (130,))]
    branch_shapes += [(m, k, k) for m in (1, 8, 32, 128, 160) for k in (10, 20)]
    # route 2 (one CTA a row, the list in shared memory, C in windows of up
    # to 2048): the int8 ring at k = 100 (K' = 400) and beyond, up to
    # K = 4096 (int8 at k = 1024); C past one window; the served merge at
    # k = 300 (C = K = 300)
    big_shapes = [(130, c, k) for k in (320, 512, 1024, 4096) for c in (256, 4096, 8192)]
    big_shapes += [(m, 300, 300) for m in (1, 128)] + [(1, 8192, 4096), (128, 256, 400)]
    n_big = 0
    for m, c, k in branch_shapes + big_shapes:
        for kind in TOPK_KINDS:
            a = [t(v) for v in mk_topk_branch(rng, m, c, k, kind)]
            for ids in (a[1], a[1][0].expand(m, c)):
                gs, gi = topk_update.running_topk_update(a[0], ids, a[2], a[3], k=k)
                ws, wi = ref.running_topk_ref(a[0], ids, a[2], a[3], k=k)
                torch.cuda.synchronize()
                assert torch.equal(gs, ws) and torch.equal(gi, wi), \
                    f"running_topk differs at {(m, c, k, kind)}, ids stride {ids.stride(0)}"
            n_checked += 1
            n_big += topk_update.route(k) == 2
    errs["running_topk_update_large_k"] = 0.0
    # route 3 (K > 12288: tiles of output positions a CTA, the list in
    # global memory; above 2048 columns window runs merged in passes): the
    # served fp32 k = 12289 and int8 K' = 12292 and beyond, C within one
    # launch, past it, and at the served merge's C = K
    n_huge = 0
    huge_shapes = [(3, c, k) for k in (12289, 16384, 20000) for c in (256, 4096, 12289)]
    huge_shapes += [(8, 256, 12292), (8, 12289, 12289)]
    for m, c, k in huge_shapes:
        for kind in TOPK_KINDS:
            a = [t(v) for v in mk_topk_branch(rng, m, c, k, kind)]
            for ids in (a[1], a[1][0].expand(m, c)):
                gs, gi = topk_update.running_topk_update(a[0], ids, a[2], a[3], k=k)
                ws, wi = ref.running_topk_ref(a[0], ids, a[2], a[3], k=k)
                torch.cuda.synchronize()
                assert torch.equal(gs, ws) and torch.equal(gi, wi), \
                    f"running_topk route 3 differs at {(m, c, k, kind)}, ids stride {ids.stride(0)}"
            n_checked += 1
            n_huge += 1
    # the merge's C = K at M = 1, 8 and 128 on both routes (K = 300 and 4096
    # on route 2; 12289 and 16384 on route 3, where C > 2048 takes the
    # window-run-pass launches), and K at the route 1/2 boundary and one above
    cut = topk_update.WARP_MAX_K
    more = [(m, c, c) for m in (1, 8, 128) for c in (300, 4096, 12289, 16384)]
    more += [(128, c, k) for k in (cut, cut + 1) for c in (256, k)]
    # route 3 past one merge pass: 3 and 5 windows of 8192 columns (2 and 3
    # passes through the ping-pong runs), and two chunks of 2^18 columns
    # (the second merging into the list the first wrote, through a scratch)
    more += [(8, 20000, 20000), (3, 40000, 12289), (1, 300000, 12289)]
    for m, c, k in more:
        for kind in TOPK_KINDS:
            a = [t(v) for v in mk_topk_branch(rng, m, c, k, kind)]
            for ids in (a[1], a[1][0].expand(m, c)):
                gs, gi = topk_update.running_topk_update(a[0], ids, a[2], a[3], k=k)
                ws, wi = ref.running_topk_ref(a[0], ids, a[2], a[3], k=k)
                torch.cuda.synchronize()
                assert torch.equal(gs, ws) and torch.equal(gi, wi), \
                    f"running_topk differs at {(m, c, k, kind)}, ids stride {ids.stride(0)}"
            n_checked += 1
            n_big += topk_update.route(k) == 2
            n_huge += topk_update.route(k) == 3
    errs["running_topk_update_huge_k"] = 0.0
    # every top-K shape checked here launches as plan() says
    for m, c, k in branch_shapes + big_shapes + huge_shapes + more:
        assert topk_update.launched_plan(m, c, k) == topk_update.plan(m, c, k), (m, c, k)
    # bf16 rows at the ring's shapes (M = QG = 128 / 64 at Db = 128 / 64,
    # N = 256), with and without a dead tile, then ragged tiles, chunked and
    # unaligned contractions (the element-wise staging path); held at the
    # f32 route's rule, and counted where they are bit-equal too
    bf16_cases = [(m, 256, d, tiles, 128, dead) for m, d in ((128, 128), (64, 64))
                  for tiles in ((128, 128), (32, 64)) for dead in (True, False)]
    bf16_cases += [(m, 256, d, (128, 128), 128, True) for m in ring_ms for d in (32, 64, 128)]
    bf16_cases += [(130, 257, 96, (32, 64), 32, True), (130, 257, 96, (4, 100), 64, False),
                   (64, 256, 30, (128, 128), 128, True), (64, 256, 60, (4, 100), 20, True)]
    errs["partial_distance_update_bf16"] = 0.0
    bit_equal = 0
    for m, n, d, tiles, tk, dead in bf16_cases:
        for metric in ("l2", "ip"):
            x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
                dev).to(torch.bfloat16)
            xf = x.float()
            q = rng.normal(size=(m, d)).astype(np.float32)
            acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
            acc[rng.random((m, n)) < 0.3] = np.inf
            if dead:
                acc[:, 128:256] = np.inf
            tau = rng.uniform(d * 0.5, d * 3.0, size=(m,)).astype(np.float32)
            a = [x, (xf * xf).sum(1), t(q), t((q ** 2).sum(1)), t(acc), t(tau)]
            got, skip = distance.partial_distance_update(
                *a, metric=metric, tile_m=tiles[0], tile_n=tiles[1], tile_k=tk)
            want = ref.partial_distance_update_ref(*a, metric=metric, tile_k=tk)
            torch.cuda.synchronize()
            errs["partial_distance_update_bf16"] = max(
                errs["partial_distance_update_bf16"], dist_err(got, want, a[5]))
            assert torch.equal(skip, ops._tile_skip_map(a[4], *tiles)), \
                f"bf16 distance: skip map differs at {(m, n, d, tiles, tk)}"
            bit_equal += bool(torch.equal(got, want))
            n_checked += 1
    log(phase="kernels_checked", cases=n_checked, large_k_topk_cases=n_big,
        huge_k_topk_cases=n_huge,
        bf16_distance_cases=2 * len(bf16_cases), bf16_bit_equal=bit_equal,
        max_abs_err=errs)
    return errs, n_checked


TOPK_KINDS = ("path", "run_entries", "run_inf", "run_part", "windows", "ascending",
              "few", "mixed")
FEW_CUT = 32      # survivors one warp ranks alone (routes 2 and 3: no merge round)


def mk_topk_branch(rng, m, c, k, kind):
    """(scores, ids, run_s, run_i) as numpy arrays aimed at one branch of
    the top-K kernel. ``path``: rows in turn all +inf, one survivor below
    run_s[K-1], a few survivors beside entries equal to run_s[K-1], and only
    such equal entries (none enters). ``run_entries``: candidates copied
    from the row's run entries, the last one included, with +inf holes.
    ``run_inf`` / ``run_part``: a run all +inf or +inf from K/2 on, under an
    all-finite chunk. ``windows``: 300 distinct integer scores over the row,
    so equal scores fall in different 256-column windows. ``ascending``:
    each row's candidates ascending with a +inf tail, as the fused merge
    passes them, drawn from the run's 300 integer scores, so equal scores
    span windows and tiles and equal run entries; every other row's run all
    +inf (the merge's first part). ``few``: rows in turn with ``FEW_CUT``,
    ``FEW_CUT + 1`` and no survivor below run_s[K-1] (the rest at it or
    +inf). ``mixed``: rows with no survivor next to rows whose every
    candidate survives."""
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
    elif kind == "ascending":
        run_s = np.sort(rng.integers(0, 300, size=(m, k)), axis=1).astype(np.float32)
        s = rng.integers(0, 300, size=(m, c)).astype(np.float32)
        s[rng.random((m, c)) < 0.2] = np.inf
        s = np.sort(s, axis=1)
        run_s[::2] = np.inf
        run_i[::2] = -1
    elif kind == "few":
        s = np.where(rng.random((m, c)) < 0.5, thr, np.inf).astype(np.float32)
        for r in range(m):
            n = min(c, (FEW_CUT, FEW_CUT + 1, 0)[r % 3])
            cols = rng.choice(c, size=n, replace=False)
            s[r, cols] = np.floor(thr[r, 0] * rng.uniform(0, 0.999, size=n))
    elif kind == "mixed":
        s = (thr * rng.uniform(0, 0.999, size=(m, c))).astype(np.float32)
        s[::2] = np.where(rng.random((len(s[::2]), c)) < 0.5, thr[::2], np.inf)
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

    from repro_torch.kernels import distance, distance_int8, ops, ref, topk_update
    from repro_torch.launch.roofline import bound_ms, distance_launch, int8_distance_launch

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
        b, by = bound_ms(*distance_launch(m, 256, d, alive_tiles))
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
        b, by = bound_ms(*int8_distance_launch(m, 256, d, alive_tiles))
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
    # the bf16-row route at the ring's shapes; yardstick torch.addmm on the
    # rows already widened to f32
    for (m, d, label) in ((128, 128, "mesh1x1_qb128_bf16"), (64, 64, "mesh2x2_qb128_bf16")):
        xb = torch.from_numpy(rng.normal(size=(256, d)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        xw = xb.float()
        q = rng.normal(size=(m, d)).astype(np.float32)
        a = [xb, (xw * xw).sum(1), t(q), t((q ** 2).sum(1)),
             *acc_tau(m, 256, d * 0.5, d * 3.0)]
        alive_tiles = int((ops._tile_skip_map(a[4], 128, 128) == 0).sum())
        base = a[4] + a[3][:, None] + a[1][None, :]
        live = revive(a[4])
        (ms, call), (plain, plain_call), (lib, lib_call), (ms_live, _) = (
            time_ms(lambda: distance.partial_distance_update(*a)),
            time_ms(lambda: ref.partial_distance_update_ref(*a)),
            time_ms(lambda: torch.addmm(base, a[2], xw.T, alpha=-2)),
            time_ms(lambda: distance.partial_distance_update(*a[:4], live, a[5])))
        b, by = bound_ms(*distance_launch(m, 256, d, alive_tiles, row_bytes=2))
        row = dict(kernel="partial_distance_update_bf16", shape=label, M=m, N=256, Db=d,
                   ctas=distance.ctas(m, 256), kernel_ms=ms,
                   kernel_ms_all_alive=ms_live, plain_ms=plain, library_ms=lib,
                   library_call="torch.addmm on the rows widened to f32",
                   bound_ms=b, bound_by=by, kernel_call_ms=call,
                   plain_call_ms=plain_call, library_call_ms=lib_call, card=smi)
        log(**row)
        timed.setdefault("partial_distance_update_bf16", row)
    # route 2 of the top-K kernel at the served shapes: the int8 ring at
    # k = 100 (K' = 400), the fp32 ring at k = 300, the merge of a k = 300
    # batch (C = K = 300, ascending parts: an all-+inf list first, a full
    # one later), and K = 4096; route 3 (K > 12288) at M = 8 (the served
    # huge-k batch): C = 256 (the ring's chunk) at K = 16384 and the int8
    # K' = 12292, and the merge of a k = 12289 batch
    for (m, c, k, label, part) in ((128, 256, 400, "ring_int8_k100", None),
                                   (128, 256, 300, "ring_fp32_k300", None),
                                   (128, 300, 300, "merge_first_k300", "first"),
                                   (128, 300, 300, "merge_later_k300", "later"),
                                   (128, 4096, 4096, "K4096_C4096", None),
                                   (8, 256, 16384, "ring_K16384", None),
                                   (8, 256, 12292, "ring_int8_k3073", None),
                                   (8, 12289, 12289, "merge_first_k12289", "first"),
                                   (8, 12289, 12289, "merge_later_k12289", "later")):
        s, run_s = topk_dense(rng, m, c, k, part)
        row = time_topk(rng, dev, s, run_s, label, smi, route=topk_update.route(k))
        timed.setdefault({2: "running_topk_update_large_k",
                          3: "running_topk_update_huge_k"}[topk_update.route(k)], row)
    return timed


def prewarm_kernel(dev, smi, nq=8000, nlist=1024, nprobe=16, dims=(128, 960)):
    """The τ prewarm kernel (``csrc/tau_prewarm.cu``) at the served cells'
    shapes, through an executor's own sample table: checked against the
    plain version on the card, timed beside it and beside the host route,
    and one launch a served batch. Returns its first row (D 128, f32) with
    the largest errors over every row."""
    import numpy as np
    import torch

    from repro_torch.config import HarmonyConfig
    from repro_torch.core import assign_queries, build_ivf
    from repro_torch.core.pruning import prewarm_tau
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.serve import ExecutorConfig, SpmdExecutor

    rng = np.random.default_rng(31)
    first = None
    top = dict(max_abs_err=0.0, max_err_over_slack=0.0)   # over every row
    for d in dims:
        # lists of 0 to 9 rows around 1,024 centres: some hold fewer than
        # the 4 samples, some none
        cent = rng.normal(size=(nlist, d)).astype(np.float32)
        x = np.repeat(cent, rng.integers(0, 10, size=nlist), axis=0)
        x += 0.1 * rng.normal(size=x.shape).astype(np.float32)
        index = build_ivf(x, HarmonyConfig(dim=d, nlist=nlist, nprobe=nprobe, topk=10),
                          centers=cent, device=dev)
        q = (cent[rng.integers(0, nlist, size=nq)]
             + 0.3 * rng.normal(size=(nq, d))).astype(np.float32)
        probes = assign_queries(index, q).astype(np.int32)
        odd = probes.copy()                      # repeated and -1 probes
        odd[::3, 1] = odd[::3, 0]
        odd[::5, 2:4] = -1
        dead = rng.random(index.nb) < 0.3
        qn2 = (q.astype(np.float64) ** 2).sum(1)
        for x_dtype in ("float32", "bfloat16"):
            for B in (1, 4):
                ex = SpmdExecutor(index, ExecutorConfig(d_blocks=B, chunk=2048,
                                                        qb_buckets=(nq,), x_dtype=x_dtype),
                                  device=dev)
                smp = ex._samples
                rows_dtype = torch.bfloat16 if x_dtype == "bfloat16" else None
                xn2 = float((smp.table.double() ** 2).sum(1).max())
                slack = 2 * (d + 3) * 2.0 ** -24 * (qn2 + xn2)
                qt = torch.as_tensor(q).to(dev)
                worst = worst_abs = 0.0
                for pr, dr in ((probes, None), (odd, None), (probes, dead), (odd, dead)):
                    got = prewarm_tau(index, q, pr, 10, rows_dtype=rows_dtype, samples=smp,
                                      dead_rows=dr)
                    live = (None if dr is None
                            else torch.as_tensor(~dr[smp.rows]).to(dev))
                    want = ref.tau_prewarm_ref(smp.table, smp.offs, qt,
                                               torch.as_tensor(pr).to(dev), smp.s, 10,
                                               live).cpu().numpy()
                    assert np.array_equal(np.isinf(got), np.isinf(want)), "prewarm: +inf differs"
                    fin = np.isfinite(want)
                    err = np.abs(got - want.astype(np.float64))[fin]
                    assert (err <= slack[fin]).all(), ("prewarm beyond rounding",
                                                       float((err / slack[fin]).max()))
                    if fin.any():
                        worst = max(worst, float((err / slack[fin]).max()))
                        worst_abs = max(worst_abs, float(err.max()))
                pt = torch.as_tensor(probes).to(dev)
                args = (smp.table, smp.offs, qt, pt, smp.s, 10)
                (ms, call), (plain, plain_call) = (
                    time_ms(lambda: ops.tau_prewarm(*args), reps=20),
                    time_ms(lambda: ref.tau_prewarm_ref(*args), reps=5))
                host = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    prewarm_tau(index, q, probes, 10, rows_dtype=rows_dtype)
                    host.append((time.perf_counter() - t0) * 1e3)
                ops.reset_launch_counts()
                res = ex.search_batch(q)
                counts = ops.launch_counts()
                assert res.stats["splits"] == 1
                assert counts["tau_prewarm"] == 1, counts
                assert counts["tau_prewarm_ref"] == 0, counts
                row_bytes = smp.table.element_size()
                hbm = (smp.table.numel() * row_bytes + nq * d * 4 + nq * nprobe * 4
                       + nq * 4 + (nlist + 1) * 4)
                l2 = nq * nprobe * smp.s * d * row_bytes          # at most
                row = dict(kernel="tau_prewarm", D=d, x_dtype=x_dtype, d_blocks=B, NQ=nq,
                           P=nprobe, s=smp.s, table_rows=smp.table.shape[0], kernel_ms=ms,
                           kernel_call_ms=call, plain_ms=plain, plain_call_ms=plain_call,
                           host_route_ms=host, bound_ms=hbm / HBM_BW * 1e3, bound_by="bytes",
                           hbm_bytes=hbm, l2_read_bytes=l2, max_abs_err=worst_abs,
                           max_err_over_slack=worst,
                           launches_a_batch=counts["tau_prewarm"], card=smi)
                log(**row)
                first = first or row
                top = dict(max_abs_err=max(top["max_abs_err"], worst_abs),
                           max_err_over_slack=max(top["max_err_over_slack"], worst))
                del ex, smp
                torch.cuda.empty_cache()
    return {**first, **top}


def topk_dense(rng, m, c, k, part=None):
    """Scores [M, C] uniform on 0..100 with 20 % +inf and an ascending list
    [M, K] of rounded scores (numpy); ``part`` "first" / "later": the fused
    merge's parts, each row ascending, over an all-+inf or a full list."""
    import numpy as np

    s = rng.uniform(0, 100, size=(m, c)).astype(np.float32)
    s[rng.random((m, c)) < 0.2] = np.inf
    if part is not None:
        s = np.sort(s, axis=1)
    if part == "first":
        return s, np.full((m, k), np.inf, np.float32)
    return s, np.sort(np.round(rng.uniform(0, 100, size=(m, k))), axis=1).astype(np.float32)


def time_topk(rng, dev, s, run_s, label, smi, **extra):
    """Time the top-K kernel, its plain version and ``torch.topk`` of the
    [M, K+C] concatenation on scores ``s`` [M, C] and the ascending list
    ``run_s`` [M, K] (numpy), with one broadcast ids row as the ring
    passes it; check the kernel against the plain version there first."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref, topk_update
    from repro_torch.launch.roofline import bound_ms, topk_launch

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
    b, by = bound_ms(*topk_launch(m, c, k))
    name = {1: "running_topk_update", 2: "running_topk_update_large_k",
            3: "running_topk_update_huge_k"}[topk_update.route(k)]
    plan = topk_update.launched_plan(m, c, k)
    assert plan == topk_update.plan(m, c, k), (label, plan, topk_update.plan(m, c, k))
    row = dict(kernel=name, shape=label, M=m, C=c, K=k, ctas=plan.ctas,
               launches_per_call=plan.launches, **extra,
               kernel_ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
               kernel_call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
               card=smi)
    log(**row)
    return row


def survivor_split(ex, queries, k, k_search=None):
    """Serve ``queries`` once (at ``k_search``, the executor's default when
    None) with the ring's top-K call wrapped here, and count over its (row,
    launch) pairs how many candidates lie below the row's run_s[K-1] (the
    ring's K is ``k``): the survivors the kernel merges (it drops the rest
    after one vote). Returns the split and the histogram of the counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, topk_update

    hist = torch.zeros(ex.cfg.chunk + 1, dtype=torch.int64, device=ex.device)
    thr_inf = torch.zeros((), dtype=torch.int64, device=ex.device)
    wrapped = ops.running_topk_update

    def counting(scores, ids, run_s, run_i, **kw):
        n = (scores < run_s[:, -1:]).sum(1)
        hist.add_(torch.bincount(n, minlength=hist.numel()))
        thr_inf.add_(torch.isinf(run_s[:, -1]).sum())
        return wrapped(scores, ids, run_s, run_i, **kw)

    ops.running_topk_update = counting
    try:
        ex.search_batch(queries, **({} if k_search is None else {"k": k_search}))
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
    """Splits the kernel launches of served batches three ways: the top-K
    launches made inside ``SpmdExecutor.search_batch`` (the ring's), every
    launch made inside ``SpmdExecutor.select_probes`` (probe selection on
    the card, ``probe``, with ``selects`` its calls) and the rest (the
    merge's). A batch the executor splits counts once, at its outer call."""

    def __init__(self):
        from repro_torch.serve.executor import SpmdExecutor

        self.cls, self.orig = SpmdExecutor, SpmdExecutor.search_batch
        self.orig_select = SpmdExecutor.select_probes
        self.depth = self.ring = self.selects = 0
        self.probe = {}

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

        def select(ex, *a, **kw):
            before = ops.launch_counts()
            try:
                return self.orig_select(ex, *a, **kw)
            finally:
                after = ops.launch_counts()
                self.selects += 1
                for n in after:
                    self.probe[n] = self.probe.get(n, 0) + after[n] - before[n]

        self.cls.search_batch = wrapped
        self.cls.select_probes = select
        return self

    def __exit__(self, *exc):
        self.cls.search_batch = self.orig
        self.cls.select_probes = self.orig_select

    def outside_probes(self, before, after):
        """The launches between two ``ops.launch_counts()`` around the
        block, less probe selection's."""
        return {n: after[n] - before[n] - self.probe.get(n, 0) for n in after}

    def check_probes(self, n_segments, what):
        """Probe selection made on the card for each of ``n_segments``
        sealed segments (0 for a filtered batch, which keeps numpy's): one
        distance and one route-1 top-K launch each, and nothing else."""
        got = {n: c for n, c in self.probe.items() if c}
        want = ({"partial_distance_update": n_segments, "running_topk_update": n_segments}
                if n_segments else {})
        assert self.selects == n_segments and got == want, (
            f"{what}: {self.selects} probe selections for {n_segments} segments, "
            f"launches {got}")


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
            launches = ring.outside_probes(before, after)
            merge = launches["running_topk_update"] - ring.ring
            want_s, want_i = engine_oracle(dev, data.snapshot(), q, 10)
            assert_topk_matches(res.scores, res.ids, want_s, want_i, f"serve_engine {tag} nq={n}")
            assert not np.isin(res.ids, list(deleted)).any(), f"{tag}: a deleted id came back"
            assert merge == n_parts, f"{tag} nq={n}: {merge} merge launches for {n_parts} parts"
            assert res.stats["segments"] == n_parts - 1
            ring.check_probes(n_parts - 1, f"serve_engine {tag} nq={n}")
            log(phase="serve_engine", burst=tag, nq=n, wall_ms=res.stats["wall_s"] * 1e3,
                executors_wall_ms=exec_wall * 1e3,
                server_overhead_ms=(res.stats["wall_s"] - exec_wall) * 1e3,
                parts=n_parts, ring_topk_launches=ring.ring, merge_topk_launches=merge,
                probe_select_launches=ring.probe, launches=launches, delta_candidates=res.stats["delta_candidates"],
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
    res8_by_k, res32_by_k = {}, {}
    for k in (10, 20):
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res8 = srv8.search_batch(q128, k=k)
        after = ops.launch_counts()
        res32 = srv.search_batch(q128, k=k)
        check_int8_rows(dev, data, q128, res8, k)
        recall = recall_at_k(res8.ids, res32.ids)
        assert recall >= 0.98, f"int8 server recall@{k} vs fp32 {recall}"
        ring.check_probes(data.n_segments, f"serve_engine_int8 k={k}")
        res8_by_k[k], res32_by_k[k] = res8, res32
        launches = ring.outside_probes(before, after)
        log(phase="serve_engine_int8", nq=128, k=k, rerank_k=k * 4, setup_s=setup8,
            wall_ms=res8.stats["wall_s"] * 1e3, recall_vs_fp32_server=recall,
            ring_topk_launches=ring.ring,
            merge_topk_launches=launches["running_topk_update"] - ring.ring,
            probe_select_launches=ring.probe, launches=launches)
    # a per-batch precision override: served by the segments' executors of
    # that precision (built on first use), equal to the other server's batch
    for srv_a, prec, k, want in ((srv, "int8", 20, res8_by_k[20]),
                                 (srv8, "fp32", 10, res32_by_k[10])):
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res_o = srv_a.search_batch(q128, k=k, precision=prec)
        after = ops.launch_counts()
        assert_topk_matches(res_o.scores, res_o.ids, want.scores, want.ids,
                            f"precision override {prec}")
        launches = ring.outside_probes(before, after)
        dist = "int8_partial_distance_update" if prec == "int8" else "partial_distance_update"
        assert launches[dist] > 0, f"override {prec}: no {dist} launch"
        assert all(prec in st.executors for st in srv_a._seg_states.values())
        log(phase="serve_engine_override", precision=prec, nq=128, k=k,
            wall_ms=res_o.stats["wall_s"] * 1e3, probe_select_launches=ring.probe,
            launches=launches)
    assert all(st.corpus is None for s_ in (srv, srv8) for st in s_._seg_states.values()), \
        "the spmd backend built a host-engine layout"
    assert_path_on_kernels(ops.launch_counts(), (
        "partial_distance_update", "int8_partial_distance_update", "running_topk_update"),
        "serve_engine")
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
        merge = ring.outside_probes(before, after)["running_topk_update"] - ring.ring
        ring.check_probes(data.n_segments, f"int64 id ({where})")
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
    return counts, data


def assert_path_on_kernels(counts, kernels, what):
    """Every kernel of ``kernels`` launched, and no plain version ran."""
    for name in kernels:
        assert counts[name] > 0, f"{what}: {name} never launched"
    for name in ("partial_distance_update_ref", "int8_partial_distance_update_ref",
                 "running_topk_ref", "tau_prewarm_ref"):
        assert counts[name] == 0, f"{what}: the plain {name} ran"


def check_int8_rows(dev, data, q, res, k):
    """An int8 served batch: k live distinct ids a row, each scored with
    its exact fp32 distance (float64 on the card)."""
    import numpy as np
    import torch

    live_ids, live_x = data.live_vectors()
    ids = res.ids
    assert (ids >= 0).all(), "int8: a row came back short of k"
    assert all(len(set(r.tolist())) == k for r in ids), "int8: repeated id"
    pos = np.searchsorted(live_ids, ids)
    assert np.array_equal(live_ids[np.clip(pos, 0, live_ids.size - 1)], ids), \
        "int8: an id that is not live"
    xv = torch.as_tensor(live_x[pos]).to(dev).double()
    qd = torch.as_tensor(q).to(dev).double()[:, None, :]
    exact = ((xv - qd) ** 2).sum(2).cpu().numpy()
    np.testing.assert_allclose(res.scores, exact, rtol=1e-3, atol=1e-3)


def serve_large_k(dev, smi, data, q128):
    """Phase 6: k above 256 on the served path, the top-K kernel's route 2:
    an fp32 server at k = 300 (ring K = 300, merge C = K = 300) and an
    int8 server at k = 100 (ring K' = 400), on the plane ``serve_engine``
    left (three sealed segments and no delta). Returns the path's counts."""
    import numpy as np
    import torch

    from repro_torch.data import recall_at_k
    from repro_torch.kernels import ops, topk_update
    from repro_torch.serve import ExecutorConfig, HarmonyServer

    n_parts = data.n_segments + (data.delta_len > 0)
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig())
    srv8 = HarmonyServer(data, n_nodes=4, backend="spmd", precision="int8",
                         executor_cfg=ExecutorConfig())
    ops.reset_launch_counts()
    for srv_, prec, k in ((srv, "fp32", 300), (srv8, "int8", 100)):
        # the first batch also builds the server's executors
        first_ms = srv_.search_batch(q128, k=k).stats["wall_s"] * 1e3
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res = srv_.search_batch(q128, k=k)
        after = ops.launch_counts()
        launches = ring.outside_probes(before, after)
        merge = launches["running_topk_update"] - ring.ring
        ring.check_probes(data.n_segments, f"large k {prec}")
        want_s, want_i = engine_oracle(dev, data.snapshot(), q128, k)
        if prec == "fp32":
            assert_topk_matches(res.scores, res.ids, want_s, want_i, f"large k fp32 k={k}")
            recall = recall_at_k(res.ids, want_i)
            # the ring (K = 300) and the merge (K = C = 300) are all route 2
            assert launches["running_topk_update_large_k"] == launches["running_topk_update"], launches
        else:
            check_int8_rows(dev, data, q128, res, k)
            recall = recall_at_k(res.ids, want_i)
            assert recall >= 0.98, f"int8 k={k} recall@{k} vs the oracle {recall}"
            # the ring's K' = 400 is route 2; the merge's K = 100 is route 2
            # too above the route 1/2 boundary (topk_update.WARP_MAX_K)
            assert launches["running_topk_update_large_k"] == (
                launches["running_topk_update"] if topk_update.route(k) == 2 else ring.ring)
        assert merge == n_parts, f"large k {prec}: {merge} merge launches, {n_parts} parts"
        log(phase="serve_engine_large_k", precision=prec, nq=q128.shape[0], k=k,
            ring_k=k if prec == "fp32" else 4 * k, wall_ms=res.stats["wall_s"] * 1e3,
            first_batch_wall_ms=first_ms,
            recall_vs_oracle=recall, parts=n_parts, ring_topk_launches=ring.ring,
            merge_topk_launches=merge, probe_select_launches=ring.probe,
            launches=launches, card=smi)
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "int8_partial_distance_update",
                                    "running_topk_update", "running_topk_update_large_k"),
                           "serve_engine_large_k")
    del srv, srv8
    torch.cuda.empty_cache()
    return counts


def serve_huge_k(dev, smi, data, q8):
    """Phase 6b: k above 12288 on the served path, the top-K kernel's
    route 3: on the plane ``serve_engine`` left, an fp32 server at
    k = 12289 (every ring and merge launch on route 3) and an int8 server
    at k = 3073 (the 1M-row segment's ring at K' = 12292), 8 queries each,
    against ``engine_oracle``. Returns the path's counts."""
    import torch

    from repro_torch.data import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.serve import ExecutorConfig, HarmonyServer

    n_parts = data.n_segments + (data.delta_len > 0)
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig(),
                        device=dev)
    srv8 = HarmonyServer(data, n_nodes=4, backend="spmd", precision="int8",
                         executor_cfg=ExecutorConfig(), device=dev)
    ops.reset_launch_counts()
    for srv_, prec, k in ((srv, "fp32", 12289), (srv8, "int8", 3073)):
        before = ops.launch_counts()
        with RingTopkLaunches() as ring:
            res = srv_.search_batch(q8, k=k)         # the first batch: executor builds too
        after = ops.launch_counts()
        warm = srv_.search_batch(q8, k=k)
        launches = ring.outside_probes(before, after)
        merge = launches["running_topk_update"] - ring.ring
        ring.check_probes(data.n_segments, f"huge k {prec}")
        want_s, want_i = engine_oracle(dev, data.snapshot(), q8, k)
        recall = recall_at_k(res.ids, want_i)
        if prec == "fp32":
            assert_topk_matches(res.scores, res.ids, want_s, want_i, f"huge k fp32 k={k}")
            # the ring (K = 12289) and the merge (C = K = 12289): all route 3
            assert launches["running_topk_update_huge_k"] == launches["running_topk_update"], \
                launches
        else:
            check_int8_rows(dev, data, q8, res, k)
            assert recall >= 0.98, f"int8 k={k} recall@{k} vs the oracle {recall}"
            # the 1M-row segment's ring runs at K' = 12292: route 3
            assert launches["running_topk_update_huge_k"] > 0, launches
        assert np.array_equal(warm.ids, res.ids) and np.array_equal(warm.scores, res.scores)
        assert merge == n_parts, f"huge k {prec}: {merge} merge launches, {n_parts} parts"
        log(phase="serve_engine_huge_k", precision=prec, nq=q8.shape[0], k=k,
            ring_k=k if prec == "fp32" else 4 * k, wall_ms=warm.stats["wall_s"] * 1e3,
            first_batch_wall_ms=res.stats["wall_s"] * 1e3, recall_vs_oracle=recall,
            parts=n_parts, ring_topk_launches=ring.ring, merge_topk_launches=merge,
            probe_select_launches=ring.probe, launches=launches, card=smi)
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "int8_partial_distance_update",
                                    "running_topk_update", "running_topk_update_huge_k"),
                           "serve_engine_huge_k")
    del srv, srv8
    torch.cuda.empty_cache()
    return counts


def spmd_search(dev, smi, index, q, want_s, want_i, V=2, B=2, chunk=256, P=1,
                phase="spmd_search"):
    """Phase 4b (``spmd_search``): one query batch through the whole-mesh
    step the reference's ``examples/distributed_search.py`` drives:
    ``preassign`` on a load-aware plan, ``build_spmd_inputs`` (moved to the
    card, where the reference places them with ``input_shardings``) and
    ``make_spmd_search`` over ``VirtualMesh(data=V, model=B)``, which scans
    every row of each shard (no probe gather). fp32 from the prewarmed τ0;
    int8 as the example's ``--int8``: stage 1 keeps K' = k · rerank_factor
    from τ0 = +inf, an exact fp32 re-rank of those rows gives the top-k.
    Each is held against the oracle rows (``want_s``, ``want_i``) by the
    example's rule: finite scores at rtol = atol = 1e-3, ids except across
    ties. The tier's distance kernel and the top-K kernel must launch, no
    plain version may run. Returns (the launch counts, each tier's line).

    With ``P`` > 1 pods (phase 22b), the corpus is split into P
    super-shards of V vector shards (one load-aware plan of P · V shards,
    pod p owning shards p·V … p·V+V−1), packed by ``build_pod_inputs`` and
    searched over ``VirtualMesh(data=V, model=B, pod=P)``; the step runs
    under the profiler (its wall there and the card's idle share)."""
    import torch

    from repro_torch.core import PartitionPlan, assign_queries, preassign, prewarm_tau
    from repro_torch.core.pipeline import (CORPUS_OPERANDS, SpmdConfig, build_pod_inputs,
                                           build_spmd_inputs, make_spmd_search)
    from repro_torch.core.router import load_aware_assignment, ring_offsets
    from repro_torch.kernels import ops
    from repro_torch.virtual_mesh import VirtualMesh

    t_phase = time.perf_counter()
    k = want_s.shape[1]
    plan = PartitionPlan(v_shards=P * V, d_blocks=B,
                         cluster_to_shard=load_aware_assignment(index.sizes, None, P * V),
                         ring_offsets=ring_offsets(P * V, B))
    corpus = preassign(index, plan, pad_to=chunk)
    probes = assign_queries(index, q)
    x_host, xn_host = index.x.numpy(), index.xnorm2.cpu().numpy()
    order = np.argsort(index.ids, kind="stable")
    sids = index.ids[order]
    total, lines = {}, {}
    for precision in ("fp32", "int8"):
        int8 = precision == "int8"
        kp = k * index.cfg.rerank_factor if int8 else k
        scfg = SpmdConfig(v_shards=V, d_blocks=B, n_pods=P, qb=len(q), cap=corpus.cap,
                          dim=index.dim, nprobe=probes.shape[1], k=kp, chunk=chunk,
                          precision=precision)
        tau0 = (np.full((len(q),), np.inf, np.float32) if int8
                else prewarm_tau(index, q, probes, k, index.cfg.prewarm_samples))
        t0 = time.perf_counter()
        build = build_pod_inputs if P > 1 else build_spmd_inputs
        arrays = {n: a.to(dev) for n, a in
                  build(index, corpus, q, scfg, probes, tau0).items()}
        inputs_s = time.perf_counter() - t0
        step = make_spmd_search(scfg, VirtualMesh(V, model=B, pod=P))
        operands = [arrays[n] for n in CORPUS_OPERANDS]
        operands += [arrays["scale2"]] if int8 else []
        operands += [arrays["queries"], arrays["probes"], arrays["tau0"]]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        extra = {}
        if P > 1:
            (scores, ids, stats), busy_ms, wall_ms = profiled(lambda: step(*operands))
            wall_s = wall_ms / 1e3
            extra = dict(device_busy_ms=busy_ms, idle_share=idle_share(busy_ms, wall_ms),
                         wall_under_profiler=True)
        else:
            t0 = time.perf_counter()
            scores, ids, stats = step(*operands)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        dist, other = (("int8_partial_distance_update", "partial_distance_update") if int8
                       else ("partial_distance_update", "int8_partial_distance_update"))
        assert counts[dist] > 0 and counts["running_topk_update"] > 0, counts
        assert counts[other] == 0, counts
        assert not any(counts[n] for n in counts if n.endswith("_ref")), counts
        scores, ids, stats = scores.cpu().numpy(), ids.cpu().numpy(), stats.cpu().numpy()
        if int8:
            # stage 2: the exact fp32 re-rank of the K' survivors (the example's)
            valid = np.isfinite(scores) & (ids >= 0)
            rows = order[np.searchsorted(sids, np.where(valid, ids, sids[0]))]
            d = (np.sum(q * q, axis=1)[:, None]
                 - 2.0 * np.einsum("md,mkd->mk", q, x_host[rows]) + xn_host[rows])
            d = np.where(valid, d.astype(np.float32), np.inf)
            o = np.argsort(d, axis=1, kind="stable")[:, :k]
            scores, ids = np.take_along_axis(d, o, axis=1), np.take_along_axis(ids, o, axis=1)
            ids[~np.isfinite(scores)] = -1
        finite = np.isfinite(want_s)
        assert np.array_equal(np.isfinite(scores), finite), f"{precision}: valid pattern"
        np.testing.assert_allclose(scores[finite], want_s[finite], rtol=1e-3, atol=1e-3)
        tie_rows = 0
        for r in np.nonzero((ids.astype(np.int64) != want_i).any(axis=1))[0]:
            assert np.allclose(np.sort(scores[r]), np.sort(want_s[r]), rtol=1e-3, atol=1e-3), (
                f"{precision} row {r}: {ids[r]} vs {want_i[r]}")
            tie_rows += 1
        lines[precision] = dict(
            precision=precision, mesh=f"{P}x{V}x{B}" if P > 1 else f"{V}x{B}", nq=len(q),
            k=k, stage1_k=kp, cap=corpus.cap, chunk=chunk, inputs_s=inputs_s,
            wall_ms=wall_s * 1e3, tile_skip_frac=float(stats[0]) / max(int(stats[1]), 1),
            max_abs_err=float(np.abs(scores[finite] - want_s[finite]).max()),
            rows_differing_at_ties=tie_rows, launches=counts, **extra)
        log(phase=phase, **lines[precision], card=smi)
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        del arrays, operands
        torch.cuda.empty_cache()
    log(phase=f"{phase}_path", seconds=time.perf_counter() - t_phase, counts=total, card=smi)
    return total, lines


def device_mb():
    """The card's allocated MB, after the queued work."""
    import torch

    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2 ** 20


def near_rows(rng, ds, n, noise=0.05, queries=None):
    """n rows near random corpus rows; the first ones near ``queries``
    (every query's top-10 then meets them)."""
    rows = rng.integers(0, ds.nb, size=n)
    x = (ds.x[rows] + noise * rng.standard_normal((n, ds.x.shape[1]))).astype(np.float32)
    if queries is not None:
        m = min(n, len(queries))
        x[:m] = queries[:m] + 0.01 * rng.standard_normal((m, queries.shape[1]))
    return x


def live_sealed_ids(data, rng, n, below):
    """n distinct ids < ``below`` that are live in a sealed segment."""
    out = []
    for i in rng.permutation(below).tolist():
        if data.has(i):
            out.append(i)
            if len(out) == n:
                return np.array(out, np.int64)
    raise AssertionError("not enough live ids")


def serve_durable(dev, smi, holder, root, ds, q128):
    """Phase 10 (``durable``, ``durable_torn``) on the plane
    ``serve_engine`` left (``holder`` holds its only reference). A WAL
    (``sync=True``) is attached, a write burst lands, the plane is
    checkpointed, a second burst lands in the WAL only; a 128-query batch
    equals ``engine_oracle``. Then a "crash" drops the server and the plane
    (the card's memory must fall), ``recover_segmented_index`` rebuilds the
    plane on the card from the checkpoint and the WAL, and a fresh
    server's batch must equal the pre-crash batch bit for bit. Then a
    write torn mid-record by a power cut (``wal.append``, kind "torn"), a
    second crash and recovery: the result equals the oracle of every write
    but the torn one. Returns (counts, the recovered plane, its server,
    its WAL)."""
    import gc

    from repro_torch.checkpoint import (
        Checkpointer,
        WriteAheadLog,
        checkpoint_segmented_index,
        recover_segmented_index,
    )
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import FaultSpec, InjectedFault, fault_scope
    from repro_torch.serve import ExecutorConfig, HarmonyServer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)
    data = holder.pop()
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig(),
                        device=dev)
    ops.reset_launch_counts()
    wal_dir, ckpt = root / "wal", Checkpointer(root / "ckpt", keep=2)
    wal = WriteAheadLog(wal_dir, sync=True)
    data.attach_wal(wal)
    records = []                  # (ms, rows) per write call: one WAL record each

    def write(kind, ids, vecs=None):
        t0 = time.perf_counter()
        if kind == "upsert":
            srv.upsert(ids, vecs)
        else:
            srv.delete(ids)
        records.append(((time.perf_counter() - t0) * 1e3, len(ids)))

    # burst C (before the checkpoint): fresh ids near the queries, overwrites
    # and deletes of live sealed ids, as a few large calls
    nb = ds.nb
    fresh_c = np.arange(4_000_000, 4_002_000)
    write("upsert", fresh_c, near_rows(rng, ds, 2_000, queries=q128))
    over_c = live_sealed_ids(data, rng, 1_000, nb)
    write("upsert", over_c, near_rows(rng, ds, 1_000))
    write("delete", live_sealed_ids(data, rng, 1_000, nb))
    t0 = time.perf_counter()
    path = checkpoint_segmented_index(ckpt, data, wal)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in path.iterdir())
    # burst D: in the WAL only
    fresh_d = np.arange(4_010_000, 4_011_000)
    write("upsert", fresh_d, near_rows(rng, ds, 1_000, queries=q128[64:]))
    write("upsert", np.concatenate([fresh_c[:250], live_sealed_ids(data, rng, 250, nb)]),
          near_rows(rng, ds, 500))
    write("delete", np.concatenate([fresh_c[250:500], live_sealed_ids(data, rng, 250, nb)]))
    acked_seq = data.wal_seq
    pre = srv.search_batch(q128)
    want_s, want_i = engine_oracle(dev, data.snapshot(), q128, 10)
    assert_topk_matches(pre.scores, pre.ids, want_s, want_i, "durable, before the crash")
    n_parts = data.n_segments + (data.delta_len > 0)

    # the crash: the process's plane and server go; the disk stays
    wal.close()
    rows_mb = sum(s.index.x.numel() * 4 for s in data.segments) / 2 ** 20
    mb_live = device_mb()
    del srv, data, wal
    gc.collect()
    mb_crashed = device_mb()
    # the executors' copies of the sealed rows go (the rows themselves are
    # host memory)
    assert mb_crashed < mb_live - 0.9 * rows_mb, f"the crash freed {mb_live - mb_crashed} MB"
    t0 = time.perf_counter()
    data, wal, report = recover_segmented_index(ckpt, wal_dir, sync=True, device=dev)
    mb_recovered_plane = device_mb()
    recover_s = time.perf_counter() - t0
    # the recovered plane holds its rows on the host: the card gets them
    # back with the executors, not with the plane
    assert mb_recovered_plane - mb_crashed < 0.05 * rows_mb, (mb_crashed, mb_recovered_plane)
    assert data.device == dev and all(s.index.device == dev and s.index.x.device.type == "cpu"
                                      for s in data.segments)
    assert report["replayed"] == 3 and not report["torn_tail"], report
    assert data.wal_seq == acked_seq
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig(),
                        device=dev)
    post = srv.search_batch(q128)
    assert np.array_equal(post.ids, pre.ids) and np.array_equal(post.scores, pre.scores), \
        "the recovered plane's batch differs from the pre-crash batch"
    want_s, want_i = engine_oracle(dev, data.snapshot(), q128, 10)
    assert_topk_matches(post.scores, post.ids, want_s, want_i, "durable, recovered")
    fsync_ms = [ms for ms, _ in records]
    log(phase="durable", nq=128, parts=n_parts, wal_records=len(records),
        rows_per_record=[n for _, n in records], ms_per_record=fsync_ms,
        ms_per_record_mean=float(np.mean(fsync_ms)),
        checkpoint_bytes=ckpt_bytes, checkpoint_s=ckpt_s, records_replayed=report["replayed"],
        recover_s=recover_s, first_batch_wall_ms=post.stats["wall_s"] * 1e3,
        pre_crash_wall_ms=pre.stats["wall_s"] * 1e3, device_mb_live=mb_live,
        device_mb_after_crash=mb_crashed, device_mb_recovered_plane=mb_recovered_plane,
        device_mb_recovered=device_mb(), rows_mb=rows_mb,
        seconds=time.perf_counter() - t_phase, card=smi)

    # durable_torn: a write torn mid-record by a power cut; recovery drops it
    t_phase = time.perf_counter()
    torn_ids = np.arange(4_020_000, 4_020_128)
    with fault_scope(FaultSpec("wal.append", kind="torn")) as plan:
        try:
            srv.upsert(torn_ids, (q128 + 1e-3).astype(np.float32))
            raise AssertionError("the torn write was acknowledged")
        except InjectedFault:
            pass
    assert plan.fired == 1
    wal.close()
    del srv, data, wal
    gc.collect()
    t0 = time.perf_counter()
    data, wal, report = recover_segmented_index(ckpt, wal_dir, sync=True, device=dev)
    recover_s = time.perf_counter() - t0
    assert report["torn_tail"] and report["replayed"] == 3, report
    assert data.wal_seq == acked_seq and not any(data.has(int(i)) for i in torn_ids)
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig(),
                        device=dev)
    res = srv.search_batch(q128)
    assert_topk_matches(res.scores, res.ids, want_s, want_i, "durable_torn")
    assert np.array_equal(res.ids, post.ids) and np.array_equal(res.scores, post.scores)
    log(phase="durable_torn", nq=128, torn_rows=len(torn_ids), torn_tail=report["torn_tail"],
        records_replayed=report["replayed"], recover_s=recover_s,
        wal_bytes=sum(p.stat().st_size for p in wal_dir.glob("wal_*.log")),
        first_batch_wall_ms=res.stats["wall_s"] * 1e3,
        seconds=time.perf_counter() - t_phase, card=smi)
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "durable")
    return counts, data, srv, wal


def serve_compactor(dev, smi, data, srv, ds, q128):
    """Phase 11 (``compactor``) on the recovered plane: ``Compactor`` seals
    the delta (``delta_full``), then merges every segment into one
    (``too_many_segments``): the retired segments' executors must go at the
    adopt, so the card's memory after the merge may not hold the old
    1M-row segment twice. Then a crash at ``compactor.commit`` rolled
    forward by ``recover()``, and a cycle on the background thread while
    the main thread serves. After each step a 128-query batch equals
    ``engine_oracle``. Returns the path's counts."""
    import weakref

    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import FaultSpec, InjectedFault, fault_scope
    from repro_torch.serve import CompactionConfig, Compactor

    rng = np.random.default_rng(7)
    ops.reset_launch_counts()
    comp = Compactor(data, srv, CompactionConfig(delta_threshold=1_000, max_segments=4,
                                                 max_dead_fraction=0.25, poll_s=0.05),
                     device=dev)
    next_id = [4_100_000]

    def burst(n):
        ids = np.arange(next_id[0], next_id[0] + n)
        next_id[0] += n
        srv.upsert(ids, near_rows(rng, ds, n, queries=q128[rng.integers(0, 128, 32)]))
        srv.delete(live_sealed_ids(data, rng, n // 10, ds.nb))

    def check(step, ev, extra=None):
        res = srv.search_batch(q128)
        want_s, want_i = engine_oracle(dev, data.snapshot(), q128, 10)
        assert_topk_matches(res.scores, res.ids, want_s, want_i, f"compactor {step}")
        assert srv.generation == data.generation
        log(phase="compactor", step=step, reason=ev.get("reason"),
            generation=data.generation, segments=[s.nb for s in data.segments],
            delta_live=data.delta_len,
            **{k: ev[k] for k in ("wall_s", "seal_s", "prepare_s", "commit_s", "adopt_s",
                                  "sealed_rows", "merged_segments", "new_segments")
               if k in ev},
            device_mb_after_adopt=device_mb(), batch_wall_ms=res.stats["wall_s"] * 1e3,
            **(extra or {}), card=smi)

    # 1. the delta is past the threshold: seal it into a fourth segment
    assert comp.should_compact() == "delta_full", comp.should_compact()
    ev = comp.maybe_compact()
    assert ev["reason"] == "delta_full" and data.n_segments == 4 and data.delta_len == 0
    check("delta_full", ev)
    # 2. a burst with four segments: merge everything into one
    burst(1_200)
    assert comp.should_compact() == "too_many_segments"
    old_execs = [weakref.ref(ex) for st in srv._seg_states.values()
                 for ex in st.executors.values()]
    old_rows_mb = sum(s.index.x.numel() * 4 for s in data.segments) / 2 ** 20
    mb_before = device_mb()
    ev = comp.maybe_compact()
    mb_after = device_mb()
    assert ev["merge_all"] and data.n_segments == 1 and data.delta_len == 0
    freed = all(r() is None for r in old_execs)
    # the old executors are gone: what is left is the new segment's, about
    # the same size (the rows of both planes are host memory)
    assert freed and mb_after < mb_before + 0.25 * old_rows_mb, (mb_before, mb_after)
    check("merge_all", ev, dict(device_mb_before=mb_before,
                                old_executors_freed=freed, old_rows_mb=old_rows_mb))
    # 3. a crash after the commit, before the replicas adopt; recover()
    # rolls forward
    burst(1_100)
    with fault_scope(FaultSpec("compactor.commit", kind="crash")) as plan:
        try:
            comp.maybe_compact()
            raise AssertionError("compactor.commit did not fire")
        except InjectedFault:
            pass
    assert plan.fired == 1 and srv.generation != data.generation
    report = comp.recover()
    assert not report["rolled_back"] and report["adopted"]
    check("commit_crash_recovered", {"reason": "recover"}, dict(report=report))
    # 4. the background thread seals a burst while this thread serves
    burst(1_100)
    n_events = len(comp.events)
    t0 = time.perf_counter()
    comp.start()
    served = 0
    try:
        while len(comp.events) == n_events and time.perf_counter() - t0 < 120:
            srv.search_batch(q128[:8])
            served += 1
    finally:
        assert comp.stop(timeout=60.0), "the compactor thread did not stop"
    assert not comp.errors, comp.errors
    assert len(comp.events) > n_events, "the background thread made no cycle in 120 s"
    check("background", comp.events[-1], dict(batches_served_meanwhile=served,
                                              thread_s=time.perf_counter() - t0))
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "compactor")
    return counts


def serve_placement(dev, smi, data, srv, q128):
    """Phase 12 (``placement``): ``plan_placement`` at a device budget of
    25 % of the plane's ``segment_device_bytes``, installed by
    ``apply_placement``; the memory report, the tiers and the fall of the
    card's memory are logged, and a batch must equal the device tier's
    bit for bit. Returns the path's counts."""
    from repro_torch.core import segment_device_bytes
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        PlacementConfig,
        apply_placement,
        device_bytes_by_segment,
        plan_placement,
    )

    ops.reset_launch_counts()
    hot = srv.search_batch(q128)
    costs = device_bytes_by_segment(data, "fp32")
    budget = int(0.25 * sum(costs.values()))
    tiers = plan_placement(data, PlacementConfig(device_budget_bytes=budget, precision="fp32"))
    assert "host" in tiers.values() and "device" in tiers.values(), tiers
    rep0 = data.memory_report()
    mb0 = device_mb()
    t0 = time.perf_counter()
    assert apply_placement(data, [srv], tiers)
    place_s = time.perf_counter() - t0
    mb1 = device_mb()
    rep1 = data.memory_report()
    res = srv.search_batch(q128)
    mb2 = device_mb()
    n_host = sum(t == "host" for t in tiers.values())
    assert res.stats["cold_segments"] == n_host
    assert np.array_equal(res.ids, hot.ids) and np.array_equal(res.scores, hot.scores), \
        "the placed plane's batch differs from the device tier's"
    host_rows_mb = sum(s.index.x.numel() * 4 for s in data.segments
                       if tiers[s.seg_id] == "host" and s.index.x.device.type == "cuda") / 2 ** 20
    report_drop_mb = (rep0["device_bytes"] - rep1["device_bytes"]) / 2 ** 20
    # no rows of a demoted segment stay on the card
    assert host_rows_mb == 0 and mb0 - mb1 >= report_drop_mb, (mb0 - mb1, report_drop_mb)
    log(phase="placement", budget_bytes=budget, costs=costs, tiers=tiers,
        memory_report_before=rep0, memory_report_after=rep1,
        report_device_drop_mb=report_drop_mb,
        measured_device_drop_mb=mb0 - mb1, measured_drop_after_a_batch_mb=mb0 - mb2,
        host_tier_index_rows_on_card_mb=host_rows_mb,
        host_segment_device_bytes_mb=sum(segment_device_bytes(s) for s in data.segments
                                         if tiers[s.seg_id] == "host") / 2 ** 20,
        apply_s=place_s, wall_ms=res.stats["wall_s"] * 1e3,
        device_tier_wall_ms=hot.stats["wall_s"] * 1e3,
        bytes_streamed=res.stats["bytes_streamed"], card=smi)
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "placement")
    return counts


def serve_bf16(dev, smi, index, q128, fp32_mb):
    """Phase 7: the executor over bf16 rows on the 1×1 mesh; its 128-query
    batch against an exact oracle over the bf16-rounded corpus, and its
    resident memory against the fp32 executor's (``fp32_mb``). Returns
    the path's counts."""
    import dataclasses

    import torch

    from repro_torch.core import search_oracle
    from repro_torch.data import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.serve import ExecutorConfig, SpmdExecutor

    mb0 = torch.cuda.memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    ex = SpmdExecutor(index, ExecutorConfig(d_blocks=1, x_dtype="bfloat16"), mesh=(1, 1))
    setup_s = time.perf_counter() - t0
    bf16_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb0
    ops.reset_launch_counts()
    res = ex.search_batch(q128)
    res = ex.search_batch(q128)                     # the second, warm batch
    counts = ops.launch_counts()
    rounded = dataclasses.replace(index, x=index.x.to(torch.bfloat16).float())
    want = search_oracle(rounded, q128)
    assert_topk_matches(res.scores, res.ids, want.scores, want.ids, "bf16 executor")
    f32 = search_oracle(index, q128)
    assert_path_on_kernels(counts, ("partial_distance_update_bf16", "running_topk_update"),
                           "serve_bf16")
    assert counts["partial_distance_update_bf16"] == counts["partial_distance_update"]
    assert bf16_mb < 0.6 * fp32_mb, f"bf16 executor holds {bf16_mb} MB, fp32 {fp32_mb}"
    log(phase="serve_bf16", mesh="1x1", nq=q128.shape[0], wall_ms=res.stats["wall_s"] * 1e3,
        setup_s=setup_s, executor_resident_mb=bf16_mb, fp32_executor_resident_mb=fp32_mb,
        recall_vs_rounded_oracle=recall_at_k(res.ids, want.ids),
        recall_vs_fp32_oracle=recall_at_k(res.ids, f32.ids),
        tile_skip_frac=res.stats["tile_skipped"] / max(res.stats["tile_total"], 1),
        counts=counts, card=smi)
    del ex, rounded
    torch.cuda.empty_cache()
    return counts


VOCAB = 4000          # the texts' seeded vocabulary: w0 .. w3999


def make_words(rng, n):
    """Word ids [n, 10] of ~8 words a row (6 to 10; -1 past a row's end)
    from the seeded vocabulary, and the texts they spell."""
    lens = rng.integers(6, 11, size=n)
    words = rng.integers(0, VOCAB, size=(n, 10))
    words[np.arange(10)[None, :] >= lens[:, None]] = -1
    vocab = [f"w{i}" for i in range(VOCAB)]
    texts = [" ".join([vocab[w] for w in row[:ln]])
             for row, ln in zip(words.tolist(), lens.tolist())]
    return words, texts


def bm25_topk_plain(words, terms, excluded, k, k1=1.5, b=0.75):
    """BM25 top-k rows of one row-aligned word-id table, in float64 from
    the word ids (no tokenizer, no postings): (scores, rows), the rows of
    equal scores in ascending order, excluded rows left out."""
    lens = (words >= 0).sum(1).astype(np.float64)
    n = words.shape[0]
    norm = 1.0 - b + b * lens / lens.mean()
    sc = np.zeros(n)
    for t in terms:
        tf = (words == t).sum(1).astype(np.float64)
        df = int((tf > 0).sum())
        if df == 0:
            continue
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        sc += idf * tf * (k1 + 1.0) / (tf + k1 * norm)
    sc[excluded] = 0.0
    rows = np.nonzero(sc > 0)[0]
    rows = rows[np.argsort(-sc[rows], kind="stable")[:k]]
    return sc[rows], rows


def rrf_plain(lists, k, k_rrf=60.0):
    """Reciprocal-rank fusion of best-first id lists ([NQ, K_t], -1 pad):
    ascending negated scores [NQ, k] and ids, ties to the lower id."""
    nq = lists[0].shape[0]
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    for r in range(nq):
        fused = {}
        for ids in lists:
            for rank, d in enumerate(ids[r].tolist()):
                if d >= 0:
                    fused[d] = fused.get(d, 0.0) + 1.0 / (k_rrf + rank)
        top = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        for j, (d, v) in enumerate(top):
            out_i[r, j], out_s[r, j] = d, -v
    return out_s, out_i


def filtered_oracle(dev, index, u, dead, delta, q, k, lo, hi):
    """The filtered served batch's answer, built from the definitions and
    not from the server's code: the rows with ``lo <= u <= hi`` (and
    live) are allowed; probe selection ranks the clusters holding an
    allowed row (nprobe widened by min(cap, threshold / selectivity) below
    the threshold; slots past the live clusters repeat the best one); an
    exact float64 scan of those clusters' allowed rows on the card, and of
    the allowed live delta rows; a stable merge. Returns (scores, ids,
    nprobe, probes)."""
    import torch

    cfg = index.cfg
    excluded = ~((u >= lo) & (u <= hi)) | dead
    sel = float((~excluded).mean())
    w = cfg.nprobe
    if 0.0 < sel < cfg.filter_widen_threshold:
        w = min(index.nlist, int(np.ceil(
            cfg.nprobe * min(max(1.0, cfg.filter_widen_cap), cfg.filter_widen_threshold / sel))))
    live_cluster = np.bincount(index.cluster_of[~excluded], minlength=index.nlist) > 0
    cen = index.centers
    d = (np.sum(q * q, axis=1)[:, None] - 2.0 * (q @ cen.T)
         + np.sum(cen * cen, axis=1)[None, :])
    d = np.where(live_cluster[None, :], d, np.inf)
    probes = np.argsort(d, axis=1)[:, :w]
    bad = ~np.isfinite(np.take_along_axis(d, probes, axis=1))
    probes = np.where(bad, probes[:, :1], probes)
    nq = q.shape[0]
    parts_s, parts_i = [], []
    x64 = index.x.to(dev).double()         # freed with the call
    xn = (x64 * x64).sum(1)
    allowed_t = torch.as_tensor(~excluded, device=dev)
    cl = torch.as_tensor(index.cluster_of.astype(np.int64), device=dev)
    seg_s = np.full((nq, k), np.inf)
    seg_i = np.full((nq, k), -1, np.int64)
    for a in range(0, nq, 32):
        qd = torch.as_tensor(q[a:a + 32]).to(dev).double()
        member = np.zeros((qd.shape[0], index.nlist), bool)
        member[np.arange(qd.shape[0])[:, None], probes[a:a + 32]] = True
        mask = torch.as_tensor(member, device=dev)[:, cl] & allowed_t[None, :]
        dist = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ x64.T) + xn[None, :]
        dist = torch.where(mask, dist, torch.inf)
        sd, pos = torch.sort(dist, dim=1, stable=True)
        seg_s[a:a + 32] = sd[:, :k].cpu().numpy()
        seg_i[a:a + 32] = index.ids[pos[:, :k].cpu().numpy()]
    parts_s.append(seg_s)
    parts_i.append(seg_i)
    d_ids, d_x, d_ok = delta
    rows = np.nonzero(d_ok)[0]
    if rows.size:
        xd = torch.as_tensor(d_x[rows]).to(dev).double()
        qd = torch.as_tensor(q).to(dev).double()
        dist = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ xd.T) + (xd * xd).sum(1)[None, :]
        sd, pos = torch.sort(dist, dim=1, stable=True)
        kk = min(k, rows.size)
        ds_ = np.full((nq, k), np.inf)
        di = np.full((nq, k), -1, np.int64)
        ds_[:, :kk] = sd[:, :kk].cpu().numpy()
        di[:, :kk] = d_ids[rows][pos[:, :kk].cpu().numpy()]
        parts_s.append(ds_)
        parts_i.append(di)
    cat_s, cat_i = np.concatenate(parts_s, 1), np.concatenate(parts_i, 1)
    order = np.argsort(cat_s, axis=1, kind="stable")[:, :k]
    want_s = np.take_along_axis(cat_s, order, axis=1).astype(np.float32)
    want_i = np.take_along_axis(cat_i, order, axis=1)
    want_i[~np.isfinite(want_s)] = -1
    return want_s, want_i, w, probes


def serve_filtered_and_tiered(dev, smi, index, ds, q_all):
    """Phases 8 and 9 on one server. The index gets per-row metadata from
    a seed (``u`` uniform in [0, 1), a text of ~8 words of a 4000-word
    vocabulary), and a delta burst with metadata. Phase 8 serves 128-query
    batches under ``NumRange("u", 0, 0.5)`` (no widening) and
    ``NumRange("u", 0, 0.02)`` (nprobe widened 4×), each without and with
    ``hybrid_text``, against ``filtered_oracle`` (hybrid: ``rrf_plain``
    over it and ``bm25_topk_plain``). Phase 9 demotes the segment to the
    host tier by prepare / swap / adopt, serves three batches (the second
    prefetched, the third the second again without) bit-identical to the
    device tier, and promotes it back.
    Returns the counts of each phase's path."""
    import dataclasses

    import torch

    from repro_torch.core import NumRange, SegmentedIndex, segment_bm25
    from repro_torch.core.index import metadata_from
    from repro_torch.kernels import ops
    from repro_torch.serve import ExecutorConfig, HarmonyServer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)
    nb = index.nb
    u = rng.uniform(0.0, 1.0, size=nb).astype(np.float32)
    words, texts = make_words(rng, nb)
    order = index.ids                                 # packed row -> input row
    idx_m = dataclasses.replace(index, meta=metadata_from(
        dict(nums={"u": u[order]}, texts=[texts[i] for i in order])))
    t_texts = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    segment_bm25(idx_m)
    bm25_s = time.perf_counter() - t0
    data = SegmentedIndex.from_static(idx_m)
    srv = HarmonyServer(data, n_nodes=4, backend="spmd", executor_cfg=ExecutorConfig())
    # a delta burst with metadata: 2000 rows near corpus rows, 500 deletes
    n_new = 2000
    new_ids = np.arange(10 * nb, 10 * nb + n_new)
    pick = rng.choice(nb, size=n_new)
    new_x = (ds.x[pick] + 0.05 * rng.standard_normal((n_new, 128))).astype(np.float32)
    new_u = rng.uniform(0.0, 1.0, size=n_new).astype(np.float32)
    new_words, new_texts = make_words(rng, n_new)
    srv.upsert(new_ids, new_x, meta={"u": new_u, "text": new_texts})
    srv.delete(rng.choice(nb, size=500, replace=False))
    log(phase="serve_engine_filtered_setup", seconds=time.perf_counter() - t_phase,
        texts_s=t_texts, bm25_build_s=bm25_s, delta_rows=n_new, card=smi)

    snap = data.snapshot()
    dead = snap.dead_rows[0]
    delta_ok = snap.delta_live.copy()
    ex = None
    q128 = q_all[41:169]
    words_packed = words[order]
    ops.reset_launch_counts()
    for lo, hi in ((0.0, 0.5), (0.0, 0.02)):
        flt = NumRange("u", lo, hi)
        want_s, want_i, w, probes = filtered_oracle(
            dev, idx_m, u[order], dead,
            (snap.delta_ids, snap.delta_x, delta_ok & (new_u >= lo) & (new_u <= hi)),
            q128, 10, lo, hi)
        for hybrid in (False, True):
            text = None
            if hybrid:
                terms = [int(t) for t in rng.choice(VOCAB, size=2, replace=False)]
                text = " ".join(f"w{t}" for t in terms)
            compiles0 = ex.compiles if ex is not None else 0
            keys0 = set(ex.trace_counts) if ex is not None else set()
            before = ops.launch_counts()
            with RingTopkLaunches() as ring:
                res = srv.search_batch(q128, flt=flt, hybrid_text=text)
            after = ops.launch_counts()
            ex = srv._seg_states[0].executors["fp32"]
            launches = {n: after[n] - before[n] for n in after}
            merge = launches["running_topk_update"] - ring.ring
            assert merge == 2, f"filtered: {merge} merge launches for 2 parts"
            ring.check_probes(0, "filtered")
            assert all(n == 1 for n in ex.trace_counts.values()), "a bucket built twice"
            new_keys = sorted(set(ex.trace_counts) - keys0)
            if hybrid:
                excluded = ~((u[order] >= lo) & (u[order] <= hi)) | dead
                s_sc, s_rows = bm25_topk_plain(words_packed, terms, excluded, 10)
                d_ok = delta_ok & (new_u >= lo) & (new_u <= hi)
                d_sc, d_rows = bm25_topk_plain(new_words, terms, ~d_ok, 10)
                cands = sorted([(-v, int(i)) for v, i in zip(s_sc, idx_m.ids[s_rows])]
                               + [(-v, int(i)) for v, i in zip(d_sc, new_ids[d_rows])])
                lex = np.array([i for _, i in cands[:10]], np.int64)
                lists = [want_i] + ([np.broadcast_to(lex, (128, lex.size))] if lex.size else [])
                f_s, f_i = rrf_plain(lists, 10)
                assert res.stats["fused"]
                assert np.array_equal(res.ids, f_i), "hybrid: fused ids differ from the oracle"
                np.testing.assert_allclose(res.scores, f_s, rtol=1e-6)
            else:
                assert_topk_matches(res.scores, res.ids, want_s, want_i,
                                    f"filtered u<={hi}")
                served_ids = res.ids[res.ids >= 0]
                ok_ids = np.concatenate([idx_m.ids[(u[order] >= lo) & (u[order] <= hi) & ~dead],
                                         snap.delta_ids[delta_ok & (new_u >= lo) & (new_u <= hi)]])
                assert np.isin(served_ids, ok_ids).all(), "filtered: a disallowed id came back"
            log(phase="serve_engine_filtered", filter=f"NumRange(u, {lo}, {hi})",
                selectivity=float(((u >= lo) & (u <= hi)).mean()), hybrid=text,
                nq=128, widened_nprobe=w, buckets_built=new_keys, compiles=ex.compiles,
                compiled_now=ex.compiles - compiles0,
                wall_ms=res.stats["wall_s"] * 1e3, parts=2, ring_topk_launches=ring.ring,
                merge_topk_launches=merge, launches=launches, card=smi)
            if hi == 0.02:
                # widened by the cap, 4×: nprobe 16 → 64 on the SIFT1M-shaped cell
                wide = min(idx_m.nlist, 4 * idx_m.cfg.nprobe)
                assert all(key[3] == w for key in new_keys) and w == wide, (w, new_keys)
    filtered_counts = ops.launch_counts()
    assert_path_on_kernels(filtered_counts, ("partial_distance_update", "running_topk_update"),
                           "serve_engine_filtered")

    # ---- phase 9: the host tier, by prepare / swap / adopt
    qa, qb = q_all[:128], q_all[169:297]
    hot_a, hot_b = srv.search_batch(qa), srv.search_batch(qb)
    del ex                        # the server's reference is the only one left
    ops.reset_launch_counts()
    mb0 = torch.cuda.memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    srv.prepare_placement({0: "host"})
    data.set_tiers({0: "host"})
    srv.adopt()
    demote_s = time.perf_counter() - t0
    cold_ex = srv._seg_states[0].executors["fp32"]
    assert cold_ex.tier == "host" and cold_ex._resident is None
    host_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb0
    # batch b twice: with the prefetch, then without, to set its wall
    # against the same batch's upload done in the call
    for tag, q, hot, prefetch in (("a", qa, hot_a, False), ("b", qb, hot_b, True),
                                  ("b_again", qb, hot_b, False)):
        if prefetch:
            t1 = time.perf_counter()
            srv.prefetch_batch(q)
            prefetch_ms = (time.perf_counter() - t1) * 1e3
        up0 = cold_ex.upload_ms
        res = srv.search_batch(q)
        assert res.stats["cold_segments"] == 1 and res.stats["bytes_streamed"] > 0
        assert np.array_equal(res.ids, hot.ids) and np.array_equal(res.scores, hot.scores), \
            f"host tier batch {tag} differs from the device tier"
        assert res.stats["prefetch_hits"] == int(prefetch), f"batch {tag}: prefetch hits"
        log(phase="serve_engine_tiered", batch=tag, nq=128, prefetched=prefetch,
            prefetch_ms=prefetch_ms if prefetch else None,
            wall_ms=res.stats["wall_s"] * 1e3, device_tier_wall_ms=hot.stats["wall_s"] * 1e3,
            bytes_streamed=res.stats["bytes_streamed"],
            upload_ms_side_stream=cold_ex.upload_ms - up0,
            prefetch_hits=res.stats["prefetch_hits"], demote_s=demote_s,
            device_mb_change_on_demote=host_mb,
            candidate_buffers_mb=sum(t.nbytes for sets in cold_ex._cand_pool.values()
                                     for b in sets for t in b.dev.values()) / 2 ** 20,
            card=smi)
    tiered_counts = ops.launch_counts()
    assert_path_on_kernels(tiered_counts, ("partial_distance_update", "running_topk_update"),
                           "serve_engine_tiered")
    cold_summary = cold_ex.stats_summary()
    del cold_ex                   # promoted, the host tier's state goes with the swap
    t0 = time.perf_counter()
    srv.prepare_placement({0: "device"})
    data.set_tiers({0: "device"})
    srv.adopt()
    promote_s = time.perf_counter() - t0
    promote_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb0
    back = srv.search_batch(qa)
    assert back.stats["cold_segments"] == 0
    assert np.array_equal(back.ids, hot_a.ids) and np.array_equal(back.scores, hot_a.scores)
    log(phase="serve_engine_tiered_promote", promote_s=promote_s,
        device_mb_change_since_demote=promote_mb,
        wall_ms=back.stats["wall_s"] * 1e3, summary={k: v for k, v in srv.stats.summary().items() if v},
        executor=cold_summary, card=smi)
    del srv, data
    torch.cuda.empty_cache()
    return filtered_counts, tiered_counts


# ------------------------------------------------------------ serving plane
def request_trace(ds, n_req, seed=0):
    """``examples/serve_anns.py``'s trace at unit rate: Poisson arrival
    times (divide by a rate in queries per second) whose workload drifts
    halfway from uniform (skew 0.0) to skewed (0.85 on 4 % of the
    clusters). Returns (unit-rate arrival times, queries)."""
    from repro_torch.data import make_queries

    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0, size=n_req))
    half = n_req // 2
    qu = make_queries(ds, nq=half, skew=0.0, noise=0.2, seed=seed + 1)
    qh = make_queries(ds, nq=n_req - half, skew=0.85, hot_fraction=0.04, noise=0.2,
                      seed=seed + 2)
    return t, np.concatenate([qu, qh]).astype(np.float32)


def profiled(fn, by_name=None):
    """Run ``fn`` under the profiler (device activity only: a window of a
    few batches holds ~10^5 kernels) and return (its result, the card's
    busy ms, the window's wall ms). Busy is the union of the device
    events' spans, read from the raw trace (a kernel launched by a thread
    the profiler has no operator for is kept); the wall starts once the
    profiler runs. ``by_name``, a dict, receives each device event name's
    summed ms."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    if by_name is not None:
        for e in events:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e6
    spans = sorted((e.start_ns(), e.end_ns()) for e in events)
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    return out, busy_ns / 1e6, wall_ms


def aten_ops(fn):
    """(``fn()``, the ATen operators it dispatched): the host's share of a
    step, every launch and view it issues, counted by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        out = fn()
    return out, count.n


def idle_share(busy_ms, wall_ms):
    return 1.0 - busy_ms / wall_ms if busy_ms > 0 else "not measured"


def check_served(results, want_s, want_i, what):
    """Served ``RequestResult`` s (req_id = trace position) against the
    oracle rows; returns how many were checked."""
    if not results:
        return 0
    rid = np.array([r.req_id for r in results])
    ids = np.stack([r.ids for r in results])
    scores = np.stack([r.scores for r in results])
    assert_topk_matches(scores, ids, want_s[rid], want_i[rid], what)
    return len(results)


def sched_summary(stats):
    s = stats.summary()
    keys = ("offered", "admitted", "shed", "full_batches", "deadline_batches",
            "capacity_batches", "skew_replans", "hedged_batches", "replans", "batches",
            "spmd_batches", "retried_batches", "replica_failures", "failed_batches",
            "p50_queue_wait_ms", "p99_queue_wait_ms", "p50_request_latency_ms",
            "p99_request_latency_ms")
    return {k: s[k] for k in keys if k in s}


def serve_sched(dev, smi, index, t_unit, q, want_s, want_i, rate, wall128):
    """Phase 13 (``serve_sched``): the admission-controlled scheduler with
    measured service times on the SIFT1M-shaped plane. The trace runs at
    0.7x and 1.5x the rate the warm server sustains at 128 queries a batch
    (``SchedulerConfig(max_batch=128, max_wait_s=<one warm batch>,
    queue_capacity=512, replan_drift=0.15)``, node 3 failed halfway), each
    on a fresh server; the first run's opening window is profiled. Every
    served row equals ``engine_oracle``. Then ``HarmonyServer.serve`` takes
    the 0.7x trace as 16 batches with their arrivals: its rows equal the
    scheduler's, shed rows -1 / +inf. Returns the path's counts."""
    import gc

    from repro_torch.core import SearchRequest, SegmentedIndex
    from repro_torch.kernels import ops
    from repro_torch.serve import HarmonyServer, SchedulerConfig, ServingScheduler

    n_req = len(q)
    cfg = SchedulerConfig(max_batch=128, max_wait_s=wall128, queue_capacity=512,
                          replan_drift=0.15)
    data = SegmentedIndex.from_static(index)
    ops.reset_launch_counts()
    base = None
    for mult in (0.7, 1.5):
        t_run = time.perf_counter()
        arrivals = t_unit / (mult * rate)
        srv = HarmonyServer(data, n_nodes=8, device=dev)
        killed = {}

        def halfway(bi, sched, srv=srv, killed=killed):
            if not killed and sched.stats.offered >= n_req // 2:
                srv.fail_node(3)
                killed["batch"] = bi

        sched = ServingScheduler(srv, cfg, k=10, on_batch=halfway)   # warms the ladder
        setup_s = time.perf_counter() - t_run
        reqs = [SearchRequest(vector=v) for v in q]
        t0 = time.perf_counter()
        window = 128 if mult == 0.7 else 0
        if window:
            _, busy_ms, win_ms = profiled(
                lambda: [sched.submit(reqs[i], float(arrivals[i])) for i in range(window)])
        for i in range(window, n_req):
            sched.submit(reqs[i], float(arrivals[i]))
        done = sched.flush()
        wall_s = time.perf_counter() - t0
        st = srv.stats
        assert len(done) == st.admitted == n_req - st.shed and killed, (len(done), killed)
        assert srv.cluster.n_live == 7 and st.spmd_batches == st.batches > 0
        checked = check_served(done, want_s, want_i, f"serve_sched x{mult}")
        log(phase="serve_sched", rate_x=mult, offered_qps=mult * rate, n_req=n_req,
            setup_s=setup_s, **sched_summary(st), node_failed_after_batch=killed["batch"],
            rows_checked=checked, virtual_makespan_s=sched.makespan_s,
            virtual_served_qps=sched.served_qps, wall_s=wall_s,
            busy_batch_wall_s=st.wall_s,
            profile_window_requests=window or None,
            profile_window_busy_ms=busy_ms if window else None,
            profile_window_wall_ms=win_ms if window else None,
            device_idle_share=idle_share(busy_ms, win_ms) if window else None,
            card=smi)
        if mult == 0.7:
            base = {r.req_id: r for r in done}
        del sched, srv, done
        gc.collect()

    # HarmonyServer.serve on the 0.7x trace: 16 batches with their arrivals
    arrivals = t_unit / (0.7 * rate)
    srv = HarmonyServer(data, n_nodes=8, device=dev)
    t0 = time.perf_counter()
    outs = srv.serve([q[i:i + 128] for i in range(0, n_req, 128)], k=10, sched=cfg,
                     arrivals=[arrivals[i:i + 128] for i in range(0, n_req, 128)])
    serve_s = time.perf_counter() - t0
    ids, scores = np.concatenate([o.ids for o in outs]), np.concatenate([o.scores for o in outs])
    shed = ids[:, 0] == -1
    assert (ids[shed] == -1).all() and np.isinf(scores[shed]).all()
    both_ = [i for i in range(n_req) if not shed[i] and i in base]
    sel = np.array(both_)
    assert_topk_matches(scores[sel], ids[sel], np.stack([base[i].scores for i in both_]),
                        np.stack([base[i].ids for i in both_]), "serve() vs the scheduler")
    assert_topk_matches(scores[~shed], ids[~shed], want_s[~shed], want_i[~shed],
                        "serve() vs the oracle")
    log(phase="serve_sched_serve", batches_in=len(outs), rows=n_req, shed_rows=int(shed.sum()),
        rows_equal_to_the_scheduler=len(both_), seconds=serve_s,
        **sched_summary(srv.stats), card=smi)
    counts = ops.launch_counts()
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "serve_sched")
    del srv, outs
    gc.collect()
    return counts


def serve_cache(dev, smi, index, ds, rate, wall128):
    """Phase 14 (``serve_cache``): ``CacheConfig(enabled=True,
    semantic_threshold=1e-3)`` (squared L2, staleness 0) in front of the
    scheduler on the same plane. 512 requests at 0.7x the sustained rate:
    half fresh queries, a quarter exact repeats, a quarter near-duplicates
    (noise 1e-3 a coordinate, squared distance ~1.3e-4). An upsert burst
    near the queries lands after the first 256: the epoch invalidates the
    cache. Every exact hit and execution equals ``engine_oracle`` of the
    data state it was served against; every semantic hit's distances are
    within sqrt(threshold) of it (P11). Returns the path's counts."""
    import gc

    from repro_torch.core import SearchRequest, SegmentedIndex
    from repro_torch.data import make_queries
    from repro_torch.kernels import ops
    from repro_torch.serve import (
        CacheConfig,
        HarmonyServer,
        SchedulerConfig,
        ServingScheduler,
    )

    thr = 1e-3
    rng = np.random.default_rng(8)
    fresh = make_queries(ds, nq=256, skew=0.3, seed=9)
    kinds = ["fresh"] * 8 + list(rng.permutation(["fresh"] * 248 + ["repeat"] * 128
                                                 + ["near"] * 128))
    vecs, nxt = [], 0
    for kind in kinds:
        if kind == "fresh":
            vecs.append(fresh[nxt])
            nxt += 1
        else:
            v = vecs[int(rng.integers(0, len(vecs)))]
            if kind == "near":
                v = v + 1e-3 * rng.standard_normal(v.shape[0])
            vecs.append(np.asarray(v, np.float32))
    vecs = np.stack(vecs).astype(np.float32)
    arrivals = np.cumsum(rng.exponential(1.0 / (0.7 * rate), size=len(vecs)))
    data = SegmentedIndex.from_static(index)
    srv = HarmonyServer(data, n_nodes=8, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched = ServingScheduler(srv, SchedulerConfig(
        max_batch=128, max_wait_s=wall128, cache=CacheConfig(enabled=True,
                                                             semantic_threshold=thr)), k=10)
    setup_s = time.perf_counter() - t0
    tiers = {}

    def submit(lo, hi):
        for i in range(lo, hi):
            st = srv.stats
            e0, s0 = st.cache_hits_exact, st.cache_hits_semantic
            rid = sched.submit(SearchRequest(vector=vecs[i]), float(arrivals[i]))
            tiers[rid] = ("exact" if st.cache_hits_exact > e0 else
                          "semantic" if st.cache_hits_semantic > s0 else "executed")
        return {r.req_id: r for r in sched.flush()}

    t0 = time.perf_counter()
    first = submit(0, 256)
    assert len(first) == 256
    want_a = engine_oracle(dev, data.snapshot(), vecs[:256], 10)
    inval0 = srv.stats.cache_invalidations
    burst = np.arange(5_000_000, 5_000_256)
    srv.upsert(burst, (vecs[:256] + 0.01 * rng.standard_normal(vecs[:256].shape)
                       ).astype(np.float32))
    # the burst lands after the first half's last completion: the second
    # half arrives after it on the virtual clock too
    arrivals[256:] += sched.busy_until - arrivals[256] + 0.05
    done = submit(256, 512)               # every result so far
    want_b = engine_oracle(dev, data.snapshot(), vecs[256:], 10)
    wall_s = time.perf_counter() - t0
    n_by = {"exact": 0, "semantic": 0, "executed": 0}
    for rid, r in done.items():
        ws, wi = (want_a if rid < 256 else want_b)
        j = rid % 256
        tier = tiers[rid]
        n_by[tier] += 1
        if tier == "semantic":
            fin = np.isfinite(ws[j])
            assert np.array_equal(np.isfinite(r.scores), fin), f"cache rid {rid}: padding"
            gap = np.abs(np.sqrt(r.scores[fin]) - np.sqrt(ws[j][fin]))
            assert gap.max(initial=0.0) <= np.sqrt(thr) + 1e-3, f"cache rid {rid}: {gap.max()}"
        else:
            assert_topk_matches(r.scores[None], r.ids[None], ws[j:j + 1], wi[j:j + 1],
                                f"cache rid {rid} ({tier})")
    st = srv.stats
    assert len(done) == 512 and st.shed == 0
    assert st.cache_hits_exact > 0 and st.cache_hits_semantic > 0
    assert st.cache_invalidations > inval0, "the upsert burst invalidated nothing"
    assert any(tiers[r] == "executed" for r in range(256, 512)
               if any(np.array_equal(vecs[r], vecs[p]) for p in range(256)))
    counts = ops.launch_counts()
    log(phase="serve_cache", n_req=512, semantic_threshold=thr, setup_s=setup_s, wall_s=wall_s,
        served_by=n_by, cache_hits_exact=st.cache_hits_exact,
        cache_hits_semantic=st.cache_hits_semantic, cache_misses=st.cache_misses,
        cache_invalidations=st.cache_invalidations,
        invalidations_by_the_burst=st.cache_invalidations - inval0,
        coalesced=st.coalesced, batches=st.batches, queries_executed=st.queries,
        upserts=len(burst), card=smi)
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "serve_cache")
    del sched, srv
    gc.collect()
    return counts


def serve_fleet(dev, smi, index, t_unit, q, want_s, want_i, rate, wall128):
    """Phase 15 (``serve_fleet``): a ``ReplicaFleet`` of two spmd replicas
    (capacities 1.0 and 0.5) on the one card over one shared plane,
    ``routing="p2c"``, hedging at 2x the warm batch wall, the trace at 1.4x
    one server's sustained rate (the fleet's capacity is 1.5x: replica 1
    takes work only once replica 0 has a backlog, so it may get none), and
    a ``FaultPlan`` failing replica 0's first ``replica.execute`` (the
    batch is retried on replica 1 and served). Every row equals the
    oracle. Returns (counts, the fleet, its scheduler config)."""
    import torch

    from repro_torch.core import SearchRequest, SegmentedIndex
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import FaultSpec, fault_scope
    from repro_torch.serve import ReplicaFleet, ReplicaSpec, SchedulerConfig, ServingScheduler

    data = SegmentedIndex.from_static(index)
    assert all(s.index.x.device.type == "cpu" for s in data.segments)
    fleet = ReplicaFleet(data, replicas=[ReplicaSpec(capacity=1.0), ReplicaSpec(capacity=0.5)],
                         routing="p2c", seed=0, device=dev)
    replica_mb = []
    for rep in fleet.replicas:                     # each replica's executors
        mb = device_mb()
        rep.server.executor
        replica_mb.append(device_mb() - mb)
    hedge_s = 2.0 * wall128
    cfg = SchedulerConfig(max_batch=128, max_wait_s=wall128, hedge_deadline_s=hedge_s)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched = ServingScheduler(fleet, cfg, k=10)
    setup_s = time.perf_counter() - t0
    arrivals = t_unit / (1.4 * rate)
    t0 = time.perf_counter()
    with fault_scope(FaultSpec("replica.execute", at=1, count=1,
                               where={"replica": 0})) as plan:
        done = sched.run_trace([(float(arrivals[i]), SearchRequest(vector=q[i]))
                                for i in range(len(q))])
    wall_s = time.perf_counter() - t0
    s = fleet.stats
    assert plan.fired == 1 and s.replica_failures == 1 and s.retried_batches >= 1, (
        plan.fired, s.replica_failures, s.retried_batches, [r.batches for r in fleet.replicas])
    assert s.failed_batches == 0 and len(done) == s.admitted == len(q)
    checked = check_served(done, want_s, want_i, "serve_fleet")
    hs = fleet._hedge.stats
    summ = fleet.summary()
    counts = ops.launch_counts()
    log(phase="serve_fleet", n_req=len(q), offered_qps=1.4 * rate, routing="p2c",
        capacities=[1.0, 0.5], hedge_deadline_ms=hedge_s * 1e3, setup_s=setup_s,
        per_replica_batches=[r.batches for r in fleet.replicas],
        per_replica_busy_s=[r.busy_s for r in fleet.replicas],
        per_replica_spmd_batches=[r.server.stats.spmd_batches for r in fleet.replicas],
        load_balance_gini=fleet.load_balance_gini, hedges=hs.hedged, hedge_wins=hs.hedge_wins,
        hedge_win_rate=hs.win_rate, retried_batches=s.retried_batches,
        replica_failures=s.replica_failures, faults_fired=plan.fired,
        per_replica_executor_mb=replica_mb,
        index_rows_mb=sum(s_.index.x.numel() * 4 for s_ in data.segments) / 2 ** 20,
        index_rows_on_card_mb=sum(s_.index.x.numel() * 4 for s_ in data.segments
                                  if s_.index.x.device.type == "cuda") / 2 ** 20,
        rows_checked=checked, virtual_makespan_s=sched.makespan_s,
        virtual_served_qps=sched.served_qps, wall_s=wall_s,
        p50_request_latency_ms=summ["p50_request_latency_ms"],
        p99_request_latency_ms=summ["p99_request_latency_ms"], card=smi)
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "serve_fleet")
    assert all(r.server.stats.spmd_batches == r.server.stats.batches for r in fleet.replicas)
    torch.cuda.synchronize()
    return counts, fleet, cfg


def serve_frontend(dev, smi, fleet, cfg, index, t_unit, q, want_s, want_i, rate):
    """Phase 16 (``serve_frontend``): the live ``ServingFrontend`` over the
    fleet (``max_inflight=2``) on the wall clock: 1024 requests submitted
    open loop at the trace's Poisson times (1.5x one server's sustained
    rate), ``drain()``, ``shutdown()``; no thread is left and every
    future's row equals the oracle. The same run with a one-replica fleet.
    The opening window of each run is profiled. Returns the path's counts."""
    import gc
    import threading

    from repro_torch.core import SearchRequest
    from repro_torch.kernels import ops
    from repro_torch.serve import ReplicaFleet, ServingFrontend

    n = 1024
    arrivals = t_unit[:n] / (1.5 * rate)
    reqs = [SearchRequest(vector=v) for v in q[:n]]
    ops.reset_launch_counts()
    out = {}
    for label in ("2_replicas", "1_replica"):
        if label == "1_replica":
            fleet = ReplicaFleet(fleet.data, replicas=1, seed=0, device=dev)
        t0 = time.perf_counter()
        fe = ServingFrontend(fleet, cfg, k=10, max_inflight=2)      # warms the ladders
        setup_s = time.perf_counter() - t0
        futs = []

        def submit(lo, hi, t_start):
            for i in range(lo, hi):
                dt = t_start + arrivals[i] - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                futs.append(fe.submit(reqs[i]))

        t_start = time.perf_counter()
        window = 512                # ~2.7 s of arrivals: the first batches run in it
        _, busy_ms, win_ms = profiled(lambda: submit(0, window, t_start))
        submit(window, n, t_start)
        assert fe.drain(timeout=900.0), "the front-end did not drain"
        results = [f.result(timeout=60.0) for f in futs]
        wall_s = time.perf_counter() - t_start
        assert fe.shutdown(timeout=60.0), "the front-end did not shut down"
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(("harmony-serve", "harmony-dispatch"))]
        assert fe.stats.shutdown_leaks == 0 and not alive, alive
        checked = check_served(results, want_s, want_i, f"serve_frontend {label}")
        s = fe.summary()
        hs = fleet._hedge.stats if fleet._hedge is not None else None
        out[label] = s["served_qps"]
        log(phase="serve_frontend", replicas=len(fleet.replicas), max_inflight=2,
            n_req=n, offered_qps=1.5 * rate, setup_s=setup_s, wall_s=wall_s,
            wall_qps=n / wall_s, served_qps=s["served_qps"], makespan_s=s["makespan_s"],
            p50_request_latency_ms=s["p50_request_latency_ms"],
            p99_request_latency_ms=s["p99_request_latency_ms"],
            p50_queue_wait_ms=s["p50_queue_wait_ms"], p99_queue_wait_ms=s["p99_queue_wait_ms"],
            batches=s["full_batches"] + s["deadline_batches"] + s["capacity_batches"],
            per_replica_batches=[r.batches for r in fleet.replicas],
            hedges=hs.hedged if hs else 0, hedge_wins=hs.hedge_wins if hs else 0,
            shutdown_leaks=fe.stats.shutdown_leaks, threads_left=len(alive),
            rows_checked=checked, profile_window_requests=window,
            profile_window_busy_ms=busy_ms, profile_window_wall_ms=win_ms,
            device_idle_share=idle_share(busy_ms, win_ms), card=smi)
        del fe, futs, results
    counts = ops.launch_counts()
    log(phase="serve_frontend_scaling", qps_2_over_1=out["2_replicas"] / out["1_replica"],
        card=smi)
    assert_path_on_kernels(counts, ("partial_distance_update", "running_topk_update"),
                           "serve_frontend")
    del fleet
    gc.collect()
    return counts


def serve_launch(smi):
    """Phase 17 (``launch``): ``python -m repro_torch.launch.serve --nb
    1000000 --nlist 1024 --batches 8 --fail-node 3`` in a subprocess on
    the card; it must exit 0 with every batch on the spmd executors."""
    import os

    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--nb", "1000000",
           "--nlist", "1024", "--batches", "8", "--fail-node", "3"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, f"launch exited {proc.returncode}: {proc.stderr[-3000:]}"
    lines = proc.stdout.strip().splitlines()
    assert "spmd batches=8" in lines[-1], lines
    log(phase="launch", cmd=" ".join(cmd[1:]), seconds=seconds, rc=proc.returncode,
        stdout=lines, card=smi)


def serve_plane(dev, smi, index, ds):
    """Phases 13-16: the serving plane on the SIFT1M-shaped plane (the
    index as one sealed segment, spmd executors, n_nodes 8, top-10). One
    2048-request trace and its ``engine_oracle`` serve the scheduler, the
    fleet and the front-end. Returns the counts of each phase's path."""
    import gc

    import torch

    from repro_torch.core import SegmentedIndex
    from repro_torch.serve import HarmonyServer

    t_phase = time.perf_counter()
    t_unit, q = request_trace(ds, 2048, seed=0)
    data = SegmentedIndex.from_static(index)
    srv = HarmonyServer(data, n_nodes=8, device=dev)
    mb = device_mb()
    srv.warmup_executors(k=10)
    walls = [srv.search_batch(q[:128]).stats["wall_s"] for _ in range(3)]
    wall128 = float(np.median(walls))
    rate = 128 / wall128
    want_s, want_i = engine_oracle(dev, data.snapshot(), q, 10)
    log(phase="serve_plane_setup", seconds=time.perf_counter() - t_phase,
        warm_128_walls_ms=[w * 1e3 for w in walls], sustained_qps=rate,
        executor_mb=device_mb() - mb, card=smi)
    del srv, data
    gc.collect()
    torch.cuda.empty_cache()
    paths = [serve_sched(dev, smi, index, t_unit, q, want_s, want_i, rate, wall128)]
    paths.append(serve_cache(dev, smi, index, ds, rate, wall128))
    counts, fleet, cfg = serve_fleet(dev, smi, index, t_unit, q, want_s, want_i, rate, wall128)
    paths.append(counts)
    paths.append(serve_frontend(dev, smi, fleet, cfg, index, t_unit, q, want_s, want_i, rate))
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------------------------ the LM substrate
LM_TOL = 1e-3                 # fp32 on the card against the CPU / its own forward
FILL_MAX_ABS = 0.2            # bf16 fill against prefill: about twice the 0.09375 measured
FILL_ARGMAX_AGREE = 7 / 8     # bf16 fill against prefill: rows whose argmax agrees
FILL_TOKENS = 256             # teacher-forced fill: Qwen1.5 and the recurrent models (PERF.md §6)
RING_F64_TOL = 1e-2           # ring decode (fp32) against forward in f64: 10× the 0.00098 measured


def _leaves(tree, full=False):
    """``launch.roofline.named_leaves``: (key, leaf) pairs of a param,
    cache or optimizer tree; with ``full``, keys are whole paths."""
    from repro_torch.launch.roofline import named_leaves

    return named_leaves(tree, full=full)


def lm_close(got, want, what):
    """(max |err|, max |err| / max |want|) of ``got`` against ``want``,
    compared in f32 on ``got``'s device and held at LM_TOL."""
    import torch

    got, want = got.float(), want.float().to(got.device)
    assert got.shape == want.shape and bool(torch.isfinite(got).all()), what
    err = float((got - want).abs().max())
    assert torch.allclose(got, want, rtol=LM_TOL, atol=LM_TOL), f"{what}: max |err| {err}"
    return err, err / float(want.abs().max())


def ring_witness(params64, cfg, toks, full, dec):
    """Where the ring check's error comes from. The fp32 ``forward``
    logits (``full``) and the teacher-forced decode's (``dec``) are each
    held against the same model's ``forward`` in f64 (``params64``; norms
    and softmax stay f32 as the reference computes them, the logits are
    rounded to f32), over all positions, the n before the ring buffers
    wrap and the n after (n = S − W). Summation order moves an fp32 path
    alike before the wrap and after; a fault in the ring's slots or window
    moves decode only, and only after the wrap. Decode is held at
    RING_F64_TOL (absolute) over all positions."""
    import torch

    from repro_torch.models import forward

    W = cfg.sliding_window
    n = toks.shape[1] - W
    ref, _ = forward(params64, cfg.replace(dtype="float64", param_dtype="float64"),
                     {"tokens": toks})
    spans = {"all": slice(None), "before_wrap": slice(W - n, W), "after_wrap": slice(W, W + n)}
    out = {"positions_each": n, "max_abs_logit": float(ref.abs().max())}
    for name, got in (("forward_fp32", full), ("decode_fp32", dec)):
        for span, sl in spans.items():
            out[f"{name}_vs_f64_{span}"] = float((got[:, sl] - ref[:, sl]).abs().max())
    for span, sl in spans.items():
        out[f"decode_vs_forward_fp32_{span}"] = float((dec[:, sl] - full[:, sl]).abs().max())
    assert out["decode_fp32_vs_f64_all"] <= RING_F64_TOL, f"ring decode against f64: {out}"
    del ref
    return out


def teacher_forced(params, cfg, toks, ctx=None):
    """``decode_step``'s logits [B, n, V] at every position of ``toks``
    (on their device), from an empty cache."""
    import torch

    from repro_torch.models import RunCtx, decode_step, init_cache

    B, n = toks.shape
    ctx = RunCtx() if ctx is None else ctx
    cache = init_cache(cfg, B, n, device=toks.device)
    out = torch.empty((B, n, cfg.vocab_size), dtype=torch.float32, device=toks.device)
    for t in range(n):
        out[:, t], cache = decode_step(params, cfg, toks[:, t],
                                       torch.full((B,), t, device=toks.device), cache, ctx)
    return out


def lm_fp32_checks(dev, qwen, gemma, vl, hubert, S=64, S_ring=1088):
    """Phase 18a (``lm_fp32``): full widths at reduced depth, in fp32 with
    TF32 off. The card's ``forward`` against the port's CPU ``forward`` on the
    same params (Qwen1.5, Qwen2-VL with M-RoPE patch positions, HuBERT's
    frames; B = 2, S tokens); teacher-forced ``decode_step`` against the
    card's own ``forward`` at every position (Qwen1.5 over S; Gemma3 over
    S_ring > its window, so the local layers' ring buffers wrap, with
    ``ring_witness`` on its error). Returns ({check: (max |err|, relative)},
    the witness)."""
    import torch

    from repro_torch.models import forward, init_params
    from repro_torch.models.lm import map_tree

    rng = np.random.default_rng(0)
    errs = {}

    def card_vs_cpu(cfg, batch, what):
        params = init_params(cfg, 0, device=dev)
        cpu = map_tree(params, lambda t: t.cpu())
        got, _ = forward(params, cfg, map_tree(batch, lambda t: t.to(dev)))
        want, _ = forward(cpu, cfg, batch)
        errs[what] = lm_close(got, want, what)
        return params, got

    toks = torch.from_numpy(rng.integers(0, qwen.vocab_size, size=(2, S)))
    params, full = card_vs_cpu(qwen, {"tokens": toks}, "qwen_card_vs_cpu")
    errs["qwen_decode_vs_forward"] = lm_close(teacher_forced(params, qwen, toks.to(dev)),
                                              full, "qwen decode against forward")
    del params, full

    params = init_params(gemma, 0, device=dev)
    toks = torch.from_numpy(rng.integers(0, gemma.vocab_size, size=(1, S_ring))).to(dev)
    full, _ = forward(params, gemma, {"tokens": toks})
    dec = teacher_forced(params, gemma, toks)
    errs["gemma_ring_decode_vs_forward"] = lm_close(dec, full,
                                                    "gemma ring decode against forward")
    params = map_tree(params, lambda t: t.double())
    witness = ring_witness(params, gemma, toks, full, dec)
    del params, full, dec

    pos = np.broadcast_to(np.arange(S)[None, None], (3, 2, S)).copy()
    pos[1, :, : S // 4] += 3                       # patch positions on a prefix
    pos[2, :, : S // 4] += 5
    card_vs_cpu(vl, {"tokens": torch.from_numpy(rng.integers(0, vl.vocab_size, size=(2, S))),
                     "positions": torch.from_numpy(pos)}, "qwen2vl_mrope_card_vs_cpu")
    frames = torch.from_numpy(rng.normal(size=(2, S, hubert.d_model)).astype(np.float32))
    card_vs_cpu(hubert, {"frames": frames}, "hubert_card_vs_cpu")
    torch.cuda.empty_cache()
    return errs, witness


def state_bytes_of(cache):
    """Bytes of a cache's recurrent states (its mLSTM, sLSTM and Mamba2
    tuples); 0 for a transformer's KV cache."""
    return sum(t.numel() * t.element_size() for key in ("mlstm", "slstm", "mamba")
               for t in cache.get(key, ()))


class RouteLog:
    """While active, records each ``repro_torch.models.moe._route`` call
    (one a MoE layer): its experts and the gap between each token's k-th
    and (k+1)-th router probability. Wraps the module's function, as the
    dense and EP paths look it up there; outside a ``with`` nothing is
    recorded."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe._route

        def route(cfg, xt, router):
            gates, experts, aux = self._route(cfg, xt, router)
            k = cfg.moe.experts_per_token
            top = torch.topk(torch.softmax(xt.float() @ router, dim=-1), k + 1, dim=-1).values
            self.calls.append((experts.reshape(-1, k), (top[..., k - 1] - top[..., k]).reshape(-1)))
            return gates, experts, aux

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    def last_rows(self, B):
        """Per layer: (the sorted experts [B, k], the gap [B]) of each
        batch row's last token (decode: its one token)."""
        return self.rows(B, last=True)

    def rows(self, B, last=False):
        """Per layer: (the sorted experts, the gaps) of every token [B·S]
        in batch order (the EP path routes rank-major, the same order), or
        of each row's last token."""
        import torch

        out = []
        for e, g in self.calls:
            e, g = e.reshape(B, -1, e.shape[-1]), g.reshape(B, -1)
            if last:
                e, g = e[:, -1:], g[:, -1:]
            out.append((torch.sort(e.reshape(-1, e.shape[-1]), dim=-1).values, g.reshape(-1)))
        return out


def moe_rule(got, want, routes_got, routes_want, what):
    """The bf16 rule (max |Δ| ≤ FILL_MAX_ABS, argmax agreement ≥
    FILL_ARGMAX_AGREE) for a model whose top-k routing is discrete. A bf16
    rounding that moves a token's router probabilities across a near tie
    of its k-th and (k+1)-th expert gives that row other experts in that
    layer, and other logits after it. Held: argmax agreement ≥
    FILL_ARGMAX_AGREE over every row; max |Δ| ≤ FILL_MAX_ABS over the rows
    routed alike in every layer (at least one); and each row routed apart
    first parts at a near tie: its gap on ``want``'s path in that layer
    below the median gap over all rows and layers (a tie broken the other
    way, not a misroute). ``routes_*``: ``RouteLog.last_rows``. Returns
    the numbers."""
    import torch

    assert len(routes_got) == len(routes_want) > 0, what
    rows = got.shape[0]
    alike = torch.ones(rows, dtype=torch.bool, device=got.device)
    first = {}
    for layer, ((e_got, _), (e_want, gap)) in enumerate(zip(routes_got, routes_want)):
        apart = (e_got != e_want).any(-1)
        for r in torch.nonzero(apart & alike).flatten().tolist():
            first[r] = (layer, float(gap[r]))
        alike &= ~apart
    median_gap = float(torch.cat([g for _, g in routes_want]).median())
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()), what
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert agree >= FILL_ARGMAX_AGREE, f"{what}: argmax agreement {agree}"
    assert bool(alike.any()), f"{what}: no row routed alike ({first})"
    alike_diff = float((got[alike] - want[alike]).abs().max())
    assert alike_diff <= FILL_MAX_ABS, f"{what}: max |Δ| {alike_diff} over the rows routed alike"
    assert all(gap < median_gap for _, gap in first.values()), (
        f"{what}: a row parted at no near tie: {first}, median gap {median_gap}")
    return dict(max_abs=float((got - want).abs().max()), max_abs_routed_alike=alike_diff,
                argmax_agree=agree, rows_routed_apart=len(first),
                first_parting={str(r): dict(layer=lay, gap=g) for r, (lay, g) in first.items()},
                median_gap=median_gap)


def lm_served(dev, cfg, B=8, S=1024, max_len=1152, steps=64, keep=False, fill=None,
              rule=None):
    """Phase 18b (``lm``): ``cfg`` served in its own bf16 from the port's
    seeded init: B prompts of S tokens through ``prefill`` (once to warm,
    once timed); a cache of ``max_len`` filled by teacher-forced
    ``decode_step`` over the prompts' first ``fill`` tokens (all S by
    default), whose last logits are held against ``prefill``'s over the
    same tokens (max |Δ| ≤ FILL_MAX_ABS, argmax agreement ≥
    FILL_ARGMAX_AGREE; an MoE model by ``moe_rule``, the routes of the
    warm prefill and the last fill step recorded; ``rule(params, tokens,
    fill logits, prefill logits)``, when given, holds them instead and
    returns its numbers); then ``steps`` greedy
    steps, every logit finite;
    then 8 more steps under the profiler (idle share). On the card only.
    Returns the numbers of the ``lm`` line; with ``keep``, also the params,
    prompts, prefill's last logits and a copy of the filled cache."""
    import torch

    from repro_torch.launch.roofline import decode_bound, prefill_bound
    from repro_torch.models import RunCtx, decode_step, init_cache, init_params, prefill
    from repro_torch.models.lm import map_tree

    fill = S if fill is None else fill
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S))).to(dev)

    with RouteLog() as prefill_routes:                  # warm: the library's plans
        prefill(params, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    # the timed prefill's own peak (the phase's dry run predicts it), the
    # phase's peak kept across the reset
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = prefill(params, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()

    fill_prefill_routes = prefill_routes
    if fill == S:
        fill_last = last
    else:                                   # the routes of the prefill it is held against
        with RouteLog() as fill_prefill_routes:
            fill_last = prefill(params, cfg, {"tokens": prompts[:, :fill]})
    cache = init_cache(cfg, B, max_len, device=dev)
    cache_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(cache))
    t0 = time.perf_counter()
    for t in range(fill - 1):
        decode_step(params, cfg, prompts[:, t], torch.full((B,), t, device=dev), cache)
    with RouteLog() as fill_routes:
        lg, cache = decode_step(params, cfg, prompts[:, fill - 1],
                                torch.full((B,), fill - 1, device=dev), cache)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    routing = None
    if rule is not None:
        routing = rule(params, prompts[:, :fill], lg, fill_last)
        fill_vs_prefill, argmax_agree = routing["max_abs"], routing["argmax_agree"]
    elif cfg.is_moe:
        routing = moe_rule(lg, fill_last, fill_routes.last_rows(B),
                           fill_prefill_routes.last_rows(B), "fill against prefill")
        fill_vs_prefill, argmax_agree = routing["max_abs"], routing["argmax_agree"]
    else:
        fill_vs_prefill = float((lg - fill_last).abs().max())
        argmax_agree = float((lg.argmax(-1) == fill_last.argmax(-1)).float().mean())
        assert bool(torch.isfinite(lg).all()) and bool(torch.isfinite(fill_last).all())
        assert fill_vs_prefill <= FILL_MAX_ABS and argmax_agree >= FILL_ARGMAX_AGREE, (
            f"fill against prefill: max |Δ| {fill_vs_prefill}, argmax agreement "
            f"{argmax_agree}")
    fill_max_abs_logit = float(fill_last.abs().max())
    del fill_last
    filled = map_tree(cache, torch.clone) if keep else None

    tok, finite = lg.argmax(-1), torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for i in range(steps):
        lg, cache = decode_step(params, cfg, tok, torch.full((B,), fill + i, device=dev), cache)
        finite &= torch.isfinite(lg).all()
        tok = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    assert bool(finite), "a greedy step gave a non-finite logit"

    def eight_steps():
        nonlocal lg, cache
        t_ = tok
        for i in range(8):
            lg, cache = decode_step(params, cfg, t_,
                                    torch.full((B,), fill + steps + i, device=dev), cache)
            t_ = lg.argmax(-1)
        return t_

    _, busy_ms, wall_ms = profiled(eight_steps)
    (lg, cache), step_ops = aten_ops(lambda: decode_step(
        params, cfg, lg.argmax(-1), torch.full((B,), fill + steps + 8, device=dev), cache))
    peak = max(peak_before, torch.cuda.max_memory_allocated())
    assert bool(torch.isfinite(lg).all())
    pb = prefill_bound(cfg, params, B, S, RunCtx().rec_chunk)
    flops, f32_flops = pb["flops"], pb["f32_flops"]
    state_bytes = state_bytes_of(cache)
    db = decode_bound(cfg, params, B, fill + (steps + 1) / 2, state_bytes=state_bytes)
    step_bytes = db["bytes"]
    out = dict(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        dtype=cfg.dtype, batch=B, prompt=S, max_len=max_len, greedy_steps=steps,
        init_s=init_s, param_bytes=param_bytes, cache_bytes=cache_bytes,
        peak_allocated_bytes=peak, prefill_peak_allocated_bytes=prefill_peak,
        prefill_ms=prefill_s * 1e3, prefill_tokens_per_s=B * S / prefill_s,
        prefill_flops=flops, prefill_bound_ms=pb["bound_ms"],
        prefill_bound_by=pb["bound_by"],
        fill_ms_per_step=fill_s / fill * 1e3, prefill_max_abs_logit=fill_max_abs_logit,
        fill_vs_prefill_max_abs=fill_vs_prefill, fill_vs_prefill_argmax_agree=argmax_agree,
        decode_ms_per_step=decode_s / steps * 1e3, decode_tokens_per_s=B * steps / decode_s,
        decode_bytes_per_step=step_bytes,
        decode_bound_ms_per_step=db["bound_ms"],
        decode_bound_by="bytes",
        idle_share_8_steps=idle_share(busy_ms, wall_ms), busy_ms_8_steps=busy_ms,
        wall_ms_8_steps=wall_ms, decode_aten_ops_per_step=step_ops,
    )
    if routing is not None:
        out["fill_vs_prefill_rule" if rule is not None else "fill_vs_prefill_routing"] = routing
    if fill != S:
        out["fill_tokens"] = fill
    if f32_flops:
        out.update(prefill_f32_flops=f32_flops, state_bytes=state_bytes)
    if keep:
        return out, dict(params=params, prompts=prompts, last=last, filled=filled)
    del params, cache, last, lg
    torch.cuda.empty_cache()
    return out


def serve_lm(dev, smi):
    """Phase 18 (``lm_serve``): the LM substrate's serving path on the card.
    (a) fp32 at full width, reduced depth (``lm_fp32_checks``): Qwen1.5-4B
    and Qwen2-VL-7B at 2 layers, HuBERT-XLarge at 2, Gemma3-27B at 8 (one
    5 + 1 unit and the 2 tail locals, window 1024, decoded over 1088
    positions); (b) Qwen1.5-4B at its published width and depth in bf16
    (``lm_served``, the fill over the prompts' first FILL_TOKENS), then 8
    steps at the cache's last positions (``decode_at_length``). The path
    runs no hand-written kernel: the launch counts stay 0. Prints the
    ``{"lm": ...}`` line."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops

    def fp32(name, layers):
        return configs.get_config(name).replace(dtype="float32", param_dtype="float32",
                                                num_layers=layers)

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    errs, witness = lm_fp32_checks(dev, fp32("qwen1.5-4b", 2), fp32("gemma3-27b", 8),
                                   fp32("qwen2-vl-7b", 2), fp32("hubert-xlarge", 2))
    rel = {k: r for k, (_, r) in errs.items()}
    errs = {k: e for k, (e, _) in errs.items()}
    log(phase="lm_fp32", tol=LM_TOL, max_abs_err=errs, rel_err=rel, ring_witness=witness,
        seconds=time.perf_counter() - t_phase, card=smi)
    qwen = configs.get_config("qwen1.5-4b")
    served, st = lm_served(dev, qwen, fill=FILL_TOKENS, keep=True)
    del st["filled"]
    served["at_max_len"] = decode_at_length(dev, qwen, st["params"], 8, served["max_len"])
    del st
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    assert not any(counts.values()), counts
    print(json.dumps({"lm": dict(
        served, fp32_max_abs_err=errs, fp32_rel_err=rel, fp32_tol=LM_TOL,
        ring_witness=witness, ring_f64_tol=RING_F64_TOL, fill_max_abs_limit=FILL_MAX_ABS,
        fill_argmax_agree_limit=FILL_ARGMAX_AGREE,
        tf32=torch.backends.cuda.matmul.allow_tf32,
        bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
        kernel_launches=sum(counts.values()), seconds=time.perf_counter() - t_phase,
        card=smi)}, default=float), flush=True)
    return served


def lm_moe_fp32_checks(dev, olmoe, S=64, ep=2):
    """Phase 19a (``lm_moe_fp32``): ``olmoe`` (full width, reduced depth) in
    fp32 with TF32 off, on the same params and 2 × S tokens, each at
    LM_TOL: the card's ``forward`` (logits and aux) against the CPU's,
    through ``RunCtx()`` and ``RunCtx(mesh=VirtualMesh(ep))`` (the default
    capacity: both devices must drop the same slots); teacher-forced
    ``decode_step`` against the card's ``forward``; each layer's
    ``moe_ffn_ep`` at capacity 8, where no slot can drop, against its
    ``moe_ffn_dense`` on a seeded normal input. Returns ({check: (max |err|,
    relative)}, the EP forward's dropped slots per layer at 1.5)."""
    import torch

    from repro_torch.models import RunCtx, VirtualMesh, forward, init_params, moe
    from repro_torch.models.lm import map_tree

    rng = np.random.default_rng(2)
    errs, drops = {}, {}
    params = init_params(olmoe, 0, device=dev)
    cpu = map_tree(params, lambda t: t.cpu())
    toks = torch.from_numpy(rng.integers(0, olmoe.vocab_size, size=(2, S)))
    full = None
    for name in ("dense", "ep"):
        logs = ([], [])
        ctxs = [RunCtx(mesh=VirtualMesh(ep, drop_log=log) if name == "ep" else None)
                for log in logs]
        got, aux = forward(params, olmoe, {"tokens": toks.to(dev)}, ctxs[0])
        want, want_aux = forward(cpu, olmoe, {"tokens": toks}, ctxs[1])
        errs[f"olmoe_{name}_card_vs_cpu"] = lm_close(got, want, f"OLMoE {name} card vs CPU")
        errs[f"olmoe_{name}_aux_card_vs_cpu"] = lm_close(aux, want_aux, f"OLMoE {name} aux")
        if name == "ep":
            drops["card"] = [int(d.sum()) for d in logs[0]]
            assert drops["card"] == [int(d.sum()) for d in logs[1]], "card and CPU drop apart"
        else:
            full = got
    del cpu, want
    errs["olmoe_decode_vs_forward"] = lm_close(teacher_forced(params, olmoe, toks.to(dev)),
                                               full, "OLMoE decode against forward")
    x = torch.from_numpy(rng.standard_normal((2, S, olmoe.d_model)).astype(np.float32)).to(dev)
    for u in range(olmoe.num_layers):
        p = map_tree(params["units"]["block"]["moe"], lambda t: t[u])
        log = []
        dense, dense_aux = moe.moe_ffn_dense(p, olmoe, x)
        got, _ = moe.moe_ffn_ep(p, olmoe, x, VirtualMesh(ep, drop_log=log), capacity_factor=8.0)
        assert int(log[0].sum()) == 0, "a slot dropped at capacity 8"
        errs[f"olmoe_layer{u}_ep_cap8_vs_dense"] = lm_close(got, dense, f"layer {u} EP vs dense")
    del params, full
    torch.cuda.empty_cache()
    return errs, drops["card"]


def lm_moe_served(dev, cfg, B=8, S=1024, max_len=1152, steps=64, ep=8, ep_steps=8):
    """Phase 19b (``lm_moe``): ``cfg`` served in bf16 through ``RunCtx()``
    (``lm_served``: prefill, the fill over the prompts' first FILL_TOKENS
    held against a prefill of those, greedy steps, the profiled 8), then
    through ``RunCtx(mesh=VirtualMesh(ep))`` at the default capacity:
    ``prefill`` (warm, then timed) with its dropped slots per layer and its
    last logits against the dense path's (information only); ``ep_steps``
    decode steps on a copy of the filled cache from the prompts' next
    token beside the dense path's on the same tokens, where no slot can
    drop (B = ep:
    one token a rank, cap_send = k), each step held against the dense
    step by ``moe_rule``; then the same EP steps again, timed, on another
    copy; then 8 dense steps at the cache's last positions
    (``decode_at_length``). Returns the numbers of the ``lm_moe`` line."""
    import torch

    from repro_torch.models import RunCtx, VirtualMesh, decode_step, moe, prefill
    from repro_torch.models.lm import map_tree

    fill = FILL_TOKENS
    out, st = lm_served(dev, cfg, B, S, max_len, steps, keep=True, fill=fill)
    params, prompts, last, cache = st["params"], st["prompts"], st["last"], st["filled"]
    del st
    log = []
    ctx = RunCtx(mesh=VirtualMesh(ep, drop_log=log))
    prefill(params, cfg, {"tokens": prompts}, ctx)          # warm
    torch.cuda.synchronize()
    log.clear()
    t0 = time.perf_counter()
    last_ep = prefill(params, cfg, {"tokens": prompts}, ctx)
    torch.cuda.synchronize()
    prefill_ep_s = time.perf_counter() - t0
    prefill_drops = [int(d.sum()) for d in log]
    assert bool(torch.isfinite(last_ep).all()), "EP prefill gave a non-finite logit"

    ep_cache, timed_cache = map_tree(cache, torch.clone), map_tree(cache, torch.clone)
    toks, log[:] = [prompts[:, fill]], []                  # the prompt's next token
    step_rule = []
    for i in range(ep_steps):
        pos = torch.full((B,), fill + i, device=dev)
        with RouteLog() as dense_routes:
            lg, _ = decode_step(params, cfg, toks[-1], pos, cache)
        with RouteLog() as ep_routes:
            lg_ep, _ = decode_step(params, cfg, toks[-1], pos, ep_cache, ctx)
        step_rule.append(moe_rule(lg_ep, lg, ep_routes.last_rows(B), dense_routes.last_rows(B),
                                  f"EP decode step {i} against dense"))
        toks.append(lg.argmax(-1))
    decode_drops = sum(int(d.sum()) for d in log)
    assert decode_drops == 0, f"{decode_drops} slots dropped in EP decode at B = ep"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ep_steps):
        decode_step(params, cfg, toks[i], torch.full((B,), fill + i, device=dev), timed_cache,
                    ctx)
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0

    from repro_torch.launch.roofline import BF16_FLOPS, HBM_BW, lm_bounds

    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    cap_send, cap_e = moe.ep_capacities(cfg, B // ep * S, ep)
    param_bytes = out["param_bytes"]
    flops_ep, _ = lm_bounds(cfg, params, B, S, 0, expert_rows=E * cap_e)
    flops_routed, _ = lm_bounds(cfg, params, B, S, 0, expert_rows=B * S * k)
    _, ep_step_bytes = lm_bounds(cfg, params, B, S, fill + (ep_steps + 1) / 2)
    out.update(
        experts=E, experts_per_token=k,
        prefill_top_k_flops=flops_routed,
        ep=dict(
            data=ep, capacity_factor=1.5, prefill_cap_send=cap_send, prefill_cap_e=cap_e,
            prefill_expert_slots_per_layer=E * cap_e, prefill_routed_slots_per_layer=B * S * k,
            prefill_ms=prefill_ep_s * 1e3, prefill_tokens_per_s=B * S / prefill_ep_s,
            prefill_flops=flops_ep,
            prefill_bound_ms=max(flops_ep / BF16_FLOPS, param_bytes / HBM_BW) * 1e3,
            prefill_dropped_slots_per_layer=prefill_drops,
            prefill_vs_dense_max_abs=float((last_ep - last).abs().max()),
            prefill_vs_dense_argmax_agree=float((last_ep.argmax(-1) == last.argmax(-1))
                                                .float().mean()),
            decode_steps=ep_steps, decode_ms_per_step=ep_s / ep_steps * 1e3,
            decode_tokens_per_s=B * ep_steps / ep_s,
            decode_bound_ms_per_step=ep_step_bytes / HBM_BW * 1e3,
            decode_cap_send_cap_e=list(moe.ep_capacities(cfg, B // ep, ep)),
            decode_dropped_slots=decode_drops,
            decode_vs_dense_max_abs=max(r["max_abs"] for r in step_rule),
            decode_vs_dense_max_abs_routed_alike=max(r["max_abs_routed_alike"]
                                                     for r in step_rule),
            decode_vs_dense_argmax_agree_min=min(r["argmax_agree"] for r in step_rule),
            decode_rows_routed_apart=[r["rows_routed_apart"] for r in step_rule],
        ))
    del ep_cache, timed_cache
    out["at_max_len"] = decode_at_length(dev, cfg, params, B, max_len)
    del params, prompts, last, cache, last_ep, lg, lg_ep
    torch.cuda.empty_cache()
    return out


def lm_kimi_witness(dev, cfg, S=64, steps=8, ep=2):
    """Phase 19c: ``cfg`` (Kimi K2 at its published width, 1 layer) in bf16
    from the seeded init, after the earlier phases freed the card: B = 2
    prompts of S tokens through ``forward`` on both paths (``RunCtx()``,
    ``VirtualMesh(ep)`` at the default capacity), every logit finite, EP
    held against dense by ``moe_rule`` over the tokens none of whose slots
    dropped (one layer: a token's logits depend on its own MoE output
    alone); then ``steps`` teacher-forced decode steps on both paths from
    empty caches, where no slot can drop, each step by ``moe_rule``."""
    import torch

    from repro_torch.models import (RunCtx, VirtualMesh, decode_step, forward, init_cache,
                                    init_params, moe)

    assert cfg.num_layers == 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for _, t in _leaves(params))
    B = 2
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S))).to(dev)
    log = []
    ctx = RunCtx(mesh=VirtualMesh(ep, drop_log=log))
    with RouteLog() as dense_routes:
        t0 = time.perf_counter()
        dense, _ = forward(params, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
    with RouteLog() as ep_routes:
        t0 = time.perf_counter()
        got, _ = forward(params, cfg, {"tokens": toks}, ctx)
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t0
    kept = (log[0] == 0).reshape(-1)                    # tokens none of whose slots dropped
    fwd_drops = int(log[0].sum())
    fwd_rule = moe_rule(got.reshape(B * S, -1)[kept], dense.reshape(B * S, -1)[kept],
                        [(e[kept], g[kept]) for e, g in ep_routes.rows(B)],
                        [(e[kept], g[kept]) for e, g in dense_routes.rows(B)],
                        "Kimi EP forward against dense")
    caches = [init_cache(cfg, B, steps, device=dev) for _ in range(2)]
    log.clear()
    dec_rule = []
    for t in range(steps):
        pos = torch.full((B,), t, device=dev)
        with RouteLog() as dense_routes:
            lg, _ = decode_step(params, cfg, toks[:, t], pos, caches[0])
        with RouteLog() as ep_routes:
            lg_ep, _ = decode_step(params, cfg, toks[:, t], pos, caches[1], ctx)
        dec_rule.append(moe_rule(lg_ep, lg, ep_routes.last_rows(B), dense_routes.last_rows(B),
                                 f"Kimi EP decode step {t} against dense"))
    assert all(int(d.sum()) == 0 for d in log), "a slot dropped in Kimi's EP decode"
    out = dict(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, experts=cfg.moe.num_experts,
        experts_per_token=cfg.moe.experts_per_token, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, vocab=cfg.vocab_size, dtype=cfg.dtype, batch=B, prompt=S,
        init_s=init_s, param_bytes=param_bytes,
        peak_allocated_bytes=torch.cuda.max_memory_allocated(),
        forward_dense_ms=dense_s * 1e3, forward_ep_ms=ep_s * 1e3, ep_cap_send_cap_e=list(
            moe.ep_capacities(cfg, B // ep * S, ep)),
        ep_dropped_slots=fwd_drops, ep_tokens_with_a_dropped_slot=int((~kept).sum()),
        ep_vs_dense_kept_tokens=fwd_rule, decode_steps=steps,
        decode_ep_vs_dense_max_abs=max(r["max_abs"] for r in dec_rule),
        decode_ep_vs_dense_argmax_agree_min=min(r["argmax_agree"] for r in dec_rule),
        decode_rows_routed_apart=[r["rows_routed_apart"] for r in dec_rule],
    )
    del params, dense, got, caches, lg, lg_ep
    torch.cuda.empty_cache()
    return out


def serve_lm_moe(dev, smi):
    """Phase 19 (``lm_moe``): the MoE serving path on the card, dense and
    expert-parallel over a virtual data axis. (a) OLMoE-1B-7B at its
    published width, 2 layers, fp32 (``lm_moe_fp32_checks``); (b)
    OLMoE-1B-7B at its published width and depth in bf16 (``lm_moe_served``);
    (c) Kimi K2 at its published width, 1 layer, bf16 (``lm_kimi_witness``).
    The path runs no hand-written kernel: the launch counts stay 0. Prints
    the ``{"lm_moe": ...}`` line."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    olmoe = configs.get_config("olmoe-1b-7b")
    errs, drops32 = lm_moe_fp32_checks(dev, olmoe.replace(
        dtype="float32", param_dtype="float32", num_layers=2))
    rel = {k: r for k, (_, r) in errs.items()}
    errs = {k: e for k, (e, _) in errs.items()}
    log(phase="lm_moe_fp32", tol=LM_TOL, max_abs_err=errs, rel_err=rel,
        ep2_dropped_slots_per_layer_at_1_5=drops32, seconds=time.perf_counter() - t_phase,
        card=smi)
    t0 = time.perf_counter()
    served = lm_moe_served(dev, olmoe)
    served_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kimi = lm_kimi_witness(dev, configs.get_config("kimi-k2-1t-a32b").replace(num_layers=1))
    kimi.update(seconds=time.perf_counter() - t0)
    counts = ops.launch_counts()
    assert not any(counts.values()), counts
    print(json.dumps({"lm_moe": dict(
        served, served_s=served_s, fp32_max_abs_err=errs, fp32_rel_err=rel, fp32_tol=LM_TOL,
        fp32_ep2_dropped_slots_per_layer_at_1_5=drops32, kimi_k2_witness=kimi,
        fill_max_abs_limit=FILL_MAX_ABS, fill_argmax_agree_limit=FILL_ARGMAX_AGREE,
        tf32=torch.backends.cuda.matmul.allow_tf32,
        kernel_launches=sum(counts.values()), seconds=time.perf_counter() - t_phase,
        card=smi)}, default=float), flush=True)


FILL_WITNESS_FACTOR = 1.5     # fill vs fp32 over prefill vs fp32: 1.06 measured (PERF.md §6)


def logit_scale(want):
    """The logits' RMS, at least 1: the unit in which the recurrent checks
    hold a logit difference (1 for every model whose logits' RMS is below
    1; xLSTM's tied N(0, 1) head gives an RMS near 40)."""
    return max(1.0, float(want.float().pow(2).mean().sqrt()))


def lm_close_scaled(got, want, what):
    """``lm_close`` in units of ``logit_scale(want)``: (max |err|, max |err|
    / max |want|, the scale)."""
    s = logit_scale(want)
    err, rel = lm_close(got / s, want / s, what)
    return err * s, rel, s


def recurrent_fill_rule(cfg):
    """The fill rule of a recurrent model (``lm_served``'s ``rule``): both
    logits finite; every row whose prefill top-two gap exceeds twice its
    own max |Δ| (a row no such difference could flip) keeps its argmax; and
    max |Δ| ≤ FILL_MAX_ABS in units of ``logit_scale``, or, failing that,
    the fill no further from the same weights' fp32 ``forward`` than
    FILL_WITNESS_FACTOR times prefill's distance from it. Returns the
    numbers."""
    import torch

    from repro_torch.models import forward
    from repro_torch.models.lm import map_tree

    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")

    def rule(params, tokens, got, want):
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())
        diff = (got - want).abs()
        max_abs, scale = float(diff.max()), logit_scale(want)
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * diff.max(-1).values
        agree = got.argmax(-1) == want.argmax(-1)
        p32 = map_tree(params, lambda t: t.float() if t.is_floating_point() else t)
        ref = forward(p32, cfg32, {"tokens": tokens})[0][:, -1]
        del p32
        fill_err, prefill_err = float((got - ref).abs().max()), float((want - ref).abs().max())
        out = dict(max_abs=max_abs, logit_scale=scale, max_abs_in_scale=max_abs / scale,
                   argmax_agree=float(agree.float().mean()), near_tie_rows=int((~clear).sum()),
                   fill_vs_fp32_max_abs=fill_err, prefill_vs_fp32_max_abs=prefill_err,
                   fill_vs_fp32_argmax_agree=float((got.argmax(-1) == ref.argmax(-1))
                                                   .float().mean()),
                   prefill_vs_fp32_argmax_agree=float((want.argmax(-1) == ref.argmax(-1))
                                                      .float().mean()))
        assert bool(agree[clear].all()), f"fill against prefill: a clear row's argmax moved: {out}"
        assert (max_abs / scale <= FILL_MAX_ABS
                or fill_err <= FILL_WITNESS_FACTOR * prefill_err), f"fill against prefill: {out}"
        return out

    return rule


def lm_recurrent_fp32_checks(dev, xlstm, zamba, S=64, chunk=16):
    """Phase 20a (``lm_recurrent_fp32``): xLSTM-1.3B and Zamba2-2.7B at
    their published widths and one unit each (``xlstm``: 7 mLSTM + 1
    sLSTM; ``zamba``: 6 Mamba2 and the shared block), fp32 with TF32 off,
    B = 2 prompts of S tokens in chunks of ``chunk`` (several chunks and
    the carried state): the card's ``forward`` against the CPU's on the
    same params, and the card's teacher-forced ``decode_step`` against its
    own ``forward``, each at LM_TOL in units of ``logit_scale`` (xLSTM's
    tied N(0, 1) head puts its logits' RMS near 40, so an fp32 rounding
    of 1e-5 of that scale is 4e-4 absolute). Returns {check: (max |err|,
    relative, the scale)}."""
    import torch

    from repro_torch.models import RunCtx, forward, init_params
    from repro_torch.models.lm import map_tree

    rng = np.random.default_rng(3)
    ctx = RunCtx(rec_chunk=chunk)
    errs = {}
    for name, cfg in (("xlstm", xlstm), ("zamba2", zamba)):
        params = init_params(cfg, 0, device=dev)
        cpu = map_tree(params, lambda t: t.cpu())
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, S)))
        got, _ = forward(params, cfg, {"tokens": toks.to(dev)}, ctx)
        want, _ = forward(cpu, cfg, {"tokens": toks}, ctx)
        errs[f"{name}_card_vs_cpu"] = lm_close_scaled(got, want, f"{name} card against CPU")
        del cpu, want
        errs[f"{name}_decode_vs_forward"] = lm_close_scaled(
            teacher_forced(params, cfg, toks.to(dev)), got, f"{name} decode against forward")
        del params, got
        torch.cuda.empty_cache()
    return errs


def decode_at_length(dev, cfg, params, B, max_len, steps=8):
    """``steps`` decode steps timed at the last positions of a fresh cache
    of ``max_len`` (after one untimed step): the attention's cost and
    bound at that length (the port attends over the whole cache); every
    logit finite. Returns the numbers."""
    import torch

    from repro_torch.launch.roofline import decode_bound
    from repro_torch.models import decode_step, init_cache

    torch.cuda.empty_cache()
    cache = init_cache(cfg, B, max_len, device=dev)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    lo = max_len - steps
    lg, _ = decode_step(params, cfg, tok, torch.full((B,), lo - 1, device=dev), cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, _ = decode_step(params, cfg, lg.argmax(-1), torch.full((B,), lo + i, device=dev),
                            cache)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    assert bool(torch.isfinite(lg).all()), f"{cfg.name} at {max_len}: a non-finite logit"
    db = decode_bound(cfg, params, B, max_len - (steps - 1) / 2,
                      state_bytes=state_bytes_of(cache))
    out = dict(max_len=max_len, positions=[lo, max_len - 1],
               cache_bytes=sum(t.numel() * t.element_size() for _, t in _leaves(cache)),
               decode_ms_per_step=step_s * 1e3, decode_bytes_per_step=db["bytes"],
               decode_bound_ms_per_step=db["bound_ms"])
    del cache
    torch.cuda.empty_cache()
    return out


def slstm_prefill_ms(dev, cfg, params, B, S):
    """Device-synchronised ms of one sLSTM layer's mixer over B × S tokens
    (a step-by-step loop on the host), after one untimed call."""
    import torch

    from repro_torch.models import recurrent

    mix = {k: v[0] for k, v in params["units"]["slstm"]["mix"].items()}
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    recurrent.slstm_mix(mix, cfg, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recurrent.slstm_mix(mix, cfg, x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def serve_lm_recurrent(dev, smi, long_len=4224):
    """Phase 20 (``lm_recurrent``): the recurrent families on the card. (a)
    ``lm_recurrent_fp32_checks``: xLSTM-1.3B at 8 layers, Zamba2-2.7B at 6,
    fp32. (b) Each as published in bf16 through ``lm_served``: the ``lm``
    cell's traffic (8 prompts of 1024 tokens, prefill, a 1152-position
    cache, 64 greedy steps, 8 under the profiler) with the fill over the
    prompts' first FILL_TOKENS tokens, held against a prefill of those;
    then ``decode_at_length`` at ``long_len`` positions (a recurrent state
    is the same at any length, Zamba2's shared KV grows) and, for xLSTM,
    one sLSTM layer's prefill time. The path runs no hand-written kernel:
    the launch counts stay 0. Prints the ``{"lm_recurrent": ...}`` line."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    xl, zb = configs.get_config("xlstm-1.3b"), configs.get_config("zamba2-2.7b")

    def fp32(cfg, layers):
        return cfg.replace(dtype="float32", param_dtype="float32", num_layers=layers)

    errs = lm_recurrent_fp32_checks(dev, fp32(xl, 8), fp32(zb, 6))
    rel = {k: r for k, (_, r, _) in errs.items()}
    scales = {k: sc for k, (_, _, sc) in errs.items()}
    errs = {k: e for k, (e, _, _) in errs.items()}
    log(phase="lm_recurrent_fp32", tol=LM_TOL, max_abs_err=errs, rel_err=rel,
        logit_scale=scales, seconds=time.perf_counter() - t_phase, card=smi)
    served = {}
    for cfg in (xl, zb):
        t0 = time.perf_counter()
        out, st = lm_served(dev, cfg, fill=FILL_TOKENS, keep=True, rule=recurrent_fill_rule(cfg))
        del st["filled"]
        out["long"] = decode_at_length(dev, cfg, st["params"], 8, long_len)
        if "slstm" in st["params"]["units"]:
            out["slstm_layer_prefill_ms"] = slstm_prefill_ms(dev, cfg, st["params"], 8, 1024)
        out["seconds"] = time.perf_counter() - t0
        served[cfg.name] = out
        del st
        torch.cuda.empty_cache()
        log(phase="lm_recurrent_model", **out, card=smi)
    counts = ops.launch_counts()
    assert not any(counts.values()), counts
    print(json.dumps({"lm_recurrent": dict(
        models=served, fp32_max_abs_err=errs, fp32_rel_err=rel, fp32_logit_scale=scales,
        fp32_tol=LM_TOL, fill_witness_factor=FILL_WITNESS_FACTOR,
        fill_tokens=FILL_TOKENS, fill_max_abs_limit=FILL_MAX_ABS,
        fill_argmax_agree_limit=FILL_ARGMAX_AGREE, tf32=torch.backends.cuda.matmul.allow_tf32,
        kernel_launches=sum(counts.values()), seconds=time.perf_counter() - t_phase,
        card=smi)}, default=float), flush=True)


TRAIN_TOL = 1e-3             # a gradient leaf, card against CPU, in units of its max |g|
OPT_TOL = 1e-5               # opt_update, card against CPU, in units of each leaf's max |value|
GRAD_FLOOR = 1e-4            # a gradient leaf's unit: at least this share of the tree's max |g|


def tree_err(got, want, what, tol, floor=0.0):
    """The largest max |got − want| / max |want| over the leaves of two
    trees (compared in f32 on ``got``'s device), held at ``tol``;
    returns (it, its leaf's path). With ``floor``, a leaf's unit is at
    least ``floor`` × the tree's largest |want|: a gradient that is 0 but
    for roundoff (the key bias's: a bias on every key of a query leaves
    its softmax unchanged) has no scale of its own."""
    import torch

    got = dict(_leaves(got, full=True))
    dev = next(iter(got.values())).device
    want = {k: w.to(dev).float() for k, w in _leaves(want, full=True)}
    top = max(float(w.abs().max()) for w in want.values())
    worst = (0.0, None)
    for name, g in got.items():
        w, g = want[name], g.float()
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), (what, name)
        unit = max(float(w.abs().max()), floor * top, 1e-30)
        worst = max(worst, (float((g - w).abs().max()) / unit, name), key=lambda e: e[0])
    assert worst[0] <= tol, f"{what}: {worst}"
    return worst


def train_fp32_checks(dev, qwen, olmoe, xlstm, B=2, S=64):
    """Phase 21a (``train_fp32``): full widths at reduced depth, fp32 with
    TF32 off, B × S tokens of ``TokenPipeline``'s stream. (1) For each
    config the card's ``loss_fn`` and every gradient leaf against the
    CPU's on the same params (OLMoE through the dense path, its aux in the
    loss; xLSTM in chunks of 16), each leaf at TRAIN_TOL in units of its
    max |g|. (2) From Qwen's gradients, one AdamW and one Adafactor
    ``opt_update`` of its units and final norm on the card against the
    CPU's (OPT_TOL). (3) Qwen's μ
    after a ``make_train_step`` step at 2 microbatches against 1
    (TRAIN_TOL). Returns the numbers of the ``train_fp32`` line."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.models import RunCtx, init_params
    from repro_torch.models.lm import map_tree
    from repro_torch.train import OptConfig, init_opt_state, make_train_step, opt_update
    from repro_torch.train.train_loop import _grads_of

    out, kept = {}, None
    for name, cfg, ctx in (("qwen", qwen, RunCtx()), ("olmoe", olmoe, RunCtx()),
                           ("xlstm", xlstm, RunCtx(rec_chunk=16))):
        t0 = time.perf_counter()
        batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B).batch_for_step(0)
        on = lambda d, b=batch: {k: torch.from_numpy(v).to(d) for k, v in b.items()}
        params = init_params(cfg, 0, device=dev)
        cpu = map_tree(params, lambda t: t.cpu())
        loss, metrics, grads = _grads_of(params, cfg, on(dev), ctx)
        torch.cuda.synchronize()
        t_cpu = time.perf_counter()
        want_loss, want_metrics, want = _grads_of(cpu, cfg, on("cpu"), ctx)
        cpu_s = time.perf_counter() - t_cpu
        rel = {k: abs(float(metrics[k]) - float(want_metrics[k]))
               / max(abs(float(want_metrics[k])), 1.0) for k in metrics}
        assert max(rel.values()) <= LM_TOL, (name, rel)
        worst = tree_err(grads, want, f"{name} gradients", TRAIN_TOL, GRAD_FLOOR)
        out[name] = dict(loss=float(loss), cpu_loss=float(want_loss),
                         aux=float(metrics["aux"]), metrics_rel_err=rel,
                         grad_leaves=len(_leaves(grads)), grad_max_rel_err=worst[0],
                         grad_worst_leaf=worst[1], cpu_seconds=cpu_s,
                         seconds=time.perf_counter() - t0)
        if name == "qwen":
            kept = (cfg, params, cpu, grads, on(dev))
        del params, cpu, grads, want
        torch.cuda.empty_cache()

    cfg, params, cpu, grads, batch = kept
    t0 = time.perf_counter()
    # the units (stacked [2, ...] leaves, factored and not, one over the
    # in-place slice) and the final norm: the embedding and head are the
    # same arithmetic on larger leaves, and 5× the CPU's time
    sub = lambda tree: {k: tree[k] for k in ("units", "final_norm")}
    p_sub, g_sub, c_sub = sub(params), sub(grads), sub(cpu)
    g_cpu = map_tree(g_sub, lambda t: t.cpu())
    for opt_name in ("adamw", "adafactor"):
        ocfg = OptConfig(name=opt_name, lr=1e-3)
        p_dev, s_dev = opt_update(p_sub, g_sub, init_opt_state(p_sub, ocfg), ocfg)
        p_cpu, s_cpu = opt_update(c_sub, g_cpu, init_opt_state(c_sub, ocfg), ocfg)
        assert int(s_dev["step"]) == int(s_cpu["step"]) == 1
        out[f"opt_{opt_name}"] = dict(
            params=tree_err(p_dev, p_cpu, f"{opt_name} params", OPT_TOL),
            state=tree_err(s_dev, s_cpu, f"{opt_name} state", OPT_TOL))
        del p_dev, s_dev, p_cpu, s_cpu
    out["opt_params"] = sum(t.numel() for _, t in _leaves(p_sub))
    out["opt_seconds"] = time.perf_counter() - t0
    del cpu, g_cpu, grads, p_sub, g_sub, c_sub
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ocfg = OptConfig(lr=1e-3)
    mus = []
    for mb in (1, 2):
        _, o, _ = make_train_step(cfg, ocfg, RunCtx(), mb)(params, init_opt_state(params, ocfg),
                                                           batch)
        mus.append(o["mu"])
        del o
    out["microbatch_2_vs_1_mu"] = tree_err(mus[1], mus[0], "mu at 2 microbatches", TRAIN_TOL,
                                           GRAD_FLOOR)
    out["microbatch_seconds"] = time.perf_counter() - t0
    del params, mus
    torch.cuda.empty_cache()
    return out


def lm_train(dev, cfg, B=4, S=1024, warm=2, timed=8, traced=2):
    """Phase 21b (``train``): ``cfg`` as published (its bf16, AdamW from
    ``cfg.optimizer``, ``cfg.remat`` on, ``RunCtx()``) from the port's
    seeded init, trained on ``TokenPipeline(vocab, S, B, seed=0)`` by
    ``train_loop``'s in-place step (``make_inplace_train_step``): ``warm``
    steps, ``timed`` steps (host clock, each ending in a synchronize), one
    step timed in its halves (loss and gradients; the in-place update),
    then ``traced`` under the profiler (idle share, device ms by kernel
    name). Every loss and grad norm
    must be finite and the mean of the last 3 losses below the first.
    The bound of a step: ``roofline.train_step_bound`` (4 × the prefill
    FLOPs of ``lm_bounds`` over 989 TFLOP/s, plus the optimizer's bytes
    over 3.35 TB/s). Returns the numbers of the ``train`` line."""
    import torch

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.roofline import train_step_bound
    from repro_torch.models import RunCtx, init_params
    from repro_torch.train import OptConfig, init_opt_state
    from repro_torch.train.optimizer import opt_update_
    from repro_torch.train.train_loop import _value_and_grads, make_inplace_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    ocfg = OptConfig(name=cfg.optimizer)
    opt = init_opt_state(params, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda tree: sum(t.numel() * t.element_size() for _, t in _leaves(tree))
    param_bytes, opt_bytes = nbytes(params), nbytes(opt)
    unit_bytes = nbytes(params["units"])
    n_params = sum(t.numel() for _, t in _leaves(params))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    step = make_inplace_train_step(cfg, ocfg, RunCtx())
    losses, gnorms, step_ms = [], [], []

    def run(i):
        metrics = step(params, opt, pipe.batch_for_step(i))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))

    for i in range(warm + timed):
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # one step in its two halves: the loss and gradients, then the update
    split = {}
    grads_of = _value_and_grads(cfg, ocfg, RunCtx(), 1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_for_step(warm + timed).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics, grads = grads_of(params, batch)
    torch.cuda.synchronize()
    split["loss_and_grads_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    opt_update_(params, grads, opt, ocfg)
    torch.cuda.synchronize()
    split["optimizer_ms"] = (time.perf_counter() - t0) * 1e3
    losses.append(float(metrics["loss"]))
    gnorms.append(float(opt["gnorm"]))
    del grads, batch
    by_name = {}
    _, busy_ms, wall_ms = profiled(lambda: [run(warm + timed + 1 + i) for i in range(traced)],
                                   by_name)
    short = {}                              # names cut to 90 characters, their times summed
    for name, ms in by_name.items():
        short[name[:90]] = short.get(name[:90], 0.0) + ms
    top = sorted(short.items(), key=lambda kv: -kv[1])[:15]
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (losses, gnorms)
    assert np.mean(losses[-3:]) < losses[0], losses
    assert int(opt["step"]) == warm + timed + 1 + traced
    bound = train_step_bound(cfg, params, B, S)
    grad_bytes = param_bytes
    med = float(np.median(step_ms[warm:]))
    out = dict(
        model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        dtype=cfg.dtype, optimizer=cfg.optimizer, lr=ocfg.lr, remat=cfg.remat,
        remat_policy=RunCtx().remat_policy, batch=B, seq=S, params=n_params, init_s=init_s,
        param_bytes=param_bytes, opt_bytes=opt_bytes, grad_bytes=grad_bytes,
        peak_allocated_bytes=peak,
        # the steady params + moments + gradients, and the units' gradients
        # stacked once beside their per-unit slices (PERF.md §6)
        peak_predicted_bytes=param_bytes + opt_bytes + grad_bytes + unit_bytes,
        step_ms_warm=step_ms[:warm], step_ms=step_ms[warm:], step_ms_median=med,
        tokens_per_s=B * S / (med / 1e3), losses=losses, grad_norms=gnorms,
        flops_per_step=bound["flops"], optimizer_bytes_per_step=bound["optimizer_bytes"],
        bound_ms=bound["bound_ms"], bound_gemm_ms=bound["bound_gemm_ms"],
        bound_optimizer_ms=bound["bound_optimizer_ms"], bound_share=bound["bound_ms"] / med,
        idle_share_traced=idle_share(busy_ms, wall_ms), busy_ms_traced=busy_ms,
        wall_ms_traced=wall_ms, traced_steps=traced, **split,
        top_device_ms_per_step={k: v / traced for k, v in top})
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def train_launch(smi, steps=20, resume_steps=10):
    """Phase 21c (``train_launch``): ``python -m repro_torch.launch.train
    --arch qwen1.5-4b --smoke --steps 20`` with a checkpoint directory under
    ``build/``, then ``--steps 10`` again: the second run must resume from
    step 20 and end on a finite loss. The directory is removed."""
    import os

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="train_launch_", dir=root))
    env = dict(os.environ, PYTHONPATH=str(root.parent / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-4b",
           "--smoke", "--ckpt-dir", str(ckpt)]
    runs = []
    try:
        for n in (steps, resume_steps):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + ["--steps", str(n)], env=env, capture_output=True,
                                  text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            assert proc.returncode == 0, f"train launch exited {proc.returncode}: " \
                                         f"{proc.stderr[-3000:]}"
            final = float(lines[-1].split()[-1])
            assert lines[-1].startswith("final loss") and np.isfinite(final), lines
            runs.append(dict(steps=n, seconds=time.perf_counter() - t0, final_loss=final,
                             stdout=lines))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert f"resumed from step {steps}" in runs[1]["stdout"], runs[1]["stdout"]
    return dict(cmd=" ".join(cmd[1:4] + cmd[4:6]), runs=runs, card=smi)


def serve_lm_train(dev, smi):
    """Phase 21 (``lm_train``): the LM substrate's training path on the card.
    (a) ``train_fp32_checks``: Qwen1.5-4B and OLMoE-1B-7B at 2 layers,
    xLSTM-1.3B at 8 (7 mLSTM + 1 sLSTM), published widths, fp32;
    (b) ``lm_train``: Qwen1.5-4B as published, bf16, AdamW, remat;
    (c) ``train_launch``: the launcher, trained and resumed in two
    subprocesses. The path runs no hand-written kernel: the launch counts
    stay 0. Prints the ``train_fp32`` line and the ``{"train": ...}``
    line."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops

    def fp32(name, layers):
        return configs.get_config(name).replace(dtype="float32", param_dtype="float32",
                                                num_layers=layers)

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    checks = train_fp32_checks(dev, fp32("qwen1.5-4b", 2), fp32("olmoe-1b-7b", 2),
                               fp32("xlstm-1.3b", 8))
    log(phase="train_fp32", tol=TRAIN_TOL, opt_tol=OPT_TOL, grad_floor=GRAD_FLOOR,
        tf32=torch.backends.cuda.matmul.allow_tf32, **checks,
        seconds=time.perf_counter() - t_phase, card=smi)
    t0 = time.perf_counter()
    trained = lm_train(dev, configs.get_config("qwen1.5-4b"))
    trained["train_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launched = train_launch(smi)
    launched["seconds"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    assert not any(counts.values()), counts
    print(json.dumps({"train": dict(
        trained, fp32=checks, fp32_tol=TRAIN_TOL, opt_tol=OPT_TOL, launch=launched,
        kernel_launches=sum(counts.values()), seconds=time.perf_counter() - t_phase,
        card=smi)}, default=float), flush=True)
    return trained


DRYRUN_PEAK_TOL = 0.10       # the dry run's predicted peak against the card's, relative


def serve_dryrun(dev, smi, lm, trained, index, q, want_s, want_i, dist_row, ring128):
    """Phase 22 (``dryrun``): the port's analysis layer held against the
    card. (a) ``launch.dryrun.trace_cell`` on ``meta`` of the two cells
    phases 18 and 21 ran (Qwen1.5-4B in bf16: the prefill at ``lm``'s B and
    S, the AdamW step with remat at ``trained``'s): each cell's bound must
    equal the one the phase logged (one code, ``launch.roofline``), its
    predicted peak (arguments + temp) lie within DRYRUN_PEAK_TOL of the
    peak the phase measured (the timed prefill's own; the train phase's),
    and its FLOPs are logged beside ``lm_bounds``'; the dry run launches
    nothing and leaves the card's memory as it was. (b) The pod step:
    ``spmd_search`` with P = 2 over ``VirtualMesh(data=2, model=2,
    pod=2)``, fp32 and int8, against the oracle rows. (c) The H100 model:
    ``calibrate_hardware`` from phase 2's distance kernel at the 1x1 ring
    shape (every tile alive), the host ms a launch of phase 3's fp32 1x1
    128-query batch and one timed 256 MiB device-to-device copy;
    ``plan_cost`` of the SIFT1M cell's 1x1 and 2x2 plans for that batch
    under ``H100_SXM`` and the calibrated model, beside phase 3's walls;
    the calibrated model must rank the two meshes as the card ran them.
    Prints the ``{"dryrun": ...}`` line; returns the pod step's launch
    counts."""
    import torch

    from repro_torch import configs
    from repro_torch.core import (H100_SXM, PartitionPlan, WorkloadStats, assign_queries,
                                  calibrate_hardware, plan_cost)
    from repro_torch.core.router import load_aware_assignment
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline

    t_phase = time.perf_counter()
    qwen = configs.get_config("qwen1.5-4b")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    card_bytes = torch.cuda.memory_allocated()
    cells = {}
    for kind, B, S, logged, measured in (
            ("prefill", lm["batch"], lm["prompt"], lm["prefill_bound_ms"],
             lm["prefill_peak_allocated_bytes"]),
            ("train", trained["batch"], trained["seq"], trained["bound_ms"],
             trained["peak_allocated_bytes"])):
        t0 = time.perf_counter()
        cell = dryrun.trace_cell(qwen, roofline.custom_shape(kind, B, S))
        row = roofline.analyze([cell])[0]
        mem = cell["variants"]["full"]["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        rel = predicted / measured - 1
        assert cell["bound"]["bound_ms"] == logged, (kind, cell["bound"]["bound_ms"], logged)
        assert abs(rel) <= DRYRUN_PEAK_TOL, (
            f"{kind}: predicted peak {predicted} against {measured} measured")
        cells[kind] = dict(
            shape=cell["shape"], bound_ms=cell["bound"]["bound_ms"], logged_bound_ms=logged,
            predicted_peak_bytes=predicted, argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], measured_peak_bytes=measured, peak_rel_err=rel,
            flops_counted=cell["stack"]["flops"],
            flops_combined=roofline._combine(cell, lambda v: v["flops"]),
            lm_bounds_flops=cell["bound"]["flops"],
            bytes_accessed=cell["stack"]["bytes_accessed"], aten_ops=cell["stack"]["ops"],
            compute_ms=row["compute_s"] * 1e3, memory_ms=row["memory_s"] * 1e3,
            dominant=row["dominant"], fits_hbm=row["fits_hbm"],
            seconds=time.perf_counter() - t0)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    assert not any(counts.values()), counts
    assert torch.cuda.memory_allocated() == card_bytes, "the dry run allocated on the card"

    pod_counts, pod = spmd_search(dev, smi, index, q, want_s, want_i, V=2, B=2, P=2,
                                  phase="dryrun_pod_step")

    m, n, d = dist_row["M"], dist_row["N"], dist_row["Db"]
    _, flops = roofline.distance_launch(m, n, d, -(-m // 128) * -(-n // 128))
    x = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    copy_ms, _ = time_ms(lambda: y.copy_(x), reps=20)
    host = ring128[(1, 1)]
    calibrated = calibrate_hardware(
        distance_flops=flops, distance_s=dist_row["kernel_ms_all_alive"] / 1e3,
        host_s_per_launch=host["wall_ms"] / host["launches"] / 1e3,
        copy_bytes=x.numel() * x.element_size(), copy_s=copy_ms / 1e3)
    del x, y
    torch.cuda.empty_cache()
    hits = np.bincount(assign_queries(index, q).reshape(-1), minlength=len(index.sizes))
    w = WorkloadStats(cluster_sizes=np.asarray(index.sizes), cluster_hits=hits,
                      dim=index.dim, nq=len(q), topk=want_s.shape[1])
    plans = {"1x1": PartitionPlan(v_shards=1, d_blocks=1,
                                  cluster_to_shard=np.zeros(len(index.sizes), np.int32)),
             "2x2": PartitionPlan(v_shards=2, d_blocks=2,
                                  cluster_to_shard=load_aware_assignment(index.sizes, hits, 2))}
    costs = {name: {mesh: plan_cost(plan, w, model) for mesh, plan in plans.items()}
             for name, model in (("h100_sxm", H100_SXM), ("calibrated", calibrated))}
    walls = {"1x1": ring128[(1, 1)]["wall_ms"], "2x2": ring128[(2, 2)]["wall_ms"]}
    cal = costs["calibrated"]
    assert (cal["1x1"]["cost"] < cal["2x2"]["cost"]) == (walls["1x1"] < walls["2x2"]), (
        cal, walls)
    hardware = dict(
        calibrated=dict(flops_rate=calibrated.flops_rate, net_bw=calibrated.net_bw,
                        net_latency=calibrated.net_latency),
        h100_sxm=dict(flops_rate=H100_SXM.flops_rate, net_bw=H100_SXM.net_bw,
                      net_latency=H100_SXM.net_latency),
        inputs=dict(distance_ms=dist_row["kernel_ms_all_alive"], distance_flops=flops,
                    host_ms_per_launch=host["wall_ms"] / host["launches"],
                    batch_launches=host["launches"], copy_ms=copy_ms,
                    copy_bytes=64 * 2 ** 20 * 4),
        plan_cost=costs, measured_wall_ms=walls,
        calibrated_ranks_as_measured=True)
    print(json.dumps({"dryrun": dict(
        cells=cells, peak_tol=DRYRUN_PEAK_TOL, pod_step=pod, hardware=hardware,
        seconds=time.perf_counter() - t_phase, card=smi)}, default=float), flush=True)
    return pod_counts


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
    prewarm = prewarm_kernel(dev, smi)                  # 2b. the τ prewarm

    # ---------------------------------------------------------- 3. serving
    nb, nlist, ncomp = 1_000_000, 1024, 256
    t0 = time.perf_counter()
    ds = make_dataset(nb=nb, dim=128, n_components=ncomp, spread=0.6, seed=0)
    sizes = (1, 8, 32, 128, 160)
    lo128 = sum(sizes[:3])                # where the 128-query batch starts
    q_all = make_queries(ds, nq=sum(sizes), skew=0.3, seed=1)
    t_data = time.perf_counter() - t0
    cfg = HarmonyConfig(dim=128, nlist=nlist, nprobe=16, topk=10)
    mb0 = device_mb()
    t0 = time.perf_counter()
    index = build_ivf(ds.x, cfg)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    index_card_mb = device_mb() - mb0
    rows_mb = index.x.numel() * 4 / 2 ** 20
    # the plane keeps its rows on the host: before any executor the card
    # holds under 5 % of them
    assert index.x.device.type == "cpu" and index_card_mb < 0.05 * rows_mb, index_card_mb
    t0 = time.perf_counter()
    oracle = search_oracle(index, q_all)
    true_idx, _ = brute_force_topk(ds.x, q_all, 10)
    log(phase="index", nb=nb, dim=128, nlist=nlist, nprobe=16, topk=10,
        data_s=t_data, build_s=t_build, oracle_and_truth_s=time.perf_counter() - t0,
        rows_mb=rows_mb, rows_pinned=index.x.is_pinned(), index_card_mb=index_card_mb,
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
              "running_topk_update": 0, "partial_distance_update_bf16": 0,
              "running_topk_update_large_k": 0, "running_topk_update_huge_k": 0,
              "tau_prewarm": 0}
    fp32_mb = {}              # mesh → the fp32 executor's resident MB
    splits = {}               # (tier, mesh, M, K) → survivor histogram
    ring128 = {}              # mesh → the fp32 128-query batch's wall ms and launches
    for mesh in ((1, 1), (2, 2)):
        mb_before = torch.cuda.memory_allocated() / 2 ** 20
        ex = SpmdExecutor(index, ExecutorConfig(d_blocks=mesh[1]), mesh=mesh)
        executor_mb = torch.cuda.memory_allocated() / 2 ** 20 - mb_before
        fp32_mb[mesh] = executor_mb
        ops.reset_launch_counts()
        t_mesh = time.perf_counter()
        lo, walls = 0, {}
        for n in sizes:
            before = ops.launch_counts()
            res = ex.search_batch(q_all[lo:lo + n])
            after = ops.launch_counts()
            walls[n] = res.stats["wall_s"] * 1e6
            # one prewarm launch a served part, on the card route
            assert after["tau_prewarm"] - before["tau_prewarm"] == res.stats["splits"]
            if n == 128:
                ring128[mesh] = dict(wall_ms=walls[n] / 1e3, launches=sum(
                    after[k] - before[k] for k in after))
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
        assert counts["tau_prewarm_ref"] == 0, "plain prewarm ran"
        for k in served:
            served[k] += counts[k]
        profile_128(ex, mesh, walls, "fp32")
        split, hist = survivor_split(ex, q_all[lo128:lo128 + 128], 10)
        splits[("fp32", f"{mesh[0]}x{mesh[1]}", 128 // mesh[1], 10)] = hist
        log(phase="topk_survivors", mesh=f"{mesh[0]}x{mesh[1]}", precision="fp32",
            nq=128, K=10, **split)
        if mesh == (1, 1):      # the served k = 300 ring (route 2)
            split, hist = survivor_split(ex, q_all[lo128:lo128 + 128], 300, k_search=300)
            splits[("fp32_k300", "1x1", 128, 300)] = hist
            log(phase="topk_survivors", mesh="1x1", precision="fp32", nq=128, K=300, **split)
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
        rows = torch.as_tensor(packed_rows(ids))
        x64 = index.x[rows].to(dev).double()
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
        if mesh == (1, 1):      # the served int8 k = 100 ring, K' = 400 (route 2)
            split, hist = survivor_split(ex, q_all[lo128:lo128 + 128], 400, k_search=100)
            splits[("int8_k100", "1x1", 128, 400)] = hist
            log(phase="topk_survivors", mesh="1x1", precision="int8", nq=128, K=400, **split)
        del ex
        torch.cuda.empty_cache()

    # ---------------------------------------------------- 4b. the whole-mesh step
    counts, _ = spmd_search(dev, smi, index, q_all[lo128:lo128 + 128],
                            oracle.scores[lo128:lo128 + 128], oracle.ids[lo128:lo128 + 128])
    for k in served:
        served[k] += counts[k]

    time_topk_path_shaped(dev, smi, splits)

    # ---------------------------------------------------------- 5. serve_engine
    counts, plane = serve_engine(dev, smi, index, ds, q_all, sizes)
    for k in served:
        served[k] += counts[k]
    time_merge_shapes(dev, smi)

    # ------------------------------------- 6-13. the later slices' served paths
    q128 = q_all[lo128:lo128 + 128]
    paths = [serve_large_k(dev, smi, plane, q128)]
    paths.append(serve_huge_k(dev, smi, plane, q128[:8]))
    # 10-13: durability, compaction and placement on the same plane, whose
    # only reference goes to serve_durable (its "crash" must free it)
    holder = [plane]
    del plane
    tmp_root = Path(__file__).resolve().parent / "build"
    tmp_root.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="durable_", dir=tmp_root))
    try:
        counts, data, srv, wal = serve_durable(dev, smi, holder, root, ds, q128)
        paths.append(counts)
        paths.append(serve_compactor(dev, smi, data, srv, ds, q128))
        paths.append(serve_placement(dev, smi, data, srv, q128))
        data.attach_wal(None)
        wal.close()
        del data, srv, wal
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    paths.append(serve_bf16(dev, smi, index, q128, fp32_mb[(1, 1)]))
    paths.extend(serve_filtered_and_tiered(dev, smi, index, ds, q_all))
    paths.extend(serve_plane(dev, smi, index, ds))      # 13-16. the serving plane
    serve_launch(smi)                                   # 17. the launcher
    for counts in paths:
        for k in served:
            served[k] += counts[k]
    lm = serve_lm(dev, smi)                             # 18. the LM substrate
    serve_lm_moe(dev, smi)                              # 19. its MoE serving path
    serve_lm_recurrent(dev, smi)                        # 20. the recurrent families
    trained = serve_lm_train(dev, smi)                  # 21. the training path
    counts = serve_dryrun(dev, smi, lm, trained, index, q_all[lo128:lo128 + 128],
                          oracle.scores[lo128:lo128 + 128], oracle.ids[lo128:lo128 + 128],
                          timed["partial_distance_update"], ring128)       # 22. dry run
    for k in served:
        served[k] += counts[k]

    # ---------------------------------------------------------- 23. report
    # one entry per kernel route; a kernel's own count takes all of its
    # routes, so the f32-row and K <= 256 entries are the rest
    sources = {
        "partial_distance_update": ("src/repro_torch/kernels/csrc/partial_distance.cu",
                                    "src/repro/kernels/distance.py:127"),
        "partial_distance_update_bf16": ("src/repro_torch/kernels/csrc/partial_distance.cu",
                                         "src/repro/kernels/distance.py:127"),
        "int8_partial_distance_update": (
            "src/repro_torch/kernels/csrc/partial_distance_int8.cu",
            "src/repro/kernels/distance_int8.py:139"),
        "running_topk_update": ("src/repro_torch/kernels/csrc/topk_update.cu",
                                "src/repro/kernels/topk_update.py:93"),
        "running_topk_update_large_k": ("src/repro_torch/kernels/csrc/topk_update.cu",
                                        "src/repro/kernels/topk_update.py:93"),
        "running_topk_update_huge_k": ("src/repro_torch/kernels/csrc/topk_update.cu",
                                       "src/repro/kernels/topk_update.py:93"),
    }
    launches = dict(served)
    launches["partial_distance_update"] -= served["partial_distance_update_bf16"]
    launches["running_topk_update"] -= (served["running_topk_update_large_k"]
                                        + served["running_topk_update_huge_k"])
    kernels = []
    for name, (source, replaces) in sources.items():
        row = timed[name]
        assert launches[name] > 0, f"{name}: no launch on the served paths"
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    assert served["tau_prewarm"] > 0, "tau_prewarm: no launch on the served paths"
    kernels.append(dict(
        name="tau_prewarm", route="cuda", source="src/repro_torch/kernels/csrc/tau_prewarm.cu",
        replaces="none (src/repro/core/pruning.py prewarm_tau is numpy)",
        launches=served["tau_prewarm"], max_abs_err=prewarm["max_abs_err"],
        max_err_over_slack=prewarm["max_err_over_slack"],
        ms=prewarm["kernel_ms"], plain_ms=prewarm["plain_ms"], bound_ms=prewarm["bound_ms"],
        bound_by=prewarm["bound_by"], library_ms="none"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
