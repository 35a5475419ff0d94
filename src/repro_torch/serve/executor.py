"""Batched search executor on one GPU.

The port of ``repro/serve/executor.py``, in both tiers and both
precisions:

* **Corpus residency** — the sharded corpus, per-block norms, cluster ids
  and packed row positions (int32 whatever the external ids; the host
  maps them to ids after the batch) are packed once on the host,
  block-major for the virtual V × B mesh
  (:func:`repro_torch.core.pipeline.resident_arrays`), and
  uploaded as the device's one copy of the sharded rows (the index's
  own ``x`` stays on the host). A batch moves only its queries, probe table, τ seeds
  and an int32 row-index table to the device.
* **Host tier** (``tier="host"``) — for a demoted segment nothing stays on
  the card: the packed arrays live in pinned host memory, and per batch
  only the probed rows are gathered on the host
  (:func:`repro_torch.core.pipeline.gather_host_candidates`) into a fixed
  candidate buffer set of the batch's cap bucket, then copied with
  ``non_blocking=True`` on a side CUDA stream; the ring's stream waits on
  the copy's event before its first launch. :meth:`SpmdExecutor.prefetch`
  stages the next batch's upload (two slots, keyed on the gather table)
  while the current one computes. The gathered values, the buckets and
  the kernels are the device tier's, so results are bit-identical.
* **Candidate gather** — probed clusters are contiguous row ranges of the
  resident shards, so the host computes a per-shard row-index union
  (tombstones dropped) and the device gathers those rows into a padded
  candidate buffer; the ring then scans ``cap_b`` rows, not the shard.
* **Bucketing** — query count and candidate volume are padded up a small
  ladder of (qb, cap) buckets, as in the reference. A bucket's step is
  built once (``trace_counts``), batches above the largest qb bucket are
  split and merged host-side.
* **int8 tier** (``precision="int8"``) — the resident corpus is the int8
  codes of a per-dimension-block grid (4× smaller than fp32 rows) with
  pre-scaled norms and each block's s²; the ring keeps the quantized
  top ``K' = k·rerank_factor`` and :meth:`SpmdExecutor._rerank` rescores
  those survivors exactly in fp32 on the card: their rows of the host
  ``index.x`` are gathered and uploaded per batch.
* **bf16 rows** (``x_dtype="bfloat16"``, fp32 precision) — the resident
  rows are rounded to bf16 (half the bytes) and the distance kernel's bf16
  route widens them to f32; queries, norms and sums stay f32, and the τ
  prewarm scores the rounded rows, so pruning is exact over them.
* **τ prewarm** — a device-tier executor that prunes keeps each list's
  first ``prewarm_samples`` rows on the card
  (:class:`~repro_torch.core.pruning.PrewarmSamples`, packed, in the rows'
  type, and counted in ``segment_device_bytes``) and seeds τ with one
  kernel launch a batch over them; the host tier keeps nothing of a
  demoted segment on the card, so its prewarm gathers the sample rows on
  the host and uploads them.

Exactness: padding adds rows whose cluster id is -1 (match no probe) and
queries whose τ is -inf (everything prunes). Pruning is off for
``metric="ip"``, where partial sums are not monotone. The int8 tier's τ
starts at +inf (an fp32-space prewarm is no bound in the quantized
metric) and tightens within the quantized metric.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.index import IVFIndex, assign_queries, preassign
from repro_torch.core.pipeline import (
    SpmdConfig,
    build_corpus_arrays,
    build_query_arrays,
    gather_host_candidates,
    gather_local_candidates,
    resident_arrays,
    ring_chunk_search,
)
from repro_torch.core.pruning import PrewarmSamples, prewarm_tau
from repro_torch.core.search import kernel_assign_queries, rerank_exact
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.core.types import PartitionPlan, SearchResult
from repro_torch.kernels import topk_update


@dataclass(frozen=True)
class ExecutorConfig:
    """Knobs of the device-resident executor.

    ``qb_buckets`` is the query-count ladder (each entry rounded up to a
    multiple of the mesh's dimension-block count); the candidate-capacity
    ladder is chunk·2^i up to the full shard capacity. ``precision`` is
    ``"fp32"`` or ``"int8"`` (quantized stage 1 keeping
    ``k·rerank_factor`` rows, then an exact fp32 re-rank; L2 only).
    ``x_dtype`` is ``"float32"`` or ``"bfloat16"`` (fp32 precision's
    resident rows). ``use_pallas`` is kept for signature parity;
    ``False`` raises ``NotImplementedError``.
    """

    d_blocks: int = 1
    chunk: int = 256
    qb_buckets: Tuple[int, ...] = (8, 32, 128)
    use_pallas: Optional[bool] = None
    x_dtype: str = "float32"
    precision: str = "fp32"         # "int8" → quantized stage-1 + fp32 re-rank
    rerank_factor: int = 4          # int8: stage-1 keeps k·rerank_factor rows
    tile_m: int = 128
    tile_n: int = 128
    tile_k: int = 128
    prune: Optional[bool] = None    # None → index.cfg.enable_pruning (L2 only)


_CAND = ("x_c", "xn2_c", "cl_c", "id_c")


class _CandBuffers:
    """One fixed candidate buffer set of a host-tier executor's cap bucket:
    pinned host arrays the gather writes, device arrays the ring reads
    (their addresses never move), and the events that order their reuse:
    ``copied`` on the side stream after the upload (the ring waits on it),
    ``consumed`` on the ring's stream after the step (the next upload into
    the set waits on it). ``held`` while a staged or in-flight upload owns
    the set."""

    def __init__(self, shapes: Dict[str, Tuple[tuple, torch.dtype]],
                 device: torch.device, side: Optional["torch.cuda.Stream"]):
        cuda = device.type == "cuda"
        self.host = {n: torch.empty(sh, dtype=dt, pin_memory=cuda)
                     for n, (sh, dt) in shapes.items()}
        self.dev = {n: torch.empty(sh, dtype=dt, device=device)
                    for n, (sh, dt) in shapes.items()}
        if side is not None:
            for t in self.dev.values():
                t.record_stream(side)
        self.started = torch.cuda.Event(enable_timing=True) if cuda else None
        self.copied = torch.cuda.Event(enable_timing=True) if cuda else None
        self.consumed = None
        self.held = False


@dataclass
class _Upload:
    """A candidate upload: the buffer set it fills and the bytes it moves."""

    buf: _CandBuffers
    nbytes: int


class SpmdExecutor:
    """Batched search over the ring pipeline.

    ``mesh`` is the virtual geometry ``(V, B)``, by default
    ``(1, cfg.d_blocks)``; all of it runs on ``device`` (CUDA by default).
    ``tier="device"`` keeps the packed corpus on the device; ``"host"``
    keeps it in (pinned) host memory and streams each batch's probed rows.
    """

    def __init__(
        self,
        index: IVFIndex,
        cfg: Optional[ExecutorConfig] = None,
        mesh: Optional[Tuple[int, int]] = None,
        tier: str = "device",
        device: DeviceLike = None,
    ):
        if tier not in ("device", "host"):
            raise ValueError(f"tier={tier!r}")
        self.tier = tier
        self.index = index
        self.cfg = cfg or ExecutorConfig()
        self.k = index.cfg.topk
        self.metric = index.cfg.metric
        self.precision = self.cfg.precision
        if self.precision not in ("fp32", "int8"):
            raise NotImplementedError(f"precision={self.precision!r}")
        if self.precision == "int8":
            if self.metric != "l2":
                raise ValueError("the int8 tier is L2-only")
            if self.cfg.rerank_factor < 1:
                raise ValueError(f"rerank_factor={self.cfg.rerank_factor}")
        self.device = resolve_device(device)
        self.mesh = tuple(mesh) if mesh is not None else (1, self.cfg.d_blocks)
        V, B = self.mesh
        prune = self.cfg.prune
        if prune is None:
            prune = index.cfg.enable_pruning
        self.prune = bool(prune and self.metric == "l2")
        self.use_pallas = self.cfg.use_pallas

        plan = PartitionPlan(
            v_shards=V,
            d_blocks=B,
            cluster_to_shard=load_aware_assignment(index.sizes, None, V),
            ring_offsets=ring_offsets(V, B),
        )
        # pad_to=chunk keeps the full capacity chunk-aligned
        self.corpus = preassign(index, plan, pad_to=self.cfg.chunk)
        self.cap_full = self.corpus.cap
        dim_pad = -(-index.dim // B) * B
        self._base_scfg = SpmdConfig(
            v_shards=V,
            d_blocks=B,
            qb=8 * B,                   # placeholder; buckets override
            cap=self.cap_full,
            dim=dim_pad,
            nprobe=index.cfg.nprobe,
            k=self.k,
            chunk=self.cfg.chunk,
            metric=self.metric,
            prune=self.prune,
            x_dtype=self.cfg.x_dtype,
            precision=self.precision,
            use_pallas=self.use_pallas,
            tile_m=self.cfg.tile_m,
            tile_n=self.cfg.tile_n,
            tile_k=self.cfg.tile_k,
        )

        self.qb_buckets = tuple(sorted({-(-b // B) * B for b in self.cfg.qb_buckets}))
        caps, c = [], self.cfg.chunk
        while c < self.cap_full:
            caps.append(c)
            c *= 2
        caps.append(self.cap_full)
        self.cap_buckets = tuple(caps)

        # packed on the host (where preassign's layout lives), one upload;
        # the int8 grid is the index's seal-time one where the blocking
        # matches the mesh, else refit to it (_mesh_quant_grid)
        quant = index.int8_quant() if self.precision == "int8" else None
        arrays = build_corpus_arrays(self.corpus, self._base_scfg, quant=quant)
        self._quant_grid = arrays.pop("quant_grid", None)
        # the ring carries packed row positions, not external ids: they fit
        # int32 whatever the ids are, and the host maps them back to ids
        # (and the int8 re-rank to rows of index.x) after the batch
        pos = np.full(self.corpus.ids_shard.shape, -1, np.int32)
        pos[self.corpus.packed_shard, self.corpus.packed_row] = np.arange(
            index.nb, dtype=np.int32)
        arrays["row_ids"] = torch.as_tensor(pos, device=arrays["row_ids"].device)
        packed = resident_arrays(arrays, self._base_scfg)
        self._scale2 = (packed["scale2"].to(self.device)
                        if "scale2" in packed else None)
        self._side: Optional[torch.cuda.Stream] = None
        if tier == "device":
            self._resident = {name: a.to(self.device) for name, a in packed.items()}
            self._host_arrays = None
        else:
            # the cold tier: nothing stays on the card but s² (B floats)
            pin = self.device.type == "cuda"
            self._resident = None
            self._host_arrays = {
                name: (a.cpu().pin_memory() if pin else a.cpu())
                for name, a in packed.items() if name != "scale2"}
            if pin:
                self._side = torch.cuda.Stream(device=self.device)
        del arrays, packed                   # the host tier's device copies go
        # the τ prewarm's sample rows, on the card with the corpus (the
        # int8 tier and a non-pruning executor have no prewarm)
        self._samples: Optional[PrewarmSamples] = None
        if tier == "device" and self.prune and self.precision == "fp32":
            self._samples = PrewarmSamples.build(
                index, index.cfg.prewarm_samples,
                torch.bfloat16 if self.cfg.x_dtype == "bfloat16" else torch.float32,
                self.device)
        # host tier: candidate buffer sets per cap bucket, and the
        # prefetch queue (two slots, keyed on the gather table)
        self._cand_pool: Dict[int, list] = {}
        self._prefetched: Dict[tuple, _Upload] = {}

        # step cache: (qb, cap, k, nprobe) → step; trace_counts counts builds
        self._steps: Dict[Tuple[int, int, int, int], object] = {}
        self.trace_counts: Dict[Tuple[int, int, int, int], int] = {}
        self._probe_widths: set = set()
        self.dispatches = 0
        self.queries = 0
        self.wall_s = 0.0
        self.tile_skipped = 0
        self.tile_total = 0
        # stages t ≥ 1: tiles the probe mask left live, and those of them
        # the τ test emptied (the early stop across dimension blocks)
        self.tiles_after_mask = 0
        self.tiles_stopped = 0
        # host-tier counters (always 0 for a device-tier executor)
        self.cold_dispatches = 0
        self.bytes_streamed = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_staged = 0
        self.upload_ms = 0.0
        self._list_rows: Optional[np.ndarray] = None    # rows a list, while tracing
        self._centroids: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def warmup(self, k: Optional[int] = None, nprobe=None):
        """Build and run every (qb, cap) bucket once, for each probe-table
        width in ``nprobe`` (an int or an iterable; default the config's).
        :meth:`search_batch` pads narrower probe tables up to the nearest
        warmed width."""
        k = self._k_step(k or self.k)
        if nprobe is None:
            widths = (self.index.cfg.nprobe,)
        elif np.ndim(nprobe) == 0:
            widths = (int(nprobe),)
        else:
            widths = tuple(int(w) for w in nprobe)
        for w in widths:
            for qb in self.qb_buckets:
                for cap in self.cap_buckets:
                    bscfg = dataclasses.replace(
                        self._base_scfg, qb=qb, cap=cap, k=k, nprobe=w
                    )
                    step = self._get_step(bscfg)
                    rows = np.full((bscfg.v_shards, cap), -1, np.int32)
                    rows[:, 0] = 0
                    qarr = build_query_arrays(
                        np.zeros((1, self.index.dim), np.float32), bscfg,
                        np.zeros((1, w), np.int32),
                        np.full((1,), np.inf, np.float32),
                        quant_grid=self._quant_grid,
                    )
                    if self.tier == "host":
                        up = self._upload_candidates(rows, cap)
                        step(up, qarr)
                        up.buf.held = False
                    else:
                        step(rows, qarr)
        if self.tier == "host":
            # the ladder's buffer sets go; serving makes those it uses
            self._cand_pool = {cap: [b for b in sets if b.held]
                               for cap, sets in self._cand_pool.items()}

    def _k_step(self, k: int) -> int:
        """The ring's K: k, or the int8 tier's K' = k·rerank_factor.
        Raises ``ValueError`` when it is beyond the top-K kernel's int
        index (``topk_update.MAX_INDEX``), on every device, before any
        launch."""
        kp = k
        if self.precision == "int8":
            kp = min(k * self.cfg.rerank_factor, self.index.nb)
        topk_update.check_limits(kp, self.cfg.chunk)
        return kp

    # ----------------------------------------------------------- bucketing
    def _pick_bucket(self, ladder: Tuple[int, ...], need: int) -> int:
        for b in ladder:
            if b >= need:
                return b
        return ladder[-1]

    def _gather_rows(self, probes: np.ndarray,
                     dead_rows: Optional[np.ndarray] = None):
        """Per-shard union of probed clusters' resident row ranges, padded
        to the smallest cap bucket. Returns (rows [V, cap_b] i32, cap_b);
        (None, 0) when the batch probes no resident rows. ``dead_rows``
        (bool [NB] over packed rows) drops tombstoned rows here, so the
        step never sees them."""
        V = self._base_scfg.v_shards
        uniq = np.unique(probes) if probes.size else np.zeros(0, np.int64)
        uniq = uniq[uniq >= 0]
        per_shard = [[] for _ in range(V)]
        counts = np.zeros(V, np.int64)
        for c in uniq:
            v, lo, hi = self.corpus.cluster_slices[int(c)]
            if hi > lo:
                r = np.arange(lo, hi, dtype=np.int32)
                if dead_rows is not None:
                    plo, phi = self.index.cluster_rows(int(c))
                    r = r[~dead_rows[plo:phi]]
                if r.size:
                    per_shard[v].append(r)
                    counts[v] += r.size
        need = int(counts.max()) if len(uniq) else 0
        if need == 0:
            return None, 0
        cap_b = self._pick_bucket(self.cap_buckets, need)
        rows = np.full((V, cap_b), -1, np.int32)
        for v in range(V):
            if per_shard[v]:
                r = np.concatenate(per_shard[v])
                rows[v, : len(r)] = r
        return rows, cap_b

    # --------------------------------------------------------------- steps
    def _get_step(self, bscfg: SpmdConfig):
        key = (bscfg.qb, bscfg.cap, bscfg.k, bscfg.nprobe)
        step = self._steps.get(key)
        if step is None:
            step = self._make_step(bscfg, key)
            self._steps[key] = step
        self._probe_widths.add(bscfg.nprobe)
        return step

    def _make_step(self, bscfg: SpmdConfig, key):
        """One bucket's step: upload the batch's tables, gather the probed
        rows on the device (device tier) or wait for their upload (host
        tier: ``src`` is the :class:`_Upload`), and run the ring. Building
        it is this port's counterpart of a jit trace, counted once per
        key."""
        self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        # the closure holds no reference to the executor, so dropping the
        # executor frees its device arrays at once (no reference cycle)
        res, dev, scale2 = self._resident, self.device, self._scale2
        host = self.tier == "host"

        def step(src, qarr: dict):
            with tracing.span("executor.upload"):
                if not host:
                    rows_t = torch.as_tensor(src.astype(np.int64)).to(dev)
                tables = [torch.as_tensor(qarr[n]).to(dev)
                          for n in ("queries", "probes", "tau0")]
            if host:
                buf = src.buf
                if buf.copied is not None:
                    torch.cuda.current_stream(dev).wait_event(buf.copied)
                cand = [buf.dev[n] for n in _CAND]
            else:
                cand = gather_local_candidates(
                    rows_t, res["x_blk"], res["xn2_blk"], res["cluster_ids"],
                    res["row_ids"],
                )
            out = ring_chunk_search(bscfg, *cand, *tables, scale2=scale2)
            if host and buf.copied is not None:
                buf.consumed = torch.cuda.Event()
                buf.consumed.record(torch.cuda.current_stream(dev))
            return out

        return step

    # ---------------------------------------------------- host-tier stream
    def _buffers(self, cap_b: int) -> _CandBuffers:
        """A buffer set of the cap bucket that no staged upload holds. A
        new set is made when all are held (at most the two prefetch slots
        and the batch in flight), and the free sets of other cap buckets
        are dropped first: the device holds the sets of the buckets in
        use, not the ladder's."""
        pool = self._cand_pool.setdefault(cap_b, [])
        for buf in pool:
            if not buf.held:
                return buf
        for cap, sets in self._cand_pool.items():
            if cap != cap_b:
                sets[:] = [b for b in sets if b.held]
        x = self._host_arrays["x_blk"]
        V, B, _, db = x.shape
        buf = _CandBuffers(dict(
            x_c=((V, B, cap_b, db), x.dtype),
            xn2_c=((V, B, cap_b), torch.float32),
            cl_c=((V, cap_b), torch.int32),
            id_c=((V, cap_b), torch.int32),
        ), self.device, self._side)
        pool.append(buf)
        return buf

    def _upload_candidates(self, rows: np.ndarray, cap_b: int) -> _Upload:
        """Gather the probed rows on the host into a buffer set of the
        cap bucket and start their copy to the device on the side stream
        (on the CPU: a plain copy). The set is held until the batch that
        consumes it has run."""
        buf = self._buffers(cap_b)
        buf.held = True
        if buf.copied is not None:
            buf.copied.synchronize()          # its previous copy has left
        gather_host_candidates(self._host_arrays, rows, out=buf.host)
        nbytes = sum(buf.host[n].nbytes for n in _CAND)
        if self._side is None:
            for n in _CAND:
                buf.dev[n].copy_(buf.host[n])
        else:
            with torch.cuda.stream(self._side):
                if buf.consumed is not None:
                    self._side.wait_event(buf.consumed)
                buf.started.record(self._side)
                for n in _CAND:
                    buf.dev[n].copy_(buf.host[n], non_blocking=True)
                buf.copied.record(self._side)
        return _Upload(buf=buf, nbytes=nbytes)

    def prefetch(
        self,
        queries: Optional[np.ndarray] = None,
        probes: Optional[np.ndarray] = None,
        dead_rows: Optional[np.ndarray] = None,
        nprobe: Optional[int] = None,
    ) -> None:
        """Stage the next batch's candidate upload while the current batch
        computes. No-op on a device-tier executor.

        The staged upload is keyed on the gather table itself, so the
        later :meth:`search_batch` recognizes its own candidate set however
        the batch was predicted; a wrong prediction is a miss (the
        dispatch uploads then), never a wrong answer. Two slots."""
        if self.tier != "host":
            return
        if probes is None:
            if queries is None:
                return
            queries = np.asarray(queries, np.float32)
            if queries.ndim == 1:
                queries = queries[None]
            probes = assign_queries(self.index, queries, nprobe)
        max_qb = self.qb_buckets[-1]
        for lo in range(0, probes.shape[0], max_qb):
            rows, cap_b = self._gather_rows(probes[lo:lo + max_qb], dead_rows)
            if cap_b == 0:
                continue
            key = (rows.tobytes(), cap_b)
            if key in self._prefetched:
                continue
            self._prefetched[key] = self._upload_candidates(rows, cap_b)
            self.prefetch_staged += 1
            while len(self._prefetched) > 2:          # two slots
                old = self._prefetched.pop(next(iter(self._prefetched)))
                old.buf.held = False

    # ------------------------------------------------------------- serving
    def select_probes(self, queries: np.ndarray) -> np.ndarray:
        """The index's ``nprobe`` nearest centroids per query, chosen on
        the executor's device by the port's own distance and top-K kernels
        (:func:`~repro_torch.core.search.kernel_assign_queries`): the table
        ``assign_queries`` gives, [NQ, nprobe] int32 ascending, up to f32
        rounding. The centroids and their squared norms are uploaded at
        the first call and kept; the batch's query copy, distances and
        running lists are freed before this returns."""
        if self._centroids is None:
            c = torch.as_tensor(self.index.centers).to(self.device)
            self._centroids = (c, (c * c).sum(1))
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32)).to(self.device)
        return kernel_assign_queries(*self._centroids, q,
                                     self.index.cfg.nprobe).cpu().numpy()

    def search_batch(
        self,
        queries: np.ndarray,
        k: Optional[int] = None,
        nprobe: Optional[int] = None,
        probes: Optional[np.ndarray] = None,
        dead_rows: Optional[np.ndarray] = None,
    ) -> SearchResult:
        """Top-K for one batch through the device-resident pipeline.

        ``dead_rows`` applies the data plane's tombstones (see
        :meth:`_gather_rows`); the τ prewarm excludes the same rows so
        pruning stays exact over the live set."""
        k = k or self.k
        k_step = self._k_step(k)
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        nq = queries.shape[0]
        max_qb = self.qb_buckets[-1]
        if nq > max_qb:
            parts = [
                self.search_batch(
                    queries[lo : lo + max_qb], k=k, nprobe=nprobe,
                    probes=None if probes is None else probes[lo : lo + max_qb],
                    dead_rows=dead_rows,
                )
                for lo in range(0, nq, max_qb)
            ]
            return SearchResult(
                ids=np.concatenate([p.ids for p in parts]),
                scores=np.concatenate([p.scores for p in parts]),
                stats={
                    "backend": "spmd",
                    "wall_s": sum(p.stats["wall_s"] for p in parts),
                    "buckets": [b for p in parts for b in p.stats["buckets"]],
                    "tile_skipped": sum(p.stats["tile_skipped"] for p in parts),
                    "tile_total": sum(p.stats["tile_total"] for p in parts),
                    "pad_queries": sum(p.stats["pad_queries"] for p in parts),
                    "compiled": any(p.stats["compiled"] for p in parts),
                    "splits": len(parts),
                    "precision": self.precision,
                    "rerank_k": max(p.stats["rerank_k"] for p in parts),
                    "cold": max(p.stats["cold"] for p in parts),
                    "bytes_streamed": sum(p.stats["bytes_streamed"] for p in parts),
                    "prefetch_hits": sum(p.stats["prefetch_hits"] for p in parts),
                    "upload_ms": sum(p.stats["upload_ms"] for p in parts),
                },
            )

        with tracing.span("executor.search_batch") as sp:
            return self._search_bucket(queries, k, k_step, nprobe, probes, dead_rows, sp)

    def _search_bucket(self, queries: np.ndarray, k: int, k_step: int,
                       nprobe: Optional[int], probes: Optional[np.ndarray],
                       dead_rows: Optional[np.ndarray], sp) -> SearchResult:
        """:meth:`search_batch` of at most the largest qb bucket's queries,
        inside its span ``sp``."""
        nq = queries.shape[0]
        t0 = time.perf_counter()
        if probes is None:
            if nprobe is not None and nprobe <= 0:
                # an explicit empty probe set means "no candidates"
                probes = np.zeros((nq, 0), np.int32)
            else:
                probes = assign_queries(self.index, queries, nprobe)
        with tracing.span("executor.gather_rows"):
            rows, cap_b = self._gather_rows(probes, dead_rows)
        if cap_b == 0:
            dt = time.perf_counter() - t0
            self.dispatches += 1
            self.queries += nq
            self.wall_s += dt
            return SearchResult(
                ids=np.full((nq, k), -1, np.int64),
                scores=np.full((nq, k), np.inf, np.float32),
                stats={
                    "backend": "spmd", "wall_s": dt, "buckets": [],
                    "tile_skipped": 0, "tile_total": 0, "pad_queries": 0,
                    "compiled": False, "splits": 1,
                    "precision": self.precision, "rerank_k": 0,
                    "cold": int(self.tier == "host"), "bytes_streamed": 0,
                    "prefetch_hits": 0, "upload_ms": 0.0,
                },
            )
        int8 = self.precision == "int8"
        # τ prewarm over the original probe table (pad columns never reach
        # it); int8 stage 1 scores in the quantized metric, where an
        # fp32-space τ is no upper bound, so it starts at +inf
        if self.prune and not int8:
            # the card route where the sample rows are resident (the
            # device tier), else the host's gather
            with tracing.span("executor.prewarm_tau") as tsp:
                tau0 = prewarm_tau(self.index, queries, probes, k,
                                   self.index.cfg.prewarm_samples, self.metric,
                                   dead_rows=dead_rows,
                                   rows_dtype=(torch.bfloat16 if self.cfg.x_dtype == "bfloat16"
                                               else None),
                                   samples=self._samples)
                tsp.count(on_card=nq if self._samples is not None else 0)
        else:
            tau0 = np.full((nq,), np.inf, np.float32)
        if sp.on:
            sp.count(pairs_needed=self._pairs_needed(probes))
        # step-cache alignment: pad a narrower probe table (-2 columns match
        # no cluster) up to the smallest width a step already exists for
        w = probes.shape[1]
        if w not in self._probe_widths:
            wider = sorted(pw for pw in self._probe_widths if pw > w)
            if wider:
                pad = np.full((nq, wider[0] - w), -2, np.int32)
                probes = np.concatenate([probes.astype(np.int32), pad], axis=1)
        qb_b = self._pick_bucket(self.qb_buckets, nq)
        bscfg = dataclasses.replace(
            self._base_scfg, qb=qb_b, cap=cap_b, k=k_step, nprobe=probes.shape[1]
        )
        qarr = build_query_arrays(queries, bscfg, probes, tau0,
                                  quant_grid=self._quant_grid)
        compiles_before = self.compiles
        step = self._get_step(bscfg)
        cold_bytes, pf_hit, up = 0, 0, None
        if self.tier == "host":
            up = self._prefetched.pop((rows.tobytes(), cap_b), None)
            if up is not None:
                pf_hit = 1
                self.prefetch_hits += 1
            else:
                up = self._upload_candidates(rows, cap_b)
                self.prefetch_misses += 1
            cold_bytes = up.nbytes
            self.cold_dispatches += 1
            self.bytes_streamed += cold_bytes
            gs, gi, st = step(up, qarr)
        else:
            gs, gi, st = step(rows, qarr)
        with tracing.span("executor.wait"):
            scores = gs[:nq].cpu().numpy()
        rows_k = gi[:nq].cpu().numpy().astype(np.int64)
        upload_ms = 0.0
        if up is not None:
            up.buf.held = False
            if up.buf.copied is not None:
                upload_ms = up.buf.started.elapsed_time(up.buf.copied)
                self.upload_ms += upload_ms
        rows_k[~np.isfinite(scores)] = -1
        if int8:
            scores, rows_k = self._rerank(queries, scores, rows_k, k)
        ids = np.where(rows_k >= 0, self.index.ids[np.maximum(rows_k, 0)], -1)
        st = st.cpu().numpy()
        dt = time.perf_counter() - t0
        self.dispatches += 1
        self.queries += nq
        self.wall_s += dt
        self.tile_skipped += int(st[0])
        self.tile_total += int(st[1])
        self.tiles_after_mask += int(st[2])
        self.tiles_stopped += int(st[3])
        sp.count(qb=qb_b, cap=cap_b, step_built=self.compiles > compiles_before,
                 pairs_scored=(int(st[1]) - int(st[0])) * bscfg.tile_m * bscfg.tile_n,
                 tiles_after_mask=int(st[2]), tiles_stopped=int(st[3]))
        return SearchResult(
            ids=ids,
            scores=scores,
            stats={
                "backend": "spmd",
                "wall_s": dt,
                "buckets": [(qb_b, cap_b)],
                "tile_skipped": int(st[0]),
                "tile_total": int(st[1]),
                "pad_queries": qb_b - nq,
                "compiled": self.compiles > compiles_before,
                "splits": 1,
                "precision": self.precision,
                "rerank_k": k_step if int8 else 0,
                "cold": int(self.tier == "host"),
                "bytes_streamed": cold_bytes,
                "prefetch_hits": pf_hit,
                "upload_ms": upload_ms,
            },
        )

    def _pairs_needed(self, probes: np.ndarray) -> int:
        """The (query, row, dimension block) triples the batch needs
        scored: each query's distinct probed lists' rows, over every
        dimension block."""
        if self._list_rows is None:
            slices = self.corpus.cluster_slices
            self._list_rows = np.array([slices[c][2] - slices[c][1]
                                        for c in range(len(slices))], np.int64)
        p = np.sort(probes, axis=1)
        keep = p >= 0
        keep[:, 1:] &= p[:, 1:] != p[:, :-1]
        return int(self._list_rows[p[keep]].sum()) * self._base_scfg.d_blocks

    # -------------------------------------------------------------- rerank
    def _rerank(self, queries: np.ndarray, s1_scores: np.ndarray,
                s1_rows: np.ndarray, k: int):
        """Exact fp32 re-rank of the int8 stage-1 survivors.

        Stage 1 returns the quantized-metric top ``K'`` packed rows; the
        host gathers those rows of ``index.x`` and the card scores them
        exactly and keeps the top k with a stable sort. Returns (scores [nq, k],
        packed rows [nq, k]); invalid survivors stay +inf / -1, and with
        ``K' < k`` (tiny corpus) the result is padded to k."""
        kp = s1_rows.shape[1]
        valid = np.isfinite(s1_scores) & (s1_rows >= 0)
        rows = np.where(valid, s1_rows, 0)
        dev = self.device
        nk = min(k, kp)
        sc, sel = rerank_exact(self.index, torch.as_tensor(queries).to(dev),
                               rows, torch.as_tensor(valid).to(dev), nk)
        sc = sc.cpu().numpy()
        out_rows = np.take_along_axis(s1_rows, sel.cpu().numpy(), axis=1)
        out_rows[~np.isfinite(sc)] = -1
        if nk < k:                                   # tiny corpus: pad to k
            sc = np.pad(sc, ((0, 0), (0, k - nk)), constant_values=np.inf)
            out_rows = np.pad(out_rows, ((0, 0), (0, k - nk)), constant_values=-1)
        return sc, out_rows

    # ----------------------------------------------------------- reporting
    @property
    def compiles(self) -> int:
        return sum(self.trace_counts.values())

    def stats_summary(self) -> dict:
        """JSON-friendly digest of the executor's counters."""
        return {
            "precision": self.precision,
            "tier": self.tier,
            "cold_dispatches": self.cold_dispatches,
            "bytes_streamed": self.bytes_streamed,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
            "prefetch_staged": self.prefetch_staged,
            "upload_ms": self.upload_ms,
            "dispatches": self.dispatches,
            "queries": self.queries,
            "wall_s": self.wall_s,
            "compiles": self.compiles,
            "buckets_compiled": {
                f"qb{qb}_cap{cap}_k{k}_p{p}": n
                for (qb, cap, k, p), n in sorted(self.trace_counts.items())
            },
            "qb_buckets": list(self.qb_buckets),
            "cap_buckets": list(self.cap_buckets),
            "tile_skipped": self.tile_skipped,
            "tile_total": self.tile_total,
            "tile_skip_frac": self.tile_skipped / max(self.tile_total, 1),
            "tiles_after_mask": self.tiles_after_mask,
            "tiles_stopped": self.tiles_stopped,
        }
