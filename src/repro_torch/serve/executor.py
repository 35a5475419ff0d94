"""Device-resident batched search executor on one GPU.

The port of ``repro/serve/executor.py`` for ``tier="device"``, in both
precisions:

* **Corpus residency** — the sharded corpus, per-block norms, cluster ids
  and row ids are packed once on the host, block-major for the virtual
  V × B mesh (:func:`repro_torch.core.pipeline.resident_arrays`), and
  uploaded as the device's one copy of the sharded rows, beside the
  index's own ``x``. A batch moves only its queries, probe table, τ seeds
  and an int32 row-index table to the device.
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
  those survivors exactly in fp32 on the card, against ``index.x``.

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

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.index import IVFIndex, assign_queries, preassign
from repro_torch.core.pipeline import (
    SpmdConfig,
    build_corpus_arrays,
    build_query_arrays,
    gather_local_candidates,
    resident_arrays,
    ring_chunk_search,
)
from repro_torch.core.pruning import prewarm_tau
from repro_torch.core.search import rerank_exact
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.core.types import PartitionPlan, SearchResult


@dataclass(frozen=True)
class ExecutorConfig:
    """Knobs of the device-resident executor.

    ``qb_buckets`` is the query-count ladder (each entry rounded up to a
    multiple of the mesh's dimension-block count); the candidate-capacity
    ladder is chunk·2^i up to the full shard capacity. ``precision`` is
    ``"fp32"`` or ``"int8"`` (quantized stage 1 keeping
    ``k·rerank_factor`` rows, then an exact fp32 re-rank; L2 only).
    ``use_pallas`` and ``x_dtype`` are kept for signature parity; values
    the port does not carry raise ``NotImplementedError``.
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


class SpmdExecutor:
    """Batched search over the device-resident ring pipeline.

    ``mesh`` is the virtual geometry ``(V, B)``, by default
    ``(1, cfg.d_blocks)``; all of it runs on ``device`` (CUDA by default).
    """

    def __init__(
        self,
        index: IVFIndex,
        cfg: Optional[ExecutorConfig] = None,
        mesh: Optional[Tuple[int, int]] = None,
        tier: str = "device",
        device: DeviceLike = None,
    ):
        if tier != "device":
            raise NotImplementedError(f"tier={tier!r}")
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
        packed = resident_arrays(arrays, self._base_scfg)
        self._resident = {name: a.to(self.device) for name, a in packed.items()}
        # stage-2 re-rank lookup (ext id → packed row), built lazily
        self._id_order: Optional[np.ndarray] = None
        self._sorted_ids: Optional[np.ndarray] = None

        # step cache: (qb, cap, k, nprobe) → step; trace_counts counts builds
        self._steps: Dict[Tuple[int, int, int, int], object] = {}
        self.trace_counts: Dict[Tuple[int, int, int, int], int] = {}
        self._probe_widths: set = set()
        self.dispatches = 0
        self.queries = 0
        self.wall_s = 0.0
        self.tile_skipped = 0
        self.tile_total = 0

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
                    step(rows, qarr)

    def _k_step(self, k: int) -> int:
        """The ring's K: k, or the int8 tier's K' = k·rerank_factor."""
        if self.precision == "int8":
            return min(k * self.cfg.rerank_factor, self.index.nb)
        return k

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
        rows on the device and run the ring. Building it is this port's
        counterpart of a jit trace, counted once per key."""
        self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
        res, dev = self._resident, self.device

        def step(rows: np.ndarray, qarr: dict):
            rows_t = torch.as_tensor(rows.astype(np.int64)).to(dev)
            x_c, xn2_c, cl_c, id_c = gather_local_candidates(
                rows_t, res["x_blk"], res["xn2_blk"], res["cluster_ids"],
                res["row_ids"],
            )
            return ring_chunk_search(
                bscfg, x_c, xn2_c, cl_c, id_c,
                torch.as_tensor(qarr["queries"]).to(dev),
                torch.as_tensor(qarr["probes"]).to(dev),
                torch.as_tensor(qarr["tau0"]).to(dev),
                scale2=res.get("scale2"),
            )

        return step

    # ------------------------------------------------------------- serving
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
                    "cold": 0,
                    "bytes_streamed": 0,
                    "prefetch_hits": 0,
                },
            )

        t0 = time.perf_counter()
        if probes is None:
            if nprobe is not None and nprobe <= 0:
                # an explicit empty probe set means "no candidates"
                probes = np.zeros((nq, 0), np.int32)
            else:
                probes = assign_queries(self.index, queries, nprobe)
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
                    "cold": 0, "bytes_streamed": 0, "prefetch_hits": 0,
                },
            )
        int8 = self.precision == "int8"
        # τ prewarm over the original probe table (pad columns never reach
        # it); int8 stage 1 scores in the quantized metric, where an
        # fp32-space τ is no upper bound, so it starts at +inf
        tau0 = (
            prewarm_tau(self.index, queries, probes, k,
                        self.index.cfg.prewarm_samples, self.metric,
                        dead_rows=dead_rows)
            if self.prune and not int8
            else np.full((nq,), np.inf, np.float32)
        )
        # step-cache alignment: pad a narrower probe table (-2 columns match
        # no cluster) up to the smallest width a step already exists for
        w = probes.shape[1]
        if w not in self._probe_widths:
            wider = sorted(pw for pw in self._probe_widths if pw > w)
            if wider:
                pad = np.full((nq, wider[0] - w), -2, np.int32)
                probes = np.concatenate([probes.astype(np.int32), pad], axis=1)
        k_step = self._k_step(k)
        qb_b = self._pick_bucket(self.qb_buckets, nq)
        bscfg = dataclasses.replace(
            self._base_scfg, qb=qb_b, cap=cap_b, k=k_step, nprobe=probes.shape[1]
        )
        qarr = build_query_arrays(queries, bscfg, probes, tau0,
                                  quant_grid=self._quant_grid)
        compiles_before = self.compiles
        step = self._get_step(bscfg)
        gs, gi, st = step(rows, qarr)
        scores = gs[:nq].cpu().numpy()
        ids = gi[:nq].cpu().numpy().astype(np.int64)
        ids[~np.isfinite(scores)] = -1
        if int8:
            scores, ids = self._rerank(queries, scores, ids, k)
        st = st.cpu().numpy()
        dt = time.perf_counter() - t0
        self.dispatches += 1
        self.queries += nq
        self.wall_s += dt
        self.tile_skipped += int(st[0])
        self.tile_total += int(st[1])
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
                "cold": 0,
                "bytes_streamed": 0,
                "prefetch_hits": 0,
            },
        )

    # -------------------------------------------------------------- rerank
    def _rerank(self, queries: np.ndarray, s1_scores: np.ndarray,
                s1_ids: np.ndarray, k: int):
        """Exact fp32 re-rank of the int8 stage-1 survivors.

        Stage 1 returns the quantized-metric top ``K'`` external ids; the
        host maps them to packed rows (numpy ``searchsorted``, as in the
        reference), and the card gathers those rows of ``index.x``,
        scores them exactly and keeps the top k with a stable sort.
        Invalid survivors stay +inf / -1; with ``K' < k`` (tiny corpus)
        the result is padded to k."""
        nq, kp = s1_ids.shape
        if self._id_order is None:
            self._id_order = np.argsort(self.index.ids, kind="stable")
            self._sorted_ids = self.index.ids[self._id_order]
        valid = np.isfinite(s1_scores) & (s1_ids >= 0)
        safe = np.where(valid, s1_ids, self._sorted_ids[0])
        pos = np.searchsorted(self._sorted_ids, safe)
        rows = self._id_order[np.clip(pos, 0, self.index.nb - 1)]
        dev = self.device
        nk = min(k, kp)
        sc, sel = rerank_exact(self.index, torch.as_tensor(queries).to(dev),
                               torch.as_tensor(rows).to(dev),
                               torch.as_tensor(valid).to(dev), nk)
        sc = sc.cpu().numpy()
        out_ids = np.take_along_axis(s1_ids, sel.cpu().numpy(), axis=1)
        out_ids[~np.isfinite(sc)] = -1
        if nk < k:                                   # tiny corpus: pad to k
            sc = np.pad(sc, ((0, 0), (0, k - nk)), constant_values=np.inf)
            out_ids = np.pad(out_ids, ((0, 0), (0, k - nk)), constant_values=-1)
        return sc, out_ids

    # ----------------------------------------------------------- reporting
    @property
    def compiles(self) -> int:
        return sum(self.trace_counts.values())

    def stats_summary(self) -> dict:
        """JSON-friendly digest of the executor's counters."""
        return {
            "precision": self.precision,
            "tier": self.tier,
            "cold_dispatches": 0,
            "bytes_streamed": 0,
            "prefetch_hits": 0,
            "prefetch_misses": 0,
            "prefetch_staged": 0,
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
        }
