"""IVF index build, the V × B sharded layout, per-row metadata and the
mutable segmented data plane.

The index's corpus rows live on the device as a tensor. The bookkeeping
stays host-side numpy, exactly as in the reference: centers, ids, the
cluster of each packed row, cluster offsets, cluster slices and the
packed-row permutation. The V × B layout that ``preassign`` makes is
host-side too, as in the reference: the executor packs it and uploads
one copy. Probe selection (``assign_queries``) is the reference's
host-side numpy computation. The int8 tier's codes and grids
(``Int8Quant``, ``quantize_vectors``) are host numpy too, made from one
host copy of the rows.

Mutability is segment-based, as in the reference: a
:class:`SegmentedIndex` is an ordered set of immutable sealed
:class:`Segment` s (each a packed IVF index whose rows live on the
index's device), one append-only delta buffer of fresh vectors (host
numpy, so a snapshot of it stays point-in-time), and per-segment
dead-row bitmaps (host numpy tombstones). Compaction seals the delta
into a new segment or merges everything into one.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config import HarmonyConfig
from repro_torch.core.kmeans import assign_nearest, kmeans_fit
from repro_torch.core.types import PartitionPlan


@dataclass
class IVFIndex:
    """Single-logical-copy IVF index (packed, cluster-sorted)."""

    cfg: HarmonyConfig
    centers: np.ndarray          # [nlist, D] float32 (host: probe selection)
    x: torch.Tensor              # [NB, D] float32 on the device, cluster-contiguous
    ids: np.ndarray              # [NB] int64 original vector ids of packed rows
    cluster_of: np.ndarray       # [NB] int32 cluster id per packed row (non-decreasing)
    offsets: np.ndarray          # [nlist + 1] int64 row offsets per cluster
    build_times: Dict[str, float]
    # per-row metadata (packed order), None when the corpus carries none
    meta: Optional["MetadataStore"] = None

    @property
    def nb(self) -> int:
        return int(self.x.shape[0])

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])

    @property
    def nlist(self) -> int:
        return int(self.centers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def sizes(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    def cluster_rows(self, c: int) -> Tuple[int, int]:
        return int(self.offsets[c]), int(self.offsets[c + 1])

    @property
    def xnorm2(self) -> torch.Tensor:
        """Full-corpus squared norms ‖x‖² [NB] on the device, cached."""
        cached = self.__dict__.get("_xnorm2")
        if cached is None:
            cached = (self.x * self.x).sum(1)
            self.__dict__["_xnorm2"] = cached
        return cached

    def int8_quant(self, d_blocks: Optional[int] = None) -> "Int8Quant":
        """Scalar-quantized int8 tier of the corpus, one grid per
        dimension block, computed on the host from one copy of the rows
        and cached per ``d_blocks`` (default ``cfg.quant_blocks``)."""
        d_blocks = d_blocks or self.cfg.quant_blocks
        cache = self.__dict__.setdefault("_int8_quants", {})
        q = cache.get(d_blocks)
        if q is None:
            q = quantize_vectors(self.x.cpu().numpy(), d_blocks)
            cache[d_blocks] = q
        return q

    def attach_int8_quant(self, quant: "Int8Quant") -> None:
        """Install codes made elsewhere (e.g. persisted) for their
        ``d_blocks``."""
        cache = self.__dict__.setdefault("_int8_quants", {})
        cache[quant.d_blocks] = quant


def _pack(cfg: HarmonyConfig, centers: np.ndarray, xt: torch.Tensor,
          assign: np.ndarray, ext_ids: Optional[np.ndarray],
          build_times: Dict[str, float], meta=None) -> IVFIndex:
    """Add stage: cluster-sort the rows (stable) and compute offsets; the
    metadata (input row order) is permuted with the rows."""
    t0 = time.perf_counter()
    order = np.argsort(assign, kind="stable")
    x_sorted = xt[torch.as_tensor(order, device=xt.device)].contiguous()
    counts = np.bincount(assign, minlength=cfg.nlist)
    offsets = np.zeros((cfg.nlist + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = order if ext_ids is None else np.asarray(ext_ids, np.int64)[order]
    store = None
    if meta is not None:
        if isinstance(meta, MetadataStore):
            store = meta.select(order)
        else:
            rows = meta_rows_from_batch(meta, len(order))
            store = meta_rows_to_store(
                None if rows is None else [rows[i] for i in order]
            )
    build_times = dict(build_times, add=time.perf_counter() - t0)
    return IVFIndex(
        cfg=cfg,
        centers=np.asarray(centers, np.float32),
        x=x_sorted,
        ids=ids.astype(np.int64),
        cluster_of=assign[order].astype(np.int32),
        offsets=offsets,
        build_times=build_times,
        meta=store,
    )


def build_ivf(
    x, cfg: HarmonyConfig, ext_ids: Optional[np.ndarray] = None,
    meta=None, centers: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> IVFIndex:
    """Train + Add stages on ``device`` (CUDA by default).

    With ``centers`` given, training is skipped and every row goes to its
    nearest center (argmin, lowest center on ties). ``ext_ids`` names
    each input row with a stable external id (default: row position).
    ``meta`` attaches per-row metadata (any form
    :func:`meta_rows_from_batch` accepts, or a :class:`MetadataStore`, in
    input row order); it is permuted by the same cluster sort as the rows.
    """
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    t0 = time.perf_counter()
    if centers is None:
        ct, at = kmeans_fit(xt, cfg.nlist, iters=cfg.kmeans_iters,
                            seed=cfg.kmeans_seed)
        centers = ct.cpu().numpy()
    else:
        centers = np.asarray(centers, np.float32)
        at, _ = assign_nearest(xt, torch.as_tensor(centers).to(dev))
    assign = at.cpu().numpy()
    return _pack(cfg, centers, xt, assign, ext_ids,
                 {"train": time.perf_counter() - t0}, meta=meta)


def ivf_from_arrays(
    cfg: Union[HarmonyConfig, Mapping], arrays: Mapping[str, np.ndarray],
    device: DeviceLike = None,
) -> IVFIndex:
    """Rebuild an index from another build's arrays.

    ``arrays`` holds ``centers``, ``x``, ``ids``, ``cluster_of`` and
    ``offsets`` (numpy, packed order, e.g. from the JAX package's
    ``IVFIndex``) and optionally ``meta`` (see :func:`metadata_from`);
    ``cfg`` is a ``HarmonyConfig`` or its field dict. The rows go to
    ``device``; the bookkeeping is copied as is.
    """
    if not isinstance(cfg, HarmonyConfig):
        names = {f.name for f in dataclasses.fields(HarmonyConfig)}
        cfg = HarmonyConfig(**{k: v for k, v in dict(cfg).items() if k in names})
    dev = resolve_device(device)
    return IVFIndex(
        cfg=cfg,
        centers=np.array(arrays["centers"], np.float32),
        x=torch.as_tensor(np.array(arrays["x"], np.float32)).to(dev),
        ids=np.array(arrays["ids"], np.int64),
        cluster_of=np.array(arrays["cluster_of"], np.int32),
        offsets=np.array(arrays["offsets"], np.int64),
        build_times={},
        meta=metadata_from(arrays.get("meta")),
    )


def assign_queries(index: IVFIndex, q: np.ndarray, nprobe: Optional[int] = None) -> np.ndarray:
    """Nearest-``nprobe`` centroids per query (host-side numpy, the
    client-side probe table of Fig. 4). Returns [NQ, nprobe] int32."""
    nprobe = nprobe or index.cfg.nprobe
    qn = np.sum(q * q, axis=1)[:, None]
    cn = np.sum(index.centers * index.centers, axis=1)[None, :]
    d = qn - 2.0 * (q @ index.centers.T) + cn
    return np.argsort(d, axis=1)[:, :nprobe].astype(np.int32)


def dim_block_bounds(dim: int, d_blocks: int) -> List[Tuple[int, int]]:
    """Contiguous dimension blocks; block b covers [lo, hi)."""
    per = -(-dim // d_blocks)  # ceil
    return [(b * per, min(dim, (b + 1) * per)) for b in range(d_blocks)]


# ---------------------------------------------------------------------------
# Scalar-quantized int8 tier (stage 1 of the two-stage search path)
# ---------------------------------------------------------------------------


def fit_int8_grid(blk: np.ndarray) -> Tuple[float, float]:
    """(zero, scale) of the affine int8 grid that covers ``blk``'s
    [min, max] exactly; the scale has a floor so a constant block stays
    well-defined."""
    mn = float(blk.min()) if blk.size else 0.0
    mx = float(blk.max()) if blk.size else 0.0
    return 0.5 * (mn + mx), max((mx - mn) / 254.0, 1e-8)


def encode_int8(x: np.ndarray, zero, scale) -> np.ndarray:
    """``round((x − zero) / scale)`` clipped to [−127, 127], as int8 (the
    f32 arithmetic of the reference, so codes are byte-identical)."""
    return np.clip(np.rint((x - zero) / scale), -127, 127).astype(np.int8)


@dataclass(frozen=True)
class Int8Quant:
    """Per-dimension-block affine int8 codes of one packed corpus.

    Block b has one (scale, zero-point) pair fit to the block's value
    range; a vector dimension j in block b encodes as
    ``round((x_j − zero_b) / scale_b)`` clipped to [−127, 127]. Queries
    are encoded on the *same* grid, so the zero-points cancel in the
    quantized L2 difference and stage-1 scoring is a pure int8×int8
    contraction (see ``kernels/csrc/partial_distance_int8.cu``).

    The codes and the grid are host numpy, byte-identical to the
    reference's; :meth:`device_scores` keeps one device copy of the codes
    for the scans that run on the card.
    """

    codes: np.ndarray   # [NB, D] int8, packed row order of the owning index
    scale: np.ndarray   # [B] float32
    zero: np.ndarray    # [B] float32

    @property
    def d_blocks(self) -> int:
        return int(self.scale.shape[0])

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        return dim_block_bounds(int(self.codes.shape[1]), self.d_blocks)

    def encode(self, x: np.ndarray) -> np.ndarray:
        """Encode fp32 vectors [..., D] on this grid → int8 codes.
        Out-of-range values (queries may fall outside the corpus's value
        range) clip; the corpus itself never clips."""
        x = np.asarray(x, np.float32)
        out = np.empty(x.shape, np.int8)
        for b, (lo, hi) in enumerate(self.bounds):
            out[..., lo:hi] = encode_int8(x[..., lo:hi], self.zero[b], self.scale[b])
        return out

    def decode(self, codes: Optional[np.ndarray] = None) -> np.ndarray:
        """Dequantize codes [..., D] back to fp32 (default: own corpus)."""
        codes = self.codes if codes is None else codes
        out = np.empty(codes.shape, np.float32)
        for b, (lo, hi) in enumerate(self.bounds):
            out[..., lo:hi] = (
                codes[..., lo:hi].astype(np.float32) * self.scale[b]
                + self.zero[b]
            )
        return out

    def code_norms2(self, codes: Optional[np.ndarray] = None) -> np.ndarray:
        """Σ_b s_b²·Σ_j code², the pre-scaled norm term of the quantized
        L2 form (cached for the corpus codes)."""
        if codes is None:
            cached = self.__dict__.get("_cnorm2")
            if cached is not None:
                return cached
            codes = self.codes
            caching = True
        else:
            caching = False
        out = np.zeros(codes.shape[:-1], np.float32)
        for b, (lo, hi) in enumerate(self.bounds):
            blk = codes[..., lo:hi].astype(np.int32)
            out += (self.scale[b] ** 2) * np.sum(blk * blk, axis=-1).astype(
                np.float32
            )
        if caching:
            object.__setattr__(self, "_cnorm2", out)
        return out

    def scores(self, q_codes: np.ndarray, rows: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """Quantized-L2 distances d̂²[m, n] between encoded queries [M, D]
        and corpus rows (all, or the given packed rows), on the host:
        int32 dot accumulation, f32 combine."""
        p = self.codes if rows is None else self.codes[rows]
        pn2 = self.code_norms2() if rows is None else self.code_norms2(p)
        qn2 = self.code_norms2(q_codes)
        acc = qn2[:, None] + pn2[None, :]
        for b, (lo, hi) in enumerate(self.bounds):
            dot = q_codes[:, lo:hi].astype(np.int32) @ p[:, lo:hi].astype(
                np.int32
            ).T
            acc -= (2.0 * self.scale[b] ** 2) * dot.astype(np.float32)
        return acc.astype(np.float32)

    def device_scores(self, q_codes: np.ndarray, device: DeviceLike
                      ) -> torch.Tensor:
        """:meth:`scores` over every corpus row, in torch on ``device``,
        bit-identical to the host version: the same f32 operations in the
        same order, and each block's dot taken in float64, where every
        partial sum of int8 products is exact (PyTorch has no int32
        matrix product on CUDA)."""
        dev = torch.device(device)
        cached = self.__dict__.get("_device_copy")
        if cached is None or cached[0] != dev:
            cached = (dev, torch.as_tensor(self.codes).to(dev),
                      torch.as_tensor(self.code_norms2()).to(dev))
            object.__setattr__(self, "_device_copy", cached)
        _, codes, pn2 = cached
        qc = torch.as_tensor(np.asarray(q_codes, np.int8)).to(dev)
        acc = torch.as_tensor(self.code_norms2(q_codes)).to(dev)[:, None] + pn2[None, :]
        for b, (lo, hi) in enumerate(self.bounds):
            dot = (qc[:, lo:hi].double() @ codes[:, lo:hi].double().T).float()
            acc -= torch.tensor(2.0 * self.scale[b] ** 2, device=dev) * dot
        return acc

    def memory_bytes(self) -> int:
        return self.codes.nbytes + self.scale.nbytes + self.zero.nbytes


def quantize_vectors(x: np.ndarray, d_blocks: int) -> Int8Quant:
    """Fit one affine int8 grid per dimension block to ``x`` [NB, D] (host
    numpy, :func:`fit_int8_grid`) and encode it; the corpus itself never
    clips."""
    x = np.asarray(x, np.float32)
    bounds = dim_block_bounds(int(x.shape[1]), d_blocks)
    scale = np.ones(d_blocks, np.float32)
    zero = np.zeros(d_blocks, np.float32)
    codes = np.empty(x.shape, np.int8)
    for b, (lo, hi) in enumerate(bounds):
        zero[b], scale[b] = fit_int8_grid(x[:, lo:hi])
        codes[:, lo:hi] = encode_int8(x[:, lo:hi], zero[b], scale[b])
    return Int8Quant(codes=codes, scale=scale, zero=zero)


@dataclass
class ShardedCorpus:
    """The Pre-assign product: the corpus laid out on the V × B grid.

    ``x_shard[v]`` holds shard v's rows padded to ``cap`` with zeros and
    ``xnorm2_blk[v, b]`` the per-row squared norm of dimension block b.
    Everything here is on the host (CPU tensors and numpy), so the layout
    adds no copy of the corpus to the device.
    """

    plan: PartitionPlan
    x_shard: torch.Tensor        # [V, cap, D] float32, CPU
    ids_shard: np.ndarray        # [V, cap] int64, -1 pad
    cluster_shard: np.ndarray    # [V, cap] int32, -1 pad
    valid: np.ndarray            # [V, cap] bool
    xnorm2_blk: torch.Tensor     # [V, B, cap] float32, CPU
    cluster_slices: Dict[int, Tuple[int, int, int]]
    packed_shard: np.ndarray     # [NB] int32
    packed_row: np.ndarray       # [NB] int32
    preassign_time: float

    @property
    def cap(self) -> int:
        return int(self.x_shard.shape[1])

    def dead_shard_mask(
        self, dead_rows: np.ndarray, key: Optional[tuple] = None
    ) -> np.ndarray:
        """Remap packed-row tombstones [NB] to the shard layout [V, cap].

        O(#dead) via the precomputed permutation. With ``key`` (the data
        plane's ``(generation, dead_version)``) the result is cached
        single-entry: any tombstone flip or generation swap changes the
        key, so a stale mask is never served. Without a key the mask is
        made fresh."""
        cache = self.__dict__.get("_dead_mask_cache")
        if key is not None and cache is not None and cache[0] == key:
            return cache[1]
        mask = np.zeros((self.x_shard.shape[0], self.cap), bool)
        rows = np.nonzero(dead_rows)[0]
        mask[self.packed_shard[rows], self.packed_row[rows]] = True
        if key is not None:
            self.__dict__["_dead_mask_cache"] = (key, mask)
        return mask


def preassign(index: IVFIndex, plan: PartitionPlan, pad_to: int = 64) -> ShardedCorpus:
    """Distribute clusters to vector shards per ``plan.cluster_to_shard``
    and precompute per-dimension-block norms, on the host."""
    t0 = time.perf_counter()
    V, B, D = plan.v_shards, plan.d_blocks, index.dim
    shard_rows: List[List[np.ndarray]] = [[] for _ in range(V)]
    fill = [0] * V
    cluster_slices: Dict[int, Tuple[int, int, int]] = {}
    for c in range(index.nlist):
        v = int(plan.cluster_to_shard[c])
        lo, hi = index.cluster_rows(c)
        shard_rows[v].append(np.arange(lo, hi, dtype=np.int64))
        cluster_slices[c] = (v, fill[v], fill[v] + (hi - lo))
        fill[v] += hi - lo

    cap = max(1, max(fill))
    cap = -(-cap // pad_to) * pad_to  # round up for tile alignment

    x_host = index.x.cpu()
    x_shard = torch.zeros((V, cap, D), dtype=torch.float32)
    ids_shard = np.full((V, cap), -1, np.int64)
    cluster_shard = np.full((V, cap), -1, np.int32)
    valid = np.zeros((V, cap), bool)
    packed_shard = np.full(index.nb, -1, np.int32)
    packed_row = np.full(index.nb, -1, np.int32)
    for v in range(V):
        rows = (np.concatenate(shard_rows[v]) if shard_rows[v]
                else np.zeros(0, np.int64))
        n = len(rows)
        if n:
            x_shard[v, :n] = x_host[torch.as_tensor(rows)]
            ids_shard[v, :n] = index.ids[rows]
            cluster_shard[v, :n] = index.cluster_of[rows]
            valid[v, :n] = True
            packed_shard[rows] = v
            packed_row[rows] = np.arange(n, dtype=np.int32)

    xnorm2_blk = torch.zeros((V, B, cap), dtype=torch.float32)
    for b, (lo, hi) in enumerate(dim_block_bounds(D, B)):
        seg = x_shard[:, :, lo:hi]
        xnorm2_blk[:, b] = (seg * seg).sum(2)

    return ShardedCorpus(
        plan=plan,
        x_shard=x_shard,
        ids_shard=ids_shard,
        cluster_shard=cluster_shard,
        valid=valid,
        xnorm2_blk=xnorm2_blk,
        cluster_slices=cluster_slices,
        packed_shard=packed_shard,
        packed_row=packed_row,
        preassign_time=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Per-row metadata (host numpy, as in the reference)
# ---------------------------------------------------------------------------

# fill value for tag columns a row never carried (a merged segment unions
# the columns of its sources); a predicate matches it only if the caller
# filters for this exact sentinel
TAG_MISSING = np.iinfo(np.int64).min


@dataclass(frozen=True)
class MetadataStore:
    """Columnar per-row metadata aligned with one packed corpus.

    ``tags[name][r]`` / ``nums[name][r]`` are row r's int tag / float
    numeric attributes; ``texts[r]`` is its lexical document (or None).
    Rows follow the owning index's packed order. Missing values are
    :data:`TAG_MISSING` / NaN / None.
    """

    tags: Dict[str, np.ndarray]                 # name -> [NB] int64
    nums: Dict[str, np.ndarray]                 # name -> [NB] float32
    texts: Optional[Tuple[Optional[str], ...]] = None   # [NB] or None

    @property
    def n(self) -> int:
        for col in self.tags.values():
            return int(col.shape[0])
        for col in self.nums.values():
            return int(col.shape[0])
        return 0 if self.texts is None else len(self.texts)

    def row(self, r: int) -> dict:
        """Row r as a plain per-row dict (python-native values)."""
        out = {}
        for k, col in self.tags.items():
            if col[r] != TAG_MISSING:
                out[k] = int(col[r])
        for k, col in self.nums.items():
            if not np.isnan(col[r]):
                out[k] = float(col[r])
        if self.texts is not None and self.texts[r] is not None:
            out["text"] = self.texts[r]
        return out

    def select(self, rows: np.ndarray) -> "MetadataStore":
        """Sub-store of the given packed rows (gather/permutation)."""
        return MetadataStore(
            tags={k: col[rows] for k, col in self.tags.items()},
            nums={k: col[rows] for k, col in self.nums.items()},
            texts=None if self.texts is None
            else tuple(self.texts[int(r)] for r in rows),
        )

def metadata_from(meta: Optional[Mapping]) -> Optional[MetadataStore]:
    """A :class:`MetadataStore` with its own copies of the columns in
    ``meta``, a mapping with ``tags`` and ``nums`` (name -> [NB] array)
    and ``texts`` (or None)."""
    if meta is None:
        return None
    texts = meta.get("texts")
    return MetadataStore(
        tags={k: np.array(v, np.int64) for k, v in meta.get("tags", {}).items()},
        nums={k: np.array(v, np.float32) for k, v in meta.get("nums", {}).items()},
        texts=None if texts is None else tuple(texts),
    )


def meta_rows_from_batch(meta, n: int) -> Optional[List[Optional[dict]]]:
    """Normalize a batch ``meta`` argument to per-row dicts.

    Accepts a dict of columns (each an [n] array/list; a ``"text"``
    column of strings feeds the lexical scorer), a list of per-row
    dicts, or None. Values become python natives so rows can be
    journaled / JSON-encoded verbatim."""
    if meta is None:
        return None
    if isinstance(meta, dict):
        rows: List[Optional[dict]] = [{} for _ in range(n)]
        for name, col in meta.items():
            vals = list(col)
            if len(vals) != n:
                raise ValueError(f"meta column {name!r} has {len(vals)} "
                                 f"values for {n} rows")
            for i, v in enumerate(vals):
                if v is None:
                    continue
                if isinstance(v, str):
                    rows[i][name] = v
                elif isinstance(v, (bool, int, np.integer)):
                    rows[i][name] = int(v)
                else:
                    rows[i][name] = float(v)
        return rows
    rows = [None if r is None else dict(r) for r in meta]
    if len(rows) != n:
        raise ValueError(f"meta has {len(rows)} rows for {n} vectors")
    return rows


def meta_rows_to_store(
    rows: Optional[Sequence[Optional[dict]]],
) -> Optional[MetadataStore]:
    """Per-row dicts → columnar store (None when no row carries any).

    Column typing is by value: all-integral → tag column, otherwise
    numeric; the ``"text"`` column (strings) becomes ``texts``."""
    if rows is None or not any(r for r in rows):
        return None
    n = len(rows)
    cols: Dict[str, list] = {}
    for i, r in enumerate(rows):
        if not r:
            continue
        for k, v in r.items():
            cols.setdefault(k, [None] * n)[i] = v
    tags, nums, texts = {}, {}, None
    for name, vals in cols.items():
        if any(isinstance(v, str) for v in vals if v is not None):
            if name != "text":
                raise ValueError(f"string column must be named 'text': {name}")
            texts = tuple(vals)
            continue
        if all(isinstance(v, (bool, int, np.integer))
               for v in vals if v is not None):
            tags[name] = np.asarray(
                [TAG_MISSING if v is None else int(v) for v in vals], np.int64
            )
        else:
            nums[name] = np.asarray(
                [np.nan if v is None else float(v) for v in vals], np.float32
            )
    return MetadataStore(tags=tags, nums=nums, texts=texts)


# ---------------------------------------------------------------------------
# Mutable segmented data plane
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    """One immutable sealed segment: a packed IVF index whose ``ids`` are
    stable external ids. Row r of ``index.x`` is addressed everywhere as
    ``(seg_id, r)``; deletions never rewrite a sealed segment, they flip
    a bit in the owning :class:`SegmentedIndex`'s dead-row bitmap."""

    seg_id: int
    index: IVFIndex

    @property
    def nb(self) -> int:
        return self.index.nb


@dataclass(frozen=True)
class CompactionPlan:
    """Consistent snapshot handed to the (off-path, lock-free) seal step.

    ``ids``/``x`` are the live rows of the structures being compacted
    (delta buffer + ``merge_seg_ids`` sealed segments), sorted by external
    id, on the host. ``carry_seg_ids`` keep serving untouched through the
    swap."""

    base_generation: int
    merge_seg_ids: Tuple[int, ...]
    carry_seg_ids: Tuple[int, ...]
    ids: np.ndarray                 # [n] int64, sorted ascending
    x: np.ndarray                   # [n, D] float32
    # per-row metadata dicts aligned with ids/x (None when no row has any)
    meta: Optional[Tuple[Optional[dict], ...]] = None


def _seg_loc(seg: Segment) -> Dict[int, Tuple[int, int]]:
    """external id -> (seg_id, row) for every row of one sealed segment."""
    ids = seg.index.ids.tolist()
    return dict(zip(ids, zip([seg.seg_id] * len(ids), range(len(ids)))))


class SegmentedIndex:
    """Mutable segmented vector index: sealed segments + delta + tombstones.

    The single shared data plane of the serving stack: every replica's
    :class:`repro_torch.serve.HarmonyServer` holds a reference to the same
    object, so one ``upsert``/``delete`` is immediately visible to all of
    them, and a compaction commit (generation bump) tells every replica
    to adopt the new segment set.

    Thread model: all mutation happens under ``_mu``; readers take a
    :meth:`snapshot` (immutable segments plus copies of the dead bitmaps
    and delta state, taken under the lock) and search lock-free on a
    point-in-time view. Delta rows are append-only host numpy (an upsert
    of an existing id appends a new row and kills the old one), so a
    reader never observes a torn vector. Sealed rows live on ``device``,
    the device of the segments' indexes.

    >>> import numpy as np
    >>> from repro_torch.config import HarmonyConfig
    >>> rng = np.random.default_rng(0)
    >>> x = rng.standard_normal((64, 4)).astype(np.float32)
    >>> cfg = HarmonyConfig(dim=4, nlist=4, nprobe=4, topk=3, kmeans_iters=2)
    >>> si = SegmentedIndex.build(x, cfg, device="cpu")
    >>> si.n_segments, si.delta_len, si.nb_live
    (1, 0, 64)
    >>> si.upsert([64], x[:1] + 1.0)
    >>> si.delete([0, 1])
    2
    >>> si.delta_len, si.nb_live, sorted(si.dead_count_by_segment().values())
    (1, 63, [2])
    >>> si.compact_inline(merge_all=True)       # one-shot, serving paused
    >>> si.generation, si.n_segments, si.delta_len, si.nb_live
    (1, 1, 0, 63)
    """

    def __init__(self, cfg: HarmonyConfig, segments: Sequence[Segment] = (),
                 device: DeviceLike = None):
        self.cfg = cfg
        self._mu = threading.RLock()
        self.segments: Tuple[Segment, ...] = tuple(segments)
        self.device = (self.segments[0].index.device
                       if self.segments and device is None
                       else resolve_device(device))
        self.generation = 0
        # monotone counter of sealed-row tombstone flips: deletes do not
        # bump generation, so (generation, dead_version) keys anything
        # derived from the dead bitmaps
        self.dead_version = 0
        self._next_seg_id = 1 + max((s.seg_id for s in self.segments), default=-1)
        # sealed-row tombstones: seg_id -> bool [nb] (True = dead)
        self._dead_rows: Dict[int, np.ndarray] = {
            s.seg_id: np.zeros(s.nb, bool) for s in self.segments
        }
        # location maps: external id -> (seg_id, row) | delta row
        self._loc: Dict[int, Tuple[int, int]] = {}
        for s in self.segments:
            self._loc.update(_seg_loc(s))
        # append-only delta buffer (doubled on growth; old buffers stay
        # valid for readers that snapshotted them)
        self._delta_x = np.zeros((0, cfg.dim), np.float32)
        self._delta_ids = np.zeros((0,), np.int64)
        self._delta_live = np.zeros((0,), bool)
        self._delta_meta: List[Optional[dict]] = []   # row n -> meta dict
        self._delta_len = 0
        self._delta_pos: Dict[int, int] = {}
        self._journal: Optional[List[tuple]] = None     # ops during compaction
        self.op_count = 0               # total accepted upsert/delete rows
        # durability hook (a write-ahead log with append_upsert /
        # append_delete): when attached, every accepted write is journaled
        # before the call returns; wal_seq is the last durable record
        self._wal = None
        self.wal_seq = 0
        # memory tier per sealed segment: seg_id -> "device" | "host"
        # (absent = "device"); placement_version bumps on every set_tiers
        self._tier: Dict[int, str] = {}
        self.placement_version = 0
        # per-segment cluster-hotness EWMA, fed by the serving layer
        self.hotness_alpha = 0.25
        self._hotness: Dict[int, np.ndarray] = {}

    # --------------------------------------------------------- constructors
    @classmethod
    def build(
        cls, x: np.ndarray, cfg: HarmonyConfig,
        ids: Optional[np.ndarray] = None, device: DeviceLike = None,
    ) -> "SegmentedIndex":
        """Build a one-sealed-segment index (the static special case)."""
        return cls.from_static(build_ivf(np.asarray(x, np.float32), cfg, ids,
                                         device=device))

    @classmethod
    def from_static(cls, index: IVFIndex) -> "SegmentedIndex":
        """Wrap an already-built index as generation 0."""
        return cls(index.cfg, [Segment(seg_id=0, index=index)],
                   device=index.device)

    @classmethod
    def from_arrays(cls, cfg: Union[HarmonyConfig, Mapping], state: Mapping,
                    device: DeviceLike = None) -> "SegmentedIndex":
        """Rebuild a data plane from plain numpy state, such as another
        build's (the JAX package's) ``SegmentedIndex``.

        ``state`` holds ``segments``, a list of dicts each with ``seg_id``
        and the :func:`ivf_from_arrays` arrays (``meta`` included);
        ``dead_rows`` (seg_id -> bool [nb]) and ``dead_version``; the
        delta's ``delta_ids``, ``delta_x``, ``delta_live`` and
        ``delta_meta`` (per-row dicts or None); ``generation``,
        ``next_seg_id`` and optionally ``op_count``. The sealed rows go
        to ``device``; the location maps are derived from the live rows.
        """
        if not isinstance(cfg, HarmonyConfig):
            names = {f.name for f in dataclasses.fields(HarmonyConfig)}
            cfg = HarmonyConfig(**{k: v for k, v in dict(cfg).items()
                                   if k in names})
        dev = resolve_device(device)
        segs = []
        for seg in state["segments"]:
            seg_cfg = cfg.replace(nlist=len(seg["centers"]),
                                  nprobe=min(cfg.nprobe, len(seg["centers"])))
            segs.append(Segment(seg_id=int(seg["seg_id"]),
                                index=ivf_from_arrays(seg_cfg, seg, device=dev)))
        out = cls(cfg, segs, device=dev)
        out.generation = int(state["generation"])
        out.dead_version = int(state["dead_version"])
        out.op_count = int(state.get("op_count", 0))
        out._next_seg_id = int(state["next_seg_id"])
        out._loc = {}
        for s in segs:
            dead = np.array(state["dead_rows"][s.seg_id], bool)
            out._dead_rows[s.seg_id] = dead
            rows = np.nonzero(~dead)[0]
            out._loc.update(zip(s.index.ids[rows].tolist(),
                                ((s.seg_id, r) for r in rows.tolist())))
        n = len(state["delta_ids"])
        out._delta_x = np.array(state["delta_x"], np.float32).reshape(n, cfg.dim)
        out._delta_ids = np.array(state["delta_ids"], np.int64)
        out._delta_live = np.array(state["delta_live"], bool)
        meta = state.get("delta_meta")
        out._delta_meta = list(meta) if meta is not None else [None] * n
        out._delta_len = n
        out._delta_pos = {int(i): r for r, i in enumerate(out._delta_ids)
                          if out._delta_live[r]}
        return out

    # ------------------------------------------------------------ properties
    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def nlist(self) -> int:
        """Cluster count of the plan/routing cluster space (the config's
        nlist; small sealed segments may carry fewer centroids)."""
        return self.cfg.nlist

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def delta_len(self) -> int:
        """Live rows currently in the delta buffer."""
        with self._mu:
            return int(self._delta_live[: self._delta_len].sum())

    @property
    def nb_live(self) -> int:
        """Total live vectors (sealed minus tombstoned, plus delta)."""
        with self._mu:
            return len(self._loc) + len(self._delta_pos)

    def dead_count_by_segment(self) -> Dict[int, int]:
        with self._mu:
            return {sid: int(d.sum()) for sid, d in self._dead_rows.items()}

    # ------------------------------------------------------ tier placement
    def tiers(self) -> Dict[int, str]:
        """seg_id -> tier for every sealed segment (point-in-time copy)."""
        with self._mu:
            return {s.seg_id: self._tier.get(s.seg_id, "device")
                    for s in self.segments}

    def set_tiers(self, tiers: Dict[int, str]) -> int:
        """Install a placement (seg_id -> "device"|"host") and bump
        ``placement_version`` so every serving replica re-syncs on its
        next batch. Unknown seg ids are ignored; omitted segments keep
        their tier. Returns the new version. (The port's executor serves
        the device tier only; the host tier comes with tiered placement.)"""
        live = {s.seg_id for s in self.segments}
        with self._mu:
            for sid, tier in tiers.items():
                if tier not in ("device", "host"):
                    raise ValueError(f"unknown tier {tier!r}")
                if int(sid) in live:
                    self._tier[int(sid)] = tier
            self.placement_version += 1
            return self.placement_version

    def note_probes(self, seg_id: int, probes: np.ndarray) -> None:
        """Fold one batch's probe selection for segment ``seg_id`` into
        its cluster-hotness EWMA. Padding entries (< 0) are ignored."""
        seg = next((s for s in self.segments if s.seg_id == seg_id), None)
        if seg is None:
            return
        flat = np.asarray(probes).ravel()
        flat = flat[(flat >= 0) & (flat < seg.index.nlist)]
        counts = np.bincount(flat, minlength=seg.index.nlist)
        with self._mu:
            h = self._hotness.get(seg_id)
            if h is None or len(h) != seg.index.nlist:
                h = np.zeros(seg.index.nlist, np.float64)
                self._hotness[seg_id] = h
            a = self.hotness_alpha
            h *= (1.0 - a)
            h += a * counts

    def hotness(self, seg_id: int) -> np.ndarray:
        """Cluster-hotness EWMA of one segment (zeros until probed)."""
        seg = next((s for s in self.segments if s.seg_id == seg_id), None)
        nlist = seg.index.nlist if seg is not None else 0
        with self._mu:
            h = self._hotness.get(int(seg_id))
            return h.copy() if h is not None else np.zeros(nlist, np.float64)

    def has(self, ext_id: int) -> bool:
        """Is ``ext_id`` live (reachable by search)?"""
        with self._mu:
            return int(ext_id) in self._loc or int(ext_id) in self._delta_pos

    @property
    def compaction_in_flight(self) -> bool:
        """Is a begin→commit compaction cycle currently open?"""
        with self._mu:
            return self._journal is not None

    # ----------------------------------------------------------- durability
    def attach_wal(self, wal) -> None:
        """Journal every later accepted write to ``wal`` (an object with
        ``append_upsert(ids, vecs, meta_rows)`` and ``append_delete(ids)``
        returning the record's sequence number), inside the critical
        section that applies it, so log order is apply order. Pass
        ``None`` to detach."""
        with self._mu:
            self._wal = wal

    # -------------------------------------------------------------- writes
    def _kill_locked(self, ext_id: int) -> bool:
        """Remove ``ext_id``'s current live copy (sealed tombstone or delta
        mask). Returns True if a copy existed."""
        loc = self._loc.pop(ext_id, None)
        if loc is not None:
            self._dead_rows[loc[0]][loc[1]] = True
            self.dead_version += 1
            return True
        row = self._delta_pos.pop(ext_id, None)
        if row is not None:
            self._delta_live[row] = False
            return True
        return False

    def _append_delta_locked(self, ext_id: int, vec: np.ndarray,
                             meta_row: Optional[dict] = None) -> None:
        n = self._delta_len
        if n == len(self._delta_x):
            cap = max(64, 2 * len(self._delta_x))
            for name in ("_delta_x", "_delta_ids", "_delta_live"):
                old = getattr(self, name)
                new = np.zeros((cap,) + old.shape[1:], old.dtype)
                new[:n] = old[:n]
                setattr(self, name, new)    # readers keep their old buffer
        self._delta_x[n] = vec
        self._delta_ids[n] = ext_id
        self._delta_live[n] = True
        self._delta_meta.append(meta_row or None)
        self._delta_len = n + 1
        self._delta_pos[ext_id] = n

    def upsert(self, ids: Sequence[int], vecs: np.ndarray, meta=None) -> None:
        """Insert-or-replace vectors under stable external ids. The newest
        version wins immediately: any older copy (sealed or delta) is
        tombstoned in the same critical section. ``meta`` attaches
        per-row metadata (omitting it clears a replaced row's).

        Ids are int64 throughout; the device pipeline carries int32 row
        positions and maps them to ids on the host, so any id is served
        on the card."""
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        ids = np.asarray(ids, np.int64).reshape(-1)
        if vecs.shape != (len(ids), self.dim):
            raise ValueError(f"vectors {vecs.shape} for {len(ids)} ids of "
                             f"dim {self.dim}")
        meta_rows = meta_rows_from_batch(meta, len(ids))
        with self._mu:
            for r, (i, v) in enumerate(zip(ids.tolist(), vecs)):
                self._kill_locked(i)
                self._append_delta_locked(
                    i, v, None if meta_rows is None else meta_rows[r]
                )
            self.op_count += len(ids)
            if self._journal is not None:
                self._journal.append(
                    ("upsert", ids.copy(), vecs.copy(), meta_rows)
                )
            if self._wal is not None:
                self.wal_seq = self._wal.append_upsert(ids, vecs, meta_rows)

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone external ids. Returns how many were actually live."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._mu:
            removed = sum(1 for i in ids.tolist() if self._kill_locked(i))
            self.op_count += len(ids)
            if self._journal is not None:
                self._journal.append(("delete", ids.copy()))
            if self._wal is not None:
                self.wal_seq = self._wal.append_delete(ids)
            return removed

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> "DataSnapshot":
        """Point-in-time read view for one search: immutable sealed
        segments plus copies of the dead bitmaps and the delta's live
        id/row state (an upsert of a sealed id flips its dead bit and
        appends the new row as one write; a reader sharing the live
        bitmap could see one half without the other)."""
        with self._mu:
            n = self._delta_len
            return DataSnapshot(
                generation=self.generation,
                segments=self.segments,
                dead_rows={sid: d.copy() for sid, d in self._dead_rows.items()},
                delta_ids=self._delta_ids[:n].copy(),
                delta_x=self._delta_x[:n],          # append-only: rows < n frozen
                delta_live=self._delta_live[:n].copy(),
                dead_version=self.dead_version,
                delta_meta=tuple(self._delta_meta[:n]),
                tiers={s.seg_id: self._tier.get(s.seg_id, "device")
                       for s in self.segments},
                placement_version=self.placement_version,
            )

    def _live_rows_locked(self, seg_ids=None):
        """(ids, host rows, meta rows) of the live sealed rows of the
        segments in ``seg_ids`` (all by default), then of the live delta."""
        parts_i, parts_x, meta_rows = [], [], []
        for s in self.segments:
            if seg_ids is not None and s.seg_id not in seg_ids:
                continue
            alive = ~self._dead_rows[s.seg_id]
            parts_i.append(s.index.ids[alive])
            parts_x.append(
                s.index.x[torch.as_tensor(alive, device=s.index.device)]
                .cpu().numpy())
            if s.index.meta is not None:
                store = s.index.meta.select(np.nonzero(alive)[0])
                meta_rows.extend(store.row(r) for r in range(store.n))
            else:
                meta_rows.extend([None] * int(alive.sum()))
        n = self._delta_len
        live = self._delta_live[:n]
        parts_i.append(self._delta_ids[:n][live].copy())
        parts_x.append(self._delta_x[:n][live].copy())
        meta_rows.extend(self._delta_meta[r] for r in np.nonzero(live)[0])
        ids = np.concatenate(parts_i)
        x = np.concatenate(parts_x) if ids.size else np.zeros((0, self.dim), np.float32)
        return ids, x, meta_rows

    def live_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, x) of every live vector on the host, sorted by external
        id: the brute-force-oracle and from-scratch-rebuild reference set."""
        with self._mu:
            ids, x, _ = self._live_rows_locked()
        order = np.argsort(ids, kind="stable")
        return ids[order], np.ascontiguousarray(x[order])

    # ----------------------------------------------------------- compaction
    def begin_compaction(self, merge_all: bool = False,
                         merge_seg_ids: Optional[Sequence[int]] = None
                         ) -> CompactionPlan:
        """Open a compaction: snapshot the rows to re-seal and start
        journaling writes so the (long) seal step can run off the serving
        path. Exactly one compaction may be in flight."""
        with self._mu:
            if self._journal is not None:
                raise RuntimeError("a compaction is already in flight")
            if merge_seg_ids is None:
                merge_seg_ids = ([s.seg_id for s in self.segments]
                                 if merge_all else [])
            merge_seg_ids = tuple(int(s) for s in merge_seg_ids)
            carry = tuple(s.seg_id for s in self.segments
                          if s.seg_id not in merge_seg_ids)
            ids, x, meta_rows = self._live_rows_locked(set(merge_seg_ids))
            order = np.argsort(ids, kind="stable")
            self._journal = []
            return CompactionPlan(
                base_generation=self.generation,
                merge_seg_ids=merge_seg_ids,
                carry_seg_ids=carry,
                ids=ids[order],
                x=np.ascontiguousarray(x[order]),
                meta=(tuple(meta_rows[i] for i in order)
                      if any(r for r in meta_rows) else None),
            )

    def seal(self, plan: CompactionPlan) -> List[Segment]:
        """Heavy step (k-means + pack), run outside the lock: seal the
        plan's rows into a new segment on the plane's device. The port's
        k-means is seeded from numpy, so its centers differ from the
        reference's for the same rows."""
        if plan.ids.size == 0:
            return []
        n = int(plan.ids.size)
        nlist = max(1, min(self.cfg.nlist, n))
        seg_cfg = self.cfg.replace(
            nlist=nlist, nprobe=min(self.cfg.nprobe, nlist)
        )
        with self._mu:
            seg_id = self._next_seg_id
            self._next_seg_id += 1
        index = build_ivf(plan.x, seg_cfg, ext_ids=plan.ids, meta=plan.meta,
                          device=self.device)
        # quantize at seal, off the serving path: the int8 tier is part of
        # the sealed artifact
        index.int8_quant(self.cfg.quant_blocks)
        return [Segment(seg_id=seg_id, index=index)]

    def abort_compaction(self) -> None:
        with self._mu:
            self._journal = None

    def commit_compaction(self, plan: CompactionPlan,
                          new_segments: Sequence[Segment]) -> int:
        """Atomically install the sealed segments and replay the writes
        that arrived during the seal. Bumps ``generation``. Returns the
        new generation."""
        # the new segments' location entries are made outside the lock:
        # the critical section stays O(journal), not O(corpus)
        new_loc: Dict[int, Tuple[int, int]] = {}
        for s in new_segments:
            new_loc.update(_seg_loc(s))
        with self._mu:
            if self._journal is None:
                raise RuntimeError("no compaction in flight")
            if self.generation != plan.base_generation:
                self._journal = None
                raise RuntimeError("concurrent generation change")
            carry = [s for s in self.segments if s.seg_id in plan.carry_seg_ids]
            self.segments = tuple(carry) + tuple(new_segments)
            self._dead_rows = {
                sid: d for sid, d in self._dead_rows.items()
                if sid in plan.carry_seg_ids
            }
            for s in new_segments:
                self._dead_rows[s.seg_id] = np.zeros(s.nb, bool)
            keep = set(plan.carry_seg_ids)
            self._tier = {sid: t for sid, t in self._tier.items() if sid in keep}
            self._hotness = {sid: h for sid, h in self._hotness.items()
                             if sid in keep}
            # carried entries survive, merged / delta entries now point at
            # the new sealed rows
            if not plan.carry_seg_ids:
                self._loc = new_loc
            elif plan.merge_seg_ids:
                self._loc = {i: l for i, l in self._loc.items()
                             if l[0] in plan.carry_seg_ids}
                self._loc.update(new_loc)
            else:
                self._loc.update(new_loc)   # sealed entries all carried
            self._delta_x = np.zeros((0, self.cfg.dim), np.float32)
            self._delta_ids = np.zeros((0,), np.int64)
            self._delta_live = np.zeros((0,), bool)
            self._delta_meta = []
            self._delta_len = 0
            self._delta_pos = {}
            ops, self._journal = self._journal, None
            self.generation += 1
            # replay the journal onto the new structures (idempotent kills
            # + fresh delta appends; ops were counted when first applied)
            for op in ops:
                if op[0] == "upsert":
                    _, ids, vecs, meta_rows = op
                    for r, (i, v) in enumerate(zip(ids.tolist(), vecs)):
                        self._kill_locked(i)
                        self._append_delta_locked(
                            i, v, None if meta_rows is None else meta_rows[r],
                        )
                else:
                    for i in op[1].tolist():
                        self._kill_locked(i)
            return self.generation

    def compact_inline(self, merge_all: bool = False) -> None:
        """Synchronous begin→seal→commit."""
        plan = self.begin_compaction(merge_all=merge_all)
        try:
            segs = self.seal(plan)
        except BaseException:
            self.abort_compaction()
            raise
        self.commit_compaction(plan, segs)


@dataclass(frozen=True)
class DataSnapshot:
    """One search's point-in-time view of a :class:`SegmentedIndex`."""

    generation: int
    segments: Tuple[Segment, ...]
    dead_rows: Dict[int, np.ndarray]    # seg_id -> bool [nb] (point-in-time copy)
    delta_ids: np.ndarray               # [n] int64
    delta_x: np.ndarray                 # [n, D] float32 (frozen host rows)
    delta_live: np.ndarray              # [n] bool
    dead_version: int = 0               # tombstone-flip counter at snapshot
    delta_meta: Tuple[Optional[dict], ...] = ()   # [n] per-row meta dicts
    # seg_id -> "device" | "host" at snapshot time, and the placement
    # version it reflects (replicas re-sync executors when it moves)
    tiers: Optional[Dict[int, str]] = None
    placement_version: int = 0

    @property
    def delta_count(self) -> int:
        return int(self.delta_live.sum())
