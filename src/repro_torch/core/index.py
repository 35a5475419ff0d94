"""IVF index build and the V × B sharded layout (static part).

The index's corpus rows live on the device as a tensor. The bookkeeping
stays host-side numpy, exactly as in the reference: centers, ids, the
cluster of each packed row, cluster offsets, cluster slices and the
packed-row permutation. The V × B layout that ``preassign`` makes is
host-side too, as in the reference: the executor packs it and uploads
one copy. Probe selection (``assign_queries``) is the reference's
host-side numpy computation. The int8 tier's codes and grids
(``Int8Quant``, ``quantize_vectors``) are host numpy too, made from one
host copy of the rows.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

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
          build_times: Dict[str, float]) -> IVFIndex:
    """Add stage: cluster-sort the rows (stable) and compute offsets."""
    t0 = time.perf_counter()
    order = np.argsort(assign, kind="stable")
    x_sorted = xt[torch.as_tensor(order, device=xt.device)].contiguous()
    counts = np.bincount(assign, minlength=cfg.nlist)
    offsets = np.zeros((cfg.nlist + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = order if ext_ids is None else np.asarray(ext_ids, np.int64)[order]
    build_times = dict(build_times, add=time.perf_counter() - t0)
    return IVFIndex(
        cfg=cfg,
        centers=np.asarray(centers, np.float32),
        x=x_sorted,
        ids=ids.astype(np.int64),
        cluster_of=assign[order].astype(np.int32),
        offsets=offsets,
        build_times=build_times,
    )


def build_ivf(
    x, cfg: HarmonyConfig, ext_ids: Optional[np.ndarray] = None,
    centers: Optional[np.ndarray] = None, device: DeviceLike = None,
) -> IVFIndex:
    """Train + Add stages on ``device`` (CUDA by default).

    With ``centers`` given, training is skipped and every row goes to its
    nearest center (argmin, lowest center on ties). ``ext_ids`` names
    each input row with a stable external id (default: row position).
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
                 {"train": time.perf_counter() - t0})


def ivf_from_arrays(
    cfg: Union[HarmonyConfig, Mapping], arrays: Mapping[str, np.ndarray],
    device: DeviceLike = None,
) -> IVFIndex:
    """Rebuild an index from another build's arrays.

    ``arrays`` holds ``centers``, ``x``, ``ids``, ``cluster_of`` and
    ``offsets`` (numpy, packed order, e.g. from the JAX package's
    ``IVFIndex``); ``cfg`` is a ``HarmonyConfig`` or its field dict. The
    rows go to ``device``; the bookkeeping is copied as is.
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
