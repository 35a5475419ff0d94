"""IVF index build and the V × B sharded layout (static part).

The index's corpus rows live on the device as a tensor. The bookkeeping
stays host-side numpy, exactly as in the reference: centers, ids, the
cluster of each packed row, cluster offsets, cluster slices and the
packed-row permutation. The V × B layout that ``preassign`` makes is
host-side too, as in the reference: the executor packs it and uploads
one copy. Probe selection (``assign_queries``) is the reference's
host-side numpy computation.
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
