"""The dimension-ring search on a virtual V × B mesh on one device (§4.3).

The reference runs the ring under ``shard_map``: device (v, b) owns
dimension block b of vector shard v, query groups' accumulators rotate
round the ``model`` axis with ``ppermute``, and ``all_gather`` +
``lax.top_k`` merge the results. Here the same V × B grid is a set of
explicit loops on one GPU, with the same semantics:

* shard v's ring starts at ``offset_v = v % B``; in stage t the device
  (v, b) scores group ``(b − t − offset_v) mod B``, so group g of shard v
  visits blocks ``(g + offset_v + t) mod B`` for t = 0 … B−1;
* a chunk's entry accumulator is the probe mask (0 where the row's
  cluster is probed, +inf elsewhere); τ travels with its group unchanged
  within a chunk and tightens between chunks to
  ``min(tau0, kth best so far)``;
* each (chunk, stage) is one :func:`kernels.ops.partial_distance_update`
  (``precision="int8"``: :func:`kernels.ops.int8_partial_distance_update`
  on the codes, with the block's s²) and each chunk ends with one
  :func:`kernels.ops.running_topk_update`;
* the cross-shard merge is a stable sort, which orders ties by index as
  ``lax.top_k`` does, so the result does not depend on the geometry;
* with ``n_pods`` = P > 1 each pod holds a corpus super-shard of its own
  (a leading [P] axis on the corpus operands) and runs the same V × B
  ring over it; the pods then merge by the same stable sort, pod-major,
  as the reference's ``all_gather`` over ``pod`` and ``lax.top_k`` do.

Stats sum the tile skip maps over every (pod, v, b, chunk, stage), as the
reference's ``psum``\\ s do.

The reference's whole-mesh step, ``make_spmd_search(scfg, mesh)``, takes
``VirtualMesh(data=V, model=B)`` here (``VirtualMesh(data=V, model=B,
pod=P)`` with pods), and its operands come from :func:`build_spmd_inputs`
(with pods, :func:`build_pod_inputs`; shapes and dtypes:
:func:`input_specs`). The reference's ``corpus_shardings`` /
``query_shardings`` / ``input_shardings`` place those operands on a
device mesh; the port runs on one card and has no counterpart.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.index import (
    Int8Quant,
    ShardedCorpus,
    dim_block_bounds,
    encode_int8,
    fit_int8_grid,
)
from repro_torch.kernels import ops as kops
from repro_torch.virtual_mesh import VirtualMesh


@dataclass(frozen=True)
class SpmdConfig:
    """Static geometry of the ring search step.

    ``n_pods`` > 1 stacks that many corpus super-shards on a leading axis
    of the corpus operands; the queries are every pod's. ``x_dtype`` is ``"float32"`` or
    ``"bfloat16"`` (the resident rows of the fp32 precision; queries,
    norms and sums stay f32; the int8 precision keeps its codes whatever
    it says). ``precision`` is ``"fp32"`` or ``"int8"`` (the quantized
    stage 1, L2 only).
    ``use_pallas`` is kept for signature parity: the route is chosen by
    the tensors' device (kernel on CUDA, plain version on the CPU), and
    ``False`` is not supported.
    """

    v_shards: int          # vector shards (per pod)
    d_blocks: int          # dimension blocks
    n_pods: int = 1        # corpus super-shards
    qb: int = 64           # queries per step
    cap: int = 1024        # padded rows per shard
    dim: int = 128         # padded to d_blocks * db
    nprobe: int = 8
    k: int = 10
    chunk: int = 512       # candidate rows scored per ring pass
    metric: str = "l2"
    prune: bool = True
    x_dtype: str = "float32"    # bf16 halves the resident rows (sums stay f32)
    precision: str = "fp32"
    use_pallas: Optional[bool] = True
    tile_m: int = 128
    tile_n: int = 128
    tile_k: int = 128

    @property
    def qg(self) -> int:
        assert self.qb % self.d_blocks == 0, (self.qb, self.d_blocks)
        return self.qb // self.d_blocks

    @property
    def db(self) -> int:
        assert self.dim % self.d_blocks == 0, (self.dim, self.d_blocks)
        return self.dim // self.d_blocks

    @property
    def n_chunks(self) -> int:
        assert self.cap % self.chunk == 0, (self.cap, self.chunk)
        return self.cap // self.chunk

    def __post_init__(self):
        if self.precision not in ("fp32", "int8"):
            raise NotImplementedError(f"precision={self.precision!r}")
        if self.precision == "int8" and self.metric != "l2":
            # the shared-grid quantized difference form is L2-only
            raise ValueError("precision='int8' needs metric='l2', "
                             f"got {self.metric!r}")
        if self.x_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"x_dtype={self.x_dtype!r}")
        if not (isinstance(self.n_pods, int) and self.n_pods >= 1):
            raise ValueError(f"n_pods={self.n_pods!r}")
        if self.use_pallas is False:
            raise NotImplementedError(
                "use_pallas=False: the route follows the tensors' device")
        if self.metric not in ("l2", "ip"):
            raise ValueError(self.metric)


# ---------------------------------------------------------------------------
# Input packaging
# ---------------------------------------------------------------------------


def build_corpus_arrays(corpus: ShardedCorpus, scfg: SpmdConfig,
                        quant: Optional[Int8Quant] = None):
    """Pack the sharded corpus into the step's resident arrays, in the
    reference's layout, on the corpus's device:

      x_blocks   [V, cap, D_pad]  f32 | bf16 | int8 codes
      xn2_blocks [B, V, cap]      f32
      cluster_ids[V, cap]         i32
      row_ids    [V, cap]         i32
      scale2     [B]              f32   (int8 only: s² per dim block)

    With ``precision="int8"`` the codes are made on the host with the
    reference's numpy arithmetic, so they are byte-identical to it:
    ``xn2_blocks`` carries the pre-scaled s²·Σcode² norms, the grid comes
    from ``quant`` when its blocking matches this mesh, else is fit to
    this layout (:func:`_mesh_quant_grid`), and the dict also holds the
    host-only ``quant_grid`` = (scale [B], zero [B]) that queries are
    encoded on. Padded rows and dims encode literal 0.0 on the same grid
    as query padding, so padding contributes exactly 0.

    With ``x_dtype="bfloat16"`` the rows are rounded to bf16 and the block
    norms are f32 sums of the rounded rows. The reference sums them in
    bf16 (``np.sum`` over ``ml_dtypes`` arrays), which errs by up to a
    few per cent of ‖x‖²; the port keeps f32 accumulation, as the
    reference's own note on ``x_dtype`` intends.
    """
    V, B = scfg.v_shards, scfg.d_blocks
    cap, D = scfg.cap, scfg.dim
    if corpus.plan.v_shards != V:
        raise ValueError((corpus.plan.v_shards, V))
    xs = corpus.x_shard
    if xs.shape[1] > cap:
        raise ValueError((tuple(xs.shape), cap))
    dev = xs.device
    n = xs.shape[1]

    cluster_ids = torch.full((V, cap), -1, dtype=torch.int32, device=dev)
    cluster_ids[:, :n] = torch.as_tensor(corpus.cluster_shard, device=dev)
    row_ids = torch.full((V, cap), -1, dtype=torch.int32, device=dev)
    row_ids[:, :n] = torch.as_tensor(corpus.ids_shard.astype(np.int32), device=dev)

    if scfg.precision == "int8":
        xs_np = xs.cpu().numpy()
        xf = np.zeros((V, cap, D), np.float32)
        xf[:, :n, : xs_np.shape[2]] = xs_np
        scale, zero = _mesh_quant_grid(xs_np, corpus.valid, scfg, quant)
        codes = np.empty((V, cap, D), np.int8)
        xn2_np = np.zeros((B, V, cap), np.float32)
        for b, (lo, hi) in enumerate(dim_block_bounds(D, B)):
            cb = encode_int8(xf[:, :, lo:hi], zero[b], scale[b])
            codes[:, :, lo:hi] = cb
            c32 = cb.astype(np.int32)
            xn2_np[b] = (scale[b] ** 2) * np.sum(c32 * c32, axis=2)
        return dict(
            x_blocks=torch.as_tensor(codes, device=dev),
            xn2_blocks=torch.as_tensor(xn2_np, device=dev),
            cluster_ids=cluster_ids,
            row_ids=row_ids,
            scale2=torch.as_tensor(scale.astype(np.float32) ** 2, device=dev),
            quant_grid=(scale, zero),   # host-only: the queries' grid
        )

    xdt = torch.bfloat16 if scfg.x_dtype == "bfloat16" else torch.float32
    x_blocks = torch.zeros((V, cap, D), dtype=xdt, device=dev)
    x_blocks[:, :n, : xs.shape[2]] = xs
    xn2_blocks = torch.zeros((B, V, cap), dtype=torch.float32, device=dev)
    if xdt == torch.float32 and corpus.xnorm2_blk.shape[1] == B:
        # zero padding (rows or dims) does not change block norms
        xn2_blocks[:, :, :n] = corpus.xnorm2_blk.permute(1, 0, 2)
    else:
        # the rounded rows (or another block split) have their own norms
        for b, (lo, hi) in enumerate(dim_block_bounds(D, B)):
            seg = x_blocks[:, :, lo:hi].float()
            xn2_blocks[b] = (seg * seg).sum(2)
    return dict(x_blocks=x_blocks, xn2_blocks=xn2_blocks,
                cluster_ids=cluster_ids, row_ids=row_ids)


def _mesh_quant_grid(xs: np.ndarray, valid: np.ndarray, scfg: SpmdConfig,
                     quant: Optional[Int8Quant]):
    """(scale [B], zero [B]) for this mesh's dimension blocking.

    Reuses the given grid when its per-block dim ranges coincide with the
    mesh blocking (``quant.d_blocks == B`` and minimal dim padding);
    otherwise fits a fresh grid to the shard layout's valid rows, a
    deterministic function of the corpus."""
    B, db = scfg.d_blocks, scfg.db
    if (quant is not None and quant.d_blocks == B
            and -(-quant.codes.shape[1] // B) == db):
        return quant.scale.copy(), quant.zero.copy()
    scale = np.ones(B, np.float32)
    zero = np.zeros(B, np.float32)
    rows = xs[valid[:, : xs.shape[1]]] if valid.size else xs.reshape(-1, xs.shape[2])
    for b, (lo, hi) in enumerate(dim_block_bounds(scfg.dim, B)):
        zero[b], scale[b] = fit_int8_grid(rows[:, lo:min(hi, rows.shape[1])])
    return scale, zero


def resident_arrays(arrays: dict, scfg: SpmdConfig) -> dict:
    """Re-lay :func:`build_corpus_arrays`'s dict block-major for the
    virtual mesh: x_blk [V, B, cap, Db] and xn2_blk [V, B, cap], so that
    every (shard, block, chunk) slice the kernels read is contiguous.
    ``scale2`` [B] (int8) is carried as is; the host-only ``quant_grid``
    is left out."""
    V, B, db = scfg.v_shards, scfg.d_blocks, scfg.db
    x = arrays["x_blocks"]
    cap = x.shape[1]
    out = dict(
        x_blk=x.reshape(V, cap, B, db).permute(0, 2, 1, 3).contiguous(),
        xn2_blk=arrays["xn2_blocks"].permute(1, 0, 2).contiguous(),
        cluster_ids=arrays["cluster_ids"].contiguous(),
        row_ids=arrays["row_ids"].contiguous(),
    )
    if "scale2" in arrays:
        out["scale2"] = arrays["scale2"].contiguous()
    return out


def build_query_arrays(
    q: np.ndarray, scfg: SpmdConfig, probes: np.ndarray, tau0: np.ndarray,
    quant_grid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Pack one query batch (host numpy), padded to ``scfg.qb``:

      queries [QB, D_pad] f32 | int8 codes, probes [QB, P] i32 (-2 =
      match nothing), tau0 [QB] f32 (-inf on pad rows, so they prune
      everything).

    With ``precision="int8"`` the queries are encoded on the corpus's
    grid (``quant_grid`` = (scale [B], zero [B])); padded rows and dims
    encode literal 0.0 like the corpus padding.
    """
    qb, D = scfg.qb, scfg.dim
    queries = np.zeros((qb, D), np.float32)
    nq = min(q.shape[0], qb)
    queries[:nq, : q.shape[1]] = q[:nq]
    if scfg.precision == "int8":
        if quant_grid is None:
            raise ValueError("int8 queries need the corpus grid (quant_grid)")
        scale, zero = quant_grid
        codes = np.empty((qb, D), np.int8)
        for b, (lo, hi) in enumerate(dim_block_bounds(D, scfg.d_blocks)):
            codes[:, lo:hi] = encode_int8(queries[:, lo:hi], zero[b], scale[b])
        queries = codes
    probes_pad = np.zeros((qb, probes.shape[1]), np.int32)
    probes_pad[:nq] = probes[:nq]
    probes_pad[nq:] = -2
    tau_pad = np.full((qb,), -np.inf, np.float32)
    tau_pad[:nq] = tau0[:nq]
    return dict(queries=queries, probes=probes_pad, tau0=tau_pad)


def build_spmd_inputs(index, corpus: ShardedCorpus, q: np.ndarray, scfg: SpmdConfig,
                      probes: np.ndarray, tau0: np.ndarray) -> dict:
    """Corpus and query-batch packing in one call: :func:`build_corpus_arrays`
    (the int8 grid from ``index.int8_quant``) and :func:`build_query_arrays`
    on that grid, every array a tensor on the corpus's device, keyed as
    :func:`input_specs` lists them."""
    quant = index.int8_quant(scfg.d_blocks) if scfg.precision == "int8" else None
    arrays = build_corpus_arrays(corpus, scfg, quant=quant)
    grid = arrays.pop("quant_grid", None)
    dev = arrays["x_blocks"].device
    queries = build_query_arrays(q, scfg, probes, tau0, quant_grid=grid)
    return {**arrays, **{k: torch.as_tensor(v, device=dev) for k, v in queries.items()}}


CORPUS_OPERANDS = ("x_blocks", "xn2_blocks", "cluster_ids", "row_ids")


def build_pod_inputs(index, corpus: ShardedCorpus, q: np.ndarray, scfg: SpmdConfig,
                     probes: np.ndarray, tau0: np.ndarray) -> dict:
    """:func:`build_spmd_inputs` for ``scfg.n_pods`` = P super-shards:
    ``corpus`` has P · V vector shards, pod p owning shards p·V … p·V+V−1.
    Every pod's rows are packed on one int8 grid (``index.int8_quant``,
    the reference's ``scale2`` being one per dimension block, replicated
    over the pods), then the corpus operands are regrouped on a leading
    [P] axis as :func:`input_specs` lists them."""
    P, V = scfg.n_pods, scfg.v_shards
    if corpus.plan.v_shards != P * V:
        raise ValueError(f"{corpus.plan.v_shards} shards, the pods need {P} x {V}")
    flat = dataclasses.replace(scfg, v_shards=P * V, n_pods=1)
    arrays = build_spmd_inputs(index, corpus, q, flat, probes, tau0)
    x, xn2 = arrays["x_blocks"], arrays["xn2_blocks"]
    arrays["x_blocks"] = x.reshape(P, V, *x.shape[1:])
    arrays["xn2_blocks"] = xn2.reshape(xn2.shape[0], P, V, -1).transpose(0, 1).contiguous()
    for name in ("cluster_ids", "row_ids"):
        arrays[name] = arrays[name].reshape(P, V, -1)
    return arrays


def input_specs(scfg: SpmdConfig) -> dict:
    """The step's operands as ``meta`` tensors (shape and dtype, no
    storage), keyed and shaped as the reference's ``ShapeDtypeStruct`` s:
    the corpus operands lead with [n_pods] when there is more than one."""
    V, B, cap, D = scfg.v_shards, scfg.d_blocks, scfg.cap, scfg.dim
    lead = (scfg.n_pods,) if scfg.n_pods > 1 else ()
    int8 = scfg.precision == "int8"
    xdt = torch.int8 if int8 else getattr(torch, scfg.x_dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = dict(
        x_blocks=spec(lead + (V, cap, D), xdt),
        xn2_blocks=spec(lead + (B, V, cap), torch.float32),
        cluster_ids=spec(lead + (V, cap), torch.int32),
        row_ids=spec(lead + (V, cap), torch.int32),
        queries=spec((scfg.qb, D), torch.int8 if int8 else torch.float32),
        probes=spec((scfg.qb, scfg.nprobe), torch.int32),
        tau0=spec((scfg.qb,), torch.float32),
    )
    if int8:
        out["scale2"] = spec((B,), torch.float32)
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def gather_local_candidates(rows, x_blk, xn2_blk, cluster_ids, row_ids):
    """Device-side gather of probed-cluster candidates into a padded static
    buffer, for every shard at once.

    ``rows`` [V, cap_b] int64 indexes each shard's resident rows, -1 = pad;
    x_blk [V, B, cap, Db], xn2_blk [V, B, cap], cluster_ids/row_ids
    [V, cap] as :func:`resident_arrays` lays them out. Pad slots re-read
    row 0 but get cluster id -1 (match no probe), norm 0 and id -1.
    Returns (x_c [V, B, cap_b, Db], xn2_c [V, B, cap_b], cl_c, id_c).
    """
    V, B, cap_full, db = x_blk.shape
    keep = rows >= 0
    safe = rows.clamp(0, cap_full - 1)
    base = (torch.arange(V * B, device=rows.device) * cap_full).view(V, B, 1)
    flat = base + safe[:, None, :]                       # [V, B, cap_b]
    x_c = x_blk.reshape(V * B * cap_full, db)[flat]
    xn2_c = torch.where(keep[:, None, :], xn2_blk.reshape(-1)[flat], 0.0)
    cl_c = torch.where(keep, torch.gather(cluster_ids, 1, safe), -1)
    id_c = torch.where(keep, torch.gather(row_ids, 1, safe), -1)
    return x_c, xn2_c, cl_c, id_c


def gather_host_candidates(arrays: dict, rows: np.ndarray,
                           out: Optional[dict] = None) -> dict:
    """Host-side analogue of :func:`gather_local_candidates` for a
    host-tier segment: gather the probed rows out of the host-resident
    arrays (:func:`resident_arrays`'s layout, on the CPU, pinned when a
    card is the target) into per-batch candidate arrays ready to copy to
    the device.

    ``rows`` [V, cap_b] indexes each shard's packed rows, -1 = pad. Pad
    slots re-read row 0 but get cluster id -1, norm 0 and id -1, exactly
    as the device-side gather gives them, so the ring sees the same
    values bit for bit. ``out`` (the four arrays below, preallocated, for
    instance in pinned memory) receives the result in place. Returns
    ``dict(x_c [V, B, cap_b, Db], xn2_c [V, B, cap_b], cl_c [V, cap_b],
    id_c [V, cap_b])``.
    """
    x_blk, xn2_blk = arrays["x_blk"], arrays["xn2_blk"]
    cl, rid = arrays["cluster_ids"], arrays["row_ids"]
    V, B, cap_full, db = x_blk.shape
    rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.int64)
    cap_b = rows_t.shape[1]
    keep = rows_t >= 0
    safe = rows_t.clamp(0, cap_full - 1)
    flat = ((torch.arange(V * B) * cap_full).view(V, B, 1) + safe[:, None, :]).reshape(-1)
    if out is None:
        out = dict(
            x_c=torch.empty((V, B, cap_b, db), dtype=x_blk.dtype),
            xn2_c=torch.empty((V, B, cap_b), dtype=torch.float32),
            cl_c=torch.empty((V, cap_b), dtype=torch.int32),
            id_c=torch.empty((V, cap_b), dtype=torch.int32),
        )
    torch.index_select(x_blk.reshape(-1, db), 0, flat,
                       out=out["x_c"].view(V * B * cap_b, db))
    torch.index_select(xn2_blk.reshape(-1), 0, flat, out=out["xn2_c"].view(-1))
    out["xn2_c"].masked_fill_(~keep[:, None, :], 0.0)
    torch.gather(cl, 1, safe, out=out["cl_c"])
    out["cl_c"].masked_fill_(~keep, -1)
    torch.gather(rid, 1, safe, out=out["id_c"])
    out["id_c"].masked_fill_(~keep, -1)
    return out


@tracing.traced("ring.enqueue")
def ring_chunk_search(scfg: SpmdConfig, x_blk, xn2_blk, cluster_ids, row_ids,
                      q_blk, probes, tau0, scale2=None):
    """The ring search over the whole virtual mesh.

    x_blk [V, B, cap, Db] (f32 or bf16 rows), xn2_blk [V, B, cap],
    cluster_ids/row_ids [V, cap] (cap = ``scfg.cap``), q_blk [qb, D_pad]
    f32, probes [qb, P]
    i32, tau0 [qb] f32, all on one device. Returns (scores [qb, K],
    ids [qb, K] i32, stats [4] int64 = (tiles skipped, tiles scored,
    tiles after mask, tiles stopped)). The last two count stages t ≥ 1
    only: the tiles the probe mask left live, and those of them the τ
    test had emptied by their stage (the early stop across dimension
    blocks); both are 0 at ``d_blocks`` 1 and the second with pruning
    off. They stay on the device with the rest.

    ``precision="int8"``: x_blk/q_blk carry int8 codes, xn2_blk the
    pre-scaled s²·Σcode² norms and ``scale2`` [B] each block's s². The
    ring then computes the *quantized* L2, still monotone over dimension
    blocks, so the travelling-τ pruning and the running top-K stay exact
    within the quantized metric (the fp32 re-rank is the executor's).

    The host's loop that enqueues all of it is the span ``ring.enqueue``,
    which counts the (shard, group, chunk) passes as ``chunks``.
    """
    V, B, QG, K = scfg.v_shards, scfg.d_blocks, scfg.qg, scfg.k
    chunk, n_chunks, db = scfg.chunk, scfg.n_chunks, scfg.db
    tracing.count(chunks=V * B * n_chunks)
    int8 = scfg.precision == "int8"
    dev = x_blk.device
    # q[g, b] = rows of group g restricted to dimension block b
    q = q_blk.reshape(B, QG, B, db).permute(0, 2, 1, 3).contiguous()
    if int8:
        # int32 code norms are exact; one f32 scale per block at the end
        q32 = q.to(torch.int32)
        qn2 = scale2[None, :, None] * (q32 * q32).sum(3).to(torch.float32)
    else:
        qn2 = (q * q).sum(3)                               # [g, b, QG]
    skips = []
    shard_s, shard_i = [], []
    for v in range(V):
        offset = v % B
        grp_s, grp_i = [], []
        for g in range(B):
            probes_g = probes[g * QG:(g + 1) * QG]
            tau_g0 = tau0[g * QG:(g + 1) * QG]
            run_s = torch.full((QG, K), torch.inf, dtype=torch.float32, device=dev)
            run_i = torch.full((QG, K), -1, dtype=torch.int32, device=dev)
            for c in range(n_chunks):
                sl = slice(c * chunk, (c + 1) * chunk)
                cl_c = cluster_ids[v, sl]
                mask = (probes_g[:, :, None] == cl_c[None, None, :]).any(1)
                tau = torch.minimum(tau_g0, run_s[:, -1])
                acc = torch.where(mask, 0.0, torch.inf)
                for t in range(B):
                    b = (g + offset + t) % B
                    if int8:
                        acc, skip = kops.int8_partial_distance_update(
                            x_blk[v, b, sl], xn2_blk[v, b, sl], q[g, b],
                            qn2[g, b], scale2[b], acc, tau, prune=scfg.prune,
                            tile_m=scfg.tile_m, tile_n=scfg.tile_n,
                            tile_k=scfg.tile_k,
                        )
                    else:
                        acc, skip = kops.partial_distance_update(
                            x_blk[v, b, sl], xn2_blk[v, b, sl], q[g, b],
                            qn2[g, b], acc, tau, prune=scfg.prune,
                            metric=scfg.metric, tile_m=scfg.tile_m,
                            tile_n=scfg.tile_n, tile_k=scfg.tile_k,
                        )
                    skips.append(skip.reshape(-1))
                ids_c = row_ids[v, sl].expand(QG, chunk)
                run_s, run_i = kops.running_topk_update(acc, ids_c, run_s,
                                                        run_i, k=K)
            grp_s.append(run_s)
            grp_i.append(run_i)
        shard_s.append(torch.cat(grp_s))
        shard_i.append(torch.cat(grp_i))

    gs, gi = merge_parts(shard_s, shard_i, K)
    # [pass, stage, tile]; a tile the mask left live at stage 0 and the
    # τ test emptied before stage t ≥ 1 is the early stop between blocks
    skip = torch.stack(skips).view(-1, B, skips[0].numel()).to(torch.int64)
    live = 1 - skip[:, :1]
    # a fill, not a copy from the host: a blocking copy would wait here for
    # the whole ring, inside ``ring.enqueue``, instead of at the caller's read
    stats = torch.stack([skip.sum(),
                         torch.full((), skip.numel(), dtype=torch.int64, device=dev),
                         live.sum() * (B - 1), (skip[:, 1:] * live).sum()])
    return gs, gi, stats


def merge_parts(parts_s, parts_i, k: int):
    """The top ``k`` of a row over its parts (each [qb, K] ascending): the
    parts side by side, part-major ([qb, n·K]), then a stable sort, so
    ties go by index as ``lax.top_k`` orders them. One part is returned
    as it is."""
    if len(parts_s) == 1:
        return parts_s[0], parts_i[0]
    qb = parts_s[0].shape[0]
    as_ = torch.stack(parts_s, dim=1).reshape(qb, -1)
    ai = torch.stack(parts_i, dim=1).reshape(qb, -1)
    s, pos = torch.sort(as_, dim=1, stable=True)
    return s[:, :k], torch.gather(ai, 1, pos[:, :k])


def make_device_fn(scfg: SpmdConfig):
    """The step's body with the reference's argument order, ``(x_blocks,
    xn2_blocks, cluster_ids, row_ids, [scale2,] queries, probes, tau0)``:
    the whole mesh's operands as :func:`build_spmd_inputs` gives them
    (:func:`input_specs`' shapes), re-laid by :func:`resident_arrays` and
    searched by :func:`ring_chunk_search`, which covers every (v, b) in one
    call; with pods, once a pod over its super-shard, the pods merged by
    :func:`merge_parts` and their stats summed. Returns (scores [qb, K],
    ids [qb, K], stats [2])."""
    want = input_specs(scfg)
    names = ["x_blocks", "xn2_blocks", "cluster_ids", "row_ids"] + (
        ["scale2"] if scfg.precision == "int8" else []) + ["queries", "probes", "tau0"]

    def device_fn(*operands):
        if len(operands) != len(names):
            raise TypeError(f"the step takes {len(names)} operands ({', '.join(names)}), "
                            f"got {len(operands)}")
        args = dict(zip(names, operands))
        dev = args["x_blocks"].device
        for name in names:
            a = args[name] = torch.as_tensor(args[name], device=dev)
            if a.shape != want[name].shape or a.dtype != want[name].dtype:
                raise ValueError(f"{name}: {tuple(a.shape)} {a.dtype}, the step takes "
                                 f"{tuple(want[name].shape)} {want[name].dtype}")
        if scfg.n_pods == 1:
            pods = [args]
        else:
            pods = [{**args, **{k: args[k][p] for k in CORPUS_OPERANDS}}
                    for p in range(scfg.n_pods)]
        outs = []
        for pod in pods:
            res = resident_arrays(pod, scfg)
            outs.append(ring_chunk_search(
                scfg, res["x_blk"], res["xn2_blk"], res["cluster_ids"], res["row_ids"],
                args["queries"], args["probes"], args["tau0"], scale2=res.get("scale2")))
        scores, ids = merge_parts([o[0] for o in outs], [o[1] for o in outs], scfg.k)
        return scores, ids, torch.stack([o[2][:2] for o in outs]).sum(0)

    return device_fn


def make_spmd_search(scfg: SpmdConfig, mesh: VirtualMesh):
    """The search step over ``mesh`` = ``VirtualMesh(data=scfg.v_shards,
    model=scfg.d_blocks, pod=scfg.n_pods)``: :func:`make_device_fn`'s
    callable, returning (scores, ids, stats) as the reference's
    ``jit(shard_map(...))`` does. Any other mesh raises."""
    if not isinstance(mesh, VirtualMesh):
        raise NotImplementedError(
            f"make_spmd_search over {type(mesh).__name__}: the port runs on one card; "
            "pass VirtualMesh(data=v_shards, model=d_blocks)")
    want = VirtualMesh(data=scfg.v_shards, model=scfg.d_blocks, pod=scfg.n_pods).shape
    if mesh.shape != want:
        raise ValueError(f"the mesh is {mesh.shape}, the config's is {want}")
    return make_device_fn(scfg)
