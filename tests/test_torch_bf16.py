"""bf16 rows (``x_dtype="bfloat16"``) in the port against the JAX package
(CPU).

(a) kernel level: the same bf16 rows and norms through the reference's
    Pallas ``partial_distance_update`` (interpret mode) and jnp oracle and
    through the port's plain version, at rtol = atol = 1e-3;
(b) executor level: the port's bf16 executor against an exact oracle over
    the bf16-rounded corpus (ids but across ties, scores at 1e-3);
(c) recall@k of the port's bf16 executor against the reference's;
(d) the bf16 block norms, where the port diverges by design: the
    reference sums bf16 products in bf16, the port in f32.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import build_ivf as r_build
from repro.core.index import dim_block_bounds
from repro.core.pipeline import SpmdConfig as RSpmdConfig
from repro.core.pipeline import build_corpus_arrays as r_corpus_arrays
from repro.data import make_dataset, make_queries, recall_at_k
from repro.kernels import ref as r_ref
from repro.kernels.distance import partial_distance_update as pallas_distance
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import SpmdExecutor as RExecutor
from repro_torch.core import ivf_from_arrays, search_oracle
from repro_torch.core.pipeline import SpmdConfig, build_corpus_arrays
from repro_torch.kernels import ops, ref
from repro_torch.serve import ExecutorConfig, SpmdExecutor
from test_executor import assert_matches_oracle


def _port(ref_index, x=None):
    return ivf_from_arrays(
        dataclasses.asdict(ref_index.cfg),
        dict(centers=ref_index.centers, x=ref_index.x if x is None else x,
             ids=ref_index.ids, cluster_of=ref_index.cluster_of,
             offsets=ref_index.offsets),
        device="cpu")


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 rows rounded to bf16 (round to nearest even) and widened back."""
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=4000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=32, nprobe=6, topk=5, kmeans_iters=4)
    ref_index = r_build(ds.x, cfg)
    q = make_queries(ds, nq=64, skew=0.3, noise=0.2, seed=1)
    return ref_index, _port(ref_index), q


@pytest.mark.parametrize("m,n,d,tile_k", [(8, 64, 32, 32), (16, 128, 64, 64),
                                          (5, 96, 48, 16)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_bf16_plain_matches_reference_kernel(m, n, d, tile_k, metric):
    rng = np.random.default_rng(m + n + d)
    xb = rng.normal(size=(n, d)).astype(np.float32).astype(ml_dtypes.bfloat16)
    xf = xb.astype(np.float32)
    q = rng.normal(size=(m, d)).astype(np.float32)
    xn2, qn2 = (xf * xf).sum(1), (q * q).sum(1)
    acc = rng.uniform(0, 5, size=(m, n)).astype(np.float32)
    acc[rng.random((m, n)) < 0.3] = np.inf
    tau = np.full(m, np.inf, np.float32)
    xt = torch.from_numpy(xf).to(torch.bfloat16)
    assert np.array_equal(xt.float().numpy(), xf)          # the same rows
    ops.reset_launch_counts()
    got, skip = ops.partial_distance_update(
        xt, *map(torch.from_numpy, (xn2, q, qn2, acc, tau)), metric=metric,
        tile_m=8, tile_n=32, tile_k=tile_k)
    assert ops.launch_counts()["partial_distance_update_ref"] == 1
    args = [jnp.asarray(a) for a in (xb, xn2, q, qn2, acc, tau)]
    pal, _ = pallas_distance(*args, metric=metric, tile_m=8, tile_n=32, tile_k=tile_k,
                             interpret=True)
    jref = r_ref.partial_distance_update_ref(*args, metric=metric)
    for want in (np.asarray(pal), np.asarray(jref)):
        finite = np.isfinite(want)
        assert np.array_equal(np.isfinite(got.numpy()), finite)
        np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-3, atol=1e-3)
    # the plain version is the f32 one on the widened rows, bit for bit
    f32 = ref.partial_distance_update_ref(
        torch.from_numpy(xf), *map(torch.from_numpy, (xn2, q, qn2, acc, tau)),
        metric=metric, tile_k=tile_k)
    assert torch.equal(got, f32)


def test_bf16_packing_halves_the_rows(anns):
    _, idx, _ = anns
    f32 = SpmdExecutor(idx, ExecutorConfig(chunk=128, qb_buckets=(8, 32)), device="cpu")
    b16 = SpmdExecutor(idx, ExecutorConfig(chunk=128, qb_buckets=(8, 32),
                                           x_dtype="bfloat16"), device="cpu")
    xa, xb = f32._resident["x_blk"], b16._resident["x_blk"]
    assert xb.dtype == torch.bfloat16 and xb.shape == xa.shape
    assert xb.nbytes * 2 == xa.nbytes
    assert torch.equal(xb, xa.to(torch.bfloat16))
    # int8 keeps its codes whatever x_dtype says, as in the reference
    i8 = SpmdExecutor(idx, ExecutorConfig(chunk=128, precision="int8",
                                          x_dtype="bfloat16"), device="cpu")
    assert i8._resident["x_blk"].dtype == torch.int8


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_bf16_executor_matches_rounded_oracle(anns, mesh):
    ref_index, idx, q = anns
    rounded = _port(ref_index, x=_bf16_round(ref_index.x))
    kw = dict(chunk=128, qb_buckets=(8, 32), x_dtype="bfloat16")
    if mesh is not None:
        kw["d_blocks"] = mesh[1]
    ex = SpmdExecutor(idx, ExecutorConfig(**kw), mesh=mesh, device="cpu")
    ops.reset_launch_counts()
    res = ex.search_batch(q)
    assert ops.launch_counts()["partial_distance_update_ref"] > 0
    want = search_oracle(rounded, q)
    assert_matches_oracle(res, want)
    np.testing.assert_array_equal(res.ids, want.ids)


def test_bf16_recall_against_reference_executor(anns):
    """(c): recall@5 of the port's bf16 executor against the reference's
    (its jnp path) on the same index, reported. On this index the
    reference's bf16 executor finds 0.9156 of the exact top-5 over the
    rounded corpus (its block norms are bf16 sums, off by up to a few per
    cent of ‖x‖²), the port all of it: every id where the two differ is a
    miss of the reference's. Against the f32 oracle the port keeps 0.99."""
    ref_index, idx, q = anns
    rounded = search_oracle(_port(ref_index, x=_bf16_round(ref_index.x)), q)
    kw = dict(chunk=128, qb_buckets=(8, 32), x_dtype="bfloat16")
    want = RExecutor(ref_index, RExCfg(use_pallas=False, **kw)).search_batch(q)
    got = SpmdExecutor(idx, ExecutorConfig(**kw), device="cpu").search_batch(q)
    recall = recall_at_k(got.ids, want.ids)
    ref_recall = recall_at_k(want.ids, rounded.ids)
    print(f"bf16 recall@5: port vs reference executor {recall:.4f}; reference vs "
          f"the rounded oracle {ref_recall:.4f}; port vs it "
          f"{recall_at_k(got.ids, rounded.ids):.4f}")
    assert recall_at_k(got.ids, rounded.ids) == 1.0
    assert recall == ref_recall
    assert recall_at_k(got.ids, search_oracle(idx, q).ids) >= 0.98


def test_bf16_block_norms_diverge_from_reference_by_design(anns):
    """Queue 3, by design: the port's bf16 block norms are f32 sums of the
    rounded rows (what the reference's "accum stays f32" note intends);
    the reference's ``np.sum`` over ``ml_dtypes`` bf16 arrays sums in bf16
    and errs by up to a few per cent."""
    ref_index, idx, _ = anns
    from repro.core import preassign as r_preassign
    from repro.core.router import load_aware_assignment, ring_offsets
    from repro.core.types import PartitionPlan
    from repro_torch.core import preassign

    plan = PartitionPlan(v_shards=1, d_blocks=2,
                         cluster_to_shard=load_aware_assignment(ref_index.sizes, None, 1),
                         ring_offsets=ring_offsets(1, 2))
    kw = dict(v_shards=1, d_blocks=2, cap=4096, dim=32, x_dtype="bfloat16")
    r_arr = r_corpus_arrays(r_preassign(ref_index, plan, pad_to=128), RSpmdConfig(**kw))
    t_arr = build_corpus_arrays(preassign(idx, plan, pad_to=128), SpmdConfig(**kw))
    rows = t_arr["x_blocks"].float().numpy()
    np.testing.assert_array_equal(rows, np.asarray(r_arr["x_blocks"], np.float32))
    for b, (lo, hi) in enumerate(dim_block_bounds(32, 2)):
        f32 = (rows[:, :, lo:hi] * rows[:, :, lo:hi]).sum(2, dtype=np.float64)
        np.testing.assert_allclose(t_arr["xn2_blocks"][b].numpy(), f32, rtol=1e-6)
    r_xn2 = np.asarray(r_arr["xn2_blocks"], np.float32)
    t_xn2 = t_arr["xn2_blocks"].numpy()
    live = t_xn2 > 0
    rel = np.abs(r_xn2[live] - t_xn2[live]) / t_xn2[live]
    assert rel.max() > 1e-3                    # the reference's bf16 sum
