"""The port's int8 tier against the JAX package: the affine per-block grid
(``Int8Quant``, ``quantize_vectors``) byte for byte, the mesh packing of
the codes, and the host two-stage search (``tests/test_quantization.py``'s
cases, through ``repro_torch`` on the same index)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import PartitionPlan as RPlan
from repro.core import build_ivf as r_build
from repro.core import preassign as r_preassign
from repro.core import quantize_vectors as r_quantize
from repro.core import search_oracle as r_oracle
from repro.core import two_stage_search as r_two_stage
from repro.core.pipeline import SpmdConfig as RScfg
from repro.core.pipeline import build_corpus_arrays as r_corpus_arrays
from repro.core.pipeline import build_query_arrays as r_query_arrays
from repro.data import make_dataset, make_queries
from repro_torch.core import (
    Int8Quant,
    PartitionPlan,
    assign_queries,
    ivf_from_arrays,
    preassign,
    quantize_vectors,
    search_oracle,
    two_stage_search,
)
from repro_torch.core.pipeline import (
    SpmdConfig,
    build_corpus_arrays,
    build_query_arrays,
)
from repro_torch.core.router import load_aware_assignment, ring_offsets
from test_executor import assert_matches_oracle


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=3000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=32, nprobe=8, topk=10, kmeans_iters=4)
    ref = r_build(ds.x, cfg)
    idx = ivf_from_arrays(
        dataclasses.asdict(cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids,
             cluster_of=ref.cluster_of, offsets=ref.offsets),
        device="cpu")
    q = make_queries(ds, nq=48, skew=0.3, noise=0.2, seed=1)
    return cfg, ref, idx, q


def _recall(ids, ref_ids):
    k = ref_ids.shape[1]
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(ids, ref_ids)])


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ------------------------------------------------------------ the grid


@pytest.mark.parametrize("dim,d_blocks", [(32, 1), (32, 2), (32, 4), (30, 4)])
def test_quantize_vectors_byte_identical(dim, d_blocks):
    rng = np.random.default_rng(dim + d_blocks)
    x = (rng.normal(size=(500, dim)) * rng.uniform(0.5, 4, dim)).astype(np.float32)
    x[:, -1] = 2.5                                   # a constant column
    got, want = quantize_vectors(x, d_blocks), r_quantize(x, d_blocks)
    for name in ("codes", "scale", "zero"):
        assert _same_bytes(getattr(got, name), getattr(want, name)), name
    assert got.d_blocks == d_blocks and got.bounds == want.bounds
    # queries may fall outside the corpus's range: they clip the same way
    q = (rng.normal(size=(20, dim)) * 6).astype(np.float32)
    assert _same_bytes(got.encode(q), want.encode(q))
    assert _same_bytes(got.decode(), want.decode())
    assert _same_bytes(got.decode(got.encode(q)), want.decode(want.encode(q)))
    assert _same_bytes(got.code_norms2(), want.code_norms2())
    assert got.code_norms2() is got.code_norms2()    # cached for the corpus
    assert _same_bytes(got.code_norms2(got.encode(q)), want.code_norms2(want.encode(q)))
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("d_blocks", [1, 4])
def test_scores_match_reference(anns, d_blocks):
    _, ref, idx, q = anns
    got, want = idx.int8_quant(d_blocks), ref.int8_quant(d_blocks)
    qc = got.encode(q[:8])
    rows = np.arange(0, idx.nb, 7)
    w_all, w_rows = want.scores(qc), want.scores(qc, rows=rows)
    np.testing.assert_allclose(got.scores(qc), w_all, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores(qc, rows=rows), w_rows, rtol=1e-5, atol=1e-4)
    # the device form repeats the host form's f32 operations: bit-equal
    dev = got.device_scores(qc, "cpu")
    assert dev.dtype == torch.float32
    assert dev.numpy().tobytes() == w_all.tobytes()


def test_int8_quant_caches_per_d_blocks_and_attach_installs(anns):
    cfg, _, idx, _ = anns
    a = idx.int8_quant()
    assert a.d_blocks == cfg.quant_blocks
    assert idx.int8_quant(cfg.quant_blocks) is a
    b = idx.int8_quant(2)
    assert b is not a and b.d_blocks == 2 and idx.int8_quant(2) is b
    mine = Int8Quant(codes=b.codes.copy(), scale=b.scale.copy(), zero=b.zero.copy())
    idx.attach_int8_quant(mine)
    assert idx.int8_quant(2) is mine
    idx.attach_int8_quant(b)


# --------------------------------------------------------- mesh packing


@pytest.mark.parametrize("V,B", [(1, 1), (1, 2), (2, 2), (1, 4)])
def test_int8_corpus_and_query_arrays_byte_identical(anns, V, B):
    _, ref, idx, q = anns
    plan = PartitionPlan(v_shards=V, d_blocks=B,
                         cluster_to_shard=load_aware_assignment(idx.sizes, None, V),
                         ring_offsets=ring_offsets(V, B))
    corpus = preassign(idx, plan, pad_to=64)
    rcorpus = r_preassign(ref, RPlan(v_shards=V, d_blocks=B,
                                     cluster_to_shard=plan.cluster_to_shard,
                                     ring_offsets=plan.ring_offsets), pad_to=64)
    kw = dict(v_shards=V, d_blocks=B, qb=8 * B, cap=corpus.cap + 64,
              dim=-(-32 // B) * B, nprobe=8, k=40, chunk=64, precision="int8")
    got = build_corpus_arrays(corpus, SpmdConfig(**kw), quant=idx.int8_quant())
    want = r_corpus_arrays(rcorpus, RScfg(**kw), quant=ref.int8_quant())
    assert got["x_blocks"].dtype == torch.int8
    for name in ("x_blocks", "xn2_blocks", "scale2", "cluster_ids", "row_ids"):
        assert _same_bytes(got[name].numpy(), want[name]), name
    for a, b in zip(got["quant_grid"], want["quant_grid"]):
        assert _same_bytes(a, b)
    # the executor's grid is quantize_vectors' at the mesh's blocking
    # (reused at B = quant_blocks, refit to the same rows elsewhere)
    ref_grid = quantize_vectors(idx.x.numpy(), B)
    assert _same_bytes(got["quant_grid"][0], ref_grid.scale)
    assert _same_bytes(got["quant_grid"][1], ref_grid.zero)
    probes = assign_queries(idx, q)
    tau0 = np.full(len(q), np.inf, np.float32)
    gq = build_query_arrays(q[:5], SpmdConfig(**kw), probes[:5], tau0[:5],
                            quant_grid=got["quant_grid"])
    wq = r_query_arrays(q[:5], RScfg(**kw), probes[:5], tau0[:5],
                        quant_grid=want["quant_grid"])
    assert gq["queries"].dtype == np.int8
    for name in ("queries", "probes", "tau0"):
        assert _same_bytes(gq[name], wq[name]), name


def test_int8_config_is_l2_only():
    with pytest.raises(ValueError, match="l2"):
        SpmdConfig(v_shards=1, d_blocks=1, precision="int8", metric="ip")
    with pytest.raises(ValueError, match="grid"):
        build_query_arrays(np.zeros((1, 8), np.float32),
                           SpmdConfig(v_shards=1, d_blocks=1, dim=8, qb=8,
                                      precision="int8"),
                           np.zeros((1, 2), np.int32), np.zeros(1, np.float32))


# ----------------------------------------------------- host two-stage


def test_two_stage_recall_and_exact_scores(anns):
    cfg, ref, idx, q = anns
    oracle = search_oracle(idx, q, k=cfg.topk)
    res = two_stage_search(idx, q, k=cfg.topk, nprobe=cfg.nlist)
    assert res.stats["precision"] == "int8"
    assert res.stats["rerank_k"] == cfg.topk * cfg.rerank_factor
    assert _recall(res.ids, oracle.ids) >= 0.98
    # any id the two paths agree on carries the *exact* fp32 score
    for i in range(q.shape[0]):
        m = dict(zip(oracle.ids[i].tolist(), oracle.scores[i].tolist()))
        for j, e in enumerate(res.ids[i].tolist()):
            if e in m:
                np.testing.assert_allclose(res.scores[i, j], m[e],
                                           rtol=1e-4, atol=1e-5)
    # and the reference's host path gives the same result
    want = r_two_stage(ref, q, k=cfg.topk, nprobe=cfg.nlist)
    assert_matches_oracle(res, want)
    assert res.stats["stage1_survivors"] == want.stats["stage1_survivors"]


def test_two_stage_full_coverage_is_oracle(anns):
    """With every cluster probed and K' = nb, stage 1 cannot drop a true
    neighbour: the result is the oracle."""
    cfg, ref, idx, q = anns
    res = two_stage_search(idx, q[:16], k=cfg.topk, nprobe=cfg.nlist,
                           rerank_factor=-(-idx.nb // cfg.topk))
    assert res.stats["rerank_k"] == idx.nb
    assert_matches_oracle(res, search_oracle(idx, q[:16], k=cfg.topk))
    assert_matches_oracle(res, r_oracle(ref, q[:16], k=cfg.topk))


def test_two_stage_dead_rows(anns):
    cfg, ref, idx, q = anns
    base = two_stage_search(idx, q[:4], k=cfg.topk, nprobe=cfg.nlist)
    dead = np.zeros(idx.nb, bool)
    order = np.argsort(idx.ids, kind="stable")
    top = base.ids[0, 0]
    dead[order[np.searchsorted(idx.ids[order], top)]] = True
    res = two_stage_search(idx, q[:4], k=cfg.topk, nprobe=cfg.nlist,
                           dead_rows=dead)
    assert top not in res.ids[0]
    assert_matches_oracle(res, r_two_stage(ref, q[:4], k=cfg.topk,
                                           nprobe=cfg.nlist, dead_rows=dead))


def test_two_stage_is_l2_only():
    from repro_torch.config import HarmonyConfig
    from repro_torch.core import build_ivf

    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3, kmeans_iters=2,
                        metric="ip")
    with pytest.raises(ValueError, match="l2"):
        two_stage_search(build_ivf(x, cfg, device="cpu"), x[:2])
