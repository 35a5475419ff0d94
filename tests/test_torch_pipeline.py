"""The port's ring search on virtual V × B meshes against the JAX
package: packing parity, the device gather, the top-k of the reference
oracle for every geometry (fp32, and the int8 tier's quantized top-K'
against a brute force over the reference's codes), and the tile-skip
accounting of the reference executor on the 1 × 1 mesh."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import PartitionPlan as RPlan
from repro.core import build_ivf as r_build
from repro.core import preassign as r_preassign
from repro.core import quantize_vectors as r_quantize
from repro.core import search_oracle as r_oracle
from repro.core.pipeline import SpmdConfig as RScfg
from repro.core.pipeline import build_corpus_arrays as r_corpus_arrays
from repro.core.pipeline import build_query_arrays as r_query_arrays
from repro.core.pipeline import gather_local_candidates as r_gather
from repro.data import make_dataset, make_queries
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import SpmdExecutor as RExecutor
from repro_torch.core import (
    PartitionPlan,
    assign_queries,
    ivf_from_arrays,
    preassign,
    prewarm_tau,
)
from repro_torch.core.pipeline import (
    SpmdConfig,
    build_corpus_arrays,
    build_query_arrays,
    gather_local_candidates,
    resident_arrays,
    ring_chunk_search,
)
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.serve import ExecutorConfig, SpmdExecutor
from test_executor import assert_matches_oracle


@pytest.fixture(scope="module")
def anns():
    ds = make_dataset(nb=2000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=16, nprobe=4, topk=5, kmeans_iters=4)
    ref = r_build(ds.x, cfg)
    idx = ivf_from_arrays(
        dataclasses.asdict(cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids,
             cluster_of=ref.cluster_of, offsets=ref.offsets),
        device="cpu")
    q = make_queries(ds, nq=16, skew=0.2, noise=0.2, seed=1)
    return ref, idx, q


def _layout(idx, V, B, chunk):
    plan = PartitionPlan(v_shards=V, d_blocks=B,
                         cluster_to_shard=load_aware_assignment(idx.sizes, None, V),
                         ring_offsets=ring_offsets(V, B))
    corpus = preassign(idx, plan, pad_to=chunk)
    return plan, corpus


@pytest.mark.parametrize("V,B", [(1, 1), (2, 2), (3, 4)])
def test_corpus_and_query_arrays_match_reference(anns, V, B):
    ref, idx, q = anns
    plan, corpus = _layout(idx, V, B, 64)
    rcorpus = r_preassign(ref, RPlan(v_shards=V, d_blocks=B,
                                     cluster_to_shard=plan.cluster_to_shard,
                                     ring_offsets=plan.ring_offsets), pad_to=64)
    dim = -(-32 // B) * B
    kw = dict(v_shards=V, d_blocks=B, qb=8 * B, cap=corpus.cap + 64, dim=dim,
              nprobe=4, k=5, chunk=64)
    got = build_corpus_arrays(corpus, SpmdConfig(**kw))
    want = r_corpus_arrays(rcorpus, RScfg(**kw))
    assert got["x_blocks"].numpy().tobytes() == want["x_blocks"].tobytes()
    for name in ("cluster_ids", "row_ids"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
        assert got[name].dtype == torch.int32
    np.testing.assert_allclose(got["xn2_blocks"].numpy(), want["xn2_blocks"],
                               rtol=1e-6)
    probes = assign_queries(idx, q)
    tau0 = np.linspace(1, 2, len(q)).astype(np.float32)
    gq = build_query_arrays(q[:5], SpmdConfig(**kw), probes[:5], tau0[:5])
    wq = r_query_arrays(q[:5], RScfg(**kw), probes[:5], tau0[:5])
    for name in ("queries", "probes", "tau0"):
        assert gq[name].tobytes() == wq[name].tobytes(), name


def test_gather_local_candidates_matches_reference(anns):
    _, idx, _ = anns
    V, B, chunk = 2, 2, 64
    _, corpus = _layout(idx, V, B, chunk)
    scfg = SpmdConfig(v_shards=V, d_blocks=B, qb=8, cap=corpus.cap, dim=32,
                      chunk=chunk)
    arrays = build_corpus_arrays(corpus, scfg)
    res = resident_arrays(arrays, scfg)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, corpus.cap, size=(V, 96)).astype(np.int64)
    rows[:, 80:] = -1
    x_c, xn2_c, cl_c, id_c = gather_local_candidates(
        torch.from_numpy(rows), res["x_blk"], res["xn2_blk"],
        res["cluster_ids"], res["row_ids"])
    db = 32 // B
    for v in range(V):
        for b in range(B):
            rx, rn, rc, ri = r_gather(
                jnp.asarray(rows[v]),
                jnp.asarray(arrays["x_blocks"][v, :, b * db:(b + 1) * db].numpy()),
                jnp.asarray(arrays["xn2_blocks"][b, v].numpy()),
                jnp.asarray(arrays["cluster_ids"][v].numpy()),
                jnp.asarray(arrays["row_ids"][v].numpy()))
            np.testing.assert_array_equal(x_c[v, b].numpy(), np.asarray(rx))
            np.testing.assert_array_equal(xn2_c[v, b].numpy(), np.asarray(rn))
            np.testing.assert_array_equal(cl_c[v].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(id_c[v].numpy(), np.asarray(ri))


@pytest.mark.parametrize("V,B", [(1, 1), (1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("prune", [True, False])
def test_ring_chunk_search_matches_reference_oracle(anns, V, B, prune):
    ref, idx, q = anns
    chunk = 64
    _, corpus = _layout(idx, V, B, chunk)
    scfg = SpmdConfig(v_shards=V, d_blocks=B, qb=16, cap=corpus.cap, dim=32,
                      nprobe=4, k=5, chunk=chunk, prune=prune)
    res = resident_arrays(build_corpus_arrays(corpus, scfg), scfg)
    probes = assign_queries(idx, q)
    tau0 = (prewarm_tau(idx, q, probes, 5) if prune
            else np.full(len(q), np.inf, np.float32))
    qa = build_query_arrays(q, scfg, probes, tau0)
    gs, gi, stats = ring_chunk_search(
        scfg, res["x_blk"], res["xn2_blk"], res["cluster_ids"], res["row_ids"],
        *(torch.from_numpy(qa[n]) for n in ("queries", "probes", "tau0")))
    scores = gs.numpy()
    ids = gi.numpy().astype(np.int64)
    ids[~np.isfinite(scores)] = -1
    assert_matches_oracle(
        type("R", (), dict(scores=scores, ids=ids)), r_oracle(ref, q))
    # one 128 × 128 tile per (shard, group, chunk, stage): QG ≤ 128, chunk = 64
    assert int(stats[1]) == V * B * (corpus.cap // chunk) * B
    assert 0 <= int(stats[0]) <= int(stats[1])


@pytest.mark.parametrize("prune", [True, False])
def test_tile_stats_equal_reference_executor_on_1x1(anns, prune):
    """With B = 1 the entry accumulator is the probe mask alone, so the
    skip count involves no float and must equal the reference's."""
    ref, idx, q = anns
    kw = dict(chunk=64, qb_buckets=(8, 16), prune=prune, tile_m=8, tile_n=32)
    rex = RExecutor(ref, RExCfg(**kw))
    tex = SpmdExecutor(idx, ExecutorConfig(**kw), device="cpu")
    assert tex.cap_buckets == rex.cap_buckets
    assert tex.qb_buckets == rex.qb_buckets
    for lo, hi in ((0, 16), (3, 4), (5, 13)):
        r = rex.search_batch(q[lo:hi])
        t = tex.search_batch(q[lo:hi])
        assert t.stats["buckets"] == r.stats["buckets"]
        assert t.stats["tile_total"] == r.stats["tile_total"] > 0
        assert t.stats["tile_skipped"] == r.stats["tile_skipped"]
        assert_matches_oracle(t, r)


@pytest.mark.parametrize("V,B", [(1, 1), (1, 2), (2, 2), (4, 2)])
def test_int8_ring_returns_quantized_topk(anns, V, B):
    """The int8 ring keeps the quantized top-K' of the probed rows: a
    brute force with the reference's ``Int8Quant.scores`` on the
    reference's codes at this mesh's grid, ids equal except across ties."""
    ref, idx, q = anns
    chunk, kp = 64, 20
    _, corpus = _layout(idx, V, B, chunk)
    scfg = SpmdConfig(v_shards=V, d_blocks=B, qb=16, cap=corpus.cap, dim=32,
                      nprobe=4, k=kp, chunk=chunk, precision="int8")
    arrays = build_corpus_arrays(corpus, scfg, quant=idx.int8_quant())
    res = resident_arrays(arrays, scfg)
    assert res["x_blk"].dtype == torch.int8 and tuple(res["scale2"].shape) == (B,)
    probes = assign_queries(idx, q)
    qa = build_query_arrays(q, scfg, probes, np.full(len(q), np.inf, np.float32),
                            quant_grid=arrays["quant_grid"])
    gs, gi, stats = ring_chunk_search(
        scfg, res["x_blk"], res["xn2_blk"], res["cluster_ids"], res["row_ids"],
        *(torch.from_numpy(qa[n]) for n in ("queries", "probes", "tau0")),
        scale2=res["scale2"])
    scores = gs.numpy()
    ids = gi.numpy().astype(np.int64)
    ids[~np.isfinite(scores)] = -1
    rq = r_quantize(ref.x, B)
    d8 = rq.scores(rq.encode(q))
    member = np.zeros((len(q), ref.nlist), bool)
    member[np.arange(len(q))[:, None], probes] = True
    d8 = np.where(member[:, ref.cluster_of], d8, np.inf)
    order = np.argsort(d8, axis=1, kind="stable")[:, :kp]
    want_s = np.take_along_axis(d8, order, axis=1)
    want_i = np.where(np.isfinite(want_s), ref.ids[order], -1)
    assert_matches_oracle(type("R", (), dict(scores=scores, ids=ids)),
                          type("W", (), dict(scores=want_s, ids=want_i)))
    assert int(stats[1]) == V * B * (corpus.cap // chunk) * B


@pytest.mark.parametrize("prune", [True, False])
def test_int8_tile_stats_equal_reference_executor_on_1x1(anns, prune):
    """τ starts at +inf on the int8 tier, so with B = 1 every skip comes
    from the probe mask and the counts must equal the reference's."""
    ref, idx, q = anns
    kw = dict(chunk=64, qb_buckets=(8, 16), prune=prune, tile_m=8, tile_n=32,
              precision="int8")
    rex = RExecutor(ref, RExCfg(**kw))
    tex = SpmdExecutor(idx, ExecutorConfig(**kw), device="cpu")
    for lo, hi in ((0, 16), (3, 4), (5, 13)):
        r = rex.search_batch(q[lo:hi])
        t = tex.search_batch(q[lo:hi])
        assert t.stats["buckets"] == r.stats["buckets"]
        assert t.stats["rerank_k"] == r.stats["rerank_k"] == 20
        assert t.stats["tile_total"] == r.stats["tile_total"] > 0
        assert t.stats["tile_skipped"] == r.stats["tile_skipped"]
        assert_matches_oracle(t, r)
