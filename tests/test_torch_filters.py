"""Filtered and hybrid search in the port against the JAX package (CPU).

The same numpy inputs from a seed go through ``repro`` and ``repro_torch``:
the filter compilation (allowed bitmaps and their cache, the excluded
mask, probe pushdown with selectivity widening), BM25 and reciprocal-rank
fusion, and ``HarmonyServer.search_batch`` with ``flt=``, ``hybrid_text=``
and a filtered ``SearchRequest`` on both backends and both precisions,
with a delta and after a seal. Ids are equal except across exact score
ties; scores agree at rtol = atol = 1e-3 (``assert_matches_oracle``).
"""

import dataclasses

import numpy as np
import pytest

from repro.config import HarmonyConfig as RCfg
from repro.core import And as RAnd
from repro.core import NumRange as RNumRange
from repro.core import SearchRequest as RRequest
from repro.core import SegmentedIndex as RSegmented
from repro.core import TagIn as RTagIn
from repro.core import build_ivf as r_build
from repro.core import search_oracle as r_oracle
from repro.core.fusion import BM25Index as RBM25
from repro.core.fusion import reciprocal_rank_fusion as r_rrf
from repro.core.fusion import tokenize as r_tokenize
from repro.core.search import filter_bitmap as r_bitmap
from repro.core.search import filter_excluded_rows as r_excluded
from repro.core.search import filtered_assign_queries as r_assign
from repro.data import make_dataset
from repro.serve import ExecutorConfig as RExCfg
from repro.serve import HarmonyServer as RServer
from repro_torch.config import HarmonyConfig
from repro_torch.core import (
    And,
    BM25Index,
    NumRange,
    SearchRequest,
    SegmentedIndex,
    TagIn,
    build_ivf,
    filter_bitmap,
    filter_excluded_rows,
    filtered_assign_queries,
    ivf_from_arrays,
    reciprocal_rank_fusion,
    search_oracle,
    segment_bm25,
    tokenize,
)
from repro_torch.serve import ExecutorConfig, HarmonyServer
from test_executor import assert_matches_oracle
from test_torch_segments import ivf_arrays, port_plane

DIM = 16
NB = 800
R_EXEC = RExCfg(qb_buckets=(8,), chunk=64, use_pallas=False)
T_EXEC = ExecutorConfig(qb_buckets=(8,), chunk=64)
BOTH = [("host", "fp32"), ("spmd", "fp32"), ("host", "int8"), ("spmd", "int8")]
VOCAB = [f"w{i}" for i in range(3000)]


def pcfg(cfg):
    """The port's config of a reference config."""
    names = {f.name for f in dataclasses.fields(HarmonyConfig)}
    return HarmonyConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def texts(rng, n):
    """~8 words a row from a 3000-word vocabulary, so most words match a
    handful of rows."""
    return [" ".join(rng.choice(VOCAB, size=int(rng.integers(6, 11))))
            for _ in range(n)]


def row_meta(rng, n):
    return {"color": rng.integers(0, 5, size=n),
            "price": rng.uniform(0.0, 1.0, size=n).astype(np.float32),
            "text": texts(rng, n)}


@pytest.fixture(scope="module")
def corpus():
    ds = make_dataset(nb=NB, dim=DIM, n_components=6, spread=0.6, seed=0)
    cfg = RCfg(dim=DIM, nlist=8, nprobe=3, topk=5, kmeans_iters=3)
    meta = row_meta(np.random.default_rng(2), NB)
    rng = np.random.default_rng(1)
    q = (ds.x[rng.choice(NB, 16, replace=False)]
         + 0.05 * rng.standard_normal((16, DIM))).astype(np.float32)
    return ds, cfg, meta, q


def both_filters():
    """(port, reference) filter pairs: selectivity ≈ 0.24 (no widening)
    and ≈ 0.06 (nprobe widened 3 → 8 = nlist)."""
    return [
        (And((TagIn("color", (1, 3)), NumRange("price", 0.0, 0.6))),
         RAnd((RTagIn("color", (1, 3)), RNumRange("price", 0.0, 0.6)))),
        (And((TagIn("color", (4,)), NumRange("price", 0.0, 0.3))),
         RAnd((RTagIn("color", (4,)), RNumRange("price", 0.0, 0.3)))),
    ]


def indexes(corpus):
    ds, cfg, meta, _ = corpus
    r = r_build(ds.x, cfg, meta=meta)
    t = ivf_from_arrays(pcfg(cfg), ivf_arrays(r), device="cpu")
    return r, t


# ------------------------------------------------------- filter compilation


def test_filter_bitmap_cache_and_no_meta(corpus):
    r, t = indexes(corpus)
    for tf, rf in both_filters():
        bm = filter_bitmap(t, tf)
        np.testing.assert_array_equal(bm, r_bitmap(r, rf))
        assert filter_bitmap(t, tf) is bm                    # cached
    assert len(t.__dict__["_filter_bitmaps"]) == 2
    for i in range(70):                                      # bounded at 64
        filter_bitmap(t, NumRange("price", 0.0, i / 100))
    assert 1 <= len(t.__dict__["_filter_bitmaps"]) <= 64
    ds, cfg, _, _ = corpus
    bare = build_ivf(ds.x, pcfg(cfg), device="cpu")
    assert not filter_bitmap(bare, TagIn("color", (1,))).any()


def test_filter_excluded_rows_matches_reference(corpus):
    r, t = indexes(corpus)
    dead = np.zeros(NB, bool)
    dead[::7] = True
    assert filter_excluded_rows(t, None, None) is None
    assert filter_excluded_rows(t, None, np.zeros(NB, bool)) is None
    assert filter_excluded_rows(t, None, dead) is dead
    for tf, rf in both_filters():
        for d in (None, dead):
            np.testing.assert_array_equal(filter_excluded_rows(t, tf, d),
                                          r_excluded(r, rf, d))


def test_filtered_assign_queries_matches_reference(corpus):
    r, t = indexes(corpus)
    q = corpus[3]
    for tf, rf in both_filters():
        ex = filter_excluded_rows(t, tf, None)
        for nprobe in (None, 2, 6):
            got = filtered_assign_queries(t, q, ex, nprobe=nprobe)
            np.testing.assert_array_equal(got, r_assign(r, q, ex, nprobe=nprobe))
    # widening: sel ≈ 0.06 < 0.2 → ceil(3 · min(4, 0.2 / sel)) = 10 → nlist 8
    ex = filter_excluded_rows(t, both_filters()[1][0], None)
    assert filtered_assign_queries(t, q, ex).shape[1] == 8
    assert filtered_assign_queries(t, q, ex, nprobe=3).shape[1] == 3   # override
    assert filtered_assign_queries(t, q, np.zeros(NB, bool)).shape[1] == 3
    # duplicate-fill: only clusters 2 and 5 hold allowed rows
    ex = ~np.isin(t.cluster_of, (2, 5))
    got = filtered_assign_queries(t, q, ex, nprobe=4)
    np.testing.assert_array_equal(got, r_assign(r, q, ex, nprobe=4))
    assert set(np.unique(got)) <= {2, 5}
    assert (got[:, 2:] == got[:, :1]).all()


def test_search_oracle_flt_matches_reference(corpus):
    r, t = indexes(corpus)
    q = corpus[3]
    dead = np.zeros(NB, bool)
    dead[::5] = True
    for tf, rf in both_filters():
        for nprobe in (3, 8):
            got = search_oracle(t, q, nprobe=nprobe, dead_rows=dead, flt=tf)
            want = r_oracle(r, q, nprobe=nprobe, dead_rows=dead, flt=rf)
            assert_matches_oracle(got, want)
            allowed = ~filter_excluded_rows(t, tf, dead)
            ok = np.isin(got.ids[got.ids >= 0], t.ids[allowed])
            assert ok.all()


# ------------------------------------------------------------ BM25 and RRF


def test_tokenize_bm25_scores_and_rrf_match_reference(corpus):
    docs = corpus[2]["text"][:200] + [None, "", "Red-Shoes, RED shoes!", "w1 w1 w1"]
    for s in ("Red-Shoes, RED shoes!", None, "", "a1 B2 c_3"):
        assert tokenize(s) == r_tokenize(s)
    t, r = BM25Index(docs), RBM25(docs)
    assert t.n == r.n and t.avg_len == r.avg_len
    np.testing.assert_array_equal(t.doc_len, r.doc_len)
    assert t.postings.keys() == r.postings.keys()
    for w in r.postings:
        np.testing.assert_array_equal(t.postings[w][0], r.postings[w][0])
        np.testing.assert_array_equal(t.postings[w][1], r.postings[w][1])
    assert t.memory_bytes() == r.memory_bytes()
    for text in ("w1 w2 w17", "shoes red", "w5 w5 nothing", "unknown"):
        np.testing.assert_array_equal(t.scores(text), r.scores(text))
        (ts, tr), (rs, rr) = t.topk(text, 5), r.topk(text, 5)
        np.testing.assert_array_equal(ts, rs)
    assert BM25Index([]).scores("x").shape == (0,)
    rng = np.random.default_rng(4)
    lists = [rng.integers(-1, 30, size=(6, 8)), rng.integers(-1, 30, size=(6, 5))]
    for k in (1, 5, 12):
        ts, ti = reciprocal_rank_fusion(lists, k)
        rs, ri = r_rrf(lists, k)
        np.testing.assert_array_equal(ts, rs)
        np.testing.assert_array_equal(ti, ri)


def test_bm25_topk_ties_go_to_the_lower_row():
    """Queue 3, by design: equal BM25 scores go to the lower row (a stable
    sort); the reference's argpartition leaves their order open. The
    scores equal the reference's either way."""
    docs = ["red shoe", "blue hat", "red shoe", "red shoe", "green", "red shoe"]
    sc, rows = BM25Index(docs).topk("red", 3)
    np.testing.assert_array_equal(rows, [0, 2, 3])
    rsc, rrows = RBM25(docs).topk("red", 3)
    np.testing.assert_array_equal(sc, rsc)
    assert set(rrows) <= {0, 2, 3, 5}
    np.testing.assert_array_equal(BM25Index(docs).topk("red", 3, excluded=np.array(
        [True, False, False, False, False, False]))[1], [2, 3, 5])


def test_segment_bm25_is_cached_and_needs_texts(corpus):
    r, t = indexes(corpus)
    bm = segment_bm25(t)
    assert bm is segment_bm25(t) and bm.n == NB
    ds, cfg, _, _ = corpus
    assert segment_bm25(build_ivf(ds.x, pcfg(cfg), device="cpu")) is None


# ----------------------------------------------------------------- servers


def servers(corpus, backend, precision, lifecycle):
    """The reference server and the port's on equal planes: metadata on
    the sealed rows, then a write burst with metadata (and rows without),
    deletes, and for ``sealed`` a reference compaction carried across."""
    ds, cfg, meta, _ = corpus
    ref = RSegmented.from_static(r_build(ds.x, cfg, meta=meta))
    rng = np.random.default_rng(5)
    fresh = np.arange(5000, 5060)
    xs = (ds.x[rng.choice(NB, 60)] + 0.05 * rng.standard_normal((60, DIM))).astype(np.float32)
    ref.upsert(fresh[:50], xs[:50], meta=row_meta(rng, 50))
    ref.upsert(fresh[50:], xs[50:])                        # no metadata
    ref.upsert(np.arange(10), ds.x[:10] + 0.01, meta=row_meta(rng, 10))
    ref.delete(np.concatenate([rng.choice(NB, 30, replace=False), fresh[:5]]))
    if lifecycle == "sealed":
        ref.compact_inline()
        ref.upsert([7000, 7001], ds.x[20:22], meta=row_meta(rng, 2))
    r = RServer(ref, n_nodes=4, backend=backend, executor_cfg=R_EXEC, precision=precision)
    t = HarmonyServer(port_plane(ref), n_nodes=4, backend=backend, executor_cfg=T_EXEC,
                      precision=precision, device="cpu")
    return r, t


@pytest.mark.parametrize("lifecycle", ["delta", "sealed"])
@pytest.mark.parametrize("backend,precision", BOTH)
def test_filtered_and_hybrid_server_match_reference(corpus, backend, precision, lifecycle):
    _, cfg, meta, q = corpus
    r, t = servers(corpus, backend, precision, lifecycle)
    rare = [w for w in VOCAB if sum(w in s.split() for s in meta["text"]) == 2][:2]
    for tf, rf in both_filters():
        for k in (5, 9):
            rr, tr = r.search_batch(q, k=k, flt=rf), t.search_batch(q, k=k, flt=tf)
            assert_matches_oracle(tr, rr)
            got = tr.ids[tr.ids >= 0]
            assert np.isin(got, t.data.live_vectors()[0]).all()
        # hybrid: the rare words match fewer rows than k, so neither side's
        # BM25 top-k has a tie to order, and the fused ids are equal
        text = " ".join(rare)
        for flt_pair in ((None, None), (tf, rf)):
            rr = r.search_batch(q, flt=flt_pair[1], hybrid_text=text)
            tr = t.search_batch(q, flt=flt_pair[0], hybrid_text=text)
            assert tr.stats["fused"] and rr.stats["fused"]
            np.testing.assert_array_equal(tr.ids, rr.ids)
            np.testing.assert_array_equal(tr.scores, rr.scores)
        # a request's filter and text ride with it
        rr = r.search_batch(RRequest(vector=q[:3], k=4, filter=rf, hybrid_text=text))
        tr = t.search_batch(SearchRequest(vector=q[:3], k=4, filter=tf, hybrid_text=text))
        np.testing.assert_array_equal(tr.ids, rr.ids)
        rr = r.search_batch(RRequest(vector=q[0], filter=rf))
        tr = t.search_batch(SearchRequest(vector=q[0], filter=tf))
        assert_matches_oracle(tr, rr)
    assert t.stats.batches == r.stats.batches


def test_filtered_spmd_keeps_the_step_cache_and_needs_no_host_engine(corpus, monkeypatch):
    """With a filter, the executor gets the excluded rows through its
    gather table: the kernels see only allowed live rows, the step of each
    new (qb, cap) bucket is built once, and widening raises the probe
    width and the cap bucket, never the host engine."""
    from repro_torch.serve import engine as t_engine

    ds, cfg, meta, q = corpus
    _, t = servers(corpus, "spmd", "fp32", "delta")

    def no_host(*a, **kw):
        raise AssertionError("the spmd backend reached the host engine")

    monkeypatch.setattr(t_engine, "harmony_search", no_host)
    t.search_batch(q)
    ex = t._seg_states[0].executors["fp32"]
    plain = dict(ex.trace_counts)
    low = both_filters()[1][0]
    t.search_batch(q, flt=low)
    wide = {key: n for key, n in ex.trace_counts.items() if key not in plain}
    assert wide and all(n == 1 for n in ex.trace_counts.values())
    assert all(key[3] == 8 for key in wide)                 # nprobe widened to nlist
    t.search_batch(q, flt=low)
    t.search_batch(q[:4], flt=low)
    assert all(n == 1 for n in ex.trace_counts.values())
    assert ex.compiles == len(ex.trace_counts)


# --------------------------------------------- mirrors of the reference's tests


def _meta_corpus(nb=2048, sel_mod=100):
    """``tests/test_tiered.py``'s corpus: 1 in ``sel_mod`` rows carries
    the target tag (selectivity 0.01), the widening cap raised to 16."""
    cfg = HarmonyConfig(dim=16, nlist=32, nprobe=2, topk=5, kmeans_iters=3,
                        filter_widen_cap=16.0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((nb, cfg.dim)).astype(np.float32)
    meta = {"bucket": np.arange(nb) % sel_mod}
    return cfg, x, meta


def _queries(x, n=12, seed=3):
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(x), n)
    return x[picks] + 0.05 * rng.standard_normal((n, x.shape[1])).astype(np.float32)


def test_filtered_widening_recovers_recall_at_low_selectivity():
    """Mirror of ``tests/test_tiered.py::test_filtered_widening_recovers_
    recall_at_low_selectivity`` on the port's own build."""
    cfg, x, meta = _meta_corpus()
    flt = TagIn("bucket", (0,))
    idx_wide = build_ivf(x, cfg, meta=meta, device="cpu")
    idx_narrow = build_ivf(x, cfg.replace(filter_widen_threshold=0.0), meta=meta,
                           device="cpu")
    q = _queries(x, n=24, seed=7)
    truth = search_oracle(idx_wide, q, nprobe=cfg.nlist, flt=flt)

    def recall(idx):
        res = HarmonyServer(idx, n_nodes=2, device="cpu").search_batch(q, flt=flt)
        hits = sum(len(set(res.ids[i].tolist()) & set(truth.ids[i].tolist()) - {-1})
                   for i in range(len(q)))
        return hits / max(int((truth.ids >= 0).sum()), 1)

    r_narrow, r_wide = recall(idx_narrow), recall(idx_wide)
    assert r_wide > r_narrow
    assert r_wide >= 0.99
    assert r_narrow <= 0.5


def test_filtered_widening_math_and_override():
    """Mirror of ``tests/test_tiered.py::test_filtered_widening_math_and_
    override``."""
    cfg, x, meta = _meta_corpus()
    idx = build_ivf(x, cfg, meta=meta, device="cpu")
    excluded = np.ones(idx.nb, bool)
    excluded[np.isin(idx.ids, np.nonzero(np.asarray(meta["bucket"]) == 0)[0])] = False
    q = x[:4]
    probes = filtered_assign_queries(idx, q, excluded)
    assert probes.shape[1] == min(cfg.nlist, cfg.nprobe * 16)
    assert filtered_assign_queries(idx, q, excluded, nprobe=3).shape[1] == 3
    assert filtered_assign_queries(idx, q, np.zeros(idx.nb, bool)).shape[1] == cfg.nprobe


def test_request_filter_on_delta_metadata_matches_reference():
    """The filtered case of ``tests/test_request_api.py::test_mixed_option_
    batch_splits_and_matches``: rows with a tag in the delta, a filtered
    request per row equal to the filtered batch, on both packages."""
    ds = make_dataset(nb=1500, dim=16, n_components=6, spread=0.6, seed=0)
    cfg = RCfg(dim=16, nlist=8, nprobe=8, topk=5, kmeans_iters=3)
    from repro.data import make_queries

    q = make_queries(ds, nq=32, skew=0.3, noise=0.2, seed=1)
    ref = RSegmented.from_static(r_build(ds.x, cfg))
    t_plane = port_plane(ref)
    r = RServer(ref, n_nodes=2)
    t = HarmonyServer(t_plane, n_nodes=2, device="cpu")
    for srv in (r, t):
        srv.upsert(np.arange(8) + 10_000, ds.x[:8] + 3.0, meta={"color": [1, 2] * 4})
    want = r.search_batch(np.stack([q[1], q[3]]), 5, flt=RTagIn("color", (2,)))
    got = t.search_batch(np.stack([q[1], q[3]]), 5, flt=TagIn("color", (2,)))
    assert_matches_oracle(got, want)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert set(got.ids[got.ids >= 0].tolist()) <= {10_001, 10_003, 10_005, 10_007}
    for i, row in enumerate((1, 3)):
        one = t.search_batch(SearchRequest(vector=q[row], k=5, filter=TagIn("color", (2,))))
        np.testing.assert_array_equal(one.ids[0], got.ids[i])
    plain = t.search_batch(q[:1], 5)
    assert_matches_oracle(plain, r.search_batch(q[:1], 5))


def test_prewarm_samples_a_repeated_probe_once(corpus):
    """Queue 3: the reference's ``prewarm_tau`` samples a cluster again
    for each time it is probed, so a duplicate-filled filtered probe table
    counts rows twice and seeds τ below the k-th allowed distance (its spmd
    executor then prunes true members: recall 0.908 on the widening corpus
    above, the host engine 1.0). The port samples each probed cluster once:
    τ0 of a repeated table equals that of the table without repeats, and
    never lies below the k-th distance of the filtered candidate set."""
    from repro.core.pruning import prewarm_tau as r_prewarm
    from repro_torch.core import prewarm_tau

    r, t = indexes(corpus)
    q = corpus[3]
    ex = ~np.isin(t.cluster_of, (2, 5))
    probes = filtered_assign_queries(t, q, ex, nprobe=4)          # 2, 5, 2, 2 ...
    once = probes[:, :2]
    tau = prewarm_tau(t, q, probes, 5, 4, dead_rows=ex)
    np.testing.assert_array_equal(tau, prewarm_tau(t, q, once, 5, 4, dead_rows=ex))
    np.testing.assert_allclose(tau, r_prewarm(r, q, once, 5, 4, dead_rows=ex), rtol=1e-5)
    truth = search_oracle(t, q, nprobe=8, dead_rows=ex)
    assert (tau >= truth.scores[:, 4] - 1e-4).all()
    r_tau = r_prewarm(r, q, probes, 5, 4, dead_rows=ex)
    assert (r_tau <= tau + 1e-5).all() and (r_tau < tau - 1e-3).any()
