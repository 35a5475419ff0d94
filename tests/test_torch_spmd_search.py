"""The ANN half's last public names against the JAX package on the CPU: the
whole-mesh search step (``build_spmd_inputs``, ``input_specs``,
``make_device_fn``, ``make_spmd_search``) over ``VirtualMesh(data=V,
model=B)``, ``kernels.masked_topk`` and the package's kernel exports, and
``core.kmeans.kmeans_fit_np``.

The step mirrors ``tests/test_pipeline_spmd.py::test_single_device_mesh_in_process``
and ``examples/distributed_search.py``'s exactness check (fp32 directly;
int8 after the example's stage 1 at K' = k · rerank_factor from τ0 = +inf
and its fp32 re-rank) on the reference's own index, carried across with
``ivf_from_arrays``: scores at rtol = atol = 1e-3 against the reference's
``search_oracle``, ids except across exact ties. The example places its
arrays with ``input_shardings``, which the port does not have (one card):
``build_spmd_inputs`` gives them on the corpus's device.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import PartitionPlan as RPlan
from repro.core import build_ivf as r_build
from repro.core import preassign as r_preassign
from repro.core import prewarm_tau as r_prewarm
from repro.core import search_oracle as r_oracle
from repro.core import kmeans as rkmeans
from repro.core import pipeline as rpipe
from repro.data import make_dataset, make_queries
from repro import kernels as rkernels
from repro_torch import kernels as tkernels
from repro_torch.core import PartitionPlan, assign_queries, ivf_from_arrays, preassign, prewarm_tau
from repro_torch.core import kmeans as tkmeans
from repro_torch.core import pipeline as tpipe
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.virtual_mesh import VirtualMesh

CHUNK = 256


def carried(ref, cfg):
    """The reference's index as the port's, on the CPU."""
    return ivf_from_arrays(
        dataclasses.asdict(cfg),
        dict(centers=ref.centers, x=ref.x, ids=ref.ids, cluster_of=ref.cluster_of,
             offsets=ref.offsets),
        device="cpu")


@pytest.fixture(scope="module")
def example():
    """``examples/distributed_search.py``'s data, index and queries."""
    ds = make_dataset(nb=4000, dim=64, n_components=16, spread=0.6, seed=0)
    cfg = RCfg(dim=64, nlist=32, nprobe=6, topk=5, kmeans_iters=6)
    ref = r_build(ds.x, cfg)
    q = make_queries(ds, nq=32, skew=0.2, noise=0.2, seed=1)
    return cfg, ref, carried(ref, cfg), q, r_oracle(ref, q)


def spmd_step(idx, q, cfg, V, B, int8, tile=(64, 64, 32)):
    """The example's stage 1 through the port: its plan, ``SpmdConfig``,
    τ0 and ``build_spmd_inputs``, then ``make_spmd_search`` over the
    virtual mesh. Returns (scores, ids, stats) as numpy, the qb padding
    dropped."""
    plan = PartitionPlan(v_shards=V, d_blocks=B,
                         cluster_to_shard=load_aware_assignment(idx.sizes, None, V),
                         ring_offsets=ring_offsets(V, B))
    corpus = preassign(idx, plan)
    cap = -(-corpus.cap // CHUNK) * CHUNK
    kp = cfg.topk * cfg.rerank_factor if int8 else cfg.topk
    scfg = tpipe.SpmdConfig(v_shards=V, d_blocks=B, qb=32, cap=cap, dim=cfg.dim,
                            nprobe=cfg.nprobe, k=kp, chunk=CHUNK,
                            precision="int8" if int8 else "fp32",
                            tile_m=tile[0], tile_n=tile[1], tile_k=tile[2])
    probes = assign_queries(idx, q)
    tau0 = (np.full((q.shape[0],), np.inf, np.float32) if int8
            else prewarm_tau(idx, q, probes, cfg.topk, cfg.prewarm_samples))
    arrays = tpipe.build_spmd_inputs(idx, corpus, q, scfg, probes, tau0)
    specs = tpipe.input_specs(scfg)
    assert arrays.keys() == specs.keys()
    for name, spec in specs.items():
        assert arrays[name].shape == spec.shape and arrays[name].dtype == spec.dtype, name
    step = tpipe.make_spmd_search(scfg, VirtualMesh(V, model=B))
    operands = [arrays["x_blocks"], arrays["xn2_blocks"], arrays["cluster_ids"],
                arrays["row_ids"]]
    if int8:
        operands.append(arrays["scale2"])
    scores, ids, stats = step(*operands, arrays["queries"], arrays["probes"], arrays["tau0"])
    n = q.shape[0]
    return scores[:n].numpy(), ids[:n].numpy(), stats.numpy()


def rerank(idx, q, scores, ids, k):
    """The example's stage 2: an exact fp32 re-rank of the K' survivors."""
    x, xnorm2 = idx.x.numpy(), idx.xnorm2.numpy()
    order = np.argsort(idx.ids, kind="stable")
    sids = idx.ids[order]
    valid = np.isfinite(scores) & (ids >= 0)
    rows = order[np.searchsorted(sids, np.where(valid, ids, sids[0]))]
    d = (np.sum(q * q, axis=1)[:, None] - 2.0 * np.einsum("md,mkd->mk", q, x[rows])
         + xnorm2[rows]).astype(np.float32)
    d = np.where(valid, d, np.inf)
    sel = np.argpartition(d, kth=k - 1, axis=1)[:, :k]
    sc = np.take_along_axis(d, sel, axis=1)
    o = np.argsort(sc, axis=1, kind="stable")
    sel = np.take_along_axis(sel, o, axis=1)
    scores = np.take_along_axis(sc, o, axis=1)
    ids = np.take_along_axis(ids, sel, axis=1)
    ids[~np.isfinite(scores)] = -1
    return scores, ids


def assert_exact(scores, ids, oracle):
    """The example's rule: finite scores at 1e-3, ids except across ties."""
    finite = np.isfinite(oracle.scores)
    np.testing.assert_allclose(scores[finite], oracle.scores[finite], rtol=1e-3, atol=1e-3)
    for r in np.nonzero((ids.astype(np.int64) != oracle.ids).any(axis=1))[0]:
        assert set(ids[r].tolist()) == set(oracle.ids[r].tolist()) or np.allclose(
            np.sort(scores[r]), np.sort(oracle.scores[r]), rtol=1e-3, atol=1e-3), (
            r, ids[r], oracle.ids[r])


# ---------------------------------------------------------------- the step
def test_single_device_mesh_in_process():
    """``test_pipeline_spmd.py``'s 1 × 1 case: the port's step against the
    reference's (its jnp route in-process) and its oracle."""
    ds = make_dataset(nb=1000, dim=32, n_components=8, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=16, nprobe=4, topk=5, kmeans_iters=4)
    ref = r_build(ds.x, cfg)
    idx = carried(ref, cfg)
    q = make_queries(ds, nq=16, seed=1)
    rcorpus = r_preassign(ref, RPlan(v_shards=1, d_blocks=1,
                                     cluster_to_shard=np.zeros(16, np.int32)))
    corpus = preassign(idx, PartitionPlan(v_shards=1, d_blocks=1,
                                          cluster_to_shard=np.zeros(16, np.int32)))
    cap = -(-corpus.cap // 128) * 128
    kw = dict(v_shards=1, d_blocks=1, qb=16, cap=cap, dim=32, nprobe=4, k=5, chunk=128)
    probes = assign_queries(idx, q)
    tau0 = prewarm_tau(idx, q, probes, 5)
    np.testing.assert_allclose(tau0, r_prewarm(ref, q, probes, 5), rtol=1e-6)
    rscfg = rpipe.SpmdConfig(**kw, use_pallas=False)
    rarrays = rpipe.build_spmd_inputs(ref, rcorpus, q, rscfg, probes, tau0)
    want = rpipe.make_spmd_search(rscfg, jax.make_mesh((1, 1), ("data", "model")))(
        rarrays["x_blocks"], rarrays["xn2_blocks"], rarrays["cluster_ids"],
        rarrays["row_ids"], rarrays["queries"], rarrays["probes"], rarrays["tau0"])
    scfg = tpipe.SpmdConfig(**kw)
    arrays = tpipe.build_spmd_inputs(idx, corpus, q, scfg, probes, tau0)
    for name, a in arrays.items():
        if name == "xn2_blocks":            # the corpus's norms, summed apart
            np.testing.assert_allclose(a.numpy(), rarrays[name], rtol=1e-6)
        else:
            assert np.asarray(rarrays[name]).tobytes() == a.numpy().tobytes(), name
    scores, ids, stats = tpipe.make_spmd_search(scfg, VirtualMesh(1, model=1))(
        arrays["x_blocks"], arrays["xn2_blocks"], arrays["cluster_ids"],
        arrays["row_ids"], arrays["queries"], arrays["probes"], arrays["tau0"])
    oracle = r_oracle(ref, q)
    finite = np.isfinite(oracle.scores)
    np.testing.assert_allclose(scores.numpy()[finite], oracle.scores[finite],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[1]))
    assert stats.dtype == torch.int64 and stats.shape == (2,)
    assert int(stats[1]) == int(want[2][1]) and int(stats[0]) == int(want[2][0])


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("V,B", [(1, 1), (1, 2), (2, 2), (4, 2)])
def test_distributed_search_matches_oracle(example, V, B, int8):
    """``examples/distributed_search.py``'s exactness check on the virtual
    mesh (its 4 × 2 mesh among them), through the plain versions the
    step's kernels dispatch to on the CPU."""
    cfg, _, idx, q, oracle = example
    ops.reset_launch_counts()
    scores, ids, stats = spmd_step(idx, q, cfg, V, B, int8)
    counts = ops.launch_counts()
    dist = "int8_partial_distance_update_ref" if int8 else "partial_distance_update_ref"
    assert counts[dist] > 0 and counts["running_topk_ref"] > 0, counts
    if int8:
        assert scores.shape == (q.shape[0], cfg.topk * cfg.rerank_factor)
        scores, ids = rerank(idx, q, scores, ids, cfg.topk)
    assert scores.shape == oracle.scores.shape and ids.dtype == np.int32
    assert_exact(scores, ids, oracle)
    assert 0 <= stats[0] <= stats[1] and stats[1] > 0


@pytest.mark.parametrize("precision,x_dtype", [("fp32", "float32"), ("fp32", "bfloat16"),
                                               ("int8", "float32")])
def test_input_specs_match_reference(precision, x_dtype):
    kw = dict(v_shards=4, d_blocks=2, qb=32, cap=512, dim=64, nprobe=6, k=5, chunk=256,
              precision=precision, x_dtype=x_dtype)
    want = rpipe.input_specs(rpipe.SpmdConfig(**kw))
    got = tpipe.input_specs(tpipe.SpmdConfig(**kw))
    assert got.keys() == want.keys()
    for name, spec in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype).replace("torch.", "") == str(spec.dtype), name


def test_build_spmd_inputs_matches_reference_int8(example):
    """The int8 operands (codes, pre-scaled norms, s², encoded queries)
    byte for byte, on the grid of ``index.int8_quant(B)``."""
    cfg, ref, idx, q, _ = example
    V, B = 2, 2
    cts = load_aware_assignment(idx.sizes, None, V)
    corpus = preassign(idx, PartitionPlan(v_shards=V, d_blocks=B, cluster_to_shard=cts,
                                          ring_offsets=ring_offsets(V, B)))
    rcorpus = r_preassign(ref, RPlan(v_shards=V, d_blocks=B, cluster_to_shard=cts,
                                     ring_offsets=ring_offsets(V, B)))
    kw = dict(v_shards=V, d_blocks=B, qb=32, cap=-(-corpus.cap // CHUNK) * CHUNK,
              dim=64, nprobe=6, k=40, chunk=CHUNK, precision="int8")
    probes = assign_queries(idx, q)
    tau0 = np.full((q.shape[0],), np.inf, np.float32)
    want = rpipe.build_spmd_inputs(ref, rcorpus, q, rpipe.SpmdConfig(**kw), probes, tau0)
    got = tpipe.build_spmd_inputs(idx, corpus, q, tpipe.SpmdConfig(**kw), probes, tau0)
    assert got.keys() == want.keys()
    for name in want:
        if name == "xn2_blocks":
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6)
        else:
            assert got[name].numpy().tobytes() == np.asarray(want[name]).tobytes(), name


def test_make_spmd_search_refuses_what_the_port_does_not_carry(example):
    cfg, _, idx, q, _ = example
    scfg = tpipe.SpmdConfig(v_shards=2, d_blocks=2, qb=32, cap=1024, dim=64, chunk=256)
    with pytest.raises(ValueError, match="mesh"):
        tpipe.make_spmd_search(scfg, VirtualMesh(2))               # model = 1
    with pytest.raises(ValueError, match="mesh"):
        tpipe.make_spmd_search(scfg, VirtualMesh(4, model=2))
    with pytest.raises(NotImplementedError, match="one card"):
        tpipe.make_spmd_search(scfg, jax.make_mesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match="mesh"):                 # the config has no pods
        tpipe.make_spmd_search(scfg, VirtualMesh(2, model=2, pod=2))
    step = tpipe.make_spmd_search(scfg, VirtualMesh(2, model=2))
    specs = tpipe.input_specs(scfg)
    zeros = [torch.zeros(s.shape, dtype=s.dtype) for s in specs.values()]
    with pytest.raises(TypeError, match="7 operands"):
        step(*zeros[:6])
    zeros[0] = torch.zeros((2, 512, 64))                            # cap 512, not 1024
    with pytest.raises(ValueError, match="x_blocks"):
        step(*zeros)
    with pytest.raises(ValueError):
        VirtualMesh(2, model=0)


def test_virtual_mesh_model_axis_refused_by_moe_ep():
    """The ring takes ``model`` > 1; the MoE layer's EP does not."""
    assert tmoe.VirtualMesh is VirtualMesh
    assert VirtualMesh(4, model=2).shape == {"data": 4, "model": 2}
    assert VirtualMesh(4) == VirtualMesh(4, drop_log=[])
    from repro_torch import configs

    cfg = configs.get_smoke_config("olmoe-1b-7b").replace(dtype="float32",
                                                           param_dtype="float32")
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.zeros((2, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="model=2"):
        tmoe.moe_ffn_ep(p, cfg, x, VirtualMesh(2, model=2))
    with pytest.raises(NotImplementedError, match="model=2"):
        tmoe.moe_ffn(p, cfg, x, VirtualMesh(2, model=2))
    assert tmoe.moe_ffn_ep(p, cfg, x, VirtualMesh(2))[0].shape == x.shape


# ---------------------------------------------------------------- kernels, k-means
def test_masked_topk_matches_reference():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 6, size=(9, 40)).astype(np.float32)     # many ties
    scores[rng.random(scores.shape) < 0.3] = np.inf
    scores[0] = np.inf                                               # a row with nothing
    ids = rng.integers(0, 10_000, size=scores.shape).astype(np.int32)
    for k in (1, 5, 40):
        ws, wi = rkernels.masked_topk(jnp.asarray(scores), jnp.asarray(ids), k)
        gs, gi = tkernels.masked_topk(torch.from_numpy(scores), torch.from_numpy(ids), k)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert (gi[0] == -1).all()


def test_kernel_exports_have_the_reference_signatures():
    """``repro_torch.kernels`` exports the reference's three names; each
    takes the reference's parameters but ``use_pallas`` / ``interpret``,
    which pick Pallas or its interpreter (the port's route follows the
    tensors' device)."""
    assert tkernels.__all__ == rkernels.__all__
    route = {"use_pallas", "interpret"}
    for name in rkernels.__all__:
        want = inspect.signature(getattr(rkernels, name)).parameters
        got = inspect.signature(getattr(tkernels, name)).parameters
        assert list(got) == [p for p in want if p not in route], name
        for p in got:
            assert got[p].kind == want[p].kind and got[p].default == want[p].default, (name, p)
    assert tkernels.partial_distance_update is ops.partial_distance_update
    assert tkernels.running_topk_update is ops.running_topk_update
    for name in ("build_spmd_inputs", "input_specs", "make_device_fn", "make_spmd_search"):
        want = inspect.signature(getattr(rpipe, name)).parameters
        assert list(inspect.signature(getattr(tpipe, name)).parameters) == list(want), name
    want = list(inspect.signature(rkmeans.kmeans_fit_np).parameters)
    assert list(inspect.signature(tkmeans.kmeans_fit_np).parameters) == want + ["device"]


def test_kmeans_fit_np_against_reference():
    """The port's k-means from numpy (its own numpy seeding, so not the
    reference's centers) against the reference's on the same rows at the
    quickstart's settings shrunk to test size: numpy out with the
    reference's dtypes, each row at its nearest center, an inertia within
    5 % of the reference's, seeded."""
    ds = make_dataset(nb=4000, dim=32, n_components=16, spread=0.6, seed=0)
    want_c, want_a = rkmeans.kmeans_fit_np(ds.x, 32)
    got_c, got_a = tkmeans.kmeans_fit_np(ds.x, 32, device="cpu")
    assert isinstance(got_c, np.ndarray) and isinstance(got_a, np.ndarray)
    assert (got_c.dtype, got_a.dtype) == (want_c.dtype, want_a.dtype)
    assert got_c.shape == want_c.shape and got_a.shape == want_a.shape

    def inertia(c, a):
        d = ((ds.x[:, None, :] - c[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(a, d.argmin(1))
        return float(d.min(1).sum())

    assert inertia(got_c, got_a) <= 1.05 * inertia(want_c, want_a)
    again_c, _ = tkmeans.kmeans_fit_np(ds.x, 32, device="cpu")
    np.testing.assert_array_equal(again_c, got_c)
    other_c, _ = tkmeans.kmeans_fit_np(ds.x, 32, seed=1, device="cpu")
    assert not np.array_equal(other_c, got_c)


def test_kmeans_fit_np_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkmeans.kmeans_fit_np(np.zeros((8, 2), np.float32), 2)
