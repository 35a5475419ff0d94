"""The ring's pod axis against the JAX package on the CPU:
``make_spmd_search`` over ``VirtualMesh(data=2, model=2, pod=2)`` against
the reference's ``n_pods=2`` step on a (2, 2, 2) host mesh, fp32 and int8.

The corpus is split into two super-shards of two vector shards each: one
plan of four shards, pod p owning shards 2p and 2p + 1. The reference has
no builder for pod-stacked operands, so its flat four-shard arrays are
regrouped on a leading [2] axis here, as ``build_pod_inputs`` regroups the
port's. The reference's step runs in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (its jnp route);
the port's through the plain versions its kernels dispatch to on the CPU.
Ids must match except across exact ties, scores at rtol = atol = 1e-3,
the stats exactly; fp32 also equals ``search_oracle`` over both
super-shards' rows, int8 after the fp32 re-rank of
``test_torch_spmd_search``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.config import HarmonyConfig as RCfg
from repro.core import PartitionPlan as RPlan
from repro.core import build_ivf as r_build
from repro.core import preassign as r_preassign
from repro.core import search_oracle as r_oracle
from repro.core import pipeline as rpipe
from repro.data import make_dataset, make_queries
from repro_torch.core import PartitionPlan, assign_queries, preassign, prewarm_tau
from repro_torch.core import pipeline as tpipe
from repro_torch.core.router import load_aware_assignment, ring_offsets
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe
from repro_torch.virtual_mesh import VirtualMesh
from test_torch_spmd_search import assert_exact, carried, rerank

ROOT = Path(__file__).resolve().parents[1]
P, V, B, CHUNK, QB = 2, 2, 2, 128, 32

REF_POD = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.core import pipeline as rpipe
    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src, allow_pickle=True))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for tier in ("fp32", "int8"):
        kw = data[f"{tier}_scfg"].item()
        step = rpipe.make_spmd_search(rpipe.SpmdConfig(**kw), mesh)
        names = ["x_blocks", "xn2_blocks", "cluster_ids", "row_ids"]
        names += ["scale2"] if tier == "int8" else []
        names += ["queries", "probes", "tau0"]
        s, i, st = step(*[data[f"{tier}_{n}"] for n in names])
        out[f"{tier}_scores"] = np.asarray(s)
        out[f"{tier}_ids"] = np.asarray(i)
        out[f"{tier}_stats"] = np.asarray(st)
    np.savez(dst, **out)
""")


def regroup(arrays):
    """The reference's flat (P·V)-shard corpus operands on a leading [P]
    axis, as ``input_specs`` of an ``n_pods=P`` config lists them."""
    out = dict(arrays)
    out["x_blocks"] = arrays["x_blocks"].reshape(P, V, *arrays["x_blocks"].shape[1:])
    xn2 = arrays["xn2_blocks"]
    out["xn2_blocks"] = np.ascontiguousarray(
        xn2.reshape(xn2.shape[0], P, V, -1).transpose(1, 0, 2, 3))
    for name in ("cluster_ids", "row_ids"):
        out[name] = arrays[name].reshape(P, V, -1)
    return out


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Data, index and queries; for each tier the port's operands and step
    output, the reference's regrouped operands, and the reference's step
    output from one subprocess with 8 host devices."""
    ds = make_dataset(nb=3000, dim=32, n_components=12, spread=0.6, seed=0)
    cfg = RCfg(dim=32, nlist=16, nprobe=5, topk=5, kmeans_iters=5)
    ref = r_build(ds.x, cfg)
    idx = carried(ref, cfg)
    q = make_queries(ds, nq=QB, skew=0.2, noise=0.2, seed=1)
    cts = load_aware_assignment(idx.sizes, None, P * V)
    corpus = preassign(idx, PartitionPlan(v_shards=P * V, d_blocks=B, cluster_to_shard=cts,
                                          ring_offsets=ring_offsets(P * V, B)))
    rcorpus = r_preassign(ref, RPlan(v_shards=P * V, d_blocks=B, cluster_to_shard=cts,
                                     ring_offsets=ring_offsets(P * V, B)))
    probes = assign_queries(idx, q)
    cap = -(-corpus.cap // CHUNK) * CHUNK
    d = tmp_path_factory.mktemp("pod")
    saved, out = {}, {}
    for tier in ("fp32", "int8"):
        int8 = tier == "int8"
        kw = dict(v_shards=V, d_blocks=B, n_pods=P, qb=QB, cap=cap, dim=cfg.dim,
                  nprobe=cfg.nprobe, k=cfg.topk * cfg.rerank_factor if int8 else cfg.topk,
                  chunk=CHUNK, precision=tier, tile_m=64, tile_n=64, tile_k=32)
        tau0 = (np.full((QB,), np.inf, np.float32) if int8
                else prewarm_tau(idx, q, probes, cfg.topk, cfg.prewarm_samples))
        scfg = tpipe.SpmdConfig(**kw)
        arrays = tpipe.build_pod_inputs(idx, corpus, q, scfg, probes, tau0)
        rflat = rpipe.build_spmd_inputs(
            ref, rcorpus, q, rpipe.SpmdConfig(**dict(kw, v_shards=P * V, n_pods=1),
                                              use_pallas=False), probes, tau0)
        rarrays = regroup({k: np.asarray(v) for k, v in rflat.items()})
        saved[f"{tier}_scfg"] = np.array(dict(kw, use_pallas=False), dtype=object)
        saved.update({f"{tier}_{k}": v for k, v in rarrays.items()})
        ops.reset_launch_counts()
        step = tpipe.make_spmd_search(scfg, VirtualMesh(V, model=B, pod=P))
        names = list(tpipe.CORPUS_OPERANDS) + (["scale2"] if int8 else []) + [
            "queries", "probes", "tau0"]
        s, i, st = step(*[arrays[n] for n in names])
        out[tier] = dict(arrays=arrays, rarrays=rarrays, scores=s.numpy(), ids=i.numpy(),
                         stats=st.numpy(), counts=ops.launch_counts(), scfg=scfg)
    np.savez(d / "in.npz", **saved)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_POD, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = dict(np.load(d / "out.npz"))
    for tier in out:
        out[tier].update(want_scores=want[f"{tier}_scores"], want_ids=want[f"{tier}_ids"],
                         want_stats=want[f"{tier}_stats"])
    return idx, q, r_oracle(ref, q), out


def assert_ids_but_ties(scores, ids, want_s, want_i):
    np.testing.assert_allclose(scores, want_s, rtol=1e-3, atol=1e-3)
    for r in np.nonzero((ids != want_i).any(axis=1))[0]:
        for j in np.nonzero(ids[r] != want_i[r])[0]:
            ties = np.nonzero(want_s[r] == scores[r, j])[0]
            assert len(ties) > 1 or set(ids[r]) == set(want_i[r]), (r, ids[r], want_i[r])


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_pod_operands_match_reference(pods, tier):
    """``build_pod_inputs``: the reference's four-shard operands regrouped
    on the pod axis, byte for byte (the norms at 1e-6), in the shapes of
    ``input_specs``."""
    _, _, _, out = pods
    got, want = out[tier]["arrays"], out[tier]["rarrays"]
    specs = tpipe.input_specs(out[tier]["scfg"])
    assert got.keys() == want.keys() == specs.keys()
    for name, spec in specs.items():
        assert got[name].shape == spec.shape and got[name].dtype == spec.dtype, name
        if name == "xn2_blocks":
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6)
        else:
            assert got[name].numpy().tobytes() == np.ascontiguousarray(want[name]).tobytes(), name
    assert specs["x_blocks"].shape[0] == P and specs["queries"].shape == (QB, 32)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_pod_step_matches_reference(pods, tier):
    """The port's pod step against the reference's ``n_pods=2`` shard_map
    step: scores at 1e-3, ids but across exact ties, stats equal; the
    tier's distance and the top-K plain versions ran."""
    idx, q, oracle, out = pods
    o = out[tier]
    assert_ids_but_ties(o["scores"], o["ids"], o["want_scores"], o["want_ids"])
    np.testing.assert_array_equal(o["stats"], o["want_stats"])
    assert 0 <= o["stats"][0] <= o["stats"][1] and o["stats"][1] > 0
    dist = "int8_partial_distance_update_ref" if tier == "int8" else "partial_distance_update_ref"
    assert o["counts"][dist] > 0 and o["counts"]["running_topk_ref"] > 0, o["counts"]
    scores, ids = o["scores"], o["ids"]
    if tier == "int8":
        scores, ids = rerank(idx, q, scores, ids, oracle.scores.shape[1])
    assert_exact(scores, ids, oracle)


def test_pod_mesh_and_the_layers_that_refuse_it(pods):
    """``VirtualMesh(pod=)`` lists pod first, as a ``("pod", "data",
    "model")`` mesh does; the step takes only its config's mesh; the MoE
    layer's EP refuses a pod axis."""
    _, _, _, out = pods
    assert VirtualMesh(2, model=2, pod=2).shape == {"pod": 2, "data": 2, "model": 2}
    assert list(VirtualMesh(2, model=2, pod=2).shape) == ["pod", "data", "model"]
    assert VirtualMesh(2, model=2, pod=1).shape == {"data": 2, "model": 2}
    scfg = out["fp32"]["scfg"]
    with pytest.raises(ValueError, match="mesh"):
        tpipe.make_spmd_search(scfg, VirtualMesh(V, model=B))
    with pytest.raises(ValueError):
        VirtualMesh(2, pod=0)
    with pytest.raises(ValueError, match="n_pods"):
        tpipe.SpmdConfig(v_shards=2, d_blocks=2, n_pods=0)
    with pytest.raises(ValueError, match="pods need"):
        tpipe.build_pod_inputs(None, _corpus_of(V), None, scfg, None, None)
    from repro_torch import configs

    cfg = configs.get_smoke_config("olmoe-1b-7b").replace(dtype="float32",
                                                           param_dtype="float32")
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="pod=2"):
        tmoe.moe_ffn_ep(p, cfg, torch.zeros((2, 4, cfg.d_model)), VirtualMesh(2, pod=2))


def _corpus_of(v_shards):
    """A stand-in corpus with ``v_shards`` shards (only its plan is read)."""
    return type("Corpus", (), {"plan": type("Plan", (), {"v_shards": v_shards})()})()
