"""The PyTorch port's foundations against the JAX package: import
isolation, device resolution, the numpy generators, the config and the
host-side routing helpers."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.config
import repro.core.index as r_index
import repro.core.router as r_router
import repro.data.vectors as r_vectors
import repro_torch.config
import repro_torch.core.index as t_index
import repro_torch.core.router as t_router
import repro_torch.data.vectors as t_vectors
from repro_torch._device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
# the serving plane's modules, which both scans must reach
SERVING_PLANE = {f"repro_torch.serve.{m}" for m in
                 ("clock", "scheduler", "cache", "fleet", "frontend")} | {
    "repro_torch.runtime.straggler", "repro_torch.launch.serve"}


def _submodules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_imports_without_jax_or_repro():
    """Every module of the port imports with ``jax``, ``ml_dtypes`` and the
    JAX package blocked from ``sys.modules``."""
    mods = list(_submodules())
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('IMPORTED', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED" in proc.stdout
    assert len(mods) >= 73, mods
    # the served entry point's modules and the serving plane's are among them
    assert {"repro_torch.runtime", "repro_torch.runtime.elastic",
            "repro_torch.serve.engine", "repro_torch.core.planner",
            "repro_torch.core.cost_model"} <= set(mods)
    assert SERVING_PLANE <= set(mods), SERVING_PLANE - set(mods)
    assert {"repro_torch.models.recurrent", "repro_torch.virtual_mesh"} <= set(mods)
    # the analysis layer (the dry run, its roofline and collective
    # accounting, the meshes and the sharding rules)
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.hlo", "repro_torch.launch.mesh",
            "repro_torch.launch.roofline", "repro_torch.sharding",
            "repro_torch.sharding.rules"} <= set(mods)


def test_source_scan_no_jax_or_reference_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)(\.|\s|$)",
                     re.MULTILINE)
    offenders, scanned = [], set()
    for path in PKG.rglob("*.py"):
        scanned.add(".".join(path.relative_to(PKG.parent).with_suffix("").parts))
        for m in pat.finditer(path.read_text()):
            offenders.append((str(path.relative_to(ROOT)), m.group(0).strip()))
    assert not offenders, offenders
    assert SERVING_PLANE <= scanned, SERVING_PLANE - scanned


def test_device_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA; with CUDA absent it raises, it never
    drops to the CPU on its own."""
    from repro_torch.config import HarmonyConfig
    from repro_torch.core.index import build_ivf
    from repro_torch.data import brute_force_topk
    from repro_torch.serve import SpmdExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3, kmeans_iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_ivf(x, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        brute_force_topk(x, x[:2], 3)
    index = build_ivf(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpmdExecutor(index)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unsupported_options_raise():
    from repro_torch.config import HarmonyConfig
    from repro_torch.core.index import build_ivf
    from repro_torch.serve import ExecutorConfig, SpmdExecutor

    x = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    cfg = HarmonyConfig(dim=8, nlist=4, nprobe=2, topk=3, kmeans_iters=2)
    index = build_ivf(x, cfg, device="cpu")
    for kw in (dict(x_dtype="float16"), dict(use_pallas=False)):
        with pytest.raises(NotImplementedError):
            SpmdExecutor(index, ExecutorConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="tier"):
        SpmdExecutor(index, tier="warm", device="cpu")
    # bf16 rows and the host tier are served, as the reference serves them
    # (their parity: test_torch_bf16.py, test_torch_tiered.py)
    want = SpmdExecutor(index, device="cpu").search_batch(x[:4])
    for kw in (dict(cfg=ExecutorConfig(x_dtype="bfloat16")), dict(tier="host")):
        got = SpmdExecutor(index, device="cpu", **kw).search_batch(x[:4])
        np.testing.assert_array_equal(got.ids[:, 0], np.arange(4))
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-2, atol=1e-2)
    # the int8 tier is L2-only, as the reference asserts
    ip_index = build_ivf(x, cfg.replace(metric="ip"), device="cpu")
    with pytest.raises(ValueError, match="L2"):
        SpmdExecutor(ip_index, ExecutorConfig(precision="int8"), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(nb=500, dim=16, n_components=8, spread=0.6, seed=0),
    dict(nb=777, dim=24, n_components=5, spread=0.25, seed=3,
         component_weights=np.array([5, 1, 1, 1, 2], float)),
])
def test_generators_byte_identical(kw):
    rd, td = r_vectors.make_dataset(**kw), t_vectors.make_dataset(**kw)
    for name in ("x", "centers", "labels"):
        a, b = getattr(rd, name), getattr(td, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for qkw in (dict(nq=40, skew=0.3, noise=0.2, seed=1),
                dict(nq=17, skew=0.0, seed=5, tail_fraction=0.2)):
        rq, tq = r_vectors.make_queries(rd, **qkw), t_vectors.make_queries(td, **qkw)
        assert rq.dtype == tq.dtype and rq.tobytes() == tq.tobytes()


def test_recall_at_k_parity():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, size=(9, 5))
    b = rng.integers(0, 50, size=(9, 5))
    assert t_vectors.recall_at_k(a, b) == r_vectors.recall_at_k(a, b)


def test_harmony_config_field_parity():
    rf = [(f.name, f.default) for f in dataclasses.fields(repro.config.HarmonyConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(repro_torch.config.HarmonyConfig)]
    assert rf == tf
    c = repro_torch.config.HarmonyConfig().replace(nlist=7)
    assert c.nlist == 7


@pytest.mark.parametrize("v_shards", [1, 3, 4])
def test_router_parity(v_shards):
    rng = np.random.default_rng(v_shards)
    sizes = rng.integers(0, 300, size=37)
    hits = rng.integers(0, 9, size=37).astype(float)
    for h in (None, hits):
        np.testing.assert_array_equal(
            t_router.load_aware_assignment(sizes, h, v_shards),
            r_router.load_aware_assignment(sizes, h, v_shards))
    for b in (1, 2, 4):
        for stagger in (True, False):
            np.testing.assert_array_equal(
                t_router.ring_offsets(v_shards, b, stagger),
                r_router.ring_offsets(v_shards, b, stagger))


@pytest.mark.parametrize("dim,blocks", [(32, 1), (32, 2), (130, 4), (7, 3), (128, 8)])
def test_dim_block_bounds_parity(dim, blocks):
    assert t_index.dim_block_bounds(dim, blocks) == r_index.dim_block_bounds(dim, blocks)
