"""The port's shape-only init and sharding rules against the JAX package's.

For each of the ten architectures: ``init_params(cfg, 0, device="meta")``
has the keys, shapes and dtypes of ``jax.eval_shape(init_params)``, and so
have the meta cache and optimizer states; ``param_shardings``,
``opt_shardings`` (AdamW and Adafactor), ``batch_shardings`` and
``cache_shardings`` of the applicable shapes give the reference's
``.spec`` s exactly, on the production meshes ``AbstractMesh((16, 16),
("data", "model"))`` and ``AbstractMesh((2, 16, 16), ("pod", "data",
"model"))`` against ``make_production_mesh``'s; ``per_device_bytes``
divides each leaf by the axes its spec splits.
"""

import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as rcfgs
from repro.config import applicable_shapes as r_shapes
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.sharding import rules as rrules
from repro.train import OptConfig as ROptConfig
from repro.train import init_opt_state as r_init_opt
from repro_torch import configs
from repro_torch.config import applicable_shapes
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import init_cache, init_params
from repro_torch.sharding import rules
from repro_torch.train import OptConfig, init_opt_state

ARCHS = configs.arch_names()
MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _name(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def ref_flat(tree, leaf=lambda x: x):
    """{path: leaf} of a reference tree (dict keys and tuple indices)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_name(k) for k in path): leaf(v) for path, v in flat}


def port_flat(tree, path=()):
    """{path: leaf} of a port tree of nested dicts and tuples; a spec (a
    tuple of axis names, tuples and ``None``) is a leaf."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in port_flat(sub, path + (k,)).items()}
    if isinstance(tree, tuple) and tree and not all(
            e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
                isinstance(a, str) for a in e)) for e in tree):
        return {p: v for i, sub in enumerate(tree)
                for p, v in port_flat(sub, path + (str(i),)).items()}
    return {path: tree}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    cfg = rcfgs.get_config(arch)
    return jax.eval_shape(lambda: r_init_params(cfg, jax.random.PRNGKey(0)))


def assert_same_shapes(ref_tree, port_tree):
    want = ref_flat(ref_tree, lambda s: (tuple(s.shape), str(s.dtype)))
    got = port_flat(port_tree)
    assert set(got) == set(want), set(got) ^ set(want)
    for path, t in got.items():
        assert t.device.type == "meta", path
        assert (tuple(t.shape), dtype_name(t.dtype)) == want[path], path


def assert_same_specs(ref_tree, port_tree):
    want = ref_flat(ref_tree, lambda ns: tuple(ns.spec))
    got = port_flat(port_tree)
    assert got == want, {p: (got.get(p), want.get(p)) for p in set(got) | set(want)
                         if got.get(p) != want.get(p)}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_eval_shape(arch):
    """``init_params``, ``init_cache`` and ``init_opt_state`` on ``meta``:
    the reference's keys, shapes and dtypes, with nothing drawn."""
    cfg = configs.get_config(arch)
    params = init_params(cfg, 0, device="meta")
    assert_same_shapes(ref_params(arch), params)
    rcfg = rcfgs.get_config(arch)
    for name in ("adamw", "adafactor"):
        want = jax.eval_shape(lambda: r_init_opt(ref_params(arch), ROptConfig(name=name)))
        assert_same_shapes(want, init_opt_state(params, OptConfig(name=name)))
    if rcfg.supports_decode and not rcfg.encoder_only:
        want = jax.eval_shape(lambda: r_init_cache(rcfg, 4, 64))
        assert_same_shapes(want, init_cache(cfg, 4, 64, device="meta"))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference(arch):
    """Every rule of ``repro.sharding.rules`` on both production meshes:
    the port's specs equal the reference's ``.spec`` s leaf for leaf."""
    cfg, rcfg = configs.get_config(arch), rcfgs.get_config(arch)
    params, rp = init_params(cfg, 0, device="meta"), ref_params(arch)
    opts = {name: (init_opt_state(params, OptConfig(name=name)),
                   jax.eval_shape(lambda: r_init_opt(rp, ROptConfig(name=name))))
            for name in ("adamw", "adafactor")}
    for multi, rmesh in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == dict(rmesh.shape)
        assert rules.batch_axes(mesh) == rrules.batch_axes(rmesh)
        assert_same_specs(rrules.param_shardings(rp, rcfg, rmesh),
                          rules.param_shardings(params, cfg, mesh))
        for opt, ropt in opts.values():
            assert_same_specs(rrules.opt_shardings(ropt, rp, rcfg, rmesh),
                              rules.opt_shardings(opt, params, cfg, mesh))
        for shape in applicable_shapes(cfg):
            rshape = next(s for s in r_shapes(rcfg) if s.name == shape.name)
            assert_same_specs(rrules.batch_shardings(rcfg, rshape, rmesh),
                              rules.batch_shardings(cfg, shape, mesh))
            if shape.kind == "decode":
                B, S = shape.global_batch, shape.seq_len
                rc = jax.eval_shape(lambda: r_init_cache(rcfg, B, S))
                assert_same_specs(rrules.cache_shardings(rcfg, rc, rshape, rmesh),
                                  rules.cache_shardings(cfg, init_cache(cfg, B, S, device="meta"),
                                                        shape, mesh))


def test_per_device_bytes():
    """Each leaf's bytes over the product of the axes its spec splits;
    hubert's vocab of 504 is not split by 16 (``_sanitize``)."""
    mesh = make_production_mesh(multi_pod=True)
    tree = {"a": torch.empty((32, 64), dtype=torch.bfloat16, device="meta"),
            "s": (torch.empty((4, 8), device="meta"), torch.empty((3,), device="meta"))}
    specs = {"a": (("pod", "data"), "model"), "s": (("data", None), (None,))}
    assert rules.per_device_bytes(tree, specs, mesh) == 32 * 64 * 2 // 512 + 4 * 8 * 4 // 16 + 12
    cfg = configs.get_config("hubert-xlarge")
    params = init_params(cfg, 0, device="meta")
    sp = rules.param_shardings(params, cfg, make_production_mesh())
    assert cfg.vocab_size == 504 and sp["lm_head"][1] is None
    total = sum(t.numel() * t.element_size() for t in port_flat(params).values())
    per = rules.per_device_bytes(params, sp, make_production_mesh())
    assert total / 256 < per < total
    assert make_local_mesh(2, 2) == make_local_mesh(2, 2, pod=1)
    assert make_local_mesh(2, 2, pod=2).shape == {"pod": 2, "data": 2, "model": 2}
