"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, at OLMoE's smoke size (8 experts, top-2,
d_model 64, d_ff 32).

``_route`` and ``moe_ffn_dense`` run against the reference in this
process (``RefJit``: fp32 at 1e-4, bf16 at ``BF16_TOL``). ``moe_ffn_ep``
over ``VirtualMesh(data=ep)`` runs against the reference's shard_map
layer on a CPU mesh of ep host devices, which one subprocess with 8 host
devices computes for every case. At the default capacity the two agree.
At capacity 0.25 the port equals a plain numpy statement of "drop the
slots past capacity", and the reference differs from it on exactly the
tokens that its duplicate-index scatters also lose: a kept slot at
position ``cap_send − 1`` of a destination that overflowed, and the kept
entry at ``buf[0, cap_e − 1]`` when an invalid entry follows it.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.models import init_params as r_init_params
from repro.models import moe as rmoe
from repro_torch._arrays import tensor_from_numpy
from repro_torch.checkpoint import Checkpointer
from repro_torch.models import VirtualMesh, init_params, params_from_reference
from repro_torch.models import moe as tmoe
from test_torch_lm import BF16_TOL, TOL32, RefJit, fp32, np32

ROOT = Path(__file__).resolve().parents[1]
ARCH = "olmoe-1b-7b"
EPS = (1, 2, 4)
B, S = 4, 8                    # B a multiple of every ep


def smoke_cfg(dtype):
    cfg = rcfgs.get_smoke_config(ARCH)
    return fp32(cfg) if dtype == "float32" else cfg


def ref_moe_params(dtype, seed=0):
    """The reference's ``init_moe`` tree for the smoke config, numpy."""
    return jax.device_get(rmoe.init_moe(smoke_cfg(dtype), jax.random.PRNGKey(seed)))


def moe_input(dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, 64)).astype(np.float32)
    return x if dtype == "float32" else np.asarray(jnp.asarray(x, jnp.bfloat16))


def port_tree(tree):
    return params_from_reference(smoke_cfg("float32"), tree, device="cpu")


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype):
    cfg = smoke_cfg(dtype)
    p = ref_moe_params(dtype)
    x = moe_input(dtype).reshape(B * S, -1)
    wg, we, waux = jax.jit(lambda a, r: rmoe._route(cfg, a, r))(x, p["router"])
    gg, ge, gaux = tmoe._route(cfg, tensor_from_numpy(x), torch.from_numpy(p["router"]))
    assert ge.dtype == torch.int32 and np.array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("router", ["zeros", "twin_columns"])
def test_route_ties_go_to_the_lower_expert(router):
    """Equal probabilities: ``jax.lax.top_k`` takes the lower expert first,
    and so does the port's stable sort."""
    cfg = smoke_cfg("float32")
    x = moe_input("float32").reshape(B * S, -1)
    r = ref_moe_params("float32")["router"].copy()
    if router == "zeros":
        r[:] = 0.0                                     # every probability equal
    else:
        r[:, 6] = r[:, 2]                              # experts 2 and 6 always tie
    _, we, _ = rmoe._route(cfg, jnp.asarray(x), jnp.asarray(r))
    _, ge, _ = tmoe._route(cfg, torch.from_numpy(x), torch.from_numpy(r))
    we, ge = np.asarray(we), ge.numpy()
    assert np.array_equal(ge, we)
    if router == "zeros":
        assert (ge == [0, 1]).all()
    else:
        both = (ge == 2).any(1) & (ge == 6).any(1)
        assert both.sum() >= 2 and (ge[both] == [2, 6]).all()
        assert not ((ge == 6).any(1) & ~both).any()      # 6 never without 2


# ---------------------------------------------------------------- the dense path
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dense_matches_reference(dtype):
    cfg = smoke_cfg(dtype)
    p = ref_moe_params(dtype)
    x = moe_input(dtype)
    want, waux = RefJit(lambda p_, x_: rmoe.moe_ffn_dense(p_, cfg, x_))(p, x)
    got, aux = tmoe.moe_ffn_dense(port_tree(p), cfg, tensor_from_numpy(x))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(np32(got), np32(want), **tol)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    # moe_ffn takes the dense path without a mesh and with one rank
    assert torch.equal(tmoe.moe_ffn(port_tree(p), cfg, tensor_from_numpy(x))[0], got)
    assert torch.equal(tmoe.moe_ffn(port_tree(p), cfg, tensor_from_numpy(x), VirtualMesh(1))[0], got)


# ---------------------------------------------------------------- the EP path
REF_EP = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro import configs
    from repro.models import moe
    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src))
    cfg = configs.get_smoke_config("olmoe-1b-7b").replace(dtype="float32",
                                                          param_dtype="float32")
    p = {k: data[k] for k in ("router", "w1", "w3", "w2")}
    out = {}
    for ep in (1, 2, 4):
        mesh = jax.make_mesh((ep, 1), ("data", "model"), devices=jax.devices()[:ep])
        for cap in (1.5, 0.25):
            fn = jax.jit(lambda p_, x_: moe.moe_ffn_ep(p_, cfg, x_, mesh, capacity_factor=cap))
            y, aux = fn(p, data["x"])
            out[f"y_{ep}_{cap}"] = np.asarray(y)
            out[f"aux_{ep}_{cap}"] = np.asarray(aux)
    np.savez(dst, **out)
""")


@pytest.fixture(scope="module")
def ref_ep(tmp_path_factory):
    """The reference's ``moe_ffn_ep`` at every (ep, capacity), fp32, from
    one subprocess with 8 host devices; with its params and input."""
    d = tmp_path_factory.mktemp("moe_ep")
    p = ref_moe_params("float32")
    x = moe_input("float32")
    np.savez(d / "in.npz", x=x, **p)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_EP, str(d / "in.npz"), str(d / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return p, x, dict(np.load(d / "out.npz"))


def plain_ep(p, x, ep, cap, like_reference=False):
    """moe_ffn_ep stated plainly in numpy (f64 expert products, the
    reference's routing): a slot counts iff it is below ``cap_send`` at
    its destination and below ``cap_e`` at its expert. ``like_reference``
    also loses what the reference's duplicate-index scatters overwrite
    (XLA's CPU applies a scatter's updates in order). Returns (y [B,S,D],
    per-token count of lost slots)."""
    cfg = smoke_cfg("float32")
    E, k = cfg.moe.num_experts, cfg.moe.experts_per_token
    e_local, D = E // ep, x.shape[-1]
    T = B // ep * S
    xr = x.reshape(ep, T, D)
    gates, experts = [], []
    for s in range(ep):
        g, e, _ = rmoe._route(cfg, jnp.asarray(xr[s]), jnp.asarray(p["router"]))
        gates.append(np.asarray(g).reshape(-1))
        experts.append(np.asarray(e).reshape(-1))
    cap_send = max(8, int(cap * T * k / ep))
    cap_e = max(8, int(cap * ep * cap_send / e_local))
    sent = [[[] for _ in range(ep)] for _ in range(ep)]   # [src][dst] → slots in order
    for s in range(ep):
        for i, e in enumerate(experts[s]):
            sent[s][e // e_local].append(i)
    counts = np.zeros((ep, T * k), bool)                  # slot counts
    for d in range(ep):
        entries = []                                       # (src, slot or None), received order
        for s in range(ep):
            kept = sent[s][d][:cap_send]
            if like_reference and len(sent[s][d]) > cap_send:
                kept = kept[:-1]                           # overwritten by a dropped slot
            entries += [(s, i) for i in kept]
            entries += [(s, None)] * (cap_send - len(kept))
        seen = np.zeros(e_local, int)
        last_buf0 = None                                   # the entry at buf[0, cap_e - 1]
        for n, (s, i) in enumerate(entries):
            valid = False
            if i is not None:
                le = experts[s][i] % e_local
                valid = seen[le] < cap_e
                if valid and le == 0 and seen[le] == cap_e - 1:
                    last_buf0 = (s, i)
                seen[le] += 1
            if valid:
                counts[s, i] = True
            elif like_reference and last_buf0 is not None:
                counts[last_buf0] = False                  # zeroed by an invalid entry
    lost = np.zeros((ep, T), int)
    y = np.zeros((ep, T, D))
    x64 = xr.astype(np.float64)
    for s in range(ep):
        for i, e in enumerate(experts[s]):
            t = i // k
            if not counts[s, i]:
                lost[s, t] += 1
                continue
            h1, h3 = x64[s, t] @ p["w1"][e], x64[s, t] @ p["w3"][e]
            h = h1 / (1 + np.exp(-h1)) * h3
            y[s, t] += gates[s][i] * (h @ p["w2"][e])
    return y.reshape(B, S, D), lost.reshape(B, S)


@pytest.mark.parametrize("ep", EPS)
def test_moe_ffn_ep_matches_reference_at_default_capacity(ref_ep, ep):
    p, x, ref = ref_ep
    cfg = smoke_cfg("float32")
    mesh = VirtualMesh(ep, drop_log=[])
    got, aux = tmoe.moe_ffn_ep(port_tree(p), cfg, torch.from_numpy(x), mesh)
    np.testing.assert_allclose(got.numpy(), ref[f"y_{ep}_1.5"], **TOL32)
    np.testing.assert_allclose(float(aux), float(ref[f"aux_{ep}_1.5"]), rtol=1e-6)
    assert len(mesh.drop_log) == 1 and int(mesh.drop_log[0].sum()) == 0
    # and equals the dense path where nothing drops
    dense, daux = tmoe.moe_ffn_dense(port_tree(p), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL32)
    if ep == 1:
        assert float(aux) == float(daux)


@pytest.mark.parametrize("ep", EPS)
def test_moe_ffn_ep_drops_only_past_capacity(ref_ep, ep):
    """Capacity 0.25: the port is the plain statement; the reference is
    the plain statement with its overwritten slots lost, and differs from
    the port on those tokens only."""
    p, x, ref = ref_ep
    cfg = smoke_cfg("float32")
    mesh = VirtualMesh(ep, drop_log=[])
    got, aux = tmoe.moe_ffn_ep(port_tree(p), cfg, torch.from_numpy(x), mesh,
                               capacity_factor=0.25)
    plain, dropped = plain_ep(p, x, ep, 0.25)
    emul, lost = plain_ep(p, x, ep, 0.25, like_reference=True)
    np.testing.assert_allclose(got.numpy(), plain, **TOL32)
    assert np.array_equal(mesh.drop_log[0].numpy(), dropped)
    assert dropped.sum() > 0
    want = ref[f"y_{ep}_0.25"]
    np.testing.assert_allclose(want, emul, **TOL32)
    np.testing.assert_allclose(float(aux), float(ref[f"aux_{ep}_0.25"]), rtol=1e-6)
    overwritten = lost > dropped
    differs = np.abs(want - got.numpy()).max(-1) > 1e-3
    assert np.array_equal(differs, overwritten), (np.argwhere(differs), np.argwhere(overwritten))
    if ep > 1:
        assert overwritten.any()


def test_moe_ffn_ep_refuses_what_one_card_cannot_split():
    cfg = smoke_cfg("float32")
    p = port_tree(ref_moe_params("float32"))
    x = torch.zeros((3, S, 64))
    with pytest.raises(ValueError, match="batch 3"):
        tmoe.moe_ffn_ep(p, cfg, x, VirtualMesh(2))
    with pytest.raises(ValueError, match="experts"):
        tmoe.moe_ffn_ep(p, cfg, torch.zeros((3, S, 64)), VirtualMesh(3))
    with pytest.raises(NotImplementedError, match="one card"):
        tmoe.moe_ffn_ep(p, cfg, torch.zeros((2, S, 64)), object())
    with pytest.raises(ValueError, match="pod"):
        tmoe.moe_ffn_ep(p, cfg, torch.zeros((2, S, 64)), VirtualMesh(2), pod_axis="pod")
    with pytest.raises(ValueError):
        VirtualMesh(0)
    assert VirtualMesh(4).shape == {"data": 4, "model": 1}
    assert VirtualMesh(2, drop_log=[]) == VirtualMesh(2)


def test_ep_op_count_does_not_grow_with_ranks():
    """The ranks are a tensor dimension: one EP call runs the same torch
    ops at ep = 2 and ep = 8."""
    cfg = smoke_cfg("float32")
    p = port_tree(ref_moe_params("float32"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, S, 64)).astype(np.float32))

    def ops(ep):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tmoe.moe_ffn_ep(p, cfg, x, VirtualMesh(ep))
        return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))

    assert ops(2) == ops(8)


# ---------------------------------------------------------------- init and carry-over
def test_init_moe_tree_and_spread():
    cfg = rcfgs.get_smoke_config(ARCH)
    want = jax.eval_shape(lambda k: rmoe.init_moe(cfg, k), jax.random.PRNGKey(0))
    got = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape
        assert str(got[key].dtype).replace("torch.", "") == str(leaf.dtype), key
    big = tmoe._expert_init(torch.Generator().manual_seed(0), (64, 32, 16), 1, torch.float32,
                            max_elems=32 * 16 * 5)        # 13 slices of 5 experts
    std = 0.8796 / np.sqrt(32)                        # a unit normal truncated to [-2, 2]
    assert abs(float(big.std()) / std - 1) < 0.05 and float(big.abs().max()) <= 2 / np.sqrt(32)
    assert not torch.equal(big[0], big[5])
    whole = tmoe._expert_init(torch.Generator().manual_seed(0), (4, 32, 16), 1, torch.float32)
    from repro_torch.models import common as cm
    assert torch.equal(whole, cm.dense_init(torch.Generator().manual_seed(0), (4, 32, 16), 1,
                                            torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_the_moe_subtree_bit_for_bit(dtype):
    cfg = rcfgs.get_smoke_config(ARCH)
    tree = jax.device_get(r_init_params(cfg, jax.random.PRNGKey(0)))
    if dtype == "float32":
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    got = params_from_reference(cfg, tree, device="cpu")
    moe = got["units"]["block"]["moe"]
    assert moe["router"].dtype == torch.float32
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert all(moe[w].dtype == want for w in ("w1", "w3", "w2"))
    for w in ("router", "w1", "w3", "w2"):
        ref = np.asarray(tree["units"]["block"]["moe"][w])
        assert np.array_equal(np32(moe[w]).view(np.uint32), np.asarray(ref, np.float32).view(
            np.uint32)), w


def test_checkpoint_carries_moe_params_across_packages(tmp_path):
    """The reference's ``Checkpointer`` writes OLMoE's smoke params, the
    port's restores them; then the port writes and the reference
    restores. Bit for bit both ways (bf16 experts, f32 router and norms)."""
    cfg = rcfgs.get_smoke_config(ARCH)
    params = r_init_params(cfg, jax.random.PRNGKey(1))
    RCheckpointer(tmp_path / "ref").save(5, {"params": params})
    like = {"params": init_params(cfg, 0, device="cpu")}
    got = Checkpointer(tmp_path / "ref").restore(like, device="cpu")["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for key, leaf in flat_w.items():
        t = flat_g[key]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), key
        assert np.array_equal(t.view(torch.int16 if t.dtype == torch.bfloat16 else t.dtype)
                              .numpy().view(np.uint8), np.asarray(leaf).view(np.uint8)), key
    mine = init_params(cfg, 7, device="cpu")
    Checkpointer(tmp_path / "port").save(3, {"params": mine})
    back = RCheckpointer(tmp_path / "port").restore({"params": params})["params"]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(back))[0])
    flat_m = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert flat_b.keys() == flat_m.keys()
    for key, t in flat_m.items():
        leaf = np.asarray(flat_b[key])
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), key
        assert np.array_equal(t.view(torch.int16 if t.dtype == torch.bfloat16 else t.dtype)
                              .numpy().view(np.uint8), leaf.view(np.uint8)), key


def test_moe_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "import repro_torch.models.moe as moe, repro_torch.configs as configs\n"
        "cfg = configs.get_smoke_config('olmoe-1b-7b')\n"
        "p = moe.init_moe(cfg, torch.Generator().manual_seed(0))\n"
        "x = torch.zeros(2, 4, cfg.d_model, dtype=torch.bfloat16)\n"
        "y, aux = moe.moe_ffn(p, cfg, x, moe.VirtualMesh(2))\n"
        "print('OK', tuple(y.shape))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK (2, 4, 64)" in proc.stdout
