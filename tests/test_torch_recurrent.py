"""The port's recurrent mixers (``models/recurrent.py``: mLSTM, sLSTM,
Mamba2) against ``repro.models.recurrent`` on the CPU.

Each mixer runs on the reference's own smoke params (the first block of
``init_params``' tree, carried across) and the same seeded input, S = 13
with ``chunk=4`` (four chunks, the last padded), from a zero state and
from a seeded nonzero one; the reference runs under ``RefJit``. Outputs
and states at rtol = atol = 1e-4 in fp32 and at ``BF16_TOL`` in the
smoke configs' bf16 (the states stay f32, Mamba2's conv state in the
model's dtype). A chunk of 128 steps whose decays overflow above the
diagonal stays finite and equal to the reference.
"""

import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.models import recurrent as rrec
from repro_torch._arrays import tensor_from_numpy
from repro_torch.models import init_params
from repro_torch.models import recurrent as trec
from repro_torch.models.lm import map_tree
from test_torch_lm import BF16_TOL, TOL32, RefJit, fp32, np32, ref_tree

B, S, CHUNK = 2, 13, 4
XLSTM, ZAMBA = "xlstm-1.3b", "zamba2-2.7b"
# mixer → (arch, the block's path in the param tree, its leading stacked dimensions)
MIXERS = {
    "mlstm": (XLSTM, ("units", "mlstm", "mix"), 2),
    "slstm": (XLSTM, ("units", "slstm", "mix"), 1),
    "mamba2": (ZAMBA, ("units", "mamba", "mix"), 2),
}


def mixer_cfg(arch, dtype):
    cfg = rcfgs.get_smoke_config(arch)
    return fp32(cfg) if dtype == "float32" else cfg


def block_params(name, dtype):
    """The first block's mixer params of the reference's smoke tree."""
    arch, path, depth = MIXERS[name]
    tree = ref_tree(arch, dtype)
    for key in path:
        tree = tree[key]
    return jax.tree.map(lambda a: a[(0,) * depth], tree)


def mix_fns(name, cfg, chunk):
    """(the reference's mixer under RefJit, the port's), as f(p, x, state)."""
    ref = {"mlstm": rrec.mlstm_mix, "slstm": rrec.slstm_mix, "mamba2": rrec.mamba2_mix}[name]
    port = {"mlstm": trec.mlstm_mix, "slstm": trec.slstm_mix, "mamba2": trec.mamba2_mix}[name]
    kw = {} if name == "slstm" else {"chunk": chunk}
    return (RefJit(lambda p, x, st: ref(p, cfg, x, state=st, **kw)),
            lambda p, x, st: port(p, cfg, x, state=st, **kw))


def seeded_state(name, cfg, rng, dtype):
    """A nonzero state of the mixer's shapes and dtypes, as numpy."""
    f32 = lambda *shape: (0.3 * rng.standard_normal(shape)).astype(np.float32)
    H, d = cfg.num_heads, cfg.d_model
    if name == "mlstm":
        hd = cfg.ssm_expand * d // H
        return (f32(B, H, hd, hd), np.abs(f32(B, H, hd)) + 0.5)
    if name == "slstm":
        hd = d // H
        return (f32(B, H, hd), np.abs(f32(B, H, hd)) + 1.0, f32(B, H, hd))
    di, ds = cfg.ssm_expand * d, cfg.ssm_state
    conv = f32(B, cfg.ssm_conv - 1, di + 2 * ds)
    return (f32(B, di // 64, 64, ds), conv.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
            else conv)


def to_port(tree):
    return map_tree(tree, lambda a: tensor_from_numpy(a).clone())


def assert_close(got, want, tol, what):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert tuple(g.shape) == np.shape(w), (what, i)
        assert str(g.dtype).replace("torch.", "") == str(np.asarray(w).dtype), (what, i)
        assert bool(torch.isfinite(g.float()).all()), (what, i)
        np.testing.assert_allclose(np32(g), np32(w), err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MIXERS))
def test_mixer_matches_reference(name, dtype):
    cfg = mixer_cfg(MIXERS[name][0], dtype)
    tol = TOL32 if dtype == "float32" else BF16_TOL
    p = block_params(name, dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    ref, port = mix_fns(name, cfg, CHUNK)
    tp = to_port(p)
    for state in (None, seeded_state(name, cfg, rng, dtype)):
        want_y, want_st = ref(p, x, state)
        got_y, got_st = port(tp, tensor_from_numpy(x), None if state is None else to_port(state))
        assert got_y.dtype == tensor_from_numpy(x).dtype
        what = f"{name} from {'zeros' if state is None else 'a seeded state'}"
        assert_close(got_y, want_y, tol, what + " y")
        assert_close(got_st, want_st, TOL32 if dtype == "float32" else tol, what + " state")


@pytest.mark.parametrize("name", list(MIXERS))
def test_chunk_size_does_not_change_the_result(name):
    """One chunk, four chunks and one step at a time (fp32) agree: the
    carried state equals the chunkwise form."""
    cfg = mixer_cfg(MIXERS[name][0], "float32")
    p = to_port(block_params(name, "float32"))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    outs = [mix_fns(name, cfg, c)[1](p, x, None) for c in (S, CHUNK, 1)]
    for y, st in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(), **TOL32)
        for a, b in zip(st, outs[0][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL32)


def test_mlstm_long_chunk_overflow_stays_finite():
    """Forget gates near 0 over a 128-step chunk: the pairwise decay's
    exponent reaches the thousands above the diagonal. The reference's ``where``
    drops those entries; so must the port (a 0/1 mask times inf is NaN)."""
    cfg = mixer_cfg(XLSTM, "float32")
    p = block_params("mlstm", "float32")
    H = cfg.num_heads
    p = dict(p, w_if=np.concatenate([p["w_if"][:, :H], np.full_like(p["w_if"][:, H:], -50.0)],
                                    axis=1))
    x = np.random.default_rng(7).standard_normal((1, 128, cfg.d_model)).astype(np.float32)
    ref, port = mix_fns("mlstm", cfg, 128)
    want_y, want_st = ref(p, x, None)
    got_y, got_st = port(to_port(p), torch.from_numpy(x), None)
    assert_close(got_y, want_y, TOL32, "mlstm y")
    assert_close(got_st, want_st, TOL32, "mlstm state")
    inner = x[0] @ p["w_up"][:, :cfg.ssm_expand * cfg.d_model]
    cum = np.cumsum(np.log(1 / (1 + np.exp(-(inner @ p["w_if"][:, H:]))) + 1e-9), axis=0)
    assert (cum[:1] - cum[-1:]).max() > 88.8            # exp overflows f32 above the diagonal


def test_ssd_long_chunk_overflow_stays_finite():
    """Mamba2 with A = −e^6 and dt ≈ 10: log decays of ≈ −4000 a step, a
    pairwise exponent far past f32's range above the diagonal."""
    cfg = mixer_cfg(ZAMBA, "float32")
    p = block_params("mamba2", "float32")
    p = dict(p, A_log=np.full_like(p["A_log"], 6.0), dt_bias=np.full_like(p["dt_bias"], 10.0))
    x = np.random.default_rng(8).standard_normal((1, 128, cfg.d_model)).astype(np.float32)
    ref, port = mix_fns("mamba2", cfg, 128)
    want_y, want_st = ref(p, x, None)
    got_y, got_st = port(to_port(p), torch.from_numpy(x), None)
    assert_close(got_y, want_y, TOL32, "mamba2 y")
    assert_close(got_st, want_st, TOL32, "mamba2 state")


def test_causal_conv_dtypes_and_state():
    """bf16 rows times f32 taps: f32 sums (silu'd), the state in bf16; a
    state carried in gives the same as the concatenated sequence."""
    rng = np.random.default_rng(9)
    xbc = rng.standard_normal((B, 9, 24)).astype(ml_dtypes.bfloat16)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    want_y, want_st = RefJit(lambda a, b: rrec._causal_conv(a, b, None))(xbc, w)
    got_y, got_st = trec._causal_conv(tensor_from_numpy(xbc), torch.from_numpy(w), None)
    assert got_y.dtype == torch.float32 and got_st.dtype == torch.bfloat16
    assert_close((got_y, got_st), (want_y, want_st), TOL32, "conv")
    y1, st1 = trec._causal_conv(tensor_from_numpy(xbc[:, :5]), torch.from_numpy(w), None)
    y2, _ = trec._causal_conv(tensor_from_numpy(xbc[:, 5:]), torch.from_numpy(w), st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), got_y.numpy(), **TOL32)


# ---------------------------------------------------------------- init
@functools.lru_cache(maxsize=None)
def port_init(arch, seed):
    return init_params(rcfgs.get_smoke_config(arch), seed, device="cpu")


def test_recurrent_init_is_seeded_and_spread_as_the_reference():
    """Each mixer's draws as the reference's ``init_*``: truncated normals
    scaled by 1/√fan-in (sLSTM's ``r`` on axis 1, Mamba2's ``conv`` at half
    that), ``A_log`` = log(1 … Hm), ``D`` = 1, zero norms and biases; the
    blocks and units drawn apart, the same seed the same tree."""
    std = 0.8796                  # a unit normal truncated to [-2, 2]
    cfg = rcfgs.get_smoke_config(XLSTM)
    a, b, c = port_init(XLSTM, 3), port_init(XLSTM, 3), init_params(cfg, 4, device="cpu")
    m, s = a["units"]["mlstm"]["mix"], a["units"]["slstm"]["mix"]
    assert torch.equal(m["wq"], b["units"]["mlstm"]["mix"]["wq"])
    assert not torch.equal(m["wq"], c["units"]["mlstm"]["mix"]["wq"])
    assert not torch.equal(m["wq"][0, 0], m["wq"][1, 0])             # units apart
    d, di, hd = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.d_model // cfg.num_heads
    leaves = [(m["w_up"], d), (m["wq"], di), (m["w_if"], di), (m["w_down"], di),
              (s["w_in"], d), (s["r"], hd), (s["w_down"], d)]
    zcfg = rcfgs.get_smoke_config(ZAMBA)
    z = port_init(ZAMBA, 3)
    mb = z["units"]["mamba"]["mix"]
    leaves += [(mb["w_in"], zcfg.d_model), (mb["w_down"], zcfg.ssm_expand * zcfg.d_model),
               (z["shared"]["attn"]["wq"], zcfg.d_model), (z["shared"]["ffn"]["w2"], zcfg.d_ff)]
    for leaf, fan_in in leaves:
        x = leaf.float()
        want = std / np.sqrt(fan_in)
        assert abs(float(x.std()) / want - 1) < 0.1, (tuple(leaf.shape), float(x.std()), want)
        assert float(x.abs().max()) <= 2.0 / np.sqrt(fan_in) * 1.01
    conv = mb["conv"]
    assert conv.dtype == torch.float32
    assert float(conv.abs().max()) <= 0.5 * 2.0 / np.sqrt(zcfg.ssm_conv) * 1.01
    assert abs(float(conv.std()) / (0.5 * std / np.sqrt(zcfg.ssm_conv)) - 1) < 0.1
    Hm = zcfg.ssm_expand * zcfg.d_model // 64
    assert torch.equal(mb["A_log"][0, 0], torch.log(torch.arange(1, Hm + 1, dtype=torch.float32)))
    assert bool((mb["D"] == 1).all()) and bool((mb["dt_bias"] == 0).all())
    for tree in (m, s, mb):
        assert bool((tree["norm"] == 0).all())
    assert "lm_head" not in a and "lm_head" in z          # xLSTM ties its head
