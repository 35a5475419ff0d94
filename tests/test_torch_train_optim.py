"""The port's optimizers, int8 gradient compression and token pipeline
(``repro_torch.train.optimizer``, ``repro_torch.train.compression``,
``repro_torch.data.TokenPipeline``) against the reference's on the CPU.

``opt_update`` runs on the reference's own gradients (Qwen1.5's smoke
model in fp32, and a tree with leaves large enough to factor), AdamW and
Adafactor, clipping active and inactive, three steps from the reference's
state: the new params and state at rtol = 1e-6 (each leaf's atol 1e-6 of
its max |value|). The codes of ``quantize_int8`` and
``compress_with_feedback`` equal the reference's bit for bit;
``compressed_psum`` over 2 and 4 ranks equals the reference's under
``shard_map`` on as many host devices (one subprocess with 8 of them),
its residuals within XLA's fused multiply-add.
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

from repro.data import TokenPipeline as RTokenPipeline
from repro.train import OptConfig as ROptConfig
from repro.train import init_opt_state as r_init_opt_state
from repro.train import opt_update as r_opt_update
from repro.train import compression as rcomp
from repro_torch.data import TokenPipeline
from repro_torch.models import tree_from_reference
from repro_torch.train import OptConfig, global_norm, init_opt_state, opt_update
from repro_torch.train import compression as tcomp
from repro_torch.train.optimizer import clip_by_global_norm, opt_update_
from test_torch_train import named_leaves, reference_grads

ROOT = Path(__file__).resolve().parents[1]
RANKS = (2, 4)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def assert_trees_close(got, want, what, rtol=1e-6, atol_frac=1e-6):
    """Every leaf of the port's tree against the reference's (numpy) at
    ``rtol``, each leaf's atol ``atol_frac`` of its max |value|."""
    want = dict(named_leaves(want))
    got = dict(named_leaves(got))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[k]
        assert tuple(g.shape) == w.shape, (what, k)
        g = g.double().numpy()
        atol = atol_frac * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


def factor_tree(seed=0):
    """Params and three steps of gradients with factored leaves (a matrix,
    a stack of them), unfactored ones (a vector, a stack of norms, a thin
    matrix), fp32."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (256, 192), "stack": (3, 128, 160), "b": (256,), "norms": (2, 64),
              "thin": (64, 300)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def smoke_tree():
    """The reference's Qwen1.5 smoke params (fp32) and its gradients at
    three scales."""
    from test_torch_lm import ref_tree

    _, _, _, g = reference_grads("qwen1.5-4b")
    params = ref_tree("qwen1.5-4b", "float32")
    return params, [jax.tree.map(lambda a: np.asarray(a) * s, g) for s in (1.0, 0.3, 2.0)]


CASES = [(tree, name, clip, mdf)
         for tree in ("smoke", "factor") for name in ("adamw", "adafactor")
         for clip in ("active", "inactive") for mdf in (128, 32)
         if not (name == "adamw" and mdf == 32)]


@pytest.mark.parametrize("tree,name,clip,mdf", CASES)
def test_opt_update_matches_reference(tree, name, clip, mdf):
    params, grad_steps = smoke_tree() if tree == "smoke" else factor_tree()
    gnorm0 = float(rglobal_norm(grad_steps[0]))
    kw = dict(name=name, lr=1e-2, min_dim_factored=mdf,
              grad_clip=gnorm0 * 0.25 if clip == "active" else gnorm0 * 100)
    rcfg, tcfg = ROptConfig(**kw), OptConfig(**kw)
    r_params, r_state = params, r_init_opt_state(params, rcfg)
    t_params = tree_from_reference(params, device="cpu")
    t_state = init_opt_state(t_params, tcfg)
    assert_trees_close(t_state, np_tree(r_state), "init state", rtol=0, atol_frac=0)
    for i, g in enumerate(grad_steps):
        r_params, r_state = r_opt_update(r_params, g, r_state, rcfg)
        t_params, t_state = opt_update(t_params, tree_from_reference(g, device="cpu"),
                                       t_state, tcfg)
        assert int(t_state["step"]) == int(r_state["step"]) == i + 1
        assert t_state["step"].dtype == torch.int32 and t_state["step"].shape == ()
        assert_trees_close(t_state, np_tree(r_state), f"{name} state, step {i + 1}")
        assert_trees_close(t_params, np_tree(r_params), f"{name} params, step {i + 1}")
    if clip == "active":
        assert float(t_state["gnorm"]) > tcfg.grad_clip


def rglobal_norm(tree):
    from repro.train import global_norm as r_global_norm

    return r_global_norm(jax.tree.map(jnp.asarray, tree))


def test_bf16_gradients_are_clipped_in_their_dtype():
    """``clip_by_global_norm`` rounds the clipped gradient back to bf16
    before the moments see it: AdamW's first μ is 0.1 × that bf16 value,
    equal to the reference's; bf16 params step as the reference's (one
    bf16 ulp at most where the f32 update sits at a rounding boundary)."""
    params, grads = factor_tree(1)
    grads = grads[0]
    bf = lambda t: jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
    params, grads = bf(params), bf(grads)
    kw = dict(lr=1e-2, grad_clip=float(rglobal_norm(grads)) * 0.3)
    r_params, r_state = r_opt_update(params, grads, r_init_opt_state(params, ROptConfig(**kw)),
                                     ROptConfig(**kw))
    t_params = tree_from_reference(params, device="cpu")
    t_grads = tree_from_reference(grads, device="cpu")
    clipped, norm = clip_by_global_norm(t_grads, kw["grad_clip"])
    assert all(c.dtype == torch.bfloat16 for _, c in named_leaves(clipped))
    t_params, t_state = opt_update(t_params, t_grads, init_opt_state(t_params, OptConfig(**kw)),
                                   OptConfig(**kw))
    assert_trees_close(t_state["mu"], np_tree(r_state["mu"]), "mu")
    for k, c in named_leaves(clipped):
        np.testing.assert_array_equal(dict(named_leaves(t_state["mu"]))[k].numpy(),
                                      (0.1 * c.float()).numpy())
    for (k, got), (_, want) in zip(named_leaves(t_params), named_leaves(np_tree(r_params))):
        assert got.dtype == torch.bfloat16
        diff = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
        ulp = torch.from_numpy(np.asarray(want, np.float32)).abs() * 2.0 ** -7
        assert bool((diff <= ulp).all()), k
        assert float((diff > 0).float().mean()) < 0.01, k


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_update_leaves_the_callers_trees_unchanged(name):
    params, grad_steps = factor_tree(2)
    ocfg = OptConfig(name=name, lr=1e-2)
    p = tree_from_reference(params, device="cpu")
    g = tree_from_reference(grad_steps[0], device="cpu")
    s = init_opt_state(p, ocfg)
    trees = lambda: named_leaves(p) + named_leaves(g) + named_leaves(s)
    before = [t.clone() for _, t in trees()]
    new_p, new_s = opt_update(p, g, s, ocfg)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, trees()))
    assert int(s["step"]) == 0 and int(new_s["step"]) == 1
    # the in-place step writes the same numbers into the trees it is given
    opt_update_(p, g, s, ocfg)
    for (k, a), (_, b) in zip(named_leaves(p) + named_leaves(s),
                              named_leaves(new_p) + named_leaves(new_s)):
        assert torch.equal(a, b), k


def test_inplace_adamw_slices_equal_the_whole_leaf(monkeypatch):
    """AdamW in place in slices of INPLACE_CHUNK elements (a stacked leaf
    split across its units) gives the whole-leaf update bit for bit; the
    weight decay follows the whole leaf's rank; a non-contiguous leaf is
    updated whole, to the same values."""
    from repro_torch.train import optimizer as topt

    params, grad_steps = factor_tree(3)
    ocfg = OptConfig(lr=1e-2)
    out = []
    for chunk in (topt.INPLACE_CHUNK, 1000):
        monkeypatch.setattr(topt, "INPLACE_CHUNK", chunk)
        p = tree_from_reference(params, device="cpu")
        s = init_opt_state(p, ocfg)
        for g in grad_steps:
            opt_update_(p, tree_from_reference(g, device="cpu"), s, ocfg)
        out.append(named_leaves(p) + named_leaves(s))
    for (k, a), (_, b) in zip(*out):
        assert torch.equal(a, b), k
    # a leaf that is no contiguous block (a transposed view) steps whole
    w = tree_from_reference(params, device="cpu")["w"]
    p_t = {"w": w.t().contiguous().t()}
    assert not p_t["w"].is_contiguous()
    s_t = init_opt_state(p_t, ocfg)
    opt_update_(p_t, {"w": tree_from_reference(grad_steps[0], device="cpu")["w"]}, s_t, ocfg)
    p_c = {"w": w.clone()}
    s_c = init_opt_state(p_c, ocfg)
    opt_update_(p_c, {"w": tree_from_reference(grad_steps[0], device="cpu")["w"]}, s_c, ocfg)
    assert torch.equal(p_t["w"], p_c["w"]) and torch.equal(s_t["mu"]["w"], s_c["mu"]["w"])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_reduces_quadratic(name):
    """``tests/test_substrate.py::test_optimizer_reduces_quadratic``."""
    ocfg = OptConfig(name=name, lr=0.05, weight_decay=0.0)
    params = {"w": torch.ones((256, 256), dtype=torch.float32) * 2.0}
    state = init_opt_state(params, ocfg)

    def loss(p):
        return torch.mean(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(20):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state = opt_update(params, {"w": g}, state, ocfg)
    assert float(loss(params)) < l0 * 0.7
    assert int(state["step"]) == 20


def test_tree_from_reference_copies_and_keeps_scalars():
    """The reference's state crosses with its 0-d ``step`` and ``gnorm``
    still 0-d (numpy's ``ascontiguousarray`` makes a 0-d array 1-d), each
    leaf a copy of the caller's arrays."""
    state = jax.device_get(r_init_opt_state({"w": jnp.ones((3, 2))}, ROptConfig()))
    got = tree_from_reference(state, device="cpu")
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    assert got["gnorm"].shape == () and got["gnorm"].dtype == torch.float32
    got["mu"]["w"].add_(1)
    assert float(np.abs(state["mu"]["w"]).max()) == 0


def test_global_norm_and_unknown_optimizer():
    params, grads = factor_tree(4)
    t = tree_from_reference(grads[0], device="cpu")
    np.testing.assert_allclose(float(global_norm(t)), float(rglobal_norm(grads[0])), rtol=1e-6)
    with pytest.raises(ValueError):
        init_opt_state(t, OptConfig(name="sgd"))


# ---------------------------------------------------------------- compression
def grad_like(seed, shape=(3, 257)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_feedback_bit_equal_reference(seed):
    g, err = grad_like(seed), grad_like(seed + 100) * 1e-3
    rq, rs = rcomp.quantize_int8(jnp.asarray(g))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == ()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(rcomp.dequantize_int8(rq, rs)))
    rq, rs, re = rcomp.compress_with_feedback(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = tcomp.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    bf = torch.from_numpy(g).to(torch.bfloat16)
    rq, rs = rcomp.quantize_int8(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    tq, ts = tcomp.quantize_int8(bf)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))


def test_quantize_roundtrip_error_bounded():
    """``tests/test_substrate.py::test_quantize_roundtrip_error_bounded``."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,)).astype(np.float32))
    q, s = tcomp.quantize_int8(x)
    err = (tcomp.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """``tests/test_substrate.py::test_error_feedback_is_unbiased_over_time``:
    Σ_t deq(q_t) tracks Σ_t g_t; and ``compressed_psum``'s mean, summed
    over the steps, tracks the ranks' mean gradient the same way."""
    rng = np.random.default_rng(1)
    err = torch.zeros(64)
    errs = tcomp.init_error_state({"g": torch.zeros(4, 64)})["g"]
    sent, true = torch.zeros(64), torch.zeros(64)
    psum_sent, psum_true = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        q, s, err = tcomp.compress_with_feedback(g, err)
        sent += tcomp.dequantize_int8(q, s)
        true += g
        gr = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
        mean, errs = tcomp.compressed_psum(gr, errs)
        psum_sent += mean[0]
        psum_true += gr.mean(0)
    assert float((sent - true).abs().max()) < 0.2
    assert float((psum_sent - psum_true).abs().max()) < 0.2


REF_PSUM = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map_compat
    from repro.train.compression import compressed_psum
    src, dst = sys.argv[1], sys.argv[2]
    data = dict(np.load(src))
    out = {}
    for r in (2, 4):
        mesh = jax.make_mesh((r,), ("data",), devices=jax.devices()[:r])
        fn = jax.jit(shard_map_compat(
            lambda g, e: tuple(a[None] for a in compressed_psum(g[0], e[0], "data")),
            mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data"))))
        for case in ("a", "b"):
            mean, err = fn(data[f"g{r}{case}"], data[f"e{r}{case}"])
            out[f"mean{r}{case}"] = np.asarray(mean)
            out[f"err{r}{case}"] = np.asarray(err)
    np.savez(dst, **out)
""")


@pytest.fixture(scope="module")
def ref_psum(tmp_path_factory):
    """The reference's ``compressed_psum`` over 2 and 4 ranks (two inputs
    each; the second with ranks whose scales differ by 10³), from one
    subprocess with 8 host devices."""
    d = tmp_path_factory.mktemp("psum")
    data = {}
    for r in RANKS:
        data[f"g{r}a"] = np.stack([grad_like(10 * r + i, (5, 33)) for i in range(r)])
        data[f"e{r}a"] = np.stack([grad_like(20 * r + i, (5, 33)) * 1e-2 for i in range(r)])
        g = np.stack([grad_like(30 * r + i, (5, 33)) * 10.0 ** (3 * (i % 2)) for i in range(r)])
        data[f"g{r}b"], data[f"e{r}b"] = g, np.zeros_like(g)
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_PSUM, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return data, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", ["a", "b"])
@pytest.mark.parametrize("ranks", RANKS)
def test_compressed_psum_matches_reference_shard_map(ref_psum, ranks, case):
    """Each rank gets the same mean and its own residual, as each of the
    reference's ranks does: the mean at rtol 1e-6, the residuals within 2
    f32 ulps of the rank's max |g + err| (XLA's CPU backend contracts the
    jitted ``corrected − q · scale`` into one fused multiply-add, which
    the op-by-op reference of ``compress_with_feedback`` above, and the
    port, round twice)."""
    data, ref = ref_psum
    g, e = (torch.from_numpy(data[f"{k}{ranks}{case}"]) for k in ("g", "e"))
    mean, err = tcomp.compressed_psum(g, e, "data")
    assert mean.shape == g.shape and err.shape == g.shape
    assert all(torch.equal(mean[0], mean[r]) for r in range(ranks))
    np.testing.assert_allclose(mean.numpy(), ref[f"mean{ranks}{case}"], rtol=1e-6, atol=0)
    top = (g + e).abs().amax(dim=(1, 2), keepdim=True).numpy()
    assert (np.abs(err.numpy() - ref[f"err{ranks}{case}"]) <= 2.0 ** -22 * top).all()


def test_init_error_state_follows_the_gradients():
    grads = {"a": torch.zeros((3, 4), dtype=torch.bfloat16), "b": {"c": torch.zeros(5)}}
    state = tcomp.init_error_state(grads)
    assert state["a"].dtype == torch.float32 and state["a"].shape == (3, 4)
    assert state["b"]["c"].shape == (5,) and float(state["b"]["c"].abs().sum()) == 0


# ---------------------------------------------------------------- the token pipeline
@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_equals_reference(seed):
    """Every batch bit for bit, and ``shard_at`` over 1, 2 and 4 ranks
    (elastic: the ranks' shards concatenate to the global batch)."""
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=seed)
    ref, port = RTokenPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 3, 11):
        g = port.global_batch_at(step)
        assert g.dtype == np.int32 and g.shape == (8, 17)
        np.testing.assert_array_equal(g, ref.global_batch_at(step))
        for size in (1, 2, 4):
            shards = [port.shard_at(step, r, size) for r in range(size)]
            for r, s in enumerate(shards):
                np.testing.assert_array_equal(s, ref.shard_at(step, r, size))
            np.testing.assert_array_equal(np.concatenate(shards), g)
            for r in range(size):
                b, rb = port.batch_for_step(step, r, size), ref.batch_for_step(step, r, size)
                assert b.keys() == rb.keys() == {"tokens", "targets"}
                for k in b:
                    np.testing.assert_array_equal(b[k], rb[k])
    with pytest.raises(AssertionError):
        port.shard_at(0, 0, 3)
