"""The port's train step, loop, checkpoints and launcher
(``repro_torch.train.make_train_step`` / ``train_loop``,
``repro_torch.launch.train``) against the reference's on the CPU.

A step of Qwen1.5's smoke model in fp32, from the reference's params
carried across, against the reference's jitted ``make_train_step`` at 1
and 4 microbatches: the loss, ``grad_norm`` and the new moments (after one
AdamW step μ = 0.1 · the clipped gradient) at 1e-5 of each leaf's max
|value|, the params at 1e-6 where the step's direction is settled (|g| ≥
1e-3 of the leaf's max |g|: the first Adam step is about lr · sign(g)).
Train checkpoints cross the packages both ways and resume training there.
"""

import functools
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rcfgs
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.data import TokenPipeline as RTokenPipeline
from repro.models import RunCtx as RRunCtx
from repro.train import OptConfig as ROptConfig
from repro.train import init_opt_state as r_init_opt_state
from repro.train import make_train_step as r_make_train_step
from repro_torch import configs as tcfgs
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import RunCtx, init_params, tree_from_reference
from repro_torch.train import OptConfig, init_opt_state, make_train_step, train_loop
from repro_torch.train.train_loop import make_inplace_train_step
from test_torch_lm import fp32, ref_tree
from test_torch_train import named_leaves
from test_torch_train_optim import assert_trees_close, np_tree

ARCH = "qwen1.5-4b"
CTX = dict(q_chunk=16)


def lm_batch(vocab, B=8, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def ref_step(name, microbatches):
    """The reference's jitted fp32 step (lr 1e-3) on Qwen1.5's smoke model."""
    cfg = fp32(rcfgs.get_smoke_config(ARCH))
    return jax.jit(r_make_train_step(cfg, ROptConfig(name=name, lr=1e-3),
                                     RRunCtx(**CTX), microbatches))


def port_cfgs(name):
    return fp32(tcfgs.get_smoke_config(ARCH)), OptConfig(name=name, lr=1e-3)


def settled_params_close(got, want, grads, what):
    """Params where the update's sign is settled (|g| ≥ 1e-3 of the
    tree's max |g|, or g = 0: an embedding row no token reads) at rtol =
    atol = 1e-6; elsewhere (the key bias's gradient, 0 but for roundoff)
    within the step's reach, 2 · lr."""
    g = {k: np.abs(np.asarray(v, np.float64)) for k, v in named_leaves(grads)}
    top = max(float(v.max()) for v in g.values())
    want = dict(named_leaves(want))
    for k, a in named_leaves(got):
        a, b = a.double().numpy(), np.asarray(want[k], np.float64)
        settled = (g[k] >= 1e-3 * top) | (g[k] == 0)
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{what}: {k}")
        assert np.abs(a - b).max() <= 2 * 1e-3, (what, k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(name, microbatches):
    params_np = ref_tree(ARCH, "float32")
    batch = lm_batch(512)
    rp, ro, rm = ref_step(name, microbatches)(
        params_np, r_init_opt_state(params_np, ROptConfig(name=name)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, ocfg = port_cfgs(name)
    params = tree_from_reference(params_np, device="cpu")
    state = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg, RunCtx(**CTX), microbatches)
    tp, to, tm = step(params, state, batch)
    for k in ("loss", "aux", "logits_mean_abs", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5, atol=1e-6)
    if microbatches > 1:
        assert float(tm["aux"]) == 0 and float(tm["logits_mean_abs"]) == 0
    assert int(to["step"]) == 1
    moments = "mu" if name == "adamw" else "v"
    assert_trees_close(to[moments], np_tree(ro[moments]), f"{moments} {microbatches}",
                       rtol=1e-5, atol_frac=1e-5)
    if name == "adamw":
        # one step from zero: μ is 0.1 × the clipped gradient, so its
        # sign marks where the direction is settled
        settled_params_close(tp, np_tree(rp), np_tree(ro["mu"]), f"params {microbatches}")
    else:
        assert_trees_close(tp, np_tree(rp), f"params {microbatches}", rtol=1e-5,
                           atol_frac=1e-5)


def test_train_step_microbatch_equivalence():
    """``tests/test_substrate.py::test_train_step_microbatch_equivalence``
    in fp32 (unmarked): 1 microbatch against 4, the same update."""
    cfg = fp32(tcfgs.get_smoke_config(ARCH)).replace(remat=False)
    params = init_params(cfg, 0, device="cpu")
    ocfg = OptConfig(lr=1e-3)
    batch = lm_batch(cfg.vocab_size)
    p1, o1, m1 = make_train_step(cfg, ocfg, RunCtx(), 1)(params, init_opt_state(params, ocfg),
                                                          batch)
    p4, o4, m4 = make_train_step(cfg, ocfg, RunCtx(), 4)(params, init_opt_state(params, ocfg),
                                                          batch)
    d = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(named_leaves(p1),
                                                                  named_leaves(p4)))
    assert d < 5e-2
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]), rtol=1e-5)
    for (k, a), (_, b) in zip(named_leaves(o1["mu"]), named_leaves(o4["mu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()), msg=k)


def test_train_step_is_functional_and_train_loop_steps_in_place():
    """``make_train_step`` leaves the caller's params and state as they
    were; ``train_loop`` owns its state and writes each step into the
    params it was given (the same tensors come back), with the numbers of
    the functional step."""
    cfg = fp32(tcfgs.get_smoke_config(ARCH))
    ocfg = OptConfig(lr=1e-3)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    params = init_params(cfg, 0, device="cpu")
    state = init_opt_state(params, ocfg)
    before = [t.clone() for _, t in named_leaves(params) + named_leaves(state)]
    step = make_train_step(cfg, ocfg, RunCtx(**CTX))
    fp, fo = params, state
    for s in range(2):
        fp, fo, _ = step(fp, fo, pipe.batch_for_step(s))
    for a, (_, b) in zip(before, named_leaves(params) + named_leaves(state)):
        assert torch.equal(a, b)
    own = {k: v.clone() for k, v in named_leaves(params)}
    given = dict(named_leaves(params))
    out, opt, hist = train_loop(cfg, params, pipe, steps=2, ocfg=ocfg, ctx=RunCtx(**CTX),
                                log_every=0)
    assert len(hist) == 2 and int(opt["step"]) == 2
    for k, t in named_leaves(out):
        assert t is given[k]                                  # written in place
    assert not torch.equal(given["/embed"], own["/embed"])
    for (k, a), (_, b) in zip(named_leaves(out) + named_leaves(opt),
                              named_leaves(fp) + named_leaves(fo)):
        assert torch.equal(a, b), k
    # the in-place step is the functional step's arithmetic
    p = init_params(cfg, 0, device="cpu")
    o = init_opt_state(p, ocfg)
    m = make_inplace_train_step(cfg, ocfg, RunCtx(**CTX))(p, o, pipe.batch_for_step(0))
    p1, o1, m1 = step(init_params(cfg, 0, device="cpu"), init_opt_state(p, ocfg),
                      pipe.batch_for_step(0))
    assert float(m["loss"]) == float(m1["loss"])
    for (k, a), (_, b) in zip(named_leaves(p) + named_leaves(o),
                              named_leaves(p1) + named_leaves(o1)):
        assert torch.equal(a, b), k


def test_training_reduces_loss():
    """``tests/test_substrate.py::test_training_reduces_loss``: the smoke
    model in its own bf16, 30 steps of ``train_loop``."""
    cfg = tcfgs.get_smoke_config(ARCH)
    params = init_params(cfg, 0, device="cpu")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    params, _, history = train_loop(cfg, params, pipe, steps=30, ocfg=OptConfig(lr=3e-3),
                                    log_every=0)
    assert np.mean(history[-5:]) < np.mean(history[:5]) - 0.2, history[:3] + history[-3:]


def test_checkpoint_restore_resumes_training(tmp_path):
    """``tests/test_substrate.py::test_checkpoint_restore_resumes_training``:
    xLSTM's smoke model, a checkpoint after step 2, a crash, a restore and
    the replay of steps 2–3 equal to the uninterrupted run (atol 1e-6)."""
    cfg = tcfgs.get_smoke_config("xlstm-1.3b")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    ocfg = OptConfig(lr=1e-3)
    step_fn = make_train_step(cfg, ocfg, RunCtx(rec_chunk=8))
    params = init_params(cfg, 0, device="cpu")
    opt = init_opt_state(params, ocfg)
    ck = Checkpointer(tmp_path)
    for step in range(4):
        params, opt, _ = step_fn(params, opt, pipe.batch_for_step(step))
        if step == 1:
            ck.save(2, {"params": params, "opt": opt})
    restored = ck.restore({"params": params, "opt": opt}, step=2, device="cpu")
    p2, o2 = restored["params"], restored["opt"]
    assert o2["step"].dtype == torch.int32 and o2["step"].shape == () and int(o2["step"]) == 2
    for step in range(2, 4):
        p2, o2, _ = step_fn(p2, o2, pipe.batch_for_step(step))
    for (k, a), (_, b) in zip(named_leaves(p2), named_leaves(params)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6, err_msg=k)


def test_async_checkpoints_of_the_in_place_loop_are_not_torn(tmp_path, monkeypatch):
    """``train_loop`` overwrites params and moments each step while an
    async checkpoint of the step before may still be writing. Each write
    here is held until the next step's update is done; every saved step
    must still restore bit for bit to the state captured when it was
    saved (bf16 params, f32 moments, the int32 step)."""
    cfg = tcfgs.get_smoke_config(ARCH)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    gates, real_savez = {}, np.savez

    def held_savez(path, **arrays):
        gates[int(Path(path).parent.name.rsplit("_", 1)[1])].wait(timeout=60)
        real_savez(path, **arrays)

    class HeldCheckpointer(Checkpointer):
        def save(self, step, tree):
            snapshots[step] = {k: v.clone() for k, v in named_leaves(tree)}
            for g in gates.values():              # the earlier steps' writes may go on
                g.set()
            gates[step] = threading.Event()
            return super().save(step, tree)

    snapshots = {}
    monkeypatch.setattr(np, "savez", held_savez)
    ck = HeldCheckpointer(tmp_path, keep=10, async_write=True)
    params = init_params(cfg, 0, device="cpu")
    like = {"params": init_params(cfg, 1, device="cpu")}
    like["opt"] = init_opt_state(like["params"], OptConfig())
    _, opt, _ = train_loop(cfg, params, pipe, steps=3, ctx=RunCtx(**CTX), checkpointer=ck,
                           ckpt_every=1, log_every=0)
    for g in gates.values():
        g.set()
    ck.wait()
    assert not ck.errors and ck.all_steps() == [1, 2, 3] and int(opt["step"]) == 3
    for step in (1, 2, 3):
        got = dict(named_leaves(ck.restore(like, step=step, device="cpu")))
        for k, want in snapshots[step].items():
            assert got[k].dtype == want.dtype and torch.equal(got[k], want), (step, k)


# ---------------------------------------------------------------- across packages
def ref_run(name, params, opt, steps, pipe):
    step = ref_step_pipe(name)
    for s in steps:
        params, opt, _ = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in pipe.batch_for_step(s).items()})
    return params, opt


@functools.lru_cache(maxsize=None)
def ref_step_pipe(name):
    cfg = fp32(rcfgs.get_smoke_config(ARCH))
    return jax.jit(r_make_train_step(cfg, ROptConfig(name=name, lr=1e-3), RRunCtx(**CTX)))


def port_run(name, params, opt, steps, pipe):
    cfg, ocfg = port_cfgs(name)
    step = make_train_step(cfg, ocfg, RunCtx(**CTX))
    for s in steps:
        params, opt, _ = step(params, opt, pipe.batch_for_step(s))
    return params, opt


def continuation_close(got, want, what):
    """Two more steps from the same checkpoint in either package: the state
    at 1e-5 of each leaf's max |value|, the params at rtol = atol = 1e-5.
    The key biases are held only within the 4 updates' reach (4 · lr · 3):
    a bias added to every key of a query leaves its softmax unchanged, so
    their gradient is 0 but for roundoff, and its sign is noise in either
    package."""
    gp, go = got
    wp, wo = want
    assert_trees_close(go, np_tree(wo), f"{what} state", rtol=1e-5, atol_frac=1e-5)
    want = dict(named_leaves(np_tree(wp)))
    for k, a in named_leaves(gp):
        a, b = a.double().numpy(), np.asarray(want[k], np.float64)
        if k.endswith("/bk"):
            assert np.abs(a - b).max() <= 4 * 1e-3 * 3, (what, k)
            continue
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"{what} params: {k}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_checkpoints_cross_packages(tmp_path, name):
    """The reference trains 2 steps and saves ``{"params", "opt"}``; the
    port restores it and trains 2 more, as the reference continues from
    its own. Then the port trains 2 steps from the same init and saves;
    the reference restores that and continues as the port does."""
    pipe = RTokenPipeline(vocab_size=512, seq_len=16, global_batch=8)
    init_np = ref_tree(ARCH, "float32")
    r_opt0 = r_init_opt_state(init_np, ROptConfig(name=name))
    rp, ro = ref_run(name, init_np, r_opt0, range(2), pipe)
    RCheckpointer(tmp_path / "ref").save(2, {"params": rp, "opt": ro})
    want = ref_run(name, rp, ro, range(2, 4), pipe)

    cfg, ocfg = port_cfgs(name)
    like_p = init_params(cfg, 1, device="cpu")
    like = {"params": like_p, "opt": init_opt_state(like_p, ocfg)}
    got = Checkpointer(tmp_path / "ref").restore(like, device="cpu")
    assert got["opt"]["step"].shape == () and got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 2
    assert_trees_close(got["params"], np_tree(rp), "restored params", rtol=0, atol_frac=0)
    continuation_close(port_run(name, got["params"], got["opt"], range(2, 4), pipe), want,
                       "port from the reference's checkpoint")

    tp0 = tree_from_reference(init_np, device="cpu")
    tp, to = port_run(name, tp0, init_opt_state(tp0, ocfg), range(2), pipe)
    Checkpointer(tmp_path / "port").save(2, {"params": tp, "opt": to})
    port_own = port_run(name, tp, to, range(2, 4), pipe)
    back = RCheckpointer(tmp_path / "port").restore({"params": init_np, "opt": r_opt0})
    assert int(back["opt"]["step"]) == 2 and back["opt"]["step"].dtype == jnp.int32
    rp2, ro2 = ref_run(name, back["params"], back["opt"], range(2, 4), pipe)
    continuation_close(port_own, (rp2, ro2), "reference from the port's checkpoint")


# ---------------------------------------------------------------- the launcher
def test_launcher_trains_and_resumes(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains
    and checkpoints; a second run resumes from the latest step; a
    frontend config is refused, and without ``--device`` it needs CUDA."""
    args = ["--arch", ARCH, "--smoke", "--seq", "16", "--batch", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = launch_train.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "final loss" in out and len(hist) == 4
    assert Checkpointer(tmp_path).all_steps() == [2, 4]
    hist = launch_train.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and np.isfinite(hist[-1])
    assert Checkpointer(tmp_path).latest_step() == 6
    with pytest.raises(SystemExit, match="frontend"):
        launch_train.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
