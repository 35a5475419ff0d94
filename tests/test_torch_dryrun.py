"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta`` tensors.

Qwen1.5-4B's full-width prefill at B = 4, S = 1024 counts ``lm_bounds``'
GEMM FLOPs plus the unmasked attention's (the port computes the whole
S × S), within 0.1 %, and the combination of its ``full`` (one unit) and
``zero`` variants gives the whole stack's count. No tensor of a run
leaves ``meta``; the cache has the reference's cell schema, so the
reference's roofline reads it; xLSTM's sLSTM recurrence is counted
analytically. ``--arch``/``--shape`` on one cell runs as a subprocess
with CUDA hidden, and ``python -m repro_torch.launch.roofline`` reads
what it wrote.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import roofline as rroof
from repro_torch import configs
from repro_torch.launch import dryrun, roofline
from repro_torch.models import init_params

ROOT = Path(__file__).resolve().parents[1]
CELL_KEYS = {"arch", "shape", "mesh", "kind", "n_units", "unit_layers", "tail_locals",
             "variants", "ok"}
VARIANT_KEYS = {"flops", "bytes_accessed", "collective_result_bytes", "memory"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


def test_qwen_prefill_flops_are_the_gemms_and_the_whole_attention():
    cfg = configs.get_config("qwen1.5-4b")
    B, S = 4, 1024
    cell = dryrun.trace_cell(cfg, roofline.custom_shape("prefill", B, S))
    p = init_params(cfg, 0, device="meta")
    flops, _ = roofline.lm_bounds(cfg, p, B, S, 0)
    per_pair = cfg.num_layers * 4 * B * cfg.num_heads * cfg.head_dim
    gemms = flops - per_pair * S * (S + 1) / 2               # lm_bounds' causal half
    want = gemms + per_pair * S * S
    assert cell["stack"]["flops"] == pytest.approx(want, rel=1e-3)
    assert roofline._combine(cell, lambda v: v["flops"]) == cell["stack"]["flops"]
    assert cell["bound"] == roofline.prefill_bound(cfg, p, B, S, 128)
    mem = cell["variants"]["full"]["memory"]
    assert mem["argument_bytes"] == roofline.tree_bytes(p) + B * S * 8
    # the f32 logits [B, S, V] and their bf16 source are live at once
    assert mem["temp_bytes"] >= B * S * cfg.vocab_size * 6
    (row,) = roofline.analyze([cell])
    assert row["fits_hbm"] and row["collective_s"] == 0.0
    assert row["compute_s"] == pytest.approx(cell["stack"]["flops"] / roofline.BF16_FLOPS)


def test_runs_on_meta_only():
    """A tensor made off ``meta`` (but a host scalar or an empty host
    tensor) stops the trace."""
    with pytest.raises(RuntimeError, match="meta only"):
        with dryrun.MetaTrace([]):
            torch.ones(3) + 1
    with dryrun.MetaTrace([]) as mt:
        x = torch.empty((4, 8), device="meta")
        y = x * torch.tensor(2.0)                      # a host scalar mixes in
        torch.empty((0,), requires_grad=True)          # checkpoint's marker
        del x
    assert mt.peak == 2 * 4 * 8 * 4 and mt.live == 4 * 8 * 4 and y.device.type == "meta"


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "gemma3-27b", "olmoe-1b-7b"])
def test_smoke_cells_have_the_reference_schema(arch):
    """Each kind of a smoke config: the reference's schema (its roofline
    reads the cell), one unit × n_units + the zero variant = the whole
    stack's FLOPs, and xLSTM's sLSTM counted analytically."""
    cfg = configs.get_smoke_config(arch)
    for kind in ("prefill", "train", "decode"):
        cell = dryrun.trace_cell(cfg, roofline.custom_shape(kind, 2, 32))
        assert CELL_KEYS <= set(cell) and cell["ok"]
        for v in cell["variants"].values():
            assert VARIANT_KEYS <= set(v) and set(v["memory"]) == MEMORY_KEYS
        assert roofline._combine(cell, lambda v: v["flops"]) == pytest.approx(
            cell["stack"]["flops"], rel=1e-9)
        assert ("slstm" in cell) == (arch == "xlstm-1.3b" and kind != "decode")
        assert cell["bound"]["bound_ms"] > 0


def test_cli_one_cell_without_a_card(tmp_path):
    """``--arch``/``--shape`` with CUDA hidden: the one-card cell, both
    production meshes and the ANNS cells; then the port's roofline and
    the reference's ``analyze`` read the file."""
    out = tmp_path / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-4b",
         "--shape", "decode_32k", "--mesh", "all", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cells = {c["mesh"] + "/" + c["arch"]: c for c in json.loads(out.read_text())}
    assert set(cells) == {f"{m}/{a}" for m in ("h100x1", "pod16x16", "2pod_2x16x16")
                          for a in ("qwen1.5-4b", "harmony-anns")}
    one, pod = cells["h100x1/qwen1.5-4b"], cells["pod16x16/qwen1.5-4b"]
    assert CELL_KEYS <= set(one) and one["variants"]["full"]["collective_result_bytes"] == {}
    assert "collective_result_bytes" not in pod["variants"]["full"]
    args = lambda c: c["variants"]["full"]["memory"]["argument_bytes"]
    assert args(one) / 256 <= args(pod) < args(one)
    assert args(cells["2pod_2x16x16/qwen1.5-4b"]) < args(pod)
    assert pod["variants"]["full"]["flops"] == one["variants"]["full"]["flops"] / 256
    anns = cells["pod16x16/harmony-anns"]
    assert anns["launches"]["distance"] == 64 * 16 and anns["launches"]["topk"] == 64
    assert cells["h100x1/harmony-anns"]["launches"]["distance"] == 256 * 64 * 16
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--json",
                           str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads((tmp_path / "roofline_torch.json").read_text())
    assert len(rows) == 6 and "6 rows" in proc.stdout
    by = {r["mesh"] + "/" + r["arch"]: r for r in rows}
    assert by["pod16x16/qwen1.5-4b"]["collective_s"] is None
    assert by["pod16x16/harmony-anns"]["dominant"] in ("compute", "memory", "collective")
    assert len(rroof.analyze([c for c in cells.values()])) == 6
