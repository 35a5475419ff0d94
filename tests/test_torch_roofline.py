"""The port's roofline and collective accounting against the JAX package's.

``_model_flops`` and ``_slstm_correction`` equal the reference's for every
architecture × applicable shape; ``_combine``, ``_combine_coll``,
``_wire`` and ``hlo.wire_bytes`` equal the reference's on the same
synthetic cells, and ``analyze`` gives each term as the reference's times
the ratio of the two packages' constants (the H100's in place of the TPU
v5e's). The card's bounds that moved out of ``chip_smoke.py`` give the
numbers its runs logged (``PERF.md`` §5–6): each kernel row's bound, the
prefill, decode and train bounds of Qwen1.5-4B on the shape-only init.
The derived collective records follow the ring's and the EP layer's
shapes.
"""

import numpy as np
import pytest

from repro import configs as rcfgs
from repro.config import applicable_shapes as r_shapes
from repro.launch import hlo as rhlo
from repro.launch import roofline as rroof
from repro_torch import configs
from repro_torch.core.pipeline import SpmdConfig
from repro_torch.launch import hlo, roofline
from repro_torch.models import init_params, moe

ARCHS = configs.arch_names()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_slstm_correction_match_reference(arch):
    for shape in r_shapes(rcfgs.get_config(arch)):
        want = rroof._model_flops(arch, shape.name, shape.kind, 256)
        got = roofline._model_flops(arch, shape.name, shape.kind, 256)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        for ndev in (1, 256, 512):
            assert roofline._slstm_correction(arch, shape.name, shape.kind, ndev) == \
                rroof._slstm_correction(arch, shape.name, shape.kind, ndev)


def synthetic_cells():
    """Cells in the reference's schema: a scanned transformer, gemma's
    unit with tail locals, xLSTM (the sLSTM correction), a decode, the
    ANNS ring, one without a ``zero`` variant and one that failed."""
    rng = np.random.default_rng(0)

    def variant(scale):
        coll = {"all-reduce": scale * 3e6, "all-gather": scale * 1e6,
                "collective-permute": scale * 5e5}
        if scale > 1:
            coll["all-to-all"] = scale * 2e5
        return {"flops": scale * 1.5e14, "bytes_accessed": scale * 4e11,
                "collective_result_bytes": coll,
                "memory": {"argument_bytes": int(scale * 3e9), "output_bytes": int(5e8),
                           "temp_bytes": int(scale * 9e9), "alias_bytes": 0}}

    cells = []
    for arch, shape, mesh, n, ul, tl in (
            ("qwen1.5-4b", "train_4k", "pod16x16", 40, 1, 0),
            ("gemma3-27b", "prefill_32k", "2pod_2x16x16", 10, 6, 2),
            ("xlstm-1.3b", "train_4k", "pod16x16", 6, 8, 0),
            ("olmoe-1b-7b", "decode_32k", "2pod_2x16x16", 16, 1, 0),
            ("zamba2-2.7b", "long_500k", "pod16x16", 9, 6, 0)):
        s = float(rng.uniform(1.5, 3.0))
        kind = shape.split("_")[0] if not shape.startswith("long") else "decode"
        cells.append({"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
                      "n_units": n, "unit_layers": ul, "tail_locals": tl, "ok": True,
                      "variants": {"full": variant(s), "zero": variant(1.0)}})
    one = dict(cells[0], shape="prefill_32k", kind="prefill")
    one["variants"] = {"full": variant(2.0)}
    cells.append(one)
    anns = {"flops": 2.1e9, "bytes_accessed": 3.4e8,
            "collective_result_bytes": {"collective-permute": 262144, "all-gather": 1280},
            "memory": {"argument_bytes": int(2.4e9), "output_bytes": 81920,
                       "temp_bytes": 524288, "alias_bytes": 0},
            "inner_trips": {"chunks": 64, "ring": 16}}
    cells.append({"arch": "harmony-anns", "shape": "spacev1b_like", "mesh": "pod16x16",
                  "kind": "serve", "ok": True, "variants": {"full": anns},
                  "scfg": {"cap": 2 ** 22, "chunk": 2 ** 16, "qb": 1024, "dim": 128,
                           "d_blocks": 16, "v_shards": 16}})
    cells.append({"arch": "qwen1.5-4b", "shape": "train_4k", "mesh": "pod16x16",
                  "ok": False, "error": "boom"})
    return cells


def test_combine_wire_and_wire_bytes_match_reference():
    for cell in synthetic_cells():
        if not cell.get("ok"):
            continue
        for key in ("flops", "bytes_accessed"):
            assert roofline._combine(cell, lambda v: v[key]) == \
                rroof._combine(cell, lambda v: v[key])
        if cell["arch"] != "harmony-anns":
            assert roofline._combine_coll(cell) == rroof._combine_coll(cell)
        coll = cell["variants"]["full"]["collective_result_bytes"]
        for groups in (1, 2, 16, 32):
            assert roofline._wire(coll, groups) == rroof._wire(coll, groups)
        for n in (1, 2, 16, 256, 512):
            assert hlo.wire_bytes(coll, n) == rhlo.wire_bytes(coll, n)


def test_analyze_is_the_reference_on_the_cards_constants():
    """Each term is the reference's times the ratio of the constants: bf16
    989 against 197 TFLOP/s (the ring: fp32 67), HBM 3.35 TB/s against
    819 GB/s, NVLink 450 GB/s against ICI 50; the counts, model FLOPs and
    resident bytes as the reference's."""
    cells = synthetic_cells()
    want = rroof.analyze(cells)
    got = roofline.analyze(cells)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        peak = roofline.FP32_FLOPS if g["arch"] == "harmony-anns" else roofline.BF16_FLOPS
        for key in ("arch", "shape", "mesh", "kind", "hlo_flops_dev", "hlo_bytes_dev",
                    "wire_bytes_dev", "slstm_correction_dev", "resident_bytes_dev"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["model_flops_global"], w["model_flops_global"],
                                   rtol=1e-12)
        np.testing.assert_allclose(g["compute_s"], w["compute_s"] * rroof.PEAK_FLOPS / peak,
                                   rtol=1e-12)
        np.testing.assert_allclose(g["memory_s"], w["memory_s"] * rroof.HBM_BW / roofline.HBM_BW,
                                   rtol=1e-12)
        np.testing.assert_allclose(g["collective_s"],
                                   w["collective_s"] * rroof.ICI_BW / roofline.NVLINK_BW,
                                   rtol=1e-12)
        np.testing.assert_allclose(g["memory_lower_s"],
                                   w["memory_lower_s"] * rroof.HBM_BW / roofline.HBM_BW,
                                   rtol=1e-12)
        terms = {k: g[f"{k}_s"] for k in ("compute", "memory", "collective")}
        assert g["dominant"] == max(terms, key=terms.get)
        assert g["fits_hbm"] == (g["resident_bytes_dev"] <= roofline.HBM_BYTES)
    assert set(roofline.RECOMMEND) == set(rroof.RECOMMEND)


def test_analyze_without_a_collective_record():
    """A production cell of the port's dry run records no collectives:
    no collective term, the bottleneck among the other two."""
    cell = synthetic_cells()[0]
    for v in cell["variants"].values():
        v.pop("collective_result_bytes")
    (row,) = roofline.analyze([cell])
    assert row["collective_s"] is None and row["wire_bytes_dev"] is None
    assert row["dominant"] == max(("compute", "memory"), key=lambda k: row[f"{k}_s"])


def test_kernel_bounds_are_the_logged_ones():
    """The per-launch counts give the bounds the kernel rows logged on
    the card (NVIDIA H100 80GB HBM3; ``PERF.md`` §6) at the main path's
    shapes: one of the two 128 × 128 tiles dead in the timed inputs."""
    b = roofline.bound_ms
    assert b(*roofline.distance_launch(128, 256, 128, 1)) == (0.00013755462686567164, "bytes")
    assert b(*roofline.distance_launch(64, 256, 64, 1)) == (6.404059701492537e-05, "bytes")
    assert b(*roofline.distance_launch(128, 256, 128, 1, row_bytes=2)) == (
        0.00011799164179104478, "bytes")
    assert b(*roofline.distance_launch(64, 256, 64, 1, row_bytes=2)) == (
        5.4259104477611936e-05, "bytes")
    assert b(*roofline.int8_distance_launch(128, 256, 128, 1)) == (
        9.353671641791045e-05, "bytes")
    assert b(*roofline.int8_distance_launch(64, 256, 64, 1)) == (
        4.5699104477611937e-05, "bytes")
    for (m, c, k), want in (((128, 256, 10), 4.554507462686567e-05),
                            ((64, 256, 40), 3.20955223880597e-05),
                            ((128, 256, 400), 0.0002839689552238806),
                            ((128, 4096, 4096), 0.0031349683582089552),
                            ((8, 12289, 12289), 0.0006016107462686567)):
        assert b(*roofline.topk_launch(m, c, k)) == (want, "bytes")
    # all tiles alive, the product dominates: operations
    assert b(*roofline.distance_launch(128, 4096, 4096, 32))[1] == "operations"


def test_lm_bounds_are_the_logged_ones():
    """Qwen1.5-4B on the shape-only init: the prefill bound at B = 8,
    S = 1024 (60.73 ms), the decode bound of its greedy steps at 288.5
    positions and of the last 8 of its 1152-position cache, and the train
    step's 149.76 ms at B = 4, S = 1024: the numbers phases 18 and 21
    logged from the card's params."""
    cfg = configs.get_config("qwen1.5-4b")
    p = init_params(cfg, 0, device="meta")
    pb = roofline.prefill_bound(cfg, p, 8, 1024, 128)
    assert pb == dict(flops=60061426647040.0, f32_flops=0, bound_ms=60.72945060368048,
                      bound_by="operations")
    assert roofline.decode_bound(cfg, p, 8, 256 + 65 / 2)["bound_ms"] == 2.408545814925373
    assert roofline.decode_bound(cfg, p, 8, 1152 - 7 / 2)["bound_ms"] == 3.249754173134328
    tb = roofline.train_step_bound(cfg, p, 4, 1024)
    assert tb["bound_ms"] == 149.76054944616692 and tb["flops"] == 120122853294080.0
    olmoe = configs.get_config("olmoe-1b-7b")
    assert roofline.prefill_bound(olmoe, init_params(olmoe, 0, device="meta"), 8, 1024,
                                  128)["bound_ms"] == 113.4719285622811
    assert roofline.recurrent_f32_flops(cfg, 8, 1024, 128) == 0
    assert roofline.recurrent_f32_flops(configs.get_config("xlstm-1.3b"), 8, 1024, 128) > 0


def test_custom_shapes_read_back():
    s = roofline.custom_shape("train", 4, 1024)
    assert (s.name, s.seq_len, s.global_batch, s.kind) == ("train_b4_s1024", 1024, 4, "train")
    assert roofline.shape_named(s.name) == s
    assert roofline.shape_named("decode_32k").global_batch == 128
    g, per = roofline._model_flops("qwen1.5-4b", "prefill_b8_s1024", "prefill", 1)
    assert g == per == 2 * roofline._active_params("qwen1.5-4b") * 8 * 1024


def test_collective_records():
    """Records sum and count by kind; the ring's follow its geometry (no
    permute on one block, a pod gather and reduce only with pods); the EP
    layer's three all-to-alls are its send buffers at ``ep_capacities``."""
    recs = [("all-gather", 10), ("all-reduce", 4), ("all-gather", 6)]
    assert hlo.collective_bytes(recs) == {"all-gather": 16, "all-reduce": 4}
    assert hlo.count_collectives(recs) == {"all-gather": 2, "all-reduce": 1}
    scfg = SpmdConfig(v_shards=4, d_blocks=2, n_pods=2, qb=64, cap=1024, dim=64, k=10,
                      chunk=256)
    stage, step = hlo.ring_collectives(scfg)
    assert stage == [("collective-permute", 4 * 32 * 256), ("collective-permute", 4 * 32)]
    assert hlo.collective_bytes(step) == {
        "all-gather": 2 * 4 * 2 * 32 * 10 + 2 * 4 * 4 * 64 * 10 + 2 * 4 * 2 * 64 * 10,
        "all-reduce": 4 + 4 + 8 + 8}
    stage1, step1 = hlo.ring_collectives(SpmdConfig(v_shards=1, d_blocks=1, qb=64, cap=1024,
                                                    dim=64, k=10, chunk=256))
    assert stage1 == [] and hlo.count_collectives(step1) == {"all-gather": 2, "all-reduce": 3}
    cfg = configs.get_config("olmoe-1b-7b")
    cap_send, _ = moe.ep_capacities(cfg, 2 * 1024, 8)
    rec = hlo.moe_ep_collectives(cfg, 2, 1024, 8)
    rows = 8 * cap_send
    assert rec == [("all-to-all", rows * cfg.d_model * 2), ("all-to-all", rows * 4),
                   ("all-to-all", rows * cfg.d_model * 2), ("all-reduce", 4)]
