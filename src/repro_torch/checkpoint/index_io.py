"""Persist and restore the segmented data plane through
:class:`repro_torch.checkpoint.Checkpointer`, in the reference's format.

``save_segmented_index`` writes the sealed segments (centers, packed
rows, external ids, cluster tables, the int8 tier's codes and grids when
present, metadata columns and texts), the dead-row bitmaps, the live
delta rows with their metadata, the tiers and hotness, and the config,
as one generation-numbered checkpoint step. ``load_segmented_index``
rebuilds an equivalent :class:`repro_torch.core.SegmentedIndex` on the
caller's device (CUDA by default) through
:meth:`~repro_torch.core.SegmentedIndex.from_arrays`; executors, plans
and step caches are derived state and are rebuilt on adopt.

Layout: the standard step directory (manifest + npz), with the tree
structure in the flat keys (``segments/<i>/<leaf>``) and the non-array
metadata (config, segment ids, generation, the WAL watermark) JSON in a
``meta`` uint8 leaf. The keys, dtypes and JSON are the reference's, so a
step written by either package loads in the other. The step number is
the plane's generation.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.config import HarmonyConfig
from repro_torch.core.index import Int8Quant, SegmentedIndex


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8).copy()


def _meta_parse(arr: np.ndarray) -> dict:
    return json.loads(bytes(np.asarray(arr).astype(np.uint8)).decode("utf-8"))


def save_segmented_index(
    ckpt: Checkpointer, data: SegmentedIndex, step: Optional[int] = None
) -> Path:
    """Write ``data`` as checkpoint step ``step`` (default: its current
    generation). Point-in-time consistent: the state is read under the
    data-plane lock, so a concurrent writer cannot tear it. The sealed
    segments' rows are written from their host copy."""
    with data._mu:
        step = data.generation if step is None else step
        meta = {
            "generation": data.generation,
            "op_count": data.op_count,
            # the WAL watermark: the last durable record this checkpoint
            # contains; recovery replays only records past it
            "wal_seq": data.wal_seq,
            "next_seg_id": data._next_seg_id,
            "seg_ids": [s.seg_id for s in data.segments],
            "seg_cfgs": [dataclasses.asdict(s.index.cfg) for s in data.segments],
            "cfg": dataclasses.asdict(data.cfg),
            # which segments carry an int8 tier at the canonical
            # cfg.quant_blocks grid (other grids are rebuilt on demand)
            "quantized": [
                s.index.cfg.quant_blocks
                in s.index.__dict__.get("_int8_quants", {})
                for s in data.segments
            ],
            "meta_cols": [
                None if s.index.meta is None else {
                    "tags": sorted(s.index.meta.tags),
                    "nums": sorted(s.index.meta.nums),
                    "texts": s.index.meta.texts is not None,
                }
                for s in data.segments
            ],
            "tiers": [data._tier.get(s.seg_id, "device")
                      for s in data.segments],
            "placement_version": data.placement_version,
        }
        tree = {"meta": _meta_array(meta)}
        for i, seg in enumerate(data.segments):
            leaf = {
                "centers": seg.index.centers,
                "x": seg.index.x.numpy(),
                "ids": seg.index.ids,
                "cluster_of": seg.index.cluster_of,
                "offsets": seg.index.offsets,
                "dead_rows": data._dead_rows[seg.seg_id].copy(),
            }
            q = seg.index.__dict__.get("_int8_quants", {}).get(
                seg.index.cfg.quant_blocks
            )
            if q is not None:
                leaf["quant_codes"] = q.codes
                leaf["quant_scale"] = q.scale
                leaf["quant_zero"] = q.zero
            h = data._hotness.get(seg.seg_id)
            if h is not None:
                leaf["hotness"] = h.copy()
            ms = seg.index.meta
            if ms is not None:
                for name, col in ms.tags.items():
                    leaf[f"meta_tag_{name}"] = col
                for name, col in ms.nums.items():
                    leaf[f"meta_num_{name}"] = col
                if ms.texts is not None:
                    leaf["meta_texts"] = _meta_array({"texts": list(ms.texts)})
            tree[f"segments/{i}"] = leaf
        n = data._delta_len
        live = data._delta_live[:n]
        tree["delta"] = {
            "ids": data._delta_ids[:n][live].copy(),
            "x": data._delta_x[:n][live].copy(),
        }
        delta_meta = [data._delta_meta[r] for r in np.nonzero(live)[0]]
        if any(r for r in delta_meta):
            tree["delta"]["meta_rows"] = _meta_array({"rows": delta_meta})
    return ckpt.save(step, tree)


def load_segmented_index(
    ckpt: Checkpointer, step: Optional[int] = None, device: DeviceLike = None,
) -> SegmentedIndex:
    """Rebuild the :class:`SegmentedIndex` of checkpoint ``step`` (default:
    the newest readable one), served on ``device`` (CUDA by default; the
    rows stay on the host). Searches over it equal the saved plane's."""
    device = resolve_device(device)
    _, arrays = ckpt.load_arrays(step)
    meta = _meta_parse(arrays["meta"])
    n_seg = len(meta["seg_ids"])
    quantized = meta.get("quantized", [False] * n_seg)
    meta_cols = meta.get("meta_cols", [None] * n_seg)
    segments, dead_rows = [], {}
    for i, seg_id in enumerate(meta["seg_ids"]):
        pre = f"segments/{i}/"
        store = None
        if meta_cols[i] is not None:
            mc = meta_cols[i]
            store = dict(
                tags={n: arrays[pre + f"meta_tag_{n}"] for n in mc["tags"]},
                nums={n: arrays[pre + f"meta_num_{n}"] for n in mc["nums"]},
                texts=_meta_parse(arrays[pre + "meta_texts"])["texts"]
                if mc["texts"] else None,
            )
        segments.append(dict(
            seg_id=int(seg_id), centers=arrays[pre + "centers"],
            x=arrays[pre + "x"], ids=arrays[pre + "ids"],
            cluster_of=arrays[pre + "cluster_of"], offsets=arrays[pre + "offsets"],
            meta=store,
        ))
        dead_rows[int(seg_id)] = arrays[pre + "dead_rows"].astype(bool)
    d_ids = arrays["delta/ids"].astype(np.int64)
    d_meta = [None] * len(d_ids)
    if "delta/meta_rows" in arrays:
        d_meta = _meta_parse(arrays["delta/meta_rows"])["rows"]
    # saved delta rows are the live set: a sealed copy of the same id was
    # tombstoned at save time (dead_rows)
    data = SegmentedIndex.from_arrays(meta["cfg"], dict(
        segments=segments, dead_rows=dead_rows, dead_version=0,
        delta_ids=d_ids, delta_x=arrays["delta/x"],
        delta_live=np.ones(len(d_ids), bool), delta_meta=d_meta,
        generation=meta["generation"], next_seg_id=meta["next_seg_id"],
        op_count=meta["op_count"],
    ), device=device)
    data.wal_seq = int(meta.get("wal_seq", 0))
    for i, seg in enumerate(data.segments):
        # the saved segment config, as the reference restores it
        seg.index.cfg = HarmonyConfig(**meta["seg_cfgs"][i])
        pre = f"segments/{i}/"
        if quantized[i]:
            seg.index.attach_int8_quant(Int8Quant(
                codes=arrays[pre + "quant_codes"].astype(np.int8),
                scale=arrays[pre + "quant_scale"].astype(np.float32),
                zero=arrays[pre + "quant_zero"].astype(np.float32),
            ))
        if pre + "hotness" in arrays:
            data._hotness[seg.seg_id] = arrays[pre + "hotness"].astype(np.float64)
    # placement: the saved hot/cold split, not an all-device cold start
    tiers = meta.get("tiers")
    if tiers is not None:
        data._tier = {int(s): t for s, t in zip(meta["seg_ids"], tiers)}
    data.placement_version = int(meta.get("placement_version", 0))
    return data
