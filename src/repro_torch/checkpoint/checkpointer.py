"""Checkpointing with a manifest, retention, async writes and a
crash-atomic publish.

Layout per step, the same as the reference's (either package reads the
other's steps)::

    <dir>/step_000000042/
        manifest.json        # leaf keys, shapes, dtypes, step
        arrays.npz           # one entry per leaf, "<key>@shard0"

A tree is nested dicts, lists and tuples over leaves (numpy arrays, torch
tensors, Python scalars). Its flat keys are the reference's: the path
components joined by ``/``, dict keys in sorted order, sequence
positions as numbers, ``None`` subtrees dropped. A bfloat16 leaf is
stored as its ``uint16`` view, with ``"bfloat16"`` in the manifest.
Restore returns torch tensors on the caller's device (CUDA by default).
One card has no resharding: ``shardings=`` raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._arrays import bf16_from_words, bf16_words, is_bf16
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.runtime.faults import fault_point


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, sequences in order, ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_paths(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_paths(v, prefix + (str(i),)))
        return out
    return [(prefix, tree)]


def _flatten(tree) -> Dict[str, Any]:
    return {"/".join(path): leaf for path, leaf in _paths(tree)}


def _unflatten(like, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``like``'s structure with each leaf replaced from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return type(like)((k, _unflatten(v, leaves, prefix + (str(k),)))
                          for k, v in like.items())
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(like)]
        return type(like)(vals) if isinstance(like, list) else tuple(vals)
    return leaves["/".join(prefix)]


def _torch_dtype(dtype) -> torch.dtype:
    """A target leaf's dtype (torch, numpy or ml_dtypes) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if is_bf16(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of the leaf to store, its manifest dtype): bf16 as
    uint16 words. Always a copy, so an async write never sees a later
    in-place update of the leaf (``train_loop`` steps in place)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            a, name = bf16_words(leaf), "bfloat16"
        else:
            a = leaf.detach().cpu().contiguous().numpy()
            name = str(a.dtype)
        # .cpu() copies a card's tensor; a CPU tensor's numpy view shares its memory
        return (a.copy() if leaf.device.type == "cpu" else a), name
    a = np.array(leaf, copy=True)
    if is_bf16(a.dtype):
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        self.errors: list = []          # failed async writes (repr strings)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> Path:
        """Write one step crash-atomically: arrays and manifest land in a
        hidden temp dir (invisible to ``all_steps``), are fsynced, and are
        published by one directory rename, so an interrupted write (sync or
        async, at any instant) never leaves a corrupt ``step_*`` dir, at
        worst dead ``.tmp_*``/``.old_*`` litter that the next save of the
        same step sweeps. Tensors are copied to the host here, before an
        async write starts. Async failures are recorded in
        ``self.errors`` and warned, never swallowed."""
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_host(v)
        manifest = {
            "step": step,
            "leaves": {
                k: {"shape": list(v.shape), "dtype": dtypes[k]}
                for k, v in host.items()
            },
            "time": time.time(),
        }
        final = self.dir / f"step_{step:09d}"

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **{f"{k}@shard0": v for k, v in host.items()})
            fault_point("checkpoint.write", step=step)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            _fsync_file(tmp / "arrays.npz")
            _fsync_file(tmp / "manifest.json")
            # publish: directory renames are atomic, so readers see either
            # the complete old step or the complete new one. Overwriting an
            # existing step moves it aside first (a rename: a crash in an
            # rmtree would tear the only copy); a crash between the two
            # renames leaves no step_ dir for this step, and the next read
            # renames the moved-aside copy back.
            old = None
            if final.exists():
                old = self.dir / f".old_step_{step:09d}"
                if old.exists():
                    shutil.rmtree(old)
                final.rename(old)
            fault_point("checkpoint.publish", step=step)
            tmp.rename(final)
            try:
                _fsync_file(self.dir)
            except OSError:
                pass
            if old is not None:
                shutil.rmtree(old)
            self._gc()

        if self.async_write:
            self.wait()

            def write_guarded():
                try:
                    write()
                except BaseException as e:     # noqa: BLE001 - surfaced below
                    self.errors.append(repr(e))
                    warnings.warn(f"async checkpoint write failed: {e!r}")

            self._pending = threading.Thread(target=write_guarded, daemon=True)
            self._pending.start()
        else:
            write()
        return final

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        # an orphaned .old_step_* is a step's only surviving copy: put it
        # back before sweeping, or the sweep would destroy data
        self._recover_interrupted_publish()
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        # crash litter: published steps never live under these names, and
        # only one write is in flight at a time (async waits for its
        # predecessor), so anything left here is a dead interrupted write
        for p in list(self.dir.glob(".tmp_step_*")) + list(
            self.dir.glob(".old_step_*")
        ):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    def _recover_interrupted_publish(self):
        """Undo a crash in :meth:`save`'s publish window: an
        ``.old_step_N`` whose ``step_N`` is missing is the previously
        published step N, complete and fsynced, so it is renamed back. One
        whose ``step_N`` exists is litter and is left for the sweep."""
        restored = []
        for p in self.dir.glob(".old_step_*"):
            m = re.fullmatch(r"\.old_step_(\d+)", p.name)
            if not m or not p.is_dir():
                continue
            final = self.dir / f"step_{m.group(1)}"
            if final.exists():
                continue
            p.rename(final)
            restored.append(int(m.group(1)))
            warnings.warn(
                f"restored checkpoint step {int(m.group(1))} from an "
                f"interrupted overwrite under {self.dir}"
            )
        return restored

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_step(self, step: int):
        """Fully read one step (manifest parsed, every array read); raises
        on any corruption, so callers can fall back."""
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "arrays.npz")
        arrays = {}
        for k in data.files:
            key = k[: -len("@shard0")]
            arr = data[k]
            want = manifest["leaves"].get(key, {}).get("dtype")
            if want == "bfloat16" and arr.dtype == np.uint16:
                arr = bf16_from_words(arr)
            arrays[key] = arr
        return manifest, arrays

    def load_arrays(self, step: Optional[int] = None):
        """Load one step's raw (manifest, flat arrays) without a
        ``target_like`` tree, for consumers whose structure is in the
        arrays themselves (the segmented-index checkpoint). Keys are the
        flat tree paths (``a/b/c``); values are host numpy arrays, except a
        leaf saved as bfloat16, which comes back as a CPU
        ``torch.bfloat16`` tensor.

        With no explicit ``step``, unreadable steps are skipped with a
        warning and the newest readable step is returned: a damaged latest
        checkpoint degrades recovery to the previous one. An explicit
        ``step`` still raises."""
        self.wait()
        self._recover_interrupted_publish()
        if step is not None:
            return self._read_step(step)
        for s in reversed(self.all_steps()):
            try:
                return self._read_step(s)
            except Exception as e:      # noqa: BLE001 - fall back + warn
                warnings.warn(
                    f"skipping unreadable checkpoint step {s} "
                    f"under {self.dir}: {e!r}"
                )
        raise FileNotFoundError(f"no readable checkpoints under {self.dir}")

    def restore(self, target_like, step: Optional[int] = None,
                device: DeviceLike = None, shardings=None):
        """Restore into the structure of ``target_like``: each leaf a torch
        tensor on ``device`` (CUDA by default) of the target leaf's dtype.
        ``shardings`` (the reference's resharding onto another mesh) has no
        counterpart on one card and raises ``ValueError``."""
        if shardings is not None:
            raise ValueError("shardings= reshards onto a JAX device mesh; the "
                             "port restores onto one device (pass device=)")
        dev = resolve_device(device)
        self.wait()
        self._recover_interrupted_publish()
        if step is None:
            # the unreadable-step fallback of load_arrays: the newest step
            # whose npz opens
            for s in reversed(self.all_steps()):
                try:
                    data = np.load(self.dir / f"step_{s:09d}" / "arrays.npz")
                    step = s
                    break
                except Exception as e:  # noqa: BLE001 - fall back + warn
                    warnings.warn(
                        f"skipping unreadable checkpoint step {s} "
                        f"under {self.dir}: {e!r}"
                    )
            if step is None:
                raise FileNotFoundError(
                    f"no readable checkpoints under {self.dir}"
                )
        else:
            data = np.load(self.dir / f"step_{step:09d}" / "arrays.npz")
        try:
            stored = json.loads(
                (self.dir / f"step_{step:09d}" / "manifest.json").read_text()
            )["leaves"]
        except (OSError, ValueError, KeyError):
            stored = {}
        out = {}
        for key, like in _flatten(target_like).items():
            arr = data[f"{key}@shard0"]
            want = getattr(like, "dtype", None)
            if arr.dtype == np.uint16 and (
                    stored.get(key, {}).get("dtype") == "bfloat16"
                    or (want is not None and is_bf16(want))):
                t = bf16_from_words(arr)
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
            if want is not None:
                t = t.to(_torch_dtype(want))
            out[key] = t.to(dev)
        return _unflatten(target_like, out)
