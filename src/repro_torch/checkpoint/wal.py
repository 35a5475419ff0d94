"""Write-ahead log for the mutable segmented data plane: crash
durability between checkpoints.

``save_segmented_index`` makes the sealed state durable, but a crash
between checkpoints would lose every acknowledged upsert/delete since the
last save. The :class:`WriteAheadLog` closes that window:

* **journal**: :meth:`repro_torch.core.SegmentedIndex.attach_wal` makes
  every accepted write append one CRC-framed record (inside the
  data-plane critical section, so log order is apply order) and fsync it
  before the write call returns: *acknowledged implies durable*;
* **rotate**: :func:`checkpoint_segmented_index` persists the plane (the
  checkpoint meta carries the ``wal_seq`` watermark of the last record it
  contains), starts a fresh log file named after the step, and prunes log
  files the checkpoint fully covers;
* **recover**: :func:`recover_segmented_index` is
  ``load_segmented_index`` plus a replay of every record past the
  checkpoint's watermark, tolerant of a *torn final record* (a crash
  mid-``write``): the intact prefix is replayed, the torn tail is
  truncated away, and appending resumes. Records carry global sequence
  numbers, so replay is exact wherever rotation crashed: a record is
  applied at most once, in its original order.

Framing (little-endian), byte for byte the reference's, so either package
reads the other's logs and the same writes give the same file:
``magic "HWAL" | payload_len u32 | seq u64 | crc32(payload) u32`` then the
payload, ``kind u8 (0=upsert 1=delete 2=upsert with metadata) | n u32 |
dim u32 | ids int64[n] | vecs float32[n*dim]`` (vecs absent for deletes;
kind 2 appends the rows' metadata as JSON). A reader stops at the first
frame that fails any check; only a tail can tear, because frames are
appended and fsynced in order. The log is host I/O: nothing here touches
the card, and replay goes through the plane's ordinary writes.

>>> import numpy as np, tempfile
>>> d = tempfile.mkdtemp()
>>> wal = WriteAheadLog(d, sync=False)
>>> wal.append_upsert(np.array([7]), np.ones((1, 4), np.float32))
1
>>> wal.append_delete(np.array([3, 4]))
2
>>> r = read_wal(wal.path)
>>> [(rec.seq, rec.kind) for rec in r.records], r.torn_tail
([(1, 'upsert'), (2, 'delete')], False)
"""

from __future__ import annotations

import os
import re
import struct
import threading
import warnings
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.index_io import (
    load_segmented_index,
    save_segmented_index,
)
from repro_torch.runtime.faults import InjectedFault, fault_point

_MAGIC = b"HWAL"
_HEADER = struct.Struct("<4sIQI")   # magic, payload_len, seq, crc32(payload)
_KIND_UPSERT = 0
_KIND_DELETE = 1
# upsert carrying per-row metadata: the plain-upsert payload followed by a
# JSON-encoded list of per-row dicts. Meta-free upserts keep kind 0, so
# logs written before the metadata store exist byte-identically.
_KIND_UPSERT_META = 2


def _fsync_dir(path: Path) -> None:
    # make a create/rename durable, not just the file contents; best
    # effort on platforms without directory fds
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclass(frozen=True)
class WalRecord:
    """One decoded log record. ``end_offset`` is the byte offset just
    past this record's frame — the crash points the recovery property
    truncates at."""

    seq: int
    kind: str                       # "upsert" | "delete"
    ids: np.ndarray                 # [n] int64
    vecs: Optional[np.ndarray]      # [n, D] float32 (None for deletes)
    end_offset: int
    meta: Optional[list] = None     # [n] per-row metadata dicts, or None


@dataclass
class WalReadResult:
    """Decoded file: the intact record prefix plus what the tail looked
    like. ``torn_tail`` is True when trailing bytes failed framing/CRC —
    ``valid_bytes`` is where the intact prefix ends (truncate there to
    repair)."""

    records: List[WalRecord] = field(default_factory=list)
    torn_tail: bool = False
    valid_bytes: int = 0

    @property
    def last_seq(self) -> int:
        return self.records[-1].seq if self.records else 0


def _encode(kind: int, ids: np.ndarray, vecs: Optional[np.ndarray],
            meta: Optional[list] = None) -> bytes:
    ids = np.ascontiguousarray(ids, np.int64)
    dim = 0 if vecs is None else int(vecs.shape[1])
    out = [struct.pack("<BII", kind, len(ids), dim), ids.tobytes()]
    if vecs is not None:
        out.append(np.ascontiguousarray(vecs, np.float32).tobytes())
    if kind == _KIND_UPSERT_META:
        import json
        out.append(json.dumps(meta).encode("utf-8"))
    return b"".join(out)


def read_wal(path: Path) -> WalReadResult:
    """Decode one log file, stopping (without raising) at the first
    torn/corrupt frame — the intact prefix is exactly the acknowledged
    writes a crashed process had made durable."""
    res = WalReadResult()
    path = Path(path)
    if not path.exists():
        return res
    buf = path.read_bytes()
    off = 0
    while off + _HEADER.size <= len(buf):
        magic, plen, seq, crc = _HEADER.unpack_from(buf, off)
        start = off + _HEADER.size
        if magic != _MAGIC or start + plen > len(buf):
            break
        payload = buf[start:start + plen]
        if zlib.crc32(payload) != crc:
            break
        kind, n, dim = struct.unpack_from("<BII", payload, 0)
        p = struct.calcsize("<BII")
        ids = np.frombuffer(payload, np.int64, count=n, offset=p).copy()
        vecs = meta = None
        if kind in (_KIND_UPSERT, _KIND_UPSERT_META):
            vecs = np.frombuffer(
                payload, np.float32, count=n * dim, offset=p + ids.nbytes
            ).reshape(n, dim).copy()
            if kind == _KIND_UPSERT_META:
                import json
                meta = json.loads(
                    payload[p + ids.nbytes + vecs.nbytes:].decode("utf-8")
                )
        off = start + plen
        res.records.append(WalRecord(
            seq=int(seq),
            kind="delete" if kind == _KIND_DELETE else "upsert",
            ids=ids, vecs=vecs, end_offset=off, meta=meta,
        ))
    res.valid_bytes = off
    res.torn_tail = off < len(buf)
    return res


class WriteAheadLog:
    """Append-only, CRC-framed, fsync'd log of data-plane writes.

    Opening an existing directory continues it: the newest
    ``wal_<step>.log`` is repaired (a torn tail from a previous crash is
    truncated away) and appending resumes with the next global sequence
    number. ``sync=False`` skips the per-record fsync (still flushed) —
    for benchmarks that model group commit; durability tests keep the
    default. Appends are internally locked, but the intended caller is
    :meth:`repro_torch.core.SegmentedIndex.attach_wal`, whose data-plane lock
    already serializes writers (keeping WAL order = apply order)."""

    def __init__(self, directory, sync: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.sync = sync
        self._mu = threading.Lock()
        self._f = None
        files = self.files()
        last_seq = 0
        for p in files:
            r = read_wal(p)
            if r.torn_tail and p == files[-1]:
                # repair: drop the torn final record so appends can't
                # bury it mid-file (it was never acknowledged)
                with open(p, "r+b") as f:
                    f.truncate(r.valid_bytes)
            last_seq = max(last_seq, r.last_seq)
        self._next_seq = last_seq + 1
        step = self._step_of(files[-1]) if files else 0
        self._open(step)

    # ------------------------------------------------------------- files
    @staticmethod
    def _step_of(path: Path) -> int:
        m = re.fullmatch(r"wal_(\d+)\.log", path.name)
        if not m:
            raise ValueError(f"not a wal file: {path}")
        return int(m.group(1))

    def files(self) -> List[Path]:
        """Log files, oldest step first."""
        out = [p for p in self.dir.glob("wal_*.log")
               if re.fullmatch(r"wal_(\d+)\.log", p.name)]
        return sorted(out, key=self._step_of)

    @property
    def path(self) -> Path:
        """The file currently being appended to."""
        return self._path

    @property
    def last_seq(self) -> int:
        """Sequence number of the last acknowledged record (0 if none)."""
        with self._mu:
            return self._next_seq - 1

    def _open(self, step: int) -> None:
        self._path = self.dir / f"wal_{step:09d}.log"
        existed = self._path.exists()
        self._f = open(self._path, "ab")
        if not existed:
            _fsync_dir(self.dir)

    # ------------------------------------------------------------ append
    def _append(self, kind: int, ids, vecs, meta=None) -> int:
        payload = _encode(
            kind, np.asarray(ids, np.int64).reshape(-1), vecs, meta
        )
        with self._mu:
            seq = self._next_seq
            frame = _HEADER.pack(
                _MAGIC, len(payload), seq, zlib.crc32(payload)
            ) + payload
            try:
                fault_point("wal.append", seq=seq)
            except InjectedFault as e:
                if e.kind == "torn":
                    # a power cut mid-write(2): persist a partial frame,
                    # then die — recovery must treat it as never written
                    cut = _HEADER.size + len(payload) // 2
                    self._f.write(frame[:cut])
                    self._f.flush()
                    os.fsync(self._f.fileno())
                raise
            self._f.write(frame)
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self._next_seq = seq + 1
            return seq

    def append_upsert(self, ids, vecs, meta=None) -> int:
        """Journal one acknowledged upsert batch (``meta``: per-row
        metadata dicts, or None); returns its seq."""
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if meta is not None and any(r for r in meta):
            return self._append(
                _KIND_UPSERT_META, ids, vecs,
                [r or None for r in meta],
            )
        return self._append(_KIND_UPSERT, ids, vecs)

    def append_delete(self, ids) -> int:
        """Journal one acknowledged delete batch; returns its seq."""
        return self._append(_KIND_DELETE, ids, None)

    # ----------------------------------------------------------- rotation
    def rotate(self, step: int, prune_up_to_seq: Optional[int] = None) -> Path:
        """Start a fresh ``wal_<step>.log`` (after a checkpoint commit)
        and delete older files whose every record is ≤
        ``prune_up_to_seq`` (i.e. fully contained in that checkpoint).
        Records are never rewritten — a crash anywhere around rotation
        leaves replay exact because recovery filters by sequence
        number, not by file."""
        with self._mu:
            self._f.close()
            self._open(step)
            if prune_up_to_seq is not None:
                for p in self.files():
                    if p == self._path:
                        continue
                    if read_wal(p).last_seq <= prune_up_to_seq:
                        p.unlink()
                _fsync_dir(self.dir)
            return self._path

    def close(self) -> None:
        with self._mu:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


# --------------------------------------------------------------- recovery
def checkpoint_segmented_index(
    ckpt: Checkpointer, data, wal: WriteAheadLog
) -> Path:
    """Durable checkpoint commit: persist the plane (the saved meta
    carries its ``wal_seq`` watermark), then rotate the WAL onto a fresh
    file and prune files the checkpoint fully covers. The watermark is
    read *before* the save, so a write landing concurrently is never
    pruned — worst case it survives in both the checkpoint and a kept
    log file, and replay's sequence filter drops the duplicate."""
    watermark = data.wal_seq
    path = save_segmented_index(ckpt, data)
    step = int(re.fullmatch(r"step_(\d+)", path.name).group(1))
    wal.rotate(step, prune_up_to_seq=watermark)
    return path


def replay_wal_into(data, directory, min_seq: int = 0) -> dict:
    """Apply every WAL record with ``seq > min_seq`` (oldest file first)
    to ``data``. The plane must not have a WAL attached yet — replay
    must not re-journal its own records. Returns a report dict."""
    if data._wal is not None:
        raise RuntimeError("detach the WAL before replaying into the plane")
    replayed = skipped = 0
    torn = False
    wal_dir = Path(directory)
    files = sorted(
        (p for p in wal_dir.glob("wal_*.log")
         if re.fullmatch(r"wal_(\d+)\.log", p.name)),
        key=WriteAheadLog._step_of,
    )
    for p in files:
        r = read_wal(p)
        torn = torn or r.torn_tail
        for rec in r.records:
            if rec.seq <= min_seq:
                skipped += 1
                continue
            if rec.kind == "upsert":
                data.upsert(rec.ids, rec.vecs, meta=rec.meta)
            else:
                data.delete(rec.ids)
            data.wal_seq = rec.seq
            replayed += 1
    return {"replayed": replayed, "skipped": skipped, "torn_tail": torn,
            "files": len(files)}


def recover_segmented_index(
    ckpt: Checkpointer,
    wal_dir,
    cfg=None,
    step: Optional[int] = None,
    sync: bool = True,
    device: DeviceLike = None,
) -> Tuple[object, WriteAheadLog, dict]:
    """Crash recovery: the newest readable checkpoint plus a replay of the
    WAL tail, onto ``device`` (CUDA by default).

    Returns ``(data, wal, report)``: the recovered plane (every
    acknowledged write present, the torn tail of an interrupted final
    record dropped), a repaired :class:`WriteAheadLog` attached to it
    (journaling continues with the next sequence number), and a report of
    what replay did. With no checkpoint on disk the plane is rebuilt from
    ``cfg`` alone (every row lives in the delta until the first
    compaction); without ``cfg`` that raises ``FileNotFoundError``."""
    from repro_torch.core import SegmentedIndex

    try:
        data = load_segmented_index(ckpt, step, device=device)
    except FileNotFoundError:
        if cfg is None:
            raise
        warnings.warn(
            f"no checkpoint under {ckpt.dir}; recovering from WAL alone"
        )
        data = SegmentedIndex(cfg, (), device=device)
    report = replay_wal_into(data, wal_dir, min_seq=data.wal_seq)
    wal = WriteAheadLog(wal_dir, sync=sync)     # repairs any torn tail
    data.attach_wal(wal)
    return data, wal, report
