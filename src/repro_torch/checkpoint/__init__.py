"""Durability: checkpoints of the segmented data plane, the write-ahead
log between them, and crash recovery. The files are the reference's, so
either package recovers the other's."""

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.index_io import load_segmented_index, save_segmented_index
from repro_torch.checkpoint.wal import (
    WriteAheadLog,
    checkpoint_segmented_index,
    read_wal,
    recover_segmented_index,
    replay_wal_into,
)

__all__ = [
    "Checkpointer",
    "save_segmented_index",
    "load_segmented_index",
    "WriteAheadLog",
    "read_wal",
    "replay_wal_into",
    "checkpoint_segmented_index",
    "recover_segmented_index",
]
