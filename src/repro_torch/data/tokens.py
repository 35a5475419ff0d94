"""Deterministic synthetic token pipeline for LM training.

The port of ``repro.data.tokens``, the same numpy code: every batch
equals the reference's bit for bit.

Produces sharded `(tokens, targets)` batches without touching disk or
network. The stream is a stateless function of (seed, step, position), so:

* every data-parallel host slices the same logical global batch — the
  pipeline is *elastic* (resuming with a different DP size yields the same
  global stream), and
* restart-after-failure is exact: the step index is the only state.

Sequences are Zipf-distributed token ids with short-range structure
(a copy-and-shift process) so a small LM has learnable signal — loss drops
measurably within a few hundred steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def global_batch_at(self, step: int) -> np.ndarray:
        """Full global batch [global_batch, seq_len+1] of int32 (inputs+shifted)."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s = self.global_batch, self.seq_len + 1
        # Zipfian marginals, clipped to vocab.
        raw = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tok = np.minimum(raw, self.vocab_size - 1).astype(np.int32)
        # Inject copy structure: second half repeats first half for a subset
        # of rows — gives the model an in-context pattern to learn.
        half = s // 2
        copy_rows = rng.random(b) < 0.5
        tok[copy_rows, half : 2 * half] = tok[copy_rows, :half]
        return tok

    def shard_at(self, step: int, dp_rank: int, dp_size: int) -> np.ndarray:
        """This host's slice of the global batch (contiguous row block)."""
        assert self.global_batch % dp_size == 0, (self.global_batch, dp_size)
        per = self.global_batch // dp_size
        g = self.global_batch_at(step)
        return g[dp_rank * per : (dp_rank + 1) * per]

    def batch_for_step(self, step: int, dp_rank: int = 0, dp_size: int = 1):
        """Returns dict(tokens=[b, S], targets=[b, S]) for the step."""
        chunk = self.shard_at(step, dp_rank, dp_size)
        return {"tokens": chunk[:, :-1], "targets": chunk[:, 1:]}
