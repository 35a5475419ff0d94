"""Host arrays to tensors and back, bfloat16 included.

numpy has no bfloat16 of its own: the reference's bf16 leaves arrive as
``ml_dtypes`` arrays, and a checkpoint stores them as their ``uint16``
words. ``torch.from_numpy`` refuses both, and the port cannot count on
``ml_dtypes`` being installed, so a bf16 leaf crosses as its 16-bit words.
"""

from __future__ import annotations

import numpy as np
import torch


def is_bf16(dtype) -> bool:
    """True for ``torch.bfloat16`` and for a numpy dtype named bfloat16."""
    return dtype == torch.bfloat16 or getattr(dtype, "name", None) == "bfloat16"


def bf16_from_words(arr: np.ndarray) -> torch.Tensor:
    """A CPU bf16 tensor over 16-bit words: an ``ml_dtypes`` bfloat16
    array or the ``uint16`` view of one."""
    arr = np.asarray(arr)
    words = np.ascontiguousarray(arr).view(np.int16).reshape(arr.shape)   # a 0-d array stays 0-d
    return torch.from_numpy(words).view(torch.bfloat16)


def bf16_words(t: torch.Tensor) -> np.ndarray:
    """The ``uint16`` words of a bf16 tensor, on the host."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor sharing ``arr``'s memory where it can; a bfloat16
    array becomes a ``torch.bfloat16`` tensor of the same bits."""
    arr = np.asarray(arr)
    if is_bf16(arr.dtype):
        return bf16_from_words(arr)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
