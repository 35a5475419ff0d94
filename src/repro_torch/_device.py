"""Device resolution: CUDA unless the caller names another device."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; anything else as given, a CUDA
    device always with its index (``cuda`` → ``cuda:0``), so that devices
    compare equal to the ``.device`` of the tensors placed on them.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and absent: nothing drops to the CPU on its own. The first
    CUDA use turns TF32 off for matrix products and convolutions, so the
    k-means, oracle and brute-force products run in full fp32.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device (none is available); "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
