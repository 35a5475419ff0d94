"""Device resolution (CUDA unless the caller names another device), the
serving threads' device binding, and what counts as a device fault."""

from __future__ import annotations

from typing import Optional, Union

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


def bind_device(device: Optional[torch.device]) -> None:
    """Make ``device`` the calling thread's current CUDA device (a thread
    starts on device 0 whatever its parent had); no-op for ``None`` and
    for a device that is not CUDA. Every serving thread calls this before
    it touches the plane's card."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(device)


def is_device_fault(err: BaseException) -> bool:
    """True for an error the card raised: a CUDA error reported by
    PyTorch or a failed kernel launch. The serving plane relays such an
    error to its caller and never retries, degrades or carries on past
    it: the CUDA context may be lost, and a retry on the same card cannot
    give a right answer."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        return True
    msg = str(err)
    return isinstance(err, RuntimeError) and (
        "CUDA error" in msg or " launch failed: " in msg)
