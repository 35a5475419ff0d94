"""Lloyd k-means for IVF index training, in PyTorch on the device.

Same algorithm as the reference: greedy farthest-point seeding on a
subsample of at most 4096 rows, a fixed number of Lloyd iterations, and
empty clusters re-seeded at the row farthest from its center. The
reference draws its subsample and first seed with JAX's PRNG, which
PyTorch cannot reproduce, so this port draws them from
``numpy.random.default_rng(seed)``: the centers are not the reference's.

Every pass over the rows is chunked, so the ``[n, k]`` distance matrix
never has to fit at once. Cluster sums are a one-hot product, not
atomics, so a run on the card is deterministic.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


def _pairwise_sq_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, d] x [m, d] -> [n, m] squared L2 distances."""
    an = (a * a).sum(1)[:, None]
    bn = (b * b).sum(1)[None, :]
    return an - 2.0 * (a @ b.T) + bn


def _row_chunk(k: int) -> int:
    """Rows per pass so that one [rows, k] fp32 block stays near 256 MB."""
    return max(1, (1 << 26) // max(k, 1))


def assign_nearest(x: torch.Tensor, centers: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin center [n] int64, min squared distance [n]), row-chunked."""
    step = _row_chunk(centers.shape[0])
    idx, mind = [], []
    for lo in range(0, x.shape[0], step):
        d = _pairwise_sq_l2(x[lo:lo + step], centers)
        m, a = d.min(dim=1)
        idx.append(a)
        mind.append(m)
    return torch.cat(idx), torch.cat(mind)


def _init_centers(xs: torch.Tensor, k: int, first: int) -> torch.Tensor:
    """Greedy farthest-point seeding over the subsample ``xs``."""
    centers = torch.zeros((k, xs.shape[1]), dtype=xs.dtype, device=xs.device)
    centers[0] = xs[first]
    mind = _pairwise_sq_l2(xs, centers[:1])[:, 0]
    for i in range(1, k):
        nxt = torch.argmax(mind)
        centers[i] = xs[nxt]
        mind = torch.minimum(mind, _pairwise_sq_l2(xs, xs[nxt][None])[:, 0])
    return centers


def kmeans_fit(
    x: torch.Tensor, k: int, iters: int = 12, seed: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centers [k, d], assignment [n] int64) on ``x``'s device."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    sub = min(n, 4096)
    perm = torch.as_tensor(rng.permutation(n)[:sub], device=x.device)
    centers = _init_centers(x[perm], k, int(rng.integers(sub)))
    step = _row_chunk(k)
    for _ in range(iters):
        sums = torch.zeros_like(centers)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device)
        far_d = torch.full((), -1.0, dtype=x.dtype, device=x.device)
        far_i = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo in range(0, n, step):
            xc = x[lo:lo + step]
            d = _pairwise_sq_l2(xc, centers)
            mind, assign = d.min(dim=1)
            one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
            counts += one_hot.sum(0)
            sums += one_hot.T @ xc
            m, i = mind.max(dim=0)
            better = m > far_d
            far_d = torch.where(better, m, far_d)
            far_i = torch.where(better, i + lo, far_i)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, x[far_i][None, :])
    assign, _ = assign_nearest(x, centers)
    return centers, assign



def kmeans_fit_np(x: np.ndarray, k: int, iters: int = 12, seed: int = 0, *,
                  device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`kmeans_fit` from numpy to numpy: the rows as f32 on
    ``device`` (CUDA by default), the centers f32 [k, d] and the assignment
    int32 [n] back on the host, the reference's dtypes."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
    c, a = kmeans_fit(xt, k, iters, seed)
    return c.cpu().numpy(), a.to(torch.int32).cpu().numpy()
