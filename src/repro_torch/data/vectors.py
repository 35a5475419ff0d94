"""Synthetic vector corpora for ANNS experiments.

``make_dataset``/``make_queries`` are numpy and bit-identical to the
reference's generators for the same arguments. ``brute_force_topk``
runs in PyTorch on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclass
class VectorDataset:
    """A corpus plus generation metadata."""

    x: np.ndarray                  # [NB, D] float32 base vectors
    centers: np.ndarray            # [C, D] mixture centers used for generation
    labels: np.ndarray             # [NB] generating component of each vector
    seed: int

    @property
    def nb(self) -> int:
        return int(self.x.shape[0])

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])


def make_dataset(
    nb: int = 20_000,
    dim: int = 64,
    n_components: int = 32,
    spread: float = 0.25,
    seed: int = 0,
    component_weights: Optional[np.ndarray] = None,
) -> VectorDataset:
    """Gaussian-mixture corpus with a lognormal per-point radius; ``spread``
    is the intra-cluster noise norm relative to unit-norm centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_components, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if component_weights is None:
        component_weights = np.full((n_components,), 1.0 / n_components)
    component_weights = np.asarray(component_weights, dtype=np.float64)
    component_weights = component_weights / component_weights.sum()
    labels = rng.choice(n_components, size=nb, p=component_weights)
    radius = spread * np.exp(0.5 * rng.normal(size=(nb, 1)))
    noise = (radius / np.sqrt(dim)) * rng.normal(size=(nb, dim))
    x = centers[labels] + noise.astype(np.float32)
    return VectorDataset(x=x.astype(np.float32), centers=centers, labels=labels, seed=seed)


def make_queries(
    ds: VectorDataset,
    nq: int = 256,
    skew: float = 0.0,
    hot_fraction: float = 0.125,
    noise: float = 0.25,
    seed: int = 1,
    tail_fraction: float = 0.0,
) -> np.ndarray:
    """Perturbed corpus points of components drawn with ``skew`` mass on
    the ``hot_fraction`` hottest components (``tail_fraction`` > 0 draws
    from the furthest-from-center rows of each component)."""
    rng = np.random.default_rng(seed)
    c = ds.centers.shape[0]
    n_hot = max(1, int(round(hot_fraction * c)))
    p = np.full((c,), (1.0 - skew) / c, dtype=np.float64)
    p[:n_hot] += skew / n_hot
    p /= p.sum()
    comp = rng.choice(c, size=nq, p=p)
    radius = np.linalg.norm(ds.x - ds.centers[ds.labels], axis=1)
    q = np.empty((nq, ds.dim), np.float32)
    for i, ci in enumerate(comp):
        rows = np.nonzero(ds.labels == ci)[0]
        if len(rows) == 0:
            rows = np.arange(ds.nb)
        if tail_fraction > 0:
            order = rows[np.argsort(radius[rows])]
            n_tail = max(1, int(tail_fraction * len(rows)))
            rows = order[-n_tail:]
        src = rows[rng.integers(len(rows))]
        q[i] = ds.x[src]
    jitter = (noise / np.sqrt(ds.dim)) * rng.normal(size=(nq, ds.dim))
    q = q + jitter.astype(np.float32)
    return q.astype(np.float32)


def brute_force_topk(
    x, q, k: int, metric: str = "l2", device: DeviceLike = None,
    chunk: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k ground truth. Returns (indices [NQ,k], scores [NQ,k]).

    Scores are squared-L2 (ascending) or negative inner product. Ties go
    to the lowest index (a stable sort), as ``lax.top_k`` orders them.
    ``x``/``q`` may be numpy arrays or tensors; the work runs on
    ``device`` (CUDA by default), ``chunk`` queries at a time.
    """
    dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
    qt = torch.as_tensor(q, dtype=torch.float32).to(dev)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    xn = (xt * xt).sum(1) if metric == "l2" else None
    idx_out, sc_out = [], []
    for lo in range(0, qt.shape[0], chunk):
        qc = qt[lo:lo + chunk]
        if metric == "l2":
            d = (qc * qc).sum(1)[:, None] - 2.0 * (qc @ xt.T) + xn[None, :]
        else:
            d = -(qc @ xt.T)
        s, i = torch.sort(d, dim=1, stable=True)
        idx_out.append(i[:, :k].cpu())
        sc_out.append(s[:, :k].cpu())
    return torch.cat(idx_out).numpy(), torch.cat(sc_out).numpy()


def recall_at_k(pred_idx: np.ndarray, true_idx: np.ndarray) -> float:
    """Standard recall@k: |pred ∩ true| / k averaged over queries."""
    assert pred_idx.shape == true_idx.shape
    nq, k = pred_idx.shape
    hits = 0
    for i in range(nq):
        hits += len(set(pred_idx[i].tolist()) & set(true_idx[i].tolist()))
    return hits / (nq * k)
