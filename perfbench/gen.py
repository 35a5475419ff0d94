"""The benchmark's inputs, made from ``--seed``.

One generator serves every configuration and every traffic mix: the
configuration file gives the corpus (rows, width, mixture), the traffic
file the query distribution (skew on the hottest components) and the
closed loop (clients, queries a request). The same seed gives the same
bits on the same device: the corpus and the centroids come from one
``torch.Generator`` on the device, in a fixed order, and the centroids'
Lloyd steps sum with a one-hot product rather than with atomics.

The corpus follows the repository's own synthetic family (a Gaussian
mixture of unit-norm component centres with a lognormal per-row radius,
``repro_torch.data.vectors.make_dataset``), drawn here on the device.
Queries are drawn by the same process, fresh for every request, from a
stream of each client's own on the host: no query repeats and none is a
corpus row, as in the TEXMEX sets, whose queries are held out from the
base.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ROW_BLOCK = 1 << 17          # rows drawn per call
CLIENT_STREAM, CHECK_STREAM = 1, 2


@dataclass
class Inputs:
    """The data both sides are handed, float32 on the device: the corpus
    rows ``x`` [n, D], the IVF centroids [nlist, D] and the mixture's
    component centres [C, D], from which the queries are drawn."""

    x: torch.Tensor
    centroids: torch.Tensor
    centres: torch.Tensor


def _seed63(*key: int) -> int:
    return int(np.random.SeedSequence([int(k) % (1 << 63) for k in key])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def mixture_rows(centres: torch.Tensor, comp: torch.Tensor, spread: float,
                 g: torch.Generator) -> torch.Tensor:
    """Rows of the components ``comp``: the component's centre plus
    Gaussian noise of norm about ``spread`` times a lognormal radius."""
    n, d = comp.shape[0], centres.shape[1]
    radius = spread * torch.exp(0.5 * torch.randn((n, 1), generator=g, device=centres.device))
    noise = torch.randn((n, d), generator=g, device=centres.device)
    return centres[comp] + noise * (radius / math.sqrt(d))


def make_corpus(cfg: dict, g: torch.Generator, device):
    """(rows [n, D], component centres [C, D]); each row's component is
    uniform over the mixture."""
    mix = cfg["assumed"]["mixture"]
    n, d, c = cfg["n_base"], cfg["dim"], mix["components"]
    centres = torch.randn((c, d), generator=g, device=device)
    centres /= centres.norm(dim=1, keepdim=True)
    labels = torch.randint(c, (n,), generator=g, device=device)
    x = torch.empty((n, d), dtype=torch.float32, device=device)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        x[lo:hi] = mixture_rows(centres, labels[lo:hi], mix["spread"], g)
    return x, centres


def make_centroids(cfg: dict, x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """``nlist`` centroids: seeded rows of a subsample, then a few Lloyd
    steps over that subsample (an empty list keeps its centroid)."""
    spec = cfg["assumed"]["centroids"]
    nlist = cfg["nlist"]
    sub = x[torch.randperm(x.shape[0], generator=g, device=x.device)[:spec["subsample"]]]
    cent = sub[:nlist].clone()
    for _ in range(spec["lloyd_iters"]):
        d = (sub * sub).sum(1)[:, None] - 2.0 * (sub @ cent.T) + (cent * cent).sum(1)[None, :]
        onehot = torch.nn.functional.one_hot(d.argmin(1), nlist).to(sub.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ sub
        cent = torch.where((counts > 0)[:, None], sums / counts.clamp(min=1.0)[:, None], cent)
    return cent


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    g = generator(seed, device)
    x, centres = make_corpus(cfg, g, device)
    return Inputs(x=x, centroids=make_centroids(cfg, x, g), centres=centres)


def component_weights(traffic: dict, c: int) -> torch.Tensor:
    """The chance of each component for a query: ``skew`` of the mass
    on the ``hot_fraction`` first components, the rest uniform."""
    n_hot = max(1, int(round(traffic["hot_fraction"] * c)))
    p = torch.full((c,), (1.0 - traffic["skew"]) / c, dtype=torch.float64)
    p[:n_hot] += traffic["skew"] / n_hot
    return p


def request_queries(cfg: dict, traffic: dict, centres: torch.Tensor, seed: int, client: int):
    """Client ``client``'s endless sequence of requests, each
    ``queries_per_request`` fresh float32 query rows [n, D] (numpy),
    drawn on the host from the client's own stream of the seed:
    every seed sends the same sizes, and no two queries are alike."""
    centres = centres.detach().to("cpu", torch.float32)
    g = generator(_seed63(seed, CLIENT_STREAM, client), "cpu")
    p = component_weights(traffic, centres.shape[0])
    per, spread = traffic["queries_per_request"], cfg["assumed"]["mixture"]["spread"]
    while True:
        comp = torch.multinomial(p, per, replacement=True, generator=g)
        yield mixture_rows(centres, comp, spread, g).numpy()


def check_sample(seed: int, n: int, size: int) -> np.ndarray:
    """The answers the check compares: ``size`` of ``n`` (all where
    ``n <= size``), drawn from the seed, in ascending order."""
    if n <= size:
        return np.arange(n)
    rng = np.random.default_rng(_seed63(seed, CHECK_STREAM))
    return np.sort(rng.choice(n, size=size, replace=False))
