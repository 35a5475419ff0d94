"""Plain reference of an IVF-Flat search, and the judge of served answers.

The semantics (Faiss ``IVF<nlist>,Flat``, L2): every corpus row lives
in the list of its nearest centroid; a query probes its ``nprobe``
nearest lists; its answer is the exact top ``k`` of the rows of those
lists, ascending by squared L2 distance. The reference works all of it
out again from the raw inputs, in float64, with plain PyTorch. It
imports nothing of the program.

The program computes the same nearest-centroid choices in float32, so a
row or a query that lies within float32 rounding of a boundary may be
placed either way. The reference allows for that and nothing more: a
choice counts as open only where two float64 distances lie within
``gamma = 2 (D + 3) 2^-24 (|a|^2 + max |c|^2)`` of each other, which
bounds the float32 error of ``|a|^2 - 2 a.c + |c|^2`` over D products.
For each query that gives a set of rows certainly probed (L) and a set
possibly probed (U, holding L). An answer is judged against both: its
r-th row, at its true float64 distance, may be no farther than the r-th
of L and no nearer than the r-th of U, and every row it names must be
in U.

Numbers (all maxima over every answer judged):

* ``bad_answers``: answers that are missing, name a row twice, name no
  row, or name a row outside U.
* ``rank_excess``: the widest gap by which an answer's r-th distance
  lies beyond [r-th of U, r-th of L], in units of ``|q|^2 + |x|^2``.
* ``score_err``: the widest gap between a served score and the true
  distance of the row it names, in the same units.

:class:`Control` is the reference put in the program's place one
precision below the configuration's float32: every product in TF32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

U32 = 2.0 ** -24            # float32 unit roundoff
ROW_BLOCK = 1 << 15
QUERY_BLOCK = 64


def gamma(dim: int) -> float:
    """The float32 error allowance of one expanded distance, per unit of
    ``|a|^2 + max |c|^2``."""
    return 2.0 * (dim + 3) * U32


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * a).sum(1)[:, None] - 2.0 * (a @ b.T) + (b * b).sum(1)[None, :]


@dataclass
class Lists:
    """Each row's list (its nearest centroid) and, for the few rows that
    lie within rounding of two or more centroids, every list they may be
    in: ``amb_rows`` [m] and ``amb_lists`` [m, w] (-1 padded)."""

    of_row: torch.Tensor
    amb_rows: torch.Tensor
    amb_lists: torch.Tensor


def assign_lists(x: torch.Tensor, cent: torch.Tensor) -> Lists:
    c64 = cent.double()
    cmax = (c64 * c64).sum(1).max()
    g = gamma(x.shape[1])
    of_row = torch.empty(x.shape[0], dtype=torch.long, device=x.device)
    amb_r, amb_l = [], []
    for lo in range(0, x.shape[0], ROW_BLOCK):
        xb = x[lo:lo + ROW_BLOCK].double()
        d = _sqdist(xb, c64)
        two, idx = torch.topk(d, 2, dim=1, largest=False)
        of_row[lo:lo + xb.shape[0]] = idx[:, 0]
        slack = 2.0 * g * ((xb * xb).sum(1) + cmax)
        amb = torch.nonzero(two[:, 1] - two[:, 0] <= slack).flatten()
        for r in amb.tolist():
            ls = torch.nonzero(d[r] <= two[r, 0] + slack[r]).flatten()
            amb_r.append(lo + r)
            amb_l.append(ls)
    w = max((len(ls) for ls in amb_l), default=1)
    amb_lists = torch.full((len(amb_l), w), -1, dtype=torch.long, device=x.device)
    for i, ls in enumerate(amb_l):
        amb_lists[i, :len(ls)] = ls
    return Lists(of_row, torch.tensor(amb_r, dtype=torch.long, device=x.device), amb_lists)


def probe_sets(q: torch.Tensor, cent: torch.Tensor, nprobe: int):
    """(certain [nq, nlist] bool, possible [nq, nlist] bool, probes
    [nq, nprobe] long): a list is certainly probed when it beats the
    (nprobe+1)-th by more than twice the rounding allowance, possibly
    probed when it is within that of the nprobe-th."""
    c64 = cent.double()
    q64 = q.double()
    d = _sqdist(q64, c64)
    srt, idx = torch.sort(d, dim=1)
    slack = 2.0 * gamma(q.shape[1]) * ((q64 * q64).sum(1) + (c64 * c64).sum(1).max())
    nth = srt[:, nprobe - 1]
    nxt = srt[:, nprobe] if nprobe < d.shape[1] else torch.full_like(nth, float("inf"))
    certain = d < (nxt - slack)[:, None]
    possible = d <= (nth + slack)[:, None]
    return certain, possible, idx[:, :nprobe]


def _row_membership(sets: torch.Tensor, lists: Lists, rows: Optional[torch.Tensor], all_of: bool):
    """[nq, n] (or [nq, len(rows)]) bool: row in a list of ``sets``. An
    open row counts where all (``all_of``) or any of its lists do."""
    of = lists.of_row if rows is None else lists.of_row[rows]
    member = sets[:, of]
    if lists.amb_rows.numel():
        safe = lists.amb_lists.clamp(min=0)
        hit = sets[:, safe] | (lists.amb_lists < 0)[None] if all_of else (
            sets[:, safe] & (lists.amb_lists >= 0)[None])
        amb = hit.all(2) if all_of else hit.any(2)          # [nq, m]
        if rows is None:
            member[:, lists.amb_rows] = amb
        else:
            pos = torch.searchsorted(lists.amb_rows, rows).clamp(max=lists.amb_rows.numel() - 1)
            is_amb = lists.amb_rows[pos] == rows
            member = torch.where(is_amb[None], amb[:, pos], member)
    return member


@dataclass
class Truth:
    """Per query: the k nearest distances over L and over U, the
    possible-probe table and the probes."""

    d_certain: torch.Tensor      # [nq, k] float64
    d_possible: torch.Tensor     # [nq, k] float64
    possible: torch.Tensor       # [nq, nlist] bool
    probes: torch.Tensor         # [nq, nprobe] long
    lists: Lists


def reference(x: torch.Tensor, cent: torch.Tensor, q: torch.Tensor,
              nprobe: int, k: int) -> Truth:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lists = assign_lists(x, cent)
        certain, possible, probes = probe_sets(q, cent, nprobe)
        x64n = (x.double() ** 2).sum(1)
        d_l = torch.empty((q.shape[0], k), dtype=torch.float64, device=x.device)
        d_u = torch.empty_like(d_l)
        for lo in range(0, q.shape[0], QUERY_BLOCK):
            qb = q[lo:lo + QUERY_BLOCK].double()
            d = torch.empty((qb.shape[0], x.shape[0]), dtype=torch.float64, device=x.device)
            for r0 in range(0, x.shape[0], ROW_BLOCK * 8):
                xb = x[r0:r0 + ROW_BLOCK * 8].double()
                d[:, r0:r0 + xb.shape[0]] = ((qb * qb).sum(1)[:, None] - 2.0 * (qb @ xb.T)
                                             + x64n[None, r0:r0 + xb.shape[0]])
            cert = _row_membership(certain[lo:lo + QUERY_BLOCK], lists, None, True)
            poss = _row_membership(possible[lo:lo + QUERY_BLOCK], lists, None, False)
            inf = torch.tensor(float("inf"), dtype=torch.float64, device=x.device)
            d_l[lo:lo + qb.shape[0]] = torch.topk(torch.where(cert, d, inf), k, dim=1,
                                                  largest=False).values
            d_u[lo:lo + qb.shape[0]] = torch.topk(torch.where(poss, d, inf), k, dim=1,
                                                  largest=False).values
        return Truth(d_l, d_u, possible, probes, lists)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


ANSWER_BLOCK = 1 << 14


def judge(x: torch.Tensor, q: torch.Tensor, truth: Truth, which: torch.Tensor,
          ids: torch.Tensor, scores: torch.Tensor, missing: int = 0) -> dict:
    """The numbers for answers ``ids`` / ``scores`` [A, k] to the queries
    ``q[which]`` [A] (all on x's device); ``missing`` answers never
    came."""
    n = x.shape[0]
    bad = int(missing)
    excess = torch.zeros((), dtype=torch.float64, device=x.device)
    serr = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, which.shape[0], ANSWER_BLOCK):
        p = which[lo:lo + ANSWER_BLOCK]
        i = ids[lo:lo + ANSWER_BLOCK].long()
        s = scores[lo:lo + ANSWER_BLOCK].double()
        valid = (i >= 0) & (i < n)
        safe = torch.where(valid, i, 0)
        srt = torch.sort(safe, dim=1).values
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        # every named row in a possibly probed list of its query
        poss = _row_membership_pairs(truth.possible, truth.lists, p, safe)
        ok = valid.all(1) & ~dup & poss.all(1) & torch.isfinite(s).all(1)
        bad += int((~ok).sum())
        qv = q[p].double()                                   # [a, D]
        xv = x[safe].double()                                # [a, k, D]
        dtrue = ((xv - qv[:, None, :]) ** 2).sum(2)
        scale = (qv * qv).sum(1)[:, None] + (xv * xv).sum(2)
        over = torch.maximum(dtrue - truth.d_certain[p], truth.d_possible[p] - dtrue).clamp(min=0)
        okr = ok[:, None]
        zero = torch.zeros((), dtype=torch.float64, device=x.device)
        excess = torch.maximum(excess, torch.where(okr, over / scale, zero).max())
        serr = torch.maximum(serr, torch.where(okr, (s - dtrue).abs() / scale, zero).max())
    return {"bad_answers": bad, "rank_excess": float(excess), "score_err": float(serr)}


def _row_membership_pairs(possible: torch.Tensor, lists: Lists, p: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """[a, k] bool: row ``rows[a, j]`` lies in a possibly probed list of
    query ``p[a]``."""
    member = possible[p[:, None], lists.of_row[rows]]
    if lists.amb_rows.numel():
        pos = torch.searchsorted(lists.amb_rows, rows).clamp(max=lists.amb_rows.numel() - 1)
        is_amb = lists.amb_rows[pos] == rows
        al = lists.amb_lists[pos]                                # [a, k, w]
        any_poss = (possible[p[:, None, None], al.clamp(min=0)] & (al >= 0)).any(2)
        member = torch.where(is_amb, any_poss, member)
    return member


class Control:
    """The reference put in the program's place one precision below the
    configuration's float32: the lists, the probes and the top-k in
    float32 with every matrix product in TF32 (on the CPU, ``emulate``:
    the operands rounded to TF32's 10-bit mantissa first). The lists
    are worked out once, from the inputs."""

    QUERY_BLOCK = 256

    def __init__(self, x: torch.Tensor, cent: torch.Tensor, nprobe: int,
                 emulate: bool = False):
        self.x, self.cent, self.nprobe = x, cent, nprobe
        self.rnd = _tf32 if emulate else (lambda t: t)
        with _tf32_products():
            self.of_row = torch.cat([self._dist(x[lo:lo + ROW_BLOCK], cent).argmin(1)
                                     for lo in range(0, x.shape[0], ROW_BLOCK)])

    def _dist(self, a, b):
        return ((a * a).sum(1)[:, None] - 2.0 * (self.rnd(a) @ self.rnd(b).T)
                + (b * b).sum(1)[None, :])

    def search(self, q: torch.Tensor, k: int):
        """(ids [nq, k] long, scores [nq, k] float32) of queries ``q``."""
        x = self.x
        with _tf32_products():
            probes = torch.topk(self._dist(q, self.cent), self.nprobe, dim=1,
                                largest=False).indices
            ids = torch.empty((q.shape[0], k), dtype=torch.long, device=x.device)
            sc = torch.empty((q.shape[0], k), dtype=torch.float32, device=x.device)
            for lo in range(0, q.shape[0], self.QUERY_BLOCK):
                qb = q[lo:lo + self.QUERY_BLOCK]
                probed = torch.zeros((qb.shape[0], self.cent.shape[0]), dtype=torch.bool,
                                     device=x.device)
                probed.scatter_(1, probes[lo:lo + self.QUERY_BLOCK], True)
                d = torch.cat([self._dist(qb, x[r0:r0 + ROW_BLOCK * 8])
                               for r0 in range(0, x.shape[0], ROW_BLOCK * 8)], dim=1)
                d = torch.where(probed[:, self.of_row], d, torch.inf)
                top = torch.topk(d, k, dim=1, largest=False)
                ids[lo:lo + qb.shape[0]] = top.indices
                sc[lo:lo + qb.shape[0]] = top.values
        return ids, sc


@contextlib.contextmanager
def _tf32_products():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (nearest, ties away)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)
