"""Hybrid retrieval: per-segment BM25 lexical scoring fused with the vector
top-k by reciprocal-rank fusion (RRF), on the host (numpy), as in the
reference.

Each sealed segment builds one immutable :class:`BM25Index` over its
metadata text column on first use (packed-row order, so the vector tier's
excluded-row masks apply to it as they are); the delta buffer is scored
per search. Fusion is by rank, so the two tiers never need commensurable
scores.

>>> import numpy as np
>>> bm = BM25Index(["red shoes", "blue shoes", None, "red hat"])
>>> s = bm.scores("red shoes")
>>> bool(s[0] > s[1] > 0), bool(s[2] == 0.0)
(True, True)
>>> sc, ids = reciprocal_rank_fusion([np.array([[10, 11, 12]]),
...                                   np.array([[12, 13, -1]])], k=3)
>>> int(ids[0, 0])     # ranked by both tiers: fused to the top
12
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")


def tokenize(text: Optional[str]) -> List[str]:
    """Lowercase alphanumeric tokens ('' / None → no tokens)."""
    return _TOKEN.findall(text.lower()) if text else []


class BM25Index:
    """Okapi BM25 over one row-aligned text column.

    Rows follow the owning corpus's packed order; :meth:`scores` returns
    a dense [n] array, so callers apply the masks they already hold for
    the vector tier. The postings are built with numpy (one sort of the
    (term, row) pairs), and score as the reference's do, in the same
    arithmetic.
    """

    def __init__(self, texts: Sequence[Optional[str]],
                 k1: float = 1.5, b: float = 0.75):
        self.k1, self.b = float(k1), float(b)
        self.n = len(texts)
        toks = [tokenize(t) for t in texts]
        self.doc_len = np.fromiter((len(t) for t in toks), np.float32, self.n)
        vocab: Dict[str, int] = {}
        term = np.fromiter((vocab.setdefault(w, len(vocab)) for t in toks for w in t),
                           np.int64)
        row = np.repeat(np.arange(self.n, dtype=np.int64),
                        self.doc_len.astype(np.int64))
        pairs, tf = np.unique(term * max(self.n, 1) + row, return_counts=True)
        p_term, p_row = np.divmod(pairs, max(self.n, 1))
        ends = np.searchsorted(p_term, np.arange(len(vocab)), side="right")
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        tf = tf.astype(np.float32)
        self.avg_len = float(self.doc_len.mean()) if self.n else 0.0
        # term -> (rows int64[m] ascending, tf float32[m])
        self.postings: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            w: (p_row[starts[t]:ends[t]], tf[starts[t]:ends[t]])
            for w, t in vocab.items()
        }

    def memory_bytes(self) -> int:
        """Host bytes of the postings and document lengths."""
        out = self.doc_len.nbytes
        for rows, tf in self.postings.values():
            out += rows.nbytes + tf.nbytes
        return out

    def scores(self, text: str) -> np.ndarray:
        """BM25 scores [n] (higher = better, 0 = no term match)."""
        out = np.zeros(self.n, np.float32)
        if self.n == 0 or self.avg_len == 0.0:
            return out
        norm = 1.0 - self.b + self.b * self.doc_len / self.avg_len
        for t in tokenize(text):
            post = self.postings.get(t)
            if post is None:
                continue
            rows, tf = post
            df = len(rows)
            idf = np.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            out[rows] += idf * tf * (self.k1 + 1.0) / (
                tf + self.k1 * norm[rows]
            )
        return out

    def topk(self, text: str, k: int,
             excluded: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores descending [≤k], rows [≤k]) of the matching rows that
        are not ``excluded``. Equal scores go to the lower row (a stable
        sort; the reference's ``argpartition`` leaves their order open)."""
        sc = self.scores(text)
        if excluded is not None:
            sc = np.where(excluded[: self.n], 0.0, sc)
        rows = np.nonzero(sc > 0.0)[0]
        rows = rows[np.argsort(-sc[rows], kind="stable")[:k]]
        return sc[rows], rows


def segment_bm25(index) -> Optional[BM25Index]:
    """The sealed segment's lexical tier, built on first use from its
    metadata text column and cached on the immutable index. None when the
    segment carries no texts."""
    meta = index.meta
    if meta is None or meta.texts is None:
        return None
    bm = index.__dict__.get("_bm25")
    if bm is None:
        bm = BM25Index(meta.texts)
        index.__dict__["_bm25"] = bm
    return bm


def reciprocal_rank_fusion(
    ranked_id_lists: Sequence[np.ndarray],
    k: int,
    k_rrf: float = 60.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fuse per-tier ranked id lists into one top-k by RRF.

    Each input is [NQ, K_t] int64, best first, -1-padded. A document's
    fused score is Σ 1/(k_rrf + rank) over the tiers that ranked it; ties
    go to the lower id. Returns (scores [NQ, k] float32 ascending: the
    negated RRF, so "smaller is better, +inf pad" holds; ids [NQ, k]
    int64, -1-padded).
    """
    nq = ranked_id_lists[0].shape[0]
    out_s = np.full((nq, k), np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int64)
    for qi in range(nq):
        fused: Dict[int, float] = {}
        for ids in ranked_id_lists:
            for rank, doc in enumerate(ids[qi]):
                doc = int(doc)
                if doc < 0:
                    continue
                fused[doc] = fused.get(doc, 0.0) + 1.0 / (k_rrf + rank)
        top = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        for j, (doc, s) in enumerate(top):
            out_i[qi, j] = doc
            out_s[qi, j] = -s
    return out_s, out_i
