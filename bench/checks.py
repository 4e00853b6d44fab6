"""The numbers that decide ``correct``: each compares what the timed path
produced with what ``bench/reference`` worked out again from the inputs."""

from __future__ import annotations

import numpy as np

WRONG = 1e9   # a gap that cannot be read (an -inf against a number): wrong


def itemsets_differing(port: dict, ref: dict) -> int:
    """Itemsets in one result and not the other, or with another support."""
    return len(set(port.items()) ^ set(ref.items()))


def _rows(ante, cons, lens, scores) -> np.ndarray:
    ante = np.ascontiguousarray(ante, dtype=np.uint32)
    cons = np.ascontiguousarray(cons, dtype=np.uint32)
    cols = [ante, cons, np.asarray(lens, np.int32).view(np.uint32)[:, None],
            np.asarray(scores, np.float32).view(np.uint32)[:, None]]
    rows = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))).ravel()


def rules_differing(port_host, ref: dict) -> int:
    """Rule rows of the program's rulebook (host columns) that the
    reference does not have, reference rules it lacks, repeated rows, real
    rows out of descending score order, and padding rows that are not inert
    (zero words, length -1, score 0) or that lie among the real rows."""
    ante, cons = np.asarray(port_host.ante_packed), np.asarray(port_host.cons_packed)
    lens, scores = np.asarray(port_host.ante_len), np.asarray(port_host.scores)
    real = lens >= 0
    n_real = int(real.sum())
    port_rows = _rows(ante[real], cons[real], lens[real], scores[real])
    ref_rows = _rows(ref["ante"], ref["cons"], ref["ante_len"], ref["score"])
    port_set, ref_set = set(port_rows.tolist()), set(ref_rows.tolist())
    bad = len(port_set ^ ref_set) + (n_real - len(port_set))
    s = scores[real]
    bad += int((s[1:] > s[:-1]).sum())
    pad = ~real
    bad += int((pad & ((scores != 0) | (lens != -1) | ante.any(1) | cons.any(1))).sum())
    bad += int(pad[:n_real].sum())
    return bad


def answer_gaps(items: np.ndarray, scores: np.ndarray, ref_scores: np.ndarray) -> tuple[float, float, int]:
    """(score gap, rank gap, malformed answers) of (S, k) served items and
    their scores against the reference's (S, I) float64 evidence.

    score gap: the widest ``|served score - reference score of that item|``
    over ``max(1, |reference score|)``; rank gap: the widest amount by which
    the reference's score of the j-th served item lies below the
    reference's j-th best, over ``max(1, |j-th best|)``; malformed: answers
    with an item twice or out of range."""
    s, k = items.shape
    ids = items.astype(np.int64)
    malformed = int(((ids < 0) | (ids >= ref_scores.shape[1])).any(1).sum())
    ids = np.clip(ids, 0, ref_scores.shape[1] - 1)
    srt = np.sort(ids, axis=1)
    malformed += int((srt[:, 1:] == srt[:, :-1]).any(1).sum())
    ref_of = np.take_along_axis(ref_scores, ids, axis=1)
    best = -np.sort(-ref_scores, axis=1)[:, :k]
    served = scores.astype(np.float64)

    def gap(a, b):
        both_inf = np.isneginf(a) & np.isneginf(b)
        with np.errstate(invalid="ignore"):
            d = np.where(both_inf, 0.0, (b - a) / np.maximum(1.0, np.abs(np.where(np.isinf(b), 0, b))))
        return np.where(np.isfinite(d), d, WRONG)

    score_gap = float(np.abs(gap(ref_of, served)).max()) if s else 0.0
    rank_gap = float(gap(ref_of, best).max()) if s else 0.0
    return score_gap, max(0.0, rank_gap), malformed
