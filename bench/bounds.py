"""The least time each kernel could take on the work these inputs need.

A bound is the larger of the operations at the part's peak rate for their
type and the bytes at its HBM rate, each input byte read once and each
output byte written once.  The counts follow what the data needs (real
rows, real candidates, real items, real rules), never the program's padding,
so the same work is counted whatever kernel implements it.  The arithmetic
is that of the port's smoke run (its ``bound``, ``k1_main_shape``,
``k3_main_shape`` and ``k2_bound``), frozen here.
"""

from __future__ import annotations

import math


def _bound(byte_count: float, ops: float, op_rate: float, peaks: dict) -> float:
    return max(byte_count / peaks["hbm"], ops / op_rate)


def passes(candidates: int, per_pass: int) -> list[int]:
    """The real candidates of each pass of a level."""
    return [min(per_pass, candidates - s) for s in range(0, candidates, per_pass)]


def k3_pass_s(rows: int, live: int, items: int, peaks: dict, operand_bytes: int = 2) -> float:
    """K3, one dense pass: 2·N·K·I operations on bf16 operands; the DB and
    the candidates read once, the counts and lengths once."""
    return _bound(operand_bytes * (rows + live) * items + 4 * 2 * live, 2 * rows * live * items,
                  peaks["bf16"], peaks)


def k1_launch_s(rows: int, live: int, k: int, words: int, peaks: dict) -> float:
    """K1, one packed chunk launch: an AND per candidate item per 32 rows and
    a popcount (four int32 operations) per candidate per 32 rows; the chunk's
    words and the candidates' words read once, counts and lengths once."""
    nb = math.ceil(rows / 32)
    ops = live * k * nb + 4 * live * nb
    return _bound(4 * (rows * words + live * words + 2 * live), ops, peaks["int32"], peaks)


def k2_launch_s(baskets: int, rules: int, ante_words: int, words: int, peaks: dict) -> float:
    """K2, one launch: a word test per basket per antecedent word that holds
    a bit (``ante_words`` over all real rules); the baskets, both rule
    bitsets, lengths and scores read once, the (B, 32·W) float32 scores
    written once.  The matched rules' flops (two per matched consequent
    item) are below 1% of the byte term at these shapes and are left out,
    which can only lower the bound."""
    byte_count = 4 * (baskets * words + 2 * rules * words + 2 * rules + baskets * 32 * words)
    return _bound(byte_count, baskets * ante_words, peaks["int32"], peaks)
