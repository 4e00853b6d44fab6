"""What the drivers share: the inputs from the seed, the program's settings
from the configuration, packing, the store, and the timing helpers."""

from __future__ import annotations

import math
import os

import numpy as np

from bench.data import quest

FAILED_LATENCY_S = 3600.0   # a request that failed or got no answer: slower than any answer


def dataset(config: dict) -> np.ndarray:
    """The configuration's data set, dense {0,1} int8 (N, I): fixed by its
    ``data_seed`` (a published data set is one file), whatever the run's
    seed, so every seed mines the same work."""
    data = config["data"]
    return quest.generate(quest.Quest.from_config(data), data["data_seed"])


def fresh_baskets(config: dict, seed_seq: list, rows: int) -> np.ndarray:
    """``rows`` fresh transactions of the data set's pattern pool, from a
    stream of the run's own: dense {0,1} int8."""
    data = config["data"]
    q = quest.Quest.from_config(data)
    pool = quest.patterns(q, np.random.default_rng([data["data_seed"], 0]))
    return quest.transactions(q, pool, np.random.default_rng(seed_seq), rows)


def pack(dense: np.ndarray) -> np.ndarray:
    """Dense {0,1} (R, I) -> (R, ceil(I/32)) uint32, item i at bit i % 32 of
    word i // 32 (the layout the gateway takes pre-packed rows in)."""
    r, i = dense.shape
    words = (i + 31) // 32
    out = np.zeros((r, words), dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    for start in range(0, r, 1 << 14):
        blk = np.zeros((min(1 << 14, r - start), words * 32), dtype=np.uint32)
        blk[:, :i] = dense[start : start + blk.shape[0]]
        out[start : start + blk.shape[0]] = (blk.reshape(-1, words, 32) << shifts).sum(2, dtype=np.uint32)
    return out


def apriori_config(config: dict, route: dict):
    from repro_torch.core.apriori import AprioriConfig

    m = config["mining"]
    return AprioriConfig(min_support=m["min_support"], max_k=m["max_k"],
                         representation=route["representation"],
                         operand_dtype=route.get("operand_dtype", "bf16"))


def write_store(dense: np.ndarray, path: str, shard_rows: int):
    """The rows as the program's on-disk store (packed shards) at ``path``."""
    from repro_torch.data.store import ingest_dense

    os.makedirs(path, exist_ok=True)
    return ingest_dense(dense, path, shard_rows=shard_rows)


def compile_and_place(result, config: dict, device: str):
    """The program's rule compile of a mined result, placed on the device."""
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    m = config["mining"]
    rb = compile_rulebook(result, min_confidence=m["min_confidence"], score=m["score"],
                          num_items=config["data"]["num_items"])
    return place_rulebook(rb, device)


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def quantile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile: the smallest value with at least a
    share ``q`` of the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return float("nan")
    return float(v[max(0, math.ceil(q * v.size) - 1)])


def sample(rng, n: int, size: int) -> np.ndarray:
    return np.sort(rng.choice(n, size=min(size, n), replace=False)) if n else np.zeros(0, np.int64)
