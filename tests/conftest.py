import os

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env():
    """Minimal env for subprocess-spawning tests: repo importable via
    ``PYTHONPATH=src`` (cwd must be REPO_ROOT), and JAX pinned to the CPU
    platform — without it, children on TPU-image containers try TPU-plugin
    init and hang for minutes retrying GCP metadata fetches."""
    return {
        "PYTHONPATH": "src",
        "PATH": "/usr/bin:/bin",
        "HOME": os.environ.get("HOME", "/root"),
        "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
    }


def random_problem(n, i, k, seed=0, density=0.3):
    """Random (transactions, candidates, lengths) triple for counting tests."""
    rng = np.random.default_rng(seed)
    t = (rng.random((n, i)) < density).astype(np.int8)
    sizes = rng.integers(1, min(6, i) + 1, size=k)
    cands = np.zeros((k, i), dtype=np.int8)
    for row, s in enumerate(sizes):
        cands[row, rng.choice(i, size=s, replace=False)] = 1
    return t, cands, cands.sum(1).astype(np.int32)


@pytest.fixture(scope="session")
def small_db():
    """Small deterministic transaction DB shared across tests."""
    from repro.data.synthetic import QuestConfig, gen_transactions

    return gen_transactions(QuestConfig(num_transactions=300, num_items=32, avg_len=7, num_patterns=6, seed=7))


def brute_force_frequent(dense: np.ndarray, min_count: int, max_k: int) -> dict:
    """Oracle: exhaustive frequent-itemset mining via python sets."""
    from itertools import combinations

    rows = [frozenset(np.flatnonzero(r)) for r in dense]
    items = sorted(set().union(*rows)) if rows else []
    out = {}
    prev = {(): None}
    for k in range(1, max_k + 1):
        level = {}
        if k <= 2:
            cands = combinations(items, k)
        else:
            seeds = [set(c) for c in prev]
            cands = {tuple(sorted(s | {b})) for s in seeds for b in items if b not in s}
        for c in cands:
            cs = set(c)
            s = sum(1 for r in rows if cs <= r)
            if s >= min_count:
                level[tuple(c)] = s
        if not level:
            break
        out.update(level)
        prev = level
    return out


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card and nvcc; skips without them")
