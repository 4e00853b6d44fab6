import shutil

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card and nvcc; skips without them")


@pytest.fixture(autouse=True)
def _few_threads():
    """The benchmark's tests drive whole dry runs; one intra-op thread keeps
    them from crowding the other workers of a parallel test run."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """The data files of the benchmark in a directory of their own, which
    the harness then reads instead of ``bench/``."""
    from bench import harness

    copy = tmp_path / "bench"
    for kind in ("workloads", "configs", "traffic", "metrics", "drivers"):
        shutil.copytree(harness.BENCH / kind, copy / kind, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "BENCH", copy)
    return copy
