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
