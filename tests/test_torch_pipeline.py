"""PyTorch port: ``repro_torch.data.pipeline.ShardedBatchIterator`` on the
CPU — order, close() joining a blocked worker, errors reaching the consumer,
the context manager (mirrors ``tests/test_pipeline.py``) — and that neither
importing the out-of-core modules nor a CPU pipeline creates a CUDA stream.
The pinned CUDA ring is held by the card tests in ``test_torch_cuda.py``."""

import importlib.util
import itertools
import sys
import time

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro_torch.data.pipeline import ShardedBatchIterator  # noqa: E402


def _batches(n, rows=4, cols=3):
    for i in range(n):
        yield np.full((rows, cols), i, dtype=np.int32)


def test_iterates_all_batches_in_order():
    it = ShardedBatchIterator(_batches(5), "cpu")
    got = list(it)
    assert [int(b[0, 0]) for b in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.int32 for b in got)
    assert not it._thread.is_alive()
    assert next(it, None) is None   # stays ended


def test_read_only_chunks_become_owned_tensors(tmp_path):
    """A chunk that is a read-only view of a memory map (what the store's
    ``iter_chunks`` can hand out) comes out as a tensor that owns its bytes."""
    path = tmp_path / "shard.npy"
    np.save(path, np.arange(40, dtype=np.uint32).reshape(10, 4))
    view = np.load(path, mmap_mode="r")[2:6].view(np.int32)
    assert not view.flags.writeable
    (got,) = list(ShardedBatchIterator(iter([view]), "cpu"))
    got[0, 0] = -1
    assert np.array_equal(view, np.arange(8, 24, dtype=np.int32).reshape(4, 4))
    assert got.tolist()[1] == [12, 13, 14, 15]


def test_close_joins_blocked_worker():
    it = ShardedBatchIterator(_batches(10_000), "cpu", prefetch=2)
    next(it)   # the worker is now (or will be) blocked in a full-queue put
    time.sleep(0.05)
    it.close()
    assert not it._thread.is_alive(), "close() must join the worker thread"
    assert list(itertools.islice(it, 5)) == []


def test_close_on_infinite_generator():
    def forever():
        i = 0
        while True:
            yield np.full((2, 2), i, np.int32)
            i += 1

    it = ShardedBatchIterator(forever(), "cpu", prefetch=3)
    for want in range(4):
        assert int(next(it)[0, 0]) == want
    it.close()
    assert not it._thread.is_alive()


def test_context_manager_closes():
    with ShardedBatchIterator(_batches(100), "cpu") as it:
        next(it)
    assert not it._thread.is_alive()


def test_worker_exception_propagates_to_consumer():
    def broken():
        yield np.zeros((2, 2), np.int32)
        raise OSError("shard read failed")

    it = ShardedBatchIterator(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="shard read failed"):
        next(it)
    assert not it._thread.is_alive()


def test_close_idempotent_and_prefetch_validated():
    it = ShardedBatchIterator(_batches(50), "cpu")
    it.close()
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(ValueError):
        ShardedBatchIterator(_batches(1), "cpu", prefetch=0)


def test_imports_and_cpu_pipeline_create_no_cuda_stream(monkeypatch):
    """Importing the out-of-core modules creates no CUDA stream and builds no
    kernel; a CPU pipeline creates no stream either."""
    from repro_torch.kernels import _build

    def no_stream(*args, **kwargs):
        raise AssertionError("a CUDA stream was created")

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    fresh = {}
    for name in ("repro_torch.data.pipeline", "repro_torch.data.store",
                 "repro_torch.distributed.checkpoint", "repro_torch.distributed.fault_tolerance",
                 "repro_torch.core.streaming"):
        # run each module's top level again under the patch, as a copy that
        # leaves the imported module (and its classes) in place
        copy = "fresh_" + name.replace(".", "_")
        spec = importlib.util.spec_from_file_location(copy, importlib.util.find_spec(name).origin)
        fresh[name] = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, copy, fresh[name])   # dataclasses look it up
        spec.loader.exec_module(fresh[name])
    iterator = fresh["repro_torch.data.pipeline"].ShardedBatchIterator(_batches(3), "cpu")
    assert [int(b[0, 0]) for b in iterator] == [0, 1, 2]
    assert _build._LIBS == {}
