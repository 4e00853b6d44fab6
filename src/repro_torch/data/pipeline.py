"""Host -> device chunk pipeline for the streaming miner.

A worker thread takes host arrays from a generator (the store's chunks),
places each on the device and keeps ``prefetch`` of them queued, so reading
the next chunk from disk overlaps counting the current one (DESIGN.md §9).

On CUDA the worker copies each chunk into one of ``prefetch + 2`` pinned
host buffers (a ring: ``prefetch`` queued, one being counted, one being
filled) and issues a ``non_blocking`` copy to the card on a side stream,
recording one event per chunk.  The consumer's stream waits on that event
before it touches the chunk, and the chunk is marked as used on the
consumer's stream (``record_stream``) so its memory is not handed out again
while counting is queued.  A buffer is refilled only after its last copy's
event has completed, and :meth:`ShardedBatchIterator.close` waits for every
copy in flight before it lets go of the buffers.  On the CPU the chunks are
plain tensors that own their bytes.

On a mesh (``launch.mesh``) each rank keeps only its row block of every
chunk (split over the data axes, as ``PartitionSpec(data_axes, None)``
splits it) and copies only that through its ring: the paper's block
locality, each map task reading its own split.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


class _Slot:
    """One pinned host buffer of the ring and the event of its last copy."""

    __slots__ = ("buf", "event")

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.event: torch.cuda.Event | None = None


class ShardedBatchIterator:
    """Wraps a generator of host arrays; yields each as a tensor on
    ``device``, prefetching ``prefetch`` of them on a worker thread.  With a
    ``mesh``, each array's rows must split evenly over ``data_axes`` and only
    this rank's block of them is yielded.

    Chunks come out in the generator's order.  A generator (or placement)
    error reaches the consumer as that error, never as a short stream.
    ``close()`` terminates the worker: its queue puts are timeout loops that
    re-check the stop event, and ``close()`` drains the queue so a worker
    mid-put unblocks, then joins it.  Iteration after ``close()`` ends.
    Context-managed; exhausting the iterator also joins the worker.
    """

    def __init__(self, gen, device, *, mesh=None, data_axes=("data",), prefetch: int = 2):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self._block = mesh.shard(tuple(data_axes)) if mesh is not None else (0, 1)
        dev = torch.device(device)
        self._cuda = dev.type == "cuda"
        if self._cuda and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._gen = gen
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._ended = False
        if self._cuda:
            self._stream = torch.cuda.Stream(device=dev)
            self._ring = [_Slot() for _ in range(prefetch + 2)]
            self._slot = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch):
        index, count = self._block
        if count > 1:
            if batch.shape[0] % count:
                raise ValueError(f"a chunk of {batch.shape[0]} rows does not split over "
                                 f"{count} data shards")
            rows = batch.shape[0] // count
            batch = batch[index * rows : (index + 1) * rows]
        if not self._cuda:
            # own the bytes: the store may hand out a read-only mmap view
            return torch.from_numpy(np.array(batch, copy=True))
        host = np.ascontiguousarray(batch)
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()   # its last copy has left the buffer
        dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
        if slot.buf is None or slot.buf.shape != host.shape or slot.buf.dtype != dtype:
            slot.buf = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        slot.buf.numpy()[...] = host
        with torch.cuda.stream(self._stream):
            out = torch.empty(host.shape, dtype=dtype, device=self._device)
            out.copy_(slot.buf, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return out, slot.event

    def _put(self, item) -> bool:
        """Timeout-put loop: returns False (item dropped) once stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._gen:
                if self._stop.is_set():
                    return
                if not self._put(self._place(batch)):
                    return
        except BaseException as e:  # surface generator/placement failures to
            self._err = e           # the consumer — NOT a clean end-of-stream
        finally:
            # end-of-stream sentinel: wait politely while the consumer is
            # live; only force room (dropping a stale batch) once stopped
            while True:
                try:
                    self._q.put(None, timeout=0.05)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        try:
                            self._q.get_nowait()
                        except queue.Empty:
                            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._ended = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        if not self._cuda:
            return item
        out, event = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)
        out.record_stream(stream)
        return out

    def close(self, timeout: float = 10.0):
        """Stop the worker, drain buffered chunks, join the thread, and wait
        for every host -> device copy still in flight."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:   # unblock a worker waiting in its timeout-put
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:   # drop stale buffered chunks
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        try:   # guarantee subsequent __next__ sees end-of-stream
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._cuda:
            for slot in self._ring:
                if slot.event is not None:
                    slot.event.synchronize()
            if not self._thread.is_alive():
                self._ring = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
