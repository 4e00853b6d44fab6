"""The device trace of a traced run, read from ``torch.profiler``.

The profiler records host operations and device activity (kernels, copies,
sets) over the traced window; its Chrome trace is read back for:

* ``busy_s``: the union of the device activity's intervals;
* ``kernel_s``: device seconds by CUDA function name (template and
  arguments stripped);
* ``idle_gaps``: the device's longest idle intervals inside the window,
  each named by the innermost benchmark annotation (``record_function``)
  that was open on the host at its middle, else by the innermost host
  operator open then, else ``host python`` (the interpreter, between
  operators).
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def kernel_name(name: str) -> str:
    """A trace event's CUDA function name, without template and arguments."""
    return name.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0].split("<")[0]


class DeviceTrace:
    """Start and stop ``torch.profiler`` around a window; :meth:`summary`
    reads what it recorded.  On a machine without CUDA it records the host
    only and reads a busy time of 0."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self._summary: dict | None = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self._prof is None or self.t1 is not None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
        finally:
            os.remove(path)
        self._prof = None
        self._summary = self._summarise(events)
        # the parsed trace is garbage now: collect it here, inside the
        # benchmark's own pause, not in a collection during the window
        del events
        gc.collect()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def summary(self) -> dict:
        if self._summary is None:
            return dict(busy_s=0.0, window_s=self.window_s, kernel_s={}, device_ops=[], idle_gaps=[])
        return self._summary

    def _summarise(self, events: list) -> dict:
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e)
                     for e in events if e.get("cat") in DEVICE_CATEGORIES)
        kernel_s: dict = {}
        op_s: dict = {}
        for _, _, e in dev:
            sec = float(e.get("dur", 0)) / 1e6
            op_s[e["name"]] = op_s.get(e["name"], 0.0) + sec
            if e.get("cat") == "kernel":
                name = kernel_name(e["name"])
                kernel_s[name] = kernel_s.get(name, 0.0) + sec
        busy_us, gaps = 0.0, []
        end = None
        for a, b, _ in dev:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy_us += b - a
                end = b
            elif b > end:
                busy_us += b - end
                end = b
        host = [e for e in events if e.get("cat") not in DEVICE_CATEGORIES]
        named = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
            named.append([self._host_at((a + b) / 2, host), (b - a) / 1e6])
        device_ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP]
        return dict(busy_s=busy_us / 1e6, window_s=self.window_s, kernel_s=kernel_s,
                    device_ops=[[k[:120], v] for k, v in device_ops], idle_gaps=named)

    @staticmethod
    def _host_at(t: float, host: list) -> str:
        open_ = [e for e in host if float(e["ts"]) <= t <= float(e["ts"]) + float(e.get("dur", 0))
                 and not str(e.get("name", "")).startswith("PyTorch Profiler")]
        marks = [e for e in open_ if e.get("cat") == "user_annotation"]
        if marks:
            return "annotation " + min(marks, key=lambda e: float(e.get("dur", 0)))["name"][:100]
        if open_:
            return "host op " + min(open_, key=lambda e: float(e.get("dur", 0)))["name"][:100]
        return "host python"
