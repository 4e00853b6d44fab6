"""What the kernel tools (``k1_variants.py``, ``k2_variants.py``,
``k3_variants.py``) share: the repo on ``sys.path``, the build of a CUDA
source with the port's ``nvcc`` command, and the timing of variants side by
side, each held to the same answer.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def card(tool: str) -> str | None:
    """The card's name and power limit, printed; None (and a message) without a card."""
    if not torch.cuda.is_available():
        print(f"{tool}: needs a CUDA card", file=sys.stderr)
        return None
    line = smoke.card_line()
    print(line, flush=True)
    return line


def build(kind: str, name: str, source: str) -> ctypes.CDLL:
    """``source`` built with the port's ``nvcc`` command into
    ``build/<kind>_variants/lib<name>.so`` and loaded."""
    out = os.path.join(ROOT, "build", f"{kind}_variants")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"lib{name}.so")
    cmd = _build.nvcc_command(Path(source), Path(lib_path), _build.nvcc_path())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(f"[build] {name}: {' '.join(cmd[1:])}\n{proc.stdout}{proc.stderr}".rstrip(), flush=True)
    proc.check_returncode()
    return ctypes.CDLL(lib_path)


def alternate(calls: dict, want: torch.Tensor, reps: int, what: str) -> dict:
    """{name: [ms, ms]}: each call of ``calls`` ({name: fn()}) timed with
    CUDA events over ``reps`` calls in the order A B .. B A, and held to
    ``torch.equal(fn(), want)`` before each timing."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        fn = calls[name]
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} {what}: differs from the plain version")
        torch.cuda.synchronize()
        times[name].append(smoke.cuda_ms(fn, reps))
    return times


def profile(fn, reps: int, what: str, line: str) -> None:
    """Prints the device time of each CUDA kernel that ``fn()`` launches,
    a call's share, over ``reps`` calls (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            print(f"[profile] {what}: {e.key[:60]} {e.device_time_total / reps / 1e3:.4f} ms a call "
                  f"({e.count} launches) [{line}]", flush=True)
