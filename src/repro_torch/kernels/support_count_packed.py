"""K1 binding: candidate-support counting over packed bitsets on the card.

The CUDA source is ``csrc/support_count_packed.cu`` (it replaces the Pallas
kernel ``repro/kernels/support_count_packed.py::support_count_packed_pallas``
and says what bounds it and how).  :func:`launch` takes operands the wrapper
in ``kernels/ops.py`` has already checked; use that wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MODES = ("and_cmp", "popcount")
THREADS = 128           # candidates per block (csrc kThreads)
ROWS = 32               # rows per staged tile (csrc kRows)
TARGET_BLOCKS = 132 * 8  # several resident blocks on each of the H100's 132 SMs


def splits_for(n: int, k: int) -> int:
    """Transaction splits (grid.y): enough blocks to fill the card, never a
    split smaller than one staged tile."""
    k_tiles = max(1, -(-k // THREADS))
    max_splits = max(1, -(-n // ROWS))
    return max(1, min(max_splits, -(-TARGET_BLOCKS // k_tiles), 65535))


def launch(t: torch.Tensor, c: torch.Tensor, lengths: torch.Tensor, mode: str) -> torch.Tensor:
    """counts (K,) int32 for int32 word views t (N, W), c (K, W) and
    lengths (K,) int32, all contiguous on one CUDA device."""
    n, w = t.shape
    k = c.shape[0]
    out = torch.zeros(k, dtype=torch.int32, device=t.device)
    lib = _build.library("support_count_packed")
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.support_count_packed_launch(
            t.data_ptr(), c.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            n, k, w, MODES.index(mode), splits_for(n, k), stream,
        )
    if err:
        raise RuntimeError(f"support_count_packed launch failed: cudaError {err}")
    return out
