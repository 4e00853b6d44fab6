"""K1 binding: candidate-support counting over packed bitsets on the card.

The CUDA source is ``csrc/support_count_packed.cu`` (it replaces the Pallas
kernel ``repro/kernels/support_count_packed.py::support_count_packed_pallas``
and says what bounds it and how): the rows are transposed into item bitmaps
in a scratch this module allocates, slab by slab, and each candidate ANDs
its items' bitmaps.  :func:`launch` takes operands the wrapper in
``kernels/ops.py`` has already checked; use that wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MODES = ("and_cmp", "popcount")
SCRATCH_CAP = 64 << 20  # bytes of item bitmaps in a slab (a slab holds at least 1,024 rows)


def slab_words(n: int, w: int) -> int:
    """Bitmap words of 32 rows in one slab: all of N where its bitmaps
    (128·W bytes a word) fit under ``SCRATCH_CAP``, else as many as fit, a
    multiple of 32 and at least 32.  K1's extra memory is about
    128·W·slab_words bytes: at most max(SCRATCH_CAP, 4,096·W) bytes, the
    second the bitmaps of 1,024 rows, as many bytes as those rows' words."""
    whole = -(-max(1, -(-n // 32)) // 32) * 32
    fit = max(32, SCRATCH_CAP // (128 * w) // 32 * 32)
    return min(whole, fit)


def launch(t: torch.Tensor, c: torch.Tensor, lengths: torch.Tensor, mode: str) -> torch.Tensor:
    """counts (K,) int32 for int32 word views t (N, W), c (K, W) and
    lengths (K,) int32, all contiguous on one CUDA device."""
    n, w = t.shape
    k = c.shape[0]
    out = torch.zeros(k, dtype=torch.int32, device=t.device)
    lib = _build.library("support_count_packed")
    slab = slab_words(n, w)
    scratch = torch.empty(lib.support_count_packed_scratch_bytes(k, w, slab), dtype=torch.uint8,
                          device=t.device)
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count  # sizes the count grid
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.support_count_packed_launch(
            t.data_ptr(), c.data_ptr(), lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n, k, w, MODES.index(mode), slab, sms, stream,
        )
    if err:
        raise RuntimeError(f"support_count_packed launch failed: cudaError {err}")
    return out
