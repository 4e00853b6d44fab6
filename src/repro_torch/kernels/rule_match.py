"""K2 binding: batched basket -> rule matching with per-item fan-out on the card.

The CUDA source is ``csrc/rule_match.cu`` (it replaces the Pallas kernel
``repro/kernels/rule_match.py::rule_match_pallas`` and says what bounds it
and how).  Its output is bit for bit ``ref.rule_match_ordered``.
:func:`launch` takes operands the wrapper in ``kernels/ops.py`` has already
checked; use that wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_ITEMS = 2**31 - 1  # the kernel numbers items in an int


def launch(b: torch.Tensor, a: torch.Tensor, lengths: torch.Tensor, c: torch.Tensor,
           scores: torch.Tensor) -> torch.Tensor:
    """(B, 32·W) float32 scores for int32 word views b (B, W), a / c (R, W),
    lengths (R,) int32 and scores (R,) float32, contiguous on one CUDA device."""
    nb, w = b.shape
    nr = a.shape[0]
    if 32 * w > MAX_ITEMS:
        raise ValueError(f"rule_match: {w} words hold {32 * w} items; the kernel numbers items in an int32")
    lib = _build.library("rule_match")
    out = torch.empty((nb, 32 * w), dtype=torch.float32, device=b.device)
    # the rulebook's compact rows, rebuilt by the launch's first kernel
    scratch = torch.empty(lib.rule_match_scratch_bytes(nr), dtype=torch.uint8, device=b.device)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.rule_match_launch(
            b.data_ptr(), a.data_ptr(), lengths.data_ptr(), c.data_ptr(),
            scores.data_ptr(), out.data_ptr(), scratch.data_ptr(), nb, nr, w, stream,
        )
    if err:
        raise RuntimeError(f"rule_match launch failed: cudaError {err}")
    return out
