"""K3 binding: candidate-support counting over dense {0,1} operands on the
card's tensor cores.

The CUDA source is ``csrc/support_count.cu`` (it replaces the Pallas kernel
``repro/kernels/support_count.py::support_count_pallas`` and says what
bounds it and how).  :func:`launch` takes operands the wrapper in
``kernels/ops.py`` has already checked (in the operand dtype, the item axis
at :func:`item_width`); use that wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# operand_dtype -> (the C interface's code, the operands' torch dtype)
DTYPES = {"bf16": (0, torch.bfloat16), "int8": (1, torch.int8)}
ITEM_MULTIPLE = 32       # the item axis the kernel takes: 16-byte TMA row strides in both types


def item_width(num_items: int) -> int:
    """The item axis the kernel takes: ``num_items`` padded with zero
    columns (inert) to :data:`ITEM_MULTIPLE`.  The dense DB placement and
    the candidate placement both take it from here, so they cannot drift."""
    return -(-max(num_items, 1) // ITEM_MULTIPLE) * ITEM_MULTIPLE


def launch(t: torch.Tensor, c: torch.Tensor, lengths: torch.Tensor, operand_dtype: str) -> torch.Tensor:
    """counts (K,) int32 for {0,1} operands t (N, Ip), c (K, Ip) of the
    operand dtype, Ip a multiple of :data:`ITEM_MULTIPLE`, and lengths (K,)
    int32, all contiguous on one CUDA device."""
    n, ip = t.shape
    k = c.shape[0]
    code, _ = DTYPES[operand_dtype]
    out = torch.zeros(k, dtype=torch.int32, device=t.device)
    lib = _build.library("support_count")
    sms = torch.cuda.get_device_properties(t.device).multi_processor_count  # the persistent grid
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.support_count_launch(
            t.data_ptr(), c.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            n, k, ip, code, sms, stream,
        )
    if err:
        raise RuntimeError(f"support_count launch failed: cudaError {err}")
    return out
