"""Blocked plain counting path under the JAX package's module name
(``repro/kernels/blocked.py``): the count over candidate blocks, so the
(N, K) intersection matrix is never whole.  The function is
``ref.support_count_blocked``, the plain route of ``ops.support_count`` on
the CPU; its blocks are slices, so unlike the JAX version it pads no
candidate row and its FLOPs are the unblocked count's."""

from repro_torch.kernels.ref import support_count_blocked

__all__ = ["support_count_blocked"]
