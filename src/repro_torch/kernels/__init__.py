"""Hand-written CUDA kernels, their plain PyTorch versions and the wrappers.

The package re-exports the JAX package's ``repro.kernels`` names, so
``repro_torch.kernels.support_count`` and ``.support_count_packed`` are the
wrapper FUNCTIONS of ``ops`` and hide the binding submodules of those names:
reach the submodules with ``from repro_torch.kernels.support_count import
...`` or ``importlib.import_module``.
"""

# the binding submodules load first: a submodule loaded after the re-exports
# below would rebind the package's name to itself
from repro_torch.kernels import support_count_packed as _k1  # noqa: F401
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import pack_bits_device, support_count, support_count_packed
