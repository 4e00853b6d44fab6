"""PyTorch + CUDA port of the packed Apriori mine -> rulebook -> recommend chain.

Layout mirrors the JAX package (``core``, ``data``, ``kernels``, ``serving``,
``launch``).  Importing the package needs only torch and numpy: it touches
no CUDA state and builds no kernel.  Kernels are compiled with ``nvcc`` at
their first launch (``kernels/_build.py``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; it runs on
the CPU only when the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
