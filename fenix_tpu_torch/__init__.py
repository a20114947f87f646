"""fenix_tpu_torch — the fenix_tpu vector search engine on PyTorch and CUDA.

A port of the JAX package ``fenix_tpu`` (which stays the reference) to
an NVIDIA H100: Arrow-Flight-served tables in the same on-disk catalog,
the vector column resident on the card, and exact filtered top-k search
whose phase-1 scan is a hand-written CUDA kernel
(``fenix_tpu_torch/csrc/``). Modules mirror the JAX package's tree, so
each file's counterpart is found by path. This package never imports
JAX, and registers no Arrow extension type on import (``types`` says
why).
"""

from fenix_tpu_torch import coder, expr, index, io, types
from fenix_tpu_torch.flight import Flight, Server
from fenix_tpu_torch.version import __version__

__all__ = ["Flight", "Server", "coder", "expr", "index", "io", "types", "__version__"]
