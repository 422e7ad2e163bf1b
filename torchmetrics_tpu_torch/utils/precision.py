"""Full float32 for the matrix products and convolutions of the pairwise and image metrics.

The JAX package asks for ``precision="highest"`` in its matrix products
(``functional/pairwise/distances.py:25-28``) so that no global setting trades float32 for a
faster, shorter format. In PyTorch that choice is a process-wide flag: cuDNN's convolutions run in
TF32 by default (``torch.backends.cudnn.allow_tf32`` is True in stock PyTorch), cuBLAS's matrix
products once a caller sets ``torch.set_float32_matmul_precision("high")``, and oneDNN's on the CPU
may take bf16 or TF32 the same way. TF32 keeps 10 mantissa bits, about 1e-3 relative error.

:func:`full_float32` sets each of those backends to IEEE float32 for the calls inside it and puts
back what the caller had, even when a call raises. It reads and writes the backends'
``fp32_precision`` (the per-backend setting that ``allow_tf32`` and
``set_float32_matmul_precision`` write too, PyTorch 2.9 and later), so the caller's flags read the
same afterwards through either interface; writing the legacy ``allow_tf32`` here instead would make
PyTorch raise on the next legacy read of a flag the caller set through the new interface. The flags
are read when a kernel is chosen, so a CUDA graph captured inside the scope replays in float32.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch


def _backends() -> tuple:
    b = torch.backends
    return b.cuda.matmul, b.cudnn.conv, b.mkldnn.matmul, b.mkldnn.conv


@contextmanager
def full_float32() -> Iterator[None]:
    """Matrix products and convolutions in IEEE float32 inside the scope, whatever the caller set."""
    backends = _backends()
    saved = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, value in zip(backends, saved):
            b.fp32_precision = value
