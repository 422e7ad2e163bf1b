"""Image gradients (counterpart of ``torchmetrics_tpu/functional/image/gradients.py``)."""
from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F  # noqa: N812
from torch import Tensor


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Finite differences ``(dy, dx)``, zero at the far edge (``gradients.py:10``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import image_gradients
        >>> dy, dx = image_gradients(torch.arange(16.0).reshape(1, 1, 4, 4))
        >>> dy[0, 0].tolist()
        [[4.0, 4.0, 4.0, 4.0], [4.0, 4.0, 4.0, 4.0], [4.0, 4.0, 4.0, 4.0], [0.0, 0.0, 0.0, 0.0]]
    """
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1))
