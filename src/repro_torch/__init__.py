"""KAN-SAs in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The module layout mirrors the JAX package ``repro`` (the reference this
package is tested against), so each module here has a counterpart of the
same name there.  This package imports ``torch``, ``numpy`` and the standard
library only; its CUDA kernels (``kernels/csrc``) are compiled with ``nvcc``
at first use on a CUDA tensor, never at import time.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

__all__ = ["set_ieee_fp32"]


def set_ieee_fp32() -> None:
    """Run float32 matrix products and convolutions in IEEE fp32 on the card.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``: TF32 keeps ~3 decimal
    digits, far outside the fp32 parity tolerances the port is held to.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
