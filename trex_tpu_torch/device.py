"""Device selection for the PyTorch port.

Entry points run on the CUDA card unless the caller asks for the CPU
with ``device="cpu"``. There is no silent CPU path: without CUDA, a
call that did not name the CPU raises.

Importing this module turns TF32 off for matrix products and cuDNN:
the port's float32 sums (pixel counts, coordinate sums) must stay
exact below 2^24, which TF32's 10-bit mantissa would break.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.

    Raises RuntimeError when a CUDA device is asked for (or implied by
    ``None``) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "trex_tpu_torch runs on a CUDA device; none is available. "
            "Pass device='cpu' to run the plain CPU versions.")
    return dev
