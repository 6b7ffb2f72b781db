"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for CUDA on a
machine without a visible GPU raises: the port never falls back to the CPU
on its own, the caller asks for ``device="cpu"`` explicitly (as the CPU tests
do).

Resolving a CUDA device also turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): the JAX reference computes in full
float32, and one TF32 pass keeps only about three decimal digits, enough to
reorder the exact scan's ids. The port's own kernels that run float32
products on the TF32 tensor cores (``l2dist``, ``flash_attention_f32``)
split each operand into hi and lo TF32 halves and take three passes, which
holds the float32 tolerances of their checks (``csrc/tf32x3.cuh``); these
flags do not reach them.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a torch.device; raise if CUDA is
    asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested (the default) but torch sees no "
                "GPU; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def to_tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Array-like -> tensor of ``dtype``.

    A tensor keeps its device unless ``device`` is given; anything else
    lands on ``resolve_device(device)``. Unsigned 32-bit numpy payloads
    (packed bits, boolean assignments) are reinterpreted as int32 bit for
    bit, because torch holds 32-bit words as int32.
    """
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(resolve_device(device))
        return t if t.dtype == dtype else t.to(dtype)
    arr = np.asarray(x)
    if arr.dtype == np.uint32 and dtype == torch.int32:
        arr = arr.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(arr),
                           device=resolve_device(device)).to(dtype)
