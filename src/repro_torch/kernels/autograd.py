"""Differentiable attention for training: ``FlashAttention``.

The kernel wrappers in ``ops`` launch through ctypes, so their outputs
carry no ``grad_fn`` (and they raise on inputs that require grad). The
TPU kernel has no backward either: the reference trains through its XLA
``_attention_scan``. So training attention is this ``autograd.Function``:

* forward is ``ops.flash_attention``: the hand-written kernel on the card
  (the one prefill runs), the plain version on the CPU;
* backward recomputes ``ref.flash_attention`` (the plain online softmax,
  the kernel's arithmetic in float32) from the saved q, k and v under
  ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. It
  launches no kernel.

``flash_attention`` has the signature of ``ops.flash_attention``, so this
module is an ``impl`` for ``models.transformer``'s layers.
"""
from __future__ import annotations

import torch

from . import ops, ref


class FlashAttention(torch.autograd.Function):
    """Causal or full GQA attention, q [B, H, Tq, D], k/v [B, Hkv, Tk, D]
    -> [B, H, Tq, D]: the kernel forward, the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v), ctx.needs_input_grad)]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ref.flash_attention(*inputs, causal=ctx.causal)
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``ops.flash_attention`` with a gradient (``FlashAttention``)."""
    return FlashAttention.apply(q, k, v, causal)
