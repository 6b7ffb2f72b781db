"""Differentiable attention for training: ``FlashAttention``.

The kernel wrappers in ``ops`` launch through ctypes, so their outputs
carry no ``grad_fn`` (and they raise on inputs that require grad). The
TPU kernel has no backward either: the reference trains through its XLA
``_attention_scan``. So training attention is this ``autograd.Function``:

* forward is ``ops.flash_attention``: the hand-written kernel on the card
  (the one prefill runs), the plain version on the CPU;
* backward recomputes ``ref.flash_attention`` (the plain online softmax,
  the kernel's arithmetic, with the same bf16 score knobs) from the saved
  q, k and v under
  ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it. It
  launches no kernel. On the ``meta`` device (the dry run) it returns
  empty gradients of the inputs' shapes, as ``ops`` does for the forward.

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
    def forward(ctx, q, k, v, causal: bool, scores_bf16: bool = False,
                p_bf16: bool = False):
        ctx.flags = dict(causal=causal, scores_bf16=scores_bf16,
                         p_bf16=p_bf16)
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, **ctx.flags)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if q.device.type == "meta":        # the dry run: shapes only
            return (*(torch.empty_like(t) if need else None for t, need in
                      zip((q, k, v), ctx.needs_input_grad)), None, None, None)
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((q, k, v), ctx.needs_input_grad)]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ref.flash_attention(*inputs, **ctx.flags)
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scores_bf16: bool = False,
                    p_bf16: bool = False) -> torch.Tensor:
    """``ops.flash_attention`` with a gradient (``FlashAttention``); the
    bf16 score knobs pass through to both the forward and the plain
    version the backward differentiates."""
    return FlashAttention.apply(q, k, v, causal, scores_bf16, p_bf16)
