"""Train and eval step factories (counterpart of ``repro.train.steps``).

``make_train_step(loss_fn, opt_cfg, accum)`` returns
``step(params, opt_state, batch) -> (params, opt_state, metrics)``. With
``accum > 1`` the batch's leading axis is split into ``accum``
microbatches as the reference's reshape splits it (microbatch i holds rows
``[i * B / accum, (i + 1) * B / accum)``), run one after another; the
gradients and the loss are their means. The parameters (an ``nn.Module``
whose parameters require grad; training turns that on explicitly) and the
optimizer state are updated in place and returned.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from .optimizer import AdamWState, OptConfig, apply_updates


def _microbatches(batch, accum: int):
    """Split every leaf's leading axis into ``accum`` consecutive parts."""
    if accum <= 1:
        return [batch]
    for k, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"{k}: leading axis {x.shape[0]} is not a "
                             f"multiple of accum={accum}")
    return [{k: x[i * (x.shape[0] // accum):(i + 1) * (x.shape[0] // accum)]
             for k, x in batch.items()} for i in range(accum)]


def accumulate_grads(loss_fn: Callable, params: nn.Module, batch,
                     accum: int = 1
                     ) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    """(loss, metrics, grads by parameter name) of ``loss_fn(params,
    batch)`` over ``accum`` microbatches: the loss and the float32
    gradients are means over the microbatches (summed, then divided by
    ``accum``); the metrics are ``loss_fn``'s only when ``accum`` is 1, as
    in the reference. The gradients are the parameters' ``.grad``, set
    anew."""
    named = dict(params.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"parameters {frozen[:3]}... do not require grad: "
                         "call params.requires_grad_(True) to train")
    for p in named.values():
        p.grad = None
    lsum, metrics = None, {}
    for mb in _microbatches(batch, accum):
        loss, m = loss_fn(params, mb)
        loss.backward()
        loss = loss.detach()
        lsum = loss if lsum is None else lsum + loss
        if accum <= 1:
            metrics = {k: v.detach() for k, v in m.items()}
    grads = {}
    for n, p in named.items():
        if p.grad is None:
            raise RuntimeError(f"{n} got no gradient")
        if accum > 1:
            p.grad.div_(accum)
        grads[n] = p.grad
    return (lsum / accum if accum > 1 else lsum), metrics, grads


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig,
                    accum: int = 1) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics dict)."""

    def step(params: nn.Module, opt_state: AdamWState, batch):
        loss, metrics, grads = accumulate_grads(loss_fn, params, batch,
                                                accum)
        params, opt_state, opt_m = apply_updates(opt_cfg, params, grads,
                                                 opt_state)
        metrics = dict(metrics)
        metrics.update(opt_m)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    """``step(params, batch) -> metrics`` with ``loss``, without
    gradients."""
    def step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics
    return step
