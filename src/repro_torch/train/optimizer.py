"""Hand-written AdamW with const / linear / cosine / WSD schedules
(counterpart of ``repro.train.optimizer``).

The state mirrors the parameters by name: ``AdamWState(step, m, v)`` holds
the step as an int32 tensor and ``m`` and ``v`` as float32 tensors keyed
by the parameter names (``LM.named_parameters()``, the reference's keys,
one entry per layer where the reference stacks them [L, ...]). Global-norm
clipping, the schedule's ``lr`` and the returned ``grad_norm`` are the
reference's, op for op in float32, and weight decay applies to every
parameter, the norms and the tied embedding included, as the reference's
does (not torch's habit of sparing the norms).

The reference returns new trees; ``apply_updates`` here updates the
parameters and ``m`` and ``v`` in place, one parameter at a time (the
temporaries of one leaf, not of the whole model), and returns them.
``opt_specs`` gives the state's logical axes: ``m`` and ``v`` mirror the
parameters' (ZeRO sharding), the step has none.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32, the number of updates so far
    m: Dict[str, torch.Tensor]         # float32, by parameter name
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"            # "cosine" | "wsd" | "linear" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1             # WSD: final fraction spent decaying
    min_lr_frac: float = 0.1


def named(params: Params) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a mapping's tensors, by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), in float32:
    linear warmup to ``cfg.lr`` over ``warmup_steps``, times the
    schedule's factor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    total = float(cfg.total_steps)
    if cfg.schedule == "const":
        post = 1.0
    elif cfg.schedule == "linear":
        post = torch.clamp_min(1.0 - s / total, cfg.min_lr_frac)
    elif cfg.schedule == "cosine":
        frac = torch.clamp(s / total, 0.0, 1.0)
        post = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): stable at peak
        # lr, then exponential-ish decay over the last decay_frac of steps
        decay_start = total * (1.0 - cfg.decay_frac)
        t = torch.clamp((s - decay_start) / (total - decay_start), 0.0, 1.0)
        post = torch.where(s < decay_start, 1.0, cfg.min_lr_frac ** t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * post


def init_state(params: Params) -> AdamWState:
    """Step 0 and zero float32 moments shaped as each parameter."""
    p = named(params)
    zeros = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for n, t in p.items()}
    dev = next(iter(p.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      {n: z.clone() for n, z in zeros.items()})


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (a module's parameters, a
    mapping's values or a sequence of tensors), in float32."""
    leaves = (named(tree).values() if isinstance(tree, (nn.Module, Mapping))
              else tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Params,
                  grads: Mapping[str, torch.Tensor], state: AdamWState
                  ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update with global-norm clipping, in place.

    ``grads`` holds a gradient for each parameter name. Returns
    ``(params, AdamWState(step + 1, m, v), {"lr", "grad_norm"})``: the same
    parameter and moment tensors, updated."""
    p = named(params)
    if set(grads) != set(p):
        raise ValueError("grads and params differ in names: "
                         f"{sorted(set(grads) ^ set(p))}")
    gnorm = global_norm([grads[n] for n in p])
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for n, w in p.items():
        g = grads[n].float() * scale
        m, v = state.m[n], state.v[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * w.float()
        w.copy_(w.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), {
        "lr": lr, "grad_norm": gnorm}


def opt_specs(param_specs: Mapping[str, Tuple]) -> AdamWState:
    """The optimizer state's logical specs: ``m`` and ``v`` mirror the
    parameters' (ZeRO sharding), the step is a scalar (``()``)."""
    return AdamWState((), dict(param_specs), dict(param_specs))
