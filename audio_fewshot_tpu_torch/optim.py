"""Optimizers and LR schedules (counterpart of ``audio_fewshot_tpu/optim.py``).

``optimizer.name/kwargs`` builds a ``torch.optim`` optimizer (Adam, AdamW,
SGD, and ``RMSprop`` below) with one parameter group per top-level submodule
of the method; ``optimizer.other: {submodule: lr}`` gives a group its own
base LR.
Weight decay is coupled (added to the gradient) for Adam, SGD and RMSprop
and decoupled for AdamW, as in torch; it defaults to 0 for all four.
``lr_scheduler.name/kwargs`` is a host-side per-EPOCH multiplier of the
base LRs, optionally behind a linear warmup, with ReduceLROnPlateau
bookkeeping; the trainer sets the groups' LR once per epoch.  The scheduler
is a copy of the JAX package's (pure Python).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn


class RMSprop(torch.optim.Optimizer):
    """RMSprop as the JAX package's optax chain computes it (coupled weight
    decay, ``scale_by_rms``, ``trace``), which is not ``torch.optim.RMSprop``:
    optax divides by ``sqrt(nu + eps)``, torch by ``sqrt(nu) + eps``.  Per
    step, for each parameter p with gradient g:

        g  <- g + weight_decay * p
        nu <- alpha * nu + (1 - alpha) * g**2       (nu starts at 0)
        u  =  g / sqrt(nu + eps)
        m  <- momentum * m + u                      (with momentum; u = m)
        p  <- p - lr * u

    One ``torch._foreach_*`` pass per group.  The state (``square_avg``,
    ``momentum_buffer``) is in ``state_dict()``."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            states = [self.state[p] for p in params]
            for p, state in zip(params, states):
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                    if group["momentum"]:
                        state["momentum_buffer"] = torch.zeros_like(p)
            nus = [state["square_avg"] for state in states]
            torch._foreach_mul_(nus, group["alpha"])
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - group["alpha"])
            denom = torch._foreach_add(nus, group["eps"])
            torch._foreach_sqrt_(denom)
            updates = torch._foreach_div(grads, denom)
            if group["momentum"]:
                updates_m = [state["momentum_buffer"] for state in states]
                torch._foreach_mul_(updates_m, group["momentum"])
                torch._foreach_add_(updates_m, updates)
                updates = updates_m
            torch._foreach_add_(params, updates, alpha=-group["lr"])
        return loss


_OPTIMIZERS = {
    "adam": (torch.optim.Adam, ("betas", "eps")),
    "adamw": (torch.optim.AdamW, ("betas", "eps")),
    "sgd": (torch.optim.SGD, ("momentum", "nesterov")),
    "rmsprop": (RMSprop, ("alpha", "eps", "momentum")),
}


class Optimizer:
    """A ``torch.optim`` optimizer over the method's parameters, one group
    per top-level submodule (``group_lrs`` maps submodule names to base LRs;
    the others use the default LR).  ``set_lr_scale`` sets every group's LR
    to its base LR times the epoch's scale."""

    def __init__(self, config_opt: Dict[str, Any], method: nn.Module):
        name = str(config_opt.get("name", "Adam"))
        kwargs = dict(config_opt.get("kwargs") or {})
        if name.lower() not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {name!r}")
        cls, keys = _OPTIMIZERS[name.lower()]
        self.base_lr = float(kwargs.get("lr", 1e-3))
        other = config_opt.get("other") or {}
        self.group_lrs: Dict[str, float] = {k: float(v) for k, v in other.items()}
        groups: List[Dict[str, Any]] = []
        for part, module in method.named_children():
            params = [p for p in module.parameters() if p.requires_grad]
            if params:
                lr = self.group_lrs.get(part, self.base_lr)
                groups.append({"params": params, "name": part, "base_lr": lr, "lr": lr})
        for part, param in method.named_parameters(recurse=False):
            if param.requires_grad:
                lr = self.group_lrs.get(part, self.base_lr)
                groups.append({"params": [param], "name": part, "base_lr": lr, "lr": lr})
        extra = {k: kwargs[k] for k in keys if k in kwargs}
        if "betas" in extra:
            extra["betas"] = tuple(float(b) for b in extra["betas"])
        self.torch = cls(groups, lr=self.base_lr,
                         weight_decay=float(kwargs.get("weight_decay", 0.0) or 0.0), **extra)

    def set_lr_scale(self, scale: float) -> None:
        for group in self.torch.param_groups:
            group["lr"] = group["base_lr"] * scale

    def zero_grad(self) -> None:
        self.torch.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.torch.step()

    def state_dict(self) -> Dict[str, Any]:
        return self.torch.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.torch.load_state_dict(state)


# -- epoch-level LR schedulers (torch semantics) -----------------------------

class LRScheduler:
    """Multiplier(epoch) with optional plateau feedback.  ``scale(epoch)``
    returns the factor applied to base LRs for that epoch; call
    ``step(metric)`` once per epoch afterwards (plateau bookkeeping)."""

    def __init__(self, name: str, kwargs: Dict[str, Any], epochs: int,
                 warmup: int = 0, base_lr: float = 1.0):
        self.name = name
        self.kwargs = dict(kwargs or {})
        self.epochs = epochs
        self.warmup = int(warmup or 0)
        self.base_lr = float(base_lr) or 1.0
        if self.warmup:
            # reference GradualWarmupScheduler.get_after_scheduler
            # (utils/utils.py:350-360) shrinks the after-scheduler horizon
            # by warmup-1 epochs (the after-scheduler takes over AT epoch
            # warmup-1, see scale())
            if name == "CosineAnnealingLR" and "T_max" in self.kwargs:
                self.kwargs["T_max"] = int(self.kwargs["T_max"]) - (self.warmup - 1)
            elif name == "MultiStepLR" and self.kwargs.get("milestones"):
                self.kwargs["milestones"] = [
                    int(m) - self.warmup + 1 for m in self.kwargs["milestones"]
                ]
        self._plateau_scale = 1.0
        self._best: Optional[float] = None
        self._bad = 0
        self._cooldown = 0

    def _base_scale(self, epoch: int) -> float:
        k = self.kwargs
        name = self.name
        if name == "StepLR":
            return float(k.get("gamma", 0.1)) ** (epoch // int(k.get("step_size", 30)))
        if name == "MultiStepLR":
            ms = sorted(k.get("milestones", []))
            passed = sum(1 for m in ms if epoch >= int(m))
            return float(k.get("gamma", 0.1)) ** passed
        if name == "ExponentialLR":
            return float(k.get("gamma", 0.95)) ** epoch
        if name == "CosineAnnealingLR":
            t_max = int(k.get("T_max", self.epochs or 1))
            # torch's eta_min is an ABSOLUTE LR floor — convert to a scale
            # against the optimizer's base LR (same convention as the
            # plateau min_lr below).  NO clamp at T_max — torch's closed
            # form is periodic (the LR climbs back up past T_max), and
            # reference runs do exceed T_max epochs
            eta_scale = float(k.get("eta_min", 0.0)) / self.base_lr
            cos = 0.5 * (1 + math.cos(math.pi * epoch / max(t_max, 1)))
            return eta_scale + (1.0 - eta_scale) * cos
        if name == "ConstantLR" or name is None:
            return 1.0
        if name == "LambdaLR":
            # reference builds LambdaLR with an eval'd lambda string
            fn = k.get("lr_lambda")
            if isinstance(fn, str):
                # reference parity (trainer.py:570 eval's the string) — but
                # evaluated in a restricted namespace: no builtins, only math
                fn = eval(  # noqa: S307
                    fn, {"__builtins__": {}}, {"math": math}
                )
            return float(fn(epoch)) if fn else 1.0
        if name == "ReduceLROnPlateau":
            return 1.0  # handled by _plateau_scale
        raise ValueError(f"unknown lr_scheduler {name!r}")

    def scale(self, epoch: int) -> float:
        # GradualWarmupScheduler semantics (reference utils/utils.py:373-381):
        # epochs 0..warmup-2 ramp linearly at (e+1)/warmup; the
        # after-scheduler takes over AT epoch warmup-1 (index 0), with its
        # horizon pre-shrunk by warmup-1 in __init__
        if self.warmup and epoch < self.warmup - 1:
            return float(epoch + 1) / float(self.warmup) * self._plateau_scale
        shift = self.warmup - 1 if self.warmup else 0
        return self._base_scale(max(0, epoch - shift)) * self._plateau_scale

    def step(self, metric: Optional[float] = None) -> None:
        if self.name != "ReduceLROnPlateau" or metric is None:
            return
        k = self.kwargs
        mode = k.get("mode", "min")
        thr = float(k.get("threshold", 1e-4))
        # torch's DEFAULT threshold_mode is 'rel': improvement relative to
        # the best metric's magnitude, not an absolute margin
        rel = str(k.get("threshold_mode", "rel")) == "rel"
        if self._best is None:
            better = True
        elif mode == "min":
            bar = self._best * (1.0 - thr) if rel else self._best - thr
            better = metric < bar
        else:
            bar = self._best * (1.0 + thr) if rel else self._best + thr
            better = metric > bar
        if better:
            self._best = metric
            self._bad = 0
            if self._cooldown:
                self._cooldown -= 1
            return
        if self._cooldown:
            # torch ignores bad epochs while cooling down after a reduction
            self._cooldown -= 1
            self._bad = 0
            return
        self._bad += 1
        if self._bad > int(k.get("patience", 10)):
            factor = float(k.get("factor", 0.1))
            # torch min_lr is an ABSOLUTE learning-rate floor — convert
            # to a scale floor against the optimizer's base LR
            min_scale = float(k.get("min_lr", 0.0)) / self.base_lr
            self._plateau_scale = max(self._plateau_scale * factor, min_scale)
            self._bad = 0
            self._cooldown = int(k.get("cooldown", 0))

    # -- state for resume ---------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "plateau_scale": self._plateau_scale,
            "best": self._best,
            "bad": self._bad,
            "cooldown": self._cooldown,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._plateau_scale = state.get("plateau_scale", 1.0)
        self._best = state.get("best")
        self._bad = state.get("bad", 0)
        self._cooldown = state.get("cooldown", 0)


def build_optimizer(config: Dict[str, Any], method: nn.Module) -> Optimizer:
    return Optimizer(config.get("optimizer") or {"name": "Adam"}, method)


def build_scheduler(config: Dict[str, Any]) -> LRScheduler:
    sched = config.get("lr_scheduler") or {"name": "ConstantLR", "kwargs": {}}
    opt_kwargs = (config.get("optimizer") or {}).get("kwargs") or {}
    return LRScheduler(
        sched.get("name", "ConstantLR"),
        sched.get("kwargs") or {},
        epochs=int(config.get("epoch", 1)),
        warmup=int(config.get("warmup", 0) or 0),
        base_lr=float(opt_kwargs.get("lr", 1e-3)),
    )
