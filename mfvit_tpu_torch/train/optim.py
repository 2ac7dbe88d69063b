"""Optimizers and schedules, the port of ``mfvit_tpu/train/optim.py``.

- SGD (decayed weights, then heavy-ball momentum: ``torch.optim.SGD`` with
  ``weight_decay`` and ``momentum``), Adam, AdamW (optax's decoupled decay
  is ``torch.optim.AdamW``'s) and LARS (``Lars`` below: weight decay and
  trust scaling only where ``ndim > 1``, as the reference's
  moco/optimizer.py).
- The finetune/fusion per-epoch schedule (cosine or milestone decay), the
  pretrain per-step schedule (warmup, then cosine over fractional
  epochs), the MoCo momentum ramp and the reference's batch-size LR
  scaling.
- Linear-probe freezing: ``head_only_mask`` names the trainable
  parameters; ``build_optimizer`` sets ``requires_grad_(False)`` on the
  others and leaves them out of the optimizer, so they stay bit-identical
  and their backward is never built.

The learning rate is set from the schedule of the step count before each
step, as optax reads ``count`` before it increments (``Scheduled``).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch


class Lars(torch.optim.Optimizer):
    """Reference-exact LARS (``mfvit_tpu/train/optim.py::lars`` :31-63):
    for each parameter with ndim > 1, ``dp = g + wd * p`` scaled by
    ``trust * ||p|| / ||dp||`` (1 where either norm is 0); other
    parameters take the plain gradient; then ``mu = mu * momentum + dp``
    and ``p -= lr * mu``."""

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                dp = p.grad
                if p.ndim > 1:
                    dp = dp + group["weight_decay"] * p
                    pn, un = torch.linalg.norm(p), torch.linalg.norm(dp)
                    q = torch.where(
                        (pn > 0) & (un > 0),
                        group["trust_coefficient"] * pn / un,
                        torch.ones_like(pn))
                    dp = dp * q
                state = self.state[p]
                mu = state.get("mu")
                if mu is None:
                    mu = state["mu"] = torch.zeros_like(p)
                mu.mul_(group["momentum"]).add_(dp)
                p.add_(mu, alpha=-group["lr"])


class Scheduled:
    """An optimizer whose learning rate comes from ``lr(count)`` before
    each step (a float is a constant schedule)."""

    def __init__(self, opt: torch.optim.Optimizer, lr):
        self.opt, self.lr, self.count = opt, lr, 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = float(self.lr(self.count)) if callable(self.lr) else self.lr
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(state["opt"])


# -------------------------------------------------------------- schedules

def scaled_init_lr(lr: float, batch_size: int, *, cos: bool,
                   entry: str) -> float:
    """The reference's batch-size LR scaling, applied only in cosine mode:
    lr * bs / 4 for pretrain, lr * bs / 8 for finetune and fusion."""
    if not cos:
        return lr
    div = 4.0 if entry == "pretrain" else 8.0
    return lr * batch_size / div


def pretrain_cosine_lr(init_lr: float, epochs: int, warmup_epochs: int,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step schedule over FRACTIONAL epochs e = step / steps_per_epoch
    (``mfvit_tpu/train/optim.py:80``): linear warmup ``init_lr * e /
    warmup_epochs``, then the half-cycle cosine from ``warmup_epochs`` to
    ``epochs``, each divisor guarded by ``max(..., 1e-8)``."""

    def sched(step: int) -> float:
        e = step / steps_per_epoch
        if e < warmup_epochs:
            return init_lr * e / max(warmup_epochs, 1e-8)
        return init_lr * 0.5 * (1.0 + math.cos(
            math.pi * (e - warmup_epochs)
            / max(epochs - warmup_epochs, 1e-8)))

    return sched


def moco_momentum(epoch_frac: float, m0: float, epochs: int) -> float:
    """The cosine ramp of the EMA momentum from ``m0`` to 1
    (``mfvit_tpu/train/optim.py:121``)."""
    return 1.0 - 0.5 * (1.0 + math.cos(math.pi * epoch_frac / epochs)) \
        * (1.0 - m0)


def finetune_lr(init_lr: float, epochs: int, *, cos: bool,
                schedule: Sequence[int] = (),
                steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Per-EPOCH schedule of the step count, epoch = floor(step /
    steps_per_epoch): cosine ``init_lr * 0.5 * (1 + cos(pi * epoch /
    epochs))`` or 0.1x at each milestone."""

    def sched(step: int) -> float:
        e = step // steps_per_epoch
        if cos:
            return init_lr * 0.5 * (1.0 + math.cos(math.pi * e / epochs))
        return init_lr * 0.1 ** sum(e >= m for m in schedule)

    return sched


# -------------------------------------------------------------- builders

def head_only_mask(named_params: Iterable) -> dict:
    """{parameter name: trainable}, True only under the classifier head
    (``head.*``): the linear-probe freeze-all-but-head."""
    return {name: name.split(".")[0] == "head" for name, _ in named_params}


def build_optimizer(name: str, named_params: Iterable, lr, *,
                    weight_decay: float = 0.0, momentum: float = 0.9,
                    trainable_mask: Optional[dict] = None) -> Scheduled:
    """sgd | adam | adamw | lars over ``named_params`` (``model.
    named_parameters()``) with the schedule ``lr``. Parameters the mask
    marks False are frozen: ``requires_grad_(False)``, not in the
    optimizer."""
    params = []
    for pname, p in named_params:
        if trainable_mask is not None and not trainable_mask[pname]:
            p.requires_grad_(False)
        elif p.requires_grad:
            params.append(p)
    name = name.lower()
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              weight_decay=weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=0.0)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=0.0, weight_decay=weight_decay)
    elif name == "lars":
        opt = Lars(params, weight_decay=weight_decay, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return Scheduled(opt, lr)
