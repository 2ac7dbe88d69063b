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

import numpy as np
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
    each step (a float is a constant schedule). ``name`` is the
    ``build_optimizer`` choice and ``names`` the parameters' names, in the
    order of the optimizer's state."""

    def __init__(self, opt: torch.optim.Optimizer, lr, name: str = "",
                 names: Sequence[str] = ()):
        self.opt, self.lr, self.count = opt, lr, 0
        self.name, self.names = name, list(names)

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
        """The step count and the moments of ``state``; the
        hyperparameters (weight decay, momentum, betas) stay this run's,
        as optax's state holds none of them."""
        self.count = int(state["count"])
        saved = dict(state["opt"])
        saved["param_groups"] = [
            dict(g, params=s["params"]) for g, s in
            zip(self.opt.state_dict()["param_groups"],
                saved["param_groups"])]
        self.opt.load_state_dict(saved)


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
    params, names = [], []
    for pname, p in named_params:
        if trainable_mask is not None and not trainable_mask[pname]:
            p.requires_grad_(False)
        elif p.requires_grad:
            params.append(p)
            names.append(pname)
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
    return Scheduled(opt, lr, name, names)


# ---------------------------------------------------- JAX optimizer states

# the torch state key of each optax moment tree, by optimizer
MOMENTS = {"lars": {"mu": "mu"}, "sgd": {"trace": "momentum_buffer"},
           "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
           "adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"}}


def _optax_parts(opt_state, name: str) -> tuple:
    """({optax moment name: tree}, the torch step count or None, the
    schedule's count) of an optax state of ``mfvit_tpu/train/optim.py::
    build_optimizer`` (:133-165) without a mask, as ``read_tree`` gives it
    (namedtuples as dicts, chains as lists, empty states as None). A state
    of another structure raises, as JAX's ``restore(like=...)`` does."""
    def count(st):
        # ScaleByScheduleState; None where the learning rate is a constant
        return int(np.asarray(st["count"])) if st is not None else 0

    def chain(st, n):
        if not isinstance(st, list) or len(st) != n:
            raise TypeError(f"a chain of {n} expected")
        return st

    try:
        if name == "lars":  # {"mu", "count"}
            if set(opt_state) != {"mu", "count"}:
                raise KeyError(sorted(opt_state))
            return {"mu": opt_state["mu"]}, None, count(opt_state)
        if name in ("adam", "adamw"):
            # (ScaleByAdamState, [adamw: EmptyState,] schedule)
            st = chain(opt_state, 2 if name == "adam" else 3)
            if name == "adamw" and st[1] is not None:
                raise TypeError("adamw's decay state is empty")
            adam = st[0]
            return ({"mu": adam["mu"], "nu": adam["nu"]},
                    int(np.asarray(adam["count"])), count(st[-1]))
        if name == "sgd":
            # (decayed weights | identity, (TraceState, schedule))
            st = chain(opt_state, 2)
            trace, sched = chain(st[1], 2)
            if st[0] is not None:
                raise TypeError("sgd's decay state is empty")
            return {"trace": trace["trace"]}, None, count(sched)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"not an optax {name} state of build_optimizer "
                         f"({type(e).__name__}: {e})") from None
    raise ValueError(f"unknown optimizer {name!r}")


def opt_state_from_jax(opt_state, name: str, opt: Scheduled,
                       to_torch: Callable[[object], dict]) -> dict:
    """The optax state of JAX's ``build_optimizer(name, ...)`` -> the state
    dict ``opt.load_state_dict`` takes: LARS's ``mu`` as ``Lars``'s
    ``"mu"``, Adam's and AdamW's ``mu``, ``nu`` and ``count`` as
    ``exp_avg``, ``exp_avg_sq`` and ``step``, SGD's trace as
    ``momentum_buffer``, and the schedule's step count as
    ``Scheduled.count``. A moment tree has the parameters' structure, so
    ``to_torch`` (the weight bridge of the parameters, e.g. ``exp.
    checkpoint.moco_state_from_jax``) names and transposes it; entries of
    no parameter of ``opt`` (BatchNorm statistics) are dropped, and a
    parameter without one raises."""
    trees, step, count = _optax_parts(opt_state, name)
    named = {MOMENTS[name][k]: to_torch(t) for k, t in trees.items()}
    params = [p for g in opt.opt.param_groups for p in g["params"]]
    state = {}
    for i, (pname, p) in enumerate(zip(opt.names, params)):
        entry = {}
        for key, sd in named.items():
            if pname not in sd:
                raise ValueError(f"the {name} state has no {key} for "
                                 f"{pname}")
            if sd[pname].shape != p.shape:
                raise ValueError(f"the {name} {key} of {pname} is "
                                 f"{tuple(sd[pname].shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            entry[key] = sd[pname].clone()
        if step is not None:
            entry["step"] = torch.tensor(float(step), dtype=torch.float32)
        state[i] = entry
    return {"count": count, "opt": {"state": state,
                                    "param_groups": opt.opt.state_dict()[
                                        "param_groups"]}}
