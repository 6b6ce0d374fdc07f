"""Optimizer and learning-rate schedule of mapper training.

Counterpart of explicit_alignment_for_vqa_tasks_tpu/trainers/optimization.py
(reference: src/trainers/few_shot_vqa_executor.py:65-137): AdamW over the
trainable (mapper) tensors, weight decay 0.01 and ``train.adam_epsilon``,
with the linear, cosine (to eta_min 1e-5) and constant-with-warmup
schedules, global-norm clipping when ``gradient_clipping`` > 0, and the
gradients of ``gradient_accumulation_steps`` micro-steps averaged before
each applied update (reference: src/main.py:118).

The JAX package chains optax transforms: ``clip_by_global_norm``, then
``adamw``, the whole inside ``optax.MultiSteps``. ``MultiStepAdamW`` is that
chain on torch tensors, in optax's order of fp32 arithmetic: the
micro-steps' gradients averaged as MultiSteps averages them (``acc += (g -
acc) / (n + 1)``); on the k-th, the mean clipped, the moments updated as
``(1 - b) * g + b * m``, each divided by its fp32 bias correction ``1 -
b^count``, ``m / (sqrt(v) + eps) + 0.01 * p`` times ``-lr``; the other
micro-steps change no tensor. The schedule is read at the count of updates
applied before this one, as optax's ``scale_by_learning_rate`` reads its
count before incrementing it, and the bias correction counts applied
updates only. (``torch.optim.AdamW`` computes the bias corrections in
float64, which moves the first updates by about 1e-5 of themselves against
optax's.)
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]

WEIGHT_DECAY = 0.01      # torch AdamW's default, used by the reference
BETA1, BETA2 = 0.9, 0.999  # optax.adamw's, torch AdamW's defaults
COSINE_ETA_MIN = 1e-5    # reference: few_shot_vqa_executor.py:100-108


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def make_schedule(config: Any, total_steps: int) -> Schedule:
    """The learning rate at each applied update, per ``train.scheduler``.
    ``linear`` is the JAX package's ``_manual_linear``: optax 0.2.6 has no
    ``optax.schedules.warmup_linear_schedule``, so that is the branch it
    takes."""
    lr = float(config.train.lr)
    warmup = int(config.train.additional.get("warmup_steps", 0))
    kind = config.train.get("scheduler", "none")
    if kind == "linear":
        def linear(step: int) -> float:
            if step < warmup:
                return lr * _clip01(step / max(warmup, 1))
            return lr * _clip01((total_steps - step)
                                / max(total_steps - warmup, 1))
        return linear
    if kind == "cosine":
        def cosine(step: int) -> float:
            if step < warmup:
                return lr * _clip01(step / max(warmup, 1))
            progress = _clip01((step - warmup) / max(total_steps - warmup, 1))
            return COSINE_ETA_MIN + 0.5 * (lr - COSINE_ETA_MIN) * (
                1 + math.cos(math.pi * progress))
        return cosine
    # constant with warmup (reference default branch :109-117)
    if warmup > 0:
        return lambda step: lr * _clip01(step / warmup)
    return lambda step: lr


class MultiStepAdamW:
    """AdamW applied every ``every_k`` micro-steps to the mean of their
    gradients, clipped to global norm ``clipping`` when it is > 0. Call
    ``step()`` after each backward; it reads and clears each tensor's
    ``grad`` and returns whether it applied an update."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Schedule,
                 eps: float, clipping: float = 0.0, every_k: int = 1):
        self.params = list(params)
        self.schedule = schedule
        self.eps = eps
        self.clipping = float(clipping)
        self.every_k = int(every_k)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.applied = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.every_k > 1 else None)

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("MultiStepAdamW.step: a trainable tensor has "
                               "no gradient; run the backward first")
        self.zero_grad()
        if self.acc is not None:
            n = self.mini_step
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads = self.acc
        if self.clipping > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            grads = [torch.where(norm < self.clipping, g,
                                 g / norm * self.clipping) for g in grads]
        self._adamw(grads)
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()
        return True

    def _adamw(self, grads: List[torch.Tensor]) -> None:
        lr = self.schedule(self.applied)
        self.applied += 1
        bc1 = _bias_correction(BETA1, self.applied)
        bc2 = _bias_correction(BETA2, self.applied)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(BETA1).add_(g * (1 - BETA1))
            nu.mul_(BETA2).add_(g * g * (1 - BETA2))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update.add_(p * WEIGHT_DECAY).mul_(-lr)
            p.add_(update)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "acc": self.acc,
                "mini_step": self.mini_step, "applied": self.applied}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.mini_step = int(state["mini_step"])
        self.applied = int(state["applied"])
        with torch.no_grad():
            for name in ("mu", "nu", "acc"):
                for mine, saved in zip(getattr(self, name) or (),
                                       state[name] or ()):
                    mine.copy_(saved)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay^count`` as optax computes it in fp32 (XLA's fp32 power
    is the correctly rounded one, which float64 then a cast to fp32 gives;
    the subtraction from 1 is exact)."""
    return 1.0 - float(np.float32(float(np.float32(decay)) ** count))


def make_optimizer(config: Any, total_steps: int,
                   params: Sequence[torch.Tensor]
                   ) -> Tuple[MultiStepAdamW, Schedule]:
    """(optimizer over ``params``, schedule), from the config's ``train``
    block as the JAX package builds its optax chain."""
    schedule = make_schedule(config, total_steps)
    optimizer = MultiStepAdamW(
        params, schedule,
        eps=float(config.train.get("adam_epsilon", 1e-8)),
        clipping=float(config.train.additional.get("gradient_clipping", 0)),
        every_k=int(config.train.additional.get(
            "gradient_accumulation_steps", 1)),
    )
    return optimizer, schedule


def tree_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out
