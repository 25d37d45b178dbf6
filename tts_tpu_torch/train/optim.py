"""Optimizer stack: gradient clip + RAdam + decoupled weight decay + Noam
warmup, skipping non-finite steps, and the gradual-training schedule
(≙ tts_tpu/train/optim.py).

tts_tpu builds it as an optax chain; this module computes what that chain
computes, step for step, as a small optimizer of the port's own
(``torch.optim.RAdam`` and ``clip_grad_norm_`` differ from optax):

- ``clip_by_global_norm``: grads / norm * max_norm where norm >= max_norm
  (no 1e-6 added to the norm);
- ``scale_by_radam``: eps added to sqrt(v_hat) (not to sqrt(v) before the
  bias correction); the rectified update from rho_t >= 5 on;
- ``add_decayed_weights``: ``weight_decay * param`` added to the update of
  the tensors that are of rank >= 2 in tts_tpu's (flax) shapes;
- ``scale_by_learning_rate``: times -lr(count), the schedule read at the
  count before its increment;
- ``apply_if_finite``: a step whose gradients hold an inf or nan changes
  neither the parameters nor the state.

The moment and update arithmetic runs as multi-tensor (``_foreach``) ops on
the parameters' device; the optimizer's scalars are float32, as in optax.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tts_tpu_torch.models.glow.flows import ActNorm

Schedule = Callable[[int], float]
_F = np.float32
# optax's defaults, which tts_tpu uses: RAdam's decays, eps and rho
# threshold; apply_if_finite's limit of skipped steps in a row
B1, B2, EPS, RHO_THRESHOLD = 0.9, 0.999, 1e-8, 5.0
MAX_CONSECUTIVE_NONFINITE = 10000


def noam_schedule(base_lr: float, warmup_steps: int = 4000) -> Schedule:
    """lr * warmup^0.5 * min(step * warmup^-1.5, step^-0.5), step >= 1."""

    def schedule(count: int) -> float:
        step = _F(max(count, 1))
        return float(_F(base_lr * warmup_steps ** 0.5)
                     * min(step * _F(warmup_steps ** -1.5),
                           step ** _F(-0.5)))

    return schedule


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies: rank >= 2 in
    tts_tpu's shapes. The port keeps some of tts_tpu's vectors as 3-D
    tensors: ActNorm ``logs``/``bias`` are (1, C, 1) and weight norm's
    ``weight_g`` (C, 1, 1), where tts_tpu's are (C,); they are not
    decayed."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[name] = (p.ndim >= 2 and not isinstance(mod, ActNorm)
                          and p_name != "weight_g")
    return mask


class RAdamW:
    """The optax chain of ``make_optimizer``, over ``model``'s parameters
    that require grad (reads their ``.grad``; ``step`` updates them in
    place)."""

    def __init__(self, model: nn.Module, lr: Union[float, Schedule],
                 grad_clip: float = 5.0, weight_decay: float = 0.0):
        trained = [(n, p) for n, p in model.named_parameters()
                   if p.requires_grad]
        self.names = [n for n, _ in trained]
        self.params = [p for _, p in trained]
        mask = decay_mask(model)
        self.decayed = [i for i, n in enumerate(self.names) if mask[n]]
        self.schedule = lr if callable(lr) else (lambda count, v=lr: v)
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # applied steps: RAdam's count and the schedule's (optax keeps one
        # each; both stand still on a skipped step, so they are equal)
        self.count = 0
        self.notfinite_count = 0
        self.total_notfinite = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """One update from the parameters' gradients (a missing gradient
        counts as zero). Returns False where a non-finite gradient skipped
        it."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        peak = torch.stack(torch._foreach_norm(grads, float("inf")))
        finite = bool(torch.isfinite(peak).all())
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        self.total_notfinite += 0 if finite else 1
        if not (finite or self.notfinite_count > MAX_CONSECUTIVE_NONFINITE):
            return False

        if self.grad_clip and self.grad_clip > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            within = norm < self.grad_clip
            one = torch.ones((), device=norm.device)
            # t / norm * max_norm where clipped; t / 1 * 1 (exact) where not
            grads = torch._foreach_mul(
                torch._foreach_div(grads, torch.where(within, one, norm)),
                torch.where(within, one, torch.full_like(one, self.grad_clip)))

        lr = self.schedule(self.count)      # read before the increment
        b1, b2 = B1, B2
        self.mu = list(torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                          torch._foreach_mul(self.mu, b1)))
        sq = torch._foreach_mul(grads, grads)
        self.nu = list(torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                          torch._foreach_mul(self.nu, b2)))
        self.count += 1
        t = _F(self.count)
        mu_hat = torch._foreach_div(self.mu, float(_F(1) - _F(b1) ** t))
        b2t = _F(b2) ** t
        nu_hat = torch._foreach_div(self.nu, float(_F(1) - b2t))
        ro_inf = _F(2.0 / (1.0 - b2) - 1.0)
        ro = ro_inf - _F(2) * t * b2t / (_F(1) - b2t)
        if ro >= RHO_THRESHOLD:
            r = np.sqrt((ro - _F(4)) * (ro - _F(2)) * ro_inf
                        / ((ro_inf - _F(4)) * (ro_inf - _F(2)) * ro))
            updates = list(torch._foreach_div(
                torch._foreach_mul(mu_hat, float(r)),
                torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)))
        else:
            updates = list(mu_hat)

        if self.weight_decay and self.weight_decay > 0 and self.decayed:
            idx = self.decayed
            decayed = torch._foreach_add(
                [updates[i] for i in idx],
                torch._foreach_mul([self.params[i] for i in idx],
                                   self.weight_decay))
            for i, u in zip(idx, decayed):
                updates[i] = u

        torch._foreach_add_(self.params, torch._foreach_mul(updates, -lr))
        return True

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: Dict) -> None:
        for key in ("count", "notfinite_count", "total_notfinite"):
            setattr(self, key, int(state[key]))
        for moments, key in ((self.mu, "mu"), (self.nu, "nu")):
            for i, name in enumerate(self.names):
                moments[i] = state[key][name].to(moments[i].device).clone()


def make_optimizer(model: nn.Module, *, lr: float = 1e-4,
                   grad_clip: float = 5.0, weight_decay: float = 0.0,
                   use_noam: bool = False, warmup_steps: int = 4000
                   ) -> RAdamW:
    """(≙ tts_tpu's ``make_optimizer``) for ``model``'s parameters."""
    schedule = noam_schedule(lr, warmup_steps) if use_noam else lr
    return RAdamW(model, schedule, grad_clip=grad_clip,
                  weight_decay=weight_decay)


def gradual_training_schedule(global_step: int,
                              schedule: Sequence[Sequence[int]],
                              num_replicas: int = 1) -> Tuple[int, int]:
    """[[start_step, r, batch_size], ...] -> the (r, batch_size) of the last
    entry whose start the step, times ``num_replicas``, has reached (the
    first entry's before any): tts_tpu scales the step by its replica count
    as the reference scales it by its GPU count. The trainers pass none, as
    tts_tpu's do."""
    step = global_step * max(num_replicas, 1)
    r, bs = schedule[0][1], schedule[0][2]
    for entry in schedule:
        if step >= entry[0]:
            r, bs = entry[1], entry[2]
    return r, bs
