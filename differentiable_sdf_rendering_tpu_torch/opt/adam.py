"""Adam with per-variable learning rates, as a plain function on dicts of
tensors.

Counterpart of the JAX package's ``opt/adam.py`` (not ``torch.optim.Adam``):
one (m, v, t) state per parameter dict key, learning rate passed *per step*,
so that the state reset at grid upsampling and the per-key schedules
(``32/res · lr/(1+0.02·i)``, halvings at 480/500) stay identical to the
reference.
"""

from __future__ import annotations

import torch

__all__ = ["adam_init", "adam_step", "simple_lr_decay"]

_BETA1 = 0.9
_BETA2 = 0.999
_EPS = 1e-8


def adam_init(params: dict) -> dict:
    return {
        "m": {k: torch.zeros_like(p) for k, p in params.items()},
        "v": {k: torch.zeros_like(p) for k, p in params.items()},
        # per-key step counters: a parameter's t (not just m/v) resets when
        # it changes shape, e.g. at grid upsampling
        "t": {k: 0 for k in params},
    }


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, lr: dict, mask_updates: bool = False):
    """One Adam update.  ``lr`` maps each key of ``params`` to a scalar
    learning rate.  ``mask_updates``: state and parameters only move where
    the gradient is non-zero.  Returns new dicts; nothing is updated in place."""
    new_t = {k: state["t"][k] + 1 for k in params}
    new_params, new_m, new_v = {}, {}, {}
    for k in params:
        p, g, m, v = params[k], grads[k], state["m"][k], state["v"][k]
        # bias corrections in float32, as the reference computes them
        tf = torch.tensor(float(new_t[k]), dtype=torch.float32)
        c1 = float(1.0 - torch.tensor(_BETA1, dtype=torch.float32) ** tf)
        c2 = float(1.0 - torch.tensor(_BETA2, dtype=torch.float32) ** tf)
        m2 = _BETA1 * m + (1.0 - _BETA1) * g
        v2 = _BETA2 * v + (1.0 - _BETA2) * g * g
        if mask_updates:
            nz = g != 0
            m2 = torch.where(nz, m2, m)
            v2 = torch.where(nz, v2, v)
        step = float(lr[k]) * (m2 / c1) / (torch.sqrt(v2 / c2) + _EPS)
        if mask_updates:
            step = torch.where(g != 0, step, torch.zeros_like(step))
        new_params[k], new_m[k], new_v[k] = p - step, m2, v2
    return new_params, {"m": new_m, "v": new_v, "t": new_t}


def simple_lr_decay(initial_lr: float, decay: float, i: int) -> float:
    """Reference LR schedule: lr/(1+decay·i), further halved after
    iterations 480 and 500."""
    lr = initial_lr / (1.0 + decay * i)
    if i > 480:
        lr = lr / 2.0
    if i > 500:
        lr = lr / 2.0
    return lr
