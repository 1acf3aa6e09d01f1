"""Gradient-method configurations (counterpart of the JAX package's
``opt/configs.py``).

One config per gradient method — the main warp method, its ablations, the
Bangaru-et-al. convolution baseline, shading-only, and finite differences —
registered by name and overridable from the command line via ``--key=value``.
The registry is complete so that names resolve as in the JAX package; a
method whose integrator or warp kind is not implemented here raises when it
is rendered (``models/integrator.py``).
"""

from __future__ import annotations

import dataclasses

from ..ops.sdf import TraceParams
from ..ops.warp import WarpConfig

__all__ = ["BaseConfig", "get_config", "is_valid_config", "apply_cmdline_args", "CONFIG_NAMES"]


@dataclasses.dataclass
class BaseConfig:
    name: str = "default"
    pretty_name: str = "baseconfig"
    learning_rate: float = 4e-2
    n_iter: int = 512
    spp: int = 64
    primal_spp_mult: int = 4
    integrator: str = "sdf_direct_reparam"
    edge_epsilon: float = 0.01
    geom_clamp_threshold: float = 0.05
    warp_weight_strategy: int = 6
    use_finite_differences: bool = False
    fd_epsilon: float = 1e-3
    mask_optimizer: bool = False
    # method of gradient attachment: 'warp' | 'conv' | 'dummy'
    warp_kind: str = "warp"
    normalize_warp_field: bool = True
    max_reparam_depth: int = -1
    n_aux_rays: int = 16  # convolution baseline
    conv_kappa: float = 1e5
    conv_power: float = 3.0

    def warp_config(self) -> WarpConfig:
        return WarpConfig(
            edge_eps=self.edge_epsilon,
            weight_strategy=self.warp_weight_strategy,
            clamping_thresh=self.geom_clamp_threshold,
            normalize_warp_field=self.normalize_warp_field,
            max_reparam_depth=self.max_reparam_depth,
        )

    def trace_params(self) -> TraceParams:
        return TraceParams()


def _mk(name, pretty, **kw):
    return dataclasses.replace(BaseConfig(), name=name, pretty_name=pretty, **kw)


def _registry():
    cfgs = [
        _mk("warp", "Ours"),
        _mk("warpprb", "Ours", integrator="sdf_prb_reparam"),
        _mk("warpprimary", "Ours (primary only)", max_reparam_depth=0),
        _mk("warpprbprimary", "Ours", integrator="sdf_prb_reparam", max_reparam_depth=0),
        _mk("warpnotnormalized", "Ours (not normalized)", normalize_warp_field=False),
        _mk("onlyshadinggrad", "Shading gradients only", warp_kind="dummy"),
        _mk("fd", "Finite differences", use_finite_differences=True, warp_kind="dummy"),
    ]
    for n_aux in (2, 4, 8, 16, 32):
        cfgs.append(
            _mk(
                f"conv{n_aux}" if n_aux != 16 else "conv",
                f"Bangaru et al. 2020 ({n_aux} aux rays)",
                warp_kind="conv",
                n_aux_rays=n_aux,
            )
        )
    return {c.name: c for c in cfgs}


_CONFIGS = _registry()
CONFIG_NAMES = sorted(_CONFIGS)


def is_valid_config(name: str) -> bool:
    return name in _CONFIGS


def get_config(name: str) -> BaseConfig:
    if name not in _CONFIGS:
        raise ValueError(f"Unknown config '{name}'; valid: {CONFIG_NAMES}")
    return dataclasses.replace(_CONFIGS[name])


def apply_cmdline_args(obj, args, allow_fail=False):
    """Generic ``--key=value`` override machinery: the type is coerced from
    the existing attribute value; returns unconsumed args."""
    remaining = []
    for arg in args or []:
        if "=" not in arg:
            remaining.append(arg)
            continue
        k, v = arg.lstrip("-").split("=", 1)
        if isinstance(obj, dict):
            if k not in obj:
                remaining.append(arg)
                continue
            obj[k] = _coerce(obj[k], v)
        else:
            if not hasattr(obj, k):
                remaining.append(arg)
                continue
            setattr(obj, k, _coerce(getattr(obj, k), v))
    return remaining


def _coerce(cur, v: str):
    if isinstance(cur, bool):
        return v.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(v)
    if isinstance(cur, float):
        return float(v)
    if isinstance(cur, (tuple, list)):
        parts = [p for p in v.strip("[]() ").split(",") if p]
        elt = cur[0] if len(cur) else 0
        return type(cur)(_coerce(elt, p) for p in parts)
    return v
