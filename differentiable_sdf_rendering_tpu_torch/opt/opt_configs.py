"""Optimization/scene configurations with declarative dict inheritance.

Counterpart of the JAX package's ``opt/opt_configs.py``: named configs as
dicts with ``parent`` inheritance, resolved by :func:`process_config_dicts`,
instantiated into :class:`SdfConfig` objects, and overridable from the
command line (``--key=value``).  All of the JAX package's names are
registered: its 39 named configs and the 32 shifted-camera variants.
"""

from __future__ import annotations

import dataclasses
import math

from .configs import apply_cmdline_args
from .variables import SdfVariableSpec, VolumeVariableSpec

__all__ = ["SdfConfig", "get_opt_config", "is_valid_opt_config", "OPT_CONFIG_NAMES"]


@dataclasses.dataclass
class SdfConfig:
    """Resolved optimization config (the JAX package's fields and defaults)."""

    name: str = "no-tex-12"
    n_sensors: int = 12
    angle_shift: float = 0.0
    cameras_top: bool = False
    resx: int = 128
    resy: int = 128
    sdf_res: int = 64
    upsample_iter: tuple = (64, 128)
    use_multiscale_rendering: bool = False
    render_upsample_iter: tuple = (64, 128)
    batch_size: int | None = None
    loss: str = "multiscale_l1"
    sdf_regularizer_weight: float = 1e-5
    param_keys: tuple = ("sdf",)
    param_averaging_beta: float = 0.95
    checkpoint_frequency: int = 64
    tex_upsample_iter: tuple = (100, 128, 160, 170, 192)
    tex_init_value: float = 0.5
    texture_lr: float | None = None
    scene_name: str | None = None  # defaults to the scene argument

    def __post_init__(self):
        if self.batch_size is None:
            self.batch_size = self.n_sensors

    def variables(self):
        """Build the variable specs: the SDF grid, then an albedo volume
        when the second parameter key names one, then a roughness volume
        when the third is ``roughness`` (its schedule is fixed)."""
        out = [
            SdfVariableSpec(
                key="sdf",
                resolution=self.sdf_res,
                upsample_iter=tuple(self.upsample_iter or ()),
                beta=self.param_averaging_beta,
                regularizer_weight=self.sdf_regularizer_weight,
            )
        ]
        if len(self.param_keys) > 1 and self.param_keys[1] in ("albedo", "base_color", "reflectance"):
            out.append(
                VolumeVariableSpec(
                    key="albedo",
                    resolution=self.sdf_res,
                    channels=3,
                    init_value=self.tex_init_value,
                    upsample_iter=tuple(self.tex_upsample_iter),
                    beta=self.param_averaging_beta,
                    lr=self.texture_lr,
                    clamp=(1e-5, 1.0),
                )
            )
        if len(self.param_keys) > 2 and self.param_keys[2] == "roughness":
            out.append(
                VolumeVariableSpec(
                    key="roughness",
                    resolution=max(self.sdf_res // 4, 4),
                    channels=1,
                    init_value=0.5,
                    upsample_iter=(128, 180),
                    beta=self.param_averaging_beta,
                    lr=self.texture_lr,
                    clamp=(0.1, 0.8),
                )
            )
        return out

    # ---- resolution schedule ----
    @property
    def init_res(self):
        if self.use_multiscale_rendering:
            f = 2 ** len(self.render_upsample_iter)
            return (self.resx // f, self.resy // f)
        return (self.resx, self.resy)

    def res_at(self, i: int):
        if not self.use_multiscale_rendering:
            return (self.resx, self.resy)
        ups = sorted(self.render_upsample_iter)
        n = sum(1 for u in ups if i >= u)
        f = 2 ** (len(ups) - n)
        return (self.resx // f, self.resy // f)

    def sensor_indices(self, i: int):
        """Strided view batch."""
        n = self.n_sensors
        if self.batch_size and self.batch_size < n:
            steps = int(math.ceil(n / self.batch_size))
            return [(j * steps + i % steps) % n for j in range(self.batch_size)]
        return list(range(n))


_CONFIG_DICTS = [
    dict(name="base", n_sensors=6, sdf_regularizer_weight=1e-5, loss="multiscale_l1",
         upsample_iter=(64, 128), sdf_res=64, resx=128, resy=128,
         param_keys=("sdf",), param_averaging_beta=0.95),
    dict(name="no-tex-6", parent="base", n_sensors=6, use_multiscale_rendering=True,
         render_upsample_iter=(180,), upsample_iter=(64, 128, 180)),
    dict(name="no-tex-12", parent="no-tex-6", use_multiscale_rendering=False,
         n_sensors=12, upsample_iter=(64, 128), batch_size=6),
    dict(name="torus-shadow-1", parent="no-tex-12", scene_name="torus-shadow",
         use_multiscale_rendering=True, render_upsample_iter=(220,),
         upsample_iter=(128, 140, 180, 220), sdf_res=128, resx=256, resy=256, n_sensors=1),
    dict(name="mirror-opt-1", parent="no-tex-12", scene_name="mirror-opt",
         upsample_iter=(128, 220), sdf_res=64, n_sensors=1),
    dict(name="mirror-opt-hq", parent="no-tex-12", scene_name="mirror-opt",
         use_multiscale_rendering=True, render_upsample_iter=(220,),
         upsample_iter=(128, 180, 220), sdf_res=128, resx=256, resy=256, n_sensors=1),
    dict(name="no-tex-3", parent="no-tex-6", n_sensors=3),
    dict(name="diffuse-6", parent="base", n_sensors=6, use_multiscale_rendering=False,
         upsample_iter=(128, 180), param_keys=("sdf", "albedo")),
    dict(name="principled-6", parent="diffuse-6",
         param_keys=("sdf", "albedo", "roughness")),
    dict(name="diffuse-12", parent="diffuse-6", n_sensors=12, batch_size=6),
    dict(name="principled-12", parent="principled-6", n_sensors=12, batch_size=6,
         upsample_iter=(128, 180)),
    dict(name="diffuse-12-hq", parent="diffuse-12", use_multiscale_rendering=True,
         render_upsample_iter=(220,), upsample_iter=(128, 180, 220), sdf_res=128,
         resx=256, resy=256),
    dict(name="diffuse-12-hqq", parent="diffuse-12", use_multiscale_rendering=True,
         render_upsample_iter=(220, 300), upsample_iter=(128, 180, 220, 270),
         sdf_res=256, resx=512, resy=512),
    dict(name="diffuse-16-hq", parent="diffuse-12-hq", n_sensors=16),
    dict(name="diffuse-20-hq", parent="diffuse-12-hq", n_sensors=20),
    dict(name="diffuse-32-hq", parent="diffuse-12-hq", n_sensors=32),
    dict(name="no-tex-12-hq", parent="no-tex-12", use_multiscale_rendering=True,
         render_upsample_iter=(220,), upsample_iter=(128, 180, 220), sdf_res=128,
         resx=256, resy=256),
    dict(name="no-tex-1-hq", parent="no-tex-12-hq", n_sensors=1),
    dict(name="no-tex-2-hq", parent="no-tex-12-hq", n_sensors=2),
    dict(name="no-tex-3-hq", parent="no-tex-12-hq", n_sensors=3),
    dict(name="no-tex-6-hq", parent="no-tex-12-hq", n_sensors=6),
    dict(name="no-tex-32-hq", parent="no-tex-12-hq", n_sensors=32),
    dict(name="no-tex-1", parent="no-tex-12", n_sensors=1),
    dict(name="no-tex-2", parent="no-tex-12", n_sensors=2),
    dict(name="no-tex-32", parent="no-tex-12", n_sensors=32),
    dict(name="no-tex-32-hq-l1", parent="no-tex-32-hq", loss="l1"),
    dict(name="no-tex-32-hq-mape", parent="no-tex-32-hq", loss="mape"),
    dict(name="no-tex-32-hq-no-reg", parent="no-tex-32-hq",
         sdf_regularizer_weight=0.0, loss="l1"),
    dict(name="no-tex-6-hqq", parent="no-tex-6", use_multiscale_rendering=True,
         render_upsample_iter=(220, 300), upsample_iter=(128, 180, 220, 270),
         sdf_res=256, resx=512, resy=512),
    dict(name="no-tex-12-hqq", parent="no-tex-12", use_multiscale_rendering=True,
         render_upsample_iter=(220, 300), upsample_iter=(128, 180, 220, 270),
         sdf_res=256, resx=512, resy=512),
    dict(name="no-tex-32-hqq", parent="no-tex-12-hqq", n_sensors=32),
    dict(name="principled-12-hq", parent="principled-12", use_multiscale_rendering=True,
         render_upsample_iter=(220,), upsample_iter=(128, 180, 220), sdf_res=128,
         resx=256, resy=256),
    dict(name="principled-12-hqq", parent="principled-12", use_multiscale_rendering=True,
         render_upsample_iter=(220, 300), upsample_iter=(128, 180, 220, 270),
         sdf_res=256, resx=512, resy=512),
    dict(name="principled-16-hq", parent="principled-12-hq", n_sensors=16),
    dict(name="principled-16-hqq", parent="principled-12-hqq", n_sensors=16),
    dict(name="principled-32-hq", parent="principled-16-hq", n_sensors=32),
    dict(name="principled-32-hqq", parent="principled-16-hqq", n_sensors=32),
    dict(name="principled-48-hqq", parent="principled-16-hqq", n_sensors=48),
    dict(name="principled-64-hqq", parent="principled-16-hqq", n_sensors=64),
]

# Shifted-camera variants for the variance figure
_N_SHIFTS = 8
for _shift in range(_N_SHIFTS):
    for _n in (2, 3, 6, 12):
        _CONFIG_DICTS.append(
            dict(name=f"no-tex-{_n}-hq-{_shift}", parent="no-tex-12-hq",
                 n_sensors=_n, angle_shift=_shift / _N_SHIFTS)
        )


def process_config_dicts(configs):
    """Parent-inheritance resolver."""
    assert len({c["name"] for c in configs}) == len(configs), "Config names must be unique"
    name_map = {c["name"]: c for c in configs}
    out = []
    for c in configs:
        chain = []
        cur = c
        while "parent" in cur:
            chain.append(cur)
            cur = name_map[cur["parent"]]
            assert cur not in chain, "Circular config inheritance"
        final = dict(cur)
        for child in reversed(chain):
            final.update(child)
        final.pop("parent", None)
        out.append(final)
    return out


_PROCESSED = process_config_dicts(_CONFIG_DICTS)
_BY_NAME = {d["name"]: d for d in _PROCESSED}
OPT_CONFIG_NAMES = sorted(_BY_NAME)


def is_valid_opt_config(name: str) -> bool:
    return name in _BY_NAME


def get_opt_config(name: str, cmd_args=None):
    """Resolve a named config; apply ``--key=value`` overrides first to the
    config dict, then to the config object.  Returns
    ``(config, remaining_args)``."""
    if name not in _BY_NAME:
        raise ValueError(f"Unknown opt config '{name}'")
    d = dict(_BY_NAME[name])
    remaining = apply_cmdline_args(d, cmd_args) if cmd_args else []
    cfg = SdfConfig(**d)
    if remaining:
        remaining = apply_cmdline_args(cfg, remaining)
    return cfg, remaining
