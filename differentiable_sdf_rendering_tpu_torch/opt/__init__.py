"""Optimization layer: variables, losses, regularizer, configs, training."""

from . import adam, configs, losses, opt_configs, regularizations, shape_opt, variables  # noqa: F401
