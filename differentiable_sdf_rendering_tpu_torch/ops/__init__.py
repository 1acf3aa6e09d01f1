"""Compute layer: interpolation, tracing, warping, redistancing, film."""

from . import film, grid, initializers, interaction, redistance, sampling, sdf, trace, vecmath, warp  # noqa: F401
