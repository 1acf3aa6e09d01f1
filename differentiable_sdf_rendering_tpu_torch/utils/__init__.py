"""State conversion utilities."""

from . import convert  # noqa: F401
