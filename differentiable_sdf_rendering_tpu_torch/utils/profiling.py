"""Timing and tracing.

Counterpart of the JAX package's ``utils/profiling.py``: ``device_time``
(mean seconds of a call after warm-up), an accumulating section
:class:`Timer`, and :func:`trace`, a ``torch.profiler`` trace of a block
written as a Chrome trace (view it in Perfetto or ``chrome://tracing``).
On the card every time is taken after ``torch.cuda.synchronize()``, so it
covers the device's work and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .. import resolve_device

__all__ = ["device_time", "Timer", "trace"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_time(fn, *args, n_runs: int = 5, warmup: int = 1, device=None, **kwargs):
    """``(mean seconds of fn(*args, **kwargs) over n_runs, its last result)``
    after ``warmup`` runs.  On the card each run is timed with CUDA events
    around it, on the host with the host clock.  ``device`` is the device
    ``fn`` runs on (``None``: the card, raising when there is none); pass
    ``fn`` its own ``device`` through a closure."""
    device = resolve_device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    times = []
    for _ in range(n_runs):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return sum(times) / len(times), out


class Timer:
    """Accumulating section timer: ``sections[name]`` is the seconds spent in
    ``with timer.section(name):`` blocks so far, the device synchronised at
    each block's start and end (``device=None``: the card, raising when
    there is none)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(self.device)
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels when ``device`` is the card; ``None`` means the card) and
    write ``log_dir/trace.json``.  Yields the profiler, whose
    ``key_averages()`` sums the time by operation."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
