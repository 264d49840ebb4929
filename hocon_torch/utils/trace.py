"""Named spans at the layer boundaries of the train and eval steps.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs (the benchmark's traced stretch, the CLIs' ``--profile``,
``tools/profile_step_torch.py``), so it shares the profiler's clock with
the device trace; otherwise it is one shared no-op, and costs the check.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str, arg: str | None = None):
    """A profiler range named ``name`` (``arg`` as its argument) when a
    profiler is running, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name, arg)
    return _OFF
