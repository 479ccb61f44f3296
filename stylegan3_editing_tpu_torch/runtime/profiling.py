"""Profiler hooks: named ranges and an on-demand `torch.profiler` capture.

Counterpart of the JAX package's `runtime/profiling.py` (reference
torch_utils/misc.py:102-110 `profiled_function`, the `record_function`
scopes of setgan/training_loop.py):

- ``profiled_scope(name)`` / ``@profiled_function`` open a
  `torch.profiler.record_function` range, visible in a captured trace, and
  add the scope's host wall time to a module-level collector that the
  training loops drain into their stats (``Timing/<name>``);
- ``maybe_start_trace(dir)`` / ``stop_trace()`` run a `torch.profiler.profile`
  (CPU, and CUDA where a card is present) gated by an argument or the
  ``SG3TPU_TRACE_DIR`` variable, and write its Chrome trace into that
  directory when it stops.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch

# Host wall time per scope name (seconds, cumulative); the training loops
# drain it into their stats each tick (`Timing/<name>`).
_scope_times: Dict[str, float] = {}
_scope_counts: Dict[str, int] = {}


@contextlib.contextmanager
def profiled_scope(name: str):
    """A `record_function` range and host wall-time accumulation for `name`."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _scope_times[name] = _scope_times.get(name, 0.0) + dt
    _scope_counts[name] = _scope_counts.get(name, 0) + 1


def profiled_function(fn):
    """Decorator form (reference `misc.profiled_function`)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with profiled_scope(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapper


def drain_scope_times(reset: bool = True) -> Dict[str, float]:
    """Cumulative seconds per scope since the last drain."""
    out = dict(_scope_times)
    if reset:
        _scope_times.clear()
        _scope_counts.clear()
    return out


_active: Optional[tuple] = None  # (directory, profile)


def maybe_start_trace(trace_dir: Optional[str] = None) -> bool:
    """Start a `torch.profiler` capture if a directory is given or
    SG3TPU_TRACE_DIR is set. Returns True when a capture started."""
    global _active
    trace_dir = trace_dir or os.environ.get("SG3TPU_TRACE_DIR")
    if not trace_dir or _active is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active = (trace_dir, prof)
    return True


def stop_trace() -> Optional[str]:
    """Stop an active capture and write ``trace_<pid>.json`` (Chrome format)
    into its directory; returns the directory (or None)."""
    global _active
    if _active is None:
        return None
    (trace_dir, prof), _active = _active, None
    prof.stop()
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(trace_dir) / f"trace_{os.getpid()}.json"))
    return trace_dir
