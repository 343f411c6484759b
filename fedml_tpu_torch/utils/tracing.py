"""torch.profiler bridges + compatibility alias for the span tracer, port of
fedml_tpu/utils/tracing.py.

The host-side span path lives in ``fedml_tpu_torch/obs/tracing.py``
(``RoundTracer``, re-exported here as in the reference). What lives here
are the device-level profiler hooks, on ``torch.profiler`` where the
reference has ``jax.profiler``:

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (CPU activity, plus CUDA when the card is in use) writing a TensorBoard /
  Perfetto trace into ``logdir`` when it exits — opt-in because trace
  files are large;
- ``annotate(name)``: a named region inside the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib

from fedml_tpu_torch.obs.tracing import RoundTracer  # noqa: F401 — compat alias


@contextlib.contextmanager
def trace(logdir: str):
    """Device-level trace via torch.profiler (TensorBoard's profiler plugin
    or Perfetto read ``logdir``'s ``*.pt.trace.json``). Wrap a handful of
    rounds, not a whole run. CUDA activity is recorded only in a process
    that already uses the card (the profiler never initializes CUDA)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up inside the profiler trace
    (torch.profiler.record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
