"""A profiler trace around a block of work (port of
``vfd_gan_tpu.obs.profiling.profile_trace``, on ``torch.profiler``).

The JAX module's ``StepTimer`` has no counterpart here: the engines keep
each step's wall time in ``EngineBase.step_seconds``.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``
    (TensorBoard's profile plugin and Perfetto read it); yields the
    profiler, whose ``key_averages()`` hold the times by kernel.  Without
    a ``logdir`` nothing is traced and None is yielded."""
    if not logdir:
        yield None
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
