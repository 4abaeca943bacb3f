"""Device time of a call on the card, for the chip run and the probes."""

from __future__ import annotations


def device_profile(fn, reps: int = 20, warmup: int = 3, attempts: int = 3):
    """Device time (ms) and device kernels of one call of ``fn``: the
    CUDA kernels it launches, summed from ``torch.profiler`` over
    ``reps`` calls.  (CUDA events around a call would also count the
    wrapper's host work, which at these sizes is longer than the
    kernels.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then comes back without the device's
    # events; such a session is taken again, up to ``attempts`` times
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            return us / reps / 1e3, sum(e.count for e in events) / reps
    raise RuntimeError("the profiler recorded no device time")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, reps, warmup)[0]
