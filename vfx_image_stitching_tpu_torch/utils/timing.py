"""Device time of a call on the card, for the chip run and the probes."""

from __future__ import annotations


def kernel_profile(fn, reps: int = 20, warmup: int = 3,
                   attempts: int = 6) -> dict:
    """``{device kernel name: (launches, device us)}`` over ``reps`` calls
    of ``fn``, from ``torch.profiler``.  (CUDA events around a call would
    also count the wrapper's host work, which at these sizes is longer
    than the kernels.)"""
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
        events = {e.key: (e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(us for _n, us in events.values()) > 0:
            return events
    raise RuntimeError("the profiler recorded no device time")


def device_profile(fn, reps: int = 20, warmup: int = 3, attempts: int = 6):
    """Device time (ms) and device kernels of one call of ``fn``: the
    CUDA kernels it launches, summed over :func:`kernel_profile`."""
    events = kernel_profile(fn, reps, warmup, attempts).values()
    return (sum(us for _n, us in events) / reps / 1e3,
            sum(n for n, _us in events) / reps)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, reps, warmup)[0]


def one_kernel_ms(fn, counter: str, reps: int = 20) -> float:
    """Device ms of one call of ``fn``, a call of the kernel wrapper that
    counts its launches in ``kernels.LAUNCHES[counter]``, which must run
    exactly one device kernel per call.  The launches come from the
    wrapper's count, which must rise by one per call (the wrapper raises
    on a refused launch); the profiler must see one kernel name and no
    more of its launches than calls.  It may miss some of a session's
    launches, so the time is the mean over the launches it saw.  A second
    kernel, or a kernel launched twice a call, fails."""
    from vfx_image_stitching_tpu_torch.models.sift import kernels as K

    calls = 0

    def call():
        nonlocal calls
        calls += 1
        fn()

    n0 = K.LAUNCHES[counter]
    events = kernel_profile(call, reps)
    launched = K.LAUNCHES[counter] - n0
    seen = sum(n for n, _us in events.values())
    if launched != calls or len(events) != 1 or not 0 < seen <= reps:
        raise AssertionError(
            f"{counter}: {calls} calls launched the wrapper's kernel {launched} "
            f"times; the profiler saw {sorted(events)} in {seen} device kernels "
            f"over {reps} calls")
    return sum(us for _n, us in events.values()) / seen / 1e3
