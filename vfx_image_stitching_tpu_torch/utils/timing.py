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
        events = {}
        for name, us in device_events(prof):
            n, total = events.get(name, (0, 0.0))
            events[name] = (n + 1, total + us)
        if sum(us for _n, us in events.values()) > 0:
            return events
    raise RuntimeError("the profiler recorded no device time")


def device_events(prof) -> list:
    """``(name, device us)`` of every device event (kernels, copies, sets)
    of a finished ``torch.profiler`` session, read from its raw trace:
    ``key_averages()`` takes minutes to build its tables on a trace of a
    few hundred thousand kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_profile(fn, reps: int = 20, warmup: int = 3, attempts: int = 6):
    """Device time (ms) and device kernels of one call of ``fn``: the
    CUDA kernels it launches, summed over :func:`kernel_profile`."""
    events = kernel_profile(fn, reps, warmup, attempts).values()
    return (sum(us for _n, us in events) / reps / 1e3,
            sum(n for n, _us in events) / reps)


def cuda_events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Ms of one call of ``fn`` from CUDA events on the current stream
    around ``reps`` calls in a row: the device's time where the host
    enqueues the calls faster than the device runs them, else the host's
    pace.  For where the profiler records no device time."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms of one call of ``fn`` (:func:`device_profile`)."""
    return device_profile(fn, reps, warmup)[0]


def one_kernel_ms(fn, counter: str, reps: int = 20,
                  launches: dict | None = None) -> float:
    """Device ms of one call of ``fn``, a call of the kernel wrapper that
    counts its launches in ``launches[counter]`` (by default the SIFT
    library's ``kernels.LAUNCHES``), which must run exactly one device
    kernel per call.  The launches come from the
    wrapper's count, which must rise by one per call (the wrapper raises
    on a refused launch); the profiler must see one kernel name and no
    more of its launches than calls.  It may miss some of a session's
    launches, so the time is the mean over the launches it saw.  A second
    kernel, or a kernel launched twice a call, fails."""
    if launches is None:
        from vfx_image_stitching_tpu_torch.models.sift import kernels as K

        launches = K.LAUNCHES
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        fn()

    n0 = launches[counter]
    events = kernel_profile(call, reps)
    launched = launches[counter] - n0
    seen = sum(n for n, _us in events.values())
    if launched != calls or len(events) != 1 or not 0 < seen <= reps:
        raise AssertionError(
            f"{counter}: {calls} calls launched the wrapper's kernel {launched} "
            f"times; the profiler saw {sorted(events)} in {seen} device kernels "
            f"over {reps} calls")
    return sum(us for _n, us in events.values()) / seen / 1e3
