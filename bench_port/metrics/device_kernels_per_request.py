"""Device operations (kernels, copies, sets) per request, from the
profiler's trace of the profiled requests."""


def read(run):
    if run.profile is None:
        return None
    return len(run.profile.device_events) / run.profile.requests
