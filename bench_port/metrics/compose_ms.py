"""The window's sum of the entry point's ``timings["compose"]`` and
``timings["crop"]`` (host clock, a device synchronize at each phase
boundary) over its completed requests, in ms per request."""

from bench_port.harness.window import mean_phase_ms


def read(run):
    return mean_phase_ms(run.window, "compose", "crop")
