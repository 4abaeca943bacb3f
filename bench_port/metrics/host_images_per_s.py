"""Input images of every completed request over all the time of the
window (host clock; the window runs with the device's activity recorded,
``harness/trace.WindowActivity``)."""

from bench_port.harness.window import images_per_s


def read(run):
    return images_per_s(run.window) if run.window.records else None
