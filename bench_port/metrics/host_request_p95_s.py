"""The 95th percentile of the wall of every request in the window (host
clock around each call into the entry point)."""

from bench_port.harness.window import percentile


def read(run):
    walls = [r.wall_s for r in run.window.records]
    return percentile(walls, 95) if walls else None
