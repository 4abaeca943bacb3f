"""The window's mean of the program's own ``timings["compose.fold"]``:
the span in which the host issues the compositing fold on the device
(``compose/blend.compose_mosaic``, before the mosaic's pull), over the
completed requests, in ms per request.  Nothing to read where the
program has no such span."""

from bench_port.harness.window import mean_phase_ms


def read(run):
    return mean_phase_ms(run.window, "compose.fold")
