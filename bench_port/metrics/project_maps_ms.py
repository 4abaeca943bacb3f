"""The window's mean of the program's own ``timings["project.maps"]``:
the span in which the host builds the per-focal projection index maps
(float64 NumPy, ``geometry/cylindrical.py``), over the completed
requests, in ms per request.  Nothing to read where the program has no
such span."""

from bench_port.harness.window import mean_phase_ms


def read(run):
    return mean_phase_ms(run.window, "project.maps")
