"""The window's mean of the program's own ``timings["load.decode"]``:
the span in which the calling thread waits on the image decode pool
(``io.load_dataset``, from the pool's creation to its last decoded
image), over the completed requests, in ms per request.  Nothing to read
where the program has no such span."""

from bench_port.harness.window import mean_phase_ms


def read(run):
    return mean_phase_ms(run.window, "load.decode")
