"""Process start to the first timed request: imports, the CUDA context,
the photo sets drawn, the kernel library built or loaded, and the
warm-up requests (host clock)."""


def read(run):
    return run.setup_s
