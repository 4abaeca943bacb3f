"""The device's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated``, reset at its start), in 10^6 bytes."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e6
