"""Synchronizing CUDA operations per request (reads of a device value on
the host, blocking copies), counted by ``torch.cuda.set_sync_debug_mode``
over requests of their own after the window."""


def read(run):
    if not run.syncs:
        return None
    return sum(run.syncs) / len(run.syncs)
