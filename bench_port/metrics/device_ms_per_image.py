"""The device's time per stitched image: the union of the intervals in
which a device operation (kernel, copy or set) ran over the whole window,
in ms, over the images of every completed request (the profiler's device
activity, ``harness/trace.WindowActivity``)."""


def read(run):
    images = sum(r.images for r in run.window.records if r.ok)
    if run.activity is None or not run.activity.ops or not images:
        return None
    return 1e3 * run.activity.busy_s / images
