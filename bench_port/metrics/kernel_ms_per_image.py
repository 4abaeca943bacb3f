"""The kernels' time per stitched image: the union of the kernels'
intervals over the whole window (copies and sets left out), in ms, over
the images of every completed request."""


def read(run):
    images = sum(r.images for r in run.window.records if r.ok)
    if run.activity is None or not run.activity.ops or not images:
        return None
    return 1e3 * run.activity.kernel_s / images
