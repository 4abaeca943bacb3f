"""The SIFT kernels' share of their roofline in the profiled requests:
the sum of the bound (``harness/roofline.py``) of every call of the
localization (K1), orientation-histogram (K2) and descriptor-window (K3)
entry points, over the device time of the kernels launched inside those
calls.  Nothing to read where no such call launched a kernel."""

from bench_port.harness import roofline as R

# (module whose attribute the stitch calls, function, tag)
SITES = (
    ("vfx_image_stitching_tpu_torch.models.sift.kernels",
     "localize_newton_resident", "K1"),
    ("vfx_image_stitching_tpu_torch.models.sift.orientation",
     "orientation_histograms", "K2"),
    ("vfx_image_stitching_tpu_torch.models.sift.descriptor",
     "pair_window_gather", "K3"),
)
BOUNDS = {"K1": R.localize_bound, "K2": R.orientation_bound,
          "K3": R.window_bound}


def read(run):
    if run.profile is None:
        return None
    bound = device = 0.0
    for call in run.profile.calls:
        if call.tag in BOUNDS and call.device_ns > 0:
            bound += BOUNDS[call.tag](call.args)[0]
            device += call.device_ns / 1e6
    return 100.0 * bound / device if device > 0 else None
