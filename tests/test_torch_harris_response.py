"""PyTorch port, the Harris response's two routes (``models/harris.py``) on
the CPU, where the kernel of ``csrc/harris_response.cu`` cannot run.

Contracts: a CPU input takes the plain response (``harris_response_plain``,
the ops the JAX-parity tests of ``tests/test_torch_harris.py`` hold) and
counts ``n_harris_kernel_images`` 0, in ``harris_corners`` and in a whole
stitch, and launches nothing; the kernel's wrapper refuses, before any
launch, a batch the kernel does not take (a dtype other than uint8, a
channel count other than 3 or 1, an empty axis, a blur longer than its
shared memory takes) and a CPU batch; its taps are the ones
``gaussian_blur`` applies.  Every library's ctypes signatures (this one's,
the fold's, the SIFT kernels') give each C entry point all its
parameters, the stream included.  The kernel against the plain response, bit
for bit, is ``tests/test_torch_cuda.py``'s, on the card.
"""

import re

import numpy as np
import pytest
import torch

from vfx_image_stitching_tpu_torch.config import HarrisConfig
from vfx_image_stitching_tpu_torch.models import harris as TH
from vfx_image_stitching_tpu_torch.ops.gaussian import gaussian_blur
from vfx_image_stitching_tpu_torch.utils.profiling import request
from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene, synth_chain

torch.set_num_threads(1)


def test_cpu_stitch_takes_the_plain_response(tmp_path):
    """A Harris stitch on the CPU: ``n_harris_kernel_images`` 0 beside
    ``n_images``, no launch, the library never loaded."""
    from vfx_image_stitching_tpu_torch.pipeline import stitch_panorama

    synth_chain(str(tmp_path), 3, 96, 128, seed=5, focal=300.0)
    before = dict(TH.LAUNCHES)
    res = stitch_panorama(str(tmp_path), crop_margin=8, device="cpu")
    assert res.timings["n_images"] == 3
    assert res.timings["n_harris_kernel_images"] == 0
    assert TH.LAUNCHES == before and not TH.LIBRARY.loaded


@pytest.mark.parametrize("shape", [(2, 40, 56, 3), (40, 56, 3), (2, 40, 56),
                                   (1, 2, 33, 41, 3)])
def test_corners_on_the_cpu_use_the_plain_response(shape):
    """``harris_corners`` of a CPU input: its gradients are the plain
    response's, its corners are those of the plain response's field (the
    threshold, NMS and top-k on it), and it counts 0 kernel images."""
    img = torch.as_tensor(
        np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8))
    with request() as trace:
        yy, xx, resp, valid, (ix, iy) = TH.harris_corners(img)
        counts = trace.take()
    assert counts["n_harris_kernel_images"] == 0
    pix, piy, pr = TH.harris_response_plain(img)
    assert torch.equal(ix, pix) and torch.equal(iy, piy)
    lead = ix.shape[:-2]
    flat_r = pr.reshape(-1, pr.shape[-2] * pr.shape[-1])
    idx = (yy * ix.shape[-1] + xx).reshape(flat_r.shape[0], -1).long()
    picked = torch.gather(flat_r, 1, idx).reshape(*lead, -1)
    assert torch.equal(picked[valid], resp[valid])
    assert int(valid.sum()) > 0


@pytest.mark.parametrize("case", ["float_bgr", "four_channels", "one_image",
                                  "empty", "long_blur"])
def test_response_kernel_refuses_what_it_does_not_take(case):
    """The wrapper's argument check, which runs before any launch: uint8
    only, (N, H, W, 3) or (N, H, W), no empty axis, at most ``MAX_TAPS``
    blur taps."""
    cfg = HarrisConfig()
    images = torch.zeros((2, 16, 24, 3), dtype=torch.uint8)
    err = ValueError
    if case == "float_bgr":
        images, err = images.to(torch.float32), TypeError
    elif case == "four_channels":
        images = torch.zeros((2, 16, 24, 4), dtype=torch.uint8)
    elif case == "one_image":
        images = images[0, ..., 0]
    elif case == "empty":
        images = images[:0]
    else:
        cfg = HarrisConfig(block_size=TH.MAX_TAPS + 2)
    with pytest.raises(err):
        TH._check_response_input(images, cfg)
    before = dict(TH.LAUNCHES)
    with pytest.raises(err):
        TH.harris_response_kernel(images, cfg)
    assert TH.LAUNCHES == before


def test_response_kernel_refuses_a_cpu_batch():
    """A batch the kernel takes, but on the CPU: refused before any
    launch, and the channel count read from its layout."""
    bgr = torch.zeros((2, 16, 24, 3), dtype=torch.uint8)
    assert TH._check_response_input(bgr, HarrisConfig()) == 3
    assert TH._check_response_input(bgr[..., 0], HarrisConfig()) == 1
    before = dict(TH.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        TH.harris_response_kernel(bgr)
    assert TH.LAUNCHES == before and not TH.LIBRARY.loaded


@pytest.mark.parametrize("block_size,sigma", [(21, 2.0), (9, 4.5), (4, 1.0),
                                              (1, 2.0), (None, 2.0)])
def test_structure_taps_are_the_blur_gaussian_blur_applies(block_size, sigma):
    """The taps the kernel gets blur as ``gaussian_blur`` does: a blur of
    a field by the taps, rows then columns in tap order with reflected
    borders, equals ``gaussian_blur`` bit for bit."""
    cfg = HarrisConfig(block_size=block_size, gauss_sigma=sigma)
    taps = TH._structure_taps(cfg)
    field = torch.as_tensor(make_scene(64, 48, 7)[..., 1]).to(torch.float32)
    h, w = field.shape
    r = len(taps) // 2

    def reflect(n, pad_lo, pad_hi):
        return torch.as_tensor(np.pad(np.arange(n), (pad_lo, pad_hi),
                                      mode="reflect"))

    rows = field[reflect(h, r, len(taps) - 1 - r)]
    out = None
    for t, k in enumerate(taps):
        term = rows[t:t + h] * float(k)
        out = term if out is None else out + term
    cols = out[:, reflect(w, r, len(taps) - 1 - r)]
    out = None
    for t, k in enumerate(taps):
        term = cols[:, t:t + w] * float(k)
        out = term if out is None else out + term
    assert torch.equal(out, gaussian_blur(field, sigma, block_size))


@pytest.mark.parametrize("module", ["models.harris", "compose.blend",
                                    "models.sift.kernels"])
def test_library_signatures_give_every_c_parameter(module):
    """Each entry point's ctypes signature has one type for each parameter
    of the C function in the library's sources: an argument without one
    (the stream, last) would pass as a 32-bit int."""
    import importlib

    lib = importlib.import_module(
        f"vfx_image_stitching_tpu_torch.{module}").LIBRARY
    text = "".join(p.read_text() for p in lib.sources)
    for entry, argtypes in lib.signatures.items():
        m = re.search(r"\bint\s+%s\s*\(([^)]*)\)\s*\{" % entry, text)
        assert m, entry
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), entry
        assert "stream" in params[-1], entry
