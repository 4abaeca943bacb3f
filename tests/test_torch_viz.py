"""PyTorch port, ``viz/``: the visualizers' panel inputs against the JAX
package's on the same images, and the headless renderers' files.

The JAX side runs op by op (``jax.disable_jit()``).  Contracts: Harris
keypoints and matched pairs equal; the SIFT stages' base image, Gaussian
and DoG pyramids bit-equal, the keypoint records' positions and octaves
equal, size, angle and response within rtol 1e-5, descriptors equal
(ROADMAP's contract allows 1 LSB on a small fraction).  The SIFT
comparison runs at small capacities (one per stage) on one image shape,
so the JAX side compiles its per-operation programs once.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 72, 96


def _caps(mod):
    return mod.SiftCapacities(
        candidate_caps=(128,), localized_caps=(96,), oriented_caps=(96,),
        max_keypoints=256, max_radius=12, max_half_width=24,
        desc_small_half=14, desc_small_caps=(96,), desc_big_caps=(96,),
        desc_chunk=32,
    )


@pytest.fixture(scope="module")
def pair():
    """Two overlapping (H, W) BGR crops of one scene (dx = -32)."""
    from vfx_image_stitching_tpu_torch.utils.synthetic import make_scene

    scene = make_scene(H, W + 32, 5, block_px=60, block_size=(2, 6))
    return scene[:, 32:].copy(), scene[:, :W].copy()


@pytest.fixture
def small_caps(monkeypatch):
    """Both packages' reference-signature extractors at small capacities."""
    from vfx_image_stitching_tpu import config as jcfg
    from vfx_image_stitching_tpu.models.sift import extract as jx
    from vfx_image_stitching_tpu_torch import config as tcfg
    from vfx_image_stitching_tpu_torch.models.sift import extract as tx

    monkeypatch.setattr(jx, "SiftConfig",
                        lambda **kw: jcfg.SiftConfig(capacities=_caps(jcfg), **kw))
    monkeypatch.setattr(tx, "SiftConfig",
                        lambda **kw: tcfg.SiftConfig(capacities=_caps(tcfg), **kw))


def test_harris_match_pair_matches_jax(pair):
    from vfx_image_stitching_tpu.viz.harris_demo import harris_match_pair as jmatch
    from vfx_image_stitching_tpu_torch.viz.harris_demo import harris_match_pair

    got = harris_match_pair(*pair, device="cpu")
    with jax.disable_jit():
        want = jmatch(*pair)
    assert len(got[2]) > 10
    for g, w in zip(got, want):
        assert g == w


def test_compute_stages_matches_jax(pair, small_caps):
    from vfx_image_stitching_tpu.viz.sift_visualizer import (
        _gray_f32 as jgray,
        compute_stages as jstages,
    )
    from vfx_image_stitching_tpu_torch.viz.sift_visualizer import (
        _gray_f32,
        compute_stages,
    )

    gray = _gray_f32(pair[0])
    assert np.array_equal(gray, jgray(pair[0]))
    base, pyr, dogs, recs, desc = compute_stages(gray, device="cpu")
    with jax.disable_jit():
        j_base, j_pyr, j_dogs, j_recs, j_desc = jstages(gray)
    assert np.array_equal(base.numpy(), np.asarray(j_base))
    assert len(pyr) == len(j_pyr) and len(dogs) == len(j_dogs)
    for t, j in zip(pyr + dogs, list(j_pyr) + list(j_dogs)):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert len(recs) == len(j_recs) > 10
    assert [r.pt for r in recs] == [r.pt for r in j_recs]
    assert [r.octave for r in recs] == [r.octave for r in j_recs]
    for key in ("size", "angle", "response"):
        np.testing.assert_allclose([getattr(r, key) for r in recs],
                                   [getattr(r, key) for r in j_recs], rtol=1e-5)
    assert np.array_equal(desc, j_desc)


def _jax_panel_names():
    """The panel file names the JAX renderer writes, read from its source."""
    src = open(os.path.join(REPO, "vfx_image_stitching_tpu", "viz",
                            "sift_visualizer.py")).read()
    return set(re.findall(r'"(\d_[a-z_]+\.png)"', src))


def test_renderers_write_the_jax_renderers_files(pair, small_caps, tmp_path):
    from vfx_image_stitching_tpu_torch.io import save_bgr
    from vfx_image_stitching_tpu_torch.viz import (
        render_harris_demo,
        render_sift_report,
    )

    paths = [str(tmp_path / f"im{i}.png") for i in range(2)]
    for p, img in zip(paths, pair):
        save_bgr(p, img)
    written = render_sift_report(paths[0], str(tmp_path / "panels"),
                                 match_path=paths[1], device="cpu")
    names = {os.path.basename(p) for p in written}
    assert len(_jax_panel_names()) == 6 and names == _jax_panel_names()
    assert all(os.path.getsize(p) > 1000 for p in written)
    out = render_harris_demo(*paths, str(tmp_path / "demo.png"), device="cpu")
    assert out == str(tmp_path / "demo.png") and os.path.getsize(out) > 1000


def test_viz_imports_without_pyqt5_or_matplotlib():
    code = ("import sys; import vfx_image_stitching_tpu_torch.viz as v; "
            "from vfx_image_stitching_tpu_torch.viz import harris_demo, sift_visualizer; "
            "print(sorted(m for m in ('PyQt5', 'matplotlib') if m in sys.modules)); "
            "print(v.__all__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "[]", "['render_sift_report', 'render_harris_demo']"]
