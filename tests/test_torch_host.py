"""PyTorch port: the copied host modules, the loader and the projection,
held against the JAX package's originals on the same inputs (exact), plus
the port's import isolation."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT, requires_cv2

torch.set_num_threads(1)


def _write_pano(folder, lines):
    with open(os.path.join(folder, "pano.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _port_fields(jax_dict, port_dict):
    """The JAX ``asdict`` restricted to the port's keys, recursively."""
    return {k: (_port_fields(jax_dict[k], v) if isinstance(v, dict)
                else jax_dict[k]) for k, v in port_dict.items()}


def test_config_copy_and_config_from_dict():
    from vfx_image_stitching_tpu import config as jc
    from vfx_image_stitching_tpu_torch import config as tc

    # every port field equals the JAX default; the JAX fields the port
    # lacks are exactly its TPU-variant switches, its unsupported outputs
    # and the Lowe ratio (the port's matcher has no ratio test)
    jax_only = set()
    for name in ("HarrisConfig", "SiftCapacities", "SiftConfig",
                 "MatchConfig", "StitchConfig"):
        jd = dataclasses.asdict(getattr(jc, name)())
        td = dataclasses.asdict(getattr(tc, name)())
        assert _port_fields(jd, td) == td, name
        jax_only |= set(jd) - set(td)
    assert jax_only == (tc._VARIANT_SWITCHES | set(tc._UNSUPPORTED)
                        | {"lowe_ratio"})
    assert jc.DEFAULT_CROP_MARGINS == tc.DEFAULT_CROP_MARGINS

    caps = jc.SiftCapacities(candidate_caps=(256, 96), max_keypoints=320,
                             max_half_width=24, desc_small_half=12)
    jcfg = jc.StitchConfig(
        crop_margin=9,
        sift=dataclasses.replace(jc.SiftConfig(), capacities=caps,
                                 max_localize_iters=4),
    )
    tcfg = tc.config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, tc.StitchConfig)
    assert (_port_fields(dataclasses.asdict(jcfg), dataclasses.asdict(tcfg))
            == dataclasses.asdict(tcfg))
    assert tcfg.sift.capacities.candidate_caps == (256, 96)
    assert hash(tcfg) == hash(tc.config_from_dict(dataclasses.asdict(jcfg)))
    t_match = dataclasses.asdict(tcfg.match())
    assert _port_fields(dataclasses.asdict(jcfg.match()), t_match) == t_match
    assert jcfg.match().lowe_ratio is None

    # capacity scaling and growth are copies too
    tcaps = tcfg.sift.capacities
    for hw in ((384, 512), (600, 800), (96, 128)):
        t_scaled = dataclasses.asdict(tcaps.scaled_for_area(*hw))
        assert _port_fields(dataclasses.asdict(caps.scaled_for_area(*hw)),
                            t_scaled) == t_scaled
    stats = {
        "cand_counts": np.array([[256, 5]]), "cand_caps": np.array([[256, 96]]),
        "loc_counts": np.array([[10, 5]]), "loc_caps": np.array([[2048, 640]]),
        "oriented_counts": np.array([[10, 5]]),
        "oriented_caps": np.array([[2560, 640]]),
        "desc_big_counts": np.array([[10, 5]]),
        "desc_big_caps": np.array([[1024, 256]]),
        "final_count": np.array([320]), "final_cap": np.array([320]),
    }
    t_grown = dataclasses.asdict(tcaps.grown_to_fit(stats))
    assert _port_fields(dataclasses.asdict(caps.grown_to_fit(stats)),
                        t_grown) == t_grown


@pytest.mark.parametrize("where, field, value, accepted", [
    ("sift", "use_pallas", True, True),
    ("sift", "localize_resident", True, True),
    ("capacities", "desc_pallas_gather", True, True),
    ("capacities", "desc_bf16", True, False),
    ("top", "save_steps", True, False),
    ("top", "profile_dir", "trace", False),
])
def test_config_from_dict_jax_only_settings(where, field, value, accepted):
    """A JAX switch between TPU variants of a stage is dropped; a setting
    that changes the result or asks for an output the port lacks raises."""
    from vfx_image_stitching_tpu import config as jc
    from vfx_image_stitching_tpu_torch import config as tc

    jcfg = jc.StitchConfig()
    if where == "top":
        jcfg = dataclasses.replace(jcfg, **{field: value})
    elif where == "sift":
        jcfg = dataclasses.replace(
            jcfg, sift=dataclasses.replace(jcfg.sift, **{field: value}))
    else:
        caps = dataclasses.replace(jcfg.sift.capacities, **{field: value})
        jcfg = dataclasses.replace(
            jcfg, sift=dataclasses.replace(jcfg.sift, capacities=caps))
    if accepted:
        assert tc.config_from_dict(dataclasses.asdict(jcfg)) == tc.StitchConfig()
    else:
        with pytest.raises(ValueError, match=field):
            tc.config_from_dict(dataclasses.asdict(jcfg))


def test_capacity_overflow_report_matches():
    from vfx_image_stitching_tpu.utils.capacity import (
        capacity_overflow_report as jrep,
    )
    from vfx_image_stitching_tpu_torch.utils.capacity import (
        capacity_overflow_report as trep,
    )

    stats = {
        "cand_counts": np.array([[4096, 3]]), "cand_caps": np.array([[4096, 9]]),
        "final_count": np.array([7]), "final_cap": np.array([8]),
    }
    assert len(trep(stats)) == len(jrep(stats)) == 1
    assert trep({"final_count": 1, "final_cap": 2}) == []


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def test_read_pano_data_and_path_fallback(tmp_path):
    from vfx_image_stitching_tpu import io as jio
    from vfx_image_stitching_tpu_torch import io as tio

    folder = str(tmp_path)
    _write_pano(folder, [
        "C:\\Users\\me\\pics\\A00.JPG", "384 512", "1 0 0", "704.9",
        "b01.png",                      # no focal before the next image: dropped
        "c02.png", "not a number", "  702.5  ",
        "",
        "d03.jpg", "700",
    ])
    pf = os.path.join(folder, "pano.txt")
    assert tio.read_pano_data(pf) == jio.read_pano_data(pf)
    paths, focals = tio.read_pano_data(pf)
    assert paths == ["C:\\Users\\me\\pics\\A00.JPG", "c02.png", "d03.jpg"]
    assert focals == [704.9, 702.5, 700.0]
    for p in paths + [pf]:
        assert tio.resolve_image_path(p, folder) == jio.resolve_image_path(p, folder)
    assert tio.resolve_image_path(paths[0], folder) == os.path.join(folder, "A00.JPG")


@requires_cv2
def test_read_pnm_matches_cv2_imread(tmp_path):
    """The OpenCV-free PNM reader gives cv2.imread's bytes (BGR order)."""
    import cv2

    from chip_smoke import write_ppm
    from vfx_image_stitching_tpu_torch.io import read_pnm

    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    p6 = str(tmp_path / "x.ppm")
    write_ppm(p6, bgr)
    assert np.array_equal(read_pnm(p6), cv2.imread(p6))
    assert np.array_equal(read_pnm(p6), bgr)
    cv2_p6 = str(tmp_path / "y.ppm")          # OpenCV's own P6 writer
    assert cv2.imwrite(cv2_p6, bgr)
    assert np.array_equal(read_pnm(cv2_p6), cv2.imread(cv2_p6))
    gray = rng.integers(0, 256, (9, 11)).astype(np.uint8)
    p5 = str(tmp_path / "g.pgm")
    with open(p5, "wb") as f:                 # header with a comment
        f.write(b"P5\n# made by a test\n11 9\n255\n" + gray.tobytes())
    assert np.array_equal(read_pnm(p5), cv2.imread(p5))

    bad = str(tmp_path / "bad.ppm")
    with open(bad, "wb") as f:
        f.write(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(OSError):
        read_pnm(bad)
    with open(bad, "wb") as f:
        f.write(b"P6\n4 4\n255\n" + bytes(10))  # truncated pixels
    with pytest.raises(OSError):
        read_pnm(bad)


@requires_cv2
def test_load_bgr_decoders_agree(tmp_path, monkeypatch):
    """cv2, PIL and the PNM reader give the same bytes; missing or
    undecodable files raise instead of returning None."""
    import cv2

    from chip_smoke import write_ppm
    from vfx_image_stitching_tpu import io as jio
    from vfx_image_stitching_tpu_torch import io as tio

    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    path = str(tmp_path / "im.png.ppm")
    write_ppm(path, bgr)
    assert np.array_equal(tio.load_bgr(path), jio.load_bgr(path))
    png = str(tmp_path / "im.png")
    cv2.imwrite(png, bgr)
    assert np.array_equal(tio.load_bgr(png), bgr)
    with pytest.raises(OSError):
        tio.load_bgr(str(tmp_path / "missing.png"))

    monkeypatch.setitem(sys.modules, "cv2", None)      # no OpenCV: PIL
    assert np.array_equal(tio.load_bgr(path), bgr)
    assert np.array_equal(tio.load_bgr(png), bgr)
    monkeypatch.setitem(sys.modules, "PIL", None)      # neither: PNM
    assert np.array_equal(tio.load_bgr(path), bgr)
    with pytest.raises(OSError):
        tio.load_bgr(png)


@requires_cv2
def test_load_dataset_and_peek_match(tmp_path):
    from chip_smoke import synth_chain
    from vfx_image_stitching_tpu import io as jio
    from vfx_image_stitching_tpu_torch import io as tio

    folder = str(tmp_path)
    synth_chain(folder, 3, 40, 56, seed=3, focal=200.0)
    with open(os.path.join(folder, "pano.txt"), "a") as f:
        f.write("gone.png\n210.0\n")          # unreadable -> None placeholder
    imgs_t, foc_t, paths_t = tio.load_dataset(folder)
    imgs_j, foc_j, paths_j = jio.load_dataset(folder)
    assert (foc_t, paths_t) == (foc_j, paths_j)
    assert imgs_t[3] is None and imgs_j[3] is None
    for a, b in zip(imgs_t[:3], imgs_j[:3]):
        assert np.array_equal(a, b)
    assert tio.peek_image_size(folder) == jio.peek_image_size(folder) == (40, 56)
    batch, valid = tio.stack_dataset(imgs_t)
    batch_j, valid_j = jio.stack_dataset(imgs_j)
    assert np.array_equal(batch, batch_j) and np.array_equal(valid, valid_j)
    with pytest.raises(ValueError):
        tio.stack_dataset([np.zeros((2, 2, 3), np.uint8),
                           np.zeros((3, 2, 3), np.uint8)])


# ---------------------------------------------------------------------------
# projection, drift, plan, compose, crop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,focal", [(40, 56, 60.0), (31, 47, 300.5)])
def test_cylindrical_projection_matches(h, w, focal):
    from vfx_image_stitching_tpu.geometry import cylindrical as jcyl
    from vfx_image_stitching_tpu_torch.geometry import cylindrical as tcyl

    assert np.array_equal(tcyl.cylindrical_index_map(h, w, focal),
                          jcyl.cylindrical_index_map(h, w, focal))
    rng = np.random.default_rng(h)
    batch = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    got = tcyl.cylindrical_project_batch(torch.as_tensor(batch),
                                         [focal, focal + 1]).numpy()
    for i, f in enumerate((focal, focal + 1)):
        assert np.array_equal(got[i], jcyl.cylindrical_project_host(batch[i], f))
    gray = batch[0, :, :, 0]
    assert np.array_equal(
        tcyl.cylindrical_project(torch.as_tensor(gray), focal).numpy(),
        jcyl.cylindrical_project_host(gray, focal),
    )


def _fake_chain(rng, n, h, w):
    imgs = [rng.integers(1, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]
    shifts = [(float(-w * 0.6 + rng.normal()), float(rng.normal() * 2))
              for _ in range(n - 1)]
    pairs = [((float(rng.random() * w), float(rng.random() * h)),
              (float(rng.random() * w), float(rng.random() * h)))
             for _ in range(n - 1)]
    return imgs, shifts, pairs


def test_drift_plan_compose_crop_match():
    from vfx_image_stitching_tpu.compose import crop as jcrop
    from vfx_image_stitching_tpu.compose import host as jhost
    from vfx_image_stitching_tpu.compose import plan as jplan
    from vfx_image_stitching_tpu.estimate import drift as jdrift
    from vfx_image_stitching_tpu_torch.compose import crop as tcrop
    from vfx_image_stitching_tpu_torch.compose import host as thost
    from vfx_image_stitching_tpu_torch.compose import plan as tplan
    from vfx_image_stitching_tpu_torch.estimate import drift as tdrift

    rng = np.random.default_rng(4)
    n, h, w = 4, 30, 40
    imgs, shifts, pairs = _fake_chain(rng, n, h, w)
    pairs[1] = None
    valid = [True, True, True, True]
    corr = tdrift.correct_drift(shifts, n_images=n)
    assert corr == jdrift.correct_drift(shifts, n_images=n)
    p_t = tplan.plan_compose(h, w, n, valid, corr, pairs)
    p_j = jplan.plan_compose(h, w, n, valid, corr, pairs)
    assert dataclasses.asdict(p_t) == dataclasses.asdict(p_j)
    mos_t = thost.compose_mosaic_host(imgs, p_t)
    mos_j = jhost.compose_mosaic_host(imgs, p_j)
    assert np.array_equal(mos_t, mos_j)
    b_t = thost.content_bounds_host(mos_t, 0)
    assert b_t == jhost.content_bounds_host(mos_j, 0)
    for margin in (0, 3, 100):
        assert np.array_equal(tcrop.apply_crop(mos_t, b_t, margin),
                              jcrop.apply_crop(mos_j, b_t, margin))
        assert np.array_equal(tcrop.rectangle_crop(mos_t, 0, margin),
                              jcrop.rectangle_crop(mos_j, 0, margin))
    black = np.zeros((5, 6, 3), np.uint8)
    assert np.array_equal(tcrop.rectangle_crop(black, 0, 2), black)


# ---------------------------------------------------------------------------
# strict escalation copy
# ---------------------------------------------------------------------------

def _escalation_case():
    k = 6
    xy_a = np.array(
        [[0, 0], [1, 0], [0, 1], [50, 50], [51, 50], [50, 51]], np.float64
    )
    return dict(
        xy_a=xy_a, xy_b=np.zeros((k, 2)), best_b=np.arange(k),
        border=np.array([False] * 5 + [True]), no_swap=np.zeros(k, bool),
        valid_a=np.ones(k, bool),
        meta={m: np.zeros(k) for m in ("size", "angle", "octave", "ix", "iy")},
        img_a=np.zeros((8, 8, 3), np.uint8), img_b=np.ones((8, 8, 3), np.uint8),
        cand_idx=np.arange(k)[:, None], cand_dist=np.zeros((k, 1)),
    )


@pytest.mark.parametrize("matched,forced_rows,expect", [
    # strict confirms the device decision: row 5 stays unmatched
    ([True, True, True, True, True, False], {5: 100.0}, None),
    # strict flips row 5 to matched: cluster B wins, the shift moves
    ([True, True, False, True, True, False], {}, ((50.0, 50.0), True)),
])
def test_escalate_pair_forced_knife_edge(monkeypatch, matched, forced_rows,
                                         expect):
    """A forced knife-edge row through both packages' escalate_pair
    (the strict oracle is replaced by a controlled descriptor, as the JAX
    package's own test does): identical decisions."""
    from vfx_image_stitching_tpu.models.sift import strict as jstrict
    from vfx_image_stitching_tpu_torch.models.sift import strict as tstrict

    c = _escalation_case()
    matched = np.array(matched)

    def fake_desc(image, m, row, cfg):
        if row in forced_rows and image is c["img_a"]:
            return np.full(128, forced_rows[row])
        return np.zeros(128)

    outs = []
    for mod in (jstrict, tstrict):
        monkeypatch.setattr(mod, "_strict_desc_cached", fake_desc)
        outs.append(mod.escalate_pair(
            c["img_a"], c["img_b"], c["xy_a"], c["meta"], c["xy_b"], c["meta"],
            c["valid_a"], c["best_b"], c["cand_idx"], c["cand_dist"],
            matched.copy(), c["border"], c["no_swap"], c["border"].copy(),
            desc_thresh=25000.0,
        ))
    assert outs[0] == outs[1]
    if expect is None:
        assert outs[1] is None
    else:
        shift, pair, anym = outs[1]
        assert (tuple(shift), anym) == expect and pair[0] == (50.0, 50.0)


@requires_cv2
def test_strict_host_pyramid_and_descriptor_copy():
    """The copied strict module rebuilds the same cv2 pyramid and the same
    reference-exact descriptor as the original."""
    from chip_smoke import make_scene
    from vfx_image_stitching_tpu.config import SiftConfig as JCfg
    from vfx_image_stitching_tpu.models.sift import strict as jstrict
    from vfx_image_stitching_tpu_torch.config import SiftConfig as TCfg
    from vfx_image_stitching_tpu_torch.models.sift import strict as tstrict

    img = make_scene(48, 64, 2)
    pj = jstrict.host_gaussian_pyramid(img, JCfg())
    pt = tstrict.host_gaussian_pyramid(img, TCfg())
    assert len(pj) == len(pt)
    for oj, ot in zip(pj, pt):
        for a, b in zip(oj, ot):
            assert np.array_equal(a, b)
    args = ((30.25, 20.5), 3.1, 45.0, 0 + (2 << 8) + (128 << 16))
    assert np.array_equal(
        tstrict.descriptor_strict(*args, pt, TCfg()),
        jstrict.descriptor_strict(*args, pj, JCfg()),
    )


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------

def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter, importing the port and running a tiny stitch
    leaves no ``jax`` and no JAX-package module in sys.modules."""
    code = f"""
import sys, dataclasses
sys.path.insert(0, {REPO_ROOT!r})
import torch
torch.set_num_threads(1)
from chip_smoke import synth_chain
import vfx_image_stitching_tpu_torch as port
from vfx_image_stitching_tpu_torch.config import SiftCapacities, StitchConfig
synth_chain({str(tmp_path)!r}, 3, 48, 64, seed=1, focal=150.0)
caps = SiftCapacities(candidate_caps=(256, 96, 64), localized_caps=(128, 64),
                      oriented_caps=(128, 64), max_keypoints=256,
                      max_radius=10, max_half_width=14)
cfg = StitchConfig()
cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift, capacities=caps))
res = port.stitch_panorama({str(tmp_path)!r}, cfg=cfg, crop_margin=4, device="cpu")
assert res.panorama.ndim == 3 and len(res.shifts) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "vfx_image_stitching_tpu."))
             or m == "vfx_image_stitching_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), (
        out.stdout + out.stderr)


def test_cuda_entry_points_refuse_without_cuda(monkeypatch):
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_escalation_without_cv2_names_the_cause(monkeypatch):
    """The strict pyramid is OpenCV's own, with no substitute: without cv2
    a pair that needs escalation fails with an error naming cv2."""
    from vfx_image_stitching_tpu_torch.models.sift import strict

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        strict.host_gaussian_pyramid(np.zeros((16, 16, 3), np.uint8))


def test_stitch_degrades_on_unreadable_image(tmp_path):
    """An unreadable image yields the reference's degraded entries: shift
    (0, 0) and a dummy pair for both pairs it belongs to."""
    from chip_smoke import synth_chain
    from vfx_image_stitching_tpu_torch.config import SiftCapacities, StitchConfig
    from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama

    folder = str(tmp_path)
    synth_chain(folder, 3, 48, 64, seed=2, focal=150.0)
    os.remove(os.path.join(folder, "im01.png.ppm"))
    caps = SiftCapacities(candidate_caps=(256, 96, 64), localized_caps=(128, 64),
                          oriented_caps=(128, 64), max_keypoints=256,
                          max_radius=10, max_half_width=14)
    cfg = StitchConfig()
    cfg = dataclasses.replace(cfg, sift=dataclasses.replace(cfg.sift,
                                                            capacities=caps))
    res = stitch_panorama(folder, cfg=cfg, crop_margin=2, device="cpu")
    assert res.shifts == [(0.0, 0.0), (0.0, 0.0)]
    assert res.pairs == [((0.0, 0.0), (0.0, 0.0))] * 2
    assert res.panorama.ndim == 3
