"""End-to-end panorama stitching, one panorama, Harris or SIFT features.

Pipeline phases mirror the reference's ``run_panorama``
(image_stitching_harris.py / image_stitching_sift.py):

  1. load + cylindrical projection          [host decode, device gather]
  2. pairwise shifts: features (Harris corners, or SIFT), nearest-neighbor
     matching and voting translation RANSAC, batched over the N-1
     adjacent pairs                                            [device]
  3. knife-edge escalation of material borderline rows (SIFT)  [host f64]
  4. drift correction                                          [host f64]
  5. sequential compositing on the device (compose/blend.py), then the
     rectangling crop on the host from the device's content bounds

Phases 2 and 3-5 are also the reference's stage API:
:func:`compute_pairwise_shifts`, and :func:`finalize_to_panorama`, the
tail every caller shares (this module and ``pipeline/multi.py``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without CUDA they raise rather than fall back.  TF32 is turned off for
matmuls and cuDNN: the match distances are exact only in full f32
(match/nn.py).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftCapacities, StitchConfig
from vfx_image_stitching_tpu_torch.compose.blend import compose_mosaic
from vfx_image_stitching_tpu_torch.compose.crop import (
    apply_crop,
    mosaic_with_bounds,
)
from vfx_image_stitching_tpu_torch.compose.plan import plan_compose
from vfx_image_stitching_tpu_torch.estimate.drift import correct_drift
from vfx_image_stitching_tpu_torch.estimate.ransac import (
    translation_ransac,
    translation_ransac_material,
)
from vfx_image_stitching_tpu_torch.geometry.cylindrical import (
    cylindrical_project_batch,
)
from vfx_image_stitching_tpu_torch.io import (
    load_dataset,
    save_bgr,
    stack_dataset,
)
from vfx_image_stitching_tpu_torch.match.nn import match_descriptors
from vfx_image_stitching_tpu_torch.models.harris import harris_batch
from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_f32
from vfx_image_stitching_tpu_torch.utils.profiling import (
    Trace,
    count_d2h,
    count_h2d,
    profile_trace,
    request,
    span,
)

# the phases of one pass, whose seconds sum to ``timings["total"]``
PASS_PHASES = ("project", "extract", "pairs", "finalize", "compose", "crop")


@dataclasses.dataclass
class StitchResult:
    """A stitch's panorama and how it got there.  ``timings`` holds
    seconds as floats (each span of the request, by name, and ``total``)
    and counts as ints (each counter: ``passes``, ``h2d_bytes``,
    ``n_maps_built``, ...)."""

    panorama: np.ndarray                  # cropped final panorama (BGR u8)
    mosaic: np.ndarray                    # uncropped mosaic
    shifts: List[Tuple[float, float]]     # raw pairwise shifts
    corrected_shifts: List[Tuple[float, float]]
    pairs: List[Optional[Tuple[Tuple[float, float], Tuple[float, float]]]]
    timings: dict
    # each step's mosaic cropped to its local canvas (return_steps=True)
    steps: Optional[List[np.ndarray]] = None
    # host capacity stats, present ONLY when a SIFT stage count hit its
    # capacity during this run (keypoints may have been truncated)
    capacity_stats: Optional[dict] = None


def resolve_device(device) -> torch.device:
    """The torch device to run on; raises when CUDA is asked for but
    missing (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _pair_shift(
    xy_a, desc_a, valid_a, xy_b, desc_b, valid_b,
    desc_thresh: float, ransac_thresh: float, refine: int = 8,
    margin: float = 0.0,
):
    """Shift + winning pair for a batch of image pairs (leading pair axis).

    Returns the 15-tuple ``(shift, pair_a, pair_b, any_match, n_matched,
    best_b, cand_idx, cand_dist, cand_inm, matched, border_flip,
    border_swap, material, n_material, max_inmargin)`` of the JAX
    package's ``_pair_shift``: with ``margin > 0`` the escalation signals
    are live (``border_flip`` rows sit within ``margin`` of the absolute
    threshold, ``border_swap`` rows within ``margin`` of their argmin
    runner-up; ``material`` marks the rows whose change could alter the
    winning hypothesis; ``cand_inm`` the top-4 candidates within margin of
    the row's best).
    """
    best_b, matched, best_dist, second, cand_idx, cand_dist, n_inmargin = (
        match_descriptors(
            desc_a, valid_a, desc_b, valid_b, desc_thresh, refine=refine,
            return_dist=True, margin=margin,
        )
    )
    n_pairs = xy_a.shape[0]
    bidx = torch.arange(n_pairs, device=xy_a.device)[:, None]
    pts_a = xy_a.to(torch.float32)
    pts_b = xy_b[bidx, best_b.long()].to(torch.float32)
    moves = pts_a - pts_b
    if margin > 0:
        border_flip = valid_a & (torch.abs(best_dist - desc_thresh) < margin)
        # argmin knife edge: relevant when the row is matched now OR could
        # strictly flip to matched
        border_swap = (
            valid_a & ((second - best_dist) < margin)
            & (matched | border_flip)
        )
        cand_inm = cand_dist < cand_dist[..., :1] + margin
        alt_valid = cand_inm[..., 1:]
        alt_moves = pts_a[:, :, None, :] - xy_b[
            bidx[:, :, None], cand_idx[..., 1:].long()
        ].to(torch.float32)
        best_i, votes, any_match, material, n_material = (
            translation_ransac_material(moves, matched, border_flip,
                                        border_swap, alt_moves, alt_valid,
                                        ransac_thresh)
        )
        max_inmargin = torch.amax(
            torch.where(border_swap, n_inmargin, torch.zeros_like(n_inmargin)),
            dim=-1,
        ).to(torch.int32)
    else:
        best_i, votes, any_match = translation_ransac(
            moves, matched, ransac_thresh
        )
        border_flip = torch.zeros_like(matched)
        border_swap = border_flip
        material = border_flip
        n_material = torch.zeros(n_pairs, dtype=torch.int32, device=xy_a.device)
        max_inmargin = n_material
        cand_inm = torch.zeros_like(cand_dist, dtype=torch.bool)
    pick = best_i.long()[:, None, None].expand(-1, 1, 2)
    zero = torch.zeros((), dtype=torch.float32, device=xy_a.device)
    anym = any_match[:, None]
    shift = torch.where(anym, moves.gather(1, pick)[:, 0], zero)
    pair_a = torch.where(anym, pts_a.gather(1, pick)[:, 0], zero)
    pair_b = torch.where(anym, pts_b.gather(1, pick)[:, 0], zero)
    return (
        shift, pair_a, pair_b, any_match, torch.sum(matched, dim=-1),
        best_b, cand_idx, cand_dist, cand_inm, matched, border_flip,
        border_swap, material, n_material, max_inmargin,
    )


def dispatch_pair_step(xy, descs, valid_kp, cfg: StitchConfig):
    """The adjacent-pair step over all N-1 pairs as one batch."""
    mcfg = cfg.match()
    return _pair_shift(
        xy[:-1], descs[:-1], valid_kp[:-1], xy[1:], descs[1:], valid_kp[1:],
        desc_thresh=mcfg.desc_thresh, ransac_thresh=mcfg.ransac_thresh,
        refine=mcfg.refine, margin=mcfg.borderline_margin,
    )


def _lists_from_arrays(
    shifts_np, pa_np, pb_np, any_np, valid: Sequence[bool], n: int
) -> Tuple[List[Tuple[float, float]], List[Optional[tuple]]]:
    """Reference-shaped (shifts, pairs) lists from the pair arrays: an
    invalid image yields ((0,0), dummy pair); no match yields ((0,0),
    None)."""
    shifts: List[Tuple[float, float]] = []
    pairs: List[Optional[tuple]] = []
    for i in range(n - 1):
        if not (valid[i] and valid[i + 1]):
            shifts.append((0.0, 0.0))
            pairs.append(((0.0, 0.0), (0.0, 0.0)))
        elif not any_np[i]:
            shifts.append((0.0, 0.0))
            pairs.append(None)
        else:
            shifts.append((float(shifts_np[i, 0]), float(shifts_np[i, 1])))
            pairs.append(
                (
                    (float(pa_np[i, 0]), float(pa_np[i, 1])),
                    (float(pb_np[i, 0]), float(pb_np[i, 1])),
                )
            )
    return shifts, pairs


def finalize_pairwise_shifts(
    cyl, xy, valid_kp, meta, stats, pair_out,
    valid: Sequence[bool], cfg: StitchConfig,
    timings_out: Optional[dict] = None,
):
    """Pull pair results to the host, warn on capacity hits, escalate
    knife edges.

    ``cyl`` is the (N, H, W, 3) uint8 cylindrical batch, on the host or
    on a device (the strict escalation rebuilds its pyramids from the two
    images of each escalated pair, pulled then).  With
    ``timings_out`` the capacity stats of an overflowing run are stored
    under ``capacity_overflow``, and the escalated pairs, their material
    rows and the escalation time under ``esc_n_pairs`` / ``esc_n_rows`` /
    ``escalate_s``.  Spans ``finalize.pull`` and ``finalize.escalate`` in
    the current request, if any; each pull to the host counts
    in ``d2h_bytes`` / ``n_d2h``.  Returns ``(shifts, pairs,
    match_counts)``.
    """
    mcfg = cfg.match()
    (
        shifts_d, pa_d, pb_d, any_d, counts_d,
        bestb_d, candidx_d, _canddist_d, candinm_d, matched_d, bflip_d,
        bswap_d, material_d, nmaterial_d, maxinm_d,
    ) = pair_out

    def host(t):
        count_d2h(t.nbytes)
        return t.cpu().numpy()

    with span("finalize.pull"):
        shifts_np = host(shifts_d).astype(np.float64)
        pa_np = host(pa_d).astype(np.float64)
        pb_np = host(pb_d).astype(np.float64)
        any_np = host(any_d).copy()
        counts = host(counts_d).astype(np.int64)
        nmaterial_np = host(nmaterial_d).astype(np.int64)
        maxinm_np = host(maxinm_d).astype(np.int64)
        host_stats = (None if stats is None
                      else {key: host(v) for key, v in stats.items()})

    # top-4 candidate-capacity guard: the strict re-rank can only consider
    # the candidates the device exported
    n_cand_cap = int(candidx_d.shape[-1])
    if (maxinm_np > n_cand_cap).any():
        warnings.warn(
            "strict escalation candidate capacity exceeded: a borderline "
            f"row has {int(maxinm_np.max())} in-margin candidates but only "
            f"the top {n_cand_cap} are re-ranked (pairs "
            f"{np.nonzero(maxinm_np > n_cand_cap)[0].tolist()}); parity "
            "may degrade — raise the candidate width in match_descriptors",
            RuntimeWarning, stacklevel=2,
        )
    if host_stats is not None:
        from vfx_image_stitching_tpu_torch.utils.capacity import (
            capacity_overflow_report,
        )

        overflow_msgs = capacity_overflow_report(host_stats)
        for msg in overflow_msgs:
            warnings.warn(f"SIFT capacity: {msg}", RuntimeWarning, stacklevel=2)
        if overflow_msgs and timings_out is not None:
            timings_out["capacity_overflow"] = host_stats

    # knife-edge precision escalation (models/sift/strict.py): pairs where
    # a borderline decision is MATERIAL are re-decided on host with
    # reference-exact arithmetic + an f64 re-vote
    esc_rows = []
    if meta is not None and mcfg.borderline_margin > 0:
        esc_rows = [
            int(i) for i in np.nonzero(nmaterial_np > 0)[0]
            if valid[int(i)] and valid[int(i) + 1]
        ]
    if timings_out is not None:
        timings_out["esc_n_pairs"] = len(esc_rows)
        timings_out["esc_n_rows"] = int(nmaterial_np[esc_rows].sum())
    if esc_rows:
        with span("finalize.escalate") as esc_span:
            from vfx_image_stitching_tpu_torch.models.sift.strict import (
                escalate_pair,
            )

            xy_np = host(xy).astype(np.float64)
            meta_np = {k: host(v) for k, v in meta.items()}
            validkp_np = host(valid_kp)
            bestb_np = host(bestb_d).astype(np.int64)
            candidx_np = host(candidx_d).astype(np.int64)
            candinm_np = host(candinm_d)
            matched_np = host(matched_d)
            bflip_np = host(bflip_d)
            bswap_np = host(bswap_d)
            material_np = host(material_d)
            for i in esc_rows:
                pair_imgs = cyl[i:i + 2]
                if torch.is_tensor(pair_imgs):
                    count_d2h(pair_imgs.nbytes)
                    pair_imgs = pair_imgs.cpu().numpy()
                esc = escalate_pair(
                    pair_imgs[0], pair_imgs[1],
                    xy_np[i], {k: v[i] for k, v in meta_np.items()},
                    xy_np[i + 1], {k: v[i + 1] for k, v in meta_np.items()},
                    validkp_np[i], bestb_np[i], candidx_np[i], candinm_np[i],
                    matched_np[i], bflip_np[i], bswap_np[i], material_np[i],
                    cfg=cfg.sift,
                    desc_thresh=mcfg.desc_thresh,
                    ransac_thresh=mcfg.ransac_thresh,
                )
                if esc is None:
                    continue  # strict pass confirmed the device result
                shift, pair, anym = esc
                any_np[i] = anym
                if anym:
                    shifts_np[i] = shift
                    pa_np[i] = pair[0]
                    pb_np[i] = pair[1]
        if timings_out is not None:
            timings_out["escalate_s"] = esc_span.seconds

    shifts, pairs = _lists_from_arrays(
        shifts_np, pa_np, pb_np, any_np, valid, int(cyl.shape[0])
    )
    return shifts, pairs, counts


def _autoscale_sift_caps(cfg: StitchConfig, hw) -> Tuple[StitchConfig, bool]:
    """Swap in area-scaled SIFT capacities for larger-than-audited inputs.

    Only the DEFAULT tables are touched — explicitly configured
    capacities are the user's contract.  At reference-dataset sizes this
    is the identity.  Returns ``(cfg, managed)``: ``managed`` is True
    when the capacities are framework-owned, the gate for the overflow
    recovery loop (never for a backend other than SIFT).
    """
    if cfg.backend != "sift":
        return cfg, False
    caps = cfg.sift.capacities
    if caps != SiftCapacities():
        return cfg, False
    scaled = caps.scaled_for_area(*hw)
    if scaled == caps:
        return cfg, True
    return dataclasses.replace(
        cfg, sift=dataclasses.replace(cfg.sift, capacities=scaled)
    ), True


def extract_features(cyl: torch.Tensor, cfg: StitchConfig):
    """Batched feature extraction of the (N, H, W, 3) uint8 cylindrical
    BGR batch: Harris on the BGR images, SIFT on their gray.

    Returns ``(xy, descs, valid_kp, meta, stats)``; ``meta``/``stats``
    are ``None`` for the Harris backend.  ``VFX_SIFT_BATCH_MODE`` picks
    the SIFT schedule, as in the JAX package: ``map`` (the default) or
    ``vmap`` (see ``models.sift.extract.sift_batch``).
    """
    if cfg.backend == "harris":
        xy, descs, valid_kp = harris_batch(cyl, cfg.harris)
        return xy, descs, valid_kp, None, None
    if cfg.backend != "sift":
        raise ValueError(f"unknown backend {cfg.backend!r} (harris or sift)")
    from vfx_image_stitching_tpu_torch.models.sift.extract import (
        sift_batch_with_stats,
    )

    mode = os.environ.get("VFX_SIFT_BATCH_MODE", "map")
    return sift_batch_with_stats(bgr_to_gray_f32(cyl), cfg.sift, mode)


def compute_pairwise_shifts(
    cyl: torch.Tensor, valid: Sequence[bool], cfg: StitchConfig,
) -> Tuple[List[Tuple[float, float]], List[Optional[tuple]], np.ndarray]:
    """Batched feature extraction + adjacent-pair shift estimation on the
    (N, H, W, 3) uint8 cylindrical batch's device.

    Returns (shifts, pairs, match_counts); unreadable images produce the
    reference's degraded ((0,0), dummy pair) entries
    (image_stitching_harris.py:479-482).
    """
    xy, descs, valid_kp, meta, stats = extract_features(cyl, cfg)
    pair_out = dispatch_pair_step(xy, descs, valid_kp, cfg)
    return finalize_pairwise_shifts(
        cyl, xy, valid_kp, meta, stats, pair_out, list(valid), cfg,
    )


@dataclasses.dataclass
class _Finalized:
    """Output of the shared finalize -> compose tail."""

    panorama: np.ndarray
    mosaic: np.ndarray
    shifts: List[Tuple[float, float]]
    corrected: List[Tuple[float, float]]
    pairs: list
    counts: np.ndarray
    steps: Optional[List[np.ndarray]]
    finalize_s: float
    compose_s: float
    crop_s: float
    detail: dict  # escalation counts and time, capacity overflow stats


def finalize_to_panorama(
    cyl: torch.Tensor, xy, valid_kp, meta, stats, pair_out,
    valid: Sequence[bool], cfg: StitchConfig, h: int, w: int, margin: int,
    return_steps: bool = False,
) -> _Finalized:
    """Shared pipeline tail: finalize -> drift -> plan -> compose -> crop.

    Used by :func:`stitch_panorama` and ``pipeline.multi.stitch_many``,
    so escalation, planning and compose semantics cannot drift between
    them.  ``cyl`` is the (N, H, W, 3) uint8 cylindrical batch on its
    device.  The fold runs on that device (``compose/blend.py``) and
    only the mosaic, its content bounds and, with ``return_steps``, the
    step crops come back.  Spans ``finalize``, ``compose`` (``.plan``,
    ``.fold``, ``.pull``) and ``crop``, in the current request if any,
    give the phases' seconds.
    """
    detail: dict = {}
    with span("finalize") as finalize:
        shifts, pairs, counts = finalize_pairwise_shifts(
            cyl, xy, valid_kp, meta, stats, pair_out, list(valid), cfg,
            timings_out=detail,
        )
    with span("compose") as compose:
        with span("compose.plan"):
            n = int(cyl.shape[0])
            corrected = correct_drift(shifts, n_images=n)
            plan = plan_compose(h, w, n, list(valid), corrected, pairs)
        with span("compose.fold"):
            out = compose_mosaic(cyl, plan, return_steps=return_steps)
        mosaic_d, steps = out if return_steps else (out, None)
        with span("compose.pull"):
            mosaic, bounds = mosaic_with_bounds(mosaic_d,
                                                cfg.black_threshold)
    with span("crop") as crop:
        panorama = apply_crop(mosaic, bounds, margin)
    return _Finalized(
        panorama=panorama, mosaic=mosaic, shifts=shifts,
        corrected=corrected, pairs=pairs, counts=counts, steps=steps,
        finalize_s=finalize.seconds, compose_s=compose.seconds,
        crop_s=crop.seconds, detail=detail,
    )


def _upload_batch(batch: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The decoded (N, H, W, 3) batch on ``dev`` (span ``project.upload``,
    counted in ``h2d_bytes``); a temporary of the projection's call, so
    the device frees it once the batch is projected."""
    with span("project.upload"):
        count_h2d(batch.nbytes)
        return torch.as_tensor(batch).to(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stitch_panorama(
    folder: str,
    backend: str = "harris",
    pano_file: Optional[str] = None,
    crop_margin: Optional[int] = None,
    cfg: Optional[StitchConfig] = None,
    save_path: Optional[str] = None,
    return_steps: bool = False,
    verbose: bool = False,
    device="cuda",
) -> StitchResult:
    """Stitch one dataset folder end to end with the ``backend``'s
    features (``"harris"``, the reference's default, or ``"sift"``; it
    overrides ``cfg.backend``).

    Images are decoded once; when a SIFT stage count reaches its
    framework-owned capacity, the run repeats with capacities grown to fit
    the measured counts (at most three times), reusing the decoded images.
    ``timings["passes"]`` counts the passes; the other timings are the
    request's spans and counters (``utils/profiling.py``): the last
    pass's, plus the load's and the request's own ``stitch`` seconds.
    The panorama is written to ``save_path`` only when one is given;
    ``return_steps`` fills ``StitchResult.steps``.
    The whole run is traced into ``cfg.profile_dir`` when that is set.
    """
    dev = resolve_device(device)
    cfg = cfg or StitchConfig(backend=backend)
    if cfg.backend != backend:
        cfg = dataclasses.replace(cfg, backend=backend)
    margin = cfg.crop_margin if crop_margin is None else crop_margin
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with profile_trace(cfg.profile_dir), request() as trace:
        with span("load"):
            images, focals, _paths = load_dataset(folder, pano_file)
            if not images:
                raise ValueError("no valid entries in pano.txt")
            batch, valid = stack_dataset(images)
        loaded = trace.take()

        run_cfg, managed = _autoscale_sift_caps(cfg, batch.shape[1:3])
        res = _stitch_inner(trace, batch, valid, focals, margin, run_cfg,
                            dev, verbose, return_steps)
        res.timings.update(loaded)
        res.timings["passes"] = 1
        for passes in range(2, 5):
            if not managed or res.capacity_stats is None:
                break
            grown = run_cfg.sift.capacities.grown_to_fit(res.capacity_stats)
            if grown is run_cfg.sift.capacities:
                break
            warnings.warn(
                "SIFT capacity overflow: re-running with capacities grown "
                "to fit the measured counts (set StitchConfig.sift."
                "capacities explicitly to pin shapes)",
                RuntimeWarning, stacklevel=2,
            )
            run_cfg = dataclasses.replace(
                run_cfg,
                sift=dataclasses.replace(run_cfg.sift, capacities=grown),
            )
            res = _stitch_inner(trace, batch, valid, focals, margin,
                                run_cfg, dev, verbose, return_steps)
            res.timings.update(loaded)
            res.timings["passes"] = passes
    res.timings.update(trace.take())
    # save only when the caller gives a path; the reference's
    # write-into-the-input-folder behavior lives in the CLI
    if save_path:
        save_bgr(save_path, res.panorama)
    return res


def _stitch_inner(
    trace: Trace, batch: np.ndarray, valid: np.ndarray,
    focals: Sequence[float], margin: int, cfg: StitchConfig,
    dev: torch.device, verbose: bool, return_steps: bool = False,
) -> StitchResult:
    """One pass over decoded images: project, extract, match, then the
    shared tail (:func:`finalize_to_panorama`), in the caller's request
    (``trace``).  Its timings are the request's spans and counters since
    the last ``Trace.take``: each phase's host-clock seconds with a
    device synchronize at every phase boundary, and ``total``, the sum of
    the pass's phases (``PASS_PHASES``)."""
    with span("project"):
        cyl = cylindrical_project_batch(_upload_batch(batch, dev),
                                        [float(f) for f in focals])
        _sync(dev)

    with span("extract"):
        xy, descs, valid_kp, meta, stats = extract_features(cyl, cfg)
        _sync(dev)

    with span("pairs"):
        pair_out = dispatch_pair_step(xy, descs, valid_kp, cfg)
        _sync(dev)

    h, w = batch.shape[1:3]
    fin = finalize_to_panorama(
        cyl, xy, valid_kp, meta, stats, pair_out, list(valid), cfg, h, w,
        margin, return_steps=return_steps,
    )
    timings = trace.take()
    timings["total"] = sum(timings[k] for k in PASS_PHASES)
    if verbose:
        features_s = sum(timings[k] for k in PASS_PHASES[:4])
        print(f"Timer: {features_s:.2f} s features + RANSAC "
              f"(matches per pair: {list(map(int, fin.counts))})")
    timings["esc_n_pairs"] = fin.detail.get("esc_n_pairs", 0)
    timings["esc_n_rows"] = fin.detail.get("esc_n_rows", 0)
    if "escalate_s" in fin.detail:
        timings["escalate"] = fin.detail["escalate_s"]
    if verbose:
        print(f"Total: {timings['total']:.2f} s")
    return StitchResult(
        panorama=fin.panorama,
        mosaic=fin.mosaic,
        shifts=fin.shifts,
        corrected_shifts=fin.corrected,
        pairs=fin.pairs,
        timings=timings,
        steps=fin.steps,
        capacity_stats=fin.detail.get("capacity_overflow"),
    )
