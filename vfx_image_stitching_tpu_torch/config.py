"""Configuration dataclasses mirroring every reference algorithm constant.

The reference keeps all constants as function default kwargs (Harris:
``image_stitching_harris.py:135``; SIFT: ``sift_impl.py:15``; thresholds at
``image_stitching_harris.py:490-494`` and ``image_stitching_sift.py:325``).
Here they live in frozen dataclasses so every stage is explicitly
parameterized and hashable.

This is the PyTorch port's copy of the JAX package's ``config.py``, with
its algorithm constants and capacities kept field for field so
:func:`config_from_dict` can carry a configuration across.  The JAX
package's switches between TPU variants of a stage have no field here:
the port has one path (the resident localize and the window kernels,
which run their plain versions on CPU tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HarrisConfig:
    """Harris corner backend constants (image_stitching_harris.py:135)."""

    max_points: int = 200
    k: float = 0.05
    block_size: int = 21          # GaussianBlur ksize for structure tensor
    gauss_sigma: float = 2.0
    thresh_ratio: float = 0.02
    border_margin: int = 8        # keypoints closer than this to the border
    #                               are dropped (image_stitching_harris.py:204)
    patch_size: int = 16          # descriptor patch (image_stitching_harris.py:86)
    desc_blur_ksize: int = 9      # GaussianBlur((9,9), 4.5) on patch magnitudes
    desc_blur_sigma: float = 4.5  # (image_stitching_harris.py:91)
    desc_bins: int = 8
    desc_cells: int = 4
    desc_clip: float = 0.2


@dataclasses.dataclass(frozen=True)
class SiftCapacities:
    """Fixed capacities for the masked, fixed-shape SIFT pipeline.

    The reference uses dynamically sized Python lists; here every stage is
    fixed shape with validity masks.  Values were audited against the four
    reference datasets (out/wind/parrington/grail) with >=2x headroom; the
    audit utility lives in :mod:`vfx_image_stitching_tpu_torch.utils.capacity`.
    """

    # Per-octave capacity tables (index = octave, last entry repeats).
    # Sized from a full audit over every image of the four reference
    # datasets (utils/capacity.py) with >= 1.35x headroom; per-dataset
    # measured maxima are in the comments.
    #
    # raw 26-neighbor extrema candidates  (audit: 2435 / 738 / 211 / 67)
    candidate_caps: Tuple[int, ...] = (4096, 1024, 384, 160, 128)
    # surviving localized candidates      (audit: 1478 / 430 / 122 / 50)
    localized_caps: Tuple[int, ...] = (2048, 640, 224, 128)
    # oriented keypoints (peak expansion) (audit: 1790 / 466 / 154 / 67)
    oriented_caps: Tuple[int, ...] = (2560, 640, 256, 128)
    # Orientation peaks emitted per localized candidate
    # (sift_impl.py:280-292 can emit several; audit max is 5).
    max_orientations: int = 8
    # Final per-image keypoint capacity after dedup/compaction (matching
    # operates on (max_keypoints, 128) descriptor blocks).  Audit max
    # total keypoints/image is ~1900.
    max_keypoints: int = 3072
    # Orientation histogram window half-radius cap (sift_impl.py:254 radius
    # is data dependent; audit max over all dataset images is 17).
    max_radius: int = 20
    # Descriptor sampling window half-width cap (sift_impl.py:386-387
    # half_width is data dependent; audit max is 41, p99 is 38).
    max_half_width: int = 44
    # GEMM chunk for the descriptor two-hot contraction (bounds the
    # intermediates; the live-row bound is a whole number of chunks).
    desc_chunk: int = 64
    # Size-bucketed descriptor windows: keypoints with half-width <=
    # desc_small_half take a small-window pass (57^2 samples instead of
    # 89^2).  Group caps audited per octave over all datasets
    # (small max: 1271/362/108/51; big max: 518/148/53/20, final-set
    # counts; caps carry pre-dedup + safety margin).
    desc_bucketed: bool = True
    desc_small_half: int = 28
    desc_small_caps: Tuple[int, ...] = (2048, 640, 224, 128)
    desc_big_caps: Tuple[int, ...] = (1024, 256, 128, 128)

    @staticmethod
    def _table(table: Tuple[int, ...], octave: int) -> int:
        return table[min(octave, len(table) - 1)]

    # Largest image area (px) the default tables were audited against:
    # the audit ran over every image of all four reference datasets
    # (SURVEY.md section 2.4), whose largest images are wind's 708x434.
    # Capacity counts scale ~linearly with image area at photo-like
    # content, so inputs beyond this area scale the tables up; at or
    # below it the audited headroom already covers the count.
    AUDITED_AREA: int = 708 * 434

    def scaled_for_area(self, h: int, w: int) -> "SiftCapacities":
        """Capacity tables scaled for an (h, w) input image.

        The defaults were audited on 384x512 inputs; a larger image has
        proportionally more extrema/keypoints (the reference's dynamic
        lists just grow — sift_impl.py:117-140 appends per pixel), so
        every count capacity scales by the area ratio, rounded up to a
        multiple of 64 to keep lane-friendly shapes.  At or below the
        audited area this is the identity — the benchmark and all
        reference-dataset executables keep their exact shapes.  Window
        caps (max_radius / max_half_width / desc_small_half) are
        per-octave scale properties, not area properties: a larger image
        adds an octave rather than widening windows, so they stay.
        """
        factor = (h * w) / float(self.AUDITED_AREA)
        if factor <= 1.0:
            return self

        def up64(v: int) -> int:
            return ((int(math.ceil(v * factor)) + 63) // 64) * 64

        def table(t: Tuple[int, ...]) -> Tuple[int, ...]:
            return tuple(up64(v) for v in t)

        return dataclasses.replace(
            self,
            candidate_caps=table(self.candidate_caps),
            localized_caps=table(self.localized_caps),
            oriented_caps=table(self.oriented_caps),
            max_keypoints=up64(self.max_keypoints),
            desc_small_caps=table(self.desc_small_caps),
            desc_big_caps=table(self.desc_big_caps),
        )

    def grown_to_fit(self, stats, headroom: float = 1.5) -> "SiftCapacities":
        """Capacities grown to fit measured per-stage occupancy ``stats``.

        ``stats`` is a (host) dict as produced by
        models/sift/extract.sift_keypoints_and_descriptors — per-octave
        ``*_counts``/``*_caps`` arrays plus ``final_count``/``final_cap``
        (leaves may carry an N-image leading axis; the max is taken).
        Area scaling (:meth:`scaled_for_area`) covers photo-statistics
        inputs; this covers CONTENT denser than the audited photo sets
        (e.g. synthetic scenes) where a count hits its capacity: every
        stage at capacity grows to ``max(count * headroom, 2 * cap)``
        rounded up to a lane-friendly multiple of 64.  Counts may
        themselves be clipped at capacity post-compaction, so the
        ``2 * cap`` floor guarantees geometric progress when the caller
        re-runs and re-checks.  Returns ``self`` (identity, same object)
        when nothing is at capacity — the overflow test the pipeline's
        recovery loop keys on.
        """
        import numpy as np

        def up64(v: float) -> int:
            return ((int(math.ceil(v)) + 63) // 64) * 64

        def maxed(key):
            arr = np.asarray(stats[key])
            if arr.ndim <= 1:
                return arr.reshape(-1)
            return arr.reshape(-1, arr.shape[-1]).max(axis=0)

        def grow(table: Tuple[int, ...], count_key: str, cap_key: str):
            counts, caps = maxed(count_key), maxed(cap_key)
            n = max(len(counts), len(table))
            out = [self._table(table, o) for o in range(n)]
            hit = False
            for o in range(len(counts)):
                c, cap = int(counts[o]), int(caps[o])
                if cap > 1 and c >= cap:
                    out[o] = max(out[o], up64(max(c * headroom, cap * 2.0)))
                    hit = True
            return (tuple(out), hit)

        cand, h1 = grow(self.candidate_caps, "cand_counts", "cand_caps")
        loc, h2 = grow(self.localized_caps, "loc_counts", "loc_caps")
        ori, h3 = grow(self.oriented_caps, "oriented_counts", "oriented_caps")
        big, h4 = grow(self.desc_big_caps, "desc_big_counts", "desc_big_caps")
        fin_count = int(np.max(np.asarray(stats["final_count"])))
        fin_cap = int(np.max(np.asarray(stats["final_cap"])))
        max_kp = self.max_keypoints
        h5 = fin_count >= fin_cap
        if h5:
            max_kp = max(max_kp,
                         up64(max(fin_count * headroom, fin_cap * 2.0)))
        if not (h1 or h2 or h3 or h4 or h5):
            return self
        return dataclasses.replace(
            self,
            candidate_caps=cand,
            localized_caps=loc,
            oriented_caps=ori,
            desc_big_caps=big,
            max_keypoints=max_kp,
        )

    def scaled_candidates(self, octave: int) -> int:
        """Candidate capacity for a given octave (shrinks with area)."""
        return self._table(self.candidate_caps, octave)

    def scaled_oriented(self, octave: int) -> int:
        """Oriented-keypoint capacity per octave (shrinks with area)."""
        return self._table(self.oriented_caps, octave)

    def scaled_localized(self, octave: int) -> int:
        """Localized-candidate capacity per octave (shrinks with area)."""
        return self._table(self.localized_caps, octave)


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """From-scratch SIFT constants (sift_impl.py:15, :117, :169, :246, :361)."""

    sigma: float = 1.6
    num_intervals: int = 3
    assumed_blur: float = 0.5
    image_border_width: int = 5
    contrast_threshold: float = 0.04
    eigen_ratio: float = 10.0
    max_localize_iters: int = 5
    # orientation assignment (sift_impl.py:246)
    radius_factor: float = 3.0
    num_bins: int = 36
    peak_ratio: float = 0.8
    scale_factor: float = 1.5
    # descriptors (sift_impl.py:361)
    window_width: int = 4
    desc_bins: int = 8
    scale_multiplier: float = 3.0
    descriptor_max_value: float = 0.2
    float_tolerance: float = 1e-7
    capacities: SiftCapacities = SiftCapacities()

    @property
    def images_per_octave(self) -> int:
        return self.num_intervals + 3


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """NN matching + translation voting (image_stitching_harris.py:219,:242)."""

    # Absolute squared-L2 threshold on the best match distance.  The
    # reference uses 1.0 for unit-norm Harris descriptors
    # (image_stitching_harris.py:494) and 25000 for 0-255 scaled SIFT
    # descriptors (image_stitching_sift.py:325).  No Lowe ratio in the
    # stitching path.
    desc_thresh: float = 1.0
    ransac_thresh: float = 3.0    # squared-distance vote threshold
    # top-k exact re-check width; 1 = trust the matmul distances (exact for
    # integer-valued SIFT descriptors), >1 = refine (float Harris descs)
    refine: int = 8
    # knife-edge precision escalation: threshold/argmin decisions whose
    # margin is below this are re-decided on host with reference-faithful
    # f64 descriptor math (models/sift/strict.py).  0 disables.  1024 =
    # two worst-case +-1 descriptor-component flips (2 * (2*255 + 1)).
    borderline_margin: float = 0.0


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    """End-to-end pipeline configuration (drives run_panorama parity)."""

    backend: str = "sift"                # "sift" | "harris"
    harris: HarrisConfig = HarrisConfig()
    sift: SiftConfig = SiftConfig()
    crop_margin: int = 15                # rectangle_crop extra_margin default
    black_threshold: int = 0             # rectangle_crop threshold

    def match(self) -> MatchConfig:
        if self.backend == "harris":
            return MatchConfig(desc_thresh=1.0, refine=8)
        return MatchConfig(
            desc_thresh=25000.0, refine=1, borderline_margin=1024.0
        )


DEFAULT_CROP_MARGINS = {
    # Margins used by the author to produce the Result/ goldens
    # (README.md:52-54, report p.16).
    "out": 30,
    "parrington": 15,
    "grail": 17,
    "wind": 24,
}


# JAX-package switches that pick among TPU implementations of one stage;
# every choice computes what the port's single path computes, so they are
# dropped on the way across.
_VARIANT_SWITCHES = frozenset({
    "use_pallas", "localize_split", "localize_slim", "localize_resident",
    "desc_lane_align", "desc_pallas_gather",
})
# JAX-package settings that change the result (bf16 descriptor operands)
# or ask for an output the port does not produce (step mosaics, a
# jax.profiler trace): accepted only at their defaults.
_UNSUPPORTED = {"desc_bf16": False, "save_steps": False, "profile_dir": None}


def config_from_dict(d: dict) -> StitchConfig:
    """Rebuild a :class:`StitchConfig` from ``dataclasses.asdict`` output.

    The system carries no weights, so the configuration is the whole
    state two implementations must share to run the same stitch: feed
    this the ``asdict`` of the JAX package's ``StitchConfig`` to run both
    on one configuration.  Tuples that ``asdict`` turned into lists come
    back as tuples, so the result hashes and compares like a directly
    built config.  Raises ``ValueError`` on a key the port does not know,
    and on a JAX-only setting away from its default.
    """

    def build(cls, fields: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for name, v in fields.items():
            if name in names:
                kwargs[name] = tuple(v) if isinstance(v, list) else v
            elif name in _UNSUPPORTED:
                if v != _UNSUPPORTED[name]:
                    raise ValueError(
                        f"{cls.__name__}.{name}={v!r}: the PyTorch port "
                        f"supports only {_UNSUPPORTED[name]!r}")
            elif name not in _VARIANT_SWITCHES:
                raise ValueError(f"{cls.__name__} has no field {name!r}")
        return cls(**kwargs)

    d = dict(d)
    sift = dict(d.pop("sift", {}))
    caps = build(SiftCapacities, sift.pop("capacities", {}))
    return build(StitchConfig, dict(
        d,
        harris=build(HarrisConfig, d.get("harris", {})),
        sift=dataclasses.replace(build(SiftConfig, sift), capacities=caps),
    ))
