"""Harris detection + matching demo (harris_visualizeUI.py parity): the
counterpart of ``vfx_image_stitching_tpu/viz/harris_demo.py``.

The reference window (harris_visualizeUI.py:224-325) loads two images,
runs its own copy of the Harris stack + ``simple_match(thresh=1.0)``, and
draws red corner dots plus green side-by-side match lines.  Here the
compute is the port's Harris backend and matcher on ``device`` (the card
unless the caller asks for the CPU), with a headless renderer and an
optional PyQt5 shell.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import HarrisConfig
from vfx_image_stitching_tpu_torch.io import load_bgr
from vfx_image_stitching_tpu_torch.match.nn import match_descriptors
from vfx_image_stitching_tpu_torch.models.harris import (
    harris_keypoints_and_descriptors,
)


def harris_match_pair(
    img_a: np.ndarray, img_b: np.ndarray,
    desc_thresh: float = 1.0, cfg: HarrisConfig = HarrisConfig(),
    *, device="cuda",
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List]:
    """Keypoints of both BGR images + matched coordinate pairs."""
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    dev = resolve_device(device)
    # the match distances are exact only in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    xy_a, d_a, v_a = harris_keypoints_and_descriptors(
        torch.as_tensor(np.asarray(img_a), device=dev), cfg)
    xy_b, d_b, v_b = harris_keypoints_and_descriptors(
        torch.as_tensor(np.asarray(img_b), device=dev), cfg)
    best, matched = match_descriptors(d_a, v_a, d_b, v_b, desc_thresh)
    xy_a, xy_b, v_a, v_b, best, matched = (
        t.cpu().numpy() for t in (xy_a, xy_b, v_a, v_b, best, matched))
    kps_a = [tuple(p) for p in xy_a[v_a].tolist()]
    kps_b = [tuple(p) for p in xy_b[v_b].tolist()]
    pairs = [
        (tuple(xy_a[i].tolist()), tuple(xy_b[best[i]].tolist()))
        for i in np.nonzero(matched)[0]
    ]
    return kps_a, kps_b, pairs


def convertCV2Qt(img_bgr: np.ndarray):
    """BGR numpy array -> QPixmap (harris_visualizeUI.py:174-182).

    Requires PyQt5; raises ImportError otherwise.
    """
    from PyQt5.QtGui import QImage, QPixmap

    img_rgb = np.ascontiguousarray(np.asarray(img_bgr)[..., ::-1])
    h, w, ch = img_rgb.shape
    qimg = QImage(img_rgb.data, w, h, ch * w, QImage.Format_RGB888)
    return QPixmap.fromImage(qimg.copy())


def draw_harris_corners_on_image(
    img_bgr: np.ndarray, keypoints
) -> np.ndarray:
    """Red filled dots at ``[(x, y), ...]`` on a copy of the image
    (harris_visualizeUI.py:184-192).  Pure-NumPy disk rasterizer — the
    reference uses cv2.circle(radius=4, filled)."""
    out = np.array(img_bgr, copy=True)
    for (x, y) in keypoints:
        _draw_disk(out, int(x), int(y), 4, (0, 0, 255))
    return out


def _draw_disk(img: np.ndarray, x: int, y: int, r: int, color) -> None:
    h, w = img.shape[:2]
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    disk = (yy * yy + xx * xx) <= r * r
    y0, y1 = max(y - r, 0), min(y + r + 1, h)
    x0, x1 = max(x - r, 0), min(x + r + 1, w)
    sub = disk[y0 - (y - r) : y1 - (y - r), x0 - (x - r) : x1 - (x - r)]
    img[y0:y1, x0:x1][sub] = color


def _draw_line(img: np.ndarray, p1, p2, color) -> None:
    n = int(max(abs(p2[0] - p1[0]), abs(p2[1] - p1[1]))) + 1
    xs = np.clip(np.rint(np.linspace(p1[0], p2[0], n)).astype(int),
                 0, img.shape[1] - 1)
    ys = np.clip(np.rint(np.linspace(p1[1], p2[1], n)).astype(int),
                 0, img.shape[0] - 1)
    img[ys, xs] = color


def draw_matches_side_by_side(
    imgA: np.ndarray, kpsA, imgB: np.ndarray, kpsB, matches
) -> np.ndarray:
    """Horizontal concat of A|B with green match lines, red/blue endpoint
    dots (harris_visualizeUI.py:194-221).  ``matches`` is
    ``[((xA, yA), (xB, yB)), ...]``; kpsA/kpsB are accepted for signature
    parity (the reference ignores them too)."""
    hA, wA = imgA.shape[:2]
    hB, wB = imgB.shape[:2]
    merged = np.zeros((max(hA, hB), wA + wB, 3), np.uint8)
    merged[:hA, :wA] = imgA
    merged[:hB, wA : wA + wB] = imgB
    for (ptA, ptB) in matches:
        p1 = (int(ptA[0]), int(ptA[1]))
        p2 = (int(ptB[0] + wA), int(ptB[1]))
        _draw_line(merged, p1, p2, (0, 255, 0))
        _draw_disk(merged, p1[0], p1[1], 4, (0, 0, 255))
        _draw_disk(merged, p2[0], p2[1], 4, (255, 0, 0))
    return merged


def render_harris_demo(
    path_a: str, path_b: str, out_path: str,
    desc_thresh: float = 1.0, *, device="cuda",
) -> str:
    """Write the corner+match panel as a PNG (headless matplotlib); the
    images' features and matches are computed on ``device``.  Raises
    ``OSError`` when an image cannot be read."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_a = load_bgr(path_a)
    img_b = load_bgr(path_b)
    kps_a, kps_b, pairs = harris_match_pair(img_a, img_b, desc_thresh,
                                            device=device)

    h = max(img_a.shape[0], img_b.shape[0])
    w_a = img_a.shape[1]
    canvas = np.zeros((h, w_a + img_b.shape[1], 3), np.uint8)
    canvas[: img_a.shape[0], :w_a] = img_a[..., ::-1]
    canvas[: img_b.shape[0], w_a:] = img_b[..., ::-1]

    fig, ax = plt.subplots(figsize=(14, 7))
    ax.imshow(canvas)
    for (x, y) in kps_a:
        ax.plot(x, y, ".", color="red", markersize=3)
    for (x, y) in kps_b:
        ax.plot(x + w_a, y, ".", color="red", markersize=3)
    for (pa, pb) in pairs:
        ax.plot([pa[0], pb[0] + w_a], [pa[1], pb[1]], "-",
                color="lime", linewidth=0.6)
    ax.set_title(f"Harris corners + {len(pairs)} matches")
    ax.set_axis_off()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


try:  # pragma: no cover - requires PyQt5
    from PyQt5.QtWidgets import QMainWindow  # type: ignore

    class HarrisDemoWindow(QMainWindow):
        """PyQt5 shell: Load A / Load B / run detection + matching."""

        def __init__(self, device="cuda"):
            from PyQt5.QtWidgets import (
                QWidget, QPushButton, QLabel, QVBoxLayout, QHBoxLayout,
                QFileDialog,
            )
            from PyQt5.QtGui import QPixmap

            super().__init__()
            self._paths: List[Optional[str]] = [None, None]
            central = QWidget()
            layout = QVBoxLayout(central)
            row = QHBoxLayout()
            self._label = QLabel("load two images, then run")
            for i, name in enumerate(["Load Image A", "Load Image B"]):
                btn = QPushButton(name)

                def pick(_=None, idx=i):
                    p, _f = QFileDialog.getOpenFileName(self, "image")
                    if p:
                        self._paths[idx] = p

                btn.clicked.connect(pick)
                row.addWidget(btn)
            run = QPushButton("Harris Detection + Matching")

            def go():
                import tempfile

                if all(self._paths):
                    out = os.path.join(
                        tempfile.mkdtemp(prefix="harris_viz_"), "demo.png"
                    )
                    render_harris_demo(self._paths[0], self._paths[1], out,
                                       device=device)
                    self._label.setPixmap(QPixmap(out))

            run.clicked.connect(go)
            row.addWidget(run)
            layout.addLayout(row)
            layout.addWidget(self._label)
            self.setCentralWidget(central)
            self.setWindowTitle("Harris Corner Demo (CUDA)")
            self.resize(1200, 700)

except ImportError:  # pragma: no cover
    HarrisDemoWindow = None  # type: ignore
