"""SIFT process visualizer (sift_visualizeUI.py parity): the counterpart
of ``vfx_image_stitching_tpu/viz/sift_visualizer.py``.

Panels mirror the reference's six tabs (sift_visualizeUI.py:121-139):
base image, Gaussian pyramid (octave 0), DoG pyramid (octave 0),
converted-keypoint overlay with orientation arrows, first-descriptor bar
chart, and FLANN + homography feature matching between two images (the
matching tab is the only place homography appears in the reference and is
deliberately cv2 on the host, as in the original; sift_visualizeUI.py:
247-273).  The stages run on ``device`` (the card unless the caller asks
for the CPU), so the keypoints come from the SIFT kernels K1-K3.

``render_sift_report`` is the headless path (PNG panels via matplotlib);
``SIFTVisualizer`` is the PyQt5 window when PyQt5 is installed.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vfx_image_stitching_tpu_torch.config import SiftConfig
from vfx_image_stitching_tpu_torch.io import load_bgr
from vfx_image_stitching_tpu_torch.models.sift import (
    compute_keypoints_and_descriptors,
    compute_number_of_octaves,
    generate_base_image,
    generate_dog_images,
    generate_gaussian_images,
    generate_gaussian_kernels,
)
from vfx_image_stitching_tpu_torch.models.sift.extract import KeyPointRecord
from vfx_image_stitching_tpu_torch.ops.color import bgr_to_gray_u8_np


def _gray_f32(path_or_img) -> np.ndarray:
    """A path (read as BGR; ``OSError`` when unreadable) or an image, as
    the reference's float32 gray."""
    img = load_bgr(path_or_img) if isinstance(path_or_img, str) else np.asarray(path_or_img)
    if img.ndim == 3:
        img = bgr_to_gray_u8_np(img)
    return img.astype(np.float32)


def compute_stages(gray: np.ndarray, cfg: SiftConfig = SiftConfig(), *,
                   device="cuda"):
    """Run the per-stage API exactly as the reference UI does, on
    ``device``: ``(base, pyramid, dogs, records, descriptors)``, the first
    three as tensors there.  The keypoints, as in the reference UI, come
    from ``compute_keypoints_and_descriptors`` at its default settings."""
    from vfx_image_stitching_tpu_torch.pipeline.stitch import resolve_device

    dev = resolve_device(device)
    base = generate_base_image(torch.as_tensor(np.asarray(gray), device=dev),
                               cfg.sigma, cfg.assumed_blur)
    n_oct = compute_number_of_octaves(base.shape)
    kernels = generate_gaussian_kernels(cfg.sigma, cfg.num_intervals)
    pyr = generate_gaussian_images(base, n_oct, kernels)
    dogs = generate_dog_images(pyr)
    records, desc = compute_keypoints_and_descriptors(gray, device=dev)
    return base, pyr, dogs, records, desc


def draw_keypoints(ax, img: np.ndarray, records: Sequence[KeyPointRecord],
                   scale: float = 3.0) -> None:
    """Red dots + yellow orientation arrows (sift_visualizeUI.py:47-86)."""
    ax.imshow(img, cmap="gray")
    ax.set_axis_off()
    for kp in records:
        x, y = kp.pt
        ax.plot(x, y, "o", color="red", markersize=2)
        if kp.angle != -1:
            a = np.deg2rad(kp.angle)
            ax.arrow(x, y, np.cos(a) * kp.size / scale,
                     np.sin(a) * kp.size / scale,
                     color="yellow", head_width=1.5, head_length=2)


def cvimg_to_qpixmap(img: np.ndarray, max_width: Optional[int] = None,
                     max_height: Optional[int] = None):
    """cv2 image (gray or BGR) -> QPixmap, min-max normalized, optionally
    scaled down aspect-preserving (sift_visualizeUI.py:21-45).

    Requires PyQt5; raises ImportError otherwise (the headless renderer
    never needs it).
    """
    from PyQt5.QtCore import Qt
    from PyQt5.QtGui import QImage, QPixmap

    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        img = ((img - lo) * scale).astype(np.uint8)
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        h, w = img.shape
        qimg = QImage(img.data, w, h, w, QImage.Format_Grayscale8)
    else:
        h, w = img.shape[:2]
        rgb = np.ascontiguousarray(img[..., ::-1])
        qimg = QImage(rgb.data, w, h, 3 * w, QImage.Format_RGB888)
    pix = QPixmap.fromImage(qimg.copy())
    if max_width or max_height:
        pix = pix.scaled(
            max_width or pix.width(), max_height or pix.height(),
            Qt.KeepAspectRatio, Qt.SmoothTransformation,
        )
    return pix


def draw_feature_points_return_disp(
    img: np.ndarray, keypoints: Sequence, point_color: str = "red",
    arrow_color: str = "yellow", scale: float = 0.5,
) -> np.ndarray:
    """Render keypoints (+orientation arrows when ``kp.angle != -1``) over
    the image via matplotlib and return the figure as a BGR array
    (sift_visualizeUI.py:47-86)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    if img.ndim == 2:
        img_rgb = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] == 3:
        img_rgb = img[..., ::-1]
    else:
        img_rgb = img.copy()

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img_rgb)
    ax.set_axis_off()
    for kp in keypoints:
        x, y = kp.pt
        ax.plot(x, y, "o", color=point_color, markersize=2)
        if kp.angle != -1:
            a = np.deg2rad(kp.angle)
            ax.arrow(x, y, np.cos(a) * kp.size / scale,
                     np.sin(a) * kp.size / scale,
                     color=arrow_color, head_width=1.5, head_length=2)
    ax.set_title("Feature Points with Orientation")
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    buf = buf.reshape(h, w, 4)[..., :3]
    plt.close(fig)
    return np.ascontiguousarray(buf[..., ::-1])


def flann_homography_match(
    query_path: str, train_path: str, min_match_count: int = 10,
    lowe_ratio: float = 0.7, *, device="cuda",
) -> Tuple[Optional[np.ndarray], List, List, List, Optional[np.ndarray]]:
    """FLANN kd-tree matching + RANSAC homography (UI-only, cv2 on the
    host; the keypoints and descriptors on ``device``).

    Parity with sift_visualizeUI.py:247-273: trees=5, checks=50,
    knnMatch(k=2), Lowe ratio 0.7, findHomography(RANSAC, 5.0).
    """
    import cv2

    g1 = _gray_f32(query_path).astype(np.uint8)
    g2 = _gray_f32(train_path).astype(np.uint8)
    kp1, des1 = compute_keypoints_and_descriptors(g1, device=device)
    kp2, des2 = compute_keypoints_and_descriptors(g2, device=device)
    flann = cv2.FlannBasedMatcher(
        dict(algorithm=0, trees=5), dict(checks=50)
    )
    matches = flann.knnMatch(des1, des2, k=2)
    good = [m for m, n in matches if m.distance < lowe_ratio * n.distance]
    homography = None
    if len(good) > min_match_count:
        src = np.float32([kp1[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
        dst = np.float32([kp2[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
        homography, _ = cv2.findHomography(src, dst, cv2.RANSAC, 5.0)
    return homography, good, kp1, kp2, None


def render_sift_report(
    image_path: str,
    out_dir: str,
    match_path: Optional[str] = None,
    cfg: SiftConfig = SiftConfig(),
    *,
    device="cuda",
) -> List[str]:
    """Write the six reference panels as PNGs, the stages computed on
    ``device``; returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    gray = _gray_f32(image_path)
    base, pyr, dogs, records, desc = compute_stages(gray, cfg, device=device)
    written = []

    def save(fig, name):
        p = os.path.join(out_dir, name)
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        written.append(p)

    fig, ax = plt.subplots()
    ax.imshow(base.cpu().numpy(), cmap="gray")
    ax.set_title(f"Base Image (sigma={cfg.sigma}, blur={cfg.assumed_blur})")
    ax.set_axis_off()
    save(fig, "1_base_image.png")

    for name, stack in [("2_gaussian_pyramid.png", pyr[0]),
                        ("3_dog_pyramid.png", dogs[0])]:
        arr = stack.cpu().numpy()
        fig, axes = plt.subplots(2, 3, figsize=(12, 6))
        for i, ax in enumerate(axes.ravel()):
            if i < arr.shape[0]:
                ax.imshow(arr[i], cmap="gray")
                ax.set_title(f"Level {i}")
            ax.set_axis_off()
        save(fig, name)

    fig, ax = plt.subplots(figsize=(8, 6))
    disp = (gray / max(gray.max(), 1) * 255).astype(np.uint8)
    draw_keypoints(ax, disp, records)
    ax.set_title(f"Converted Keypoints ({len(records)})")
    save(fig, "4_keypoints.png")

    fig, ax = plt.subplots(figsize=(6, 3))
    if desc.shape[0] > 0:
        ax.bar(range(desc.shape[1]), desc[0])
        ax.set_title("First Descriptor Vector")
    save(fig, "5_descriptor.png")

    if match_path is not None:
        try:
            homography, good, kp1, kp2, _ = flann_homography_match(
                image_path, match_path, device=device
            )
            fig, ax = plt.subplots(figsize=(12, 6))
            g1 = _gray_f32(image_path)
            g2 = _gray_f32(match_path)
            h = max(g1.shape[0], g2.shape[0])
            canvas = np.zeros((h, g1.shape[1] + g2.shape[1]), np.float32)
            canvas[: g1.shape[0], : g1.shape[1]] = g1
            canvas[: g2.shape[0], g1.shape[1] :] = g2
            ax.imshow(canvas, cmap="gray")
            for m in good[:80]:
                p1 = kp1[m.queryIdx].pt
                p2 = kp2[m.trainIdx].pt
                ax.plot([p1[0], p2[0] + g1.shape[1]], [p1[1], p2[1]],
                        "-", color="tab:blue", linewidth=0.5)
            ax.set_title(
                f"FLANN matches: {len(good)}"
                + (" (homography found)" if homography is not None else "")
            )
            ax.set_axis_off()
            save(fig, "6_matching.png")
        except Exception as e:  # cv2/FLANN unavailable: the reference's note
            with open(os.path.join(out_dir, "6_matching.txt"), "w") as f:
                f.write(f"matching panel unavailable: {e}\n")
    return written


try:  # pragma: no cover - requires PyQt5
    from PyQt5.QtWidgets import QMainWindow  # type: ignore

    class SIFTVisualizer(QMainWindow):
        """PyQt5 window with the reference's six tabs."""

        def __init__(self, image_path: str, sigma: float = 1.6,
                     assumed_blur: float = 0.5,
                     match_path: Optional[str] = None, device="cuda"):
            from PyQt5.QtWidgets import QTabWidget, QLabel, QScrollArea
            from PyQt5.QtGui import QPixmap
            import tempfile

            super().__init__()
            out = tempfile.mkdtemp(prefix="sift_viz_")
            cfg = SiftConfig(sigma=sigma, assumed_blur=assumed_blur)
            panels = render_sift_report(image_path, out, match_path, cfg,
                                        device=device)
            tabs = QTabWidget()
            for p in panels:
                label = QLabel()
                label.setPixmap(QPixmap(p))
                scroll = QScrollArea()
                scroll.setWidget(label)
                tabs.addTab(scroll, os.path.basename(p).split("_", 1)[1][:-4])
            self.setCentralWidget(tabs)
            self.setWindowTitle("SIFT Process Visualizer (CUDA)")
            self.resize(1024, 768)

except ImportError:  # pragma: no cover
    SIFTVisualizer = None  # type: ignore
