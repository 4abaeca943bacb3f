"""Host-side data I/O: pano.txt parsing and image loading.

Replicates the reference's AutoStitch ``pano.txt`` heuristic exactly
(a copy of the JAX package's parser), including the quirk that an image
line with no space-free float-parsable line before the next image line is
silently dropped.

Images decode with OpenCV when it is importable, else with PIL, else with
the binary-PNM reader here, so a machine without either library still
reads ``.ppm``/``.pgm`` datasets.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_pano_data(pano_file_path: str) -> Tuple[List[str], List[float]]:
    """Parse an AutoStitch ``pano.txt`` into (image paths, focal lengths).

    Heuristic (reference parity):
      * any line containing ``.jpg`` or ``.png`` (case-insensitive) becomes
        the pending image path (stored with original case, stripped);
      * the next non-image line that has no internal space and parses as a
        float is taken as that image's focal length in pixels;
      * dimension / homography-matrix lines are skipped because they contain
        spaces; an image line with no focal before the next image line is
        dropped.
    """
    images: List[str] = []
    focuses: List[float] = []
    pending_img: Optional[str] = None

    with open(pano_file_path, "r", encoding="utf-8") as f:
        all_lines = f.read().splitlines()

    for text_line in all_lines:
        line_stripped = text_line.strip().lower()
        if (".jpg" in line_stripped) or (".png" in line_stripped):
            pending_img = text_line.strip()
        elif (" " not in line_stripped) and line_stripped:
            try:
                val = float(line_stripped)
            except ValueError:
                continue
            if pending_img is not None:
                images.append(pending_img)
                focuses.append(val)
                pending_img = None
    return images, focuses


def resolve_image_path(path: str, folder: str) -> str:
    """Reference path-fallback rule: the given path if it exists, else
    ``folder/basename``, splitting Windows backslashes too (the shipped
    pano.txt files carry the author's absolute Windows paths)."""
    if os.path.exists(path):
        return path
    base = os.path.basename(path.replace("\\", "/"))
    return os.path.join(folder, base)


def read_pnm(path: str) -> np.ndarray:
    """Binary PGM (``P5``) / PPM (``P6``) with maxval 255 -> BGR uint8.

    Gray images are replicated to three channels and RGB is reversed to
    BGR, as ``cv2.imread`` returns them.  Raises ``OSError`` on anything
    else.
    """
    with open(path, "rb") as f:
        data = f.read()
    tokens: List[bytes] = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise OSError(f"truncated PNM header: {path}")
        tokens.append(data[start:pos])
    magic = tokens[0]
    if magic not in (b"P5", b"P6"):
        raise OSError(f"not a binary PGM/PPM file: {path}")
    try:
        w, h, maxval = (int(t) for t in tokens[1:])
    except ValueError as exc:
        raise OSError(f"bad PNM header: {path}") from exc
    if maxval != 255:
        raise OSError(f"only 8-bit PNM is supported (maxval {maxval}): {path}")
    c = 3 if magic == b"P6" else 1
    if len(data) - (pos + 1) < h * w * c:
        raise OSError(f"truncated PNM pixel data: {path}")
    pixels = np.frombuffer(data, np.uint8, count=h * w * c, offset=pos + 1)
    img = pixels.reshape(h, w, c)
    if c == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., ::-1].copy()


def load_bgr(path: str) -> np.ndarray:
    """Load an image as BGR uint8 (cv2.imread parity); raises ``OSError``
    when it cannot be read."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise OSError(f"cv2 cannot read image: {path}")
        return img
    try:
        from PIL import Image
    except ImportError:
        return read_pnm(path)
    try:
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    except (OSError, ValueError) as exc:
        raise OSError(f"PIL cannot read image: {path}") from exc
    return rgb[..., ::-1].copy()


def save_bgr(path: str, img: np.ndarray) -> None:
    """Write a BGR uint8 image (cv2.imwrite parity), with OpenCV when it
    is importable, else with PIL.  Raises ``OSError`` when the write
    fails (``cv2.imwrite`` only returns False, e.g. in a read-only
    directory, which a caller could not tell from success)."""
    img = np.asarray(img, dtype=np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise OSError(f"could not write image: {path}")
        return
    from PIL import Image

    try:
        Image.fromarray(img[..., ::-1]).save(path, quality=95)
    except ValueError as exc:  # PIL: no writer for the file's extension
        raise OSError(f"could not write image: {path}") from exc


def peek_image_size(folder: str, pano_file: Optional[str] = None
                    ) -> Optional[Tuple[int, int]]:
    """(height, width) of the dataset's first readable image, from the
    image header when PIL is present; None when no image is readable."""
    pf = pano_file or os.path.join(folder, "pano.txt")
    try:
        paths, _ = read_pano_data(pf)
    except OSError:
        return None
    for p in paths:
        fp = resolve_image_path(p, folder)
        try:
            from PIL import Image

            with Image.open(fp) as im:
                w, h = im.size  # header read only
            return int(h), int(w)
        except (ImportError, OSError, ValueError):
            try:
                img = load_bgr(fp)
            except OSError:
                continue
            return int(img.shape[0]), int(img.shape[1])
    return None


def _load_or_none(path: str) -> Optional[np.ndarray]:
    try:
        return load_bgr(path)
    except OSError:
        return None


def load_dataset(
    folder: str, pano_file: Optional[str] = None
) -> Tuple[List[Optional[np.ndarray]], List[float], List[str]]:
    """Load a dataset folder: returns (BGR images or None, focals, paths).

    Unreadable images become ``None`` placeholders that downstream stages
    tolerate (shift (0,0), dummy match pair), as the reference's
    ``run_panorama`` does.  Spans ``load.read`` and ``load.decode`` and
    counters ``n_images`` and ``n_decode_failed`` in the current request.
    """
    # the tracer's package imports torch, which importing this package
    # does not
    from vfx_image_stitching_tpu_torch.utils.profiling import count, span

    with span("load.read"):
        if not folder.endswith(("/", "\\")):
            folder = folder + "/"
        if pano_file is None:
            pano_file = os.path.join(folder, "pano.txt")
        img_paths, focals = read_pano_data(pano_file)
        resolved = [resolve_image_path(p, folder) for p in img_paths]
    with span("load.decode"):
        if len(resolved) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(resolved))) as pool:
                images = list(pool.map(_load_or_none, resolved))
        else:
            images = [_load_or_none(p) for p in resolved]
    count("n_images", len(images))
    count("n_decode_failed", sum(im is None for im in images))
    return images, focals, resolved


def stack_dataset(
    images: Sequence[Optional[np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack same-shape images into (N, H, W, 3) uint8 + validity mask.

    ``None`` entries are replaced by zeros with ``valid=False`` so the
    batched pipeline keeps fixed shapes.  Span ``load.stack`` in the
    current request.
    """
    from vfx_image_stitching_tpu_torch.utils.profiling import span

    with span("load.stack"):
        shapes = {im.shape for im in images if im is not None}
        if len(shapes) > 1:
            raise ValueError(f"dataset images disagree on shape: {shapes}")
        if not shapes:
            raise ValueError("no readable images in dataset")
        shape = next(iter(shapes))
        batch = np.zeros((len(images),) + shape, dtype=np.uint8)
        valid = np.zeros((len(images),), dtype=bool)
        for i, im in enumerate(images):
            if im is not None:
                batch[i] = im
                valid[i] = True
    return batch, valid
