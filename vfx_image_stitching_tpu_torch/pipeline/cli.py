"""Command-line entry points of the PyTorch port.

Two modes:
  * ``argparse`` mode: ``python -m vfx_image_stitching_tpu_torch.pipeline.cli
    parrington/ --backend sift [--pano pano.txt] [--margin 15]
    [--device cuda|cpu]``
  * ``--interactive``: reference-parity stdin prompts — the same three
    questions (folder, pano.txt path, crop margin with default 15) and the
    same output filename ``panoroma_{backend}.jpg`` (sic, the reference's
    spelling; image_stitching_harris.py:543) written into the input
    folder, plus the same phase-timer stdout lines.

Both run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from vfx_image_stitching_tpu_torch.config import StitchConfig
from vfx_image_stitching_tpu_torch.pipeline.stitch import stitch_panorama


def run_interactive(backend: str, device="cuda") -> None:
    """Reference run_panorama() interaction parity."""
    folder = input("請輸入圖片資料夾位置 (預設為 .) ：").strip() or "."
    if not folder.endswith(("/", "\\")):
        folder += "/"
    pano = input("請輸入 pano.txt 檔案路徑 (在圖片資料夾內可直接按enter)：").strip()
    pano_file = pano if pano else None

    try:
        res = stitch_panorama(
            folder,
            backend=backend,
            pano_file=pano_file,
            crop_margin=None,   # asked below, after stitching, like the ref
            save_path=None,     # saved after the margin prompt
            verbose=True,
            device=device,
        )
    except ValueError as e:
        print(str(e))
        return

    margin_in = input("請輸入裁切邊界 (預設 15)：").strip()
    margin = int(margin_in) if margin_in.isdigit() else 15
    from vfx_image_stitching_tpu_torch.compose.crop import rectangle_crop
    from vfx_image_stitching_tpu_torch.io import save_bgr

    result = rectangle_crop(res.mosaic, 0, margin)
    save_path = os.path.join(folder, f"panoroma_{backend}.jpg")
    try:
        save_bgr(save_path, result)
    except OSError:
        # read-only dataset folder: fall back to the working directory
        save_path = os.path.abspath(f"panoroma_{backend}.jpg")
        save_bgr(save_path, result)
    print(f"全景拼接完成，輸出：{save_path}")


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="vfx-stitch-torch",
        description="cylindrical panorama stitching (PyTorch/CUDA port)",
    )
    parser.add_argument("folder", nargs="?", default=".",
                        help="dataset folder containing images + pano.txt")
    parser.add_argument("--backend", choices=["sift", "harris"],
                        default="sift")
    parser.add_argument("--pano", default=None, help="pano.txt path")
    parser.add_argument("--margin", type=int, default=15,
                        help="rectangling crop margin (default 15)")
    parser.add_argument("--out", default=None,
                        help="output path (default <folder>/panoroma_<backend>.jpg)")
    parser.add_argument("--save-steps", action="store_true",
                        help="dump per-step mosaics next to the output")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler (Chrome) trace here")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="run on the card (default) or the CPU")
    parser.add_argument("--interactive", action="store_true",
                        help="reference-parity stdin prompt mode")
    args = parser.parse_args(argv)

    if args.interactive:
        run_interactive(args.backend, args.device)
        return 0

    cfg = StitchConfig(backend=args.backend, save_steps=args.save_steps,
                       profile_dir=args.profile_dir)
    res = stitch_panorama(
        args.folder,
        backend=args.backend,
        pano_file=args.pano,
        crop_margin=args.margin,
        cfg=cfg,
        save_path=args.out
        or os.path.join(args.folder, f"panoroma_{args.backend}.jpg"),
        return_steps=args.save_steps,
        verbose=True,
        device=args.device,
    )
    if args.save_steps and res.steps:
        from vfx_image_stitching_tpu_torch.io import save_bgr

        base = os.path.dirname(args.out or args.folder) or "."
        for i, step in enumerate(res.steps):
            save_bgr(os.path.join(base, f"pano{i + 1}.jpg"), step)
    print(
        "timings:",
        {k: round(v, 3) for k, v in res.timings.items()},
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
