"""Part-segmentation pictures: predicted parts rendered as shaded balls.

Counterpart of ``ppt_tpu/tools/visualize.py`` (the reference's
``notebook/show_balls.py`` with its prebuilt ``render_balls.so``, driven by
``show-partseg.sh``): the same fixed 50-colour palette and the same
z-buffer renderer of ``native/libppt_host.so``, through the port's own
binding (``ppt_torch/native.py``), so the images are the JAX tool's byte
for byte.

Usage:
  python -m ppt_torch.tools.visualize --npz parts.npz --out viz/
  # or programmatically: render_partseg(points, labels) -> [H, W, 3] u8
"""

from __future__ import annotations

import argparse
import colorsys
import os
from typing import Optional, Tuple

import numpy as np

from ppt_torch import native


def part_palette(num_parts: int = 50) -> np.ndarray:
    """[num_parts, 3] uint8 distinct colours (a golden-ratio hue walk)."""
    colors = np.zeros((num_parts, 3), dtype=np.uint8)
    h = 0.0
    for i in range(num_parts):
        h = (h + 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.65, 0.95)
        colors[i] = [int(r * 255), int(g * 255), int(b * 255)]
    return colors


def _rotate(points: np.ndarray, yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return points @ Ry.T @ Rx.T


def render_partseg(
    points: np.ndarray,
    part_labels: np.ndarray,
    size: Tuple[int, int] = (512, 512),
    radius: float = 4.0,
    yaw: float = 0.6,
    pitch: float = -0.4,
    palette: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One cloud [N, 3] + per-point labels [N] -> RGB image [H, W, 3] u8."""
    if palette is None:
        palette = part_palette(int(part_labels.max()) + 1)
    pts = _rotate(np.asarray(points, np.float32), yaw, pitch)
    # fit into [-0.9, 0.9]
    pts = pts - pts.mean(0)
    pts = pts / (np.abs(pts).max() + 1e-9) * 0.9
    colors = palette[np.asarray(part_labels, np.int64)]
    return native.render_balls(pts, colors, size=size, radius=radius)


def save_png(image: np.ndarray, path: str) -> str:
    """A PNG through PIL where it is installed, else a binary PPM beside the
    name; returns the path written."""
    try:
        from PIL import Image

        Image.fromarray(image).save(path)
    except ImportError:  # minimal PPM fallback, viewable everywhere
        path = os.path.splitext(path)[0] + ".ppm"
        h, w, _ = image.shape
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(image.tobytes())
    return path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz", required=True,
                    help="npz with 'points' [M, N, 3] and 'labels' [M, N]")
    ap.add_argument("--out", default="viz")
    ap.add_argument("--limit", type=int, default=8)
    ap.add_argument("--radius", type=float, default=4.0)
    args = ap.parse_args(argv)

    data = np.load(args.npz)
    os.makedirs(args.out, exist_ok=True)
    palette = part_palette(50)
    written = []
    for i in range(min(args.limit, len(data["points"]))):
        img = render_partseg(data["points"][i], data["labels"][i], radius=args.radius,
                             palette=palette)
        written.append(save_png(img, os.path.join(args.out, f"partseg_{i:03d}.png")))
        print("wrote", written[-1])
    return written


if __name__ == "__main__":
    main()
