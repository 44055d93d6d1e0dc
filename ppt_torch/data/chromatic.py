"""Chromatic (colour-feature) transforms for scene datasets, in numpy.

The port's own copy of ``ppt_tpu/data/chromatic.py`` (openpoints'
``point_transform_cpu.py:191-330``): the colour augmentations the
S3DIS/ScanNet recipes compose on the host, each taking its draws from an
explicit ``np.random.RandomState`` in the reference's order, so a pipeline
seeded alike draws alike. Each function takes and returns ``feat
[N, >=3]`` with RGB in [0, 255] in the first three channels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def chromatic_auto_contrast(
    feat: np.ndarray,
    rng: np.random.RandomState,
    p: float = 0.2,
    blend_factor: Optional[float] = None,
) -> np.ndarray:
    """Blend toward per-channel full-range stretch (:192-209)."""
    if rng.rand() >= p:
        return feat
    feat = feat.copy()
    rgb = feat[:, :3]
    lo = rgb.min(0, keepdims=True)
    hi = rgb.max(0, keepdims=True)
    scale = 255 / np.maximum(hi - lo, 1e-12)
    stretched = (rgb - lo) * scale
    blend = rng.rand() if blend_factor is None else blend_factor
    feat[:, :3] = (1 - blend) * rgb + blend * stretched
    return feat


def chromatic_translation(
    feat: np.ndarray, rng: np.random.RandomState,
    p: float = 0.95, ratio: float = 0.05,
) -> np.ndarray:
    """Global RGB shift (:212-222)."""
    if rng.rand() >= p:
        return feat
    feat = feat.copy()
    tr = (rng.rand(1, 3) - 0.5) * 255 * 2 * ratio
    feat[:, :3] = np.clip(feat[:, :3] + tr, 0, 255)
    return feat


def chromatic_jitter(
    feat: np.ndarray, rng: np.random.RandomState,
    p: float = 0.95, std: float = 0.005,
) -> np.ndarray:
    """Per-point gaussian RGB noise (:225-236)."""
    if rng.rand() >= p:
        return feat
    feat = feat.copy()
    noise = rng.randn(feat.shape[0], 3) * std * 255
    feat[:, :3] = np.clip(feat[:, :3] + noise, 0, 255)
    return feat


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.rgb_to_hsv over [N, 3] in [0, 255]
    (:242-267)."""
    rgb = rgb.astype("float")
    hsv = np.zeros_like(rgb)
    hsv[..., 3:] = rgb[..., 3:]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb[..., :3], axis=-1)
    minc = np.min(rgb[..., :3], axis=-1)
    hsv[..., 2] = maxc
    mask = maxc != minc
    hsv[mask, 1] = (maxc - minc)[mask] / maxc[mask]
    rc = np.zeros_like(r)
    gc = np.zeros_like(g)
    bc = np.zeros_like(b)
    span = np.where(mask, maxc - minc, 1.0)
    rc[mask] = ((maxc - r) / span)[mask]
    gc[mask] = ((maxc - g) / span)[mask]
    bc[mask] = ((maxc - b) / span)[mask]
    hsv[..., 0] = np.select(
        [r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc
    )
    hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
    return hsv


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.hsv_to_rgb (:269-293)."""
    rgb = np.empty_like(hsv)
    rgb[..., 3:] = hsv[..., 3:]
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype("uint8")
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conditions = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb[..., 0] = np.select(conditions, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conditions, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conditions, [v, p, t, v, v, q], default=p)
    return rgb.astype("uint8")


def hue_saturation_translation(
    feat: np.ndarray, rng: np.random.RandomState,
    hue_max: float = 0.5, saturation_max: float = 0.2,
) -> np.ndarray:
    """Random hue rotation + saturation scaling in HSV (:296-307)."""
    feat = feat.copy()
    hsv = rgb_to_hsv(feat[:, :3])
    hue_val = (rng.rand() - 0.5) * 2 * hue_max
    sat_ratio = 1 + (rng.rand() - 0.5) * 2 * saturation_max
    hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
    hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
    feat[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
    return feat


def random_drop_feature(
    feat: np.ndarray, rng: np.random.RandomState,
    p: float = 0.2, drop_dims: Sequence[int] = (0, 3),
) -> np.ndarray:
    """Zero a channel range with probability p (:303-314)."""
    if rng.rand() >= p:
        return feat
    feat = feat.copy()
    feat[:, drop_dims[0] : drop_dims[-1]] = 0
    return feat


def chromatic_normalize(
    feat: np.ndarray,
    color_mean: Optional[Sequence[float]] = None,
    color_std: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Scale to [0,1] and optionally standardize (:317-330)."""
    feat = feat.copy().astype(np.float32)
    if feat[:, :3].max() > 1:
        feat[:, :3] /= 255.0
    if color_mean is not None:
        feat[:, :3] -= np.asarray(color_mean, np.float32)
    if color_std is not None:
        feat[:, :3] /= np.asarray(color_std, np.float32)
    return feat
