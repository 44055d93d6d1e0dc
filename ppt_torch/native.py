"""ctypes binding of the native host library's renderer (``native/libppt_host.so``).

The port's own copy of the part of ``ppt_tpu/native.py`` that
``tools/visualize.py`` needs (the port imports nothing of the JAX package):
the z-buffer ball renderer, which replaces the reference's prebuilt
``notebook/render_balls.so``, and the on-demand build of the library with
the in-tree Makefile. numpy in, numpy out, as there.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libppt_host.so")


def build_native(force: bool = False) -> str:
    """Compile libppt_host.so if missing; returns its path."""
    if force or not os.path.exists(_LIB_PATH):
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"] + (["-B"] if force else []),
            check=True,
        )
    return _LIB_PATH


@functools.lru_cache()
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native())
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)
    lib.ppt_render_balls.restype = None
    lib.ppt_render_balls.argtypes = [
        c_float_p, c_u8_p, ctypes.c_int, c_u8_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
    ]
    return lib


def render_balls(
    points: np.ndarray,
    colors: np.ndarray,
    size: Tuple[int, int] = (512, 512),
    radius: float = 6.0,
    background: Tuple[int, int, int] = (255, 255, 255),
) -> np.ndarray:
    """Render a cloud to an RGB image (z-buffered shaded discs).

    points: [N, 3] in roughly [-1, 1]; colors: [N, 3] uint8.
    Returns [H, W, 3] uint8.
    """
    pts = np.ascontiguousarray(points, dtype=np.float32)
    cols = np.ascontiguousarray(colors, dtype=np.uint8)
    h, w = size
    img = np.empty((h, w, 3), dtype=np.uint8)
    _lib().ppt_render_balls(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(pts), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        ctypes.c_float(radius), *background,
    )
    return img
