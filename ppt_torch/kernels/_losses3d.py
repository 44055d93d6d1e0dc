"""``csrc/losses3d.cu``'s library, shared by ``kernels/chamfer.py`` and
``kernels/emd.py``: every entry point's ctypes argument types, one per C
parameter, set once when the library is first loaded (an untyped pointer
would be cut to 32 bits)."""

from __future__ import annotations

import ctypes

from ppt_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "ppt_nn_dists": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ppt_nn_launch_floor": [_I] * 8 + [_P],
    "ppt_approx_match_needs_scratch": [_I, _I],
    "ppt_approx_match_warp": [_P, _I, _I, _I, _F, _F, _P, _P],
    "ppt_approx_match": [_P, _I, _I, _I, _F, _F, _P, _P, _P],
    "ppt_approx_match_floor": [_I] * 4 + [_P],
}
_lib_typed = None


def lib() -> ctypes.CDLL:
    global _lib_typed
    if _lib_typed is None:
        loaded = _build.load("losses3d")
        for name, types in _ARGTYPES.items():
            getattr(loaded, name).argtypes = types
        _lib_typed = loaded
    return _lib_typed
