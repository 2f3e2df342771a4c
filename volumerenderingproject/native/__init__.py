"""ctypes bindings for the native host runtime (libvrputils.so).

Build with ``make -C volumerenderingproject/native`` (or
``python -m volumerenderingproject.native.build``).  Every entry point
has a pure-Python fallback elsewhere in the package (ingest/nifti.py,
accel/pyramid.py, ops/conv3d.py); :func:`available` reports whether the
native library is loaded.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_SO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "libvrputils.so")
_lib: Optional[ctypes.CDLL] = None


class _NiftiInfo(ctypes.Structure):
    _fields_ = [
        ("sizeof_hdr", ctypes.c_int32),
        ("datatype", ctypes.c_int32),
        ("bitpix", ctypes.c_int32),
        ("dim", ctypes.c_int64 * 8),
        ("pixdim", ctypes.c_double * 8),
        ("vox_offset", ctypes.c_int64),
        ("scl_slope", ctypes.c_double),
        ("scl_inter", ctypes.c_double),
        ("cal_max", ctypes.c_double),
        ("cal_min", ctypes.c_double),
        ("swapped", ctypes.c_int32),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.vrp_nifti_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(_NiftiInfo)]
    lib.vrp_nifti_header.restype = ctypes.c_int
    lib.vrp_nifti_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(_NiftiInfo),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.vrp_nifti_read.restype = ctypes.c_int
    lib.vrp_leaf_grid.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.vrp_pool2.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vrp_point_rasterize.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vrp_conv3d.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def _info_dict(info: _NiftiInfo) -> dict:
    return {
        "sizeof_hdr": info.sizeof_hdr,
        "datatype": info.datatype,
        "bitpix": info.bitpix,
        "dim": tuple(info.dim),
        "pixdim": tuple(info.pixdim),
        "vox_offset": info.vox_offset,
        "scl_slope": info.scl_slope,
        "scl_inter": info.scl_inter,
        "cal_max": info.cal_max,
        "cal_min": info.cal_min,
        "swapped": bool(info.swapped),
    }


def nifti_header(path: str) -> dict:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    info = _NiftiInfo()
    rc = lib.vrp_nifti_header(path.encode(), ctypes.byref(info))
    if rc:
        raise ValueError(f"native nifti header parse failed (code {rc}): {path}")
    return _info_dict(info)


def nifti_read(path: str) -> Tuple[dict, np.ndarray]:
    """Header + float32 payload (flat, C-order x-major)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    info = _NiftiInfo()
    rc = lib.vrp_nifti_header(path.encode(), ctypes.byref(info))
    if rc:
        raise ValueError(f"native nifti header parse failed (code {rc}): {path}")
    ndim = int(info.dim[0])
    count = 1
    for i in range(1, 1 + ndim):
        count *= int(info.dim[i])
    out = np.empty(count, np.float32)
    rc = lib.vrp_nifti_read(path.encode(), ctypes.byref(info), _fptr(out), count, _nthreads())
    if rc:
        raise ValueError(f"native nifti payload read failed (code {rc}): {path}")
    return _info_dict(info), out


def leaf_grid(volume: np.ndarray, depth: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    vol = np.ascontiguousarray(volume, np.float32)
    d1, d2, d3 = vol.shape
    n = 2**depth
    out = np.empty((n, n, n), np.float32)
    lib.vrp_leaf_grid(_fptr(vol), d1, d2, d3, depth, _fptr(out), _nthreads())
    return out


def build_pyramid(volume: np.ndarray, depth: int):
    """Full min/max level stack, finest first (matches accel/pyramid.py)."""
    leaf = leaf_grid(volume, depth)
    mins = [leaf]
    maxs = [leaf]
    lib = _load()
    while mins[-1].shape[0] > 1:
        n = mins[-1].shape[0]
        m = n // 2
        omin = np.empty((m, m, m), np.float32)
        omax = np.empty((m, m, m), np.float32)
        lib.vrp_pool2(_fptr(mins[-1]), _fptr(maxs[-1]), n, _fptr(omin), _fptr(omax))
        mins.append(omin)
        maxs.append(omax)
    return mins, maxs


def point_rasterize(
    ndc: np.ndarray, rgba: np.ndarray, width: int, height: int, background
) -> np.ndarray:
    """Exact GL-semantics point rasterization -> [W, H, 4] image."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    ndc = np.ascontiguousarray(ndc, np.float32)
    rgba = np.ascontiguousarray(rgba, np.float32)
    bg = np.ascontiguousarray(background, np.float32)
    out = np.empty((width, height, 4), np.float32)
    lib.vrp_point_rasterize(
        _fptr(ndc), _fptr(rgba), ndc.shape[0], width, height, _fptr(bg), _fptr(out)
    )
    return out


def conv3d(volume: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    vol = np.ascontiguousarray(volume, np.float32)
    k = np.ascontiguousarray(kernel, np.float32)
    out = np.empty_like(vol)
    lib.vrp_conv3d(
        _fptr(vol), *vol.shape, _fptr(k), *k.shape, _fptr(out), _nthreads()
    )
    return out
