"""Pure-Python/NumPy NIfTI-1 / NIfTI-2 reader.

Replacement for the reference loader (BinaryLoader.cu:273-335 +
nifti1.h/nifti2.h).  Like the reference, files are discriminated by
``sizeof_hdr`` (348 = NIfTI-1, 540 = NIfTI-2; BinaryLoader.cu:288-302) and the
voxel payload is read at ``vox_offset``.  Unlike the reference (which
reinterprets every payload as float32), this reader honours ``datatype`` and
converts to float32, and supports 4-D multi-channel volumes via ``dim[0]``
(the ``RGB16_4D.nii``-style datasets named in BASELINE.json).

No nibabel dependency — header fields are decoded with numpy structured reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from .volume import Volume, make_volume

# nifti datatype codes (nifti1.h:136-180) -> numpy dtypes
_DTYPE_CODES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}

NIFTI1_HDR_SIZE = 348
NIFTI2_HDR_SIZE = 540


@dataclasses.dataclass(frozen=True)
class NiftiHeader:
    """The header subset the pipeline consumes (cf. nifti_2_header nifti2.h:59-96)."""

    sizeof_hdr: int
    datatype: int
    bitpix: int
    dim: Tuple[int, ...]  # dim[0..7]
    pixdim: Tuple[float, ...]  # pixdim[0..7]
    vox_offset: int
    scl_slope: float
    scl_inter: float
    cal_max: float
    cal_min: float
    magic: bytes
    byteorder: str  # '<' or '>'

    @property
    def ndim(self) -> int:
        return int(self.dim[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(d) for d in self.dim[1 : 1 + self.ndim])


def _scalar(buf: bytes, off: int, dtype, bo: str):
    return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder(bo), count=1, offset=off)[0]


def _array(buf: bytes, off: int, dtype, count: int, bo: str):
    return np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder(bo), count=count, offset=off)


def parse_header(buf: bytes) -> NiftiHeader:
    """Parse a NIfTI-1/2 header from raw bytes (native or swapped endianness)."""
    if len(buf) < NIFTI1_HDR_SIZE:
        raise ValueError("file too small to hold a NIfTI header")
    raw_size = np.frombuffer(buf, dtype="<i4", count=1)[0]
    if raw_size in (NIFTI1_HDR_SIZE, NIFTI2_HDR_SIZE):
        bo = "<"
    else:
        raw_size_be = np.frombuffer(buf, dtype=">i4", count=1)[0]
        if raw_size_be in (NIFTI1_HDR_SIZE, NIFTI2_HDR_SIZE):
            bo = ">"
            raw_size = raw_size_be
        else:
            # same failure surface as BinaryLoader.cu:299-301
            raise ValueError(
                f"file isn't in a valid NIfTI format (sizeof_hdr={int(raw_size)})"
            )

    if raw_size == NIFTI2_HDR_SIZE:
        # nifti2.h:59-96 field offsets
        return NiftiHeader(
            sizeof_hdr=int(raw_size),
            datatype=int(_scalar(buf, 12, np.int16, bo)),
            bitpix=int(_scalar(buf, 14, np.int16, bo)),
            dim=tuple(int(x) for x in _array(buf, 16, np.int64, 8, bo)),
            pixdim=tuple(float(x) for x in _array(buf, 104, np.float64, 8, bo)),
            vox_offset=int(_scalar(buf, 168, np.int64, bo)),
            scl_slope=float(_scalar(buf, 176, np.float64, bo)),
            scl_inter=float(_scalar(buf, 184, np.float64, bo)),
            cal_max=float(_scalar(buf, 192, np.float64, bo)),
            cal_min=float(_scalar(buf, 200, np.float64, bo)),
            magic=bytes(buf[4:12]),
            byteorder=bo,
        )
    # nifti1.h field offsets
    return NiftiHeader(
        sizeof_hdr=int(raw_size),
        datatype=int(_scalar(buf, 70, np.int16, bo)),
        bitpix=int(_scalar(buf, 72, np.int16, bo)),
        dim=tuple(int(x) for x in _array(buf, 40, np.int16, 8, bo)),
        pixdim=tuple(float(x) for x in _array(buf, 76, np.float32, 8, bo)),
        vox_offset=int(_scalar(buf, 108, np.float32, bo)),
        scl_slope=float(_scalar(buf, 112, np.float32, bo)),
        scl_inter=float(_scalar(buf, 116, np.float32, bo)),
        cal_max=float(_scalar(buf, 124, np.float32, bo)),
        cal_min=float(_scalar(buf, 128, np.float32, bo)),
        magic=bytes(buf[344:348]),
        byteorder=bo,
    )


def load_nifti(
    path: str | os.PathLike,
    *,
    apply_scaling: bool = False,
    dtype_override: int | None = None,
    backend: str = "auto",
) -> Volume:
    """Load a ``.nii`` file into a :class:`Volume`.

    Args:
      path: file path.
      apply_scaling: apply ``scl_slope * v + scl_inter`` when slope != 0
        (the reference ignores scaling; off by default for parity).
      dtype_override: force a nifti datatype code (the reference always reads
        float32 regardless of the header, BinaryLoader.cu:313-323; pass 16 to
        replicate that behaviour for non-f32 files).
      backend: "auto" uses the native C++ loader (multithreaded conversion,
        native/vrputils.cpp) when built and applicable, else pure Python;
        "python" / "native" force a path.
    """
    if backend in ("auto", "native") and dtype_override is None:
        from .. import native

        if native.available():
            try:
                return _load_native(os.fspath(path), apply_scaling)
            except ValueError:
                if backend == "native":
                    raise
        elif backend == "native":
            raise RuntimeError(
                "native loader requested but libvrputils.so is not built "
                "(run: python -m volumerenderingproject.native.build)"
            )

    with open(path, "rb") as f:
        buf = f.read()
    hdr = parse_header(buf)

    code = dtype_override if dtype_override is not None else hdr.datatype
    np_dtype = _DTYPE_CODES.get(code)
    if np_dtype is None:
        raise ValueError(f"unsupported nifti datatype code {code}")

    ndim = hdr.ndim
    if ndim < 3:
        raise ValueError(f"need >= 3 spatial dims, got dim[0]={ndim}")
    shape = hdr.shape
    count = int(np.prod(shape))
    payload = np.frombuffer(
        buf,
        dtype=np.dtype(np_dtype).newbyteorder(hdr.byteorder),
        count=count,
        offset=int(hdr.vox_offset),
    )
    data = payload.astype(np.float32)
    if apply_scaling and hdr.scl_slope not in (0.0,):
        data = data * np.float32(hdr.scl_slope) + np.float32(hdr.scl_inter)

    # Reference index math is x-major: x*dim2*dim3 + y*dim3 + z
    # (BinaryLoader.cu:234-238), i.e. the file's flat order maps to [X, Y, Z]
    # in C-order.  4-D (dim[0]==4) keeps the 4th axis as channels.
    if ndim == 3:
        arr = data.reshape(shape)
    else:
        spatial = shape[:3]
        chans = int(np.prod(shape[3:]))
        # nifti stores extra dims slowest-last in the reference's flat view;
        # put channels last: [X, Y, Z, C]
        arr = data.reshape((chans,) + spatial).transpose(1, 2, 3, 0)

    cal_max = hdr.cal_max if hdr.cal_max not in (0.0,) else float(np.max(data) or 1.0)
    return make_volume(
        arr,
        cal_max=cal_max,
        cal_min=hdr.cal_min,
        pixdim=tuple(hdr.pixdim[1:4]),
    )


def _load_native(path: str, apply_scaling: bool) -> Volume:
    from .. import native

    hdr, flat = native.nifti_read(path)
    ndim = int(hdr["dim"][0])
    shape = tuple(int(d) for d in hdr["dim"][1 : 1 + ndim])
    data = flat
    if apply_scaling and hdr["scl_slope"] not in (0.0,):
        data = data * np.float32(hdr["scl_slope"]) + np.float32(hdr["scl_inter"])
    if ndim == 3:
        arr = data.reshape(shape)
    else:
        spatial = shape[:3]
        chans = int(np.prod(shape[3:]))
        arr = data.reshape((chans,) + spatial).transpose(1, 2, 3, 0)
    cal_max = hdr["cal_max"] if hdr["cal_max"] else float(np.max(data) or 1.0)
    return make_volume(
        arr,
        cal_max=cal_max,
        cal_min=hdr["cal_min"],
        pixdim=tuple(hdr["pixdim"][1:4]),
    )
