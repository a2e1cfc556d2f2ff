"""Minimal NIfTI-1 reader/writer in plain numpy (the port's own copy of
``tmar.data.nifti``; the same bytes written, the same arrays read).

Read/write of single-file ``.nii``/``.nii.gz`` volumes with scalar dtypes,
preserving the affine (srow) and scl_slope/inter scaling.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Return (data, affine[4,4]).  Applies scl_slope/scl_inter when set."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack("<8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype code {datatype}")
        dtype = _DTYPES[datatype]
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        srow = np.array(
            struct.unpack("<12f", hdr[280:328]), dtype=np.float64
        ).reshape(3, 4)
        affine = np.vstack([srow, [0, 0, 0, 1]])

        f.seek(vox_offset)
        raw = f.read()
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return np.asarray(data), affine


def write_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a single-file .nii/.nii.gz volume (Fortran order, NIfTI-1)."""
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 1)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
