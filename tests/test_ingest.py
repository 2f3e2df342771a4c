import numpy as np

from volumerenderingproject.ingest import load_nifti, parse_header, synthetic
from volumerenderingproject.ingest.nifti import NIFTI2_HDR_SIZE


def test_avg152_header(avg152_path):
    with open(avg152_path, "rb") as f:
        hdr = parse_header(f.read(1024))
    assert hdr.sizeof_hdr == NIFTI2_HDR_SIZE
    assert hdr.dim[0] == 3
    assert hdr.shape == (91, 109, 91)
    assert hdr.datatype == 16  # float32
    assert hdr.cal_max == 255.0
    assert hdr.vox_offset == 544


def test_avg152_volume(avg152_path):
    vol = load_nifti(avg152_path)
    assert vol.dims == (91, 109, 91)
    assert vol.longest_dimension == 109
    assert vol.octree_depth == 7  # 2^7 = 128 >= 109 (Octree.cu:40-41)
    assert vol.totaldim == 91 * 109 * 91
    data = np.asarray(vol.data)
    assert data.dtype == np.float32
    assert data.min() >= 0.0
    assert 100.0 < data.max() <= 255.0
    # brain voxels exist in the middle
    assert data[45, 54, 45] > 0


def test_centered_sphere_formula():
    vol = synthetic.centered_sphere()
    data = np.asarray(vol.data)
    assert data.shape == (100, 100, 100)
    # intensity = y/100*255 inside the sphere (BinaryLoader.cu:354-358)
    assert data[50, 70, 50] == np.float32(70 / 100.0 * 255.0)
    assert data[0, 0, 0] == 0.0  # corner outside sphere
    # boundary: (x-50)^2+... <= 50^2 inclusive
    assert data[0, 50, 50] == np.float32(50 / 100.0 * 255.0)


def test_corner_sphere_formula():
    vol = synthetic.corner_sphere()
    data = np.asarray(vol.data)
    # intensity = r^2/R^2*255 inside radius-100 sphere about (0,0,0)
    assert data[0, 0, 0] == 0.0
    r2 = 30**2 + 40**2 + 50**2
    assert abs(data[30, 40, 50] - r2 / 100.0**2 * 255.0) < 1e-3
    assert data[99, 99, 99] == 0.0  # r^2 = 3*99^2 > 100^2


def test_nifti1_roundtrip(tmp_path):
    # write a minimal nifti-1 file and read it back
    import struct

    dims = (5, 6, 7)
    data = np.arange(np.prod(dims), dtype=np.float32).reshape(dims)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *dims, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)  # float32
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<8f", hdr, 76, 1.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 124, 100.0)  # cal_max
    hdr[344:348] = b"n+1\x00"
    p = tmp_path / "t.nii"
    with open(p, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(data.tobytes())
    vol = load_nifti(p)
    assert vol.dims == dims
    np.testing.assert_array_equal(np.asarray(vol.data), data)
    assert float(vol.cal_max) == 100.0


def test_big_endian_header():
    import struct

    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 4, 5, 6, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 16)
    h = parse_header(bytes(hdr))
    assert h.byteorder == ">"
    assert h.shape == (4, 5, 6)


def test_vvi_sidecar_parse():
    """VolView .vvi sidecars (reference C21 inventory) parse and
    cross-check the NIfTI header where both exist."""
    import os

    from volumerenderingproject.ingest.vvi import load_vvi, parse_vvi

    p = "/root/reference/avg152T1_LR_nifti2.nii.vvi"
    if not os.path.exists(p):
        import pytest

        pytest.skip("reference .vvi sidecar not available")
    props = load_vvi(p)
    assert props.file_dimensionality == 3
    # VolView cached its own interpretation of this file: a 3-component
    # uint8 view over a 91x91x109 extent (a transposed/padded take on the
    # 91x109x91 NIfTI grid) — the sidecar records the viewer's state, not
    # the NIfTI truth, which is exactly why it is provenance-only here
    assert props.num_scalar_components == 3
    assert props.dtype_name == "uint8"
    assert props.dims == (91, 91, 109)
    assert props.spacing == (1.0, 1.0, 1.0)
    assert not props.big_endian

    with np.testing.assert_raises(ValueError):
        parse_vvi("<NotAVvi/>")
