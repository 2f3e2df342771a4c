"""The stdlib PNG codec, the npz fit checkpoints and the compilation-cache
helper: the pieces that keep the main path on jax, numpy and the stdlib."""

import hashlib
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from volumerenderingproject import default_transfer_function
from volumerenderingproject.diff import fit
from volumerenderingproject.ops import phong
from volumerenderingproject.utils import cache, imageio
from volumerenderingproject.utils.config import Algorithm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 3), (33, 64, 4),
                                   (16, 9, 4)], ids=str)
def test_png_roundtrip(shape):
    arr = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    png = imageio.encode_png(arr)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(imageio.decode_png(png), arr)


def _filtered_png(arr, ftype):
    """PNG bytes of ``arr`` with every row written under filter ``ftype``
    (the PNG specification's sub/up/average/paeth predictors)."""
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(np.int32)
    out = []
    for r in range(h):
        cur = rows[r]
        prev = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[ftype], (cur - pred) & 0xFF]))
    raw = np.asarray(out, np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_every_row_filter(ftype):
    arr = np.random.default_rng(ftype).integers(0, 256, (9, 11, 3),
                                                dtype=np.uint8)
    np.testing.assert_array_equal(
        imageio.decode_png(_filtered_png(arr, ftype)), arr)


def test_png_decodes_committed_preview():
    """A preview written by another encoder (sub, up and paeth rows)."""
    path = os.path.join(REPO, "goldens", "recovered_previews",
                        "image_100x100_a1_spr100_pair.png")
    arr = imageio.decode_png(open(path, "rb").read())
    assert arr.shape == (100, 204, 3)
    assert hashlib.sha256(arr.tobytes()).hexdigest() == (
        "3da7ac0c6bf33049264a639433d15aed456937bae11ff5be828a44af5432602c")


@pytest.mark.parametrize("alg", [Algorithm.VRC, Algorithm.TEST])
def test_save_load_png_display_orientation(tmp_path, alg):
    img = np.random.default_rng(2).uniform(size=(12, 7, 4)).astype(
        np.float32)
    path = tmp_path / "x.png"
    imageio.save_png(path, img, alg)
    disp = imageio.load_png(path)
    assert disp.shape == (7, 12, 3)
    back = imageio.from_display(disp, alg)
    np.testing.assert_allclose(back, imageio.to_uint8(img[..., :3]) / 255.0,
                               atol=1e-7)


@pytest.mark.parametrize("data", [
    b"not a png at all",
    b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
    + struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0) + b"\0" * 4,
    b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
    + struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1) + b"\0" * 4,
], ids=["signature", "16-bit", "interlaced"])
def test_png_rejects_unsupported(data):
    with pytest.raises(ValueError):
        imageio.decode_png(data)


def _params(bounds, light):
    tf = default_transfer_function()
    return fit.FitParams.init(
        tf, fit_bounds=bounds, light=phong.default_light() if light else None)


@pytest.mark.parametrize("bounds,light,opt", [
    (False, False, False), (True, False, True), (False, True, True),
    (True, True, True)], ids=["colors", "bounds+opt", "light+opt", "all"])
def test_npz_checkpoint_roundtrip(tmp_path, bounds, light, opt):
    params = _params(bounds, light)
    params = jax.tree.map(lambda x: x + 0.125, params)
    optimizer = optax.adam(1e-2)
    state = optimizer.init(params)
    state = jax.tree.map(lambda x: x + 1, state)
    fit.save_checkpoint(str(tmp_path), 7, params, state if opt else None)
    assert os.listdir(tmp_path) == ["step_7.npz"]
    back = fit.load_checkpoint(str(tmp_path), 7)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (back.light is None) == (not light)
    assert (back.tf_lower is None) == (not bounds)
    if opt:
        _, st = fit.load_checkpoint(str(tmp_path), 7,
                                    opt_state_like=optimizer.init(params))
        for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_checkpoint_step(tmp_path):
    assert fit.latest_checkpoint_step(str(tmp_path / "missing")) is None
    params = _params(False, False)
    for step in (2, 10, 4):
        fit.save_checkpoint(str(tmp_path), step, params)
    (tmp_path / "step_99.txt").write_text("not a checkpoint")
    assert fit.latest_checkpoint_step(str(tmp_path)) == 10


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself


def test_compile_cache_default_is_in_checkout(monkeypatch):
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()
