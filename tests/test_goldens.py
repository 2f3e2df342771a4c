import os

import numpy as np
import pytest

from volumerenderingproject.harness import goldens

GOLDEN_DIR = "/root/reference/image_output"


def test_parse_golden_name():
    meta = goldens.parse_golden_name("image_700x700_a1_spr250.png")
    assert meta == {"width": 700, "height": 700, "algorithm": 1, "spr": 250}
    assert goldens.parse_golden_name("myOutputIsAwesome.png") is None


def test_similarity_self_and_noise(rng):
    img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    assert goldens.similarity(img, img) > 0.9999
    other = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    assert goldens.similarity(img, other) < 0.3


@pytest.mark.skipif(not os.path.isdir(GOLDEN_DIR), reason="no goldens")
def test_golden_palette_is_reference_materials():
    """Golden a1 captures must be composed of the reference material colors
    blended toward the background — a structural check that doesn't depend
    on the unrecorded capture camera."""
    from volumerenderingproject.scene.materials import MaterialId, material_rgba
    from volumerenderingproject.utils.imageio import load_png

    img = load_png(os.path.join(GOLDEN_DIR, "image_100x100_a1_spr100.png"))
    bg = np.asarray([0.2, 0.2, 0.2], np.float32)
    mats = [material_rgba(m)[:3] for m in (MaterialId.bone, MaterialId.muscle, MaterialId.brain)]
    # palette: background, black (window border), pure materials, and
    # materials over background at their own alpha (single-hit blends)
    palette = [bg, np.zeros(3)]
    for m, a in zip(mats, (0.3, 0.3, 0.7)):
        palette.append(m)
        palette.append(bg * (1 - a) + m * a)
    d = goldens.palette_distance(img, np.stack(palette))
    assert d < 0.25


@pytest.mark.skipif(not os.path.isdir(GOLDEN_DIR), reason="no goldens")
def test_our_render_structurally_close_to_golden():
    """Render the golden config at the saved preset camera; NCC against the
    golden capture should be well above chance (camera unrecorded upstream,
    so this is a structural-similarity regression floor, not pixel parity)."""
    from volumerenderingproject import (
        RenderConfig,
        default_transfer_function,
        load_nifti,
        reset_preset,
    )
    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.utils.config import Algorithm
    from volumerenderingproject.utils.imageio import load_png, to_display

    volume = load_nifti("/root/reference/avg152T1_LR_nifti2.nii")
    cfg = RenderConfig(width=100, height=100, samples_per_ray=100)
    img = np.asarray(
        render_vrc(volume, default_transfer_function(), reset_preset(), cfg)
    )
    ours = to_display(img[..., :3], Algorithm.VRC)
    golden = load_png(os.path.join(GOLDEN_DIR, "image_100x100_a1_spr100.png"))
    assert goldens.similarity(ours, golden) > 0.5
    assert goldens.foreground_fraction(img) > 0.05


RECOVERED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "goldens", "recovered_cameras.json")


@pytest.mark.skipif(
    not (os.path.isdir(GOLDEN_DIR) and os.path.exists(RECOVERED)),
    reason="no recovered cameras")
def test_recovered_cameras_reproduce_goldens():
    """Round 2 recovered the unrecorded golden capture cameras by searching
    the orbit manifold (harness/camera_recovery.py).  With the
    committed cameras, each a1/a5 golden must reproduce to NCC >= its
    per-golden floor at the search resolution — near-pixel regressions
    instead of round 1's 0.5 structural floor."""
    import json

    import jax.numpy as jnp

    from volumerenderingproject import (
        RenderConfig,
        default_transfer_function,
        load_nifti,
    )
    from volumerenderingproject.harness.camera_recovery import (
        ALGO_BY_ID,
        _golden_gray,
    )
    from volumerenderingproject.models.raycast import render
    from volumerenderingproject.scene.camera import Camera

    with open(RECOVERED) as f:
        recovered = json.load(f)
    assert recovered, "empty recovery file"
    volume = load_nifti("/root/reference/avg152T1_LR_nifti2.nii")
    tf = default_transfer_function()
    res = 100
    nccs = {}
    for name, rec in recovered.items():
        meta = goldens.parse_golden_name(name)
        algorithm = ALGO_BY_ID[meta["algorithm"]]
        cam = Camera(**{
            k: jnp.asarray(v, jnp.float32) for k, v in rec["camera"].items()
        })
        import math

        cfg = RenderConfig(
            width=res, height=res, samples_per_ray=meta["spr"],
            algorithm=algorithm,
            view_angle=rec.get("view_angle", math.pi / 4),
        )
        img = np.asarray(render(volume, tf, cam, cfg))
        g = img[..., :3].mean(axis=-1)
        gold = _golden_gray(
            os.path.join(GOLDEN_DIR, name), algorithm, (res, res))
        nccs[name] = ncc = goldens.similarity(g, gold)
        # regression floor: each stays at its recovered score
        floor = rec["ncc_search"] - 0.03
        assert ncc >= floor, f"{name}: NCC {ncc:.4f} < floor {floor:.4f}"
    # quality bar: the overwhelming majority of goldens are near-pixel
    # matches (>= 0.85); outliers (captures made under unrecoverable
    # compile-time edits) are documented in recovered_cameras.json
    assert sum(v >= 0.85 for v in nccs.values()) >= len(nccs) - 1, nccs
