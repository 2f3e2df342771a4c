"""Render every recovered golden camera at native resolution and save
side-by-side [reference golden | our render] previews to
goldens/recovered_previews/ — visual evidence for the camera recovery
(tests enforce the NCC floors; these are for human eyes).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import math

    import jax.numpy as jnp

    from volumerenderingproject import (
        RenderConfig,
        default_transfer_function,
        load_nifti,
    )
    from volumerenderingproject.harness import goldens as gold
    from volumerenderingproject.harness.camera_recovery import ALGO_BY_ID
    from volumerenderingproject.models.raycast import render
    from volumerenderingproject.scene.camera import Camera
    from volumerenderingproject.utils.imageio import (
        encode_png,
        load_png,
        to_display,
        to_uint8,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rec_path = os.path.join(root, "goldens", "recovered_cameras.json")
    out_dir = os.path.join(root, "goldens", "recovered_previews")
    os.makedirs(out_dir, exist_ok=True)
    with open(rec_path) as f:
        recovered = json.load(f)

    volume = load_nifti("/root/reference/avg152T1_LR_nifti2.nii")
    tf = default_transfer_function()
    for name, rec in recovered.items():
        meta = gold.parse_golden_name(name)
        alg = ALGO_BY_ID[meta["algorithm"]]
        cam = Camera(**{k: jnp.asarray(v, jnp.float32)
                        for k, v in rec["camera"].items()})
        cfg = RenderConfig(
            width=meta["width"], height=meta["height"],
            samples_per_ray=meta["spr"], algorithm=alg,
            view_angle=rec.get("view_angle", math.pi / 4),
        )
        img = np.asarray(render(volume, tf, cam, cfg))
        ours = to_uint8(to_display(img[..., :3], alg))
        golden = to_uint8(load_png(
            os.path.join("/root/reference/image_output", name)))
        sep = np.full((golden.shape[0], 4, 3), 255, np.uint8)
        side = np.concatenate([golden, sep, ours], axis=1)
        out = os.path.join(out_dir, name.replace(".png", "_pair.png"))
        with open(out, "wb") as f:
            f.write(encode_png(side))
        print(f"{name}: NCC {rec['ncc_refined']:.3f} -> {out}", flush=True)


if __name__ == "__main__":
    main()
