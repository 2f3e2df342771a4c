"""Command-line harness — the runtime replacement for the reference app.

The reference app (myApp.cu main/renderLoop/processInput) is an interactive
GL window whose every setting is compile-time (utils.h AppData); this CLI
exposes the same capabilities as composable commands:

  render   one frame to PNG (any algorithm / camera / size / spr — the
           reference needed a recompile per configuration)
  orbit    a camera-orbit frame sequence (the WASD loop, myApp.cu:1088-1112)
  fit      optimize transfer-function colors against a target image
  bench    per-stage timed render (the myApp.cu:885-907 timers, formalized)
  info     dump the NIfTI header (displayNIFTI2Header, BinaryLoader.cu:166)
  compare  score a render against a reference golden capture

Run as ``python -m volumerenderingproject <command> ...``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _load_volume(args):
    from ..ingest import load_nifti, synthetic

    if args.data == "sphere":
        return synthetic.centered_sphere()
    if args.data == "corner-sphere":
        return synthetic.corner_sphere()
    return load_nifti(args.data)


def _camera(args, config):
    from ..scene.camera import Camera, default_camera, reset_preset

    if args.camera == "preset":
        cam = reset_preset()
    elif args.camera == "default":
        cam = default_camera()
    else:
        pos = tuple(float(v) for v in args.camera.split(","))
        cam = Camera.initial(
            position=pos,
            screen_w=config.real_screen_width,
            screen_h=config.real_screen_height,
        )
    if args.orbit:
        yaw, pitch, zoom = (float(v) for v in args.orbit.split(","))
        cam = cam.orbit(
            math.radians(yaw),
            math.radians(pitch),
            zoom,
            screen_w=config.real_screen_width,
            screen_h=config.real_screen_height,
        )
    return cam


def _config(args):
    from ..utils.config import Algorithm, Interp, RenderConfig

    if args.config:
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    else:
        cfg = RenderConfig()
    over = {}
    if args.width:
        over["width"] = args.width
    if args.height:
        over["height"] = args.height
    if args.spr:
        over["samples_per_ray"] = args.spr
    if args.algorithm:
        over["algorithm"] = Algorithm[args.algorithm.upper()]
    if getattr(args, "lighting", False):
        over["lighting"] = True
    if getattr(args, "gradient_filter", None):
        over["gradient_filter"] = args.gradient_filter
    if getattr(args, "presmooth", None):
        over["presmooth_sigma"] = args.presmooth
    if getattr(args, "conic", False):
        over["conic"] = True
    if getattr(args, "interp", None):
        over["interp"] = Interp(args.interp)
    if getattr(args, "scattering", False):
        over["scattering"] = True
    if getattr(args, "scattering_strength", None) is not None:
        over["scattering_strength"] = args.scattering_strength
    return cfg.replace(**over) if over else cfg


def _render(volume, tf, cam, cfg, backend: str, mesh_spec: str | None,
            exact_points: bool = False, depth: bool = False):
    from ..models.raycast import render
    from ..utils.config import Algorithm

    if depth:
        # z-buffer visualization (3.3.zbuffershader.fs analog)
        from ..models import point_splat

        if cfg.algorithm is Algorithm.POINT:
            return point_splat.render_points_depth(volume, cam, cfg)
        return point_splat.render_depth_vrc(volume, tf, cam, cfg)
    if exact_points and cfg.algorithm is Algorithm.POINT:
        from ..models.point_splat import render_points

        return render_points(volume, tf, cam, cfg, exact=True)
    if mesh_spec:
        if cfg.algorithm is Algorithm.POINT:
            raise SystemExit(
                "error: --mesh supports the ray-cast algorithms (vrc/test); "
                "POINT splatting is a single-device path"
            )
        from ..parallel.mesh import make_mesh
        from ..parallel.render_dist import render_vrc_sharded

        spec = dict(kv.split("=") for kv in mesh_spec.split(","))
        mesh = make_mesh(**{k: int(v) for k, v in spec.items()})
        return render_vrc_sharded(volume, tf, cam, cfg, mesh)
    return render(volume, tf, cam, cfg, mode=backend)


def _tf(args):
    from ..scene.transfer_function import default_transfer_function, from_text

    if getattr(args, "tf", None):
        with open(args.tf) as f:
            return from_text(f.read())
    return default_transfer_function()


def cmd_render(args) -> int:
    import numpy as np

    from ..utils import imageio

    cfg = _config(args)
    volume = _load_volume(args)
    tf = _tf(args)
    cam = _camera(args, cfg)
    t0 = time.time()
    img = np.asarray(
        _render(
            volume, tf, cam, cfg, args.backend, args.mesh,
            exact_points=getattr(args, "exact_points", False),
            depth=getattr(args, "depth", False),
        )
    )
    dt = time.time() - t0
    if getattr(args, "window", None):
        # render-to-texture display: resample the offscreen render onto a
        # fullscreen quad at the window resolution (myApp.cu:1732-1901's
        # unfinished FBO path, completed — utils/texture.py)
        from ..utils.texture import texture_quad_display

        ww, wh = (int(x) for x in args.window.split("x"))
        img = np.asarray(texture_quad_display(img, ww, wh))
    out = args.out or (
        f"image_{cfg.width}x{cfg.height}_a{cfg.algorithm.value}"
        f"_spr{cfg.samples_per_ray}.png"
    )  # reference naming, myApp.cu:1209-1210
    imageio.save_png(out, img, cfg.algorithm)
    print(f"rendered {cfg.width}x{cfg.height} spr={cfg.samples_per_ray} "
          f"alg={cfg.algorithm.name} in {dt:.2f}s -> {out}")
    return 0


def cmd_orbit(args) -> int:
    import numpy as np

    from ..utils import imageio

    cfg = _config(args)
    volume = _load_volume(args)
    tf = _tf(args)
    cam = _camera(args, cfg)
    step = math.radians(args.step_deg)
    for i in range(args.frames):
        img = np.asarray(_render(volume, tf, cam, cfg, args.backend, args.mesh))
        path = f"{args.out_prefix}{i:04d}.png"
        imageio.save_png(path, img, cfg.algorithm)
        print(f"frame {i}: {path}")
        cam = cam.orbit(
            yaw_rad=step,
            screen_w=cfg.real_screen_width,
            screen_h=cfg.real_screen_height,
        )
    return 0


def cmd_fit(args) -> int:
    import numpy as np

    from ..diff.fit import fit_transfer_function
    from ..models.raycast import render
    from ..scene.transfer_function import TransferFunction, to_text
    from ..utils import imageio

    cfg = _config(args)
    volume = _load_volume(args)
    tf = _tf(args)
    cam = _camera(args, cfg)
    if args.target:
        disp = imageio.load_png(args.target)
        target = imageio.from_display(disp, cfg.algorithm)
        import jax.numpy as jnp

        target = jnp.asarray(
            np.concatenate([target, np.ones_like(target[..., :1])], -1)
        )
    else:  # self-target smoke: fit against own render
        target = render(volume, tf, cam, cfg)
    light = None
    if getattr(args, "fit_light", False):
        from ..ops import phong

        light = phong.default_light()
    params, losses = fit_transfer_function(
        volume,
        cam,
        target,
        tf,
        cfg,
        steps=args.steps,
        learning_rate=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        fit_bounds=getattr(args, "fit_bounds", False),
        light=light,
    )
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {args.steps} steps")
    fitted = TransferFunction(
        tf.lower if params.tf_lower is None else params.tf_lower,
        tf.upper if params.tf_upper is None else params.tf_upper,
        params.tf_colors, tf.hg_g)
    if params.light is not None:
        from ..ops import phong

        print("fitted light:",
              np.asarray(phong.light_to_vec(params.light)).round(4).tolist())
    if args.out_tf:
        with open(args.out_tf, "w") as f:
            f.write(to_text(fitted))
        print(f"wrote {args.out_tf}")
    return 0


def cmd_bench(args) -> int:
    import jax

    from .profiling import StageTimer

    cfg = _config(args)
    volume = _load_volume(args)
    tf = _tf(args)
    cam = _camera(args, cfg)

    timer = StageTimer()
    with timer.stage("compile+first") as out:
        out["img"] = _render(volume, tf, cam, cfg, args.backend, args.mesh)

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if getattr(args, "profile", None):
        # XLA timeline capture (XProf/TensorBoard) around the timed
        # frames — the deep-dive counterpart of the stage timers
        from .profiling import trace

        profile_ctx = trace(args.profile)
    with profile_ctx:
        for r in range(args.repeats):
            import dataclasses

            cam_r = dataclasses.replace(
                cam, position=cam.position + 1e-6 * (r + 1)
            )
            with timer.stage(f"frame{r}") as out:
                img = _render(volume, tf, cam_r, cfg, args.backend, args.mesh)
                out["img"] = jax.block_until_ready(img)
    if getattr(args, "profile", None):
        print(f"profiler trace written to {args.profile}")
    print(timer.report())
    frames = [t for n, t in timer.stages if n.startswith("frame")]
    if frames:
        best = min(frames)
        print(
            json.dumps(
                {
                    "metric": f"rays_per_sec_{cfg.width}x{cfg.height}"
                    f"_spr{cfg.samples_per_ray}",
                    "value": round(cfg.num_rays / best, 1),
                    "unit": "rays/s",
                }
            )
        )
    return 0


def cmd_info(args) -> int:
    from ..ingest.nifti import parse_header

    with open(args.data, "rb") as f:
        hdr = parse_header(f.read(1024))
    for field in (
        "sizeof_hdr",
        "magic",
        "datatype",
        "bitpix",
        "dim",
        "pixdim",
        "vox_offset",
        "scl_slope",
        "scl_inter",
        "cal_max",
        "cal_min",
        "byteorder",
    ):
        print(f"{field.upper()}: {getattr(hdr, field)}")
    return 0


def cmd_recover_golden(args) -> int:
    from .camera_recovery import main as recover_main

    argv = list(args.goldens)
    argv += ["--golden-dir", args.golden_dir, "--dataset", args.dataset,
             "--out", args.out, "--n-dirs", str(args.n_dirs),
             "--n-rolls", str(args.n_rolls)]
    recover_main(argv)
    return 0


def cmd_compare(args) -> int:
    from ..utils import imageio
    from . import goldens

    ours = imageio.load_png(args.ours)
    golden = imageio.load_png(args.golden)
    meta = goldens.parse_golden_name(args.golden)
    if meta:
        print(f"golden config: {meta}")
    sim = goldens.similarity(ours, golden)
    print(f"similarity (ncc): {sim:.4f}")
    return 0 if sim >= args.threshold else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volumerenderingproject", description=__doc__
    )
    p.add_argument("--platform", help="force a jax platform, e.g. 'cpu'")
    p.add_argument(
        "--host-devices",
        type=int,
        help="virtual CPU device count (for --mesh testing without a pod)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, data=True):
        if data:
            sp.add_argument(
                "--data",
                default="sphere",
                help=".nii path, or 'sphere' / 'corner-sphere' fixtures",
            )
        sp.add_argument("--width", type=int)
        sp.add_argument("--height", type=int)
        sp.add_argument("--spr", type=int)
        sp.add_argument(
            "--algorithm", choices=["point", "vrc", "test"], default=None
        )
        sp.add_argument("--camera", default="preset")
        sp.add_argument("--orbit", help="yaw_deg,pitch_deg,zoom")
        sp.add_argument("--lighting", action="store_true")
        sp.add_argument("--gradient-filter", choices=["central", "sobel"])
        sp.add_argument("--presmooth", type=float,
                        help="Gaussian sigma for the pre-render gradient "
                             "filter (BASELINE config 4)")
        sp.add_argument("--conic", action="store_true")
        sp.add_argument("--scattering", action="store_true",
                        help="single-scattering transport (HG phase x "
                             "light transmittance)")
        sp.add_argument("--scattering-strength", type=float)
        sp.add_argument("--interp", choices=["nearest", "trilinear_color", "trilinear"])
        sp.add_argument("--config", help="RenderConfig JSON path")
        sp.add_argument("--tf", help="transfer-function text file")
        sp.add_argument(
            "--backend", choices=["fast", "xla"], default="fast",
            help="fast: the fused GPU march where it applies, else the XLA "
                 "scan; xla: always the XLA scan")
        sp.add_argument("--mesh", help="e.g. rays=4,samples=2")

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--out")
    sp.add_argument(
        "--depth", action="store_true",
        help="render the depth buffer (zbuffer-shader analog) instead of "
             "colors")
    sp.add_argument(
        "--window", metavar="WxH",
        help="display the render through a textured fullscreen quad at "
             "this window size (render-to-texture path)")
    sp.add_argument(
        "--exact-points",
        action="store_true",
        help="POINT mode: exact GL draw-order blending (native rasterizer)",
    )
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("orbit", help="render an orbit sequence")
    common(sp)
    sp.add_argument("--frames", type=int, default=8)
    sp.add_argument("--step-deg", type=float, default=45.0)
    sp.add_argument("--out-prefix", default="orbit_")
    sp.set_defaults(fn=cmd_orbit)

    sp = sub.add_parser("fit", help="optimize TF colors to a target image")
    common(sp)
    sp.add_argument("--target", help="target PNG (display orientation)")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--out-tf")
    sp.add_argument("--checkpoint-dir")
    sp.add_argument("--checkpoint-every", type=int, default=0)
    sp.add_argument("--fit-bounds", action="store_true",
                    help="optimize TF interval bounds too (smooth mode: "
                         "--interp trilinear)")
    sp.add_argument("--fit-light", action="store_true",
                    help="optimize the 10 Blinn-Phong light parameters")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("bench", help="timed render with per-stage report")
    sp.add_argument(
        "--profile", metavar="DIR",
        help="capture a jax.profiler trace of the timed frames to DIR "
             "(open in XProf/TensorBoard)")
    common(sp)
    sp.add_argument("--repeats", type=int, default=3)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("info", help="dump NIfTI header")
    sp.add_argument("--data", required=True)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("compare", help="compare a render to a golden PNG")
    sp.add_argument("--ours", required=True)
    sp.add_argument("--golden", required=True)
    sp.add_argument("--threshold", type=float, default=0.0)
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser(
        "recover-golden",
        help="search the orbit manifold for a golden capture's camera "
             "(harness/camera_recovery.py; run on the GPU)")
    sp.add_argument("goldens", nargs="*")
    sp.add_argument("--golden-dir", default="/root/reference/image_output")
    sp.add_argument("--dataset",
                    default="/root/reference/avg152T1_LR_nifti2.nii")
    sp.add_argument("--out", default="goldens/recovered_cameras.json")
    sp.add_argument("--n-dirs", type=int, default=1500)
    sp.add_argument("--n-rolls", type=int, default=12)
    sp.set_defaults(fn=cmd_recover_golden)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.host_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}"
        ).strip()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
