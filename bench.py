"""Benchmark the renderer on one NVIDIA GPU.

    python bench.py            # the cells below, one JSON line at the end
    python bench.py --sweep    # block_rays x num_warps of the fused a1 march
    python bench.py --profile DIR  # device time per op of the a1 cells

Every number is the median over ``--frames`` frames after one warm-up,
each timed to ``block_until_ready`` in this one process, on a seeded head
phantom at the MNI152-1mm grid (182x218x182 f32).  The script fails when
JAX finds no GPU, and prints the card's name and power limit beside the
numbers.

Cells (ms/frame and rays/s):
  a1_700_prepare   the XLA pass before the fused march's kernel (volume
                   normalization + brick occupancy), alone
  a1_700_eps1e-3   a1 700^2 x 500 spr, early_termination 1e-3: fused march
  a1_700_exact     the same at early_termination 0
  a1_700_xla       the same render on the XLA scan (``mode="xla"``)
  lut_phong_300    300^2 x 300, 256-entry TF LUT + Phong lighting
  sobel_lit_700    700^2 x 250, Sobel gradient filter + Phong lighting
  a5_500           a5 (trilinear colour) 500^2 x 500
  multichannel_304 3-channel avg152-grid volume, 304^2 x 300

The cell design (which deployments, which metrics, per-layer breakdown)
is the subject of the benchmark work in ROADMAP.md item A1.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _device():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def sweep(args) -> dict:
    """Fused a1 march at 700^2 x 500 on the MNI phantom for every
    (block_rays, num_warps) pair, at early_termination 1e-3 and 0."""
    import jax

    from volumerenderingproject import RenderConfig, default_transfer_function
    from volumerenderingproject import reset_preset
    from volumerenderingproject.harness.profiling import time_frames
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.ops import gpu_march

    vol = synthetic.head_phantom(synthetic.MNI_1MM, seed=args.seed)
    tf, cam = default_transfer_function(), reset_preset()
    out = {}
    for eps in (1e-3, 0.0):
        cfg = RenderConfig(width=700, height=700, samples_per_ray=500,
                           early_termination=eps)
        for rays in (32, 64, 128, 256):
            for warps in (1, 2, 4, 8):
                if rays < 32 * warps:
                    continue
                fn = jax.jit(lambda v, t, c, r=rays, w=warps: (
                    gpu_march.render_vrc(v, t, c, cfg, block_rays=r,
                                         num_warps=w)))
                ms, _ = time_frames(fn, vol, tf, cam, frames=args.frames)
                key = f"eps{eps:g}_r{rays}_w{warps}"
                out[key] = round(ms, 4)
                print(f"sweep {key}: {ms:.4f} ms/frame", flush=True)
    return out


def cells(args) -> dict:
    import jax

    from volumerenderingproject import (
        Algorithm,
        RenderConfig,
        default_transfer_function,
        make_volume,
        render_jit,
        reset_preset,
    )
    from volumerenderingproject.harness.profiling import time_frames
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.ops import gpu_march

    vol = synthetic.head_phantom(synthetic.MNI_1MM, seed=args.seed)
    small = synthetic.head_phantom(synthetic.AVG152, seed=args.seed).data
    vol3 = make_volume(np.stack([small, small * 0.7, small * 0.4], axis=-1))
    tf, cam = default_transfer_function(), reset_preset()
    a1 = RenderConfig(width=700, height=700, samples_per_ray=500)
    table = (
        ("a1_700_eps1e-3", vol, a1.replace(early_termination=1e-3), "fast"),
        ("a1_700_exact", vol, a1, "fast"),
        ("a1_700_xla", vol, a1, "xla"),
        ("lut_phong_300", vol, RenderConfig(
            width=300, height=300, samples_per_ray=300, tf_lut=256,
            lighting=True), "fast"),
        ("sobel_lit_700", vol, RenderConfig(
            width=700, height=700, samples_per_ray=250, lighting=True,
            gradient_filter="sobel"), "fast"),
        ("a5_500", vol, RenderConfig(
            width=500, height=500, samples_per_ray=500,
            algorithm=Algorithm.TEST), "fast"),
        ("multichannel_304", vol3, RenderConfig(
            width=304, height=304, samples_per_ray=300), "fast"),
    )
    out = {}
    # the XLA pass the fused march runs before its kernel, alone
    ms, _ = time_frames(jax.jit(lambda v, t: gpu_march.prepare(v, t, a1)),
                        vol, tf, frames=args.frames)
    out["a1_700_prepare"] = {"ms_per_frame": round(ms, 4)}
    print(f"a1_700_prepare: {ms:.4f} ms/frame", flush=True)
    for name, v, cfg, mode in table:
        ms, _ = time_frames(
            lambda: render_jit(v, tf, cam, cfg, mode=mode),
            frames=args.frames)
        out[name] = {"ms_per_frame": round(ms, 4),
                     "rays_per_s": round(cfg.num_rays / ms * 1e3, 1)}
        print(f"{name}: {ms:.4f} ms/frame", flush=True)
    return out


def profile(args) -> dict:
    """Trace ``--frames`` frames of the a1 700^2 x 500 cells and reduce
    each trace to device time per operation."""
    import os

    import jax

    from volumerenderingproject import (
        RenderConfig,
        default_transfer_function,
        render_jit,
        reset_preset,
    )
    from volumerenderingproject.harness.profiling import device_time_by_op
    from volumerenderingproject.ingest import synthetic

    vol = synthetic.head_phantom(synthetic.MNI_1MM, seed=args.seed)
    tf, cam = default_transfer_function(), reset_preset()
    a1 = RenderConfig(width=700, height=700, samples_per_ray=500)
    out = {}
    for name, cfg, mode in (
            ("a1_700_eps1e-3", a1.replace(early_termination=1e-3), "fast"),
            ("a1_700_xla", a1, "xla")):
        jax.block_until_ready(render_jit(vol, tf, cam, cfg, mode=mode))
        trace_dir = os.path.join(args.profile, name)
        with jax.profiler.trace(trace_dir):
            for _ in range(args.frames):
                jax.block_until_ready(render_jit(vol, tf, cam, cfg, mode=mode))
        out[name] = device_time_by_op(trace_dir)
        out[name]["frames"] = args.frames
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", action="store_true",
                   help="sweep the fused march's block_rays x num_warps")
    p.add_argument("--profile", metavar="DIR",
                   help="trace the a1 cells into DIR and reduce the traces")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from volumerenderingproject.harness.profiling import card_info, require_gpu
    from volumerenderingproject.utils.cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    card = card_info()
    print("card:", card, flush=True)
    if args.sweep:
        result = sweep(args)
    elif args.profile:
        result = profile(args)
    else:
        result = cells(args)
    print(json.dumps({"device": _device(), "card": card,
                      "frames": args.frames, "results": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
