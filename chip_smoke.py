"""Smoke test of the renderer on one NVIDIA GPU (or, with --four, four).

    python chip_smoke.py                 # every one-card phase
    python chip_smoke.py --four          # the four-card phase only
    python chip_smoke.py --phases a1,fit # a subset of the one-card phases

Every phase runs in this one process, through the entry points a user
calls (``render_jit``, the CLI, the HTTP server, ``make_train_step``,
``render_vrc_sharded``), on a seeded head phantom at the MNI152-1mm grid
(182x218x182 f32).  The phases:

  device  the devices, the card's name and power limit, XLA_FLAGS and the
          compilation cache directory
  a1      the a1 headline, 700^2 x 500 spr, fused GPU march against the XLA
          scan on an avg152-shaped and an MNI-shaped phantom at
          early_termination 0 (max abs <= 2e-5) and 1e-3 (<= 2e-3);
          median ms/frame and rays/s of both
  cpu     the XLA scan at 128^2 x 128 on the GPU against the CPU: max abs
          <= 2e-5 except for voxel flips at cell boundaries, which must
          stay under 0.1% of the pixels
  modes   a5 at 500^2 x 500, Sobel-lit a1 at 700^2 x 250 and a 3-channel
          volume at 304^2 x 300 (all on the XLA scan): finite, ms/frame
  fit     three make_train_step steps (TF colours, density, light) at
          304^2 x 300: finite loss, ms/step
  cli     ``cli.main(["render", ...])`` at 700^2 x 500, PNG read back
  server  ``server.serve`` on port 0, three /render requests, PNGs back

Any failure exits non-zero and prints no result.  The last line of a
passing run is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

ONE_CARD_PHASES = ("device", "a1", "cpu", "modes", "fit", "cli", "server")


def _scene(dims, seed):
    from volumerenderingproject import default_transfer_function, reset_preset
    from volumerenderingproject.ingest import synthetic

    return (synthetic.head_phantom(dims, seed=seed),
            default_transfer_function(), reset_preset())


def _maxabs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _flip_share(a, b, tol) -> float:
    """Share of pixels whose largest channel difference exceeds ``tol``."""
    d = np.max(np.abs(np.asarray(a) - np.asarray(b)), axis=-1)
    return float(np.mean(d > tol))


def phase_device(args):
    import jax

    from volumerenderingproject.harness.profiling import card_info
    from volumerenderingproject.utils.cache import enable_compile_cache

    print("devices:", jax.devices())
    print("nvidia-smi:", card_info().replace("\n", " | "))
    print("XLA_FLAGS:", os.environ.get("XLA_FLAGS", ""))
    print("compilation cache:", enable_compile_cache())


def phase_a1(args):
    from volumerenderingproject import RenderConfig, render_jit
    from volumerenderingproject.harness.profiling import time_frames
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.ops import gpu_march

    for name, dims in (("avg152", synthetic.AVG152),
                       ("mni1mm", synthetic.MNI_1MM)):
        vol, tf, cam = _scene(dims, args.seed)
        base = RenderConfig(width=700, height=700, samples_per_ray=500)
        ms_x, _ = time_frames(
            lambda: render_jit(vol, tf, cam, base, mode="xla"),
            frames=args.frames)
        ref = render_jit(vol, tf, cam, base, mode="xla")
        print(f"a1 {name} {dims} 700^2x500 xla scan: {ms_x:.3f} ms/frame, "
              f"{base.num_rays / ms_x * 1e3:.4g} rays/s")
        for eps, tol in ((0.0, 2e-5), (1e-3, 2e-3)):
            cfg = base.replace(early_termination=eps)
            assert gpu_march.eligible(vol, cfg), "fused march not routed"
            img = render_jit(vol, tf, cam, cfg)
            err = _maxabs(img, ref)
            ms_k, _ = time_frames(lambda: render_jit(vol, tf, cam, cfg),
                                  frames=args.frames)
            print(f"a1 {name} eps={eps:g} fused march: {ms_k:.3f} ms/frame, "
                  f"{cfg.num_rays / ms_k * 1e3:.4g} rays/s, "
                  f"{ms_x / ms_k:.2f}x the scan; max abs vs scan {err:.3g} "
                  f"(limit {tol:g}), {_flip_share(img, ref, tol):.3g} of "
                  "pixels over the limit")
            assert np.isfinite(np.asarray(img)).all()
            assert err <= tol, f"a1 {name} eps={eps}: max abs {err} > {tol}"


def phase_cpu(args):
    import jax

    from volumerenderingproject import RenderConfig
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.models.raycast import render

    vol, tf, cam = _scene(synthetic.MNI_1MM, args.seed)
    cfg = RenderConfig(width=128, height=128, samples_per_ray=128)
    fn = jax.jit(lambda v, t, c: render(v, t, c, cfg, mode="xla"))
    gpu = np.asarray(fn(vol, tf, cam))
    cpu_dev = jax.devices("cpu")[0]
    cpu = np.asarray(fn(*jax.device_put((vol, tf, cam), cpu_dev)))
    err = _maxabs(gpu, cpu)
    share = _flip_share(gpu, cpu, 2e-5)
    print(f"xla scan 128^2x128 gpu vs cpu: max abs {err:.3g}, "
          f"{int(round(share * cfg.num_rays))} of {cfg.num_rays} pixels "
          f"over 2e-5 ({share:.3%}, limit 0.1%)")
    assert share < 1e-3, f"gpu vs cpu: {share:.3%} of pixels differ"


def phase_modes(args):
    from volumerenderingproject import Algorithm, RenderConfig, make_volume
    from volumerenderingproject import render_jit
    from volumerenderingproject.harness.profiling import time_frames
    from volumerenderingproject.ingest import synthetic

    vol, tf, cam = _scene(synthetic.MNI_1MM, args.seed)
    small = synthetic.head_phantom(synthetic.AVG152, seed=args.seed).data
    vol3 = make_volume(np.stack(
        [small, small * 0.7, small * 0.4], axis=-1))
    cases = (
        ("a5 500^2x500", vol, RenderConfig(
            width=500, height=500, samples_per_ray=500,
            algorithm=Algorithm.TEST)),
        ("sobel-lit a1 700^2x250", vol, RenderConfig(
            width=700, height=700, samples_per_ray=250, lighting=True,
            gradient_filter="sobel")),
        ("3-channel a1 304^2x300", vol3, RenderConfig(
            width=304, height=304, samples_per_ray=300)),
    )
    for name, v, cfg in cases:
        img = render_jit(v, tf, cam, cfg)
        assert np.isfinite(np.asarray(img)).all(), f"{name}: non-finite"
        ms, _ = time_frames(lambda: render_jit(v, tf, cam, cfg),
                            frames=args.frames)
        print(f"{name} (xla scan): {ms:.3f} ms/frame, "
              f"{cfg.num_rays / ms * 1e3:.4g} rays/s")


def phase_fit(args):
    import jax
    import optax

    from volumerenderingproject import RenderConfig, render_jit
    from volumerenderingproject.diff.fit import FitParams, make_train_step
    from volumerenderingproject.ingest import synthetic
    from volumerenderingproject.ops import phong

    vol, tf, cam = _scene(synthetic.MNI_1MM, args.seed)
    cfg = RenderConfig(width=304, height=304, samples_per_ray=300)
    target = render_jit(vol, tf, cam, cfg.replace(density_scale=0.8))
    opt = optax.adam(1e-2)
    params = FitParams.init(tf, light=phong.default_light())
    state = opt.init(params)
    step = make_train_step(tf, cfg, opt)
    params, state, loss = jax.block_until_ready(
        step(params, state, vol, cam, target))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, loss = jax.block_until_ready(
            step(params, state, vol, cam, target))
        times.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(loss)), f"fit loss {loss}"
    print(f"fit 304^2x300 (colours, density, light): loss {float(loss):.6g}, "
          f"{float(np.median(times)):.3f} ms/step")


def phase_cli(args):
    from volumerenderingproject.harness import cli
    from volumerenderingproject.utils import imageio

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--data", "sphere", "--width", "700",
                       "--height", "700", "--spr", "500", "--out", out])
        assert rc == 0, f"cli rc {rc}"
        img = imageio.load_png(out)
    assert img.shape == (700, 700, 3), img.shape
    print(f"cli render 700^2x500 -> PNG {img.shape} in "
          f"{time.perf_counter() - t0:.2f} s (compile included)")


def phase_server(args):
    import urllib.request

    from volumerenderingproject.harness import server
    from volumerenderingproject.utils import imageio

    httpd = server.serve("sphere", port=0, host="127.0.0.1")
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        for i, yaw in enumerate((0, 20, 40)):
            url = (f"http://127.0.0.1:{port}/render?width=700&height=700"
                   f"&spr=500&orbit={yaw},10,0")
            t0 = time.perf_counter()
            with urllib.request.urlopen(url, timeout=600) as r:
                assert r.status == 200, r.status
                assert r.headers["Content-Type"] == "image/png"
                png = imageio.decode_png(r.read())
            assert png.shape == (700, 700, 3), png.shape
            print(f"server /render #{i} 700^2x500: PNG {png.shape} in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)


def phase_four(args):
    """render_vrc_sharded on three 4-card meshes against the one-card
    render, and sharded-fit gradients against unsharded ones."""
    import jax
    import jax.numpy as jnp

    from volumerenderingproject import RenderConfig, render_jit
    from volumerenderingproject.diff.fit import FitParams, render_loss
    from volumerenderingproject.harness.profiling import time_frames
    from volumerenderingproject.ops import phong
    from volumerenderingproject.parallel.mesh import make_mesh
    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded_jit,
    )
    from volumerenderingproject.utils.config import Interp

    n = len(jax.devices())
    assert n >= 4, f"--four needs 4 GPUs, found {n}"
    # the MNI grid with x padded to a multiple of 4 for the volume axis
    vol, tf, cam = _scene((184, 218, 182), args.seed)
    lit = RenderConfig(width=700, height=700, samples_per_ray=250,
                       lighting=True)
    plain = RenderConfig(width=700, height=700, samples_per_ray=500)
    cases = (
        ("rays=4 lit", dict(rays=4), lit),
        ("rays=2,samples=2 lit", dict(rays=2, samples=2), lit),
        ("volume=4 lit", dict(rays=1, volume=4), lit),
        ("rays=2,samples=2 fused march", dict(rays=2, samples=2), plain),
    )
    singles = {}
    for name, axes, cfg in cases:
        mesh = make_mesh(devices=jax.devices()[:4], **axes)
        if cfg not in singles:
            singles[cfg] = render_jit(vol, tf, cam, cfg)
            ms1, _ = time_frames(lambda: render_jit(vol, tf, cam, cfg),
                                 frames=args.frames)
            print(f"one card {cfg.width}^2x{cfg.samples_per_ray} "
                  f"lighting={cfg.lighting}: {ms1:.3f} ms/frame")
        img = render_vrc_sharded_jit(vol, tf, cam, cfg, mesh)
        err = _maxabs(img, singles[cfg])
        share = _flip_share(img, singles[cfg], 1e-4)
        ms, _ = time_frames(
            lambda: render_vrc_sharded_jit(vol, tf, cam, cfg, mesh),
            frames=args.frames)
        print(f"four cards {name}: {ms:.3f} ms/frame; max abs vs one card "
              f"{err:.3g}, {share:.3%} of pixels over 1e-4 (limit 0.1%)")
        assert share < 1e-3, f"{name}: {share:.3%} of pixels differ"

    mesh = make_mesh(rays=1, samples=2, volume=2, devices=jax.devices()[:4])
    fit_cfg = RenderConfig(width=304, height=304, samples_per_ray=300)
    fits = (
        ("a1 colours+density+light", fit_cfg,
         FitParams.init(tf, light=phong.default_light())),
        ("trilinear lit colours+density+bounds",
         fit_cfg.replace(interp=Interp.TRILINEAR, lighting=True,
                         tf_sharpness=40.0),
         FitParams.init(tf, fit_bounds=True)),
    )
    for name, cfg, params in fits:
        target = jnp.zeros((cfg.width, cfg.height, 4), jnp.float32)
        g_mesh = jax.jit(lambda p: jax.grad(render_loss)(
            p, tf, vol, cam, target, cfg, mesh))(params)
        g_one = jax.jit(lambda p: jax.grad(render_loss)(
            p, tf, vol, cam, target, cfg))(params)
        worst = 0.0
        for path, gm in jax.tree_util.tree_leaves_with_path(g_mesh):
            gs = dict(jax.tree_util.tree_leaves_with_path(g_one))[path]
            scale = float(jnp.max(jnp.abs(gs))) + 1e-8
            rel = float(jnp.max(jnp.abs(gm - gs))) / scale
            worst = max(worst, rel)
            assert rel <= 1e-3, (
                f"{name} grad {jax.tree_util.keystr(path)}: rel err {rel}")
        print(f"sharded fit grads {name} on {dict(mesh.shape)} 304^2x300: "
              f"worst relative error vs one card {worst:.3g} (limit 1e-3)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--phases", default=",".join(ONE_CARD_PHASES),
                   help="comma-separated one-card phases to run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=5,
                   help="timed frames per measurement (median reported)")
    args = p.parse_args(argv)

    import jax

    from volumerenderingproject.harness.profiling import card_info, require_gpu
    from volumerenderingproject.utils.cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    if args.four:
        phases = [("device", phase_device), ("four", phase_four)]
    else:
        names = [s for s in args.phases.split(",") if s]
        unknown = set(names) - set(ONE_CARD_PHASES)
        if unknown:
            p.error(f"unknown phases {sorted(unknown)}")
        phases = [(s, globals()[f"phase_{s}"]) for s in names]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"--- {name}", flush=True)
        try:
            fn(args)
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f"--- {name}: {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(card_info())
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
