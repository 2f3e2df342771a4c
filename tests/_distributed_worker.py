"""Worker for the real multi-process jax.distributed test.

Launched (2 processes) by tests/test_distributed.py: each process brings up
``jax.distributed.initialize`` over a localhost coordinator with 4 virtual
CPU devices, builds the global 8-device ("rays", "samples", "volume") mesh,
renders a rays-sharded frame, and asserts its *addressable* output columns
equal the locally-computed single-device render — executable evidence for
the multi-host path (SURVEY.md §5 distributed backend) without a pod.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    coordinator, process_id = sys.argv[1], int(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    from volumerenderingproject.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed(
        coordinator_address=coordinator,
        num_processes=2,
        process_id=process_id,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from volumerenderingproject import (
        Camera,
        RenderConfig,
        default_transfer_function,
        make_volume,
    )
    from volumerenderingproject.models.raycast import render_vrc
    from volumerenderingproject.parallel.render_dist import (
        render_vrc_sharded_jit,
    )

    rng = np.random.default_rng(7)
    volume = make_volume(rng.uniform(0, 255, size=(8, 10, 9)).astype(np.float32))
    tf = default_transfer_function()
    cam = Camera.initial(position=(0.4, 0.3, 0.9))
    cfg = RenderConfig(width=16, height=6, samples_per_ray=24)

    mesh = make_mesh(rays=8, samples=1, volume=1)
    repl = NamedSharding(mesh, P())
    volume_g = jax.tree.map(lambda x: jax.device_put(x, repl), volume)
    tf_g = jax.tree.map(lambda x: jax.device_put(x, repl), tf)
    cam_g = jax.tree.map(lambda x: jax.device_put(x, repl), cam)

    out = render_vrc_sharded_jit(volume_g, tf_g, cam_g, cfg, mesh)

    want = np.asarray(render_vrc(volume, tf, cam, cfg, mode="fast"))
    w_local = cfg.width // 8
    checked = 0
    for shard in out.addressable_shards:
        x0 = shard.index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(shard.data), want[x0 : x0 + w_local], atol=1e-6
        )
        checked += 1
    assert checked > 0

    # 4-D multichannel across the process boundary (BASELINE config 5:
    # "multi-channel ... sharded N>=2 hosts"), rays x volume-slab mesh
    vol_mc = make_volume(
        rng.uniform(0, 255, size=(8, 10, 9, 3)).astype(np.float32))
    mesh2 = make_mesh(rays=4, samples=1, volume=2)
    repl2 = NamedSharding(mesh2, P())
    slab = NamedSharding(mesh2, P("volume"))
    vol_g = type(vol_mc)(
        data=jax.device_put(vol_mc.data, slab),
        cal_max=jax.device_put(vol_mc.cal_max, repl2),
        cal_min=jax.device_put(vol_mc.cal_min, repl2),
        pixdim=jax.device_put(vol_mc.pixdim, repl2),
        dims=vol_mc.dims,
        channels=vol_mc.channels,
    )
    tf_g2 = jax.tree.map(lambda x: jax.device_put(x, repl2), tf)
    cam_g2 = jax.tree.map(lambda x: jax.device_put(x, repl2), cam)
    out2 = render_vrc_sharded_jit(vol_g, tf_g2, cam_g2, cfg, mesh2)
    want2 = np.asarray(render_vrc(vol_mc, tf, cam, cfg, mode="fast"))
    w_local2 = cfg.width // 4
    for shard in out2.addressable_shards:
        x0 = shard.index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(shard.data), want2[x0 : x0 + w_local2], atol=1e-5
        )

    # BASELINE config 5's combination at test scale: a 4-D multi-channel
    # volume through the full sharded pipeline across the 2 processes
    volume4 = make_volume(
        rng.uniform(0, 255, size=(8, 10, 9, 3)).astype(np.float32))
    volume4_g = jax.tree.map(lambda x: jax.device_put(x, repl), volume4)
    out4 = render_vrc_sharded_jit(volume4_g, tf_g, cam_g, cfg, mesh)
    want4 = np.asarray(render_vrc(volume4, tf, cam, cfg, mode="fast"))
    for shard in out4.addressable_shards:
        x0 = shard.index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(shard.data), want4[x0 : x0 + w_local], atol=1e-6
        )

    # ---- TRAINING across the process boundary (VERDICT r3 item 7) -----
    # the gradient psum over the 2-process mesh (the DCN-like boundary)
    # was the one untested collective path: run a full fit step
    # (loss -> grads -> adam update) on a rays x samples mesh spanning
    # both processes and assert loss AND grads equal the process-local
    # single-device computation.
    import jax.numpy as jnp
    import optax

    from volumerenderingproject.diff.fit import (
        FitParams,
        make_train_step,
        render_loss,
    )

    mesh3 = make_mesh(rays=4, samples=2, volume=1)
    repl3 = NamedSharding(mesh3, P())
    put3 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jax.device_put(x, repl3), t)
    vol_g3, tf_g3, cam_g3 = put3(volume), put3(tf), put3(cam)
    target = jnp.zeros((cfg.width, cfg.height, 4), jnp.float32)
    target_g = jax.device_put(target, repl3)
    params = put3(FitParams.init(tf))

    g_mesh = jax.jit(
        lambda p: jax.grad(render_loss)(
            p, tf_g3, vol_g3, cam_g3, target_g, cfg, mesh3)
    )(params)
    # local single-device reference (no mesh, process-local data)
    g_single = jax.grad(render_loss)(
        FitParams.init(tf), tf, volume, cam, target, cfg)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(g_mesh.tf_colors)),
        np.asarray(g_single.tf_colors), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        float(jax.device_get(g_mesh.density_scale)),
        float(g_single.density_scale), rtol=1e-4)

    # one full optimizer step through make_train_step on the global mesh
    optimizer = optax.adam(1e-2)
    opt_state = put3(optimizer.init(FitParams.init(tf)))
    step = make_train_step(tf_g3, cfg, optimizer, mesh=mesh3)
    params2, _, loss = step(params, opt_state, vol_g3, cam_g3, target_g)
    jax.block_until_ready((params2, loss))
    loss_single = float(render_loss(
        FitParams.init(tf), tf, volume, cam, target, cfg))
    np.testing.assert_allclose(
        float(jax.device_get(loss)), loss_single, rtol=1e-5)
    # the updated params are replicated and finite on every process
    p2 = np.asarray(jax.device_get(params2.tf_colors))
    assert np.isfinite(p2).all()
    assert np.abs(p2 - np.asarray(tf.colors)).max() > 0.0  # moved

    print(f"process {process_id}: {checked} shards OK + train step OK",
          flush=True)


if __name__ == "__main__":
    main()
