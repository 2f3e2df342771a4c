"""Differentiable-rendering optimization: fit TF / density to target images.

The reference has no training loop (SURVEY.md: "no autodiff — all of that is
the new framework's mandate").  This module provides the canonical use case:
given target renders, optimize transfer-function colors (and optionally a
global density scale) by gradient descent through the renderer.

Single-device and sharded (mesh) variants share one loss; under a mesh the
renderer runs through shard_map (parallel/render_dist.py) and XLA inserts
the gradient all-reduce over the rays axis when differentiating.

Checkpoints are ``numpy.savez`` files of the flattened parameter and
optimizer pytrees (the reference persists nothing but an in-memory camera
preset, myApp.cu:1160-1186).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, RenderConfig
from ..models import raycast

_f32 = jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FitParams:
    """Optimizable render parameters.

    The full parameter set named by BASELINE.json's north star: transfer
    function (colors and, in smooth mode, interval bounds), density, and
    lighting.  ``tf_lower``/``tf_upper``/``light`` default to ``None``
    (excluded from the optimizable set; ``None`` is an empty pytree so
    optax simply skips them).  Bounds gradients are nonzero only through
    the smooth classify (``config.interp = TRILINEAR``) — the reference's
    piecewise-constant table (TransferFunction.cu:19-23) has zero bound
    gradients a.e., so fitting bounds *requires* the smooth relaxation.
    ``light`` is an ops.phong.Light; its gradients flow through the XLA
    scan's Phong shading.
    """

    tf_colors: jnp.ndarray  # [K, 4]
    density_scale: jnp.ndarray  # scalar
    tf_lower: Optional[jnp.ndarray] = None  # [K] (smooth-mode bound fits)
    tf_upper: Optional[jnp.ndarray] = None  # [K]
    light: Optional[Any] = None  # ops.phong.Light

    @staticmethod
    def init(
        tf: TransferFunction,
        *,
        fit_bounds: bool = False,
        light=None,
    ) -> "FitParams":
        return FitParams(
            tf_colors=tf.colors,
            density_scale=jnp.asarray(1.0, _f32),
            tf_lower=tf.lower if fit_bounds else None,
            tf_upper=tf.upper if fit_bounds else None,
            light=light,
        )


def _apply_params(
    tf: TransferFunction, params: FitParams
) -> TransferFunction:
    return TransferFunction(
        lower=tf.lower if params.tf_lower is None else params.tf_lower,
        upper=tf.upper if params.tf_upper is None else params.tf_upper,
        colors=params.tf_colors,
        hg_g=tf.hg_g,
    )


def render_loss(
    params: FitParams,
    tf: TransferFunction,
    volume: Volume,
    camera: Camera,
    target: jnp.ndarray,
    config: RenderConfig,
    mesh=None,
) -> jnp.ndarray:
    """MSE between the differentiable render and the target image."""
    tf2 = _apply_params(tf, params)
    density = jnp.clip(params.density_scale, 0.0, None)
    if mesh is None:
        img = _render_with_density(
            volume, tf2, camera, config, density, params.light)
    else:
        from ..parallel.render_dist import render_vrc_sharded

        # fold the density knob into the TF alphas so the sharded path
        # trains it identically to the single-device path
        tf3 = TransferFunction(
            lower=tf2.lower,
            upper=tf2.upper,
            colors=tf2.colors.at[:, 3].mul(density),
            hg_g=tf2.hg_g,
        )
        # light and bound gradients all-reduce over the mesh exactly like
        # the colors (XLA inserts the psum when transposing shard_map)
        img = render_vrc_sharded(volume, tf3, camera, config, mesh,
                                 light=params.light)
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


def _render_with_density(volume, tf, camera, config, density, light=None):
    # scale TF alphas by the (traced) density knob, then render with the
    # XLA scan (its gradient is the one every render path shares)
    tf2 = TransferFunction(
        lower=tf.lower,
        upper=tf.upper,
        colors=tf.colors.at[:, 3].mul(density),
        hg_g=tf.hg_g,
    )
    if config.algorithm is Algorithm.TEST:
        return raycast.render_test(
            volume, tf2, camera, config, mode="fast", light=light)
    return raycast.render_vrc(
        volume, tf2, camera, config, mode="fast", light=light)


def make_train_step(
    tf: TransferFunction,
    config: RenderConfig,
    optimizer: optax.GradientTransformation,
    mesh=None,
):
    """Build a jitted train step: (params, opt_state, volume, camera, target)
    -> (params, opt_state, loss)."""

    def step(params, opt_state, volume, camera, target):
        loss, grads = jax.value_and_grad(render_loss)(
            params, tf, volume, camera, target, config, mesh
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def fit_transfer_function(
    volume: Volume,
    camera: Camera,
    target: jnp.ndarray,
    tf: TransferFunction,
    config: RenderConfig,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    fit_bounds: bool = False,
    light=None,
) -> Tuple[FitParams, list]:
    """Optimize TF colors + density (and optionally interval bounds and
    light parameters) against a target image.

    ``fit_bounds=True`` adds tf_lower/tf_upper to the optimizable set
    (meaningful with ``config.interp = TRILINEAR``, the smooth classify);
    ``light`` (an ops.phong.Light) adds the 10 light parameters.

    ``resume=True`` restores the latest checkpoint in ``checkpoint_dir``
    (params AND optimizer state, so the continued trajectory is identical
    to an uninterrupted run) and continues until ``steps`` total steps."""
    params = FitParams.init(tf, fit_bounds=fit_bounds, light=light)
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(params)
    start = 0
    if resume and checkpoint_dir:
        latest = latest_checkpoint_step(checkpoint_dir)
        if latest is not None:
            params, opt_state = load_checkpoint(
                checkpoint_dir, latest, opt_state_like=opt_state)
            start = latest
    train_step = make_train_step(tf, config, optimizer, mesh)

    losses = []
    for i in range(start, steps):
        params, opt_state, loss = train_step(
            params, opt_state, volume, camera, target
        )
        losses.append(float(loss))
        if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, i + 1, params, opt_state)
    return params, losses


# -- checkpoint / resume -----------------------------------------------------


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.npz")


def save_checkpoint(directory: str, step: int, params: FitParams,
                    opt_state=None) -> None:
    """Persist params (and optionally the optax state) at ``step`` as one
    ``.npz``: ``p.<field>`` for each fitted field (``p.light.<field>`` for
    the light), ``o.<i>`` for the i-th optimizer-state leaf."""
    arrays = {}
    for k, v in dataclasses.asdict(params).items():
        if v is None:
            continue
        if isinstance(v, dict):  # the light, flattened by asdict
            for lk, lv in v.items():
                arrays[f"p.light.{lk}"] = np.asarray(lv)
        else:
            arrays[f"p.{k}"] = np.asarray(v)
    if opt_state is not None:
        for i, x in enumerate(jax.tree.leaves(opt_state)):
            arrays[f"o.{i}"] = np.asarray(x)
    os.makedirs(directory, exist_ok=True)
    path = _checkpoint_path(directory, step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def latest_checkpoint_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)\.npz", d))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, opt_state_like=None):
    """Restore a checkpoint.  Without ``opt_state_like``: -> FitParams.
    With it (a pytree of the optimizer state's structure): ->
    (FitParams, opt_state)."""
    with np.load(_checkpoint_path(directory, step)) as z:
        arrays = {k: jnp.asarray(z[k]) for k in z.files}
    light = None
    lfields = {k[len("p.light."):]: v for k, v in arrays.items()
               if k.startswith("p.light.")}
    if lfields:
        from ..ops.phong import Light

        light = Light(**lfields)
    params = FitParams(
        tf_colors=arrays["p.tf_colors"],
        density_scale=arrays["p.density_scale"],
        tf_lower=arrays.get("p.tf_lower"),
        tf_upper=arrays.get("p.tf_upper"),
        light=light,
    )
    if opt_state_like is None:
        return params
    treedef = jax.tree.structure(opt_state_like)
    n = len(jax.tree.leaves(opt_state_like))
    leaves = [arrays[f"o.{i}"] for i in range(n)]
    return params, jax.tree.unflatten(treedef, leaves)
