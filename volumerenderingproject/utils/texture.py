"""Render-to-texture / textured-quad display.

The reference scaffolds an offscreen render-to-texture path
(``rendering_to_a_texture`` myApp.cu:1732-1901: FBO + color texture + a
fullscreen quad drawn with 3.3.texture_shader.*) but never finished it —
the fragment shader ships as a stub (solid blue).  This module completes
the capability the scaffold was for, array-style: render the scene at an
offscreen resolution, then display it through a textured fullscreen quad —
i.e. GL_LINEAR-style bilinear texture sampling at the window's pixel
centers.  The standard use is decoupling render resolution from display
resolution (fast low-res preview upscaled to the window, or supersampled
downscale), which the HTTP viewer and CLI expose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_f32 = jnp.float32


def sample_bilinear(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray
                    ) -> jnp.ndarray:
    """GL_LINEAR + CLAMP_TO_EDGE texture fetch.

    ``tex``: [W, H, C] canonical image (x = column, y = row from top);
    ``u``/``v``: texture coordinates in [0, 1] (any broadcastable shape),
    u along W, v along H.  Texel centers sit at (i + 0.5) / size, exactly
    GL's convention.
    """
    w, h = tex.shape[0], tex.shape[1]
    # clamp-to-edge BEFORE the floor so out-of-range coords weight the
    # edge texel fully
    x = jnp.clip(u * w - 0.5, 0.0, w - 1.0)
    y = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    t00 = tex[x0i, y0i]
    t10 = tex[x1i, y0i]
    t01 = tex[x0i, y1i]
    t11 = tex[x1i, y1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def texture_quad_display(img: jnp.ndarray, out_w: int, out_h: int
                         ) -> jnp.ndarray:
    """Draw ``img`` [W, H, C] on a fullscreen quad of ``out_w`` x ``out_h``
    window pixels (UVs 0..1 across the quad, sampled at pixel centers) ->
    [out_w, out_h, C]."""
    u = (jax.lax.broadcasted_iota(_f32, (out_w, out_h), 0) + 0.5) / out_w
    v = (jax.lax.broadcasted_iota(_f32, (out_w, out_h), 1) + 0.5) / out_h
    return sample_bilinear(jnp.asarray(img, _f32), u, v)


def stub_blue(out_w: int, out_h: int) -> jnp.ndarray:
    """The reference texture shader's actual shipped behavior — a solid
    blue quad (3.3.texture_shader.fs stub).  Kept for parity/testing."""
    img = jnp.zeros((out_w, out_h, 4), _f32)
    return img.at[..., 2].set(1.0).at[..., 3].set(1.0)
