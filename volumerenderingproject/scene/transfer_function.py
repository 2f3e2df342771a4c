"""Transfer function: piecewise-constant intensity → RGBA classification.

Replicates ``TransferFunction::getMaterial`` (TransferFunction.cu:46-55)
semantics exactly as a vectorized, differentiable table lookup:

  * a linear scan over intervals with *inclusive* bounds,
  * the LAST matching interval wins,
  * no match falls back to interval 0's material.

The interval table is a pytree of jnp arrays, so its colors (and optionally
bounds) are first-class differentiable parameters — the "fit" path optimizes
them (diff/fit.py).  A dense-LUT compilation is provided for the fast render
path; it is exactly equivalent on the LUT's sample grid.

The text format sketched by the reference but never implemented
(TransferFunction.txt:1-6 "NOT USED YET") is finished here:
``name lower upper`` per line, '#' comments, resolved via the materials
registry.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .materials import MaterialId, get_material


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransferFunction:
    """Interval table.

    Attributes:
      lower: [K] inclusive lower bounds (normalized intensity).
      upper: [K] inclusive upper bounds.
      colors: [K, 4] RGBA per interval.
      hg_g: [K] Henyey-Greenstein anisotropy per interval (reference stores
        this on Material, always 0; Material.h:14-23).
    """

    lower: jnp.ndarray
    upper: jnp.ndarray
    colors: jnp.ndarray
    hg_g: jnp.ndarray

    @property
    def num_intervals(self) -> int:
        return self.lower.shape[0]

    def classify_index(self, value: jnp.ndarray) -> jnp.ndarray:
        """Index of the winning interval for each value (last match wins)."""
        v = value[..., None]
        match = (v >= self.lower) & (v <= self.upper)  # [..., K]
        rev = match[..., ::-1]
        any_match = jnp.any(match, axis=-1)
        first_rev = jnp.argmax(rev, axis=-1)
        k = self.num_intervals
        idx = jnp.where(any_match, (k - 1) - first_rev, 0)
        return idx

    def classify(self, value: jnp.ndarray) -> jnp.ndarray:
        """RGBA for normalized intensity values, shape value.shape + (4,).

        Differentiable w.r.t. ``colors`` (piecewise-constant in ``value``, so
        d/d value is 0 a.e. — matching the reference's semantics).  Implemented
        as a sum of interval indicators rather than a gather so the backward
        pass is a plain (segment-)sum.
        """
        v = value[..., None]
        match = (v >= self.lower) & (v <= self.upper)  # [..., K]
        # last-match-wins == highest matching index: keep a match only if no
        # higher interval matches.
        later = jnp.cumsum(match[..., ::-1], axis=-1)[..., ::-1]
        wins = match & (later == 1)  # exactly the last matching interval
        none = ~jnp.any(match, axis=-1, keepdims=True)
        weights = wins.astype(self.colors.dtype)
        weights = weights.at[..., 0].add(none[..., 0].astype(self.colors.dtype))
        # full-precision product: a GPU's default float32 matmul may run in
        # TF32 and round every rendered color to ~3 decimal digits (see
        # utils/transforms._HI)
        return jnp.matmul(weights, self.colors,
                          precision=jax.lax.Precision.HIGHEST)

    def classify_smooth(
        self, value: jnp.ndarray, sharpness: float = 200.0
    ) -> jnp.ndarray:
        """Smooth (C^inf) relaxation of :meth:`classify` for gradient-based
        optimization of densities/volumes (no reference counterpart — the
        reference TF is piecewise-constant with zero intensity gradient).

        Interval 0 acts as the base layer (the reference's fallback
        material); each later interval overlays it with a soft membership
        ``sigmoid(s*(v-lo)) * sigmoid(s*(hi-v))``.  For disjoint overlay
        intervals (the default table), sharpness -> inf recovers the exact
        last-match-wins output.
        """
        s = jnp.asarray(sharpness, jnp.float32)
        v = value[..., None]
        w = jax.nn.sigmoid(s * (v - self.lower[1:])) * jax.nn.sigmoid(
            s * (self.upper[1:] - v)
        )  # [..., K-1]
        base = self.colors[0]
        return base + jnp.matmul(w, self.colors[1:] - base,
                                 precision=jax.lax.Precision.HIGHEST)

    def to_lut(self, resolution: int = 256) -> jnp.ndarray:
        """Dense RGBA LUT over [0, 1] (interval semantics at bin centers?

        No — at bin *lower edges* i/(resolution-1), matching how a LUT render
        path quantizes ``value`` with round-to-nearest).  Shape [R, 4].
        """
        grid = jnp.linspace(0.0, 1.0, resolution, dtype=jnp.float32)
        return self.classify(grid)


def from_pairs(
    pairs: Sequence[Tuple[MaterialId | int | str, float, float]]
) -> TransferFunction:
    """Build from (material, lower, upper) triples (cf. TransferFunction.cu:19-23)."""
    lowers, uppers, colors, gs = [], [], [], []
    for mid, lo, hi in pairs:
        m = get_material(mid)
        lowers.append(np.float32(lo))
        uppers.append(np.float32(hi))
        colors.append(np.asarray(m.rgba, np.float32))
        gs.append(np.float32(m.hg_g))
    return TransferFunction(
        lower=jnp.asarray(lowers, jnp.float32),
        upper=jnp.asarray(uppers, jnp.float32),
        colors=jnp.asarray(np.stack(colors), jnp.float32),
        hg_g=jnp.asarray(gs, jnp.float32),
    )


def default_transfer_function() -> TransferFunction:
    """The reference's hardcoded table (TransferFunction.cu:19-23)."""
    return from_pairs(
        [
            (MaterialId.empty, 0.0, 1.0),
            (MaterialId.bone, 30.0 / 255.0, 80.0 / 255.0),
            (MaterialId.muscle, 140.0 / 255.0, 160.0 / 255.0),
            (MaterialId.brain, 105.0 / 255.0, 120.0 / 255.0),
        ]
    )


def from_text(text: str) -> TransferFunction:
    """Parse the (now implemented) TransferFunction.txt format.

    One interval per line, either

      ``<material-name> <lower> <upper>``                (registry colors)
      ``<name> <lower> <upper> <r> <g> <b> <a> [<hg_g>]``  (explicit colors)

    '#' comments and blank lines ignored.  Bounds may be given in [0,1] or
    [0,255] (values > 1 are divided by 255, matching the file's
    ``30 80``-style sketch).  The explicit-color form is what
    :func:`to_text` emits, so fitted transfer functions round-trip.
    """
    lowers, uppers, colors, gs = [], [], [], []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) not in (3, 7, 8):
            raise ValueError(f"bad transfer-function line: {line!r}")
        name = parts[0]
        lo, hi = float(parts[1]), float(parts[2])
        if lo > 1.0 or hi > 1.0:
            lo, hi = lo / 255.0, hi / 255.0
        if len(parts) >= 7:
            rgba = np.asarray([float(v) for v in parts[3:7]], np.float32)
            g = float(parts[7]) if len(parts) == 8 else 0.0
        else:
            m = get_material(name)
            rgba = np.asarray(m.rgba, np.float32)
            g = m.hg_g
        lowers.append(np.float32(lo))
        uppers.append(np.float32(hi))
        colors.append(rgba)
        gs.append(np.float32(g))
    if not lowers:
        raise ValueError("empty transfer function")
    return TransferFunction(
        lower=jnp.asarray(lowers, jnp.float32),
        upper=jnp.asarray(uppers, jnp.float32),
        colors=jnp.asarray(np.stack(colors), jnp.float32),
        hg_g=jnp.asarray(gs, jnp.float32),
    )


def to_text(tf: TransferFunction, names: Sequence[str] | None = None) -> str:
    """Serialize to the explicit-color text format (round-trips colors)."""
    lines = ["# volumerenderingproject transfer function",
             "# name lower upper r g b a hg_g"]
    lo = np.asarray(tf.lower)
    hi = np.asarray(tf.upper)
    cols = np.asarray(tf.colors)
    gs = np.asarray(tf.hg_g)
    for i in range(tf.num_intervals):
        name = names[i] if names else f"interval_{i}"
        c = " ".join(f"{float(v):.9g}" for v in cols[i])
        lines.append(
            f"{name} {float(lo[i]):.9g} {float(hi[i]):.9g} {c} {float(gs[i]):.9g}"
        )
    return "\n".join(lines) + "\n"
