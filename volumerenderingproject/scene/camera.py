"""Orbit camera — state + derivations replicating the reference app.

The reference keeps the camera always looking at the origin and derives the
basis two slightly different ways:

  * initial construction (utils.h:41-46):
      front = normalize(-pos); right = normalize(cross(front, world_up));
      up = normalize(cross(right, front))
  * per-frame re-derivation after input (myApp.cu:1106-1112):
      front = normalize(-pos); right = normalize(cross(prev_up, front));
      up = cross(front, right)            # NOT normalized

Both are provided (:func:`Camera.initial` and :meth:`Camera.orbit` /
:meth:`Camera.rederive`).  ``top_left`` always uses the orthographic formula
(utils.h:68-70 — the conic variant was commented out, myApp.cu's
updateTopLeftCorner), even in conic mode; replicated on purpose.

The screen geometry (real_screen_width = 2*tan(view_angle), sample_distance =
(viewplane - front_clip)/spr, utils.h:53-74) lives in
:class:`~volumerenderingproject.utils.config.RenderConfig`; the camera
needs only the physical screen extents to place ``top_left``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..utils import transforms as T

_f32 = jnp.float32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera state pytree: position + orthonormal-ish basis + screen corner."""

    position: jnp.ndarray  # [3]
    front: jnp.ndarray  # [3]
    right: jnp.ndarray  # [3]
    up: jnp.ndarray  # [3]
    top_left: jnp.ndarray  # [3] top-left corner of the virtual screen

    @staticmethod
    def initial(
        position=(0.0, 0.0, 1.0),
        world_up=(0.0, 1.0, 0.0),
        screen_w: float = 2.0,
        screen_h: float = 2.0,
    ) -> "Camera":
        """AppData-construction-style derivation (utils.h:41-46,68-70)."""
        pos = jnp.asarray(position, _f32)
        front = T.normalize(-pos)
        right = T.normalize(T.cross(front, jnp.asarray(world_up, _f32)))
        up = T.normalize(T.cross(right, front))
        top_left = pos + (screen_w / 2.0) * (-right) + up * (screen_h / 2.0)
        return Camera(pos, front, right, up, top_left)

    def rederive(self, screen_w: float = 2.0, screen_h: float = 2.0) -> "Camera":
        """processInput-style re-derivation from position + previous up
        (myApp.cu:1106-1112)."""
        front = T.normalize(-self.position)
        right = T.normalize(T.cross(self.up, front))
        up = T.cross(front, right)
        top_left = (
            self.position + (screen_w / 2.0) * (-right) + up * (screen_h / 2.0)
        )
        return Camera(self.position, front, right, up, top_left)

    def orbit(
        self,
        yaw_rad=0.0,
        pitch_rad=0.0,
        zoom=0.0,
        screen_w: float = 2.0,
        screen_h: float = 2.0,
    ) -> "Camera":
        """WASD/QE orbit step (myApp.cu:1088-1112).

        Positive pitch = W (rotate about -right), positive yaw = A (rotate
        about up), positive zoom = Q (translate along front).
        """
        rot = T.identity()
        pitch = jnp.asarray(pitch_rad, _f32)
        yaw = jnp.asarray(yaw_rad, _f32)
        rot = T.matmul(T.rotate(rot, pitch, -self.right),
                       T.rotation(yaw, self.up))
        trans = T.translate(T.identity(), self.front * jnp.asarray(zoom, _f32))
        pos = T.apply(T.matmul(rot, trans), self.position)
        return dataclasses.replace(self, position=pos).rederive(screen_w, screen_h)

    def look_at_origin_view(self) -> jnp.ndarray:
        """glm::lookAt(position, origin, up) — POINT-mode view (myApp.cu:960)."""
        return T.look_at(self.position, jnp.zeros(3, _f32), self.up)


def save_preset(camera: Camera, path: str) -> None:
    """Persist a camera preset to JSON — the durable version of the
    reference's in-memory key-M save (myApp.cu:1160-1175)."""
    import json

    import numpy as np

    with open(path, "w") as f:
        json.dump(
            {
                k: np.asarray(getattr(camera, k)).tolist()
                for k in ("position", "front", "right", "up", "top_left")
            },
            f,
            indent=2,
        )


def load_preset(path: str) -> Camera:
    """Restore a camera preset saved by :func:`save_preset` (key X,
    myApp.cu:1178-1186)."""
    import json

    with open(path) as f:
        d = json.load(f)
    return Camera(
        position=jnp.asarray(d["position"], _f32),
        front=jnp.asarray(d["front"], _f32),
        right=jnp.asarray(d["right"], _f32),
        up=jnp.asarray(d["up"], _f32),
        top_left=jnp.asarray(d["top_left"], _f32),
    )


def reset_preset() -> Camera:
    """The saved oblique camera preset (utils.h:77-81) used by key X."""
    return Camera(
        position=jnp.asarray([0.456607, 0.693644, -0.55711], _f32),
        front=jnp.asarray([-0.456606, -0.693643, 0.557109], _f32),
        right=jnp.asarray([-0.19427, -0.533349, -0.823285], _f32),
        up=jnp.asarray([0.868199, -0.484147, 0.108777], _f32),
        top_left=jnp.asarray([1.51908, 0.742847, 0.374952], _f32),
    )


def default_camera() -> Camera:
    """Initial camera at (0,0,1) looking at the origin (utils.h:41-46)."""
    return Camera.initial()
