"""Slow, loop-based Python mirror of the reference CUDA math, for tests only.

This is an independent re-implementation of the semantics documented in
SURVEY.md (octree build/query, TF scan, a1/a5 sample math, over-blend) using
float32 numpy scalars, used as the oracle that the vectorized framework
must match.  Deliberately structured like the CUDA code (recursion, per-pixel
loops) and deliberately tiny-workload-only.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


# ---------------------------------------------------------------------------
# Array octree (Octree.cu)
# ---------------------------------------------------------------------------


class PyOctree:
    """Faithful port of the complete array octree (Octree.cu:30-156)."""

    def __init__(self, volume: np.ndarray):
        assert volume.ndim == 3
        self.vol = volume.astype(f32)
        self.dims = volume.shape
        self.L = max(self.dims)
        d = 0
        while 2**d < self.L:
            d += 1
        self.depth = d
        n_nodes = sum(8**p for p in range(d + 1))
        # node: (depth, max, min, lower[3], upper[3])
        self.node_depth = np.zeros(n_nodes, np.int32)
        self.node_max = np.zeros(n_nodes, f32)
        self.node_min = np.zeros(n_nodes, f32)
        self.node_lo = np.zeros((n_nodes, 3), f32)
        self.node_hi = np.zeros((n_nodes, 3), f32)
        self._create(0, 0, np.zeros(3, f32), np.ones(3, f32))
        self._update(0)

    def _is_leaf(self, idx):
        return self.node_depth[idx] == self.depth

    def _create(self, index, depth, lower, upper):
        self.node_depth[index] = depth
        self.node_lo[index] = lower
        self.node_hi[index] = upper
        if depth == self.depth:
            return
        dist = (upper - lower).astype(f32)
        for x in range(2):
            for y in range(2):
                for z in range(2):
                    child_number = x * 4 + y * 2 + z + 1
                    child_index = 8 * index + child_number
                    # NB: reference reuses dist.y for z (Octree.cu:145,150);
                    # harmless for the cubic domain but replicated anyway.
                    c_lo = lower + np.array(
                        [x * dist[0] / 2, y * dist[1] / 2, z * dist[1] / 2], f32
                    )
                    c_hi = c_lo + np.array(
                        [dist[0] / 2, dist[1] / 2, dist[1] / 2], f32
                    )
                    self._create(child_index, depth + 1, c_lo.astype(f32), c_hi.astype(f32))

    def _update(self, index):
        if self._is_leaf(index):
            L = f32(self.L)
            res = (self.node_lo[index] * L).astype(f32)  # scale matrix
            d1, d2, d3 = self.dims
            ok = (
                res[0] >= f32(L / 2.0) - f32(d1 / 2.0)
                and res[0] < f32(L / 2.0) + f32(d1 / 2.0)
                and res[1] >= f32(L / 2.0) - f32(d2 / 2.0)
                and res[1] < f32(L / 2.0) + f32(d2 / 2.0)
                and res[2] >= f32(L / 2.0) - f32(d3 / 2.0)
                and res[2] < f32(L / 2.0) + f32(d3 / 2.0)
            )
            if ok:
                ix = int(f32(res[0] + f32(d1 / 2.0)) - f32(L / 2.0))
                iy = int(f32(res[1] + f32(d2 / 2.0)) - f32(L / 2.0))
                iz = int(f32(res[2] + f32(d3 / 2.0)) - f32(L / 2.0))
                v = self.vol[ix, iy, iz]
                self.node_max[index] = v
                self.node_min[index] = v
            else:
                self.node_max[index] = f32(0.0)
                self.node_min[index] = f32(0.0)
        else:
            for c in range(1, 9):
                self._update(8 * index + c)
            # min/max start at the createNode 0.0 fill (Octree.cu:133)
            for c in range(1, 9):
                ci = 8 * index + c
                if self.node_max[index] < self.node_max[ci]:
                    self.node_max[index] = self.node_max[ci]
                if self.node_min[index] > self.node_min[ci]:
                    self.node_min[index] = self.node_min[ci]

    def _inside(self, index, p):
        lo, hi = self.node_lo[index], self.node_hi[index]
        return bool(np.all(p >= lo) and np.all(p < hi))

    def get_intensity(self, p) -> f32:
        return self._search(0, np.asarray(p, f32))

    def _search(self, index, p) -> f32:
        res = f32(0.0)
        if self._inside(index, p):
            if self.node_max[index] == self.node_min[index]:
                res = self.node_max[index]
            else:
                for c in range(1, 9):
                    aux = self._search(index * 8 + c, p)
                    if aux > res:
                        res = aux
        return res


# ---------------------------------------------------------------------------
# Transfer function (TransferFunction.cu:46-55)
# ---------------------------------------------------------------------------


def tf_scan(intervals, value):
    """intervals: list of (lower, upper, rgba).  Last match wins
    (TransferFunction.cu:46-55)."""
    result = np.asarray(intervals[0][2], f32)
    for lo, hi, rgba in intervals:
        if value >= f32(lo) and value <= f32(hi):
            result = np.asarray(rgba, f32)
    return result


# ---------------------------------------------------------------------------
# a1 / VRC render (kernel.cu:20-70, 194-225)
# ---------------------------------------------------------------------------


def py_render_vrc(vol, intervals, cal_max, cam, cfg) -> np.ndarray:
    """cam: dict(position, front, right, up, top_left) numpy f32.
    cfg: dict(width, height, spr, sample_distance, front_clip,
    real_screen_width, real_screen_height, background, conic)."""
    W, H, S = cfg["width"], cfg["height"], cfg["spr"]
    octree = PyOctree(vol)
    w = f32(cfg["real_screen_width"])
    h = f32(cfg["real_screen_height"])
    ds = f32(cfg["sample_distance"])
    clip = f32(cfg["front_clip"])
    bg = np.asarray(cfg["background"], f32)
    img = np.zeros((W, H, 4), f32)

    for x in range(W):
        for y in range(H):
            if cfg["conic"]:
                d = (
                    cam["top_left"]
                    + f32(f32(x * w) / W) * cam["right"]
                    + f32(f32(y * h) / H) * (-cam["up"])
                    - cam["position"]
                )
                d = (d / f32(np.sqrt(np.dot(d, d)))).astype(f32)
            else:
                d = cam["front"]
            frag = bg[:3].copy()
            for i in range(S - 1, -1, -1):
                t = f32(f32(i) * ds + clip)
                if cfg["conic"]:
                    pos = (cam["position"] + t * d).astype(f32)
                else:
                    xt = f32(f32(x * w) / W) * cam["right"]
                    yt = f32(f32(y * h) / H) * (-cam["up"])
                    pos = (((cam["top_left"] + xt) + yt) + t * d).astype(f32)
                p = (pos + f32(0.5)).astype(f32)  # modelAux
                v = octree.get_intensity(p)
                # the CUDA a1 kernel receives cal_max as `int max_intensity`
                # (kernel.cu:42), truncating the header double
                ni = f32(v / f32(int(cal_max)))
                rgba = tf_scan(intervals, ni)
                a = rgba[3]
                frag = (frag * (f32(1.0) - a) + rgba[:3] * a).astype(f32)
            img[x, y, :3] = frag
            img[x, y, 3] = 1.0
    return img


# ---------------------------------------------------------------------------
# a5 / TEST render (kernel.cu:72-187, 1164-1259)
# ---------------------------------------------------------------------------


def _glm_translate(v):
    m = np.eye(4, dtype=f32)
    m[:3, 3] = v
    return m


def _glm_scale(v):
    m = np.eye(4, dtype=f32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def _glm_look_at(eye, center, up):
    eye = np.asarray(eye, f32)
    fwd = center - eye
    fwd = (fwd / f32(np.sqrt(np.dot(fwd, fwd)))).astype(f32)
    s = np.cross(fwd, up).astype(f32)
    s = (s / f32(np.sqrt(np.dot(s, s)))).astype(f32)
    u = np.cross(s, fwd).astype(f32)
    m = np.eye(4, dtype=f32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -fwd
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(fwd, eye)
    return m


def py_render_test(vol, intervals, cal_max, cam, cfg) -> np.ndarray:
    W, H, S = cfg["width"], cfg["height"], cfg["spr"]
    d1, d2, d3 = vol.shape
    total = d1 * d2 * d3
    vol_flat = vol.astype(f32).reshape(-1)
    L = max(vol.shape)
    w = f32(cfg["real_screen_width"])
    h = f32(cfg["real_screen_height"])
    bg = np.asarray(cfg["background"], f32)

    model_cam = _glm_translate([-w / 2, -h / 2, 0.0]) @ _glm_scale(
        [w / W, h / H, -f32(cfg["viewplane_distance"]) / S]
    )
    view = _glm_look_at(cam["position"], np.zeros(3, f32), cam["up"])
    inv_view = np.linalg.inv(view.astype(np.float64)).astype(f32)
    to_vol = (
        _glm_translate([d1 / 2.0 - L / 2.0, d2 / 2.0 - L / 2.0, d3 / 2.0 - L / 2.0])
        @ _glm_scale([L, L, L])
        @ _glm_translate([0.5, 0.5, 0.5])
    )

    def fetch(posq):
        ix, iy, iz = int(posq[0]), int(posq[1]), int(posq[2])
        flat = ix * d2 * d3 + iy * d3 + iz
        return vol_flat[flat] if flat < total else f32(0.0)

    img = np.zeros((W, H, 4), f32)
    offsets = [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
        (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
    ]
    for x in range(W):
        for y in range(H):
            frag = bg[:3].copy()
            for i in range(S - 1, -1, -1):
                g = np.array([x, y, i, 1.0], f32)
                p = (model_cam @ g).astype(f32)
                p = (inv_view @ np.array([p[0], p[1], p[2], 1.0], f32)).astype(f32)
                p = (to_vol @ np.array([p[0], p[1], p[2], 1.0], f32)).astype(f32)
                pos = p[:3]
                inside = bool(
                    np.all(pos >= 0)
                    and pos[0] < d1
                    and pos[1] < d2
                    and pos[2] < d3
                )
                if inside:
                    frac = (pos - np.trunc(pos)).astype(f32)
                    cols = []
                    for off in offsets:
                        q = (pos + np.asarray(off, f32)).astype(f32)
                        iv = fetch(q)
                        cols.append(tf_scan(intervals, f32(iv / f32(cal_max))))
                    c = cols
                    fy, fx, fz = frac[1], frac[0], frac[2]
                    cy1 = c[0] * (1 - fy) + c[2] * fy
                    cy2 = c[1] * (1 - fy) + c[3] * fy
                    cy3 = c[4] * (1 - fy) + c[6] * fy
                    cy4 = c[5] * (1 - fy) + c[7] * fy
                    cz1 = cy1 * (1 - fx) + cy3 * fx
                    cz2 = cy2 * (1 - fx) + cy4 * fx
                    rgba = (cz1 * (1 - fz) + cz2 * fz).astype(f32)
                else:
                    rgba = tf_scan(intervals, f32(0.0))
                a = rgba[3]
                frag = (frag * (f32(1.0) - a) + rgba[:3] * a).astype(f32)
            img[x, y, :3] = frag
            img[x, y, 3] = 1.0
    return img
