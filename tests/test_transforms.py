import numpy as np
import jax.numpy as jnp

from volumerenderingproject.utils import transforms as T


def test_translate_scale_compose_order():
    # glm chain: m = translate(I, t); m = scale(m, s)  => applies scale first
    m = T.scale(T.translate(T.identity(), (1.0, 2.0, 3.0)), (2.0, 2.0, 2.0))
    p = T.apply(m, (1.0, 1.0, 1.0))
    np.testing.assert_allclose(np.asarray(p), [3.0, 4.0, 5.0], rtol=1e-6)


def test_look_at_matches_manual():
    eye = np.array([0.3, -0.2, 1.1], np.float32)
    center = np.zeros(3, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    m = np.asarray(T.look_at(eye, center, up))
    # eye maps to origin, center maps to (0, 0, -|eye-center|)
    def ap(mat, p):
        return (mat @ np.append(p, 1.0))[:3]

    np.testing.assert_allclose(ap(m, eye), 0.0, atol=1e-6)
    c = ap(m, center)
    np.testing.assert_allclose(c[:2], 0.0, atol=1e-6)
    assert c[2] < 0


def test_inverse_roundtrip():
    m = T.rotate(T.translate(T.identity(), (0.1, 0.2, 0.3)), 0.7, (1.0, 2.0, 0.5))
    mi = T.inverse(m)
    np.testing.assert_allclose(np.asarray(m @ mi), np.eye(4), atol=1e-5)


def test_ortho_matches_glm():
    m = np.asarray(T.ortho(-1.0, 1.0, -1.0, 1.0, -1.5, 1.5))
    p = (m @ np.array([0.5, -0.25, 1.5, 1.0], np.float32))[:3]
    np.testing.assert_allclose(p, [0.5, -0.25, -1.0], atol=1e-6)


def test_rotation_orthonormal():
    r = np.asarray(T.rotation(1.234, (0.3, -0.5, 0.81)))[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)


def test_apply_batched():
    m = T.translate(T.identity(), (1.0, 0.0, 0.0))
    pts = jnp.zeros((4, 5, 3))
    out = T.apply(m, pts)
    assert out.shape == (4, 5, 3)
    np.testing.assert_allclose(np.asarray(out[..., 0]), 1.0)


def test_display_roundtrip():
    import numpy as np

    from volumerenderingproject.utils import imageio
    from volumerenderingproject.utils.config import Algorithm

    img = np.random.default_rng(0).uniform(0, 1, (12, 8, 3)).astype(np.float32)
    for alg in (Algorithm.VRC, Algorithm.TEST):
        disp = imageio.to_display(img, alg)
        assert disp.shape == (8, 12, 3)
        back = imageio.from_display(disp, alg)
        np.testing.assert_array_equal(back, img)
