import numpy as np
import jax.numpy as jnp

from volumerenderingproject.scene import (
    default_transfer_function,
    from_pairs,
    from_text,
    to_text,
)
from volumerenderingproject.scene.materials import MaterialId, get_material

from reference_impl import tf_scan


def _intervals(tf):
    return [
        (float(lo), float(hi), np.asarray(c, np.float32))
        for lo, hi, c in zip(
            np.asarray(tf.lower), np.asarray(tf.upper), np.asarray(tf.colors)
        )
    ]


def test_last_match_wins_vs_reference_scan():
    tf = default_transfer_function()
    ivals = _intervals(tf)
    values = np.concatenate(
        [
            np.linspace(-0.1, 1.1, 257, dtype=np.float32),
            # exact interval boundaries (inclusive on both sides)
            np.asarray(tf.lower),
            np.asarray(tf.upper),
        ]
    )
    got = np.asarray(tf.classify(jnp.asarray(values)))
    want = np.stack([tf_scan(ivals, np.float32(v)) for v in values])
    np.testing.assert_array_equal(got, want)


def test_classify_index_agrees_with_classify():
    tf = default_transfer_function()
    values = jnp.linspace(0.0, 1.0, 101)
    idx = np.asarray(tf.classify_index(values))
    colors = np.asarray(tf.colors)[idx]
    np.testing.assert_array_equal(colors, np.asarray(tf.classify(values)))


def test_out_of_range_falls_back_to_interval0():
    tf = default_transfer_function()
    got = np.asarray(tf.classify(jnp.asarray([-0.5, 1.5], jnp.float32)))
    want = np.asarray(tf.colors)[0]
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)


def test_known_materials():
    tf = default_transfer_function()
    bone = np.asarray(tf.classify(jnp.float32(50.0 / 255.0)))
    np.testing.assert_allclose(
        bone, get_material(MaterialId.bone).rgba, rtol=1e-6
    )
    brain = np.asarray(tf.classify(jnp.float32(110.0 / 255.0)))
    np.testing.assert_allclose(
        brain, get_material(MaterialId.brain).rgba, rtol=1e-6
    )
    empty = np.asarray(tf.classify(jnp.float32(0.01)))
    assert empty[3] == 0.0


def test_overlapping_interval_order_matters():
    # brain [105,120]/255 overlays the full-range empty interval
    tf = from_pairs(
        [
            (MaterialId.brain, 105 / 255.0, 120 / 255.0),
            (MaterialId.empty, 0.0, 1.0),
        ]
    )
    # empty is later, so it wins everywhere
    got = np.asarray(tf.classify(jnp.float32(110 / 255.0)))
    np.testing.assert_array_equal(got, get_material(MaterialId.empty).rgba)


def test_text_roundtrip():
    tf = default_transfer_function()
    text = to_text(tf, names=["empty", "bone", "muscle", "brain"])
    tf2 = from_text(text)
    np.testing.assert_allclose(np.asarray(tf.lower), np.asarray(tf2.lower))
    np.testing.assert_allclose(np.asarray(tf.upper), np.asarray(tf2.upper))
    np.testing.assert_allclose(np.asarray(tf.colors), np.asarray(tf2.colors))


def test_text_255_scale():
    tf = from_text("bone 30 80\n# comment\nmuscle 140 160\n")
    np.testing.assert_allclose(
        np.asarray(tf.lower), [30 / 255.0, 140 / 255.0], rtol=1e-6
    )


def test_lut_matches_classify():
    tf = default_transfer_function()
    lut = np.asarray(tf.to_lut(256))
    grid = jnp.linspace(0.0, 1.0, 256)
    np.testing.assert_array_equal(lut, np.asarray(tf.classify(grid)))


def test_gradient_wrt_colors():
    import jax

    tf = default_transfer_function()

    def loss(colors):
        tf2 = tf.__class__(tf.lower, tf.upper, colors, tf.hg_g)
        vals = jnp.linspace(0.0, 1.0, 64)
        return jnp.sum(tf2.classify(vals) ** 2)

    g = jax.grad(loss)(tf.colors)
    assert g.shape == tf.colors.shape
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).sum() > 0
