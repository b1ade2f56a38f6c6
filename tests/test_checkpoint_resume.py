"""Checkpoint/resume + golden regression (SURVEY.md §5).

The reference's only resumable state is (accumulator, sample counter) —
never persisted; reload restarts from sample 0 (main.js:298-311). Here
resume must be exact: counter-based RNG makes sample k's contribution a
pure function of k, so accumulation splits associatively and repeated
renders are bit-identical.
"""

import numpy as np
import pytest

from computeraytracer.tracer import xla as xla_tracer


def test_progressive_resume_is_exact(cornell_scene):
    w = h = 12
    full = np.asarray(xla_tracer.render_accumulate(
        cornell_scene, w, h, spp=4, max_depth=3))
    part1 = np.asarray(xla_tracer.render_accumulate(
        cornell_scene, w, h, spp=2, max_depth=3))
    part2 = np.asarray(xla_tracer.render_accumulate(
        cornell_scene, w, h, spp=2, max_depth=3, first_sample=3))
    np.testing.assert_allclose(part1 + part2, full, rtol=2e-7, atol=1e-7)


def test_repeated_render_bit_exact(cornell_scene):
    w = h = 12
    a = np.asarray(xla_tracer.render_accumulate(cornell_scene, w, h, 2,
                                                max_depth=3))
    b = np.asarray(xla_tracer.render_accumulate(cornell_scene, w, h, 2,
                                                max_depth=3))
    np.testing.assert_array_equal(a, b)


def test_render_state_roundtrip(tmp_path, cornell_scene):
    from computeraytracer.train import checkpoint as ckpt

    w = h = 8
    accum = np.asarray(xla_tracer.render_accumulate(
        cornell_scene, w, h, 3, max_depth=2))
    ckpt.save_render_state(str(tmp_path), accum, sample_count=3)
    back, count = ckpt.load_render_state(str(tmp_path), np.zeros_like(accum))
    assert count == 3
    np.testing.assert_array_equal(np.asarray(back), accum)


def test_optimizer_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    import optax

    from computeraytracer.train import checkpoint as ckpt

    params = {"spectra": jnp.arange(12.0).reshape(3, 4)}
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(5, params, opt_state)
    c.save(9, params, opt_state)
    assert c.latest_step() == 9
    restored = c.restore_latest(params, opt_state)
    assert restored is not None
    r_params, r_opt, step = restored
    assert step == 9
    np.testing.assert_array_equal(np.asarray(r_params["spectra"]),
                                  np.asarray(params["spectra"]))


def test_checkpoint_refuses_other_layout(tmp_path):
    """A checkpoint of another geometry layout version (or none) is
    refused, never reinterpreted."""
    import jax.numpy as jnp

    from computeraytracer.train import checkpoint as ckpt

    params = {"data2": jnp.ones((4, 3))}
    c = ckpt.Checkpointer(str(tmp_path))
    c.save(1, params)
    path = tmp_path / "step_00000001.npz"
    with np.load(path) as z:
        arrays = dict(z)
    for bad in ({**arrays, "layout_version": np.int64(1)},
                {k: v for k, v in arrays.items() if k != "layout_version"}):
        with open(path, "wb") as f:
            np.savez(f, **bad)
        with pytest.raises(ValueError, match="layout"):
            c.restore(1, params)


def test_checkpoint_refuses_mismatched_template(tmp_path):
    import jax.numpy as jnp

    from computeraytracer.train import checkpoint as ckpt

    c = ckpt.Checkpointer(str(tmp_path))
    c.save(3, {"a": jnp.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        c.restore(3, {"a": jnp.zeros(2), "b": jnp.zeros(2)})


# Golden regression: Cornell 8x8, sample 1, depth 3 on the CPU test
# platform. Catches silent estimator drift (RNG order, MIS weights,
# material branches). Regenerate deliberately if the estimator changes.
_GOLDEN = {
    "sum": 10.487754821777344,
    (2, 3): [0.10122361779212952, 0.10102009028196335, 7.20952739357017e-05],
    (6, 1): [0.17419582605361938, 0.09720221906900406,
             4.909306881017983e-06],
    (7, 7): [0.08959296345710754, 0.06201157718896866,
             9.300700185121968e-06],
    (0, 0): [0.0, 0.0, 0.0],
}


def test_golden_cornell_regression(cornell_scene):
    img = np.asarray(xla_tracer.render_sample(cornell_scene, 8, 8, 1,
                                              max_depth=3))
    assert img.sum() == pytest.approx(_GOLDEN["sum"], rel=1e-5)
    for key, want in _GOLDEN.items():
        if not isinstance(key, tuple):
            continue
        np.testing.assert_allclose(img[key], want, rtol=1e-5, atol=1e-7)
