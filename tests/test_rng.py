"""RNG parity: vectorized jnp TEA/pcg4d vs the scalar oracle."""

import numpy as np
import jax.numpy as jnp

from computeraytracer.ops import rng
from computeraytracer.tracer import reference_cpu as oracle


def test_tea_matches_oracle():
    pairs = [(0, 0), (1, 2), (123, 456), (999983, 271828), (2**31, 2**32 - 1)]
    for a, b in pairs:
        got = int(rng.tea(jnp.uint32(a & 0xFFFFFFFF), jnp.uint32(b & 0xFFFFFFFF)))
        want = oracle.tea(a, b)
        assert got == want, (a, b, got, want)


def test_pcg4d_stream_matches_oracle():
    for px, py, sample in [(0, 0, 1), (17, 42, 3), (511, 1023, 7)]:
        o = oracle.Pcg4dRng(px, py, sample)
        seed = rng.seed_pixel(jnp.uint32(px), jnp.uint32(py), jnp.uint32(sample))
        assert [int(x) for x in np.asarray(seed)] == o.state
        for _ in range(32):
            want = float(o.rand())
            u, seed = rng.rand(seed)
            assert float(u) == want


def test_rand_masked_freezes_state():
    seed = rng.seed_pixel(jnp.uint32([3, 4]), jnp.uint32([5, 6]), jnp.uint32(1))
    mask = jnp.array([True, False])
    u, seed2 = rng.rand_masked(seed, mask)
    assert not np.array_equal(np.asarray(seed2[0]), np.asarray(seed[0]))
    assert np.array_equal(np.asarray(seed2[1]), np.asarray(seed[1]))
    assert float(u[1]) == 0.0


def test_uniform_range():
    seed = rng.seed_pixel(
        jnp.arange(128, dtype=jnp.uint32), jnp.arange(128, dtype=jnp.uint32),
        jnp.uint32(1))
    us = []
    for _ in range(20):
        u, seed = rng.rand(seed)
        us.append(np.asarray(u))
    us = np.concatenate(us)
    assert us.min() >= 0.0 and us.max() < 1.0
    assert abs(us.mean() - 0.5) < 0.02
