"""The kernel's counter-based generator (ssme_tpu/ops/_prng.py): the hash
is JAX's Threefry-2x32 bit for bit, the kernel draws exactly the
plain-jnp stream, and the normals and uniforms have the right moments."""

import jax
import jax.extend.random as jex_random
import jax.numpy as jnp
import numpy as np
import pytest

from ssme_tpu.ops import _prng
from ssme_tpu.ops.filter_megakernel import KernelModel, filter_megakernel


def test_threefry_matches_jax():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x0 = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    x1 = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    want = np.asarray(jex_random.threefry_2x32(jnp.asarray(key),
                                               jnp.concatenate([x0, x1])))
    got0, got1 = _prng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                    jnp.asarray(x0), jnp.asarray(x1))
    np.testing.assert_array_equal(np.concatenate([got0, got1]), want)


def test_counters_separate_steps_slots_and_lanes():
    k0, k1 = jnp.uint32(7), jnp.uint32(9)
    words = [np.asarray(_prng.draw_words(k0, k1, step, slot, (1, 256))[0])
             for step in (0, 1) for slot in (0, 1)]
    flat = np.concatenate([w.ravel() for w in words])
    assert len(np.unique(flat)) == flat.size
    # the row key changes every word
    other = np.asarray(_prng.draw_words(k0, k1 + 1, 0, 0, (1, 256))[0])
    assert not np.any(other == words[0])


def _plain(kind, b, n, seed=5):
    words = np.asarray(_prng.row_seeds(seed, b)).reshape(b, 2)
    rows = []
    for i in range(b):
        w0, w1 = _prng.draw_words(jnp.uint32(words[i, 0]),
                                  jnp.uint32(words[i, 1]), 0, 0, (1, n))
        rows.append(_prng.uniform_from_word(w0) if kind == "uniform"
                    else _prng.normal_from_words(w0, w1))
    return np.concatenate([np.asarray(r) for r in rows])


@pytest.mark.parametrize("kind", ["uniform", "normal"])
def test_kernel_stream_matches_plain_jnp(kind):
    """The interpreted kernel's time-1 draws (exported as the final cloud
    of a one-step filter) equal the plain-jnp generator bit for bit:
    same row keys, same (step, slot, lane) counters."""
    draw = (lambda rng, shape: rng.uniform(shape)) if kind == "uniform" \
        else (lambda rng, shape: rng.normal(shape))
    km = KernelModel(num_params=1,
                     init=lambda rng, p, y, z, shape: (draw(rng, shape),),
                     propagate=lambda rng, p, st, y, z: st,
                     log_weight=lambda p, st, y, z: jnp.zeros_like(st[0]),
                     name=f"{kind}_stream")
    b, n = 3, 128
    *_, cloud, _ = filter_megakernel(km, 5, jnp.zeros((b, 1)), jnp.zeros(1),
                                     num_particles=n, interpret=True,
                                     return_cloud=True)
    np.testing.assert_array_equal(np.asarray(cloud[0]), _plain(kind, b, n))


def test_uniform_moments():
    w = _prng.draw_words(jnp.uint32(1), jnp.uint32(2), 3, 0, (1, 1 << 16))[0]
    u = np.asarray(_prng.uniform_from_word(w), np.float64).ravel()
    assert u.min() > 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / u.size)
    assert abs(u.var() - 1 / 12) < 0.003
    # equal-width bins hold equal counts (chi-square, 16 bins)
    counts = np.histogram(u, bins=16, range=(0, 1))[0]
    expected = u.size / 16
    assert ((counts - expected) ** 2 / expected).sum() < 40.0


def test_normal_moments():
    w0, w1 = _prng.draw_words(jnp.uint32(3), jnp.uint32(4), 11, 2,
                              (1, 1 << 16))
    z = np.asarray(_prng.normal_from_words(w0, w1), np.float64).ravel()
    se = 1.0 / np.sqrt(z.size)
    assert abs(z.mean()) < 4 * se
    assert abs(z.var() - 1.0) < 4 * np.sqrt(2.0) * se
    assert abs(np.mean(z ** 3)) < 4 * np.sqrt(15.0) * se
    assert abs(np.mean(z ** 4) - 3.0) < 4 * np.sqrt(96.0) * se
    # tail mass beyond 2 sd matches the normal's 4.55%
    assert abs(np.mean(np.abs(z) > 2.0) - 0.0455) < 0.004
