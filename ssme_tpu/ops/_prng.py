"""Counter-based random numbers for the whole-filter kernel.

A GPU kernel has no hardware generator, so every draw is a pure
function of a counter: Threefry-2x32 (20 rounds, the hash behind
``jax.random``'s default generator) of the 64-bit row key and the
counter ``(step, slot << 20 | lane)``.  ``slot`` numbers the draws a
filter makes within one time step, ``lane`` the particle.  The same
functions run inside the kernel and in plain ``jax.numpy``, which is
how the tests pin the kernel's stream bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TWO_PI = 6.283185307179586
HALF_LOG_2PI = 0.9189385332046727
_INV_2_24 = 1.0 / 16777216.0

# counter layout: 20 bits of lane, the rest of the word for the slot
LANE_BITS = 20
MAX_SLOTS = 1 << (32 - LANE_BITS)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (broadcasting).

    Same function as ``jax.random``'s ``threefry_2x32`` hash, written in
    shifts, xors and wrapping adds only, so it lowers inside a kernel."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def draw_words(k0, k1, step, slot: int, shape):
    """Two uint32 words per element of ``shape`` for draw ``slot`` of
    time step ``step``; the last axis of ``shape`` is the lane."""
    lane = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1)
    x0 = jnp.asarray(step).astype(jnp.uint32)
    x1 = lane + np.uint32(slot << LANE_BITS)
    return threefry2x32(k0, k1, x0, x1)


def uniform_from_word(w):
    """U(0, 1), both ends open: the top 24 bits, centred in their cell."""
    top = (w >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32)
    return (top + 0.5) * _INV_2_24


def normal_from_words(w0, w1):
    """One standard normal per element by Box-Muller (cosine branch)."""
    u1 = uniform_from_word(w0)
    u2 = uniform_from_word(w1)
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(TWO_PI * u2)


def row_seeds(seed, num_rows: int):
    """Per-row key words threefry-derived from a scalar seed or a
    ``jax.random`` key: shape ``(2 * num_rows,)`` uint32, row ``b``
    owning words ``2b`` and ``2b + 1``.

    Each filter row gets a 64-bit key.  With one 31-bit word, two of a
    PMMH chain's 1e4 iterations would reuse a stream with birthday
    probability ~2%; with 64 bits it is ~1e-12.  Deriving through
    ``jax.random`` keeps rows' streams decorrelated, which PMMH's
    replicate averaging (``thread_pool.h:259-273``) assumes.

    ``seed`` may be an integer (tests, standalone filters) or a typed
    ``jax.random`` key (the PMMH hooks pass their iteration key
    straight through, keeping its full entropy).
    """
    if isinstance(seed, jax.Array) and jnp.issubdtype(
            seed.dtype, jax.dtypes.prng_key):
        key = seed
    else:
        key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return jax.random.bits(key, (2 * num_rows,), jnp.uint32)


__all__ = ["threefry2x32", "draw_words", "uniform_from_word",
           "normal_from_words", "row_seeds", "HALF_LOG_2PI", "MAX_SLOTS"]
