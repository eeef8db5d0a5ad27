"""On-device MT19937: the reference's RNG, vectorized in pure integer
ops.

core/parity.py's default stream source is host-side (numpy RandomState /
the native C++ generator).  This module computes the SAME bit-exact
streams on device — thousands of independent per-instance generators as a
[B, 624] uint32 state tensor — so parity-mode pipelines can run with no
host involvement at all:

* seeding is Knuth's init_genrand recurrence (what numpy's legacy
  RandomState uses for integer seeds), a 624-step `lax.scan` vectorized
  over instances;
* the twist is the 3-phase vectorized form (the last M entries of the
  in-place loop read already-updated words, so a single roll is NOT
  equivalent — phases split at the dependency boundaries);
* `random_sample` doubles are (a>>5)*2^26 + (b>>6) over 2^53; with no
  float64 arithmetic, the double's IEEE-754 BIT PATTERN is constructed
  directly with integer ops (bit-length via branchless binary search,
  exponent/mantissa assembly) as the (hi, lo) uint32 pair the parity
  kernel compares against.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

N = 624
M = 397
MATRIX_A = 0x9908B0DF
UPPER = 0x80000000
LOWER = 0x7FFFFFFF


def seed_states(seeds: jax.Array) -> jax.Array:
    """[B] uint32 seeds -> [B, 624] uint32 MT states (init_genrand)."""
    seeds = seeds.astype(jnp.uint32)

    def body(prev, i):
        nxt = jnp.uint32(1812433253) * (prev ^ (prev >> 30)) + i.astype(
            jnp.uint32)
        return nxt, nxt

    _, rest = jax.lax.scan(body, seeds, jnp.arange(1, N))
    return jnp.concatenate([seeds[None, :], rest], axis=0).T  # [B, 624]


def twist(mt: jax.Array) -> jax.Array:
    """One full twist of [B, 624] states, matching the in-place loop's
    read-after-write pattern exactly."""
    def mix(cur, nxt, src):
        y = (cur & jnp.uint32(UPPER)) | (nxt & jnp.uint32(LOWER))
        mag = jnp.where((y & 1) == 1, jnp.uint32(MATRIX_A), jnp.uint32(0))
        return src ^ (y >> 1) ^ mag

    # The in-place loop reads mt[(k+M) % N], which for k >= N-M is an
    # ALREADY-UPDATED word: new[k-(N-M)].  That dependency has lag
    # N-M = 227, so the 624 updates decompose into ceil(623/227)+1
    # vectorizable phases:
    K = N - M  # 227
    # phase 1: k in [0, K) — sources mt[k+M] are old words
    p1 = mix(mt[:, 0:K], mt[:, 1:K + 1], mt[:, M:N])
    # phase 2a: k in [K, 2K) — sources new[k-K] = p1
    p2a = mix(mt[:, K:2 * K], mt[:, K + 1:2 * K + 1], p1)
    # phase 2b: k in [2K, N-1) — sources new[k-K] are p2a outputs
    p2b = mix(mt[:, 2 * K:N - 1], mt[:, 2 * K + 1:N],
              p2a[:, 0:N - 1 - 2 * K])
    # phase 3: k = N-1 — neighbor is the NEW mt[0] (= p1[0]), source the
    # NEW mt[M-1] (= new[396] = p2a[396-K])
    p3 = mix(mt[:, N - 1:N], p1[:, 0:1], p2a[:, M - 1 - K:M - K])
    return jnp.concatenate([p1, p2a, p2b, p3], axis=1)


def temper(y: jax.Array) -> jax.Array:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & jnp.uint32(0x9D2C5680))
    y = y ^ ((y << 15) & jnp.uint32(0xEFC60000))
    return y ^ (y >> 18)


def _bit_length32(x: jax.Array) -> jax.Array:
    """Branchless bit length of uint32 (0 -> 0)."""
    n = jnp.zeros_like(x, jnp.int32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (jnp.uint32(1) << shift)
        n = n + jnp.where(big, shift, 0)
        x = jnp.where(big, x >> shift, x)
    return n + (x > 0).astype(jnp.int32)


def double_bits(a: jax.Array, b: jax.Array):
    """(hi, lo) uint32 bit-pattern words of (a*2^26 + b) / 2^53, where
    a < 2^27 (one word >> 5) and b < 2^26 (next word >> 6) — numpy's
    random_sample double construction — computed entirely in integer
    ops."""
    # 53-bit mantissa m = (a << 26) | b, split into 32-bit words
    m_hi = a >> 6                                   # (a << 26) >> 32
    m_lo = (a << 26) | b
    nbits = jnp.where(m_hi > 0, 32 + _bit_length32(m_hi),
                      _bit_length32(m_lo))
    zero = (m_hi == 0) & (m_lo == 0)

    # left-shift m by s = 53 - nbits so the leading bit lands at bit 52
    s = (53 - nbits).astype(jnp.uint32)
    # 64-bit left shift on the (hi, lo) pair; s in [0, 52]
    big = s >= 32
    s_lo = jnp.where(big, jnp.uint32(0), s)
    s_hi = jnp.where(big, s - 32, jnp.uint32(0))
    # first shift within-word amounts
    hi1 = jnp.where(
        s_lo > 0,
        (m_hi << s_lo) | (m_lo >> (jnp.uint32(32) - s_lo)),
        m_hi)
    lo1 = m_lo << s_lo
    # then whole-word shift if s >= 32
    hi2 = jnp.where(big, lo1 << s_hi, hi1)
    lo2 = jnp.where(big, jnp.uint32(0), lo1)

    # drop the implicit leading bit (bit 52 = bit 20 of hi word)
    frac_hi = hi2 & jnp.uint32(0x000FFFFF)
    exponent = (jnp.uint32(969) + nbits.astype(jnp.uint32))
    hi = jnp.where(zero, jnp.uint32(0), (exponent << 20) | frac_hi)
    lo = jnp.where(zero, jnp.uint32(0), lo2)
    return hi, lo


def device_streams(seeds: jax.Array, n_draws: int):
    """Per-instance uniform streams as (hi, lo) uint32 [B, n_draws] —
    bit-identical to host gen_streams / numpy RandomState, computed on
    device.  Each twist yields 312 doubles; blocks scan until n_draws."""
    mt = seed_states(jnp.asarray(seeds))
    n_blocks = -(-n_draws // (N // 2))

    def block(mt, _):
        mt = twist(mt)
        words = temper(mt)
        a = words[:, 0::2] >> 5
        b = words[:, 1::2] >> 6
        hi, lo = double_bits(a, b)
        return mt, (hi, lo)

    _, (hi, lo) = jax.lax.scan(block, mt, None, length=n_blocks)
    # [n_blocks, B, 312] -> [B, n_blocks*312] -> trim
    hi = jnp.moveaxis(hi, 0, 1).reshape(hi.shape[1], -1)[:, :n_draws]
    lo = jnp.moveaxis(lo, 0, 1).reshape(lo.shape[1], -1)[:, :n_draws]
    return hi, lo
