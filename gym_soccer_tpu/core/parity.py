"""Reference-RNG parity backend: bit-exact batched reproduction of the
reference environment's trajectories (BASELINE.json north star).

The reference consumes exactly one MT19937 double per reset and per step
(soccer_simultaneous_env.py:395, :414 via gym's categorical_sample), and
selects the first transition whose float64 cumulative sum exceeds it
(SURVEY.md §0.4).  This module reproduces that **per batched instance**:

* per-instance uniform streams generated host-side with numpy's
  ``RandomState(seed_i)`` — the exact generator the reference uses;
* float64 cumulative-sum thresholds precomputed on host from the padded
  transition tensors (bit-identical to the reference's, see core/tables);
* the threshold comparison done in pure integer ops: non-negative IEEE-754
  doubles order identically to their 64-bit patterns, so ``cum > u`` is a
  lexicographic (hi, lo) uint32 compare.  **No float64 arithmetic
  needed** — the same code is exact on any device
  (SURVEY.md §7.3.1 option ii).

A "parity step" mirrors the reference driver loop per instance: if the env
finished last step, consume one reset draw (ISD categorical), then consume
one transition draw — so draw order matches the reference's
reset/step/step/... sequence exactly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, N_ACTIONS, MAX_TRANSITIONS
from . import tables


def f64_bits(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split float64 array into (hi, lo) uint32 bit-pattern words."""
    bits = np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)
    return (bits >> np.uint64(32)).astype(np.uint32), \
        (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _le_bits(hi_a, lo_a, hi_b, lo_b):
    """a <= b for non-negative doubles given (hi, lo) uint32 words."""
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a <= lo_b))


class ParityTables(NamedTuple):
    """Host-side (numpy) arrays; inlined as constants under jit.

    The per-slot data is PACKED into two tensors so a parity step costs 3
    device gathers instead of 8:

    * ``cum_pair`` [nS, R, 36, 2]: float64 cumulative-sum thresholds as
      (hi, lo) uint32 bit-pattern words, fetched by (state, row);
    * ``meta`` [nS, R, 36, 4] int32: (next_raw, done, reward f32 bits,
      prob f32 bits), fetched at the selected slot.

    The reference's argmax-over-empty fallback slot is NOT stored: the
    first in-list slot equals the count of zero cumulative sums (cum is
    nondecreasing from 0 and every padding slot before the first real
    entry carries probability 0), so it is recomputed from cum_pair.
    """
    nS: int
    n_rows: int                # 25 joint (multiagent) or 5 (single-agent)
    raw_to_dense: np.ndarray   # [nRaw] int32
    cum_pair: np.ndarray       # [nS, R, 36, 2] uint32 (hi, lo)
    meta: np.ndarray           # [nS, R, 36, 4] int32
    isd_cum_hi: np.ndarray     # [nI] uint32
    isd_cum_lo: np.ndarray
    isd_raw: np.ndarray        # [nI] int32


@functools.lru_cache(maxsize=None)
def _parity_tables_cached(cfg: EnvConfig, frozen: Optional[str],
                          policy_key) -> ParityTables:
    tb = tables.build_tables(cfg)
    if frozen is None:
        arr = {"t_cum": tb.t_cum, "t_next_raw": tb.t_next_raw,
               "t_prob": tb.t_prob, "t_reward": tb.t_reward,
               "t_done": tb.t_done, "t_first": tb.t_first}
    else:
        arr = tables.collapse_single_agent(
            tb, frozen, np.asarray(policy_key, dtype=np.int32))
    cum_hi, cum_lo = f64_bits(arr["t_cum"])
    cum_pair = np.stack([cum_hi, cum_lo], axis=-1)
    meta = np.stack([
        arr["t_next_raw"].astype(np.int32),
        arr["t_done"].astype(np.int32),
        arr["t_reward"].astype(np.float32).view(np.int32),
        arr["t_prob"].astype(np.float32).view(np.int32),
    ], axis=-1)
    isd_hi, isd_lo = f64_bits(np.cumsum(tb.isd_probs))
    return ParityTables(
        nS=tb.nS, n_rows=arr["t_cum"].shape[1],
        raw_to_dense=tb.raw_to_dense,
        cum_pair=cum_pair, meta=meta,
        isd_cum_hi=isd_hi, isd_cum_lo=isd_lo,
        isd_raw=tb.isd_raw.astype(np.int32),
    )


def parity_tables(cfg: EnvConfig, frozen: Optional[str] = None,
                  policy=None) -> ParityTables:
    """Build (cached) parity tensors.  ``frozen``/``policy`` mirror the
    facade's single-agent collapse."""
    key = None if policy is None else tuple(int(a) for a in np.asarray(policy))
    return _parity_tables_cached(cfg, frozen, key)


def gen_streams(seeds, n_draws: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-instance MT19937 uniform streams as (hi, lo) uint32 bit words,
    [B, n_draws] each.  seeds[i] seeds instance i exactly like the
    reference's ctor/reset(seed) (RandomState(seed_i)).

    Uses the threaded C++ generator (gym_soccer_tpu/native) when available
    — bit-identical output, ~10-40x faster for large batches — else the
    numpy RandomState loop."""
    seeds = np.asarray(seeds)
    from .. import native
    out = native.mt19937_streams(seeds, n_draws)
    if out is None:
        out = np.empty((len(seeds), n_draws), dtype=np.float64)
        for i, s in enumerate(seeds):
            out[i] = np.random.RandomState(int(s)).random_sample(n_draws)
    return f64_bits(out)


class ParityState(NamedTuple):
    raw: jax.Array          # int32 [B] current state raw code
    t: jax.Array            # int32 [B] steps taken this episode
    cursor: jax.Array       # int32 [B] per-instance stream position
    needs_reset: jax.Array  # bool [B]


def parity_init(cfg: EnvConfig, batch_size: int) -> ParityState:
    zeros = jnp.zeros(batch_size, jnp.int32)
    return ParityState(raw=zeros, t=zeros, cursor=zeros,
                       needs_reset=jnp.ones(batch_size, bool))


class ParityOut(NamedTuple):
    obs: jax.Array        # int32 [B] dense observation
    reward_a: jax.Array   # float32 [B]
    done: jax.Array       # bool [B]
    truncated: jax.Array  # bool [B]
    prob: jax.Array       # float32 [B] (sampled transition probability)
    was_reset: jax.Array  # bool [B] (a reset draw was consumed this step)


def _pick_first_exceedance(cum_hi_row, cum_lo_row, u_hi, u_lo):
    """Index of the first threshold exceeding u (uint32-pair compare).
    The reference's argmax-over-empty fallback selects the first in-list
    slot, which equals the count of zero thresholds (see ParityTables)."""
    le = _le_bits(cum_hi_row, cum_lo_row, u_hi[..., None], u_lo[..., None])
    i = jnp.sum(le, axis=-1).astype(jnp.int32)
    first = jnp.sum((cum_hi_row == 0) & (cum_lo_row == 0),
                    axis=-1).astype(jnp.int32)
    # An all-zero row (unreachable for current tables: every row carries
    # full probability mass) would make `first` == slot count; clamp so the
    # fallback stays in range like the dropped t_first table did.
    first = jnp.minimum(first, cum_hi_row.shape[-1] - 1)
    return jnp.where(i >= cum_hi_row.shape[-1], first, i)


def parity_step(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                row: Optional[jax.Array], stream_hi: jax.Array,
                stream_lo: jax.Array, pol_rows: Optional[jax.Array] = None
                ) -> tuple[ParityState, ParityOut]:
    """One reference-exact transition per instance.

    ``row``: int32 [B] table row (aa*5+ab joint index, or the learner's
    action in single-agent mode).  ``stream_hi/lo``: [B, n_draws] uint32
    per-instance MT19937 bit streams from `gen_streams`.

    ``pol_rows``: optional int32 [nS] CLOSED-LOOP policy — the table row
    to play at each dense observation.  When given, ``row`` is ignored
    and computed ON DEVICE from the post-reset observation, exactly like
    the reference main() driving ``policy[obs['player_a']]``
    (soccer_simultaneous_env.py:588-593).  Build it with `policy_rows`.
    """
    B = state.raw.shape[0]
    bidx = jnp.arange(B)

    take = lambda cur: (stream_hi[bidx, cur], stream_lo[bidx, cur])

    # ---- optional reset draw (reference reset(), :410-424) ----
    u_hi, u_lo = take(state.cursor)
    isd_hi = jnp.asarray(pt.isd_cum_hi)
    isd_lo = jnp.asarray(pt.isd_cum_lo)
    le = _le_bits(isd_hi[None, :], isd_lo[None, :], u_hi[:, None], u_lo[:, None])
    isd_i = jnp.minimum(jnp.sum(le, axis=-1),
                        len(pt.isd_raw) - 1).astype(jnp.int32)
    reset_raw = jnp.asarray(pt.isd_raw)[isd_i]

    was_reset = state.needs_reset
    raw = jnp.where(was_reset, reset_raw, state.raw)
    t = jnp.where(was_reset, 0, state.t)
    cursor = state.cursor + was_reset.astype(jnp.int32)

    # ---- transition draw (reference step(), :375-408) ----
    u_hi, u_lo = take(cursor)
    s = jnp.asarray(pt.raw_to_dense)[raw]
    if pol_rows is not None:
        row = jnp.asarray(pol_rows, jnp.int32)[s]
    pair = jnp.asarray(pt.cum_pair)[s, row]          # [B, 36, 2]
    cum_hi, cum_lo = pair[..., 0], pair[..., 1]
    i = _pick_first_exceedance(cum_hi, cum_lo, u_hi, u_lo)

    m = jnp.asarray(pt.meta)[s, row, i]              # [B, 4]
    ns_raw = m[..., 0]
    # Absorbing goal rows point at the class representative; the actual
    # state self-loops (matches facade/reference semantics).
    ns_raw = jnp.where(s == 0, raw, ns_raw)
    done = m[..., 1] != 0
    bitcast = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
    reward = bitcast(m[..., 2])
    prob = bitcast(m[..., 3])

    t = t + 1
    truncated = t >= cfg.max_steps
    new = ParityState(raw=ns_raw, t=t, cursor=cursor + 1,
                      needs_reset=done | truncated)
    obs = jnp.asarray(pt.raw_to_dense)[ns_raw]
    return new, ParityOut(obs=obs, reward_a=reward, done=done,
                          truncated=truncated, prob=prob,
                          was_reset=was_reset)


def parity_rollout(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                   rows: jax.Array, stream_hi: jax.Array,
                   stream_lo: jax.Array):
    """Scripted scan: rows [T, B] table-row indices per step."""
    def body(carry, row):
        return parity_step(cfg, pt, carry, row, stream_hi, stream_lo)

    return jax.lax.scan(body, state, rows)


def joint_row(actions_a, actions_b) -> jax.Array:
    return actions_a * N_ACTIONS + actions_b


def policy_rows(pt: ParityTables, policy_a=None, policy_b=None) -> jax.Array:
    """Dense-obs -> table-row map for closed-loop rollouts.

    * single-agent tables (n_rows == 5, one side collapsed): pass the
      live side's deterministic policy [nS];
    * joint tables (n_rows == 25): pass both policies — the row is the
      joint index pol_a[s]*5 + pol_b[s].
    """
    if pt.n_rows == N_ACTIONS:
        pol = policy_a if policy_a is not None else policy_b
        assert pol is not None, "single-agent tables need the live policy"
        return jnp.asarray(pol, jnp.int32)
    assert policy_a is not None and policy_b is not None, \
        "joint tables need both policies"
    return (jnp.asarray(policy_a, jnp.int32) * N_ACTIONS
            + jnp.asarray(policy_b, jnp.int32))


def parity_policy_rollout(cfg: EnvConfig, pt: ParityTables,
                          state: ParityState, pol_rows: jax.Array,
                          n_steps: int, stream_hi: jax.Array,
                          stream_lo: jax.Array):
    """Closed-loop scan: the policy plays itself for ``n_steps`` ticks
    (episodes auto-chain through reset draws exactly like the reference
    main()'s `while not all_done` / `env.reset()` loop, :569-597)."""
    def body(carry, _):
        return parity_step(cfg, pt, carry, None, stream_hi, stream_lo,
                           pol_rows=pol_rows)

    return jax.lax.scan(body, state, None, length=n_steps)


def parity_policy_rollout_device(cfg: EnvConfig, pt: ParityTables, seeds,
                                 pol_rows: jax.Array, n_steps: int):
    """Closed-loop parity rollout with ON-DEVICE MT19937 streams (see
    parity_rollout_device): whole policy evaluations — e.g. the reference
    main()'s 1000-episode VI eval — reproduced bit-exactly per lane."""
    from . import mt19937
    seeds = jnp.asarray(seeds, jnp.uint32)
    n_draws = 2 * n_steps + 2
    hi, lo = mt19937.device_streams(seeds, n_draws)
    state = parity_init(cfg, seeds.shape[0])
    return parity_policy_rollout(cfg, pt, state, pol_rows, n_steps, hi, lo)


class ParityEventOut(NamedTuple):
    """Per-EVENT outputs (see parity_event_step).  On reset events the
    transition fields (reward/done/truncated) are zeroed and ``was_reset``
    is True; ``obs``/``raw`` always hold the post-event state."""
    obs: jax.Array
    raw: jax.Array
    reward_a: jax.Array
    done: jax.Array
    truncated: jax.Array
    was_reset: jax.Array


def parity_event_step(cfg: EnvConfig, pt: ParityTables, state: ParityState,
                      pol_rows: jax.Array, u_hi: jax.Array, u_lo: jax.Array
                      ) -> tuple[ParityState, ParityEventOut]:
    """One reference RNG draw per lane — EVENT time.

    parity_step consumes 1-2 draws per call (an optional reset draw plus
    the transition draw), so lanes' stream positions diverge as episodes
    end at different times.  In event time each call consumes EXACTLY one
    draw per lane: lanes needing a reset spend it on the ISD categorical
    (reference reset(), :410-424), all others on the transition
    categorical (step(), :394-396).  Per-lane draw ORDER is identical to
    the reference's reset/step/step/... sequence, but every lane's stream
    cursor advances in lockstep, which keeps thousands of per-lane
    MT19937 streams position-synchronized.
    """
    nr = state.needs_reset

    # ---- reset interpretation of the draw ----
    isd_hi = jnp.asarray(pt.isd_cum_hi)
    isd_lo = jnp.asarray(pt.isd_cum_lo)
    le = _le_bits(isd_hi[None, :], isd_lo[None, :],
                  u_hi[:, None], u_lo[:, None])
    isd_i = jnp.minimum(jnp.sum(le, axis=-1),
                        len(pt.isd_raw) - 1).astype(jnp.int32)
    reset_raw = jnp.asarray(pt.isd_raw)[isd_i]

    # ---- transition interpretation of the same draw ----
    s = jnp.asarray(pt.raw_to_dense)[state.raw]
    row = jnp.asarray(pol_rows, jnp.int32)[s]
    pair = jnp.asarray(pt.cum_pair)[s, row]
    i = _pick_first_exceedance(pair[..., 0], pair[..., 1], u_hi, u_lo)
    m = jnp.asarray(pt.meta)[s, row, i]
    ns_raw = jnp.where(s == 0, state.raw, m[..., 0])
    done = m[..., 1] != 0
    reward = jax.lax.bitcast_convert_type(m[..., 2], jnp.float32)
    t2 = state.t + 1
    truncated = t2 >= cfg.max_steps

    new_raw = jnp.where(nr, reset_raw, ns_raw)
    new_t = jnp.where(nr, 0, t2)
    new = ParityState(raw=new_raw, t=new_t, cursor=state.cursor + 1,
                      needs_reset=jnp.where(nr, False, done | truncated))
    out = ParityEventOut(
        obs=jnp.asarray(pt.raw_to_dense)[new_raw], raw=new_raw,
        reward_a=jnp.where(nr, 0.0, reward),
        done=~nr & done, truncated=~nr & truncated, was_reset=nr)
    return new, out


def parity_policy_events(cfg: EnvConfig, pt: ParityTables,
                         state: ParityState, pol_rows: jax.Array,
                         n_events: int, stream_hi: jax.Array,
                         stream_lo: jax.Array):
    """Closed-loop EVENT-time scan: exactly one draw per lane per event
    (streams [B, n_events]).  Equivalent trajectories to
    parity_policy_rollout, re-timed (see parity_event_step)."""
    B = state.raw.shape[0]
    bidx = jnp.arange(B)

    def body(carry, k):
        st = carry
        return parity_event_step(cfg, pt, st, pol_rows,
                                 stream_hi[bidx, k], stream_lo[bidx, k])

    return jax.lax.scan(body, state, jnp.arange(n_events))


def parity_rollout_device(cfg: EnvConfig, pt: ParityTables, seeds,
                          rows: jax.Array):
    """Fully device-resident parity rollout: per-instance MT19937 streams
    are generated ON DEVICE (core/mt19937.py — bit-identical to numpy's
    RandomState) and fed straight into the parity kernel.  Seeds in,
    bit-exact reference trajectories out; no host RNG involvement.

    ``rows``: [T, B] table-row indices (see parity_rollout)."""
    from . import mt19937
    seeds = jnp.asarray(seeds, jnp.uint32)
    n_draws = 2 * rows.shape[0] + 2
    hi, lo = mt19937.device_streams(seeds, n_draws)
    state = parity_init(cfg, seeds.shape[0])
    return parity_rollout(cfg, pt, state, rows, hi, lo)
