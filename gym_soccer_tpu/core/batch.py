"""Batched, jit/vmap-native environment engine.

This is the batched replacement for the reference's single-env Python step
loop (soccer_simultaneous_env.py:375-424): pure functions over
struct-of-arrays int32 state, stepping thousands of env instances in
lockstep on one device,
with `lax.scan` rollouts and automatic reset-on-termination.

Design (SURVEY.md §7.1): *rules kernel first, tables second* — transitions
are computed inside the step kernel (branchless collision chain + factored
slip sampling), O(1) memory, any grid size, no gathers on the hot path
except the dense-observation lookup.  The factored sampler (slip variant
per player, then outcome slot) draws from exactly the same joint
distribution as the reference's 36-entry categorical (the list probabilities
are the products of the per-player slip probabilities and the outcome
weights), so the fast path is distributionally exact; bit-exact stream
parity is provided separately by core/parity.py.

RNG: each env instance carries an immutable per-instance key plus a
monotonic draw counter; per-step randomness is `fold_in(key_i, n_i)`.
This is placement-invariant — instance i behaves identically regardless of
batch position, shard, or host (SURVEY.md §7.3.7).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, MOVES, orthogonal_moves
from . import rules, tables


def _move_variant_table():
    """[5 actions, 3 variants, 2 (dcol,drow)] — intended move + the two
    orthogonal slips, reference order (soccer_simultaneous_env.py:203-206)."""
    out = np.zeros((5, 3, 2), dtype=np.int32)
    for a, m in enumerate(MOVES):
        o0, o1 = orthogonal_moves(m)
        out[a] = [m, o0, o1]
    return out


_MOVE_VARIANTS = _move_variant_table()


class EnvState(NamedTuple):
    """Struct-of-arrays batched state; every leaf has leading dim [B]."""
    rows_a: jax.Array  # int32
    cols_a: jax.Array
    rows_b: jax.Array
    cols_b: jax.Array
    poss: jax.Array    # 0 = A has the ball, 1 = B
    t: jax.Array       # steps taken in the current episode (int32)
    n: jax.Array       # total draws counter (monotonic, for fold_in)
    key: jax.Array     # per-instance PRNG key, never advanced


class StepOut(NamedTuple):
    obs: jax.Array        # dense observation index, int32 [B]
    reward_a: jax.Array   # player-A-perspective reward, float32 [B]
    done: jax.Array       # goal scored this step, bool [B]
    truncated: jax.Array  # episode hit max_steps, bool [B]
    final_obs: jax.Array  # obs BEFORE autoreset (terminal obs), int32 [B]
    prob: jax.Array       # sampled transition probability, float32 [B]
    #   (the reference reports it per step in info["p"],
    #   soccer_simultaneous_env.py:405; here it is the product of the two
    #   per-player slip probabilities and the sampled outcome weight, which
    #   equals the sampled unmerged-list entry's probability exactly)


class DeviceMaps(NamedTuple):
    """Small lookup arrays (no transition tables).  Cached as HOST numpy —
    they become inlined constants when referenced under jit (caching device
    arrays created during a trace would leak tracers)."""
    raw_to_dense: np.ndarray  # int32 [nRaw]
    isd_fields: np.ndarray    # int32 [nI, 5]
    isd_cum: np.ndarray       # float32 [nI]


@functools.lru_cache(maxsize=None)
def device_maps(cfg: EnvConfig) -> DeviceMaps:
    # Only the cheap O(n_raw) indexing layer — NOT the transition tensors —
    # so the direct kernel scales to grids far beyond table capacity.
    ss = tables.build_statespace(cfg)
    fields = np.stack(
        [np.array(rules.raw_decode(np, int(r), cfg), dtype=np.int32)
         for r in ss.isd_raw])
    return DeviceMaps(
        raw_to_dense=ss.raw_to_dense,
        isd_fields=fields,
        isd_cum=np.cumsum(ss.isd_probs).astype(np.float32),
    )


def init(cfg: EnvConfig, key: jax.Array, batch: int) -> EnvState:
    """Create per-instance keys and sample initial states.

    Instance i's key is fold_in(key, i): stable under resharding as long as
    global instance ids are stable.
    """
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(batch, dtype=jnp.uint32))
    return init_from_keys(cfg, keys)


def init_from_keys(cfg: EnvConfig, keys: jax.Array) -> EnvState:
    """Initialize from explicit per-instance keys [B] (e.g. gym.vector's
    per-env seed lists mapped through jax.random.key)."""
    batch = keys.shape[0]
    zeros = jnp.zeros(batch, dtype=jnp.int32)
    st = EnvState(zeros, zeros, zeros, zeros, zeros,
                  t=zeros, n=zeros, key=keys)
    return _reset_where(cfg, st, jnp.ones(batch, dtype=bool))


def per_env_uniforms(state: EnvState, count: int, salt: int = 0,
                     rng: str = "threefry") -> jax.Array:
    """[B, count] uniforms from (key_i, n_i) — placement-invariant.

    ``salt`` separates independent consumer streams (0 = the env transition
    itself; learners/policies use nonzero salts so action sampling never
    correlates with slip/collision draws).

    ``rng``: 'threefry' (default) uses jax.random fold_in/uniform — the
    strongest stream, but ~2 threefry blocks per consumer per step.
    'counter' uses the same murmur3-finalizer counter construction as the
    pallas rollout kernel (ops/step_kernel.py) — a handful of fusable
    elementwise int ops, 24-bit uniforms, statistically validated; choose
    it for throughput-bound rollouts.  Both are pure functions of
    (per-instance key, draw counter, salt): placement-invariant either way.
    """
    if rng == "counter":
        from ..ops.step_kernel import _fmix32
        kd = jax.random.key_data(state.key).astype(jnp.uint32)  # [B, 2]
        # Both 64 key bits enter the hash at SEPARATE pipeline stages: two
        # envs only replay identical streams if both 32-bit words collide
        # simultaneously (a single folded 32-bit base would hit birthday
        # collisions — duplicated trajectories — around 2^16-env batches).
        base = kd[..., 0]
        base2 = _fmix32(kd[..., 1] ^ jnp.uint32(0x3C6EF372))
        n = state.n.astype(jnp.uint32)
        cols = []
        for w in range(count):
            c = (n * jnp.uint32(0x85EBCA77)
                 + jnp.uint32((w * 0xC2B2AE3D + salt * 0x9E3779B9)
                              & 0xFFFFFFFF))
            bits = _fmix32(_fmix32(base ^ c) + (c ^ base2))
            cols.append((bits >> 8).astype(jnp.float32)
                        * jnp.float32(1.0 / (1 << 24)))
        return jnp.stack(cols, axis=-1)
    if rng != "threefry":
        raise ValueError(f"unknown rng mode {rng!r} "
                         "(expected 'threefry' or 'counter')")
    sub = jax.vmap(jax.random.fold_in)(state.key, state.n.astype(jnp.uint32))
    if salt:
        sub = jax.vmap(jax.random.fold_in, (0, None))(sub, jnp.uint32(salt))
    return jax.vmap(lambda k: jax.random.uniform(k, (count,)))(sub)


_per_env_uniforms = per_env_uniforms


def _sample_isd(cfg: EnvConfig, u: jax.Array):
    """Categorical over the initial state distribution (reference
    :146-165/:414): first-exceedance over cumulative sums."""
    maps = device_maps(cfg)
    isd_cum = jnp.asarray(maps.isd_cum)
    isd_fields = jnp.asarray(maps.isd_fields)
    i = jnp.sum(isd_cum[None, :] <= u[:, None], axis=1)
    i = jnp.clip(i, 0, isd_fields.shape[0] - 1).astype(jnp.int32)
    f = isd_fields[i]
    return f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4]


def _reset_where(cfg: EnvConfig, state: EnvState, mask: jax.Array,
                 rng: str = "threefry") -> EnvState:
    """Re-sample initial states for masked instances (consumes one draw)."""
    u = _per_env_uniforms(state, 1, rng=rng)[:, 0]
    ra, ca, rb, cb, p = _sample_isd(cfg, u)
    pick = lambda new, old: jnp.where(mask, new, old)
    return EnvState(
        rows_a=pick(ra, state.rows_a), cols_a=pick(ca, state.cols_a),
        rows_b=pick(rb, state.rows_b), cols_b=pick(cb, state.cols_b),
        poss=pick(p, state.poss),
        t=pick(jnp.zeros_like(state.t), state.t),
        n=state.n + 1,  # keep draw counters aligned across the batch
        key=state.key,
    )


def observe(cfg: EnvConfig, state: EnvState) -> jax.Array:
    """Dense observation index (reference obs codec :487-494: goal states
    map to 0, reachable states to their enumeration-order index)."""
    maps = device_maps(cfg)
    raw = rules.raw_encode(jnp, state.rows_a, state.cols_a,
                           state.rows_b, state.cols_b, state.poss, cfg)
    return jnp.asarray(maps.raw_to_dense)[raw]


def _slip_variant(cfg: EnvConfig, u: jax.Array) -> jax.Array:
    """0 = intended move (prob 1-q), 1/2 = the orthogonal slips (q/2 each),
    matching the slip expansion weights (reference :209-223)."""
    q = cfg.slip_prob
    return jnp.where(u < 1.0 - q, 0,
                     jnp.where(u < 1.0 - q * 0.5, 1, 2)).astype(jnp.int32)


def _slipped_move_arith(a: jax.Array, variant: jax.Array):
    """(dcol, drow) of action ``a`` under slip ``variant``, computed
    arithmetically.  Equivalent to indexing _MOVE_VARIANTS[a, variant] but
    with no gather, so the whole step stays one elementwise fusion."""
    mc0 = (a == 3).astype(jnp.int32) - (a == 4).astype(jnp.int32)
    mr0 = (a == 2).astype(jnp.int32) - (a == 1).astype(jnp.int32)
    # variant 1 -> (-mr0, mc0); variant 2 -> (mr0, -mc0)  (orthogonal_moves)
    first = variant == 1
    keep = variant == 0
    mc = jnp.where(keep, mc0, jnp.where(first, -mr0, mr0))
    mr = jnp.where(keep, mr0, jnp.where(first, mc0, -mc0))
    return mc, mr


def step(cfg: EnvConfig, state: EnvState,
         actions_a: jax.Array, actions_b: jax.Array,
         autoreset: bool = True,
         rng: str = "threefry") -> tuple[EnvState, StepOut]:
    """One lockstep transition for the whole batch.

    Factored sampling: slip variant per player, then one categorical over
    the <=4 collision outcome slots — jointly identical in distribution to
    the reference's single categorical over the unmerged 36-entry list.
    """
    u = _per_env_uniforms(state, 4, rng=rng)

    va = _slip_variant(cfg, u[:, 0])
    vb = _slip_variant(cfg, u[:, 1])
    mca, mra = _slipped_move_arith(actions_a, va)
    mcb, mrb = _slipped_move_arith(actions_b, vb)

    out = rules.resolve_outcomes(
        jnp, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, actions_a, actions_b, mca, mra, mcb, mrb, cfg)

    # Sample one of the 4 outcome slots by weight (first exceedance); the
    # select is arithmetic for the same no-gather reason as the moves.
    wcum = jnp.cumsum(out["weight"].astype(jnp.float32), axis=-1)
    k = jnp.sum(wcum <= u[:, 2:3], axis=-1)
    k = jnp.clip(k, 0, 3).astype(jnp.int32)
    take = lambda a: sum(a[:, j] * (k == j) for j in range(4))
    nra, nca = take(out["rows_a"]), take(out["cols_a"])
    nrb, ncb = take(out["rows_b"]), take(out["cols_b"])
    npz = take(out["poss"]).astype(jnp.int32)

    was_goal = rules.is_goal_state(
        jnp, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    # Goal states are absorbing self-loops (reference :300-301): with
    # autoreset=False a lane that terminated stays frozen in its terminal
    # state instead of letting the rules kernel move players out of a goal
    # column (which would even escape the board).
    keep = was_goal
    nra = jnp.where(keep, state.rows_a, nra)
    nca = jnp.where(keep, state.cols_a, nca)
    nrb = jnp.where(keep, state.rows_b, nrb)
    ncb = jnp.where(keep, state.cols_b, ncb)
    npz = jnp.where(keep, state.poss, npz)
    now_goal = rules.is_goal_state(jnp, nra, nca, nrb, ncb, npz, cfg)

    # Sampled transition probability (reference info["p"], :405): the
    # unmerged-list entry's probability is combo_prob x outcome weight,
    # and combo_prob factorizes into the two per-player slip probabilities.
    q = cfg.slip_prob
    pv = lambda v: jnp.where(v == 0, 1.0 - q, q * 0.5).astype(jnp.float32)
    # Absorbing states have a single outcome per combo (weight 1); the
    # reference still expands them over the 9 slip combos (:229-240).
    w_sel = jnp.where(was_goal, 1.0, take(out["weight"]).astype(jnp.float32))
    prob = pv(va) * pv(vb) * w_sel
    # Reward/done per reference :235-240: entering a goal pays the goal
    # reward; starting absorbed in one pays 0.
    ball_col = jnp.where(npz == 0, nca, ncb)
    reward_a = jnp.where(
        now_goal & ~was_goal,
        jnp.where(ball_col == cfg.W - 1, 1.0, -1.0), 0.0
    ).astype(jnp.float32)

    t_next = state.t + 1
    truncated = t_next >= cfg.max_steps
    done = now_goal

    mid = EnvState(rows_a=nra.astype(jnp.int32), cols_a=nca.astype(jnp.int32),
                   rows_b=nrb.astype(jnp.int32), cols_b=ncb.astype(jnp.int32),
                   poss=npz, t=t_next, n=state.n + 1, key=state.key)
    final_obs = observe(cfg, mid)

    if autoreset:
        new_state = _reset_where(cfg, mid, done | truncated, rng=rng)
    else:
        new_state = mid
    return new_state, StepOut(obs=observe(cfg, new_state),
                              reward_a=reward_a, done=done,
                              truncated=truncated, final_obs=final_obs,
                              prob=prob)


def rollout(cfg: EnvConfig, state: EnvState, policy_fn, n_steps: int,
            rng: str = "threefry"):
    """`lax.scan` rollout: policy_fn(obs, step_key) -> (actions_a,
    actions_b).  Returns final state and stacked StepOut trajectory."""
    def body(carry, i):
        st = carry
        obs = observe(cfg, st)
        aa, ab = policy_fn(obs, i)
        st, out = step(cfg, st, aa, ab, rng=rng)
        return st, out

    return jax.lax.scan(body, state, jnp.arange(n_steps))


class RolloutStats(NamedTuple):
    reward_sum: jax.Array  # float32 [] sum of player-A rewards
    goals: jax.Array       # int32 [] goal terminations
    truncs: jax.Array      # int32 [] truncations


def _accumulate(acc: "RolloutStats", out: StepOut) -> "RolloutStats":
    return RolloutStats(
        reward_sum=acc.reward_sum + out.reward_a.sum(),
        goals=acc.goals + out.done.sum(dtype=jnp.int32),
        truncs=acc.truncs + out.truncated.sum(dtype=jnp.int32))


def rollout_stats(cfg: EnvConfig, state: EnvState, policy_fn, n_steps: int,
                  rng: str = "threefry"):
    """`lax.scan` rollout that accumulates summary statistics in the carry
    instead of stacking per-step outputs.

    `rollout` materializes StepOut as [T, B] arrays — ~14 KB of HBM writes
    per env per 1000 steps, which dominates its runtime at large B (the
    engine computes transitions faster than it can journal them).  When
    only aggregates are needed (throughput benches, evaluation win rates),
    this variant keeps the per-step outputs out of device memory, like the
    fused rollouts (ops/step_kernel.py).  Returns (final_state, RolloutStats)."""
    def body(carry, i):
        st, acc = carry
        obs = observe(cfg, st)
        aa, ab = policy_fn(obs, i)
        st, out = step(cfg, st, aa, ab, rng=rng)
        return (st, _accumulate(acc, out)), None

    zero = RolloutStats(jnp.float32(0), jnp.int32(0), jnp.int32(0))
    (state, acc), _ = jax.lax.scan(body, (state, zero), jnp.arange(n_steps))
    return state, acc


def random_policy_fn(cfg: EnvConfig, key: jax.Array, batch: int):
    """Uniform-random joint policy for throughput benchmarks."""
    def fn(obs, i):
        k = jax.random.fold_in(key, i)
        acts = jax.random.randint(k, (2, batch), 0, 5, dtype=jnp.int32)
        return acts[0], acts[1]
    return fn


_POLICY_SALT = 9


def random_rollout_stats(cfg: EnvConfig, state: EnvState, n_steps: int,
                         rng: str = "threefry"):
    """Random-vs-random rollout accumulating stats only — the fastest
    pure-XLA path: no observation gather (random play never reads obs) and
    actions drawn from the per-instance stream (salted so they never
    correlate with the transition draws).  Returns (state, RolloutStats).
    """
    def body(carry, i):
        st, acc = carry
        u = _per_env_uniforms(st, 2, salt=_POLICY_SALT, rng=rng)
        aa = jnp.minimum((u[:, 0] * 5).astype(jnp.int32), 4)
        ab = jnp.minimum((u[:, 1] * 5).astype(jnp.int32), 4)
        st, out = step(cfg, st, aa, ab, rng=rng)
        return (st, _accumulate(acc, out)), None

    zero = RolloutStats(jnp.float32(0), jnp.int32(0), jnp.int32(0))
    (state, acc), _ = jax.lax.scan(body, (state, zero), jnp.arange(n_steps))
    return state, acc
