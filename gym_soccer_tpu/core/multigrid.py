"""Multi-variant engine: a MIXTURE of grid geometries in one jitted batch.

BASELINE config 4 ("parameterized grid sizes / goal widths vmapped across
variants"): instead of one compiled kernel per geometry, grid parameters
become per-lane DATA — heights, widths, and goal-row ranges are int32
arrays — and the shared rules kernel (core/rules.py) broadcasts over them
(its geometry accesses are elementwise, so static ints and arrays are
interchangeable).  One compilation then steps any mix of Littman-soccer
variants in lockstep: no padding recompiles, no per-variant dispatch.

States are bounded by the LARGEST variant's board; smaller variants simply
never leave their own bounds (their kinematics clamp/bounce against their
own H/W).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig
from . import batch as corebatch
from . import rules
from . import tables


class LaneGeometry(NamedTuple):
    """Per-lane geometry arrays (a duck-typed stand-in for EnvConfig inside
    the rules kernel)."""
    H: jax.Array        # int32 [B]
    W: jax.Array        # int32 [B] (internal width incl. goal columns)
    glo: jax.Array      # int32 [B] first goal row
    ghi: jax.Array      # int32 [B] last goal row
    slip: jax.Array     # float32 [B] slip probability
    vid: jax.Array      # int32 [B] variant id (index into the cfgs list)
    max_steps: int

    @property
    def goal_row_bounds(self):
        return self.glo, self.ghi


class MultiGridState(NamedTuple):
    rows_a: jax.Array
    cols_a: jax.Array
    rows_b: jax.Array
    cols_b: jax.Array
    poss: jax.Array
    t: jax.Array
    n: jax.Array
    key: jax.Array
    geo: LaneGeometry


def lane_geometry(cfgs: Sequence[EnvConfig], batch_size: int,
                  max_steps: int = 100) -> LaneGeometry:
    """Assign variants to lanes round-robin."""
    n = len(cfgs)
    idx = np.arange(batch_size) % n
    H = np.asarray([c.H for c in cfgs], np.int32)[idx]
    W = np.asarray([c.W for c in cfgs], np.int32)[idx]
    glo = np.asarray([c.goal_row_bounds[0] for c in cfgs], np.int32)[idx]
    ghi = np.asarray([c.goal_row_bounds[1] for c in cfgs], np.int32)[idx]
    slip = np.asarray([c.slip_prob for c in cfgs], np.float32)[idx]
    return LaneGeometry(H=jnp.asarray(H), W=jnp.asarray(W),
                        glo=jnp.asarray(glo), ghi=jnp.asarray(ghi),
                        slip=jnp.asarray(slip),
                        vid=jnp.asarray(idx.astype(np.int32)),
                        max_steps=max_steps)


class MultiGridCodec(NamedTuple):
    """Per-variant dense observation codec over a mixed-geometry batch.

    The reference provides dense state indexing for any single geometry
    (soccer_simultaneous_env.py:63-106, :487-494: goal states map to
    observation 0, reachable states to their enumeration-order index);
    this extends it to a MIXTURE — each lane's observation is computed
    under its own variant's state space.  Arrays are host numpy, inlined
    as constants under jit.
    """
    cfgs: tuple                 # tuple[EnvConfig, ...]
    nS: tuple                   # per-variant dense state counts
    offsets: np.ndarray         # [V] int32: variant base in the global index
    nS_total: int               # sum of per-variant counts
    raw_to_dense: np.ndarray    # [V, max_nraw] int32 (0-padded; lanes never
    #                             produce raw codes outside their variant)


@functools.lru_cache(maxsize=None)
def build_codec(cfgs: tuple) -> MultiGridCodec:
    """Build (cached) the mixed-batch observation codec.  ``cfgs`` must be
    the same tuple used for `lane_geometry`/`init`."""
    spaces = [tables.build_statespace(c) for c in cfgs]
    nS = tuple(int(s.nS) for s in spaces)
    offsets = np.concatenate([[0], np.cumsum(nS[:-1])]).astype(np.int32)
    max_raw = max(s.raw_to_dense.shape[0] for s in spaces)
    r2d = np.zeros((len(cfgs), max_raw), np.int32)
    for v, s in enumerate(spaces):
        r2d[v, :s.raw_to_dense.shape[0]] = s.raw_to_dense
    return MultiGridCodec(cfgs=tuple(cfgs), nS=nS, offsets=offsets,
                          nS_total=int(sum(nS)), raw_to_dense=r2d)


def dense_obs(codec: MultiGridCodec, st: MultiGridState) -> jax.Array:
    """Per-lane dense observation under the lane's OWN variant
    (reference obs codec semantics per geometry: goal -> 0, reachable ->
    enumeration-order index)."""
    geo = st.geo
    raw = rules.raw_encode(jnp, st.rows_a, st.cols_a, st.rows_b, st.cols_b,
                           st.poss, geo)
    return jnp.asarray(codec.raw_to_dense)[geo.vid, raw]


def global_obs(codec: MultiGridCodec, st: MultiGridState) -> jax.Array:
    """Variant-disjoint observation: ``offsets[vid] + dense_obs`` — the
    index into learner tables concatenated over variants (each variant
    keeps its own terminal slot at its offset)."""
    return jnp.asarray(codec.offsets)[st.geo.vid] + dense_obs(codec, st)


def _isd_fields(geo: LaneGeometry, u: jax.Array):
    """Per-lane initial state, arithmetically from the geometry (reference
    _generate_isd, soccer_simultaneous_env.py:146-165): col_a=2,
    col_b=W-3; even-H grids pick one of 2 row swaps x 2 possessions,
    odd-H grids the middle goal row x 2 possessions."""
    even = (geo.H % 2) == 0
    n_entries = jnp.where(even, 4, 2)
    idx = jnp.minimum((u * n_entries).astype(jnp.int32), n_entries - 1)

    mid_hi = geo.H // 2          # even: second of the two middle rows
    mid_lo = (geo.H - 1) // 2    # even: first; odd: the single middle row
    swap = (idx // 2) == 1       # even-H: which player takes the top row
    row_a = jnp.where(even, jnp.where(swap, mid_hi, mid_lo), geo.H // 2)
    row_b = jnp.where(even, jnp.where(swap, mid_lo, mid_hi), geo.H // 2)
    poss = (idx % 2).astype(jnp.int32)
    col_a = jnp.full_like(row_a, 2)
    col_b = geo.W - 3
    return row_a, col_a, row_b, col_b, poss


def init(cfgs: Sequence[EnvConfig], key: jax.Array,
         batch_size: int) -> MultiGridState:
    geo = lane_geometry(cfgs, batch_size)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(batch_size, dtype=jnp.uint32))
    zeros = jnp.zeros(batch_size, jnp.int32)
    st = MultiGridState(zeros, zeros, zeros, zeros, zeros,
                        t=zeros, n=zeros, key=keys, geo=geo)
    return _reset_where(st, jnp.ones(batch_size, bool))


def uniforms(st: MultiGridState, count: int, salt: int = 0,
             rng: str = "threefry") -> jax.Array:
    """Per-lane uniforms; ``salt`` separates consumer streams — a policy
    sampling actions MUST use a nonzero salt or its choices correlate
    exactly with the transition's slip/collision draws (salt 0)."""
    env_view = corebatch.EnvState(st.rows_a, st.cols_a, st.rows_b,
                                  st.cols_b, st.poss, st.t, st.n, st.key)
    return corebatch.per_env_uniforms(env_view, count, salt=salt, rng=rng)


_uniforms = uniforms


def _reset_where(st: MultiGridState, mask: jax.Array) -> MultiGridState:
    u = _uniforms(st, 1)[:, 0]
    ra, ca, rb, cb, p = _isd_fields(st.geo, u)
    pick = lambda new, old: jnp.where(mask, new, old)
    return st._replace(
        rows_a=pick(ra, st.rows_a), cols_a=pick(ca, st.cols_a),
        rows_b=pick(rb, st.rows_b), cols_b=pick(cb, st.cols_b),
        poss=pick(p, st.poss), t=pick(jnp.zeros_like(st.t), st.t),
        n=st.n + 1)


def reset_where(st: MultiGridState, mask: jax.Array) -> MultiGridState:
    """Public re-sample of masked lanes (one draw, batch-aligned) — used by
    learners that need the pre-reset state (same stream as autoreset)."""
    return _reset_where(st, mask)


def step(st: MultiGridState, actions_a: jax.Array, actions_b: jax.Array,
         autoreset: bool = True):
    """Identical structure to core/batch.step, with per-lane geometry."""
    geo = st.geo
    u = _uniforms(st, 4)

    q = geo.slip  # per-lane slip probability
    var = lambda uu: jnp.where(uu < 1.0 - q,
                               0, jnp.where(uu < 1.0 - q * 0.5, 1, 2)
                               ).astype(jnp.int32)
    # arithmetic moves/selects instead of table gathers (see
    # core/batch._slipped_move_arith)
    mca, mra = corebatch._slipped_move_arith(actions_a, var(u[:, 0]))
    mcb, mrb = corebatch._slipped_move_arith(actions_b, var(u[:, 1]))

    out = rules.resolve_outcomes(
        jnp, st.rows_a, st.cols_a, st.rows_b, st.cols_b, st.poss,
        actions_a, actions_b, mca, mra, mcb, mrb, geo)

    wcum = jnp.cumsum(out["weight"].astype(jnp.float32), axis=-1)
    k = jnp.clip(jnp.sum(wcum <= u[:, 2:3], axis=-1), 0, 3).astype(jnp.int32)
    take = lambda a: sum(a[:, j] * (k == j) for j in range(4))
    nra, nca = take(out["rows_a"]), take(out["cols_a"])
    nrb, ncb = take(out["rows_b"]), take(out["cols_b"])
    npz = take(out["poss"]).astype(jnp.int32)

    # Absorbing goal states (reference :235-240, :300-301): with
    # autoreset=False a terminated lane self-loops and pays 0, exactly like
    # core/batch.step.
    was_goal = rules.is_goal_state(jnp, st.rows_a, st.cols_a, st.rows_b,
                                   st.cols_b, st.poss, geo)
    nra = jnp.where(was_goal, st.rows_a, nra)
    nca = jnp.where(was_goal, st.cols_a, nca)
    nrb = jnp.where(was_goal, st.rows_b, nrb)
    ncb = jnp.where(was_goal, st.cols_b, ncb)
    npz = jnp.where(was_goal, st.poss, npz)

    now_goal = rules.is_goal_state(jnp, nra, nca, nrb, ncb, npz, geo)
    ball_col = jnp.where(npz == 0, nca, ncb)
    reward_a = jnp.where(now_goal & ~was_goal,
                         jnp.where(ball_col == geo.W - 1, 1.0, -1.0),
                         0.0).astype(jnp.float32)

    t_next = st.t + 1
    truncated = t_next >= geo.max_steps
    mid = st._replace(rows_a=nra.astype(jnp.int32),
                      cols_a=nca.astype(jnp.int32),
                      rows_b=nrb.astype(jnp.int32),
                      cols_b=ncb.astype(jnp.int32),
                      poss=npz, t=t_next, n=st.n + 1)
    if autoreset:
        new = _reset_where(mid, now_goal | truncated)
    else:
        new = mid
    return new, (reward_a, now_goal, truncated)


def rollout(st: MultiGridState, policy_fn, n_steps: int):
    def body(carry, i):
        aa, ab = policy_fn(carry, i)
        return step(carry, aa, ab)

    return jax.lax.scan(body, st, jnp.arange(n_steps))
