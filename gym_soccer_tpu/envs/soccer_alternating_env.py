"""Alternating-turn soccer environment.

Reference counterpart: /root/reference/gym_soccer/envs/soccer_alternating_env.py
(`SoccerGridWorld`) — an untested, unexported prototype.  Per SURVEY.md
§2.9/§7.4 it is a *capability signal* (turn-taking mode), to be
reimplemented sanely rather than bug-for-bug.  Differences from the
prototype's quirks, on purpose:

* goal geometry matches the simultaneous env (goal rows x goal columns,
  possession required) instead of the prototype's whole-edge goals
  (soccer_alternating_env.py:174-189);
* randomness is sampled at step time from the env's seeded RNG, not baked
  into the transition table at build time (:200);
* the state space/`nS` accounting is consistent (the prototype's
  `n_states` is wrong, :27); a constructor seed exists (:24 has none).

Semantics: players move one at a time; ``who_moves_next`` is part of the
state.  The mover's displacement may slip orthogonally (prob `slip_prob`,
split 50/50).  Moving into the opponent's cell bounces back and hands them
possession (the prototype's steal rule, :161-169); board edges and goal
walls bounce like the simultaneous env.  Carrying the ball into a goal
cell ends the episode with the A-perspective reward +-1.

Both a single-env class (dict API mirroring the simultaneous facade) and a
batched jit/vmap kernel (`alt_step`) are provided.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import spaces
from ..config import MOVES, N_ACTIONS, EnvConfig, orthogonal_moves
from ..core import rules


def _mover_next_cell(xp, x, y, mc, mr, has_ball, cfg):
    return rules.next_cell(xp, x, y, mc, mr, has_ball, cfg)


def alt_transition(xp, xa, ya, xb, yb, p, turn, action, mc, mr, cfg):
    """Pure single-move resolution (broadcastable).  ``turn`` 0 = A moves.

    Returns (nxa, nya, nxb, nyb, npz, nturn)."""
    mover_x = xp.where(turn == 0, xa, xb)
    mover_y = xp.where(turn == 0, ya, yb)
    opp_x = xp.where(turn == 0, xb, xa)
    opp_y = xp.where(turn == 0, yb, ya)
    has_ball = p == turn

    nx, ny = _mover_next_cell(xp, mover_x, mover_y, mc, mr, has_ball, cfg)

    # Steal rule: stepping into the opponent bounces back and flips
    # possession to the opponent.
    collide = (nx == opp_x) & (ny == opp_y)
    nx = xp.where(collide, mover_x, nx)
    ny = xp.where(collide, mover_y, ny)
    npz = xp.where(collide, 1 - turn, p)

    nxa = xp.where(turn == 0, nx, xa)
    nya = xp.where(turn == 0, ny, ya)
    nxb = xp.where(turn == 0, xb, nx)
    nyb = xp.where(turn == 0, yb, ny)
    return nxa, nya, nxb, nyb, npz, 1 - turn


class AltEnvState(NamedTuple):
    rows_a: jax.Array
    cols_a: jax.Array
    rows_b: jax.Array
    cols_b: jax.Array
    poss: jax.Array
    turn: jax.Array
    t: jax.Array
    n: jax.Array
    key: jax.Array


def alt_init(cfg: EnvConfig, key: jax.Array, batch: int,
             first_mover: int = 0) -> AltEnvState:
    from ..core import batch as corebatch
    st = corebatch.init(cfg, key, batch)
    return AltEnvState(rows_a=st.rows_a, cols_a=st.cols_a, rows_b=st.rows_b,
                       cols_b=st.cols_b, poss=st.poss,
                       turn=jnp.full_like(st.poss, first_mover),
                       t=st.t, n=st.n, key=st.key)


def alt_step(cfg: EnvConfig, state: AltEnvState, action: jax.Array,
             autoreset: bool = True):
    """Batched alternating-turn step for the current mover of each lane."""
    from ..core import batch as corebatch
    env_view = corebatch.EnvState(state.rows_a, state.cols_a, state.rows_b,
                                  state.cols_b, state.poss, state.t,
                                  state.n, state.key)
    u = corebatch.per_env_uniforms(env_view, 2)
    variant = corebatch._slip_variant(cfg, u[:, 0])
    mc, mr = corebatch._slipped_move_arith(action, variant)

    nra, nca, nrb, ncb, npz, nturn = alt_transition(
        jnp, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, state.turn, action, mc, mr, cfg)

    now_goal = rules.is_goal_state(jnp, nra, nca, nrb, ncb, npz, cfg)
    ball_col = jnp.where(npz == 0, nca, ncb)
    reward_a = jnp.where(
        now_goal, jnp.where(ball_col == cfg.W - 1, 1.0, -1.0), 0.0
    ).astype(jnp.float32)

    t = state.t + 1
    truncated = t >= cfg.max_steps
    mid = AltEnvState(nra, nca, nrb, ncb, npz, nturn, t, state.n + 1,
                      state.key)
    if autoreset:
        mid = alt_reset_where(cfg, mid, now_goal | truncated)
    return mid, (reward_a, now_goal, truncated)


def alt_reset_where(cfg: EnvConfig, state: AltEnvState,
                    mask: jax.Array) -> AltEnvState:
    """Re-sample masked lanes from the ISD (turn resets to first mover 0)."""
    from ..core import batch as corebatch
    env_mid = corebatch.EnvState(state.rows_a, state.cols_a, state.rows_b,
                                 state.cols_b, state.poss, state.t, state.n,
                                 state.key)
    env_new = corebatch._reset_where(cfg, env_mid, mask)
    return AltEnvState(env_new.rows_a, env_new.cols_a, env_new.rows_b,
                       env_new.cols_b, env_new.poss,
                       jnp.where(mask, 0, state.turn),
                       env_new.t, env_new.n, state.key)


# ----------------------------------------------------------------------
# Tabular dynamics + planners (the prototype exposes a P table and is
# meant to be solvable — soccer_alternating_env.py:100-200; this gives the
# sane reimplementation the same capability, vectorized)
# ----------------------------------------------------------------------

# Per (state, action) there are at most 3 outcomes: the intended move
# (prob 1-q) and the two orthogonal slips (q/2 each), in the facade
# step()'s sampling order.  Turn-taking has no collision fan-out — the
# steal rule is deterministic given the landed cell.
ALT_MAX_TRANSITIONS = 3


@dataclasses.dataclass
class AltTables:
    """Dense tabular dynamics of the alternating-turn game.

    States are (xa, ya, xb, yb, p, turn); the mover of state ``s`` is
    ``turn[s]``.  Dense index 0 is the absorbing terminal (all goal
    states map there), mirroring the simultaneous tables' convention."""
    cfg: EnvConfig
    nS: int
    raw_to_dense: np.ndarray   # [n_raw * 2] int32; -1 unreachable, 0 goal
    dense_to_raw: np.ndarray   # [nS] int32 (raw*2 + turn codes)
    fields: np.ndarray         # [nS, 6] int32 (xa, ya, xb, yb, p, turn)
    turn: np.ndarray           # [nS] int32 — mover of each dense state
    t_prob: np.ndarray         # [nS, nA, 3] float64
    t_next_dense: np.ndarray   # [nS, nA, 3] int32
    t_reward: np.ndarray       # [nS, nA, 3] float64 (A-perspective)
    t_done: np.ndarray         # [nS, nA, 3] bool


def alt_raw_encode(xp, xa, ya, xb, yb, p, turn, cfg: EnvConfig):
    """Mixed-radix code over (simultaneous raw code, turn)."""
    return rules.raw_encode(xp, xa, ya, xb, yb, p, cfg) * 2 + turn


@functools.lru_cache(maxsize=None)
def build_alt_tables(cfg: EnvConfig) -> AltTables:
    """Vectorized enumeration of the alternating-turn dynamics.

    Same reachability classification as the simultaneous game (players
    never co-locate thanks to the steal rule; goal columns only entered
    on goal rows with the ball), crossed with the 2 turn values."""
    n_raw2 = cfg.n_raw * 2
    code = np.arange(n_raw2, dtype=np.int64)
    turn_all = (code & 1).astype(np.int32)
    xa, ya, xb, yb, p = rules.raw_decode(np, code >> 1, cfg)

    unreach = rules.is_unreachable(np, xa, ya, xb, yb, p, cfg)
    goal = ~unreach & rules.is_goal_state(np, xa, ya, xb, yb, p, cfg)
    reach = ~unreach & ~goal

    raw_to_dense = np.full(n_raw2, -1, dtype=np.int32)
    raw_to_dense[reach] = np.cumsum(reach)[reach].astype(np.int32)
    raw_to_dense[goal] = 0
    nS = int(reach.sum()) + 1

    dense_to_raw = np.zeros(nS, dtype=np.int32)
    dense_to_raw[raw_to_dense[reach]] = code[reach]
    dense_to_raw[0] = code[goal][-1]

    fxa, fya, fxb, fyb, fp = rules.raw_decode(np, dense_to_raw >> 1, cfg)
    fturn = (dense_to_raw & 1).astype(np.int32)
    fields = np.stack([fxa, fya, fxb, fyb, fp, fturn], axis=-1).astype(np.int32)

    # --- transition expansion: [nS, nA, 3] ---------------------------------
    from ..core.tables import _move_variants
    mv = _move_variants()                       # [nA, 3, 2] (dcol, drow)
    mc = mv[None, :, :, 0]
    mr = mv[None, :, :, 1]
    sxa, sya = fxa[:, None, None], fya[:, None, None]
    sxb, syb = fxb[:, None, None], fyb[:, None, None]
    sp, st = fp[:, None, None], fturn[:, None, None]
    act = np.arange(N_ACTIONS, dtype=np.int32)[None, :, None]

    nxa, nya, nxb, nyb, npz, nturn = alt_transition(
        np, sxa, sya, sxb, syb, sp, st, act, mc, mr, cfg)
    nxt = alt_raw_encode(np, nxa, nya, nxb, nyb, npz,
                         np.broadcast_to(nturn, nxa.shape), cfg)
    done = rules.is_goal_state(np, nxa, nya, nxb, nyb, npz, cfg)
    reward = np.where(done, rules.goal_reward_a(np, nxa, nya, nxb, nyb,
                                                npz, cfg), 0.0)
    t_next_dense = raw_to_dense[nxt].astype(np.int32)
    t_next_dense = np.broadcast_to(t_next_dense,
                                   (nS, N_ACTIONS, ALT_MAX_TRANSITIONS)).copy()
    done = np.broadcast_to(done, t_next_dense.shape).copy()
    reward = np.broadcast_to(reward, t_next_dense.shape).copy()

    q = float(cfg.slip_prob)
    t_prob = np.broadcast_to(
        np.array([1.0 - q, q * 0.5, q * 0.5], dtype=np.float64),
        t_next_dense.shape).copy()

    # Dense 0 is the absorbing terminal: self-loop, reward 0, done.
    t_prob[0] = 0.0
    t_prob[0, :, 0] = 1.0
    t_next_dense[0] = 0
    t_reward = reward
    t_reward[0] = 0.0
    done[0] = True

    assert (t_next_dense >= 0).all(), "alternating step left the state space"
    return AltTables(cfg=cfg, nS=nS, raw_to_dense=raw_to_dense,
                     dense_to_raw=dense_to_raw, fields=fields, turn=fturn,
                     t_prob=t_prob, t_next_dense=t_next_dense,
                     t_reward=t_reward, t_done=done)


def alt_value_iteration(tb: AltTables, theta: float = 1e-10,
                        gamma: float = 0.99,
                        frozen_a: np.ndarray | None = None,
                        frozen_b: np.ndarray | None = None):
    """Turn-based minimax value iteration (A-perspective values).

    At A-to-move states V = max_a Q; at B-to-move states V = min_a Q —
    the exact solution of the zero-sum turn game (no LP needed: only one
    player acts per tick).  Passing ``frozen_a``/``frozen_b`` (int [nS]
    policies) clamps that side's choice instead, turning the sweep into
    best-response planning against a frozen opponent — the alternating
    analogue of the reference's VI-vs-frozen-policy usage
    (soccer_simultaneous_env.py:518-530).

    Returns (pi, V, Q, sweeps): ``pi[s]`` is the mover's action."""
    prob, ns = tb.t_prob, tb.t_next_dense
    rew, done = tb.t_reward, tb.t_done
    turn = tb.turn
    idx = np.arange(tb.nS)
    V = np.zeros(tb.nS, dtype=np.float64)
    cc = 0
    while True:
        cont = np.where(done, 0.0, V[ns])
        Q = np.einsum("sak,sak->sa", prob, rew + gamma * cont, optimize=True)
        va = Q.max(axis=1) if frozen_a is None else Q[idx, frozen_a]
        vb = Q.min(axis=1) if frozen_b is None else Q[idx, frozen_b]
        newV = np.where(turn == 0, va, vb)
        cc += 1
        if np.max(np.abs(V - newV)) < theta:
            break
        V = newV
    pa = Q.argmax(axis=1) if frozen_a is None else frozen_a
    pb = Q.argmin(axis=1) if frozen_b is None else frozen_b
    pi = np.where(turn == 0, pa, pb).astype(np.int32)
    return pi, newV, Q, cc


def alt_value_iteration_jax(t_prob, t_next_dense, t_reward, t_done, turn,
                            theta: float = 1e-6, gamma: float = 0.99,
                            max_sweeps: int = 20_000):
    """Jitted turn-based minimax VI fixpoint (lax.while_loop), the
    on-device twin of `alt_value_iteration` (same sweep; dtype follows
    `t_prob` — float32 by default, use x64 arrays for tight thetas).

    Returns (pi, V, Q, sweeps) with ``pi[s]`` the mover's action."""
    dt = t_prob.dtype
    a_moves = (turn == 0)

    def backup(V):
        cont = jnp.where(t_done, 0.0, V[t_next_dense])
        return jnp.sum(t_prob * (t_reward + gamma * cont), axis=-1)

    def cond(carry):
        V, Q, cc, delta = carry
        return (delta >= theta) & (cc < max_sweeps)

    def body(carry):
        V, _, cc, _ = carry
        Q = backup(V)
        newV = jnp.where(a_moves, Q.max(axis=1), Q.min(axis=1))
        return newV, Q, cc + 1, jnp.max(jnp.abs(V - newV))

    nS, nA = t_prob.shape[:2]
    V0 = jnp.zeros(nS, dtype=dt)
    Q0 = jnp.zeros((nS, nA), dtype=dt)
    V, Q, cc, _ = jax.lax.while_loop(
        cond, body, (V0, Q0, jnp.int32(0), jnp.asarray(jnp.inf, dt)))
    pi = jnp.where(a_moves, Q.argmax(axis=1), Q.argmin(axis=1))
    return pi.astype(jnp.int32), V, Q, cc


alt_value_iteration_jax_jit = jax.jit(
    alt_value_iteration_jax, static_argnames=("max_sweeps",))


def alt_policy_rollout(cfg: EnvConfig, raw_to_dense, pol_a, pol_b,
                       batch: int = 512, steps: int = 400, seed: int = 0,
                       first_mover: int = 0):
    """Batched closed-loop evaluation: both sides play their int [nS]
    policy arrays through the jitted alternating kernel (autoreset on).

    Returns (wins_a, losses_a, truncations) summed over all lanes/steps."""
    r2d = jnp.asarray(raw_to_dense, dtype=jnp.int32)
    pa = jnp.asarray(pol_a, dtype=jnp.int32)
    pb = jnp.asarray(pol_b, dtype=jnp.int32)

    def body(st, _):
        raw2 = alt_raw_encode(jnp, st.rows_a, st.cols_a, st.rows_b,
                              st.cols_b, st.poss, st.turn, cfg)
        s = r2d[raw2]
        a = jnp.where(st.turn == 0, pa[s], pb[s]).astype(jnp.int32)
        st2, (rew, goal, trunc) = alt_step(cfg, st, a, autoreset=True)
        return st2, (rew, trunc)

    @jax.jit
    def run(key):
        st0 = alt_init(cfg, key, batch, first_mover)
        _, (rews, truncs) = jax.lax.scan(body, st0, None, length=steps)
        return ((rews > 0).sum(), (rews < 0).sum(), truncs.sum())

    w, l, t = run(jax.random.key(seed))
    return int(w), int(l), int(t)


class SoccerAlternatingEnv:
    """Single-env alternating-turn facade (dict API like the simultaneous
    facade; one agent acts per step — the one named by `current_player`)."""

    NOOP, NORTH, SOUTH, EAST, WEST = 0, 1, 2, 3, 4
    ACTION_STRING = ['NOOP', 'NORTH', 'SOUTH', 'EAST', 'WEST']
    TERMINAL_STATE = (-1, -1, -1, -1, -1, -1)

    def __init__(self, width=5, height=4, slip_prob=0.0, seed=0,
                 first_mover=0, max_steps=100):
        assert width >= 5, "Width must be at least 5 columns."
        assert height >= 4, "Height must be at least 4 rows."
        self.cfg = EnvConfig(width=width, height=height,
                             slip_prob=float(slip_prob),
                             max_steps=int(max_steps))
        self.width, self.height = self.cfg.W, self.cfg.H
        self.slip_prob = float(slip_prob)
        self.goal_rows, self.goal_cols = self.cfg.goal_rows, self.cfg.goal_cols
        self.np_random = np.random.RandomState(seed)
        self.first_mover = first_mover
        self.agents = ['player_a', 'player_b']
        obs_nvec = (self.height, self.width, self.height, self.width, 2)
        self.observation_space = spaces.Dict({
            a: spaces.MultiDiscrete(obs_nvec) for a in self.agents})
        self.action_space = spaces.Dict({
            a: spaces.Discrete(5) for a in self.agents})
        self._isd = self._make_isd()
        self.state = None            # (xa, ya, xb, yb, p, turn)
        self.needs_reset = True
        self.timestep = 0
        self.lastaction = None

    def _make_isd(self):
        from ..core.tables import build_isd
        probs, raws = build_isd(self.cfg)
        return [(float(p), rules.raw_decode(np, int(r), self.cfg))
                for p, r in zip(probs, raws)]

    @property
    def current_player(self):
        assert self.state is not None, "reset first"
        return 'player_a' if self.state[5] == 0 else 'player_b'

    @property
    def tables(self) -> AltTables:
        """Dense tabular dynamics (built lazily, cached per config)."""
        return build_alt_tables(self.cfg)

    @property
    def nS(self) -> int:
        return self.tables.nS

    @functools.cached_property
    def state_space(self):
        """(xa, ya, xb, yb, p, turn) tuple -> dense index, like the
        simultaneous facade's state_space dict (including the
        TERMINAL_STATE -> 0 entry).  Built once and cached — per-step
        access is O(1), like the simultaneous facade's _P view."""
        tb = self.tables
        out = {self.TERMINAL_STATE: 0}
        out.update({tuple(int(v) for v in tb.fields[s]): s
                    for s in range(1, tb.nS)})
        return out

    @functools.cached_property
    def P(self):
        """Reference-prototype-style transition dict view
        (soccer_alternating_env.py:100-130 exposes P): P[s][a] ->
        ordered [(prob, next_dense, reward_a, done)], zero-probability
        slip slots dropped (like the simultaneous env drops
        zero-probability combos, soccer_simultaneous_env.py:226-227).
        Built once and cached."""
        tb = self.tables
        out = {}
        for s in range(tb.nS):
            row = {}
            for a in range(N_ACTIONS):
                row[a] = [
                    (float(tb.t_prob[s, a, k]), int(tb.t_next_dense[s, a, k]),
                     float(tb.t_reward[s, a, k]), bool(tb.t_done[s, a, k]))
                    for k in range(ALT_MAX_TRANSITIONS)
                    if tb.t_prob[s, a, k] > 0.0]
            out[s] = row
        return out

    def _obs(self):
        xa, ya, xb, yb, p, turn = self.state
        # Egocentric tuples: own position first, own-possession bit.
        return {
            'player_a': (xa, ya, xb, yb, 1 if p == 0 else 0),
            'player_b': (xb, yb, xa, ya, 1 if p == 1 else 0),
        }

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.np_random.seed(seed)
        u = self.np_random.random()
        cum = np.cumsum([p for p, _ in self._isd])
        i = int(np.argmax(cum > u))
        _, st = self._isd[i]
        self.state = (*st, self.first_mover)
        self.needs_reset = False
        self.timestep = 0
        self.lastaction = None
        return self._obs(), {a: {} for a in self.agents}

    def step(self, action: int):
        """`action` is the CURRENT mover's action (int)."""
        assert not self.needs_reset, "reset the environment first"
        xa, ya, xb, yb, p, turn = self.state
        mc, mr = MOVES[action]
        u = self.np_random.random()
        if u >= 1.0 - self.slip_prob:
            o0, o1 = orthogonal_moves((mc, mr))
            mc, mr = o0 if u < 1.0 - self.slip_prob * 0.5 else o1
        nxa, nya, nxb, nyb, npz, nturn = alt_transition(
            np, xa, ya, xb, yb, p, turn, action, mc, mr, self.cfg)
        state = tuple(int(v) for v in (nxa, nya, nxb, nyb, npz, nturn))
        self.state = state
        self.lastaction = action
        self.timestep += 1
        done = bool(rules.is_goal_state(np, *state[:5], self.cfg))
        ball_col = state[1] if state[4] == 0 else state[3]
        reward_a = (0.0 if not done
                    else 1.0 if ball_col == self.cfg.W - 1 else -1.0)
        truncated = self.timestep >= self.cfg.max_steps
        self.needs_reset = done or truncated
        rewards = {'player_a': reward_a, 'player_b': -reward_a}
        dones = {a: done for a in self.agents}
        truncs = {a: truncated for a in self.agents}
        return self._obs(), rewards, dones, truncs, {a: {} for a in self.agents}
