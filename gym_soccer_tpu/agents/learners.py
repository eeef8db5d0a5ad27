"""On-device tabular self-play learners, fused with batched rollouts.

The reference has NO learners (its solution layer is DP planning over the
exposed tables; SURVEY.md §2.10a requires these as batched additions):

* **Independent Q-learning** — two Q-tables (player A maximizes r, player B
  maximizes -r), epsilon-greedy behavior, batched TD(0) updates applied as
  scatter-adds over the lockstep batch, the whole (rollout chunk + update)
  loop living inside one `lax.scan` under jit.

* **Minimax-Q** (Littman 1994 — the algorithm this environment was built
  for) — joint table Q[s, aa, ab] for player A; V and mixed strategies come
  from solving the 5x5 zero-sum matrix game at every state.  Batched
  schedule: transitions stream into Q via scatter-adds, and the per-state
  game solves are batched over ALL nS states at once every `resolve_every`
  steps (761 simultaneous 5x5 solves are one tiny fused kernel) instead of
  the classical per-visit LP.

Data parallelism: `psum_axis` names a mesh axis to all-reduce Q-table
*deltas* over, keeping replicated tables consistent across env shards
(SURVEY.md §5.8) while each shard steps its own envs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import EnvConfig, N_ACTIONS
from ..core import batch, multigrid, tables


# ----------------------------------------------------------------------
# Engine adapters: the learner math is identical over the single-geometry
# batch engine (core/batch) and the mixed-geometry engine (core/multigrid
# + its per-variant dense codec); only obs/uniforms/step wiring differs.
# ----------------------------------------------------------------------

class _Engine(NamedTuple):
    observe: object    # env -> int32 [B] learner state index
    uniforms: object   # (env, count, salt) -> [B, count] uniforms
    step: object       # (env, aa, ab) -> (env2, reward_a, done, trunc,
    #                                      final_obs)  [final_obs pre-reset]
    nS: int


def _batch_engine(cfg: EnvConfig) -> _Engine:
    def estep(env, aa, ab):
        env2, out = batch.step(cfg, env, aa, ab)
        return env2, out.reward_a, out.done, out.truncated, out.final_obs

    return _Engine(
        observe=lambda env: batch.observe(cfg, env),
        uniforms=lambda env, count, salt: batch.per_env_uniforms(
            env, count, salt=salt),
        step=estep,
        nS=tables.build_statespace(cfg).nS)


def _multigrid_engine(codec: multigrid.MultiGridCodec) -> _Engine:
    """Mixed-geometry engine: learner tables are concatenated over variants
    (index = codec.offsets[vid] + per-variant dense obs), so one Q-table /
    policy array covers the whole mixture and scatter updates land in each
    variant's own block."""
    def estep(env, aa, ab):
        mid, (r, goal, trunc) = multigrid.step(env, aa, ab, autoreset=False)
        final_obs = multigrid.global_obs(codec, mid)
        env2 = multigrid.reset_where(mid, goal | trunc)
        return env2, r, goal, trunc, final_obs

    return _Engine(
        observe=lambda env: multigrid.global_obs(codec, env),
        uniforms=lambda env, count, salt: multigrid.uniforms(
            env, count, salt=salt),
        step=estep,
        nS=codec.nS_total)


# ----------------------------------------------------------------------
# Zero-sum matrix-game solver (batched)
# ----------------------------------------------------------------------

def _lsum(x: jax.Array) -> jax.Array:
    """Sum over the last axis, left to right, as elementwise adds: every
    game's arithmetic is then the same sequence of f32 operations for any
    batch shape (a dot or reduce may be compiled differently per shape on
    a GPU), so a state-sharded solve equals the replicated one bit for
    bit, and no product runs in TF32."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def solve_matrix_games(M: jax.Array, iters: int = 100
                       ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Approximately solve max_x min_y x^T M y for a batch of zero-sum
    games M [..., nA, nA] via Regret Matching+ self-play with linear
    averaging (empirically ~O(1/T) duality gap on small games — a few
    hundred iterations reach 1e-3-1e-4 on [-1,1]-bounded payoffs, which
    matters because a per-state strategy gap is amplified by the 1/(1-gamma)
    horizon when these solves back equilibrium values).

    Returns (value, x, y): the game values [...] and the averaged mixed
    strategies for the row maximizer / column minimizer [..., nA].

    The contractions are explicit f32 multiply-adds (`_lsum`), not
    einsums: on a GPU a default f32 einsum may run in TF32 (~1e-3
    relative), as coarse as the exploitability the trainers are held to
    (<= 0.010 at a ~0.002 floor), and its summation order may change with
    the batch shape.
    """
    nA = M.shape[-1]
    shape = M.shape[:-2]
    dt = M.dtype
    uniform = jnp.full(shape + (nA,), 1.0 / nA, dt)

    def normalize(r):
        s = _lsum(r)[..., None]
        return jnp.where(s > 0, r / jnp.maximum(s, 1e-30), uniform)

    def body(carry, t):
        rx, ry, sx, sy = carry
        x = normalize(rx)
        y = normalize(ry)
        # instantaneous payoffs
        my = _lsum(M * y[..., None, :])               # row payoffs vs y
        xm = _lsum(jnp.swapaxes(M, -1, -2) * x[..., None, :])  # col vs x
        vx = _lsum(x * my)[..., None]
        # RM+: truncate cumulative regrets at zero
        rx = jnp.maximum(rx + (my - vx), 0.0)
        ry = jnp.maximum(ry + (vx - xm), 0.0)
        w = (t + 1).astype(dt)  # linear averaging
        return (rx, ry, sx + w * x, sy + w * y), None

    zeros = jnp.zeros(shape + (nA,), dt)
    (rx, ry, sx, sy), _ = jax.lax.scan(
        body, (zeros, zeros, zeros, zeros), jnp.arange(iters))
    x = sx / _lsum(sx)[..., None]
    y = sy / _lsum(sy)[..., None]
    value = _lsum(x * _lsum(M * y[..., None, :]))
    return value, x, y


# ----------------------------------------------------------------------
# Independent Q-learning
# ----------------------------------------------------------------------

class IQLState(NamedTuple):
    q_a: jax.Array      # [nS, 5]
    q_b: jax.Array      # [nS, 5]
    env: batch.EnvState
    step: jax.Array     # int32 scalar


class IQLConfig(NamedTuple):
    lr: float = 0.1
    gamma: float = 0.99
    eps: float = 0.1


def iql_init(cfg: EnvConfig, key: jax.Array, n_envs: int) -> IQLState:
    nS = tables.build_statespace(cfg).nS
    return IQLState(
        q_a=jnp.zeros((nS, N_ACTIONS), jnp.float32),
        q_b=jnp.zeros((nS, N_ACTIONS), jnp.float32),
        env=batch.init(cfg, key, n_envs),
        step=jnp.int32(0),
    )


def _eps_greedy(q_row: jax.Array, u_explore: jax.Array,
                u_action: jax.Array, eps: float) -> jax.Array:
    greedy = jnp.argmax(q_row, axis=-1).astype(jnp.int32)
    rand = (u_action * N_ACTIONS).astype(jnp.int32) % N_ACTIONS
    return jnp.where(u_explore < eps, rand, greedy)


def _iql_step_engine(eng: _Engine, lcfg: IQLConfig, state: IQLState,
                     psum_axis: Optional[str] = None,
                     frozen_a=None, frozen_b=None
                     ) -> tuple[IQLState, jax.Array]:
    obs = eng.observe(state.env)
    u = eng.uniforms(state.env, 4, 1).T
    if frozen_a is not None:
        aa = jnp.asarray(frozen_a)[obs]
    else:
        aa = _eps_greedy(state.q_a[obs], u[0], u[1], lcfg.eps)
    if frozen_b is not None:
        ab = jnp.asarray(frozen_b)[obs]
    else:
        ab = _eps_greedy(state.q_b[obs], u[2], u[3], lcfg.eps)

    env2, reward_a, done, truncated, final_obs = eng.step(state.env, aa, ab)
    term = done | truncated
    cont = jnp.where(term, 0.0, 1.0)

    # TD targets; B sees the negated reward (zero-sum, reference :400-402)
    tgt_a = reward_a + lcfg.gamma * cont * state.q_a[final_obs].max(-1)
    tgt_b = -reward_a + lcfg.gamma * cont * state.q_b[final_obs].max(-1)
    td_a = tgt_a - state.q_a[obs, aa]
    td_b = tgt_b - state.q_b[obs, ab]

    # Count-normalized scatter updates: many envs can hit the same
    # (s, a) cell in one lockstep batch; applying the MEAN of their TDs at
    # learning rate lr keeps the update magnitude batch-size-invariant
    # (raw sums compound into runaway feedback at large batch).  Sums and
    # counts are all-reduced across env shards BEFORE the divide, so
    # replicated tables stay bit-identical to single-device training.
    sum_a = jnp.zeros_like(state.q_a).at[obs, aa].add(td_a)
    cnt_a = jnp.zeros_like(state.q_a).at[obs, aa].add(1.0)
    sum_b = jnp.zeros_like(state.q_b).at[obs, ab].add(td_b)
    cnt_b = jnp.zeros_like(state.q_b).at[obs, ab].add(1.0)
    if psum_axis is not None:
        sum_a = jax.lax.psum(sum_a, psum_axis)
        cnt_a = jax.lax.psum(cnt_a, psum_axis)
        sum_b = jax.lax.psum(sum_b, psum_axis)
        cnt_b = jax.lax.psum(cnt_b, psum_axis)
    delta_a = lcfg.lr * sum_a / jnp.maximum(cnt_a, 1.0)
    delta_b = lcfg.lr * sum_b / jnp.maximum(cnt_b, 1.0)
    if frozen_a is not None:
        delta_a = jnp.zeros_like(delta_a)
    if frozen_b is not None:
        delta_b = jnp.zeros_like(delta_b)

    new = IQLState(q_a=state.q_a + delta_a, q_b=state.q_b + delta_b,
                   env=env2, step=state.step + 1)
    return new, (jnp.abs(td_a).mean() + jnp.abs(td_b).mean()) * 0.5


def iql_step(cfg: EnvConfig, lcfg: IQLConfig, state: IQLState,
             psum_axis: Optional[str] = None,
             frozen_a=None, frozen_b=None) -> tuple[IQLState, jax.Array]:
    """One fused act/step/update for the whole batch.  Returns mean |TD|.

    Action exploration draws from the env instances' own salted key streams
    (batch.per_env_uniforms) — placement-invariant and shard-safe.

    ``frozen_a``/``frozen_b``: optional int policy array [nS] fixing that
    player's behavior (the batched analogue of the reference's frozen-
    opponent single-agent mode, soccer_simultaneous_env.py:187-188); the
    frozen side's Q-table is left untouched."""
    return _iql_step_engine(_batch_engine(cfg), lcfg, state, psum_axis,
                            frozen_a, frozen_b)


def iql_train(cfg: EnvConfig, lcfg: IQLConfig, state: IQLState,
              n_steps: int, psum_axis: Optional[str] = None,
              frozen_a=None, frozen_b=None) -> tuple[IQLState, jax.Array]:
    """`lax.scan` over fused learner steps (jit this)."""
    def body(carry, _):
        return iql_step(cfg, lcfg, carry, psum_axis, frozen_a, frozen_b)

    return jax.lax.scan(body, state, None, length=n_steps)


def multigrid_iql_init(cfgs, key: jax.Array, n_envs: int) -> IQLState:
    """IQL over a MIXED-geometry batch: one concatenated Q-table pair
    covering every variant's state space (see _multigrid_engine)."""
    codec = multigrid.build_codec(tuple(cfgs))
    return IQLState(
        q_a=jnp.zeros((codec.nS_total, N_ACTIONS), jnp.float32),
        q_b=jnp.zeros((codec.nS_total, N_ACTIONS), jnp.float32),
        env=multigrid.init(list(cfgs), key, n_envs),
        step=jnp.int32(0),
    )


def multigrid_iql_train(cfgs, lcfg: IQLConfig, state: IQLState,
                        n_steps: int, psum_axis: Optional[str] = None,
                        frozen_a=None, frozen_b=None
                        ) -> tuple[IQLState, jax.Array]:
    """Fused IQL training over a mixed-geometry batch (jit this)."""
    eng = _multigrid_engine(multigrid.build_codec(tuple(cfgs)))

    def body(carry, _):
        return _iql_step_engine(eng, lcfg, carry, psum_axis,
                                frozen_a, frozen_b)

    return jax.lax.scan(body, state, None, length=n_steps)


# ----------------------------------------------------------------------
# Minimax-Q (Littman 1994)
# ----------------------------------------------------------------------

class MinimaxQState(NamedTuple):
    q: jax.Array        # [nS, 5, 5] — player-A payoff of joint actions
    v: jax.Array        # [nS] — current game values
    pi_a: jax.Array     # [nS, 5] — A's maximin mixed strategy
    pi_b: jax.Array     # [nS, 5] — B's minimax mixed strategy
    env: batch.EnvState
    step: jax.Array
    n: jax.Array        # [nS, 5, 5] — lifetime visit counts (decayed-alpha)


class MinimaxQConfig(NamedTuple):
    lr: float = 0.25
    gamma: float = 0.99
    eps: float = 0.3          # exploration mixed into the policies
    resolve_every: int = 32   # batched all-state game re-solve cadence
    solver_iters: int = 200
    lr_halflife: int = 0      # steps to halve lr (0 = constant), as in
    eps_halflife: int = 0     # Littman's decayed-alpha schedule
    # Per-cell Robbins-Monro schedule (Littman 1994's decayed alpha, done
    # per (s, aa, ab) like his per-visit decay): lr_cell =
    # lr * (1 + N(s,aa,ab)/tau)^(-pow).  Polynomial decay keeps
    # sum(lr) = inf (unlike the exponential halflife, which stops learning
    # at a fixed error floor) while still driving the noise floor to 0.
    count_lr_tau: float = 0.0   # 0 disables; counts-per-cell scale
    count_lr_pow: float = 0.85  # in (0.5, 1] for RM convergence
    eps_min: float = 0.0        # exploration floor under eps_halflife


def minimax_init(cfg: EnvConfig, key: jax.Array, n_envs: int) -> MinimaxQState:
    nS = tables.build_statespace(cfg).nS
    uniform = jnp.full((nS, N_ACTIONS), 1.0 / N_ACTIONS, jnp.float32)
    return MinimaxQState(
        q=jnp.zeros((nS, N_ACTIONS, N_ACTIONS), jnp.float32),
        v=jnp.zeros(nS, jnp.float32),
        pi_a=uniform, pi_b=uniform,
        env=batch.init(cfg, key, n_envs),
        step=jnp.int32(0),
        n=jnp.zeros((nS, N_ACTIONS, N_ACTIONS), jnp.float32),
    )


def _sample_mixed(pi_rows: jax.Array, u: jax.Array) -> jax.Array:
    """Sample actions from per-env mixed strategies [B, nA]."""
    cum = jnp.cumsum(pi_rows, axis=-1)
    return jnp.minimum(jnp.sum(cum <= u[:, None], axis=-1),
                       N_ACTIONS - 1).astype(jnp.int32)


def _minimax_step_engine(eng: _Engine, lcfg: MinimaxQConfig,
                         state: MinimaxQState,
                         psum_axis: Optional[str] = None
                         ) -> tuple[MinimaxQState, jax.Array]:
    obs = eng.observe(state.env)
    u = eng.uniforms(state.env, 2, 1).T
    nA = N_ACTIONS
    fstep = state.step.astype(jnp.float32)
    decay = lambda hl: jnp.where(hl > 0, 0.5 ** (fstep / jnp.maximum(hl, 1)),
                                 1.0)
    eps = jnp.maximum(lcfg.eps * decay(lcfg.eps_halflife), lcfg.eps_min)
    lr = lcfg.lr * decay(lcfg.lr_halflife)
    explore = eps / nA
    pa = state.pi_a[obs] * (1 - eps) + explore
    pb = state.pi_b[obs] * (1 - eps) + explore
    aa = _sample_mixed(pa, u[0])
    ab = _sample_mixed(pb, u[1])

    env2, reward_a, done, truncated, final_obs = eng.step(state.env, aa, ab)
    term = done | truncated
    cont = jnp.where(term, 0.0, 1.0)
    tgt = reward_a + lcfg.gamma * cont * state.v[final_obs]
    td = tgt - state.q[obs, aa, ab]

    # Count-normalized update (see iql_step): mean TD per visited cell.
    sum_td = jnp.zeros_like(state.q).at[obs, aa, ab].add(td)
    cnt = jnp.zeros_like(state.q).at[obs, aa, ab].add(1.0)
    if psum_axis is not None:
        sum_td = jax.lax.psum(sum_td, psum_axis)
        cnt = jax.lax.psum(cnt, psum_axis)
    n = state.n + cnt
    if lcfg.count_lr_tau > 0:
        lr = lr * (1.0 + n / lcfg.count_lr_tau) ** (-lcfg.count_lr_pow)
    q = state.q + lr * sum_td / jnp.maximum(cnt, 1.0)

    # Periodic batched re-solve of ALL state games (761 x 5x5 at once).
    def resolve(qv):
        value, x, y = solve_matrix_games(qv, iters=lcfg.solver_iters)
        return value, x, y

    do = (state.step % lcfg.resolve_every) == (lcfg.resolve_every - 1)
    v, pi_a, pi_b = jax.lax.cond(
        do, resolve, lambda qv: (state.v, state.pi_a, state.pi_b), q)

    new = MinimaxQState(q=q, v=v, pi_a=pi_a, pi_b=pi_b, env=env2,
                        step=state.step + 1, n=n)
    return new, jnp.abs(td).mean()


def minimax_step(cfg: EnvConfig, lcfg: MinimaxQConfig, state: MinimaxQState,
                 psum_axis: Optional[str] = None
                 ) -> tuple[MinimaxQState, jax.Array]:
    return _minimax_step_engine(_batch_engine(cfg), lcfg, state, psum_axis)


def minimax_train(cfg: EnvConfig, lcfg: MinimaxQConfig,
                  state: MinimaxQState, n_steps: int,
                  psum_axis: Optional[str] = None
                  ) -> tuple[MinimaxQState, jax.Array]:
    def body(carry, _):
        return minimax_step(cfg, lcfg, carry, psum_axis)

    return jax.lax.scan(body, state, None, length=n_steps)


def multigrid_minimax_init(cfgs, key: jax.Array,
                           n_envs: int) -> MinimaxQState:
    """Minimax-Q over a MIXED-geometry batch: the joint Q/V/pi tables are
    concatenated over variants, and the batched all-state game re-solve
    covers every variant's states in the same fused kernel."""
    codec = multigrid.build_codec(tuple(cfgs))
    nS = codec.nS_total
    uniform = jnp.full((nS, N_ACTIONS), 1.0 / N_ACTIONS, jnp.float32)
    return MinimaxQState(
        q=jnp.zeros((nS, N_ACTIONS, N_ACTIONS), jnp.float32),
        v=jnp.zeros(nS, jnp.float32),
        pi_a=uniform, pi_b=uniform,
        env=multigrid.init(list(cfgs), key, n_envs),
        step=jnp.int32(0),
        n=jnp.zeros((nS, N_ACTIONS, N_ACTIONS), jnp.float32),
    )


def multigrid_minimax_train(cfgs, lcfg: MinimaxQConfig,
                            state: MinimaxQState, n_steps: int,
                            psum_axis: Optional[str] = None
                            ) -> tuple[MinimaxQState, jax.Array]:
    """Fused minimax-Q training over a mixed-geometry batch (jit this)."""
    eng = _multigrid_engine(multigrid.build_codec(tuple(cfgs)))

    def body(carry, _):
        return _minimax_step_engine(eng, lcfg, carry, psum_axis)

    return jax.lax.scan(body, state, None, length=n_steps)


# ----------------------------------------------------------------------
# Alternating-turn Q-learning (turn-based minimax TD)
# ----------------------------------------------------------------------

class AltQState(NamedTuple):
    q: jax.Array        # [nS_alt, 5] — A-perspective value of mover actions
    env: object         # envs.soccer_alternating_env.AltEnvState
    step: jax.Array


class AltQConfig(NamedTuple):
    lr: float = 0.2
    gamma: float = 0.99
    eps: float = 0.2


def altq_init(cfg: EnvConfig, key: jax.Array, n_envs: int) -> AltQState:
    from ..envs import soccer_alternating_env as alt
    tb = alt.build_alt_tables(cfg)
    return AltQState(q=jnp.zeros((tb.nS, N_ACTIONS), jnp.float32),
                     env=alt.alt_init(cfg, key, n_envs),
                     step=jnp.int32(0))


def altq_step(cfg: EnvConfig, lcfg: AltQConfig, state: AltQState,
              psum_axis: Optional[str] = None,
              frozen_a=None, frozen_b=None) -> tuple[AltQState, jax.Array]:
    """One fused act/step/update on the alternating-turn game.

    Turn alternation makes the zero-sum TD rule LP-free (unlike
    minimax-Q's matrix-game solves): a single A-perspective table
    Q[s, a] over mover actions, with bootstrap value
    V(s') = max_a Q[s'] at A-to-move states and min_a Q[s'] at
    B-to-move states — Q-learning on the exact minimax Bellman operator
    of `alt_value_iteration`, so the fixpoint is the game's value.
    Behavior is eps-greedy for the mover (A argmax / B argmin).
    ``frozen_a``/``frozen_b`` clamp that side's moves to an int [nS]
    policy (no exploration on frozen turns) and switch the bootstrap at
    that side's next states from min/max to Q[s', frozen[s']] — the
    frozen side is not playing minimax, so the backup must follow its
    actual reply.  Frozen-turn rows keep being updated (with the clamped
    action) so that Q[s', frozen[s']] is learned and value propagates
    through opponent turns; the fixpoint is the best-response value of
    `alt_value_iteration(frozen_*=...)` — the alternating analogue of
    the reference's VI-vs-frozen-policy usage
    (soccer_simultaneous_env.py:518-530)."""
    from ..core import batch as corebatch
    from ..envs import soccer_alternating_env as alt
    tb = alt.build_alt_tables(cfg)
    r2d = jnp.asarray(tb.raw_to_dense)
    turn_of = jnp.asarray(tb.turn)
    st = state.env

    def dense_obs(s):
        return r2d[alt.alt_raw_encode(jnp, s.rows_a, s.cols_a, s.rows_b,
                                      s.cols_b, s.poss, s.turn, cfg)]

    obs = dense_obs(st)
    env_view = corebatch.EnvState(st.rows_a, st.cols_a, st.rows_b,
                                  st.cols_b, st.poss, st.t, st.n, st.key)
    u = corebatch.per_env_uniforms(env_view, 2, salt=1).T
    mover_is_a = st.turn == 0

    qrow = state.q[obs]
    greedy = jnp.where(mover_is_a, jnp.argmax(qrow, axis=-1),
                       jnp.argmin(qrow, axis=-1)).astype(jnp.int32)
    rand = (u[1] * N_ACTIONS).astype(jnp.int32) % N_ACTIONS
    a = jnp.where(u[0] < lcfg.eps, rand, greedy)
    fa = None if frozen_a is None else jnp.asarray(frozen_a)
    fb = None if frozen_b is None else jnp.asarray(frozen_b)
    if fa is not None:
        a = jnp.where(mover_is_a, fa[obs], a)
    if fb is not None:
        a = jnp.where(mover_is_a, a, fb[obs])

    mid, (reward_a, goal, trunc) = alt.alt_step(cfg, st, a, autoreset=False)
    final_obs = dense_obs(mid)
    term = goal | trunc
    cont = jnp.where(term, 0.0, 1.0)
    next_is_a = turn_of[final_obs] == 0
    # Bootstrap: minimax (max at A-to-move, min at B-to-move) — except a
    # frozen side, whose reply is known: V(s') = Q[s', frozen[s']].
    v_a = (state.q[final_obs].max(-1) if fa is None
           else state.q[final_obs, fa[final_obs]])
    v_b = (state.q[final_obs].min(-1) if fb is None
           else state.q[final_obs, fb[final_obs]])
    vnext = jnp.where(next_is_a, v_a, v_b)
    tgt = reward_a + lcfg.gamma * cont * vnext
    td = tgt - state.q[obs, a]

    # Count-normalized scatter update (see iql_step); frozen turns update
    # their clamped-action entry so the bootstrap above has real values.
    sum_td = jnp.zeros_like(state.q).at[obs, a].add(td)
    cnt = jnp.zeros_like(state.q).at[obs, a].add(1.0)
    if psum_axis is not None:
        sum_td = jax.lax.psum(sum_td, psum_axis)
        cnt = jax.lax.psum(cnt, psum_axis)
    q = state.q + lcfg.lr * sum_td / jnp.maximum(cnt, 1.0)

    env2 = alt.alt_reset_where(cfg, mid, term)
    new = AltQState(q=q, env=env2, step=state.step + 1)
    return new, jnp.abs(td).mean()


def altq_train(cfg: EnvConfig, lcfg: AltQConfig, state: AltQState,
               n_steps: int, psum_axis: Optional[str] = None,
               frozen_a=None, frozen_b=None) -> tuple[AltQState, jax.Array]:
    """`lax.scan` over fused alternating learner steps (jit this)."""
    def body(carry, _):
        return altq_step(cfg, lcfg, carry, psum_axis, frozen_a, frozen_b)

    return jax.lax.scan(body, state, None, length=n_steps)


def altq_greedy_policy(cfg: EnvConfig, q) -> jnp.ndarray:
    """Mover's greedy policy per dense state: argmax at A-to-move states,
    argmin at B-to-move states (A-perspective values)."""
    from ..envs import soccer_alternating_env as alt
    turn = jnp.asarray(alt.build_alt_tables(cfg).turn)
    q = jnp.asarray(q)
    return jnp.where(turn == 0, jnp.argmax(q, -1),
                     jnp.argmin(q, -1)).astype(jnp.int32)
