"""Learner correctness: matrix-game solver on known games, IQL/minimax-Q
training progress, and sharded-vs-single-device training equivalence."""
import jax
import jax.numpy as jnp
import numpy as np

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.agents import learners
from gym_soccer_tpu.core import batch
from gym_soccer_tpu.parallel import mesh as pmesh

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def test_matrix_game_solver_known_games():
    # Matching pennies: value 0, both mix 50/50.
    mp = jnp.asarray([[1.0, -1.0], [-1.0, 1.0]])
    v, x, y = learners.solve_matrix_games(mp, iters=400)
    assert abs(float(v)) < 0.02
    assert np.allclose(np.asarray(x), 0.5, atol=0.05)
    assert np.allclose(np.asarray(y), 0.5, atol=0.05)

    # Rock-paper-scissors: value 0, uniform thirds.
    rps = jnp.asarray([[0.0, -1.0, 1.0], [1.0, 0.0, -1.0], [-1.0, 1.0, 0.0]])
    v, x, y = learners.solve_matrix_games(rps, iters=400)
    assert abs(float(v)) < 0.02
    assert np.allclose(np.asarray(x), 1 / 3, atol=0.05)

    # Dominant strategy: row 1 dominates; value = min of that row.
    dom = jnp.asarray([[0.0, 0.0], [3.0, 1.0]])
    v, x, y = learners.solve_matrix_games(dom, iters=400)
    assert abs(float(v) - 1.0) < 0.05
    assert float(x[1]) > 0.95

    # Batched: all three at once (padded to 3x3)
    def pad(m):
        out = np.full((3, 3), -10.0)  # strictly dominated padding rows/cols
        out[:m.shape[0], :m.shape[1]] = m
        out[:, m.shape[1]:] = 10.0    # huge payoff: col player avoids
        out[m.shape[0]:, :] = -10.0   # row player avoids
        return out

    M = jnp.asarray(np.stack([pad(np.asarray(mp)), np.asarray(rps)]))
    v, x, y = learners.solve_matrix_games(M, iters=400)
    assert np.allclose(np.asarray(v), [0.0, 0.0], atol=0.05)


def test_iql_learns_to_score():
    """Self-play IQL for 3000 fused steps: TD error should drop and the
    learned greedy policies should reach goals reliably (both players
    actively trying beats the uniform-random baseline episode length)."""
    st = jax.jit(lambda k: learners.iql_init(CFG, k, 512))(jax.random.key(0))
    lcfg = learners.IQLConfig(lr=0.5, eps=0.25)
    train = jax.jit(lambda s: learners.iql_train(CFG, lcfg, s, 6000))
    st, td = jax.block_until_ready(train(st))
    td = np.asarray(td)
    assert np.abs(np.asarray(st.q_a)).max() > 0.3, "Q never moved"
    # evaluate greedy-vs-greedy: mean |reward| per episode ~ frequent goals
    qa = st.q_a
    qb = st.q_b
    pol = lambda obs, i: (jnp.argmax(qa[obs], -1).astype(jnp.int32),
                          jnp.argmax(qb[obs], -1).astype(jnp.int32))
    est = jax.jit(lambda s: batch.rollout(CFG, s, pol, 200))
    env0 = jax.jit(lambda k: batch.init(CFG, k, 512))(jax.random.key(3))
    _, out = est(env0)
    goals = np.asarray(out.done).sum()
    truncs = np.asarray(out.truncated).sum()
    assert goals > truncs, (
        f"greedy self-play should usually end in goals: {goals} goals vs "
        f"{truncs} truncations")


def test_minimax_q_value_bounded_and_mixed():
    st = jax.jit(lambda k: learners.minimax_init(CFG, k, 512))(
        jax.random.key(0))
    lcfg = learners.MinimaxQConfig(lr=0.2, resolve_every=16)
    train = jax.jit(lambda s: learners.minimax_train(CFG, lcfg, s, 2000))
    st, td = jax.block_until_ready(train(st))
    v = np.asarray(st.v)
    assert np.all(np.abs(v) <= 1.0 + 1e-3), "values must stay in [-1, 1]"
    assert np.abs(v).max() > 0.05, "values never moved"
    pi = np.asarray(st.pi_a)
    assert np.allclose(pi.sum(-1), 1.0, atol=1e-3)
    assert (pi >= -1e-6).all()


def test_ql_vs_frozen_opponent_wins():
    """Frozen-opponent mode (the reference's single-agent mode, batched):
    Q-learning against a frozen random B must reach a high win rate —
    the learned analogue of the reference's >95% VI contract
    (test_general.py:344-381)."""
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    frozen_b = get_random_policy_array(761, 5, seed=42)
    st = jax.jit(lambda k: learners.iql_init(CFG, k, 512))(jax.random.key(0))
    lcfg = learners.IQLConfig(lr=0.5, eps=0.25)
    train = jax.jit(lambda s: learners.iql_train(CFG, lcfg, s, 8000,
                                                 frozen_b=frozen_b))
    st, _ = jax.block_until_ready(train(st))
    assert float(jnp.abs(st.q_b).max()) == 0.0, "frozen side must not learn"

    qa, fb = st.q_a, jnp.asarray(frozen_b)
    pol = lambda obs, i: (jnp.argmax(qa[obs], -1).astype(jnp.int32), fb[obs])
    env0 = jax.jit(lambda k: batch.init(CFG, k, 512))(jax.random.key(9))
    _, out = jax.jit(lambda s: batch.rollout(CFG, s, pol, 300))(env0)
    done = np.asarray(out.done)
    wins = ((np.asarray(out.reward_a) > 0) & done).sum()
    eps = (done | np.asarray(out.truncated)).sum()
    assert wins / eps > 0.9, f"win rate {wins / eps:.3f}"


def test_sharded_training_matches_single_device():
    """Delta-psum DP training on the 8-device mesh must produce identical
    Q-tables to single-device training on the same global batch."""
    n_envs, steps = 64, 50
    lcfg = learners.IQLConfig()
    st = jax.jit(lambda k: learners.iql_init(CFG, k, n_envs))(
        jax.random.key(0))
    single = jax.jit(lambda s: learners.iql_train(CFG, lcfg, s, steps))
    s1, _ = jax.block_until_ready(single(st))

    m = pmesh.env_mesh()
    train = pmesh.sharded_iql_train_fn(CFG, lcfg, m, steps)
    sN, _ = jax.block_until_ready(train(st))
    np.testing.assert_allclose(np.asarray(s1.q_a), np.asarray(sN.q_a),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1.q_b), np.asarray(sN.q_b),
                               rtol=0, atol=1e-5)


def test_alternating_q_learner_converges_to_minimax_values():
    """Turn-based Q-learning (agents.learners.altq_*) is Q-learning on the
    exact minimax Bellman operator of alt_value_iteration: an annealed
    self-play run approaches the game's exact values, and its greedy
    policy wins >95% of completed episodes vs a frozen random opponent."""
    from gym_soccer_tpu.envs.soccer_alternating_env import (
        alt_policy_rollout, alt_value_iteration, build_alt_tables)
    cfg = EnvConfig(5, 4, 0.2)
    tb = build_alt_tables(cfg)
    _, V_star, _, _ = alt_value_iteration(tb)

    st = jax.jit(lambda k: learners.altq_init(cfg, k, 256))(jax.random.key(0))
    for lr, eps, n in [(0.25, 0.3, 15000), (0.08, 0.15, 15000)]:
        lcfg = learners.AltQConfig(lr=lr, gamma=0.99, eps=eps)
        train = jax.jit(lambda s, c=lcfg: learners.altq_train(cfg, c, s, n))
        st, td = jax.block_until_ready(train(st))

    q = np.asarray(st.q)
    V_l = np.where(tb.turn == 0, q.max(-1), q.min(-1))
    err = np.abs(V_l - np.asarray(V_star))
    assert err.mean() < 0.08, f"mean |V - V*| {err.mean():.3f}"

    pol = np.asarray(learners.altq_greedy_policy(cfg, st.q))
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pol, randpol,
                                  batch=128, steps=300, seed=6)
    assert w > 0 and w / (w + l) > 0.95


def test_alternating_q_learner_frozen_opponent():
    """Freezing one side clamps its moves (no exploration on its turns),
    bootstraps B-to-move next states with Q[s', frozen[s']] instead of
    min, and keeps updating the clamped entry — so value propagates
    through opponent turns and the learner approaches the exact
    best-response values of alt_value_iteration(frozen_b=...)."""
    from gym_soccer_tpu.envs.soccer_alternating_env import (
        alt_value_iteration, build_alt_tables)
    cfg = EnvConfig(5, 4, 0.2)
    tb = build_alt_tables(cfg)
    stand = np.zeros(tb.nS, dtype=np.int32)
    _, V_br, _, _ = alt_value_iteration(tb, frozen_b=stand)

    st = jax.jit(lambda k: learners.altq_init(cfg, k, 256))(jax.random.key(1))
    for lr, eps, n in [(0.25, 0.3, 12000), (0.08, 0.15, 12000)]:
        lcfg = learners.AltQConfig(lr=lr, gamma=0.99, eps=eps)
        train = jax.jit(lambda s, c=lcfg: learners.altq_train(
            cfg, c, s, n, frozen_b=stand))
        st, _ = jax.block_until_ready(train(st))

    q = np.asarray(st.q)
    turn = np.asarray(tb.turn)
    # B turns never explore: only the clamped (NOOP) column is touched.
    b_rows = (turn == 1)
    b_rows[0] = False
    assert (q[b_rows][:, 1:] == 0.0).all()
    assert (q[b_rows][:, 0] != 0.0).any(), "frozen rows must learn"
    # The learned values track the exact best response on the states the
    # behavior distribution visits (a standing B pins most B-positions
    # out of reach; unvisited rows legitimately stay 0).  With a severed
    # bootstrap (the pre-fix bug) this error stays ~0.4.
    visited = (q != 0.0).any(-1)
    visited[0] = False
    assert visited.sum() > 50, "behavior must visit a real state set"
    V_l = np.where(turn == 0, q.max(-1), q[np.arange(tb.nS), stand])
    err = np.abs(V_l - np.asarray(V_br))[visited]
    assert err.mean() < 0.08, f"mean |V - V_br| {err.mean():.3f}"
    # And the learned greedy policy must actually beat the frozen
    # opponent (value propagated back to the start states).
    from gym_soccer_tpu.envs.soccer_alternating_env import alt_policy_rollout
    pol = np.asarray(learners.altq_greedy_policy(cfg, st.q))
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pol, stand,
                                  batch=128, steps=300, seed=3)
    assert w > 0 and w / max(w + l, 1) > 0.95, (w, l, tr)


def test_alternating_sharded_training_matches_single_device():
    """Delta-psum DP training of the alternating learner on the 8-device
    mesh produces the same Q-table as single-device on the same batch."""
    cfg = EnvConfig(5, 4, 0.2)
    n_envs, steps = 64, 50
    lcfg = learners.AltQConfig()
    st = jax.jit(lambda k: learners.altq_init(cfg, k, n_envs))(
        jax.random.key(0))
    single = jax.jit(lambda s: learners.altq_train(cfg, lcfg, s, steps))
    s1, _ = jax.block_until_ready(single(st))

    m = pmesh.env_mesh()
    train = pmesh.sharded_altq_train_fn(cfg, lcfg, m, steps)
    sN, _ = jax.block_until_ready(train(st))
    np.testing.assert_allclose(np.asarray(s1.q), np.asarray(sN.q),
                               rtol=0, atol=1e-5)


def _rm_plus_f64(M, iters):
    """The solver's Regret Matching+ iteration in float64 numpy."""
    nA = M.shape[-1]
    rx = np.zeros(M.shape[:-1])
    ry = np.zeros(M.shape[:-1])
    sx = np.zeros_like(rx)
    sy = np.zeros_like(ry)

    def normalize(r):
        s = r.sum(-1, keepdims=True)
        return np.where(s > 0, r / np.maximum(s, 1e-30), 1.0 / nA)

    for t in range(iters):
        x, y = normalize(rx), normalize(ry)
        my = np.einsum('...ij,...j->...i', M, y)
        xm = np.einsum('...i,...ij->...j', x, M)
        vx = np.einsum('...i,...i->...', x, my)[..., None]
        rx = np.maximum(rx + (my - vx), 0.0)
        ry = np.maximum(ry + (vx - xm), 0.0)
        sx, sy = sx + (t + 1) * x, sy + (t + 1) * y
    x = sx / sx.sum(-1, keepdims=True)
    y = sy / sy.sum(-1, keepdims=True)
    return np.einsum('...i,...ij,...j->...', x, M, y), x, y


def test_matrix_game_solver_matches_float64():
    """The f32 solve (explicit multiply-adds, so no TF32 on a GPU) tracks
    the same RM+ iteration run in float64 numpy.  Tolerance: RM+'s
    truncation of regrets at zero is a branch, so f32 rounding can send a
    game down another path; each run's value is then still within its
    own duality gap of the exact value, so |v32 - v64| <= gap32 + gap64.
    Where no branch flips, the runs agree to f32 rounding: the median
    difference stays below 1e-5, two orders under the 1e-3 level
    exploitability is read at (TF32 would put most games near 1e-3).
    Weak duality against an exact LP checks the brackets themselves."""
    from scipy.optimize import linprog
    rng = np.random.RandomState(11)
    M = rng.uniform(-1, 1, (64, 5, 5))
    v, x, y = jax.jit(lambda m: learners.solve_matrix_games(m, iters=400))(
        jnp.asarray(M, jnp.float32))
    v64, x64, y64 = _rm_plus_f64(M, 400)
    v, x, y = (np.asarray(a, np.float64) for a in (v, x, y))

    def gap(x, y):
        return (np.einsum('kij,kj->ki', M, y).max(-1)
                - np.einsum('ki,kij->kj', x, M).min(-1))
    diff = np.abs(v - v64)
    assert (diff <= gap(x, y) + gap(x64, y64) + 1e-5).all()
    assert np.median(diff) < 1e-5, np.median(diff)
    for k in range(8):   # exact value: max_x min_j (x^T M)_j by LP
        A = M[k]
        res = linprog(c=np.r_[np.zeros(5), -1.0],
                      A_ub=np.c_[-A.T, np.ones(5)], b_ub=np.zeros(5),
                      A_eq=np.r_[np.ones(5), 0.0][None], b_eq=[1.0],
                      bounds=[(0, None)] * 5 + [(None, None)])
        lo, hi = (x[k] @ A).min(), (A @ y[k]).max()
        assert lo - 1e-6 <= -res.fun <= hi + 1e-6, (k, lo, -res.fun, hi)
