"""Alternating-turn environment: turn-taking semantics, steal rule, goal
detection, slip statistics, batched-kernel/single-env agreement, and the
tabular layer (table builder + turn-based minimax VI + win-rate
contracts)."""
import jax
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.envs import SoccerAlternatingEnv
from gym_soccer_tpu.envs.soccer_alternating_env import (
    alt_init, alt_policy_rollout, alt_step, alt_transition,
    alt_value_iteration, build_alt_tables)

NOOP, NORTH, SOUTH, EAST, WEST = 0, 1, 2, 3, 4


@pytest.fixture
def env():
    e = SoccerAlternatingEnv(width=5, height=4, slip_prob=0.0)
    e.reset()
    return e


def test_turn_alternates(env):
    assert env.current_player == 'player_a'
    env.step(NOOP)
    assert env.current_player == 'player_b'
    env.step(NOOP)
    assert env.current_player == 'player_a'


def test_only_mover_moves(env):
    env.state = (1, 2, 2, 4, 0, 0)  # A's turn
    env.step(EAST)
    assert env.state[:4] == (1, 3, 2, 4), "only A moved"
    env.step(WEST)  # now B's turn
    assert env.state[:4] == (1, 3, 2, 3), "only B moved"


def test_steal_on_contact(env):
    env.state = (1, 2, 1, 3, 0, 0)  # A with ball, B adjacent, A's turn
    env.step(EAST)
    xa, ya, xb, yb, p, turn = env.state
    assert (xa, ya, xb, yb) == (1, 2, 1, 3), "A bounces back"
    assert p == 1, "possession stolen by B"
    assert turn == 1


def test_goal_scoring(env):
    env.state = (1, 5, 3, 1, 0, 0)  # A with ball at goal mouth, A's turn
    obs, rew, done, trunc, info = env.step(EAST)
    assert done['player_a'] and rew['player_a'] == 1.0 \
        and rew['player_b'] == -1.0


def test_own_goal(env):
    env.state = (2, 1, 3, 5, 0, 0)
    obs, rew, done, trunc, info = env.step(WEST)
    assert done['player_a'] and rew['player_a'] == -1.0


def test_no_goal_without_possession(env):
    env.state = (1, 5, 3, 1, 1, 0)  # A at goal mouth WITHOUT ball
    obs, rew, done, trunc, info = env.step(EAST)
    assert not done['player_a']
    assert env.state[:2] == (1, 5), "goal wall bounces A back"


def test_truncation(env):
    for _ in range(100):
        env.step(NOOP)
    assert env.needs_reset


def test_egocentric_observations(env):
    env.state = (1, 2, 2, 4, 1, 0)
    obs = env._obs()
    assert obs['player_a'] == (1, 2, 2, 4, 0)
    assert obs['player_b'] == (2, 4, 1, 2, 1)


def test_slip_statistics():
    env = SoccerAlternatingEnv(width=5, height=4, slip_prob=0.2, seed=1)
    n, slipped = 20000, 0
    for _ in range(n):
        env.reset()
        env.state = (1, 2, 3, 4, 0, 0)
        env.step(EAST)
        if env.state[:2] != (1, 3):
            slipped += 1
    assert 0.18 <= slipped / n <= 0.22


def test_batched_kernel_matches_single_env_semantics():
    cfg = EnvConfig(5, 4, 0.0)
    B = 32
    st = jax.jit(lambda k: alt_init(cfg, k, B))(jax.random.key(0))
    step = jax.jit(lambda s, a: alt_step(cfg, s, a, autoreset=False))
    # force a known state in all lanes: A's turn, adjacent, A has ball
    full = lambda v: np.full(B, v, dtype=np.int32)
    st = st._replace(rows_a=full(1), cols_a=full(2), rows_b=full(1),
                     cols_b=full(3), poss=full(0), turn=full(0))
    st2, (rew, done, trunc) = step(st, full(EAST))
    assert (np.asarray(st2.cols_a) == 2).all(), "steal rule bounces A"
    assert (np.asarray(st2.poss) == 1).all()
    assert (np.asarray(st2.turn) == 1).all()

    # pure transition function agreement with the single-env step
    env = SoccerAlternatingEnv(width=5, height=4, slip_prob=0.0)
    env.reset()
    env.state = (1, 2, 1, 3, 0, 0)
    env.step(EAST)
    got = alt_transition(np, 1, 2, 1, 3, 0, 0, EAST, 1, 0, cfg)
    assert tuple(int(v) for v in got) == env.state


# ----------------------------------------------------------------------
# Tabular layer: table builder, minimax VI, win-rate contracts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("slip", [0.0, 0.2])
def test_alt_tables_are_proper_distributions(slip):
    tb = build_alt_tables(EnvConfig(5, 4, slip))
    assert tb.nS == 1521  # 760 reachable simultaneous states x 2 turns + 1
    np.testing.assert_allclose(tb.t_prob.sum(axis=-1), 1.0, rtol=0, atol=0)
    assert (tb.t_next_dense >= 0).all()
    assert (tb.t_next_dense < tb.nS).all()
    # terminal row is absorbing with zero reward
    assert tb.t_done[0].all() and (tb.t_next_dense[0] == 0).all()
    assert (tb.t_reward[0] == 0.0).all()
    # rewards only on terminal transitions, and only +-1
    r = tb.t_reward[tb.t_prob > 0]
    d = tb.t_done[tb.t_prob > 0]
    assert set(np.unique(r)) <= {-1.0, 0.0, 1.0}
    assert (r[~d] == 0.0).all()


def test_alt_tables_match_env_sampling():
    """The table's outcome distribution for an injected state/action is
    what the facade's step actually samples (2000 trials, slip 0.2)."""
    cfg = EnvConfig(5, 4, 0.2)
    tb = build_alt_tables(cfg)
    env = SoccerAlternatingEnv(width=5, height=4, slip_prob=0.2, seed=7)
    env.reset()
    state = (1, 2, 3, 4, 0, 0)
    s = int(tb.raw_to_dense[
        ((((state[0] * cfg.W + state[1]) * cfg.H + state[2]) * cfg.W
          + state[3]) * 2 + state[4]) * 2 + state[5]])
    a = EAST
    want = {}
    for k in range(3):
        if tb.t_prob[s, a, k] > 0:
            ns = int(tb.t_next_dense[s, a, k])
            want[ns] = want.get(ns, 0.0) + float(tb.t_prob[s, a, k])
    got = {}
    n = 2000
    for _ in range(n):
        env.reset()
        env.state = state
        env.step(a)
        ns = int(tb.raw_to_dense[
            ((((env.state[0] * cfg.W + env.state[1]) * cfg.H + env.state[2])
              * cfg.W + env.state[3]) * 2 + env.state[4]) * 2 + env.state[5]])
        got[ns] = got.get(ns, 0) + 1
    assert set(got) == set(want)
    for ns, p in want.items():
        assert abs(got[ns] / n - p) < 0.03


def test_alt_minimax_vi_slip0_is_a_draw():
    """At slip 0 optimal play never concedes: the steal rule hands the
    ball TO the invaded player, so a standing ball-holder cannot be
    dispossessed and perfect defense holds forever -> game value 0."""
    tb = build_alt_tables(EnvConfig(5, 4, 0.0))
    pi, V, Q, cc = alt_value_iteration(tb)
    from gym_soccer_tpu.core.tables import build_isd
    probs, raws = build_isd(EnvConfig(5, 4, 0.0))
    for r in raws:
        assert abs(V[tb.raw_to_dense[int(r) * 2]]) < 1e-9
    # minimax self-play: no goals at all, every episode truncates
    w, l, tr = alt_policy_rollout(EnvConfig(5, 4, 0.0), tb.raw_to_dense,
                                  pi, pi, batch=128, steps=300, seed=1)
    assert w == 0 and l == 0 and tr > 0


def test_alt_best_response_beats_random_opponent():
    """Win-rate contract (alternating analogue of the reference's VI
    >95%-vs-random contract, test_general.py:381): best response to a
    frozen random policy wins every completed episode."""
    cfg = EnvConfig(5, 4, 0.2)
    tb = build_alt_tables(cfg)
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi, V, Q, cc = alt_value_iteration(tb, frozen_b=randpol)
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi, randpol,
                                  batch=256, steps=400, seed=3)
    episodes = w + l + tr
    assert l == 0
    assert w / episodes > 0.95


def test_alt_best_response_never_loses_to_stand():
    """Vs an all-NOOP opponent the best response never concedes and wins
    every start where it holds the ball (a standing holder is untouchable
    under the steal rule, so opponent-possession starts can be draws)."""
    cfg = EnvConfig(5, 4, 0.0)
    tb = build_alt_tables(cfg)
    stand = np.zeros(tb.nS, dtype=np.int32)
    pi, V, Q, cc = alt_value_iteration(tb, frozen_b=stand)
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi, stand,
                                  batch=256, steps=400, seed=2)
    assert l == 0 and w > 0
    # every A-possession ISD start is a certain win in the table values
    from gym_soccer_tpu.core.tables import build_isd
    probs, raws = build_isd(cfg)
    for r in raws:
        xa_fields = tb.fields[tb.raw_to_dense[int(r) * 2]]
        if xa_fields[4] == 0:  # A holds the ball
            assert V[tb.raw_to_dense[int(r) * 2]] > 0.5


def test_alt_minimax_policy_is_safe_vs_any_opponent():
    """The minimax policy guarantees at least the game value: it never
    loses a completed episode to an arbitrary frozen opponent."""
    cfg = EnvConfig(5, 4, 0.2)
    tb = build_alt_tables(cfg)
    pi, V, Q, cc = alt_value_iteration(tb)
    for seed in (0, 1):
        randpol = np.random.RandomState(seed).randint(
            0, 5, tb.nS).astype(np.int32)
        w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi, randpol,
                                      batch=128, steps=300, seed=seed + 10)
        assert l == 0
        assert w > 0


def test_alt_P_dict_view(env):
    P = env.P
    assert set(P) == set(range(env.nS))
    for a, lst in P[1].items():
        assert len(lst) == 1  # slip 0: single deterministic outcome
        p, ns, r, d = lst[0]
        assert p == 1.0 and 0 <= ns < env.nS
    s = env.state_space[(1, 2, 2, 4, 0, 0)]
    assert tuple(int(v) for v in env.tables.fields[s]) == (1, 2, 2, 4, 0, 0)


def test_alt_vi_jax_matches_numpy():
    """Jitted minimax VI agrees with the float64 host sweep (x64 CPU)."""
    import jax.numpy as jnp
    from gym_soccer_tpu.envs.soccer_alternating_env import (
        alt_value_iteration_jax_jit)
    tb = build_alt_tables(EnvConfig(5, 4, 0.2))
    pi, V, Q, cc = alt_value_iteration(tb, theta=1e-8)
    with jax.enable_x64(True):
        pj, Vj, Qj, ccj = alt_value_iteration_jax_jit(
            jnp.asarray(tb.t_prob), jnp.asarray(tb.t_next_dense),
            jnp.asarray(tb.t_reward), jnp.asarray(tb.t_done),
            jnp.asarray(tb.turn), theta=1e-8)
    np.testing.assert_allclose(np.asarray(Vj), V, atol=1e-6)
    # identical greedy values (argmax ties may differ; values must not)
    idx = np.arange(tb.nS)
    np.testing.assert_allclose(np.asarray(Qj)[idx, np.asarray(pj)],
                               Q[idx, pi], atol=1e-6)
