"""Markov-game solution layer: Shapley iteration, best response,
exploitability, and the minimax-Q convergence contract."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.agents import evaluation as ev, learners

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
UNIFORM = jnp.full((761, 5), 0.2, jnp.float32)


@pytest.fixture(scope="module")
def equilibrium():
    return jax.jit(lambda: ev.shapley_iteration(
        CFG, theta=1e-5, solver_iters=400))()


def test_shapley_game_value_symmetric(equilibrium):
    V, pa, pb, Q, cc = equilibrium
    # zero-sum symmetric game: the value at the (mirror-symmetric) ISD is 0
    assert abs(ev.start_value(CFG, V)) < 5e-3
    assert float(jnp.abs(V).max()) <= 1.0 + 1e-3
    assert int(cc) > 10
    # V[0] is the absorbed terminal class
    assert abs(float(V[0])) < 1e-4


def test_equilibrium_unexploitable(equilibrium):
    V, pa, pb, Q, cc = equilibrium
    e = ev.exploitability(CFG, pa, pb)
    assert 0 <= e < 0.05, e


def test_segmented_solvers_match_whileloop():
    """The bounded-dispatch (segmented) editions of shapley_iteration and
    best_response_value must reproduce the unbounded while_loop results —
    same backups, only the stopping check moves host-side (iteration
    counts may overshoot by up to a segment, so compare to theta
    tolerance).  The segmented mode keeps each device program bounded at
    11x7 scale."""
    gamma, theta = 0.9, 1e-5
    V1, pa1, pb1, _, _ = ev.shapley_iteration(CFG, gamma=gamma,
                                              theta=theta, max_iters=400)
    V2, pa2, pb2, _, _ = ev.shapley_iteration(CFG, gamma=gamma,
                                              theta=theta, max_iters=400,
                                              segment_sweeps=20)
    np.testing.assert_allclose(np.asarray(V1), np.asarray(V2), atol=5e-4)
    b1, p1 = ev.best_response_value(CFG, pa1, "player_b", gamma=gamma,
                                    theta=theta)
    b2, p2 = ev.best_response_value(CFG, pa1, "player_b", gamma=gamma,
                                    theta=theta, segment_iters=50)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), atol=5e-4)


def test_uniform_policies_exploitable():
    e = ev.exploitability(CFG, UNIFORM, UNIFORM)
    assert e > 1.0, e


def test_best_response_dominates_fixed_opponent(equilibrium):
    """BR value vs uniform must beat the equilibrium value from the start
    states (a uniform opponent is strictly weaker)."""
    V_eq, pa, pb, *_ = equilibrium
    v_br, pi_br = ev.best_response_value(CFG, UNIFORM, "player_a")
    assert ev.start_value(CFG, v_br) > ev.start_value(CFG, V_eq) + 0.3


def test_minimax_q_reduces_exploitability():
    st = jax.jit(lambda k: learners.minimax_init(CFG, k, 1024))(
        jax.random.key(0))
    lcfg = learners.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=32,
                                   solver_iters=200, lr_halflife=4000,
                                   eps_halflife=6000)
    train = jax.jit(lambda s: learners.minimax_train(CFG, lcfg, s, 5000))
    e0 = ev.exploitability(CFG, st.pi_a, st.pi_b)
    st, _ = jax.block_until_ready(train(st))
    e1 = ev.exploitability(CFG, st.pi_a, st.pi_b)
    assert np.isfinite(float(jnp.abs(st.q).max()))
    assert float(jnp.abs(st.v).max()) <= 1.5
    assert e1 < 0.6 * e0, (e0, e1)


def test_equilibrium_policy_dominates_random_in_rollouts(equilibrium):
    """Game-theoretic analogue of the reference's VI win-rate contracts
    (test_general.py:344-381): the Shapley-equilibrium mixture, PLAYED in
    real batched rollouts against a uniform-random opponent, must win
    >95% of decided episodes with mean episode reward >0.9.  Exercises
    evaluation + engine end-to-end (measured: 99.3% over 72k episodes)."""
    import jax.numpy as jnp
    from gym_soccer_tpu.core import batch

    _, pa, _, _, _ = equilibrium
    pa = jnp.asarray(pa)
    st = jax.jit(lambda k: batch.init(CFG, k, 1024))(jax.random.key(0))

    def policy_fn(obs, i):
        k = jax.random.fold_in(jax.random.key(42), i)
        u = jax.random.uniform(k, (2, obs.shape[0]))
        cum = jnp.cumsum(pa[obs], axis=-1)
        aa = jnp.clip(jnp.sum(cum < u[0][:, None], axis=-1),
                      0, 4).astype(jnp.int32)
        return aa, jnp.clip((u[1] * 5).astype(jnp.int32), 0, 4)

    st, acc = jax.jit(lambda s: batch.rollout_stats(CFG, s, policy_fn, 300))(st)
    g, t, r = int(acc.goals), int(acc.truncs), float(acc.reward_sum)
    wins = (g + r) / 2           # reward_sum = wins - losses; goals = wins + losses
    assert g > 1000
    assert wins / g > 0.95, (wins, g)
    assert r / (g + t) > 0.9, (r, g, t)
