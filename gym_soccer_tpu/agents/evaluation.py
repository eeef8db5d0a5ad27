"""Markov-game solution tools: Shapley iteration and exploitability.

The reference's solution layer stops at single-agent DP against a FROZEN
opponent (planners.py).  For the actual zero-sum Markov game these tools
provide what Littman's minimax-Q is trying to learn:

* `shapley_iteration` — exact equilibrium value iteration for the
  simultaneous-move game:  V(s) <- value( Q_V(s, ., .) ) where
  Q_V(s,aa,ab) is the one-step backup and value() solves the 5x5 zero-sum
  matrix game (batched over all states on device);
* `best_response_value` — optimal counter-strategy value against a FIXED
  (possibly mixed) opponent policy, via single-agent VI on the induced MDP;
* `exploitability` — BR_A(pi_b) + BR_B(pi_a) at the initial state
  distribution; 0 exactly at a Nash equilibrium, and the standard measure
  of how far a learned self-play pair is from it.

All operate on the padded joint transition tensors [nS, 25, 36]
(core/tables.py) as dense contractions.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, N_ACTIONS
from ..core import tables
from .learners import solve_matrix_games


class JointTensors(NamedTuple):
    prob: jnp.ndarray     # [nS, 5, 5, K]
    next_dense: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    isd_probs: jnp.ndarray  # [nI]
    isd_obs: jnp.ndarray    # [nI]


def joint_tensors(cfg: EnvConfig, dtype=jnp.float32) -> JointTensors:
    tb = tables.build_tables(cfg)
    nS = tb.nS
    shape = (nS, N_ACTIONS, N_ACTIONS, tb.t_prob.shape[-1])
    return JointTensors(
        prob=jnp.asarray(tb.t_prob.reshape(shape), dtype),
        next_dense=jnp.asarray(tb.t_next_dense.reshape(shape)),
        reward=jnp.asarray(tb.t_reward.reshape(shape), dtype),
        done=jnp.asarray(tb.t_done.reshape(shape)),
        isd_probs=jnp.asarray(tb.isd_probs, dtype),
        isd_obs=jnp.asarray(tb.raw_to_dense[tb.isd_raw]),
    )


def _joint_backup(jt: JointTensors, V, gamma):
    """Q[s, aa, ab] = sum_k p * (r + gamma * V[ns] * !done)."""
    cont = jnp.where(jt.done, 0.0, V[jt.next_dense])
    return jnp.sum(jt.prob * (jt.reward + gamma * cont), axis=-1)


def shapley_iteration(cfg: EnvConfig, gamma: float = 0.99,
                      theta: float = 1e-6, max_iters: int = 2000,
                      solver_iters: int = 200, segment_sweeps: int = 0):
    """Exact (to solver tolerance) equilibrium solve of the zero-sum
    Markov game.  Returns (V, pi_a, pi_b, Q, iterations).

    Contraction: each sweep is one batched 5x5 matrix-game solve per state
    — 761 games in a single fused device call, vs. the classical
    per-state LP loop.

    ``segment_sweeps`` > 0 runs the sweeps as bounded jitted scans of
    that length with host-side convergence checks instead of one
    unbounded device while_loop, so each device program stays short and
    progress is visible between segments (used for 11x7, nS=11705)."""
    jt = joint_tensors(cfg)
    nS = jt.prob.shape[0]
    V0 = jnp.zeros(nS, jt.prob.dtype)

    if segment_sweeps > 0:
        import functools

        @functools.partial(jax.jit, static_argnames=("sweeps",))
        def seg(V, sweeps: int):
            def body(V, _):
                Q = _joint_backup(jt, V, gamma)
                v2, _, _ = solve_matrix_games(Q, iters=solver_iters)
                return v2, jnp.max(jnp.abs(v2 - V))
            V, deltas = jax.lax.scan(body, V, None, length=sweeps)
            return V, deltas[-1]

        V, cc = V0, 0
        while cc < max_iters:
            # clamp the final segment so the total never overshoots
            # max_iters (matches the while_loop edition's count)
            sweeps = min(segment_sweeps, max_iters - cc)
            V, d = seg(V, sweeps)
            cc += sweeps
            if float(np.asarray(d)) < theta:
                break
        Q = _joint_backup(jt, V, gamma)
        V, pi_a, pi_b = jax.jit(
            lambda q: solve_matrix_games(q, iters=solver_iters))(Q)
        return V, pi_a, pi_b, Q, jnp.int32(cc)

    def cond(carry):
        V, _, _, cc, delta = carry
        return (delta >= theta) & (cc < max_iters)

    def body(carry):
        V, _, _, cc, _ = carry
        Q = _joint_backup(jt, V, gamma)
        newV, x, y = solve_matrix_games(Q, iters=solver_iters)
        return newV, x, y, cc + 1, jnp.max(jnp.abs(newV - V))

    pi0 = jnp.full((nS, N_ACTIONS), 1.0 / N_ACTIONS, jt.prob.dtype)
    V, pi_a, pi_b, cc, _ = jax.lax.while_loop(
        cond, body, (V0, pi0, pi0, jnp.int32(0),
                     jnp.asarray(jnp.inf, jt.prob.dtype)))
    Q = _joint_backup(jt, V, gamma)
    return V, pi_a, pi_b, Q, cc


def best_response_value(cfg: EnvConfig, pi_opp, side: str,
                        gamma: float = 0.99, theta: float = 1e-6,
                        max_iters: int = 5000, segment_iters: int = 0):
    """Value of the optimal deterministic counter-strategy for `side`
    ('player_a' or 'player_b') against a fixed mixed opponent policy
    pi_opp [nS, 5].  Rewards are from `side`'s perspective (B maximizes
    -reward_a).  Returns (V_br [nS], pi_br [nS]).

    ``segment_iters`` > 0 runs bounded jitted scans with host-side
    convergence checks instead of one unbounded device while_loop (see
    shapley_iteration)."""
    jt = joint_tensors(cfg)
    pi_opp = jnp.asarray(pi_opp, jt.prob.dtype)

    def backup(V):
        q = _joint_backup(jt, V if side == "player_a" else -V, gamma)
        # A picks rows against B's mixture; B picks columns against A's.
        # HIGHEST: not TF32 on a GPU (exploitability is read at 1e-3).
        hi = jax.lax.Precision.HIGHEST
        if side == "player_a":
            return jnp.einsum("sab,sb->sa", q, pi_opp, precision=hi)
        return -jnp.einsum("sab,sa->sb", q, pi_opp, precision=hi)

    nS = jt.prob.shape[0]
    V0 = jnp.zeros(nS, jt.prob.dtype)

    if segment_iters > 0:
        import functools

        @functools.partial(jax.jit, static_argnames=("iters",))
        def seg(V, iters: int):
            def body(V, _):
                v2 = backup(V).max(axis=-1)
                return v2, jnp.max(jnp.abs(v2 - V))
            return jax.lax.scan(body, V, None, length=iters)

        V, cc = V0, 0
        while cc < max_iters:
            iters = min(segment_iters, max_iters - cc)  # no overshoot
            V, deltas = seg(V, iters)
            cc += iters
            if float(np.asarray(deltas[-1])) < theta:
                break
        return V, backup(V).argmax(axis=-1)

    def cond(carry):
        V, cc, delta = carry
        return (delta >= theta) & (cc < max_iters)

    def body(carry):
        V, cc, _ = carry
        newV = backup(V).max(axis=-1)
        return newV, cc + 1, jnp.max(jnp.abs(newV - V))

    V, cc, _ = jax.lax.while_loop(
        cond, body, (V0, jnp.int32(0), jnp.asarray(jnp.inf, jt.prob.dtype)))
    return V, backup(V).argmax(axis=-1)


def start_value(cfg: EnvConfig, V) -> float:
    """Expectation of V over the initial state distribution."""
    jt = joint_tensors(cfg)
    return float(jnp.sum(jt.isd_probs * V[jt.isd_obs]))


def exploitability(cfg: EnvConfig, pi_a, pi_b, gamma: float = 0.99,
                   segment_iters: int = 0) -> float:
    """BR_A(pi_b) + BR_B(pi_a) at the ISD; >= 0, and 0 iff (pi_a, pi_b)
    is a Nash equilibrium of the discounted game.  ``segment_iters``:
    see best_response_value."""
    va, _ = best_response_value(cfg, pi_b, "player_a", gamma,
                                segment_iters=segment_iters)
    vb, _ = best_response_value(cfg, pi_a, "player_b", gamma,
                                segment_iters=segment_iters)
    return start_value(cfg, va) + start_value(cfg, vb)
