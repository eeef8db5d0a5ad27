"""Alternating-turn game end-to-end: solve, learn, and play.

The reference's turn-taking prototype (soccer_alternating_env.py) exposes
a P table and was meant to be solvable; this demo exercises the full
batched, on-device version of that capability:

1. build the tabular dynamics (`build_alt_tables`, vectorized);
2. solve the zero-sum turn game EXACTLY with turn-based minimax VI
   (LP-free: max at A-to-move states, min at B-to-move states);
3. train the turn-based Q-learner (`agents.learners.altq_*`) in batched
   self-play and report its value error against the exact solution;
4. play batched closed-loop matches: minimax vs itself, and a
   best-response policy vs a frozen random opponent.

Run: python examples/alternating_demo.py [--quick]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from gym_soccer_tpu.config import EnvConfig  # noqa: E402
from gym_soccer_tpu.agents import learners  # noqa: E402
from gym_soccer_tpu.envs.soccer_alternating_env import (  # noqa: E402
    alt_policy_rollout, alt_value_iteration, build_alt_tables)
from gym_soccer_tpu.utils.profiling import phase, phase_report, log_json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="shorter learner run (CI smoke)")
    ap.add_argument("--fused", action="store_true",
                    help="train with the fused Triton kernel "
                         "(ops/altq_kernel; needs a GPU)")
    args = ap.parse_args()

    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)

    with phase("table_build", sync=False):
        tb = build_alt_tables(cfg)
    log_json(event="tables", nS=tb.nS)

    with phase("minimax_vi", sync=False):
        pi_star, v_star, _, sweeps = alt_value_iteration(tb)
    log_json(event="solved", sweeps=sweeps,
             v_abs_max=round(float(np.abs(v_star).max()), 4))

    # --- batched Q-learning self-play vs the exact solution -------------
    if args.fused:
        from gym_soccer_tpu.ops.altq_kernel import fused_altq_train
        n_chunks = 60 if args.quick else 400
        with phase("altq_train_fused", sync=False):
            q, _ = fused_altq_train(
                cfg, batch=8192 if args.quick else 65536,
                n_chunks=n_chunks, chunk_len=32, lr=1.0, eps=0.25,
                eps_min=0.1, eps_halflife=300_000,
                lr_anneal_start=n_chunks // 2, lr_anneal_tau=25.0,
                lr_anneal_pow=1.5, seed=1)
        q = np.asarray(q)
        env_steps = (8192 if args.quick else 65536) * n_chunks * 32
    else:
        schedule = ([(0.25, 0.3, 3000)] if args.quick else
                    [(0.25, 0.3, 20000), (0.1, 0.2, 20000),
                     (0.03, 0.1, 20000)])
        st = jax.jit(lambda k: learners.altq_init(cfg, k, 256))(
            jax.random.key(0))
        with phase("altq_train", sync=False):
            for lr, eps, n in schedule:
                lcfg = learners.AltQConfig(lr=lr, gamma=0.99, eps=eps)
                train = jax.jit(
                    lambda s, c=lcfg, n=n: learners.altq_train(cfg, c, s, n))
                st, _ = jax.block_until_ready(train(st))
        q = np.asarray(st.q)
        env_steps = sum(n for _, _, n in schedule) * 256
    v_learned = np.where(tb.turn == 0, q.max(-1), q.min(-1))
    err = np.abs(v_learned - v_star)
    log_json(event="learned", env_steps=env_steps,
             v_err_mean=round(float(err.mean()), 4),
             v_err_max=round(float(err.max()), 4))

    # --- closed-loop matches --------------------------------------------
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi_star, pi_star,
                                  batch=256, steps=400, seed=1)
    log_json(event="minimax_selfplay", wins_a=w, wins_b=l, truncations=tr)

    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    pi_br, _, _, _ = alt_value_iteration(tb, frozen_b=randpol)
    w, l, tr = alt_policy_rollout(cfg, tb.raw_to_dense, pi_br, randpol,
                                  batch=256, steps=400, seed=2)
    log_json(event="best_response_vs_random", wins=w, losses=l,
             truncations=tr,
             win_rate=round(w / max(w + l + tr, 1), 4))

    phase_report()


if __name__ == "__main__":
    main()
