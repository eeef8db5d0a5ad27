"""Flagship workload: minimax-Q self-play (BASELINE config 3) -- the XLA
learner by default, or the fused lane-loop learner (--fused, --converge,
--multigrid, --best-response) -- with on-device episode metrics,
checkpointing, and throughput reporting.

Run: python examples/train_minimax.py [--steps 20000] [--envs 8192]
     python examples/train_minimax.py --converge      # 5x4 equilibrium
"""
import argparse
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.agents import learners
from gym_soccer_tpu.agents.evaluation import exploitability
from gym_soccer_tpu.core import batch
from gym_soccer_tpu.utils import checkpoint
from gym_soccer_tpu.utils.cache import enable_compile_cache
from gym_soccer_tpu.utils.metrics import chunk_stats
from gym_soccer_tpu.utils.profiling import Throughput, log_json

# The --converge recipes: the 5x4 one is the flagship equilibrium
# contract (exploitability <= 0.010 at gamma=0.99); the 11x7 one adds an
# eps floor for off-equilibrium coverage, 600-iteration in-loop solves
# and avg_q -- solve the Q table time-averaged over the deep-anneal tail
# (solve(mean Q) beats mean(solve Q): the matrix-game solve amplifies Q
# noise at near-ties) -- with SEGMENTED evaluation.
CONVERGE = {
    (5, 4): dict(n_chunks=1000, eps=0.2, lr_anneal_start=500,
                 lr_anneal_tau=25.0, lr_anneal_pow=1.5, solver_iters=400,
                 seed=1),
    (11, 7): dict(n_chunks=6000, eps=0.25, eps_halflife=40000,
                  eps_min=0.15, lr_anneal_start=2500, lr_anneal_tau=160.0,
                  lr_anneal_pow=1.2, solver_iters=600, avg_after=4000,
                  avg_q=True, seed=2),
}


def converge(grid=(5, 4), backend="triton", chunks_per_dispatch=8):
    """Run the --converge recipe for ``grid``; returns (pa, pb, result
    dict with wall seconds and exploitability)."""
    from gym_soccer_tpu.ops import learner_kernel as lk
    w, h = grid
    cfg = EnvConfig(width=w, height=h, slip_prob=0.2)
    kw = CONVERGE[tuple(grid)]
    t0 = time.perf_counter()
    q, v, pa, pb, hist = lk.fused_minimax_train(
        cfg, batch=65536, chunk_len=32, lr=1.0, final_solver_iters=3000,
        backend=backend, chunks_per_dispatch=chunks_per_dispatch, **kw)
    jax.block_until_ready((pa, pb))
    dt = time.perf_counter() - t0
    steps = kw["n_chunks"] * 32 * 65536
    ex = exploitability(cfg, pa, pb,
                        segment_iters=200 if tuple(grid) != (5, 4) else 0)
    return cfg, pa, pb, dict(grid=f"{w}x{h}", env_steps=steps,
                             seconds=round(dt, 1),
                             env_steps_per_s=round(steps / dt),
                             exploitability=round(float(ex), 5))


def eval_episode_stats(cfg, pi_a, pi_b, n_envs=1024, n_steps=400, seed=7):
    """Play the learned mixed strategies against each other and aggregate
    episode metrics on device (utils/metrics) — the batched analogue of
    the reference main()'s 1000-episode eval loop
    (soccer_simultaneous_env.py:569-613)."""
    import jax.numpy as jnp
    pi_a = jnp.asarray(pi_a)
    pi_b = jnp.asarray(pi_b)
    key = jax.random.key(seed)

    def policy_fn(obs, i):
        k = jax.random.fold_in(key, i)
        u = jax.random.uniform(k, (2, obs.shape[0]))
        return (learners._sample_mixed(pi_a[obs], u[0]),
                learners._sample_mixed(pi_b[obs], u[1]))

    @jax.jit
    def run(k):
        st = batch.init(cfg, k, n_envs)
        _, out = batch.rollout(cfg, st, policy_fn, n_steps)
        return chunk_stats(out)

    s = jax.device_get(run(jax.random.key(seed + 1)))
    return {"episodes": int(s.episodes), "goals": int(s.goals),
            "truncations": int(s.truncations),
            "win_rate_a": round(s.win_rate_a, 4),
            "mean_reward_a": round(s.mean_reward_a, 4),
            "mean_length": round(s.mean_length, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--backend", choices=["triton", "xla"],
                    default="triton",
                    help="fused chunk launcher: the Triton kernel (GPU) or "
                         "its plain XLA twin (any backend, e.g. CPU)")
    ap.add_argument("--fused", action="store_true",
                    help="use the fused lane-loop learner "
                         "(ops/learner_kernel.py)")
    ap.add_argument("--multigrid", action="store_true",
                    help="train ONE concatenated table over a mixed "
                         "5x4+6x5 batch through the fused multigrid "
                         "kernel and report per-variant exploitability")
    ap.add_argument("--with-big", action="store_true",
                    help="with --multigrid: make the mixture 5x4 + the "
                         "reference's 11x7 big grid (nS=11705) — the "
                         "stress case for the per-lane offset planes; "
                         "per-variant exploitability uses the segmented "
                         "solvers")
    ap.add_argument("--converge", action="store_true",
                    help="run the equilibrium recipe (2.1B steps): lr=1.0 "
                         "Bellman-backup phase then polynomial anneal; "
                         "the contract is exploitability <= 0.010 vs the "
                         "exact solver's ~0.002")
    ap.add_argument("--grid", type=int, nargs=2, default=(5, 4),
                    metavar=("W", "H"),
                    help="board size for --converge (default 5 4).  "
                         "'--grid 11 7' runs the reference's big grid "
                         "(nS=11705, 12.6B steps; exact Shapley floor "
                         "0.0014) with segmented evaluation")
    ap.add_argument("--best-response", choices=["player_a", "player_b"],
                    default="",
                    help="SINGLE-AGENT mode: train the given side as a "
                         "fused best response against a frozen random "
                         "opponent — the reference main()'s training "
                         "shape (soccer_simultaneous_env.py:507-520) at "
                         "fused-kernel speed; reports the gap to the "
                         "exact best-response value and the eval win "
                         "rate")
    args = ap.parse_args()
    enable_compile_cache()

    if args.best_response:
        import jax.numpy as jnp
        from gym_soccer_tpu.agents.evaluation import (best_response_value,
                                                      start_value)
        from gym_soccer_tpu.core import tables
        from gym_soccer_tpu.ops import learner_kernel as lk
        from gym_soccer_tpu.utils.policies import get_random_policy_array
        cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
        side = args.best_response
        nS = tables.build_statespace(cfg).nS
        opp = get_random_policy_array(nS, 5, seed=42)
        n_chunks = max(2, args.steps // 32)
        t0 = time.perf_counter()
        q, v, pa, pb, hist = lk.fused_best_response_train(
            cfg, opp, side, batch=args.envs, n_chunks=n_chunks,
            chunk_len=32, lr=1.0, eps=0.3, eps_halflife=8 * n_chunks,
            eps_min=0.05, lr_anneal_start=n_chunks // 2,
            lr_anneal_tau=25.0, backend=args.backend)
        dt = time.perf_counter() - t0
        steps = n_chunks * 32 * args.envs
        opp_oh = jnp.asarray(np.eye(5, dtype=np.float32)[np.asarray(opp)])
        v_br, _ = best_response_value(cfg, opp_oh, side)
        sign = 1.0 if side == "player_a" else -1.0
        gap = float(np.abs(np.asarray(v) - sign * np.asarray(v_br)).mean())
        log_json(event="finished_best_response", side=side,
                 env_steps=steps, seconds=round(dt, 1),
                 env_steps_per_s=round(steps / dt),
                 start_value=round(start_value(cfg, v), 4),
                 mean_gap_to_exact_br=round(gap, 4))
        log_json(event="eval_episode_stats",
                 **eval_episode_stats(cfg, pa, pb))
        return

    if args.multigrid:
        from gym_soccer_tpu.core import tables
        from gym_soccer_tpu.ops import learner_kernel as lk
        cfgs = (EnvConfig(5, 4, 0.2),
                EnvConfig(11, 7, 0.2) if args.with_big
                else EnvConfig(6, 5, 0.2))
        n_chunks = max(2, args.steps // 64)
        t0 = time.perf_counter()
        q, v, pa, pb, hist = lk.fused_minimax_train(
            cfgs, batch=args.envs, n_chunks=n_chunks, chunk_len=64,
            lr=1.0, eps=0.2, lr_anneal_start=n_chunks // 2,
            lr_anneal_tau=25.0, lr_anneal_pow=1.5,
            final_solver_iters=2000, backend=args.backend,
            chunks_per_dispatch=8)
        dt = time.perf_counter() - t0
        steps = n_chunks * 64 * args.envs
        off = 0
        per_variant = {}
        for c in cfgs:
            nS = tables.build_statespace(c).nS
            seg = 200 if c.width * c.height > 40 else 0  # big variants
            ex = exploitability(c, pa[off:off + nS], pb[off:off + nS],
                                segment_iters=seg)
            per_variant[f"{c.width}x{c.height}"] = round(float(ex), 4)
            off += nS
        log_json(event="finished_multigrid", env_steps=steps,
                 seconds=round(dt, 1), env_steps_per_s=round(steps / dt),
                 exploitability_per_variant=per_variant)
        return

    if args.converge:
        cfg, pa, pb, res = converge(tuple(args.grid), args.backend)
        log_json(event="finished_converge", **res)
        log_json(event="eval_episode_stats",
                 **eval_episode_stats(cfg, pa, pb))
        return

    if args.fused:
        import jax.numpy as jnp
        from gym_soccer_tpu.core import tables
        from gym_soccer_tpu.ops import learner_kernel as lk
        cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
        n_chunks = max(1, args.steps // 64)
        # Exact checkpoint/resume: --ckpt stores the trainer's resume
        # state PLUS the anneal schedule anchor (lr_anneal_start) used by
        # the first segment; a resumed run reuses the stored anchor, so
        # the composite run is BIT-IDENTICAL to an uninterrupted run at
        # the combined step count with that same anneal schedule (PRNG
        # seeds and lr/eps schedules all key off the absolute chunk
        # index).
        start, init_tabs, fields0 = 0, None, None
        anneal_start = n_chunks // 2
        if args.ckpt and os.path.exists(args.ckpt):
            nS = tables.build_statespace(cfg).nS
            tmpl = {"q": jnp.zeros((nS, 5, 5), jnp.float32),
                    "v": jnp.zeros(nS, jnp.float32),
                    "pi_a": jnp.zeros((nS, 5), jnp.float32),
                    "pi_b": jnp.zeros((nS, 5), jnp.float32),
                    "n": jnp.zeros((nS, 5, 5), jnp.float32),
                    "fields": lk.init_state_fields(cfg, args.envs),
                    "next_chunk": 0, "lr_anneal_start": 0}
            r = checkpoint.load_pytree(args.ckpt, tmpl)
            start = int(r["next_chunk"])
            anneal_start = int(r["lr_anneal_start"])
            init_tabs = (r["q"], r["v"], r["pi_a"], r["pi_b"], r["n"])
            fields0 = r["fields"]
            log_json(event="resumed_fused", chunk=start,
                     env_steps=start * 64 * args.envs,
                     lr_anneal_start=anneal_start)
        if start >= n_chunks:
            log_json(event="already_complete", chunk=start,
                     target_chunks=n_chunks,
                     hint="re-run with a larger --steps to continue")
            return
        t0 = time.perf_counter()
        q, v, pa, pb, hist, res = lk.fused_minimax_train(
            cfg, batch=args.envs, n_chunks=n_chunks - start,
            chunk_len=64, lr=1.0, eps=0.2,
            lr_anneal_start=anneal_start, lr_anneal_tau=25.0,
            lr_anneal_pow=1.5, final_solver_iters=2000,
            start_chunk=start, init=init_tabs, fields_init=fields0,
            return_state=True, backend=args.backend)
        if args.ckpt:
            res = dict(res, lr_anneal_start=anneal_start)
            checkpoint.save_pytree(args.ckpt, res)
            log_json(event="checkpointed", path=args.ckpt,
                     chunk=int(res["next_chunk"]))
        dt = time.perf_counter() - t0
        steps = (n_chunks - start) * 64 * args.envs
        log_json(event="finished_fused", env_steps=steps,
                 seconds=round(dt, 1),
                 env_steps_per_s=round(steps / dt),
                 v_min=float(np.asarray(v).min()),
                 v_max=float(np.asarray(v).max()),
                 exploitability=round(float(exploitability(cfg, pa, pb)), 4))
        log_json(event="eval_episode_stats",
                 **eval_episode_stats(cfg, pa, pb))
        return

    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    lcfg = learners.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                                   solver_iters=200,
                                   lr_halflife=args.steps // 5,
                                   eps_halflife=args.steps // 3)

    init = jax.jit(lambda k: learners.minimax_init(cfg, k, args.envs))
    train = jax.jit(
        lambda s: learners.minimax_train(cfg, lcfg, s, args.chunk))

    state = jax.block_until_ready(init(jax.random.key(0)))
    if args.ckpt and os.path.exists(args.ckpt):
        state = checkpoint.load_pytree(args.ckpt, state)
        log_json(event="resumed", step=int(state.step))

    t_compile = time.perf_counter()
    state, td = jax.block_until_ready(train(state))
    log_json(event="compiled", seconds=round(time.perf_counter() - t_compile, 1))

    tp = Throughput()
    done = int(state.step)
    while done < args.steps:
        state, td = train(state)
        jax.block_until_ready(td)
        done = int(state.step)
        tp.tick(args.chunk * args.envs)
        log_json(step=done, mean_abs_td=round(float(np.asarray(td).mean()), 5),
                 v_max=round(float(np.abs(np.asarray(state.v)).max()), 4),
                 **tp.summary())
        if args.ckpt:
            checkpoint.save_pytree(args.ckpt, state)

    v = np.asarray(state.v)
    log_json(event="finished", steps=done, v_min=float(v.min()),
             v_max=float(v.max()),
             exploitability=round(
                 float(exploitability(cfg, state.pi_a, state.pi_b)), 4),
             **tp.summary())
    log_json(event="eval_episode_stats",
             **eval_episode_stats(cfg, state.pi_a, state.pi_b))


if __name__ == "__main__":
    main()
