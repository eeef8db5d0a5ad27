"""Scaling-efficiency bench: throughput vs device count over the env mesh.

BASELINE.json's north star is ">=0.8 linear scaling efficiency at N>=2".
By default this harness runs on a VIRTUAL device mesh -- the CPU backend
split into N devices via ``--xla_force_host_platform_device_count``, with
the fused chunks on their XLA twin -- which exercises the production code
paths (jax.sharding.Mesh layout, shard_map, psum/pmean collectives,
replicated Q-tables) and therefore validates the *harness*; its
efficiency numbers are a PROXY (the virtual devices share the host's
cores, and are labeled so).  ``--real`` runs the same sweep on the
machine's GPUs (up to four, joined by NVLink) with the fused chunks on
their Triton kernel; run it on the cards, one process for all of them.

Weak scaling: the per-device env count is fixed and the batch grows with
the mesh (the deployment-relevant regime for embarrassingly-parallel env
shards + all-reduced learners).  Efficiency(N) = thr(N) / (N * thr(1)).

Each row also carries ``efficiency_device_work``: work per process-CPU-
second relative to 1 device.  On the virtual mesh all device compute
burns process CPU time, so this column isolates the sharded PROGRAM's
cost (collectives, partitioning) from host oversubscription: wall-clock
efficiency collapses when N virtual devices share fewer cores even for a
perfect program, CPU-time-per-work does not.  A device-work efficiency
near 1.0 with a low wall efficiency therefore indicts the host, not the
sharding.  (On the GPUs it measures host dispatch only.)

Outputs one JSON line per (path, n_devices) plus a summary line; exit code
0 always (measurement tool, not a gate).

Run: python tools/bench_scaling.py [--real] [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="use the machine's GPUs (fused chunks on the "
                         "Triton kernel) instead of the virtual CPU mesh")
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (default 1 2 4 8, "
                         "clipped to what's available)")
    ap.add_argument("--envs-per-device", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=None,
                    help="rollout/train chunk length per timed call")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json-out", type=str, default=None,
                    help="also write the summary JSON to this path")
    return ap.parse_args(argv)


def _force_virtual_mesh(n_devices: int) -> None:
    """Must run before jax's backend initializes."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def _timed(fn, n=3):
    """Median (wall, process-CPU) seconds per call.

    On the VIRTUAL mesh every 'device' is a thread of this process, so
    compute burns process CPU time: work per CPU-second isolates the
    sharded program's cost from host oversubscription (which inflates
    wall time but not CPU time per unit of work).  On GPUs the CPU column
    measures only host-side dispatch and is not device work."""
    import resource
    fn()  # warmup / compile
    ts, cs = [], []
    for _ in range(n):
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        cs.append((r1.ru_utime + r1.ru_stime)
                  - (r0.ru_utime + r0.ru_stime))
    return sorted(ts)[n // 2], sorted(cs)[n // 2]


def sweep(device_counts, envs_per_device=2048, n_steps=200, reps=3,
          chunk_backend="xla"):
    """Measure sharded rollout + sharded minimax-Q training throughput for
    each device count.  ``chunk_backend`` runs the fused learner chunks
    (ops/lane_loop: 'triton' on GPUs, the 'xla' twin anywhere).  Returns a
    list of row dicts (shared by the CLI and the CI smoke test)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gym_soccer_tpu.agents import learners
    from gym_soccer_tpu.config import EnvConfig
    from gym_soccer_tpu.core import batch
    from gym_soccer_tpu.parallel import mesh as pmesh

    cfg = EnvConfig(5, 4, 0.2)
    lcfg = learners.MinimaxQConfig(resolve_every=64)
    nS = batch.tables.build_statespace(cfg).nS
    rows = []

    for n in device_counts:
        B = envs_per_device * n
        m = pmesh.env_mesh(n)
        rep = pmesh.replicated(m)

        # --- sharded random rollout (collective-free stepping) ---
        pol = batch.random_policy_fn(cfg, jax.random.key(1), B)
        st = pmesh.sharded_init(cfg, m, jax.random.key(0), B)
        roll = pmesh.sharded_rollout_fn(cfg, m, pol, n_steps)

        def run_roll():
            nonlocal st
            st, (r, d, t) = roll(st)
            np.asarray(r)  # host fetch ends the timed call

        dt, dc = _timed(run_roll, reps)
        rows.append({"path": "rollout", "n_devices": n, "n_envs": B,
                     "steps_per_s": B * n_steps / dt,
                     "cpu_s_per_call": dc})

        # --- sharded fused minimax-Q training (replicated Q, psum'd TDs) ---
        uniform = jnp.full((nS, 5), 0.2, jnp.float32)
        lstate = learners.MinimaxQState(
            q=jax.device_put(jnp.zeros((nS, 5, 5), jnp.float32), rep),
            v=jax.device_put(jnp.zeros(nS, jnp.float32), rep),
            pi_a=jax.device_put(uniform, rep),
            pi_b=jax.device_put(uniform, rep),
            env=pmesh.sharded_init(cfg, m, jax.random.key(2), B),
            step=jax.device_put(jnp.int32(0), rep),
            n=jax.device_put(jnp.zeros((nS, 5, 5), jnp.float32), rep))
        train = pmesh.sharded_minimax_train_fn(cfg, lcfg, m, n_steps)

        def run_train():
            nonlocal lstate
            lstate, td = train(lstate)
            np.asarray(td)

        dt, dc = _timed(run_train, reps)
        rows.append({"path": "minimax_train", "n_devices": n, "n_envs": B,
                     "steps_per_s": B * n_steps / dt,
                     "cpu_s_per_call": dc})

        # --- sharded FUSED learner chunks (one lane-loop chunk per
        # device, psum'd integer accumulators); the chunk needs whole
        # 128-lane rows per device
        from jax.sharding import NamedSharding, PartitionSpec
        from gym_soccer_tpu.ops import learner_kernel as lk
        f_epd = max(128, envs_per_device // 128 * 128)
        fB = f_epd * n
        mm = lk.pack_m(cfg, uniform, uniform, jnp.zeros(nS), eps=0.3)
        sh = NamedSharding(m, PartitionSpec("env", None))
        fields = tuple(jax.device_put(f, sh)
                       for f in lk.init_state_fields(cfg, fB))
        chunkf = pmesh.sharded_learner_chunk_fn(cfg, m, fB, n_steps,
                                                backend=chunk_backend)

        def run_fused():
            nonlocal fields
            fields, acc, stats = chunkf(0, mm, fields)
            np.asarray(acc)

        dt, dc = _timed(run_fused, reps)
        rows.append({"path": "fused_learner_chunk", "n_devices": n,
                     "n_envs": fB, "steps_per_s": fB * n_steps / dt,
                     "cpu_s_per_call": dc})

        # --- state-sharded RM+ re-solve (the model-parallel stage,
        # parallel/mesh.sharded_solve_fn): a FIXED nS-state batch of 5x5
        # games splits across devices — strong scaling, unlike the env
        # paths' weak scaling.  steps_per_s counts state-game RM+
        # iterations.
        solve_iters = 2 * n_steps
        qrand = jax.device_put(
            jax.random.uniform(jax.random.key(5), (nS, 5, 5),
                               jnp.float32, -1, 1), rep)
        solvef = pmesh.sharded_solve_fn(m, iters=solve_iters)

        def run_solve():
            v, x, y = solvef(qrand)
            np.asarray(v)

        dt, dc = _timed(run_solve, reps)
        rows.append({"path": "sharded_solve", "n_devices": n,
                     "n_envs": nS, "steps_per_s": nS * solve_iters / dt,
                     "cpu_s_per_call": dc})

    # efficiency vs linear extrapolation of the 1-device number
    base = {r["path"]: r["steps_per_s"] for r in rows if r["n_devices"] == 1}
    # Device-work efficiency: steps per CPU-second relative to 1 device.
    # On the virtual mesh this isolates the sharded PROGRAM's cost (extra
    # collectives, partitioning overhead) from host oversubscription:
    # N threads timesharing fewer cores inflate wall time even for a
    # perfect program, but not CPU time per unit of work.  The solve
    # path is strong scaling over a fixed batch, so its per-step work is
    # constant too and the same normalization applies.
    # work-per-CPU-second at 1 device: n_envs / cpu_s (the per-step work
    # of every path is proportional to its n_envs, including the
    # strong-scaling solve whose n_envs is the fixed state count)
    wbase = {r["path"]: r["n_envs"] / r["cpu_s_per_call"]
             for r in rows if r["n_devices"] == 1 and r["cpu_s_per_call"] > 0}
    for r in rows:
        b = base.get(r["path"])
        if b:
            r["efficiency_vs_linear"] = r["steps_per_s"] / (r["n_devices"] * b)
        wb = wbase.get(r["path"])
        if wb and r["cpu_s_per_call"] > 0:
            r["efficiency_device_work"] = (
                (r["n_envs"] / r["cpu_s_per_call"]) / wb)
    return rows


def main(argv=None) -> int:
    args = _parse_args(argv)
    counts = args.devices or [1, 2, 4, 8]
    if not args.real:
        _force_virtual_mesh(max(counts))
    import jax

    avail = len(jax.devices())
    counts = [n for n in counts if n <= avail]
    backend = jax.devices()[0].platform
    if args.real and backend != "gpu":
        print(f"--real needs GPUs; JAX runs on {backend}", file=sys.stderr)
        return 2
    proxy = not args.real
    n_steps = args.steps or (50 if args.quick else 200)

    rows = sweep(counts, args.envs_per_device, n_steps,
                 reps=2 if args.quick else 3,
                 chunk_backend="triton" if args.real else "xla")
    for r in rows:
        r.update(backend=backend, proxy_virtual_mesh=proxy)
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in r.items()}))

    summary = {
        "metric": "scaling_efficiency",
        "backend": backend,
        "proxy_virtual_mesh": proxy,
        "device_counts": counts,
        "envs_per_device": args.envs_per_device,
        "min_efficiency": round(min(
            (r["efficiency_vs_linear"] for r in rows
             if r["n_devices"] > 1), default=1.0), 4),
        "rows": rows,
    }
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
