"""Multi-host (multi-process) data-parallel training demonstration.

The reference has no distributed machinery at all (SURVEY.md §5.8); this
framework's claim is that the env batch shards over a device mesh with
replicated, psum-synced learner state — and that per-instance RNG keyed by
GLOBAL instance id makes results placement-invariant (SURVEY.md §7.3.7).

This tool proves both claims with real process boundaries, not simulation:

1. baseline — ONE process, 8 virtual CPU devices, runs a sharded fused
   minimax-Q training step (the same path as __graft_entry__.dryrun_multichip);
2. distributed — TWO processes, 4 virtual devices each, connected through
   ``jax.distributed.initialize`` (gloo collectives across process
   boundaries — the CPU stand-in for NCCL between GPUs), running the identical
   global computation on the same global mesh axis;
3. the parent asserts the two TD summaries agree (placement invariance
   across process topologies).

Run:  python tools/demo_multihost.py           (parent; ~1-2 min on 2 vCPUs)
      python tools/demo_multihost.py --worker I N   (internal)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEVICES = 8
N_ENVS = 8 * N_DEVICES
TRAIN_STEPS = 12
PORT = int(os.environ.get("GYM_SOCCER_TPU_MH_PORT", "12741"))


def _force_cpu(n_local_devices: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")


def run_training(tag: str):
    """Build the global mesh from jax.devices() (all processes) and run the
    sharded minimax-Q training step on tiny shapes.  Returns the TD summary,
    which is replicated (pmean'd) and therefore host-readable everywhere."""
    import jax
    import jax.numpy as jnp

    from gym_soccer_tpu.config import EnvConfig
    from gym_soccer_tpu.agents import learners
    from gym_soccer_tpu.parallel import mesh as pmesh

    cfg = EnvConfig(width=5, height=4, slip_prob=0.2)
    lcfg = learners.MinimaxQConfig(resolve_every=2)
    m = pmesh.env_mesh(N_DEVICES)
    nS = 761

    env = pmesh.sharded_init(cfg, m, jax.random.key(0), N_ENVS)
    rep = pmesh.replicated(m)
    # Deterministic NONZERO value init so every step produces nonzero TDs
    # and Q updates — otherwise the invariance check compares zeros.
    q0 = (jnp.arange(nS * 25, dtype=jnp.float32).reshape(nS, 5, 5)
          % 17) * 1e-2
    state = learners.MinimaxQState(
        q=jax.device_put(q0, rep),
        v=jax.device_put(q0.mean(axis=(1, 2)), rep),
        pi_a=jax.device_put(jnp.full((nS, 5), 0.2, jnp.float32), rep),
        pi_b=jax.device_put(jnp.full((nS, 5), 0.2, jnp.float32), rep),
        env=env, step=jax.device_put(jnp.int32(0), rep),
        n=jax.device_put(jnp.zeros((nS, 5, 5), jnp.float32), rep),
    )
    train = pmesh.sharded_minimax_train_fn(cfg, lcfg, m, n_steps=TRAIN_STEPS)
    state, td = jax.block_until_ready(train(state))
    q_sum = float(jnp.abs(state.q).sum())
    return {"tag": tag, "td": [float(x) for x in td], "q_l1": q_sum,
            "n_global_devices": len(jax.devices())}


def worker(process_id: int, num_processes: int) -> None:
    _force_cpu(N_DEVICES // num_processes)
    from gym_soccer_tpu.parallel.mesh import distributed_init
    distributed_init(coordinator_address=f"localhost:{PORT}",
                     num_processes=num_processes, process_id=process_id)
    out = run_training(f"proc{process_id}/{num_processes}")
    print("RESULT " + json.dumps(out), flush=True)


def parent() -> int:
    # 1. single-process baseline on 8 virtual devices
    base = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--baseline"],
        capture_output=True, text=True, timeout=600)
    baseline = _extract(base.stdout)
    assert baseline, f"baseline failed:\n{base.stdout}\n{base.stderr}"

    # 2. two real processes, 4 devices each, gloo-connected.  Any failure
    # or timeout must kill BOTH workers (by exact PID): a surviving worker
    # blocks in gloo forever and keeps the coordinator port bound.
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            r = _extract(out)
            assert p.returncode == 0 and r, \
                f"worker failed (rc={p.returncode}):\n{out}\n{err}"
            results.append(r)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    # 3a. the two gloo-connected processes must agree BIT-EXACTLY — they
    # share one global computation, so any divergence is a real bug.
    ok = json.dumps(results[0]["td"]) == json.dumps(results[1]["td"]) and \
        results[0]["q_l1"] == results[1]["q_l1"]
    if not ok:
        print("MISMATCH between the two distributed processes")
    # 3b. 1x8-device vs 2x4-device: per-instance trajectories are bit-exact
    # (global-id RNG), but cross-replica float psum/pmean reductions are
    # reduction-order-dependent at the last ULP (in-process XLA allreduce
    # vs cross-process gloo), so compare to 1e-6 relative.
    for r in results:
        for a, b in zip(baseline["td"] + [baseline["q_l1"]],
                        r["td"] + [r["q_l1"]]):
            if abs(a - b) > 1e-6 * max(abs(a), abs(b), 1e-3):
                ok = False
                print(f"MISMATCH {r['tag']}: {a} vs {b}")
    print(json.dumps({
        "baseline_1proc_8dev": baseline,
        "distributed_2proc_4dev": results,
        "placement_invariant": ok,
    }, indent=2))
    print("MULTIHOST OK" if ok else "MULTIHOST MISMATCH")
    return 0 if ok else 1


def _extract(stdout: str):
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
    elif "--baseline" in sys.argv:
        _force_cpu(N_DEVICES)
        print("RESULT " + json.dumps(run_training("1proc")), flush=True)
    else:
        sys.exit(parent())
