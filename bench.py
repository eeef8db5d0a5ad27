"""Env-step throughput of the fused random rollout on one NVIDIA GPU.

Runs in ONE process on the card.  The first lines name the device (JAX's
platform, device kind and count) and the card (name and power limit from
nvidia-smi); the last line is one JSON object:

  {"metric": "env_steps_per_s", "value": N, "unit": "env-steps/s", ...}

The workload is BASELINE.json config 2: random-vs-random joint actions on
the default 5x4 Littman grid (slip 0.2), 262,144 env lanes in lockstep
(sized to fill 132 SMs) for 1000 steps per call, timed over a window of at
least one second that ends in block_until_ready.

``--ab`` instead times every lane-loop family's Triton kernel against its
plain XLA twin (ops/lane_loop.py) at the shapes the kernel choices were
made at, one JSON line per family.

Without a GPU it exits with status 2 and prints no measurement.

Run: python bench.py [--ab]
"""
import argparse
import json
import sys

B, T = 262144, 1000


def _rollout_case(fn, cfg, batch, steps):
    import jax.numpy as jnp

    def run(backend):
        return lambda: fn(cfg, jnp.int32(1), batch, steps, backend=backend)
    return run, batch * steps


def _chunk_case(kind, cfg, batch, steps):
    """A learner chunk with chunk-0 tables (uniform policies / zero Q)."""
    import jax.numpy as jnp
    from gym_soccer_tpu.core import tables
    from gym_soccer_tpu.ops import altq_kernel as ak
    from gym_soccer_tpu.ops import iql_kernel as ik
    from gym_soccer_tpu.ops import learner_kernel as lk
    if kind == "altq":
        from gym_soccer_tpu.envs.soccer_alternating_env import (
            build_alt_tables)
        m = ak.pack_alt_m(cfg, jnp.zeros((build_alt_tables(cfg).nS, 5)))
        fields = ak.init_alt_state_fields(cfg, batch)
        call = lambda be: ak.altq_chunk(cfg, 1, 19661, m, fields, batch,
                                        steps, backend=be)
    elif kind == "iql":
        nS = tables.build_statespace(cfg).nS
        m = ik.pack_iql_m(cfg, jnp.zeros((nS, 5)), jnp.zeros((nS, 5)))
        fields = ik.init_iql_state_fields(cfg, batch)
        call = lambda be: ik.iql_chunk(cfg, 1, 19661, m, fields, batch,
                                       steps, backend=be)
    else:
        nS = (sum(tables.build_statespace(c).nS for c in cfg)
              if isinstance(cfg, tuple) else tables.build_statespace(cfg).nS)
        uni = jnp.full((nS, 5), 0.2, jnp.float32)
        m = lk.pack_m(cfg, uni, uni, jnp.zeros(nS), 0.2)
        if isinstance(cfg, tuple):
            planes, fields = lk.init_state_fields(cfg, batch)
            call = lambda be: lk.multigrid_learner_chunk(
                cfg, 1, m, planes, fields, batch, steps, backend=be)
        else:
            fields = lk.init_state_fields(cfg, batch)
            call = lambda be: lk.learner_chunk(cfg, 1, m, fields, batch,
                                               steps, backend=be)
    return (lambda backend: (lambda: call(backend))), batch * steps


def ab_cases():
    """(name, case) for every lane-loop family at its measured shape."""
    from gym_soccer_tpu.config import EnvConfig
    from gym_soccer_tpu.ops import step_kernel as sk
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    mg = (c54, EnvConfig(6, 5, 0.1), EnvConfig(8, 6, 0.3))
    return [
        ("rollout_5x4", _rollout_case(sk.pallas_rollout, c54, B, T)),
        ("alt_rollout_5x4", _rollout_case(sk.pallas_alt_rollout, c54, B, T)),
        ("multigrid_rollout_3var", _rollout_case(
            sk.pallas_multigrid_rollout, mg, B, T)),
        ("journal_rollout_5x4", _rollout_case(sk.pallas_journal_rollout,
                                              c54, B, 256)),
        ("minimax_chunk_5x4", _chunk_case("minimax", c54, 65536, 32)),
        ("minimax_chunk_11x7", _chunk_case("minimax", c117, 65536, 32)),
        ("multigrid_chunk_5x4+11x7", _chunk_case("minimax", (c54, c117),
                                                 65536, 32)),
        ("iql_chunk_5x4", _chunk_case("iql", c54, 65536, 32)),
        ("altq_chunk_5x4", _chunk_case("altq", c54, 65536, 32)),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab", action="store_true",
                    help="time every family's Triton kernel vs its XLA twin")
    args = ap.parse_args()

    import jax
    from gym_soccer_tpu.utils.cache import enable_compile_cache
    from gym_soccer_tpu.utils.profiling import (card_line, device_line,
                                                time_window)
    dev = device_line()
    if dev["platform"] != "gpu":
        print(f"no GPU: JAX runs on {dev['platform']}; nothing measured",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_line()
    print(f"device: {dev}")
    print(f"card: {card}")
    sys.stdout.flush()

    if args.ab:
        for name, (make, work) in ab_cases():
            row = {"family": name, "work_per_call": work, "card": card,
                   "device": dev}
            for backend in ("triton", "xla"):
                per_call, calls, window = time_window(make(backend))
                row[backend] = {"seconds_per_call": per_call,
                                "steps_per_s": work / per_call,
                                "calls": calls, "window_s": window}
            row["triton_speedup"] = (row["xla"]["seconds_per_call"]
                                     / row["triton"]["seconds_per_call"])
            print(json.dumps(row))
            sys.stdout.flush()
        return 0

    from gym_soccer_tpu.config import EnvConfig
    from gym_soccer_tpu.ops import step_kernel as sk
    make, work = _rollout_case(sk.pallas_rollout, EnvConfig(5, 4, 0.2), B, T)
    per_call, calls, window = time_window(make("triton"))
    print(json.dumps({
        "metric": "env_steps_per_s", "value": work / per_call,
        "unit": "env-steps/s", "batch": B, "steps_per_call": T,
        "calls": calls, "window_s": window, "backend": "triton",
        "device": dev, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
