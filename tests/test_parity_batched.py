"""Batched-engine parity: the vectorized parity backend (uint32 bit-pattern
threshold compares, per-instance MT19937 streams) must reproduce the
executed reference's trajectories exactly, per batch lane — the
BASELINE.json north-star claim.  The kernel is pure int32/uint32/float32,
so the SAME code is exact on any device (no float64 arithmetic needed);
here it runs on the CPU backend.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import parity, rules

with open(os.path.join(os.path.dirname(__file__), "golden",
                       "reference_golden.json")) as f:
    GOLD = json.load(f)


def hex_to_f64(h):
    return np.frombuffer(bytes.fromhex(h), dtype=np.float64)[0]


def random_policy_array(n_states, n_actions, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, n_actions, size=n_states).astype(np.int32)


FIXTURES = {
    "traj_5x4_slip02_multi_seed123": (EnvConfig(5, 4, 0.2), None, None),
    "traj_5x4_slip02_multi_seed0": (EnvConfig(5, 4, 0.2), None, None),
    "traj_5x4_slip00_multi_seed5": (EnvConfig(5, 4, 0.0), None, None),
    "traj_7x5_slip03_multi_seed42": (EnvConfig(7, 5, 0.3), None, None),
    "traj_6x4_slip01_multi_seed77": (EnvConfig(6, 4, 0.1), None, None),
    "traj_9x6_slip025_multi_seed31": (EnvConfig(9, 6, 0.25), None, None),
    "traj_5x4_slip02_singleA_seed9": (
        EnvConfig(5, 4, 0.2), "player_b", random_policy_array(761, 5, 0)),
    "traj_5x4_slip02_singleB_seed21": (
        EnvConfig(5, 4, 0.2), "player_a", random_policy_array(761, 5, 1)),
}


def fixture_script(name):
    """Flatten a golden trajectory into per-parity-step expectations.
    Reset records merge into the following step (parity_step performs the
    pending reset before consuming the action)."""
    rec = GOLD[name]
    cfg, frozen, pol = FIXTURES[name]
    steps = []
    for r in rec["steps"]:
        if r.get("reset"):
            continue  # merged into the next step's was_reset
        act = r["action"]
        if frozen is None:
            row = act["player_a"] * 5 + act["player_b"]
        else:
            learner = "player_a" if frozen == "player_b" else "player_b"
            row = act[learner]
        agent = (list(act.keys())[0] if frozen is not None else "player_a")
        steps.append({
            "row": row,
            "state": r["state"],
            "obs": r["obs"][agent if frozen is not None else "player_a"],
            "reward": hex_to_f64(r["reward"][
                "player_a" if frozen is None else agent]),
            "done": r["done"]["player_a" if frozen is None else agent],
            "trunc": r["trunc"]["player_a" if frozen is None else agent],
        })
    return rec["seed"], steps


def run_fixture_lanes(names, lanes_per_fixture=2):
    """Run several fixtures in parallel batch lanes through one jitted
    parity rollout and compare every lane step-for-step."""
    cfg, frozen, pol = FIXTURES[names[0]]
    for n in names:
        assert FIXTURES[n][0] == cfg and FIXTURES[n][1] == frozen
    pt = parity.parity_tables(cfg, frozen, pol)

    scripts = [fixture_script(n) for n in names]
    T = min(len(s[1]) for s in scripts)
    seeds, rows = [], []
    for seed, steps in scripts:
        for _ in range(lanes_per_fixture):
            seeds.append(seed)
            rows.append([st["row"] for st in steps[:T]])
    B = len(seeds)
    rows = jnp.asarray(np.asarray(rows, dtype=np.int32).T)  # [T, B]
    hi, lo = parity.gen_streams(seeds, 2 * T + 2)

    st = parity.parity_init(cfg, B)
    roll = jax.jit(lambda s, r: parity.parity_rollout(
        cfg, pt, s, r, jnp.asarray(hi), jnp.asarray(lo)))
    final, out = jax.block_until_ready(roll(st, rows))
    out = jax.tree.map(np.asarray, out)

    lane = 0
    for (seed, steps), name in zip(scripts, names):
        for _ in range(lanes_per_fixture):
            for t in range(T):
                exp = steps[t]
                assert int(out.obs[t, lane]) == exp["obs"], (name, t)
                assert np.float32(exp["reward"]).tobytes() == \
                    out.reward_a[t, lane].tobytes(), (name, t)
                assert bool(out.done[t, lane]) == exp["done"], (name, t)
                assert bool(out.truncated[t, lane]) == exp["trunc"], (name, t)
            # final lane state must equal the fixture's last compared state
            exp_state = steps[T - 1]["state"]
            got = rules.raw_decode(np, int(np.asarray(final.raw)[lane]), cfg)
            assert list(got) == exp_state, name
            lane += 1


def test_multiagent_fixtures_in_shared_batch():
    run_fixture_lanes([
        "traj_5x4_slip02_multi_seed123",
        "traj_5x4_slip02_multi_seed0",
    ])


def test_deterministic_grid_fixture():
    run_fixture_lanes(["traj_5x4_slip00_multi_seed5"])


def test_odd_grid_fixture():
    run_fixture_lanes(["traj_7x5_slip03_multi_seed42"])


def test_even_grid_fixtures():
    run_fixture_lanes(["traj_6x4_slip01_multi_seed77"])
    run_fixture_lanes(["traj_9x6_slip025_multi_seed31"])


def test_single_agent_a_fixture():
    run_fixture_lanes(["traj_5x4_slip02_singleA_seed9"])


def test_single_agent_b_fixture():
    run_fixture_lanes(["traj_5x4_slip02_singleB_seed21"])


def test_state_trajectory_full_parity():
    """Exhaustive per-step state comparison (not just obs): re-run one
    fixture and decode every intermediate raw state."""
    name = "traj_5x4_slip02_multi_seed123"
    cfg, frozen, pol = FIXTURES[name]
    pt = parity.parity_tables(cfg)
    seed, steps = fixture_script(name)
    T = len(steps)
    rows = jnp.asarray(np.asarray([[s["row"]] for s in steps],
                                  dtype=np.int32))  # [T, 1]
    hi, lo = parity.gen_streams([seed], 2 * T + 2)

    st = parity.parity_init(cfg, 1)
    states = []
    step = jax.jit(lambda s, r: parity.parity_step(
        cfg, pt, s, r, jnp.asarray(hi), jnp.asarray(lo)))
    for t in range(T):
        st, out = step(st, rows[t])
        states.append(list(rules.raw_decode(np, int(st.raw[0]), cfg)))
    expected = [s["state"] for s in steps]
    assert states == expected
