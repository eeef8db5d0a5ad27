"""Event-time parity path (core/parity.parity_policy_events) -- bit
exactness against the step-time parity path and the golden fixtures.

Event time consumes exactly one reference RNG draw per lane per call: a
reset draw where a lane's episode ended, a transition draw otherwise.
Anchoring chain: the event stream, filtered per lane to its transition
events, is compared with the step-time closed-loop rollout
(parity_policy_rollout), which is pinned to golden fixtures generated
from the executed reference (tools/gen_golden.py) -- including the
reference main()'s closed-loop policy evaluation, which is also checked
here end to end through the event path.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import mt19937, parity, tables

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def _policies(nS, sa=1, sb=7):
    ra = np.random.RandomState(sa).randint(0, 5, size=nS).astype(np.int32)
    rb = np.random.RandomState(sb).randint(0, 5, size=nS).astype(np.int32)
    return ra, rb


def _events(cfg, seeds, pol_a, pol_b, n_events, device_streams=False):
    pt = parity.parity_tables(cfg)
    rows = parity.policy_rows(pt, pol_a, pol_b)
    if device_streams:
        hi, lo = jax.jit(lambda s: mt19937.device_streams(s, n_events))(
            jnp.asarray(seeds, jnp.uint32))
    else:
        hi, lo = (jnp.asarray(x) for x in parity.gen_streams(seeds,
                                                            n_events))
    st0 = parity.parity_init(cfg, len(seeds))
    st, ev = jax.jit(lambda s: parity.parity_policy_events(
        cfg, pt, s, rows, n_events, hi, lo))(st0)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, ev)


def _step_time(cfg, seeds, pol_a, pol_b, T):
    pt = parity.parity_tables(cfg)
    rows = parity.policy_rows(pt, pol_a, pol_b)
    hi, lo = parity.gen_streams(seeds, 2 * T + 2)
    st0 = parity.parity_init(cfg, len(seeds))
    _, out = jax.jit(lambda s: parity.parity_policy_rollout(
        cfg, pt, s, rows, T, jnp.asarray(hi), jnp.asarray(lo)))(st0)
    return jax.tree.map(np.asarray, out)


def _assert_events_match_step_time(cfg, ev, step_out, lanes, T):
    r2d = tables.build_statespace(cfg).raw_to_dense
    for b in lanes:
        tr = ~ev.was_reset[:, b]
        n = min(int(tr.sum()), T)
        assert n > 0
        assert np.array_equal(r2d[ev.raw[tr, b][:n]], step_out.obs[:n, b])
        assert np.array_equal(ev.reward_a[tr, b][:n], step_out.reward_a[:n, b])
        assert np.array_equal(ev.done[tr, b][:n], step_out.done[:n, b])
        assert np.array_equal(ev.truncated[tr, b][:n],
                              step_out.truncated[:n, b])


@pytest.mark.parametrize("slip", [0.2, 0.0])
def test_events_match_step_time_parity(slip):
    """Transition events, filtered per lane, reproduce the step-time
    closed-loop rollout across two MT19937 twist boundaries (> 624
    draws), goal terminations and episode chaining."""
    cfg = EnvConfig(5, 4, slip)
    nS = tables.build_statespace(cfg).nS
    pol_a, pol_b = _policies(nS)
    seeds = np.arange(64, dtype=np.uint32) * 7 + 3
    T = 320
    _, ev = _events(cfg, seeds, pol_a, pol_b, 2 * T)
    step_out = _step_time(cfg, seeds, pol_a, pol_b, T)
    _assert_events_match_step_time(cfg, ev, step_out, range(0, 64, 9), T)


def test_events_truncation_horizon():
    """max_steps-driven truncation: stand-vs-stand never scores from the
    ISD, so every episode truncates after exactly max_steps transitions,
    and each truncation is followed by one reset draw."""
    cfg = EnvConfig(5, 4, 0.2, max_steps=17)
    nS = tables.build_statespace(cfg).nS
    stand = np.zeros(nS, np.int32)
    seeds = np.arange(32, dtype=np.uint32)
    E = 384
    _, ev = _events(cfg, seeds, stand, stand, E)
    assert ev.done.sum() == 0 and ev.truncated.sum() > 0
    for b in range(0, 32, 5):
        ends = np.nonzero(ev.truncated[:, b])[0]
        resets = np.nonzero(ev.was_reset[:, b])[0]
        # the first event of a lane is its initial reset; each episode is
        # then 17 transitions, a truncation, and the next reset draw
        assert resets[0] == 0
        assert np.array_equal(np.diff(ends), np.full(len(ends) - 1, 18))
        assert set(resets[1:]) == set(ends + 1) & set(range(E))
    step_out = _step_time(cfg, seeds, stand, stand, E // 2)
    _assert_events_match_step_time(cfg, ev, step_out, range(0, 32, 5),
                                   E // 2)


def test_events_reproduce_reference_golden_policy_eval():
    """End to end: per-episode rewards/lengths of the reference main()'s
    closed-loop eval (VI policy vs frozen random B), reconstructed from
    the event stream, match the golden fixture generated from the
    EXECUTED reference."""
    gold = json.load(open(os.path.join(
        os.path.dirname(__file__), "golden", "reference_golden.json")))
    fx = gold["policy_eval_5x4_slip02_joint"]
    pol_a = np.asarray(fx["policy_a"], np.int32)
    pol_b = np.asarray(fx["policy_b"], np.int32)
    n_epi = 40  # enough episodes to cross a twist boundary
    lengths = fx["episode_lengths"][:n_epi]
    n_events = sum(lengths) + n_epi  # one reset draw per episode
    seeds = np.full(8, fx["reset_seed"], np.uint32)
    _, ev = _events(CFG, seeds, pol_a, pol_b, n_events)
    lane = 0
    term = ev.done[:, lane] | ev.truncated[:, lane]
    got_lengths, got_rewards, start = [], [], 0
    for e in np.nonzero(term)[0]:
        got_lengths.append(int((~ev.was_reset[start:e + 1, lane]).sum()))
        got_rewards.append(float(ev.reward_a[start:e + 1, lane].sum()))
        start = e + 1
    assert got_lengths[:n_epi] == lengths
    want = [np.frombuffer(bytes.fromhex(h), np.float64)[0]
            for h in fx["episode_rewards"][:n_epi]]
    assert got_rewards[:n_epi] == [float(w) for w in want]
    # every lane ran the same seed: event streams must be identical
    assert (ev.raw == ev.raw[:, :1]).all()


def test_events_11x7_grid():
    """The reference's own big grid (nS=11705) on the event path."""
    cfg = EnvConfig(11, 7, 0.3)
    nS = tables.build_statespace(cfg).nS
    pol_a, pol_b = _policies(nS)
    seeds = np.arange(32, dtype=np.uint32)
    T = 128
    _, ev = _events(cfg, seeds, pol_a, pol_b, 2 * T)
    step_out = _step_time(cfg, seeds, pol_a, pol_b, T)
    _assert_events_match_step_time(cfg, ev, step_out, (0, 13, 31), T)


def test_events_11x7_scripted_stand_truncates():
    """Big grid, stand-vs-stand: the reset/transition alternation holds
    at the 11x7 ISD too (every event is a reset or a transition, and the
    observed states are the ISD states)."""
    cfg = EnvConfig(11, 7, 0.2, max_steps=9)
    ss = tables.build_statespace(cfg)
    stand = np.zeros(ss.nS, np.int32)
    seeds = np.arange(16, dtype=np.uint32) + 100
    _, ev = _events(cfg, seeds, stand, stand, 60)
    isd = set(ss.isd_raw.tolist())
    # standing still keeps every lane in an initial state
    assert set(np.unique(ev.raw).tolist()) <= isd
    assert ev.truncated.sum() > 0 and ev.done.sum() == 0


@pytest.mark.parametrize("slip", [0.2, 0.0])
def test_events_device_streams_match_host_streams(slip):
    """Event path fed by on-device MT19937 streams (core/mt19937) equals
    the event path fed by numpy's RandomState streams, bit for bit."""
    cfg = EnvConfig(5, 4, slip)
    nS = tables.build_statespace(cfg).nS
    pol_a, pol_b = _policies(nS, 3, 5)
    seeds = np.arange(16, dtype=np.uint32) * 11 + 1
    st_h, ev_h = _events(cfg, seeds, pol_a, pol_b, 700)
    st_d, ev_d = _events(cfg, seeds, pol_a, pol_b, 700, device_streams=True)
    for a, b in zip(jax.tree.leaves((st_h, ev_h)),
                    jax.tree.leaves((st_d, ev_d))):
        assert np.array_equal(a, b)


def test_events_one_draw_per_lane_per_event():
    """Every lane consumes exactly one draw per event: cursors advance in
    lockstep, whatever each lane's episode boundaries."""
    nS = tables.build_statespace(CFG).nS
    pol_a, pol_b = _policies(nS, 2, 4)
    seeds = np.arange(32, dtype=np.uint32)
    E = 200
    st, ev = _events(CFG, seeds, pol_a, pol_b, E)
    assert (st.cursor == E).all()
    # each event is either a reset draw or a transition draw
    n_trans = (~ev.was_reset).sum(0)
    assert np.array_equal(n_trans + ev.was_reset.sum(0), np.full(32, E))


def test_events_seed_determinism():
    """Same seeds, same event stream; different seeds, different stream."""
    nS = tables.build_statespace(CFG).nS
    pol_a, pol_b = _policies(nS)
    s = np.arange(16, dtype=np.uint32)
    _, a = _events(CFG, s, pol_a, pol_b, 120)
    _, b = _events(CFG, s, pol_a, pol_b, 120)
    _, c = _events(CFG, s + 1000, pol_a, pol_b, 120)
    assert np.array_equal(a.raw, b.raw)
    assert not np.array_equal(a.raw, c.raw)
