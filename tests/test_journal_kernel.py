"""Journaled fused rollout: bit-exactness vs the pure-XLA twin, journal
decoding, and non-perturbation of the stats-only kernel's trajectories.

The reference's step() emits the full transition every tick
(soccer_simultaneous_env.py:375-408); `pallas_journal_rollout` streams
that per-step record from the fused lane loop.  The Triton kernel runs
in interpreter mode on CPU here; the `gpu`-marked test re-validates
bit-exactness on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import tables
from gym_soccer_tpu.ops.step_kernel import (
    pallas_journal_rollout, pallas_journal_rollout_chained, pallas_rollout,
    unpack_journal)

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def test_journal_matches_xla_twin_bit_exact():
    """Same counter PRNG (seed, step, word, global lane) => the kernel's
    journal equals the pure-XLA twin's word-for-word, and the final
    state fields match."""
    B, T = 1024, 96
    fields, stats, journal = pallas_journal_rollout(
        CFG, jnp.int32(5), B, T, interpret=True)
    tfields, _, tjournal = pallas_journal_rollout(CFG, jnp.int32(5), B, T,
                                                  backend="xla")
    assert np.array_equal(np.asarray(journal), np.asarray(tjournal))
    for a, b in zip(fields, tfields):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_journal_nonperturbing():
    """Journaling must not change the trajectory: final fields and stats
    equal the stats-only kernel's for the same (seed, batch, steps)."""
    B, T = 1024, 80
    jfields, jstats, _ = pallas_journal_rollout(
        CFG, jnp.int32(3), B, T, interpret=True)
    pfields, pstats = pallas_rollout(CFG, jnp.int32(3), B, T,
                                     interpret=True)
    for a, b in zip(jfields, pfields):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in jstats] == [int(x) for x in pstats]


def test_journal_blocking_and_slab_invariance():
    """The journal is bit-invariant to the lane blocking (PRNG keys on
    global lane id; blocks only re-tile the lanes)."""
    B, T = 1024, 64
    _, _, j0 = pallas_journal_rollout(CFG, jnp.int32(9), B, T,
                                      interpret=True)
    _, _, j1 = pallas_journal_rollout(CFG, jnp.int32(9), B, T,
                                      interpret=True, block=512)
    _, _, j2 = pallas_journal_rollout(CFG, jnp.int32(9), B, T,
                                      interpret=True, block=1024)
    assert np.array_equal(np.asarray(j0), np.asarray(j1))
    assert np.array_equal(np.asarray(j0), np.asarray(j2))


def test_journal_chained_matches_single_call():
    B, T = 1024, 96
    _, _, j0 = pallas_journal_rollout(CFG, jnp.int32(11), B, T,
                                      interpret=True)
    fields, stats, chunks = pallas_journal_rollout_chained(
        CFG, jnp.int32(11), B, T, steps_per_call=32, interpret=True)
    j1 = np.concatenate([np.asarray(c) for c in chunks], axis=0)
    assert np.array_equal(np.asarray(j0), j1)


def test_unpack_journal_reference_shaped_stream():
    """Decoded stream must be internally consistent and reproduce the
    kernel's stats exactly; terminal lanes follow the reference's obs
    codec (goal -> dense 0) and teleport to ISD states."""
    B, T = 1024, 128
    _, stats, journal = pallas_journal_rollout(CFG, jnp.int32(7), B, T,
                                               interpret=True)
    out = {k: np.asarray(v) for k, v in unpack_journal(CFG, journal).items()}
    rew, goals, truncs = (int(x) for x in stats)
    assert int(out["done"].sum()) == goals
    assert int(out["truncated"].sum()) == truncs
    assert int(out["reward_a"].sum()) == rew
    # rewards only on goal steps, sign matches the scoring side
    assert (out["reward_a"][~out["done"]] == 0).all()
    assert (np.abs(out["reward_a"][out["done"]]) == 1).all()
    # actions decode to the 5-action space
    for k in ("actions_a", "actions_b"):
        assert out[k].min() >= 0 and out[k].max() <= 4
    # goal steps observe terminal dense index 0 pre-reset
    assert (out["final_obs"][out["done"]] == 0).all()
    ss = tables.build_statespace(CFG)
    nS = ss.nS
    assert out["final_obs"].min() >= 0 and out["final_obs"].max() < nS
    # post-reset obs of terminated lanes is one of the ISD states
    isd_dense = set(ss.raw_to_dense[ss.isd_raw].tolist())
    term = out["done"] | out["truncated"]
    assert set(np.unique(out["obs"][term]).tolist()) <= isd_dense
    # non-terminated lanes: post-step obs == pre-reset obs, never terminal
    assert np.array_equal(out["obs"][~term], out["final_obs"][~term])
    assert (out["obs"][~term] > 0).all()


def test_journal_works_on_the_big_grid():
    """11x7 raw codes (16562) fit the 16-bit field; the word must decode
    back to valid dense states."""
    cfg = EnvConfig(width=11, height=7, slip_prob=0.2)
    B, T = 1024, 16
    _, stats, journal = pallas_journal_rollout(cfg, jnp.int32(1), B, T,
                                               interpret=True)
    out = unpack_journal(cfg, journal)
    nS = tables.build_statespace(cfg).nS
    fo = np.asarray(out["final_obs"])
    assert fo.min() >= 0 and fo.max() < nS
    assert int(np.asarray(out["done"]).sum()) == int(stats[1])


@pytest.mark.slow
@pytest.mark.gpu
def test_journal_gpu_bit_exact(gpu):
    """The compiled kernel's journal must equal the XLA twin bit-for-bit
    on the card (the journal path is all-int32, but validation on the
    device is the house rule for anything claiming exactness)."""
    B, T = 262144, 256
    _, _, journal = pallas_journal_rollout(CFG, jnp.int32(21), B, T)
    _, _, tjournal = pallas_journal_rollout(CFG, jnp.int32(21), B, T,
                                            backend="xla")
    assert np.array_equal(np.asarray(journal), np.asarray(tjournal))
