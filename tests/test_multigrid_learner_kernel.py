"""Fused learner chunks over MIXED-geometry batches (XLA twin on CPU):
single-variant equivalence with the static-geometry chunk, per-variant
accounting, and training progress on a mixture (ops/learner_kernel's
multigrid mode -- BASELINE config 4, training edition)."""
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import tables
from gym_soccer_tpu.ops import learner_kernel as lk

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
CFG2 = EnvConfig(width=6, height=5, slip_prob=0.1)
CFG117 = EnvConfig(width=11, height=7, slip_prob=0.2)


def _uniform_m(cfg):
    nS = (sum(tables.build_statespace(c).nS for c in cfg)
          if isinstance(cfg, tuple) else tables.build_statespace(cfg).nS)
    return lk.pack_m(cfg, jnp.full((nS, 5), 0.2), jnp.full((nS, 5), 0.2),
                     jnp.zeros(nS), eps=0.3), nS


def test_mg_single_variant_is_bit_identical_to_static_kernel():
    """cfgs=(CFG,) must reproduce the static-geometry kernel exactly:
    same lane counters, same ISD spread, same table rows -- geometry
    moving from code to data cannot change a single bit."""
    B, T = 1024, 12
    m1, _ = _uniform_m(CFG)
    mg, _ = _uniform_m((CFG,))
    assert np.array_equal(np.asarray(m1, np.float32),
                          np.asarray(mg, np.float32))
    f1 = lk.init_state_fields(CFG, B)
    planes, fmg = lk.init_state_fields((CFG,), B)
    for a, b in zip(f1, fmg):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    out1 = lk.learner_chunk(CFG, 7, m1, f1, B, T, backend="xla")
    outg = lk.multigrid_learner_chunk((CFG,), 7, mg, planes, fmg, B, T,
                                      backend="xla")
    for a, b in zip(out1[0], outg[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(out1[1]), np.asarray(outg[1]))
    for a, b in zip(out1[2], outg[2]):
        assert int(np.asarray(a)) == int(np.asarray(b))


def test_mg_chunk_accumulates_per_variant():
    cfgs = (CFG, CFG2)
    B, T = 1024, 16
    m, nS_total = _uniform_m(cfgs)
    planes, fields = lk.init_state_fields(cfgs, B)
    fields2, acc, stats = lk.multigrid_learner_chunk(
        cfgs, 0, m, planes, fields, B, T, backend="xla")
    sum_td, cnt = lk.unpack_acc(cfgs, acc)
    cnt = np.asarray(cnt)
    assert cnt.shape == (nS_total, 5, 5)
    assert cnt.sum() == B * T
    # lanes are assigned round-robin: exactly half the visits per variant
    nS0 = tables.build_statespace(CFG).nS
    assert cnt[:nS0].sum() == (B // 2) * T
    assert cnt[nS0:].sum() == (B // 2) * T
    # with v=0 the residual is the reward, held exactly in fixed point
    rew = int(np.asarray(stats[0]))
    assert float(np.asarray(sum_td).sum()) == rew
    assert int(np.asarray(stats[1])) > 0
    # each lane's state stays inside its OWN board
    H = np.asarray(planes[0])
    W = np.asarray(planes[1])
    for f, hi in zip(fields2[:4], (H, W, H, W)):
        arr = np.asarray(f)
        assert (arr >= 0).all() and (arr < hi).all()


def test_mg_big_grid_mixture_packed_accounting():
    """The reference's own big grid (nS=11705, soccer_simultaneous_env.py
    :501) trains INSIDE a mixture: per-lane code offsets must hold with a
    big variant in the mix -- exact per-variant visit accounting, and the
    Triton chunk (interpret mode) stepping the twin's trajectories."""
    cfgs = (CFG, CFG117)
    B, T = 256, 4
    nS = sum(tables.build_statespace(c).nS for c in cfgs)
    v = jnp.zeros(nS, jnp.float32)
    uni = jnp.full((nS, 5), 0.2, jnp.float32)
    m = lk.pack_m(cfgs, uni, uni, v, eps=0.3)
    planes, fields = lk.init_state_fields(cfgs, B)
    f2, acc2, st2 = lk.multigrid_learner_chunk(
        cfgs, 3, m, planes, fields, B, T, backend="xla")
    sum_res, cnt = lk.unpack_acc(cfgs, acc2)
    cnt = np.asarray(cnt)
    nS0 = tables.build_statespace(CFG).nS
    assert cnt.sum() == B * T
    # blocked lane layout: each variant holds exactly half the lanes
    assert cnt[:nS0].sum() == (B // 2) * T
    assert cnt[nS0:].sum() == (B // 2) * T
    assert float(np.asarray(sum_res).sum()) == int(np.asarray(st2[0]))
    f1, _, st1 = lk.multigrid_learner_chunk(
        cfgs, 3, m, planes, fields, B, T, interpret=True)
    for a, b in zip(f1, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in st1] == [int(x) for x in st2]


def test_mg_big_single_variant_matches_static_packed():
    """(11x7,) as a one-variant mixture must reproduce the static 11x7
    chunk bit-for-bit (counts/sums here are integer-exact)."""
    B, T = 256, 3
    nS = tables.build_statespace(CFG117).nS
    v = jnp.zeros(nS, jnp.float32)
    uni = jnp.full((nS, 5), 0.2, jnp.float32)
    m = lk.pack_m(CFG117, uni, uni, v, eps=0.3)
    mg = lk.pack_m((CFG117,), uni, uni, v, eps=0.3)
    assert np.array_equal(np.asarray(m), np.asarray(mg))
    f1 = lk.init_state_fields(CFG117, B)
    planes, fmg = lk.init_state_fields((CFG117,), B)
    for a, b in zip(f1, fmg):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    out1 = lk.learner_chunk(CFG117, 7, m, f1, B, T, backend="xla")
    outg = lk.multigrid_learner_chunk((CFG117,), 7, mg, planes, fmg, B, T,
                                      backend="xla")
    for a, b in zip(out1[0], outg[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(out1[1]), np.asarray(outg[1]))
    for a, b in zip(out1[2], outg[2]):
        assert int(np.asarray(a)) == int(np.asarray(b))


def test_mg_blocked_layout_offsets():
    """init_state_fields' multigrid mode assigns variants in contiguous
    lane chunks, and each lane's code-offset plane points at its
    variant's block of table rows."""
    cfgs = (CFG, CFG2, CFG117)
    B = 1536
    planes, _ = lk.init_state_fields(cfgs, B)
    H, off = np.asarray(planes[0]).ravel(), np.asarray(planes[5]).ravel()
    vid = np.arange(B) * 3 // B
    assert np.array_equal(H, np.asarray([c.H for c in cfgs])[vid])
    assert np.array_equal(off, lk.code_offsets(cfgs)[vid])
    assert lk.n_codes(cfgs) == sum(lk.n_codes(c) for c in cfgs)


@pytest.mark.slow
def test_fused_mg_training_learns_both_variants():
    """fused_minimax_train with a tuple cfg trains ONE concatenated table
    over the mixture; both variants' value slices must move and stay in
    the game's range, and policies stay normalized."""
    cfgs = (CFG, CFG2)
    q, v, pa, pb, hist = lk.fused_minimax_train(
        cfgs, batch=1024, n_chunks=30, chunk_len=16, lr=0.4, eps=0.3,
        solver_iters=100, backend="xla")
    nS0 = tables.build_statespace(CFG).nS
    v = np.asarray(v)
    for sl in (slice(0, nS0), slice(nS0, None)):
        assert float(np.abs(v[sl]).max()) > 0.05, "variant values never moved"
        assert float(np.abs(v[sl]).max()) <= 1.05
    assert np.allclose(np.asarray(pa).sum(-1), 1.0, atol=1e-3)
    assert sum(h[1] for h in hist) > 0
