"""Fused independent-Q chunks (ops/iql_kernel): packing, exact
dual-player TD/count accounting and greedy semantics on the XLA twin,
training progress, and the Triton kernel (interpret mode) stepping the
twin's trajectories."""
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import tables
from gym_soccer_tpu.ops import iql_kernel as ik

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
NS = tables.build_statespace(CFG).nS


def test_iql_pack_unpack_roundtrip():
    rng = np.random.RandomState(0)
    q_a = jnp.asarray(rng.uniform(-1, 1, (NS, 5)).astype(np.float32))
    q_b = jnp.asarray(rng.uniform(-1, 1, (NS, 5)).astype(np.float32))
    m = np.asarray(ik.pack_iql_m(CFG, q_a, q_b)).reshape(-1, ik.M_COLS)
    rows = ik._cell_rows(CFG)
    # f32 tables hold both players' Q exactly
    assert np.array_equal(m[rows, ik.COL_QA:ik.COL_QA + 5], np.asarray(q_a))
    assert np.array_equal(m[rows, ik.COL_QB:ik.COL_QB + 5], np.asarray(q_b))


def test_iql_chunk_accumulates_both_players_exactly():
    B, T = 1024, 16
    m = ik.pack_iql_m(CFG, jnp.zeros((NS, 5)), jnp.zeros((NS, 5)))
    fields = ik.init_iql_state_fields(CFG, B)
    fields2, acc, stats = ik.iql_chunk(CFG, 0, int(0.3 * 65536), m,
                                       fields, B, T, backend="xla")
    sum_a, cnt_a, sum_b, cnt_b = (np.asarray(x)
                                  for x in ik.unpack_iql_acc(CFG, acc))
    # each player updates exactly one cell per env per step
    assert cnt_a.sum() == B * T and cnt_b.sum() == B * T
    # with q=0: td_a == r and td_b == -r, so the sums are exact negations
    rew = int(np.asarray(stats[0]))
    assert float(sum_a.sum()) == rew
    assert float(sum_b.sum()) == -rew
    assert int(np.asarray(stats[1])) > 0, "random-ish play must score"
    for f, hi in zip(fields2[:4], (CFG.H, CFG.W, CFG.H, CFG.W)):
        arr = np.asarray(f)
        assert (arr >= 0).all() and (arr < hi).all()


@pytest.mark.parametrize("block", [128, 256])
def test_iql_packed_chunk_matches_unpacked(block):
    """The Triton IQL chunk (interpret mode) steps the twin's
    trajectories bit for bit for equal Q contents (fields and stats; the
    accumulator is checked on the twin)."""
    B, T = 640, 16
    rng = np.random.RandomState(2)
    q_a = jnp.asarray(rng.uniform(-1, 1, (NS, 5)).astype(np.float32))
    q_b = jnp.asarray(rng.uniform(-1, 1, (NS, 5)).astype(np.float32))
    fields = ik.init_iql_state_fields(CFG, B)
    eps = int(0.3 * 65536)
    m = ik.pack_iql_m(CFG, q_a, q_b)
    f1, _, st1 = ik.iql_chunk(CFG, 9, eps, m, fields, B, T, interpret=True,
                              block=block)
    f2, acc, st2 = ik.iql_chunk(CFG, 9, eps, m, fields, B, T,
                                backend="xla")
    for a, b in zip(f1, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            "Triton and twin IQL chunks diverged in trajectory"
    assert [int(x) for x in st1] == [int(x) for x in st2]
    _, ca, _, cb = (np.asarray(x) for x in ik.unpack_iql_acc(CFG, acc))
    assert ca.sum() == B * T and cb.sum() == B * T


def test_fused_iql_training_learns_packed():
    """fused_iql_train's grouped-dispatch path trains: both tables
    move."""
    q_a, q_b, hist = ik.fused_iql_train(
        CFG, batch=1024, n_chunks=20, chunk_len=16, lr=0.5, eps=0.3,
        backend="xla", chunks_per_dispatch=4)
    assert float(jnp.abs(q_a).max()) > 0.01
    assert float(jnp.abs(q_b).max()) > 0.01
    assert sum(h[1] for h in hist) > 0


def test_iql_chunks_per_dispatch_grouping_invariant():
    """fused_iql_train's grouped-dispatch mode must be invariant to the
    group size (in-graph f32 schedules; includes a remainder segment)."""
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.6, eps=0.35,
              eps_halflife=64, eps_min=0.1, lr_anneal_start=2,
              lr_anneal_tau=4.0, seed=5, backend="xla")
    qa1, qb1, h1 = ik.fused_iql_train(CFG, chunks_per_dispatch=7, **kw)
    qa2, qb2, h2 = ik.fused_iql_train(CFG, chunks_per_dispatch=3, **kw)
    assert np.array_equal(np.asarray(qa1), np.asarray(qa2))
    assert np.array_equal(np.asarray(qb1), np.asarray(qb2))
    assert h1 == h2


def test_iql_eps_zero_is_greedy():
    """eps=0 with all-zero Q: both players NOOP forever -> no goals, and
    only the NOOP columns are visited."""
    B, T = 512, 12
    m = ik.pack_iql_m(CFG, jnp.zeros((NS, 5)), jnp.zeros((NS, 5)))
    fields = ik.init_iql_state_fields(CFG, B)
    _, acc, stats = ik.iql_chunk(CFG, 3, 0, m, fields, B, T,
                                 backend="xla")
    assert int(np.asarray(stats[1])) == 0
    _, cnt_a, _, cnt_b = (np.asarray(x) for x in ik.unpack_iql_acc(CFG, acc))
    assert cnt_a[:, 0].sum() == B * T and (cnt_a[:, 1:] == 0).all()
    assert cnt_b[:, 0].sum() == B * T and (cnt_b[:, 1:] == 0).all()


def test_iql_players_explore_independently():
    """A's and B's exploration draws come from different PRNG words: with
    full exploration the two players' action marginals must decorrelate
    (a shared draw would force aa == ab always)."""
    B, T = 512, 8
    m = ik.pack_iql_m(CFG, jnp.zeros((NS, 5)), jnp.zeros((NS, 5)))
    fields = ik.init_iql_state_fields(CFG, B)
    _, acc, _ = ik.iql_chunk(CFG, 5, 65536, m, fields, B, T,
                             backend="xla")
    _, cnt_a, _, cnt_b = (np.asarray(x) for x in ik.unpack_iql_acc(CFG, acc))
    # both marginals roughly uniform over the 5 actions
    for cnt in (cnt_a, cnt_b):
        per_action = cnt.sum(0)
        assert per_action.min() > 0.15 * B * T / 5


def test_fused_iql_training_learns():
    q_a, q_b, hist = ik.fused_iql_train(
        CFG, batch=1024, n_chunks=30, chunk_len=16, lr=0.4, eps=0.3,
        backend="xla")
    q_a, q_b = np.asarray(q_a), np.asarray(q_b)
    assert np.abs(q_a).max() > 0.05 and np.abs(q_b).max() > 0.05
    assert np.abs(q_a).max() <= 1.05 and np.abs(q_b).max() <= 1.05
    assert sum(h[1] for h in hist) > 0
    # zero-sum structure: A's and B's values are anticorrelated on
    # heavily-visited states (B learns from -r)
    va, vb = q_a.max(-1), q_b.max(-1)
    mask = (np.abs(va) > 0.2) & (np.abs(vb) > 0.2)
    if mask.sum() > 20:
        corr = np.corrcoef(va[mask], vb[mask])[0, 1]
        assert corr < 0.5, corr


def test_iql_chunk_step_offset_changes_stream():
    """step_offset keys the counter PRNG: the same chunk at another
    absolute step draws other actions and visits other cells."""
    B, T = 512, 8
    m = ik.pack_iql_m(CFG, jnp.zeros((NS, 5)), jnp.zeros((NS, 5)))
    fields = ik.init_iql_state_fields(CFG, B)
    eps = int(0.9 * 65536)
    _, acc1, _ = ik.iql_chunk(CFG, 3, eps, m, fields, B, T, backend="xla")
    _, acc2, _ = ik.iql_chunk(CFG, 3, eps, m, fields, B, T, step_offset=T,
                              backend="xla")
    _, acc3, _ = ik.iql_chunk(CFG, 3, eps, m, fields, B, T, backend="xla")
    assert np.array_equal(np.asarray(acc1), np.asarray(acc3))
    assert not np.array_equal(np.asarray(acc1), np.asarray(acc2))


def test_fused_iql_warm_start_lr_zero():
    rng = np.random.RandomState(1)
    q0a = jnp.asarray(rng.uniform(-0.5, 0.5, (NS, 5)), jnp.float32)
    q0b = jnp.asarray(rng.uniform(-0.5, 0.5, (NS, 5)), jnp.float32)
    q_a, q_b, _ = ik.fused_iql_train(CFG, batch=512, n_chunks=1,
                                     chunk_len=4, lr=0.0, eps=0.5,
                                     backend="xla", init=(q0a, q0b))
    assert np.array_equal(np.asarray(q_a), np.asarray(q0a))
    assert np.array_equal(np.asarray(q_b), np.asarray(q0b))


def test_fused_iql_exact_resume():
    """3+3 chunks across a utils/checkpoint roundtrip == 6 uninterrupted
    chunks, bit-for-bit (same contract as the minimax and alternating
    fused trainers)."""
    import os
    import tempfile
    from gym_soccer_tpu.utils import checkpoint as ckpt
    kw = dict(batch=256, chunk_len=4, lr=0.4, eps=0.4, eps_halflife=24,
              lr_anneal_start=2, lr_anneal_tau=4.0, seed=13,
              backend="xla")
    qac, qbc, _, res_c = ik.fused_iql_train(CFG, n_chunks=6,
                                            return_state=True, **kw)
    _, _, _, r1 = ik.fused_iql_train(CFG, n_chunks=3, return_state=True,
                                     **kw)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ck.npz")
        ckpt.save_pytree(p, r1)
        r1 = ckpt.load_pytree(p, r1)
    qa, qb, _, res = ik.fused_iql_train(
        CFG, n_chunks=3, return_state=True, init=(r1["q_a"], r1["q_b"]),
        fields_init=r1["fields"], start_chunk=int(r1["next_chunk"]), **kw)
    assert int(res["next_chunk"]) == int(res_c["next_chunk"]) == 6
    assert np.array_equal(np.asarray(qa), np.asarray(qac))
    assert np.array_equal(np.asarray(qb), np.asarray(qbc))
    for a, b in zip(res["fields"], res_c["fields"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
