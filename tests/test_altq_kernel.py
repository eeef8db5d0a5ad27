"""Fused alternating-turn Q-learner chunks (ops/altq_kernel): packing
roundtrips, TD/count accumulation on the XLA twin, the Triton kernel
(interpret mode) stepping the twin's trajectories, and convergence
toward the exact turn-based minimax values."""
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.ops import altq_kernel as ak

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def _nS():
    from gym_soccer_tpu.envs.soccer_alternating_env import build_alt_tables
    return build_alt_tables(CFG).nS


def test_alt_pack_unpack_roundtrip():
    nS = _nS()
    rng = np.random.RandomState(0)
    q = jnp.asarray(rng.uniform(-1, 1, (nS, 5)).astype(np.float32))
    m = np.asarray(ak.pack_alt_m(CFG, q)).reshape(-1, ak.M_COLS)
    rows, turn = ak._alt_rows(CFG)
    # f32 tables: the mover's 5 columns hold q exactly
    got = np.where((turn == 0)[:, None], m[rows, 0:5], m[rows, 5:10])
    assert np.array_equal(got, np.asarray(q))
    # (row, turn) is unique per dense state -> no packing collisions
    assert len({(int(r), int(t)) for r, t in zip(rows, turn)}) == nS
    assert rows.min() >= 0 and rows.max() < ak.n_codes(CFG)
    # unpack_alt_acc inverts the acc layout: cell (row*2 + turn)*5 + a
    acc = np.zeros((2 * ak.n_codes(CFG) * 5, 4), np.int32)
    cells = (rows * 2 + turn) * 5
    acc[cells[turn == 0], 1] = 3 << 21  # folded frac word: 3 * 2^21 / 2^24
    acc[cells[turn == 1] + 4, 2] = 7    # count of action 4
    td, cnt = (np.asarray(x) for x in ak.unpack_alt_acc(
        CFG, jnp.asarray(acc.reshape(-1))))
    assert (td[turn == 0, 0] == 3 / 8).all()
    assert (td[turn == 1] == 0).all()
    assert (cnt[turn == 1, 4] == 7).all() and cnt.sum() == 7 * (turn == 1).sum()


@pytest.mark.parametrize("block", [128, 256])
def test_altq_packed_chunk_matches_unpacked(block):
    """The Triton alternating chunk (interpret mode) steps the twin's
    trajectories bit for bit for equal Q contents (fields and stats;
    the accumulator is checked on the twin)."""
    B, T = 640, 16
    nS = _nS()
    rng = np.random.RandomState(4)
    q = jnp.asarray(rng.uniform(-1, 1, (nS, 5)).astype(np.float32))
    fields = ak.init_alt_state_fields(CFG, B)
    eps = int(0.3 * 65536)
    m = ak.pack_alt_m(CFG, q)
    f1, _, st1 = ak.altq_chunk(CFG, 11, eps, m, fields, B, T,
                               interpret=True, block=block)
    f2, acc, st2 = ak.altq_chunk(CFG, 11, eps, m, fields, B, T,
                                 backend="xla")
    for a, b in zip(f1, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            "Triton and twin altq chunks diverged in trajectory"
    assert [int(x) for x in st1] == [int(x) for x in st2]
    _, cnt = ak.unpack_alt_acc(CFG, acc)
    assert int(np.asarray(cnt).sum()) == B * T


def test_fused_altq_training_learns_packed():
    """fused_altq_train's grouped-dispatch path trains."""
    q, hist = ak.fused_altq_train(
        CFG, batch=1024, n_chunks=20, chunk_len=16, lr=0.5, eps=0.3,
        backend="xla")
    assert float(jnp.abs(q).max()) > 0.01
    assert sum(h[1] for h in hist) > 0


def test_altq_chunks_per_dispatch_grouping_invariant():
    """fused_altq_train's grouped-dispatch mode must be invariant to the
    group size (in-graph f32 schedules; includes a remainder segment)."""
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.6, eps=0.35,
              eps_halflife=64, eps_min=0.1, lr_anneal_start=2,
              lr_anneal_tau=4.0, seed=5, backend="xla")
    q1, h1 = ak.fused_altq_train(CFG, chunks_per_dispatch=7, **kw)
    q2, h2 = ak.fused_altq_train(CFG, chunks_per_dispatch=3, **kw)
    assert np.array_equal(np.asarray(q1), np.asarray(q2))
    assert h1 == h2


def test_alt_chunk_accumulates_visits_and_valid_tds():
    B, T = 1024, 16
    nS = _nS()
    m = ak.pack_alt_m(CFG, jnp.zeros((nS, 5)))
    fields = ak.init_alt_state_fields(CFG, B)
    fields2, acc, stats = ak.altq_chunk(CFG, 0, int(0.3 * 65536), m,
                                        fields, B, T, backend="xla")
    sum_td, cnt = ak.unpack_alt_acc(CFG, acc)
    cnt = np.asarray(cnt)
    # exactly one visit per env per tick
    assert cnt.sum() == B * T
    assert (cnt >= 0).all()
    # with q=0: td == reward, so the total TD mass equals the reward sum
    rew = int(np.asarray(stats[0]))
    assert float(np.asarray(sum_td).sum()) == rew
    assert int(np.asarray(stats[1])) > 0, "random play must score"
    # fields stay on the board; turn stays binary
    for f, hi in zip(fields2[:4], (CFG.H, CFG.W, CFG.H, CFG.W)):
        arr = np.asarray(f)
        assert (arr >= 0).all() and (arr < hi).all()
    assert set(np.unique(np.asarray(fields2[5]))) <= {0, 1}


def test_alt_chunk_eps_zero_is_greedy_and_offset_changes_stream():
    """eps=0 must follow the packed Q greedily (all-zero Q -> action 0 =
    NOOP everywhere -> nobody ever scores), and a different step_offset
    must decorrelate the PRNG stream."""
    B, T = 512, 12
    nS = _nS()
    m = ak.pack_alt_m(CFG, jnp.zeros((nS, 5)))
    fields = ak.init_alt_state_fields(CFG, B)
    _, acc, stats = ak.altq_chunk(CFG, 3, 0, m, fields, B, T,
                                  backend="xla")
    assert int(np.asarray(stats[1])) == 0, "greedy NOOP play cannot score"
    # with ties, argmax picks action 0: only the NOOP column is visited
    _, cnt = ak.unpack_alt_acc(CFG, acc)
    cnt = np.asarray(cnt)
    assert cnt[:, 0].sum() == B * T and (cnt[:, 1:] == 0).all()
    _, acc1, _ = ak.altq_chunk(CFG, 3, int(0.9 * 65536), m, fields, B, T,
                               backend="xla")
    _, acc2, _ = ak.altq_chunk(CFG, 3, int(0.9 * 65536), m, fields, B, T,
                               step_offset=T, backend="xla")
    assert not np.array_equal(np.asarray(acc1), np.asarray(acc2))


def test_fused_altq_warm_start_and_lr_zero():
    nS = _nS()
    rng = np.random.RandomState(0)
    q0 = jnp.asarray(rng.uniform(-0.5, 0.5, (nS, 5)), jnp.float32)
    q, _ = ak.fused_altq_train(CFG, batch=512, n_chunks=1, chunk_len=4,
                               lr=0.0, eps=0.5, backend="xla", init=q0)
    assert np.array_equal(np.asarray(q), np.asarray(q0))


def test_altq_backend_validation():
    """The launcher names its backends; an unknown one, or interpret mode
    on the twin, fails before anything runs."""
    with pytest.raises(ValueError, match="backend"):
        ak.fused_altq_train(CFG, batch=256, n_chunks=1, chunk_len=2,
                            backend="mosaic")
    from gym_soccer_tpu.envs.soccer_alternating_env import build_alt_tables
    m = ak.pack_alt_m(CFG, jnp.zeros((build_alt_tables(CFG).nS, 5)))
    fields = ak.init_alt_state_fields(CFG, 256)
    with pytest.raises(ValueError, match="interpret"):
        ak.altq_chunk(CFG, 0, 0, m, fields, 256, 2, backend="xla",
                      interpret=True)


@pytest.mark.slow
def test_fused_altq_trains_toward_minimax_values():
    """CPU smoke (XLA twin) of the full recipe: the chunked fused
    learner's V (max at A-to-move, min at B-to-move) must approach the
    exact alt_value_iteration values -- same lr=1 empirical-Bellman phase
    + polynomial anneal as the minimax chunk.  The full-scale contract
    runs in test_altq_convergence_gpu on the card."""
    from gym_soccer_tpu.envs.soccer_alternating_env import (
        alt_policy_rollout, alt_value_iteration, build_alt_tables)
    from gym_soccer_tpu.agents import learners
    gamma = 0.9  # short horizon so CPU step counts suffice
    tb = build_alt_tables(CFG)
    _, V_star, _, _ = alt_value_iteration(tb, gamma=gamma)
    q, hist = ak.fused_altq_train(
        CFG, batch=4096, n_chunks=120, chunk_len=8, lr=1.0, eps=0.3,
        gamma=gamma, lr_anneal_start=60, lr_anneal_tau=10.0,
        lr_anneal_pow=1.5, seed=5, backend="xla")
    q = np.asarray(q)
    V_l = np.where(tb.turn == 0, q.max(-1), q.min(-1))
    err = np.abs(V_l - np.asarray(V_star))
    base = np.abs(np.asarray(V_star)).mean()  # error of the zero init
    assert err.mean() < base / 4, (err.mean(), base)
    # the greedy policy must dominate a frozen random opponent
    pol = np.asarray(learners.altq_greedy_policy(CFG, q))
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    w, losses, _ = alt_policy_rollout(CFG, tb.raw_to_dense, pol, randpol,
                                      batch=128, steps=300, seed=6)
    assert w > 0 and w / max(w + losses, 1) > 0.9, (w, losses)


@pytest.mark.slow
@pytest.mark.gpu
def test_altq_convergence_gpu(gpu):
    """Full-scale fused alternating self-play at gamma=0.99: mean
    |V - V*| <= 0.05 vs the exact solver and >95% win rate of the greedy
    policy vs frozen random."""
    from gym_soccer_tpu.envs.soccer_alternating_env import (
        alt_policy_rollout, alt_value_iteration, build_alt_tables)
    from gym_soccer_tpu.agents import learners
    tb = build_alt_tables(CFG)
    _, V_star, _, _ = alt_value_iteration(tb)
    q, _ = ak.fused_altq_train(
        CFG, batch=65536, n_chunks=400, chunk_len=32, lr=1.0, eps=0.25,
        eps_min=0.1, eps_halflife=300_000, lr_anneal_start=200,
        lr_anneal_tau=25.0, lr_anneal_pow=1.5, seed=1)
    q = np.asarray(q)
    V_l = np.where(tb.turn == 0, q.max(-1), q.min(-1))
    err = np.abs(V_l - np.asarray(V_star))
    assert err.mean() <= 0.05, err.mean()
    pol = np.asarray(learners.altq_greedy_policy(CFG, q))
    randpol = np.random.RandomState(0).randint(0, 5, tb.nS).astype(np.int32)
    w, losses, _ = alt_policy_rollout(CFG, tb.raw_to_dense, pol, randpol,
                                      batch=256, steps=300, seed=6)
    assert w / max(w + losses, 1) > 0.95, (w, losses)


def test_fused_altq_exact_resume():
    """3+3 chunks across a utils/checkpoint roundtrip == 6 uninterrupted
    chunks, bit-for-bit (seeds, eps schedule and the in-kernel
    step_offset all key off the absolute chunk index)."""
    import os
    import tempfile
    from gym_soccer_tpu.utils import checkpoint as ckpt
    kw = dict(batch=256, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=24,
              lr_anneal_start=2, lr_anneal_tau=4.0, seed=11,
              backend="xla")
    qc, _, res_c = ak.fused_altq_train(CFG, n_chunks=6, return_state=True,
                                       **kw)
    _, _, r1 = ak.fused_altq_train(CFG, n_chunks=3, return_state=True,
                                   **kw)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ck.npz")
        ckpt.save_pytree(p, r1)
        r1 = ckpt.load_pytree(p, r1)
    q, _, res = ak.fused_altq_train(
        CFG, n_chunks=3, return_state=True, init=r1["q"],
        fields_init=r1["fields"], start_chunk=int(r1["next_chunk"]), **kw)
    assert int(res["next_chunk"]) == int(res_c["next_chunk"]) == 6
    assert np.array_equal(np.asarray(q), np.asarray(qc))
    for a, b in zip(res["fields"], res_c["fields"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
