"""Fused minimax-Q chunks: TD/count accumulation on the XLA twin,
training progress, packing roundtrips, and the Triton kernel (interpret
mode on CPU) stepping the twin's trajectories."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.ops import learner_kernel as lk

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def test_pack_unpack_roundtrip():
    nS = 761
    rng = np.random.RandomState(0)
    v = jnp.asarray(rng.uniform(-1, 1, nS).astype(np.float32))
    pa = jnp.asarray(rng.dirichlet(np.ones(5), nS).astype(np.float32))
    pb = jnp.full((nS, 5), 0.2, jnp.float32)
    m = np.asarray(lk.pack_m(CFG, pa, pb, v, eps=0.1)).reshape(-1, lk.M_COLS)
    rows = lk._cell_rows(CFG)
    # f32 tables: v is stored exactly, policies exploration-mixed
    assert np.array_equal(m[rows, lk.COL_V], np.asarray(v))
    np.testing.assert_allclose(m[rows, lk.COL_PI_A:lk.COL_PI_A + 5],
                               np.asarray(pa) * 0.9 + 0.02, rtol=1e-6)
    np.testing.assert_allclose(m[rows, lk.COL_PI_B:lk.COL_PI_B + 5], 0.2,
                               rtol=1e-6)
    # compact rows are unique and in range
    assert len(np.unique(rows)) == nS
    assert rows.min() >= 0 and rows.max() < lk.n_codes(CFG)
    # folded accumulator decode: whole + frac / 2^24 (frac's excess
    # carried into whole) and the count word
    acc = np.zeros((lk.n_codes(CFG) * lk.NJ, lk.ACC_WORDS), np.int32)
    cell = rows[5] * lk.NJ + 7
    acc[cell] = (-3, (1 << 24) + 100, 9, 0)
    sum_res, cnt = lk.unpack_acc(CFG, jnp.asarray(acc.reshape(-1)))
    assert float(sum_res[5, 1, 2]) == -2 + 100 / 2 ** 24
    assert float(cnt[5, 1, 2]) == 9 and float(np.asarray(cnt).sum()) == 9


def test_chunk_accumulates_visits_and_valid_tds():
    B, T = 1024, 16
    m = lk.pack_m(CFG, jnp.full((761, 5), 0.2), jnp.full((761, 5), 0.2),
                  jnp.zeros(761), 0.3)
    fields = lk.init_state_fields(CFG, B)
    fields2, acc, stats = lk.learner_chunk(CFG, 0, m, fields, B, T,
                                           backend="xla")
    sum_res, cnt = lk.unpack_acc(CFG, acc)
    cnt = np.asarray(cnt)
    # exactly one visit per env per step
    assert cnt.sum() == B * T
    assert (cnt >= 0).all()
    # with v=0 the residual IS the reward, which fixed point holds
    # exactly: the residual sum equals the total reward
    rew = int(np.asarray(stats[0]))
    assert float(np.asarray(sum_res).sum()) == rew
    # fields stay on the board
    for f, hi in zip(fields2[:4], (CFG.H, CFG.W, CFG.H, CFG.W)):
        arr = np.asarray(f)
        assert (arr >= 0).all() and (arr < hi).all()


def test_fused_training_learns():
    q, v, pa, pb, hist = lk.fused_minimax_train(
        CFG, batch=1024, n_chunks=30, chunk_len=16, lr=0.4, eps=0.3,
        solver_iters=100, backend="xla")
    assert float(jnp.abs(v).max()) > 0.05, "values never moved"
    assert float(jnp.abs(v).max()) <= 1.05, "values outside game range"
    assert np.allclose(np.asarray(pa).sum(-1), 1.0, atol=1e-3)
    goals = sum(h[1] for h in hist)
    assert goals > 0


def test_fused_learner_visit_guard():
    """A chunk whose batch * chunk_len could overflow an int32 accumulator
    word must fail loudly before it runs."""
    with pytest.raises(ValueError, match="exceeds"):
        lk.learner_chunk(CFG, 0, None, None, batch=1 << 16, n_steps=128,
                         backend="xla")


@pytest.mark.slow
def test_convergence_recipe_trains_toward_equilibrium():
    """The 2-phase schedule (lr=1.0 empirical-Bellman-backup phase, then
    polynomial anneal + high-iteration final solve) must drive
    exploitability far below the uniform-play baseline -- the CPU smoke
    (XLA twin) of the full recipe.  The full-scale contract
    (exploitability <= 0.010 at gamma=0.99 vs the exact solver's ~0.002
    floor) runs in test_equilibrium_convergence_gpu on the card."""
    from gym_soccer_tpu.agents.evaluation import exploitability
    gamma = 0.9  # short horizon so interpret-mode step counts suffice
    q, v, pa, pb, _ = lk.fused_minimax_train(
        CFG, batch=4096, n_chunks=120, chunk_len=8, lr=1.0, eps=0.25,
        gamma=gamma, lr_anneal_start=60, lr_anneal_tau=10.0,
        lr_anneal_pow=1.5, solver_iters=200, final_solver_iters=1500,
        seed=5, backend="xla")
    uniform = jnp.full((761, 5), 0.2, jnp.float32)
    ex_uniform = float(exploitability(CFG, uniform, uniform, gamma=gamma))
    ex_trained = float(exploitability(CFG, pa, pb, gamma=gamma))
    assert ex_trained < ex_uniform / 4, (ex_trained, ex_uniform)
    assert ex_trained < 0.25, ex_trained


@pytest.mark.slow
@pytest.mark.gpu
def test_equilibrium_convergence_gpu(gpu):
    """The flagship contract: a fused run reaching exploitability
    <= 0.010 at gamma=0.99 (exact-solver floor ~0.002); 2.1B env-steps
    plus an exact best-response evaluation."""
    from gym_soccer_tpu.agents.evaluation import exploitability
    q, v, pa, pb, _ = lk.fused_minimax_train(
        CFG, batch=65536, n_chunks=1000, chunk_len=32, lr=1.0, eps=0.2,
        lr_anneal_start=500, lr_anneal_tau=25.0, lr_anneal_pow=1.5,
        solver_iters=400, final_solver_iters=3000, seed=1)
    ex = float(exploitability(CFG, pa, pb))
    assert ex <= 0.010, ex


@pytest.mark.slow
@pytest.mark.gpu
def test_equilibrium_11x7_gpu(gpu):
    """Big-grid contract: the reference's own BIG grid (nS=11705,
    soccer_simultaneous_env.py:501) learned by fused self-play to
    exploitability <= 0.005 at gamma=0.99 (exact Shapley floor 0.00138).
    The recipe is the winner of BASELINE.md's 11x7 sweep: eps floor
    0.15 for off-equilibrium coverage, 600-iteration in-loop solves, a
    slow polynomial anneal, and avg_q — solve the Q table time-averaged
    over the deep-anneal tail; solve(mean Q) beats mean(solve Q)
    because the matrix-game solve amplifies Q noise at near-ties
    (12.6B env-steps + segmented best-response evaluation)."""
    from gym_soccer_tpu.agents.evaluation import exploitability
    cfg117 = EnvConfig(width=11, height=7, slip_prob=0.2)
    q, v, pa, pb, _ = lk.fused_minimax_train(
        cfg117, batch=65536, n_chunks=6000, chunk_len=32, lr=1.0,
        eps=0.25, eps_halflife=40000, eps_min=0.15,
        lr_anneal_start=2500, lr_anneal_tau=160.0, lr_anneal_pow=1.2,
        solver_iters=600, avg_after=4000, avg_q=True,
        final_solver_iters=3000, seed=2, chunks_per_dispatch=8)
    ex = float(exploitability(cfg117, pa, pb, segment_iters=200))
    assert ex <= 0.005, ex


def test_fused_training_warm_start():
    """init=(q, v, pi_a, pi_b) must resume from the given tables: with
    lr=0 the Q table comes back bit-identical, and policies re-solve to
    the init Q's equilibrium (not the uniform default)."""
    from gym_soccer_tpu.core import tables
    nS = tables.build_statespace(CFG).nS
    rng = np.random.RandomState(0)
    q0 = jnp.asarray(rng.uniform(-0.5, 0.5, (nS, 5, 5)), jnp.float32)
    v0 = q0.mean(axis=(1, 2))
    pi0 = jnp.full((nS, 5), 0.2, jnp.float32)
    q, v, pa, pb, _ = lk.fused_minimax_train(
        CFG, batch=512, n_chunks=1, chunk_len=4, lr=0.0, eps=0.5,
        solver_iters=50, backend="xla", init=(q0, v0, pi0, pi0))
    assert np.array_equal(np.asarray(q), np.asarray(q0))
    assert not np.allclose(np.asarray(pa), 0.2, atol=1e-3), \
        "policies should re-solve the init Q, not stay uniform"


def test_fused_training_exact_resume():
    """Checkpoint/resume on the flagship trainer: 3+3 chunks across a
    utils/checkpoint save/load roundtrip must be BIT-IDENTICAL to 6
    uninterrupted chunks (absolute-chunk-index PRNG seeds + schedules,
    env fields carried through, M repacked with the continuous run's
    epsilon)."""
    import os
    import tempfile
    from gym_soccer_tpu.utils import checkpoint as ckpt
    kw = dict(batch=512, chunk_len=4, lr=0.5, eps=0.4, eps_halflife=32,
              lr_anneal_start=2, lr_anneal_tau=4.0, solver_iters=30,
              seed=7, backend="xla")
    qc, vc, pac, pbc, _, res_c = lk.fused_minimax_train(
        CFG, n_chunks=6, return_state=True, **kw)

    _, _, _, _, _, r1 = lk.fused_minimax_train(
        CFG, n_chunks=3, return_state=True, **kw)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ck.npz")
        ckpt.save_pytree(p, r1)
        r1 = ckpt.load_pytree(p, r1)
    q, v, pa, pb, _, res = lk.fused_minimax_train(
        CFG, n_chunks=3, return_state=True,
        init=(r1["q"], r1["v"], r1["pi_a"], r1["pi_b"], r1["n"]),
        fields_init=r1["fields"], start_chunk=int(r1["next_chunk"]), **kw)

    assert int(res["next_chunk"]) == int(res_c["next_chunk"]) == 6
    assert np.array_equal(np.asarray(q), np.asarray(qc))
    assert np.array_equal(np.asarray(v), np.asarray(vc))
    assert np.array_equal(np.asarray(pa), np.asarray(pac))
    assert np.array_equal(np.asarray(pb), np.asarray(pbc))
    for a, b in zip(res["fields"], res_c["fields"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_fused_training_packed_converges():
    """fused_minimax_train's grouped-dispatch mode must train (same smoke
    as test_fused_training_learns, on the other dispatch path)."""
    q, v, pa, pb, hist = lk.fused_minimax_train(
        CFG, batch=1024, n_chunks=30, chunk_len=16, lr=0.4, eps=0.3,
        solver_iters=100, backend="xla", chunks_per_dispatch=5)
    assert float(jnp.abs(v).max()) > 0.05, "values never moved"
    assert float(jnp.abs(v).max()) <= 1.05, "values outside game range"
    assert np.allclose(np.asarray(pa).sum(-1), 1.0, atol=1e-3)
    assert sum(h[1] for h in hist) > 0


def _chunk_inputs(cfg, B, seed=3):
    from gym_soccer_tpu.core import tables
    nS = (sum(tables.build_statespace(c).nS for c in cfg)
          if isinstance(cfg, tuple) else tables.build_statespace(cfg).nS)
    rng = np.random.RandomState(seed)
    v = jnp.asarray(rng.uniform(-1, 1, nS).astype(np.float32))
    pa = jnp.asarray(rng.dirichlet(np.ones(5), nS).astype(np.float32))
    pb = jnp.asarray(rng.dirichlet(np.ones(5), nS).astype(np.float32))
    return lk.pack_m(cfg, pa, pb, v, eps=0.2), lk.init_state_fields(cfg, B)


@pytest.mark.parametrize("block", [128, 512])
def test_learner_kernel_matches_twin(block):
    """The Triton chunk (interpret mode) steps the twin's trajectories
    bit for bit: M is frozen in-chunk, so fields and stats depend on the
    table reads alone, never on the accumulator (whose interpreted
    atomics are not faithful; accumulators are checked on the twin)."""
    B, T = 640, 12
    m, fields = _chunk_inputs(CFG, B)
    f1, _, st1 = lk.learner_chunk(CFG, 7, m, fields, B, T, interpret=True,
                                  block=block)
    f2, _, st2 = lk.learner_chunk(CFG, 7, m, fields, B, T, backend="xla")
    for a, b in zip(f1, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in st1] == [int(x) for x in st2]


def test_multigrid_packed_chunk_matches_unpacked():
    """The MULTIGRID Triton chunk (interpret mode) steps the multigrid
    twin's trajectories bit for bit, and the twin counts one visit per
    lane-step in each variant's own block of cells."""
    cfgs = (EnvConfig(5, 4, 0.2), EnvConfig(6, 5, 0.1))
    B, T = 1024, 8
    m, (planes, fields) = _chunk_inputs(cfgs, B)
    f1, _, st1 = lk.multigrid_learner_chunk(cfgs, 9, m, planes, fields,
                                            B, T, interpret=True)
    f2, acc, st2 = lk.multigrid_learner_chunk(cfgs, 9, m, planes, fields,
                                              B, T, backend="xla")
    for a, b in zip(f1, f2):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in st1] == [int(x) for x in st2]
    _, cnt = lk.unpack_acc(cfgs, acc)
    assert int(np.asarray(cnt).sum()) == B * T


def test_twin_accumulator_is_order_independent():
    """The int32 fixed-point accumulator is an exact sum: the same visits
    added in a permuted lane order give the same words, and two runs of
    the twin are bit-identical."""
    from gym_soccer_tpu.ops import lane_loop as ll
    rng = np.random.RandomState(0)
    cells = jnp.asarray(rng.randint(0, 50, 4096), jnp.int32)
    deltas = jnp.asarray(rng.uniform(-3, 3, 4096), jnp.float32)

    def acc_of(perm):
        c, d = cells[perm], deltas[perm]

        def body(ctx, lanes):
            lk.scatter_residual(ctx, 0, lanes[0], jax.lax.bitcast_convert_type(
                lanes[1], jnp.float32), jnp.ones_like(lanes[0]))
            return ()
        _, (acc,), _ = ll.run(
            body, batch=4096, lanes=(c, jax.lax.bitcast_convert_type(
                d, jnp.int32)), scalars=(0,), acc_sizes=(50 * 4,), n_out=0,
            backend="xla")
        return np.asarray(acc)
    a = acc_of(np.arange(4096))
    b = acc_of(rng.permutation(4096))
    assert np.array_equal(a, b)
    sums, cnt = lk.decode_acc(lk.fold_acc(jnp.asarray(a)), jnp.arange(50))
    want = np.zeros(50)
    np.add.at(want, np.asarray(cells), np.asarray(deltas, np.float64))
    # per-visit rounding to 2^-24: |error| <= 2^-25 per visit, plus the
    # f32 rounding of the decoded sum
    assert (np.abs(np.asarray(sums) - want)
            <= np.asarray(cnt) * 2.0 ** -25 + np.abs(want) * 2.0 ** -24).all()
    assert int(np.asarray(cnt).sum()) == 4096


@pytest.mark.parametrize("q", [-lk.FIX_MAX, lk.FIX_MAX, -1, 1, 12345678])
def test_fold_acc_exact_at_visit_cap(q):
    """MAX_VISITS visits of one cell, each adding the fixed-point residual
    q (the clamp's extremes included), fit every kernel word; folding is
    exact, and the folded words of MAX_SHARDS devices add (psum) without
    overflow to the exact total."""
    mask = (1 << lk.LIMB_BITS) - 1
    limbs = np.asarray([q >> (2 * lk.LIMB_BITS), (q >> lk.LIMB_BITS) & mask,
                        q & mask, 1], np.int64)
    words = limbs * lk.MAX_VISITS
    assert (np.abs(words) < 2 ** 31).all()
    folded = np.asarray(lk.fold_acc(jnp.asarray(words.astype(np.int32))),
                        np.int64)
    whole, frac, cnt, pad = folded
    assert 0 <= frac < 2 ** lk.FIX_BITS and pad == 0
    assert whole * 2 ** lk.FIX_BITS + frac == q * lk.MAX_VISITS
    assert cnt == lk.MAX_VISITS
    total = folded * lk.MAX_SHARDS
    assert (np.abs(total) < 2 ** 31).all()
    sums, cnts = lk.decode_acc(jnp.asarray(total.astype(np.int32)),
                               jnp.arange(1))
    exact = q * lk.MAX_VISITS * lk.MAX_SHARDS / 2 ** lk.FIX_BITS
    assert abs(float(sums[0]) - exact) <= abs(exact) * 2.0 ** -24
    assert float(cnts[0]) == lk.MAX_VISITS * lk.MAX_SHARDS


def test_chunks_per_dispatch_matches_single_dispatch():
    """The segmented scan mode (g chunks per dispatch, one compile) must
    reproduce single_dispatch bit-for-bit — same in-graph f32 schedule
    arithmetic, same chunk sequence, including a remainder segment."""
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.7, eps=0.4,
              eps_halflife=64, lr_anneal_start=3, lr_anneal_tau=5.0,
              solver_iters=40, seed=11, backend="xla")
    q1, v1, pa1, pb1, h1 = lk.fused_minimax_train(
        CFG, single_dispatch=True, **kw)
    q2, v2, pa2, pb2, h2 = lk.fused_minimax_train(
        CFG, chunks_per_dispatch=3, **kw)
    assert np.array_equal(np.asarray(q1), np.asarray(q2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    assert np.array_equal(np.asarray(pa1), np.asarray(pa2))
    assert np.array_equal(np.asarray(pb1), np.asarray(pb2))
    assert h1 == h2


def test_avg_after_grouped_matches_per_chunk():
    """avg_after (strategy time-averaging, the faster-converging
    estimator) must work on the grouped-dispatch fast path and match the
    per-chunk loop exactly when schedules are constant (no anneal, so
    the host-f64 and in-graph-f32 schedules agree bit-for-bit)."""
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.7, eps=0.4,
              solver_iters=40, seed=11, avg_after=2, backend="xla")
    q1, v1, pa1, pb1, _ = lk.fused_minimax_train(CFG, **kw)
    q2, v2, pa2, pb2, _ = lk.fused_minimax_train(
        CFG, chunks_per_dispatch=3, **kw)
    assert np.array_equal(np.asarray(q1), np.asarray(q2))
    assert np.array_equal(np.asarray(pa1), np.asarray(pa2))
    assert np.array_equal(np.asarray(pb1), np.asarray(pb2))
    # averaged strategies sum to 1 and differ from the raw iterates
    np.testing.assert_allclose(np.asarray(pa1).sum(-1), 1.0, atol=1e-5)
    q3, _, pa3, _, _ = lk.fused_minimax_train(
        CFG, **{**kw, "avg_after": 0})
    assert np.array_equal(np.asarray(q1), np.asarray(q3))  # q unaffected
    assert not np.array_equal(np.asarray(pa1), np.asarray(pa3))


def test_avg_q_grouped_matches_per_chunk():
    """avg_q (solve the time-averaged Q instead of averaging per-chunk
    solutions) must run on both dispatch modes with identical results,
    leave the raw Q iterate untouched, and produce different strategies
    from the strategy-averaging estimator."""
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.7, eps=0.4,
              solver_iters=40, seed=11, avg_after=2, avg_q=True,
              final_solver_iters=60, backend="xla")
    q1, v1, pa1, pb1, _ = lk.fused_minimax_train(CFG, **kw)
    q2, v2, pa2, pb2, _ = lk.fused_minimax_train(
        CFG, chunks_per_dispatch=3, **kw)
    for a, b in ((q1, q2), (v1, v2), (pa1, pa2), (pb1, pb2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    q3, _, pa3, _, _ = lk.fused_minimax_train(
        CFG, **{**kw, "avg_q": False})
    assert np.array_equal(np.asarray(q1), np.asarray(q3))
    assert not np.array_equal(np.asarray(pa1), np.asarray(pa3))
    np.testing.assert_allclose(np.asarray(pa1).sum(-1), 1.0, atol=1e-5)


def test_fused_best_response_matches_exact_br():
    """Fused frozen-opponent training (the reference's single-agent mode,
    soccer_simultaneous_env.py:187-188, main() :507-520) must converge to
    the exact best-response values computed by
    agents/evaluation.best_response_value, and the frozen side must play
    its policy EXACTLY (zero exploration in its packed columns)."""
    from gym_soccer_tpu.agents.evaluation import best_response_value
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    gamma = 0.85  # short horizon so interpret-mode step counts suffice
    opp = get_random_policy_array(761, 5, seed=42)
    q, v, pa, pb, hist = lk.fused_best_response_train(
        CFG, opp, "player_a", batch=1024, n_chunks=40, chunk_len=8,
        lr=1.0, gamma=gamma, eps=0.3, eps_halflife=160, eps_min=0.1,
        seed=3, backend="xla")
    # frozen side: exact one-hot of the frozen policy
    opp_oh = np.eye(5, dtype=np.float32)[np.asarray(opp)]
    assert np.array_equal(np.asarray(pb), opp_oh)
    # and its packed pi columns carry NO exploration mix
    m = np.asarray(lk.pack_m(CFG, pa, pb, v, 0.3, eps_b=0.0)).reshape(
        -1, lk.M_COLS)
    rows = lk._cell_rows(CFG)
    assert np.array_equal(m[rows, lk.COL_PI_B:lk.COL_PI_B + 5], opp_oh)
    # learner's values approach the exact best response
    v_br, _ = best_response_value(CFG, jnp.asarray(opp_oh), "player_a",
                                  gamma=gamma)
    err = np.abs(np.asarray(v) - np.asarray(v_br))
    assert err.mean() < 0.08, f"mean |v - V_br| = {err.mean():.3f}"
    goals = sum(h[1] for h in hist)
    assert goals > 0


def test_fused_best_response_side_b():
    """Learning side B against a frozen random A: the kernel keeps
    everything in A's reward perspective, so the trained v must approach
    MINUS the B-perspective exact best-response value."""
    from gym_soccer_tpu.agents.evaluation import best_response_value
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    gamma = 0.85
    opp = get_random_policy_array(761, 5, seed=7)
    opp_oh = jnp.asarray(np.eye(5, dtype=np.float32)[np.asarray(opp)])
    q, v, pa, pb, _ = lk.fused_best_response_train(
        CFG, opp, "player_b", batch=1024, n_chunks=40, chunk_len=8,
        lr=1.0, gamma=gamma, eps=0.3, eps_halflife=160, eps_min=0.1,
        seed=4, backend="xla")
    assert np.array_equal(np.asarray(pa), np.asarray(opp_oh))
    v_br, _ = best_response_value(CFG, opp_oh, "player_b", gamma=gamma)
    err = np.abs(np.asarray(v) - (-np.asarray(v_br)))
    assert err.mean() < 0.08, f"mean |v + V_br_b| = {err.mean():.3f}"


def test_br_chunks_per_dispatch_grouping_invariant():
    """BR's grouped-dispatch mode must be invariant to the group size
    (both in-graph f32 schedules; includes a remainder segment)."""
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    opp = get_random_policy_array(761, 5, seed=3)
    kw = dict(batch=512, n_chunks=7, chunk_len=4, lr=0.8, eps=0.4,
              eps_halflife=64, eps_min=0.1, lr_anneal_start=2,
              lr_anneal_tau=4.0, gamma=0.9, seed=13, backend="xla")
    q1, v1, pa1, _, h1 = lk.fused_best_response_train(
        CFG, opp, "player_a", chunks_per_dispatch=7, **kw)
    q2, v2, pa2, _, h2 = lk.fused_best_response_train(
        CFG, opp, "player_a", chunks_per_dispatch=3, **kw)
    assert np.array_equal(np.asarray(q1), np.asarray(q2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    assert np.array_equal(np.asarray(pa1), np.asarray(pa2))
    assert h1 == h2


def test_fused_best_response_exact_resume():
    """BR trainer checkpoint/resume: 3+3 chunks across a save/load
    roundtrip must be BIT-IDENTICAL to 6 uninterrupted chunks (greedy
    pi/v and M reconstruct from q alone; schedules and seeds key off the
    absolute chunk index)."""
    import os
    import tempfile
    from gym_soccer_tpu.utils import checkpoint as ckpt
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    opp = get_random_policy_array(761, 5, seed=3)
    kw = dict(batch=512, chunk_len=4, lr=0.8, eps=0.4, eps_halflife=64,
              eps_min=0.1, lr_anneal_start=2, lr_anneal_tau=4.0,
              gamma=0.9, seed=13, backend="xla")
    qc, vc, pac, pbc, _, res_c = lk.fused_best_response_train(
        CFG, opp, "player_a", n_chunks=6, return_state=True, **kw)

    _, _, _, _, _, r1 = lk.fused_best_response_train(
        CFG, opp, "player_a", n_chunks=3, return_state=True, **kw)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "br.npz")
        ckpt.save_pytree(p, r1)
        r1 = ckpt.load_pytree(p, r1)
    q, v, pa, pb, _, res = lk.fused_best_response_train(
        CFG, opp, "player_a", n_chunks=3, return_state=True,
        init=(r1["q"], r1["n"]), fields_init=r1["fields"],
        start_chunk=int(r1["next_chunk"]), **kw)

    assert int(res["next_chunk"]) == int(res_c["next_chunk"]) == 6
    assert np.array_equal(np.asarray(q), np.asarray(qc))
    assert np.array_equal(np.asarray(v), np.asarray(vc))
    assert np.array_equal(np.asarray(pa), np.asarray(pac))
    assert np.array_equal(np.asarray(pb), np.asarray(pbc))
    for a, b in zip(res["fields"], res_c["fields"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
@pytest.mark.gpu
def test_br_convergence_gpu(gpu):
    """Full-scale fused best response on the card: the learned greedy
    policy must win >95% of completed episodes vs a frozen random
    opponent -- the reference's single-agent solution-quality contract
    (test_general.py:344-381)."""
    from gym_soccer_tpu.core import batch
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    opp = get_random_policy_array(761, 5, seed=42)
    q, v, pa, pb, _ = lk.fused_best_response_train(
        CFG, opp, "player_a", batch=32768, n_chunks=300, chunk_len=32,
        lr=1.0, gamma=0.99, eps=0.3, eps_halflife=2400, eps_min=0.05,
        lr_anneal_start=150, lr_anneal_tau=25.0, lr_anneal_pow=1.0,
        seed=1)
    pol_a = jnp.argmax(jnp.asarray(pa), -1).astype(jnp.int32)
    fb = jnp.asarray(opp)
    pol = lambda obs, i: (pol_a[obs], fb[obs])
    env0 = jax.jit(lambda k: batch.init(CFG, k, 2048))(jax.random.key(9))
    _, out = jax.jit(lambda s: batch.rollout(CFG, s, pol, 400))(env0)
    done = np.asarray(out.done)
    wins = ((np.asarray(out.reward_a) > 0) & done).sum()
    eps_n = (done | np.asarray(out.truncated)).sum()
    assert wins / eps_n > 0.95, f"win rate {wins / eps_n:.3f}"
