"""DP-sharded FUSED learner chunks (parallel/mesh.sharded_learner_chunk_fn
/ sharded_altq_chunk_fn) on the 8-device virtual mesh: the psum'd
accumulators must equal the sum of each shard's standalone chunk, and
shard PRNG streams must be decorrelated (XLA twin on CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import tables
from gym_soccer_tpu.ops import altq_kernel as ak
from gym_soccer_tpu.ops import learner_kernel as lk
from gym_soccer_tpu.parallel import mesh as pmesh

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)
GOLD = 0x61C88647  # shard-seed decorrelation constant (mesh.py)


def _slice_fields(fields, i, rows):
    return tuple(f[i * rows:(i + 1) * rows] for f in fields)


def test_sharded_minimax_chunk_equals_manual_shards():
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    B, T = n_dev * 256, 8
    rows = 256 // 128
    nS = tables.build_statespace(CFG).nS
    m = lk.pack_m(CFG, jnp.full((nS, 5), 0.2), jnp.full((nS, 5), 0.2),
                  jnp.zeros(nS), eps=0.3)
    fields = lk.init_state_fields(CFG, B)

    fn = pmesh.sharded_learner_chunk_fn(CFG, mesh, B, T, backend="xla")
    out_fields, acc, stats = fn(3, m, fields)

    # manual per-shard runs with the same decorrelated seeds (int32
    # wrap-around semantics of mesh.py's seed ^ (axis_index * GOLD))
    acc_sum = None
    for i in range(n_dev):
        f_i = _slice_fields(fields, i, rows)
        bits = (3 ^ ((i * GOLD) & 0xFFFFFFFF)) & 0xFFFFFFFF
        sseed = np.int32(bits - (1 << 32) if bits >= 1 << 31 else bits)
        of_i, acc_i, st_i = lk.learner_chunk(CFG, sseed, m, f_i, 256, T,
                                             backend="xla")
        acc_sum = acc_i if acc_sum is None else acc_sum + acc_i
        for a, b in zip(of_i, (f[i * rows:(i + 1) * rows]
                               for f in out_fields)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    # integer accumulators: the psum is exact
    assert np.array_equal(np.asarray(acc), np.asarray(acc_sum))
    _, cnt = lk.unpack_acc(CFG, acc)
    assert float(np.asarray(cnt).sum()) == B * T


def test_sharded_visit_guard_is_per_device():
    """The accumulator's visit cap holds per device: a mesh takes its
    device count times one device's largest chunk, and refuses more."""
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    T = 32
    bpd = lk.MAX_VISITS // T
    pmesh.sharded_learner_chunk_fn(CFG, mesh, n_dev * bpd, T,
                                   backend="xla")
    with pytest.raises(ValueError, match="exceeds"):
        pmesh.sharded_learner_chunk_fn(CFG, mesh, n_dev * bpd * 2, T,
                                       backend="xla")


def test_sharded_minimax_shards_are_decorrelated():
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    B, T = n_dev * 256, 8
    rows = 256 // 128
    nS = tables.build_statespace(CFG).nS
    m = lk.pack_m(CFG, jnp.full((nS, 5), 0.2), jnp.full((nS, 5), 0.2),
                  jnp.zeros(nS), eps=0.3)
    fields = lk.init_state_fields(CFG, B)
    fn = pmesh.sharded_learner_chunk_fn(CFG, mesh, B, T, backend="xla")
    out_fields, acc, stats = fn(3, m, fields)
    # every shard starts from the same ISD spread; identical streams would
    # leave identical final states — require at least one difference
    f0 = np.asarray(out_fields[0])
    assert any(not np.array_equal(f0[:rows], f0[i * rows:(i + 1) * rows])
               for i in range(1, n_dev)), "shard PRNG streams collide"


def test_sharded_altq_chunk_accumulates_exactly():
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    B, T = n_dev * 256, 8
    from gym_soccer_tpu.envs.soccer_alternating_env import build_alt_tables
    nS = build_alt_tables(CFG).nS
    m = ak.pack_alt_m(CFG, jnp.zeros((nS, 5)))
    fields = ak.init_alt_state_fields(CFG, B)
    fn = pmesh.sharded_altq_chunk_fn(CFG, mesh, B, T, backend="xla")
    out_fields, acc, stats = fn(1, int(0.3 * 65536), m, fields, 0)
    td, cnt = ak.unpack_alt_acc(CFG, acc)
    assert float(np.asarray(cnt).sum()) == B * T
    assert abs(float(np.asarray(td).sum()) - int(np.asarray(stats[0]))) < 1.0


def test_fused_train_on_mesh_learns():
    """fused_minimax_train(mesh=...) must run the whole chunked loop with
    sharded lanes + psum'd accumulators and still learn."""
    mesh = pmesh.env_mesh()
    B = mesh.devices.size * 256
    q, v, pa, pb, hist = lk.fused_minimax_train(
        CFG, batch=B, n_chunks=10, chunk_len=8, lr=0.5, eps=0.3,
        solver_iters=50, backend="xla", mesh=mesh)
    assert float(jnp.abs(v).max()) > 0.02, "values never moved"
    assert np.allclose(np.asarray(pa).sum(-1), 1.0, atol=1e-3)


def test_fused_altq_train_on_mesh_learns():
    mesh = pmesh.env_mesh()
    B = mesh.devices.size * 256
    q, hist = ak.fused_altq_train(CFG, batch=B, n_chunks=10, chunk_len=8,
                                  lr=0.5, eps=0.3, backend="xla",
                                  mesh=mesh)
    assert float(jnp.abs(np.asarray(q)).max()) > 0.02


def test_sharded_multigrid_chunk_accumulates_exactly():
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    cfgs = (CFG, EnvConfig(6, 5, 0.1))
    B, T = n_dev * 256, 8
    nS = sum(tables.build_statespace(c).nS for c in cfgs)
    m = lk.pack_m(cfgs, jnp.full((nS, 5), 0.2), jnp.full((nS, 5), 0.2),
                  jnp.zeros(nS), eps=0.3)
    planes, fields = lk.init_state_fields(cfgs, B)
    fn = pmesh.sharded_learner_chunk_fn(cfgs, mesh, B, T, backend="xla")
    out_fields, acc, stats = fn(2, m, fields, planes)
    _, cnt = lk.unpack_acc(cfgs, acc)
    cnt = np.asarray(cnt)
    assert cnt.sum() == B * T
    nS0 = tables.build_statespace(CFG).nS
    assert cnt[:nS0].sum() == (B // 2) * T
    assert cnt[nS0:].sum() == (B // 2) * T


def test_sharded_solve_matches_replicated_bitexact():
    """The state-sharded RM+ re-solve (the workload's one model-parallel
    stage) must return exactly what the replicated solver returns —
    per-state arithmetic is untouched, only the state batch is
    partitioned (761 states over 8 devices exercises the padding path)."""
    from gym_soccer_tpu.agents import learners
    mesh = pmesh.env_mesh()
    nS = tables.build_statespace(CFG).nS
    rng = np.random.RandomState(3)
    q = jnp.asarray(rng.uniform(-1, 1, (nS, 5, 5)).astype(np.float32))
    want = jax.jit(lambda q: learners.solve_matrix_games(q, iters=120))(q)
    got = pmesh.sharded_solve_fn(mesh, iters=120)(q)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_sharded_iql_chunk_accumulates_exactly():
    mesh = pmesh.env_mesh()
    n_dev = mesh.devices.size
    B, T = n_dev * 256, 8
    from gym_soccer_tpu.ops import iql_kernel as ik
    nS = tables.build_statespace(CFG).nS
    m = ik.pack_iql_m(CFG, jnp.zeros((nS, 5)), jnp.zeros((nS, 5)))
    fields = ik.init_iql_state_fields(CFG, B)
    fn = pmesh.sharded_iql_chunk_fn(CFG, mesh, B, T, backend="xla")
    out_fields, acc, stats = fn(1, int(0.3 * 65536), m, fields, 0)
    sa, ca, sb, cb = ik.unpack_iql_acc(CFG, acc)
    # one visit per env per step, for EACH player's table
    assert float(np.asarray(ca).sum()) == B * T
    assert float(np.asarray(cb).sum()) == B * T
    # zero-sum dual accounting: td_a sums to +R, td_b to -R
    rew = int(np.asarray(stats[0]))
    assert abs(float(np.asarray(sa).sum()) - rew) < 1.0
    assert abs(float(np.asarray(sb).sum()) + rew) < 1.0
