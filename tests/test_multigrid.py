"""Multi-variant engine: mixed grid geometries stepping in one jitted
batch, validated per-variant against the single-grid engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import batch, multigrid, rules

CFGS = [EnvConfig(5, 4, 0.2), EnvConfig(6, 4, 0.1),
        EnvConfig(7, 5, 0.2), EnvConfig(11, 7, 0.3)]
B = len(CFGS) * 64


@pytest.fixture(scope="module")
def final_and_traj():
    st = jax.jit(lambda k: multigrid.init(CFGS, k, B))(jax.random.key(0))
    pol = lambda s, i: tuple(jax.random.randint(
        jax.random.fold_in(jax.random.key(1), i), (2, B), 0, 5,
        dtype=jnp.int32))
    final, traj = jax.jit(
        lambda s: multigrid.rollout(s, pol, 400))(st)
    return final, jax.tree.map(np.asarray, traj)


def _lane_cfg_index():
    return np.arange(B) % len(CFGS)


def test_initial_states_respect_variant_isd():
    st = jax.jit(lambda k: multigrid.init(CFGS, k, B))(jax.random.key(0))
    idx = _lane_cfg_index()
    for v, cfg in enumerate(CFGS):
        lanes = idx == v
        ca = np.asarray(st.cols_a)[lanes]
        cb = np.asarray(st.cols_b)[lanes]
        assert (ca == 2).all() and (cb == cfg.W - 3).all()
        gr = set(cfg.goal_rows)
        assert set(np.asarray(st.rows_a)[lanes].tolist()) <= gr
        assert set(np.asarray(st.rows_b)[lanes].tolist()) <= gr


def test_lanes_stay_inside_their_own_geometry(final_and_traj):
    final, traj = final_and_traj
    idx = _lane_cfg_index()
    for v, cfg in enumerate(CFGS):
        lanes = idx == v
        for rows, cols in [(final.rows_a, final.cols_a),
                           (final.rows_b, final.cols_b)]:
            r = np.asarray(rows)[lanes]
            c = np.asarray(cols)[lanes]
            assert (r >= 0).all() and (r < cfg.H).all()
            assert (c >= 1).all() and (c <= cfg.W - 2).all(), \
                "autoreset keeps players out of goal columns"


def test_goal_rates_match_single_grid_engines(final_and_traj):
    _, (rew, goal, trunc) = final_and_traj
    idx = _lane_cfg_index()
    for v, cfg in enumerate(CFGS):
        lanes = idx == v
        multi_rate = goal[:, lanes].mean()
        # single-grid engine reference rate
        st = jax.jit(lambda k, cfg=cfg: batch.init(cfg, k, 256))(
            jax.random.key(2))
        pol = batch.random_policy_fn(cfg, jax.random.key(3), 256)
        _, out = jax.jit(
            lambda s, cfg=cfg: batch.rollout(cfg, s, pol, 400))(st)
        single_rate = np.asarray(out.done).mean()
        # loose band: rates differ by sampling noise only
        assert abs(multi_rate - single_rate) < 0.012, \
            (cfg, multi_rate, single_rate)


def test_rewards_are_goal_consistent(final_and_traj):
    _, (rew, goal, trunc) = final_and_traj
    assert ((rew != 0) == goal).all()
    assert set(np.unique(rew)).issubset({-1.0, 0.0, 1.0})


def test_absorbing_goal_pays_zero_without_autoreset():
    """With autoreset=False a terminated lane self-loops and never pays the
    goal reward again (reference :235-240 'starting absorbed => r=0')."""
    cfgs = [EnvConfig(5, 4, 0.0), EnvConfig(7, 5, 0.0)]
    st = jax.jit(lambda k: multigrid.init(cfgs, k, 8))(jax.random.key(0))
    # Inject every lane into ITS OWN variant's right-goal terminal state:
    # A on a goal row in goal column W-1 with possession.
    glo = np.asarray(st.geo.glo)
    W = np.asarray(st.geo.W)
    st = st._replace(
        rows_a=jnp.asarray(glo), cols_a=jnp.asarray(W - 1),
        rows_b=jnp.asarray(glo + 1), cols_b=jnp.asarray(W - 3),
        poss=jnp.zeros(8, jnp.int32))
    step = jax.jit(lambda s, a, b: multigrid.step(s, a, b, autoreset=False))
    ref = jax.tree.map(np.asarray,
                       (st.rows_a, st.cols_a, st.rows_b, st.cols_b, st.poss))
    for a in range(5):
        acts = jnp.full(8, a, jnp.int32)
        st, (rew, goal, trunc) = step(st, acts, (acts + 2) % 5)
        assert (np.asarray(rew) == 0).all()
        assert np.asarray(goal).all()
        now = jax.tree.map(np.asarray, (st.rows_a, st.cols_a, st.rows_b,
                                        st.cols_b, st.poss))
        for f, g in zip(now, ref):
            assert np.array_equal(f, g)


def test_salted_random_play_is_balanced():
    """Random play with a SALTED policy stream must score both goals about
    equally in every variant.  (A salt-0 policy consumes the very uniforms
    the transition reads, correlating actions with slip draws — the bug
    mode uniforms(salt=...) exists to prevent.)"""
    cfgs = [EnvConfig(5, 4, 0.2), EnvConfig(9, 6, 0.3)]
    st = jax.jit(lambda k: multigrid.init(cfgs, k, 2048))(jax.random.key(0))

    def pol(s, i):
        u = multigrid.uniforms(s, 2, salt=9)
        return (jnp.minimum((u[:, 0] * 5).astype(jnp.int32), 4),
                jnp.minimum((u[:, 1] * 5).astype(jnp.int32), 4))

    st, (r, g, tr) = jax.jit(lambda s: multigrid.rollout(s, pol, 300))(st)
    r, g = np.asarray(r), np.asarray(g)
    lane = np.arange(2048) % len(cfgs)
    for v in range(len(cfgs)):
        goals = g[:, lane == v].sum()
        net = abs(r[:, lane == v].sum())
        assert goals > 100, f"variant {v} too few goals: {goals}"
        # |net| for a fair coin over `goals` trials: 3 sigma = 3*sqrt(goals)
        assert net < 3 * np.sqrt(goals) + 1, (v, net, goals)


# ----------------------------------------------------------------------
# Dense observation codec + mixed-batch learners (per-variant raw_to_dense
# over concatenated tables; reference obs semantics :487-494 per geometry)
# ----------------------------------------------------------------------

def test_dense_obs_matches_each_variants_statespace(final_and_traj):
    """Per-lane dense_obs must equal the lane's OWN variant's raw_to_dense
    lookup (goal -> 0, reachable -> enumeration-order index)."""
    final, _ = final_and_traj
    codec = multigrid.build_codec(tuple(CFGS))
    obs = np.asarray(jax.jit(
        lambda s: multigrid.dense_obs(codec, s))(final))
    gobs = np.asarray(jax.jit(
        lambda s: multigrid.global_obs(codec, s))(final))
    idx = _lane_cfg_index()
    fields = [np.asarray(x) for x in (final.rows_a, final.cols_a,
                                      final.rows_b, final.cols_b,
                                      final.poss)]
    for v, cfg in enumerate(CFGS):
        ss = batch.tables.build_statespace(cfg)
        for i in np.nonzero(idx == v)[0]:
            raw = int(rules.raw_encode(
                np, *[int(f[i]) for f in fields], cfg))
            want = int(ss.raw_to_dense[raw])
            assert want >= 0, "lane reached an unreachable state"
            assert obs[i] == want, (i, v, obs[i], want)
            assert gobs[i] == codec.offsets[v] + want


def test_global_obs_blocks_are_disjoint(final_and_traj):
    final, _ = final_and_traj
    codec = multigrid.build_codec(tuple(CFGS))
    gobs = np.asarray(jax.jit(
        lambda s: multigrid.global_obs(codec, s))(final))
    idx = _lane_cfg_index()
    for v in range(len(CFGS)):
        lo = codec.offsets[v]
        hi = lo + codec.nS[v]
        sel = gobs[idx == v]
        assert (sel >= lo).all() and (sel < hi).all()


def test_single_variant_learners_bitmatch_batch_engine():
    """A one-variant 'mixture' must reproduce the single-grid fused
    learners BIT-EXACTLY: same per-instance keys, same draw order, same
    scatter updates — the multigrid learner is the same algorithm wired
    through the per-variant codec."""
    from gym_soccer_tpu.agents import learners
    cfg = EnvConfig(5, 4, 0.2)
    B, T = 128, 50

    lcfg = learners.IQLConfig(lr=0.2, eps=0.3)
    s1 = learners.iql_init(cfg, jax.random.key(0), B)
    s2 = learners.multigrid_iql_init([cfg], jax.random.key(0), B)
    r1, td1 = jax.jit(lambda s: learners.iql_train(cfg, lcfg, s, T))(s1)
    r2, td2 = jax.jit(
        lambda s: learners.multigrid_iql_train((cfg,), lcfg, s, T))(s2)
    assert np.array_equal(np.asarray(r1.q_a), np.asarray(r2.q_a))
    assert np.array_equal(np.asarray(r1.q_b), np.asarray(r2.q_b))
    assert np.array_equal(np.asarray(td1), np.asarray(td2))

    mcfg = learners.MinimaxQConfig(resolve_every=8, solver_iters=20)
    m1 = learners.minimax_init(cfg, jax.random.key(3), B)
    m2 = learners.multigrid_minimax_init([cfg], jax.random.key(3), B)
    n1, t1 = jax.jit(lambda s: learners.minimax_train(cfg, mcfg, s, T))(m1)
    n2, t2 = jax.jit(
        lambda s: learners.multigrid_minimax_train((cfg,), mcfg, s, T))(m2)
    assert np.array_equal(np.asarray(n1.q), np.asarray(n2.q))
    assert np.array_equal(np.asarray(n1.v), np.asarray(n2.v))
    assert np.array_equal(np.asarray(n1.pi_a), np.asarray(n2.pi_a))


def test_mixed_training_slices_match_single_grid():
    """Statistical contract for mixed-batch learning:

    (a) two copies of the SAME variant in one mixture learn statistically
        matching Q/V slices (same game, disjoint lanes & table blocks);
    (b) a variant trained inside a genuine mixture (5x4 + 6x4) matches a
        single-grid training run of the same length (different streams).
    """
    from gym_soccer_tpu.agents import learners
    cfg = EnvConfig(5, 4, 0.2)
    mcfg = learners.MinimaxQConfig(resolve_every=32, solver_iters=50)
    nS = batch.tables.build_statespace(cfg).nS

    def corr(a, b):
        m = (np.abs(a) > 0) & (np.abs(b) > 0)
        return np.corrcoef(a[m], b[m])[0, 1]

    # (a) same-variant slices
    cfgs = (cfg, cfg)
    st = learners.multigrid_minimax_init(cfgs, jax.random.key(7), 512)
    st, _ = jax.jit(
        lambda s: learners.multigrid_minimax_train(cfgs, mcfg, s, 2000))(st)
    q, v = np.asarray(st.q), np.asarray(st.v)
    assert corr(q[:nS], q[nS:]) > 0.75
    assert np.corrcoef(v[:nS], v[nS:])[0, 1] > 0.9

    # (b) mixture slice vs single-grid run
    cfgs2 = (cfg, EnvConfig(6, 4, 0.1))
    st2 = learners.multigrid_minimax_init(cfgs2, jax.random.key(8), 512)
    st2, _ = jax.jit(
        lambda s: learners.multigrid_minimax_train(cfgs2, mcfg, s, 2000))(st2)
    sg = learners.minimax_init(cfg, jax.random.key(9), 256)
    sg, _ = jax.jit(lambda s: learners.minimax_train(cfg, mcfg, s, 2000))(sg)
    assert corr(np.asarray(st2.q)[:nS], np.asarray(sg.q)) > 0.75
    assert np.corrcoef(np.asarray(st2.v)[:nS],
                       np.asarray(sg.v))[0, 1] > 0.9
