"""Fused lane-loop rollouts: statistical agreement of the XLA twin with
the (digest-verified) XLA engine, and the Triton kernel (interpret mode
on the CPU backend) bit-exact against the twin."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.core import batch
from gym_soccer_tpu.ops.step_kernel import pallas_rollout

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def _kernel_stats(seed, B=2048, T=400):
    fields, stats = pallas_rollout(CFG, jnp.int32(seed), B, T,
                                   backend="xla")
    rew, goals, truncs = (int(x) for x in stats)
    return rew, goals, truncs, B * T, fields


def _xla_stats(seed, B=2048, T=400):
    st = jax.jit(lambda k: batch.init(CFG, k, B))(jax.random.key(seed))
    pol = batch.random_policy_fn(CFG, jax.random.key(seed + 1), B)
    _, out = jax.jit(lambda s: batch.rollout(CFG, s, pol, T))(st)
    return (float(np.asarray(out.reward_a).sum()),
            int(np.asarray(out.done).sum()),
            int(np.asarray(out.truncated).sum()), B * T)


def test_rates_match_xla_engine():
    kr, kg, kt, kn, _ = _kernel_stats(0)
    xr, xg, xt, xn = _xla_stats(0)
    k_goal_rate, x_goal_rate = kg / kn, xg / xn
    # binomial sigma ~ 0.00037 at n=819200; allow model bias + 4 sigma
    assert abs(k_goal_rate - x_goal_rate) < 0.002, (k_goal_rate, x_goal_rate)
    assert abs(kt / kn - xt / xn) < 0.001, (kt / kn, xt / xn)


def test_reward_unbiased():
    zs = []
    for seed in range(3):
        r, g, t, n, _ = _kernel_stats(seed * 7 + 1)
        zs.append(r / max(np.sqrt(g), 1))
    assert all(abs(z) < 4 for z in zs), zs
    assert abs(np.mean(zs)) < 2.5, zs


def test_final_states_valid():
    """Every lane must end in a valid non-terminal reachable state."""
    from gym_soccer_tpu.core import rules, tables
    _, _, _, _, fields = _kernel_stats(3)
    ra, ca, rb, cb, p, t = (np.asarray(f).ravel() for f in fields)
    tb = tables.build_tables(CFG)
    raw = rules.raw_encode(np, ra, ca, rb, cb, p, CFG)
    dense = tb.raw_to_dense[raw]
    assert (dense > 0).all(), "autoreset must leave no terminal/unreachable"
    assert (t >= 0).all() and (t < CFG.max_steps).all()


def test_blocking_invariance():
    """Splitting the batch into grid blocks must not change ANY result:
    the counter PRNG is keyed on global lane id, so per-lane trajectories
    and aggregate stats are bit-identical for every block size."""
    fields1, stats1 = pallas_rollout(CFG, jnp.int32(7), 2048, 40,
                                     interpret=True)
    fields4, stats4 = pallas_rollout(CFG, jnp.int32(7), 2048, 40,
                                     interpret=True, block=1024)
    for a, b in zip(fields1, fields4):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in stats1] == [int(x) for x in stats4]


def _eq_tree(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("family", ["sim", "alt", "multigrid", "journal"])
def test_rollout_kernel_matches_twin(family):
    """The Triton kernel (interpret mode) and the plain XLA twin run the
    same per-lane body with the same global lane ids: fields, stats and
    journal words agree bit for bit."""
    from gym_soccer_tpu.ops import step_kernel as sk
    fn, cfg = {"sim": (sk.pallas_rollout, CFG),
               "alt": (sk.pallas_alt_rollout, CFG),
               "multigrid": (sk.pallas_multigrid_rollout, MG_CFGS),
               "journal": (sk.pallas_journal_rollout, CFG)}[family]
    kern = fn(cfg, jnp.int32(13), 1024, 50, interpret=True, block=256)
    twin = fn(cfg, jnp.int32(13), 1024, 50, backend="xla")
    assert _eq_tree(kern, twin)


def test_rollout_padding_for_partial_block():
    """A batch that is not a multiple of the block runs padded lanes
    that are sliced away: results equal the unpadded twin's."""
    kern = pallas_rollout(CFG, jnp.int32(3), 384, 30, interpret=True,
                          block=256)
    twin = pallas_rollout(CFG, jnp.int32(3), 384, 30, backend="xla")
    assert kern[0][0].shape == (3, 128)
    assert _eq_tree(kern, twin)


def _atomic_counts(backend):
    """3072 lanes add signed int32 values into 3 colliding words and 1
    into 2 more; returns the words and their exact int64 sums."""
    from gym_soccer_tpu.ops import lane_loop as ll
    B = 3072

    def body(ctx, lanes):
        lane = lanes[0]
        ctx.scatter_add(0, lane % 3, lane * 1001 - 1_000_000)
        ctx.scatter_add(0, 3 + (lane & 1), jnp.ones_like(lane))
        return ()
    _, (acc,), _ = ll.run(body, batch=B,
                          lanes=(jnp.arange(B, dtype=jnp.int32),),
                          scalars=(0,), acc_sizes=(5,), n_out=0,
                          backend=backend)
    lane = np.arange(B, dtype=np.int64)
    want = np.zeros(5, np.int64)
    np.add.at(want, lane % 3, lane * 1001 - 1_000_000)
    np.add.at(want, 3 + (lane & 1), 1)
    return np.asarray(acc).tolist(), want.tolist()


def test_twin_int32_scatter_add_exact():
    """The twin's colliding int32 adds are the exact integer sums."""
    got, want = _atomic_counts("xla")
    assert got == want


@pytest.mark.gpu
def test_int32_atomic_add_exact(gpu):
    """On the card, colliding int32 atomic adds land exactly.  JAX 0.9.0
    lowers them as float adds unless lane_loop._fix_int_atomic_add
    re-registers the rule; a JAX upgrade that changes the rule shows
    here."""
    got, want = _atomic_counts("triton")
    assert got == want


def test_atomic_fix_is_lazy_and_version_guarded(monkeypatch):
    """The integer atomic_add fix patches JAX's global lowering table
    only on a Triton launch with accumulators: the twin and interpret
    mode leave the table alone, and an unchecked JAX version fails
    loudly instead of patching it."""
    from jax._src.pallas import primitives as pp
    from jax._src.pallas.triton import lowering as tl
    from gym_soccer_tpu.ops import learner_kernel as lk
    from gym_soccer_tpu.ops import lane_loop as ll
    monkeypatch.setattr(ll, "_atomic_fixed", False)
    rule = tl.triton_lowering_rules[pp.atomic_rmw_p]
    m = lk.pack_m(CFG, jnp.full((761, 5), 0.2), jnp.full((761, 5), 0.2),
                  jnp.zeros(761), 0.3)
    fields = lk.init_state_fields(CFG, 256)
    lk.learner_chunk(CFG, 0, m, fields, 256, 4, backend="xla")
    lk.learner_chunk(CFG, 0, m, fields, 256, 4, interpret=True)
    assert tl.triton_lowering_rules[pp.atomic_rmw_p] is rule
    assert not ll._atomic_fixed
    monkeypatch.setattr(jax, "__version__", "0.0.0")
    with pytest.raises(RuntimeError, match="ATOMIC_FIX_JAX"):
        ll._fix_int_atomic_add()
    assert tl.triton_lowering_rules[pp.atomic_rmw_p] is rule


def test_chained_dispatch_matches_single_call():
    """Chaining shorter kernel calls is bit-identical to one long call:
    the PRNG counter is the absolute step index and state/stats carry
    across calls."""
    from gym_soccer_tpu.ops.step_kernel import pallas_rollout_chained
    f1, s1 = pallas_rollout(CFG, jnp.int32(5), 1024, 100, interpret=True)
    fc, sc = pallas_rollout_chained(CFG, jnp.int32(5), 1024, 100,
                                    steps_per_call=32, interpret=True)
    for a, b in zip(f1, fc):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in s1] == [int(x) for x in sc]


def test_alt_chained_dispatch_matches_single_call():
    from gym_soccer_tpu.ops.step_kernel import (pallas_alt_rollout,
                                                pallas_alt_rollout_chained)
    f1, s1 = pallas_alt_rollout(CFG, jnp.int32(5), 1024, 100, interpret=True)
    fc, sc = pallas_alt_rollout_chained(CFG, jnp.int32(5), 1024, 100,
                                        steps_per_call=32, interpret=True)
    for a, b in zip(f1, fc):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in s1] == [int(x) for x in sc]


# ----------------------------------------------------------------------
# Alternating-turn fused rollout
# ----------------------------------------------------------------------

def _alt_kernel_stats(seed, B=2048, T=400):
    from gym_soccer_tpu.ops.step_kernel import pallas_alt_rollout
    fields, stats = pallas_alt_rollout(CFG, jnp.int32(seed), B, T,
                                       backend="xla")
    rew, goals, truncs = (int(x) for x in stats)
    return rew, goals, truncs, B * T, fields


def _alt_xla_stats(seed, B=2048, T=400):
    from gym_soccer_tpu.core import batch as corebatch
    from gym_soccer_tpu.envs.soccer_alternating_env import alt_init, alt_step

    def body(st, _):
        env_view = corebatch.EnvState(st.rows_a, st.cols_a, st.rows_b,
                                      st.cols_b, st.poss, st.t, st.n, st.key)
        u = corebatch.per_env_uniforms(env_view, 1, salt=3)[:, 0]
        a = jnp.minimum((u * 5).astype(jnp.int32), 4)
        st2, out = alt_step(CFG, st, a, autoreset=True)
        return st2, out

    st = jax.jit(lambda k: alt_init(CFG, k, B))(jax.random.key(seed))
    _, (r, g, tr) = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=T))(st)
    return (float(np.asarray(r).sum()), int(np.asarray(g).sum()),
            int(np.asarray(tr).sum()), B * T)


def test_alt_kernel_rates_match_xla_engine():
    kr, kg, kt, kn, _ = _alt_kernel_stats(0)
    xr, xg, xt, xn = _alt_xla_stats(0)
    # binomial sigma ~ 1.3e-4 on the goal rate at n=819200; allow
    # 16-bit-threshold model bias + 5 sigma
    assert abs(kg / kn - xg / xn) < 0.0012, (kg / kn, xg / xn)
    assert abs(kt / kn - xt / xn) < 0.0006, (kt / kn, xt / xn)
    # zero-sum random play: net reward is a +-1 random walk over goals
    assert abs(kr) < 5 * max(np.sqrt(kg), 1), (kr, kg)


def test_alt_kernel_final_states_valid():
    from gym_soccer_tpu.core import rules
    from gym_soccer_tpu.envs.soccer_alternating_env import build_alt_tables
    _, _, _, _, fields = _alt_kernel_stats(3)
    ra, ca, rb, cb, p, turn, t = (np.asarray(f).ravel() for f in fields)
    tb = build_alt_tables(CFG)
    raw2 = rules.raw_encode(np, ra, ca, rb, cb, p, CFG) * 2 + turn
    dense = tb.raw_to_dense[raw2]
    assert (dense > 0).all(), "autoreset must leave no terminal/unreachable"
    assert np.isin(turn, (0, 1)).all()
    assert (t >= 0).all() and (t < CFG.max_steps).all()


def test_alt_kernel_blocking_invariance():
    from gym_soccer_tpu.ops.step_kernel import pallas_alt_rollout
    f1, s1 = pallas_alt_rollout(CFG, jnp.int32(7), 2048, 40, interpret=True)
    f4, s4 = pallas_alt_rollout(CFG, jnp.int32(7), 2048, 40, interpret=True,
                                block=512)
    for a, b in zip(f1, f4):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert [int(x) for x in s1] == [int(x) for x in s4]


# ----------------------------------------------------------------------
# Multigrid fused rollout (mixed geometries in one kernel)
# ----------------------------------------------------------------------

MG_CFGS = (EnvConfig(5, 4, 0.2), EnvConfig(6, 5, 0.1), EnvConfig(8, 6, 0.3))


def test_multigrid_isd_arith_matches_table_builder():
    """The kernel's arithmetic ISD enumerates exactly each variant's
    initial-state set from core/tables.build_isd (reference
    _generate_isd, soccer_simultaneous_env.py:146-165)."""
    from gym_soccer_tpu.core import rules, tables
    from gym_soccer_tpu.ops.step_kernel import _isd_fields_arith
    for cfg in MG_CFGS + (EnvConfig(11, 7, 0.0), EnvConfig(5, 5, 0.1)):
        _, raws = tables.build_isd(cfg)
        expect = {tuple(int(v) for v in rules.raw_decode(np, int(r), cfg))
                  for r in raws}
        n = 4 if cfg.H % 2 == 0 else 2
        idx = np.arange(n, dtype=np.int32)
        H = np.full(n, cfg.H, np.int32)
        W = np.full(n, cfg.W, np.int32)
        got = {tuple(int(f[i]) for f in _isd_fields_arith(idx, H, W, xp=np))
               for i in range(n)}
        assert got == expect, (cfg, got, expect)


def _mg_kernel_stats(seed, B=3072, T=400):
    from gym_soccer_tpu.ops.step_kernel import pallas_multigrid_rollout
    fields, stats = pallas_multigrid_rollout(MG_CFGS, jnp.int32(seed), B, T,
                                             backend="xla")
    return np.asarray(stats), B // len(MG_CFGS) * T, fields


def test_multigrid_kernel_rates_match_single_grid_kernels():
    """Per-variant goal/truncation rates from the mixed-geometry kernel
    agree with the single-grid kernel compiled per variant."""
    stats, n, _ = _mg_kernel_stats(0)
    for v, cfg in enumerate(MG_CFGS):
        _, sstats = pallas_rollout(cfg, jnp.int32(100 + v), 1024, 400,
                                   backend="xla")
        sn = 1024 * 400
        g_mix, g_single = stats[v, 1] / n, int(sstats[1]) / sn
        t_mix, t_single = stats[v, 2] / n, int(sstats[2]) / sn
        # binomial sigma ~= 4e-4 at these n; allow 5 sigma on each side
        assert abs(g_mix - g_single) < 0.004, (cfg, g_mix, g_single)
        assert abs(t_mix - t_single) < 0.004, (cfg, t_mix, t_single)
        # zero-sum play: net reward is a +-1 walk over goals
        assert abs(stats[v, 0]) < 5 * max(np.sqrt(stats[v, 1]), 1)


def test_multigrid_kernel_final_states_valid():
    """Every lane ends in a reachable non-terminal state of ITS OWN
    variant (per-variant raw_to_dense classification)."""
    from gym_soccer_tpu.core import rules, tables
    _, _, fields = _mg_kernel_stats(3)
    ra, ca, rb, cb, p, t = (np.asarray(f).ravel() for f in fields)
    vid = np.arange(ra.size) % len(MG_CFGS)
    for v, cfg in enumerate(MG_CFGS):
        m = vid == v
        tb = tables.build_statespace(cfg)
        raw = rules.raw_encode(np, ra[m], ca[m], rb[m], cb[m], p[m], cfg)
        dense = tb.raw_to_dense[raw]
        assert (dense > 0).all(), cfg
        assert (t[m] >= 0).all() and (t[m] < cfg.max_steps).all()


def test_multigrid_kernel_blocking_and_chaining_invariance():
    from gym_soccer_tpu.ops.step_kernel import (
        pallas_multigrid_rollout, pallas_multigrid_rollout_chained)
    f1, s1 = pallas_multigrid_rollout(MG_CFGS, jnp.int32(7), 2048, 60,
                                      interpret=True)
    f4, s4 = pallas_multigrid_rollout(MG_CFGS, jnp.int32(7), 2048, 60,
                                      interpret=True, block=512)
    fc, sc = pallas_multigrid_rollout_chained(MG_CFGS, jnp.int32(7), 2048,
                                              60, steps_per_call=17,
                                              interpret=True)
    for a, b, c in zip(f1, f4, fc):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.array_equal(np.asarray(a), np.asarray(c))
    assert np.array_equal(np.asarray(s1), np.asarray(s4))
    assert np.array_equal(np.asarray(s1), np.asarray(sc))


def test_multigrid_kernel_initial_states_respect_variant_isd():
    """A zero-step call returns the host-built initial fields: every lane
    starts in ITS variant's ISD set."""
    from gym_soccer_tpu.core import rules, tables
    from gym_soccer_tpu.ops.step_kernel import pallas_multigrid_rollout
    fields, _ = pallas_multigrid_rollout(MG_CFGS, jnp.int32(0), 1024, 0,
                                         interpret=True)
    ra, ca, rb, cb, p, t = (np.asarray(f).ravel() for f in fields)
    assert (t == 0).all()
    vid = np.arange(ra.size) % len(MG_CFGS)
    for v, cfg in enumerate(MG_CFGS):
        _, raws = tables.build_isd(cfg)
        isd = {tuple(int(x) for x in rules.raw_decode(np, int(r), cfg))
               for r in raws}
        m = vid == v
        lanes = set(zip(ra[m], ca[m], rb[m], cb[m], p[m]))
        got = {tuple(int(x) for x in s) for s in lanes}
        assert got == isd, (cfg, got, isd)
