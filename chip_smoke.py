"""Smoke test of the system's main paths on an NVIDIA GPU.

Drives the normal entry points once, at full width, in ONE process on the
card, and checks every lane-loop kernel against its plain XLA twin:

1. the card (nvidia-smi name and power limit) and JAX's device;
2. compile every kernel at its real widths (memory analysis of the
   trainer chunk);
3. the four random rollouts at 262,144 lanes: kernel == twin bit for bit
   (fields, stats, journal words), with both rates;
4. learner chunks (minimax 5x4 and 11x7, IQL, alternating Q, best
   response, a 5x4+11x7 mixture): kernel and twin step identical
   trajectories with identical visit counts and residual sums within
   2^-20 per visit; two kernel runs are bit-identical; a 1+1-chunk resume
   equals 2 uninterrupted chunks;
5. the 5x4 --converge recipe reaches exploitability <= 0.010;
6. golden parity: the reference fixtures through core/parity's device
   path, bit for bit.

The last line is {"ok": true, "device": {...}}; any failed phase makes the
exit status non-zero.  Without a GPU it exits with status 2 and prints
no result.

``--four`` runs only the data-parallel path on four GPUs, at 65,536
lanes per card: the sharded fused trainer against its four single-device
shard chunks, and the state-sharded solve against the replicated one.

Run: python chip_smoke.py [--four] [--only PHASE,...]
"""
import argparse
import json
import sys
import time
import traceback

import numpy as np

PHASES = ("compile", "rollouts", "learners", "converge", "golden")
ROLL_B, ROLL_T = 262144, 1000
CHUNK_B, CHUNK_T = 65536, 32
RES_TOL = 2.0 ** -20          # per-visit residual tolerance (see _compare_chunk)


def _eq(a, b):
    import jax
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _cfgs():
    from gym_soccer_tpu.config import EnvConfig
    c54, c117 = EnvConfig(5, 4, 0.2), EnvConfig(11, 7, 0.2)
    return c54, c117, (c54, EnvConfig(6, 5, 0.1), EnvConfig(8, 6, 0.3))


def phase_compile(ctx):
    import jax.numpy as jnp
    from gym_soccer_tpu.ops import learner_kernel as lk
    from gym_soccer_tpu.ops import step_kernel as sk
    c54, c117, mg = _cfgs()
    for name, fn, cfg, t in (("rollout", sk.pallas_rollout, c54, ROLL_T),
                             ("alt_rollout", sk.pallas_alt_rollout, c54,
                              ROLL_T),
                             ("multigrid_rollout",
                              sk.pallas_multigrid_rollout, mg, ROLL_T),
                             ("journal_rollout", sk.pallas_journal_rollout,
                              c54, 256)):
        t0 = time.perf_counter()
        fn.lower(cfg, jnp.int32(0), ROLL_B, t).compile()
        print(f"  compiled {name} [{ROLL_B} lanes x {t}] in "
              f"{time.perf_counter() - t0:.1f} s")
    for cfg in (c54, c117):
        m, fields = _chunk_inputs(cfg, CHUNK_B)
        t0 = time.perf_counter()
        comp = lk.learner_chunk.lower(cfg, 1, m, fields, CHUNK_B,
                                      CHUNK_T).compile()
        print(f"  compiled learner_chunk {cfg.width}x{cfg.height} "
              f"[{CHUNK_B} x {CHUNK_T}] in {time.perf_counter() - t0:.1f} s;"
              f" memory_analysis: {comp.memory_analysis()}")


def phase_rollouts(ctx):
    import jax.numpy as jnp
    from gym_soccer_tpu.ops import step_kernel as sk
    from gym_soccer_tpu.utils.profiling import time_window
    c54, _, mg = _cfgs()
    for name, fn, cfg, t in (("rollout", sk.pallas_rollout, c54, ROLL_T),
                             ("alt_rollout", sk.pallas_alt_rollout, c54,
                              ROLL_T),
                             ("multigrid_rollout",
                              sk.pallas_multigrid_rollout, mg, ROLL_T),
                             ("journal_rollout", sk.pallas_journal_rollout,
                              c54, 256)):
        kern = fn(cfg, jnp.int32(5), ROLL_B, t)
        twin = fn(cfg, jnp.int32(5), ROLL_B, t, backend="xla")
        _check(_eq(kern, twin), f"{name}: kernel != twin")
        rates = {}
        for be in ("triton", "xla"):
            per_call, _, _ = time_window(
                lambda: fn(cfg, jnp.int32(5), ROLL_B, t, backend=be))
            rates[be] = ROLL_B * t / per_call
        print(f"  {name}: kernel == twin bit for bit; env-steps/s "
              f"triton {rates['triton']:.4g}, xla twin {rates['xla']:.4g} "
              f"({ctx['card']})")


def _chunk_inputs(cfg, batch, seed=3):
    """Chunk tables with random policies/values, and initial fields."""
    import jax.numpy as jnp
    from gym_soccer_tpu.core import tables
    from gym_soccer_tpu.ops import learner_kernel as lk
    nS = (sum(tables.build_statespace(c).nS for c in cfg)
          if isinstance(cfg, tuple) else tables.build_statespace(cfg).nS)
    rng = np.random.RandomState(seed)
    v = jnp.asarray(rng.uniform(-1, 1, nS).astype(np.float32))
    pa = jnp.asarray(rng.dirichlet(np.ones(5), nS).astype(np.float32))
    pb = jnp.asarray(rng.dirichlet(np.ones(5), nS).astype(np.float32))
    return lk.pack_m(cfg, pa, pb, v, eps=0.2), lk.init_state_fields(cfg,
                                                                    batch)


def _compare_chunk(name, run, decode, ctx):
    """Kernel vs twin on one chunk: fields and stats exact, counts exact,
    residual sums within RES_TOL per visit; two kernel runs bit-identical.
    The two compilers may contract r + gamma*v' - v into an FMA
    differently: each f32 rounding of that |delta| <= 3 sum is <= 2^-23,
    so the two residuals differ by < 2^-21 before they are rounded to
    the 2^-24 grid, and by < 2^-20 after; the decoded f32 sums add at
    most 2^-24 relative rounding each."""
    from gym_soccer_tpu.utils.profiling import time_window
    k1, k2, tw = run("triton"), run("triton"), run("xla")
    _check(_eq(k1, k2), f"{name}: two kernel runs differ")
    _check(_eq(k1[0], tw[0]), f"{name}: fields differ from the twin")
    _check(_eq(k1[2], tw[2]), f"{name}: stats differ from the twin")
    dk, dt = decode(k1[1]), decode(tw[1])
    worst = 0.0
    for (sk_, ck), (st, ct) in zip(dk, dt):
        _check(np.array_equal(np.asarray(ck), np.asarray(ct)),
               f"{name}: visit counts differ from the twin")
        diff = np.abs(np.asarray(sk_) - np.asarray(st))
        _check((diff <= np.asarray(ck) * RES_TOL
                + np.abs(np.asarray(st)) * 2.0 ** -23).all(),
               f"{name}: residual sums beyond tolerance")
        worst = max(worst, float((diff / np.maximum(np.asarray(ck), 1))
                                 .max()))
    times = {be: time_window(lambda: run(be))[0] for be in ("triton", "xla")}
    work = CHUNK_B * CHUNK_T
    print(f"  {name}: kernel == twin (fields, stats, counts); worst "
          f"residual diff {worst:.3g} per visit (tol {RES_TOL:.3g}); "
          f"deterministic; env-steps/s triton {work / times['triton']:.4g}, "
          f"xla twin {work / times['xla']:.4g} ({ctx['card']})")


def _check_resume(name, train, split):
    """1+1 chunks == 2 uninterrupted chunks, for a fused trainer.
    ``train(n_chunks, **resume_kw)`` returns (outputs, resume_dict);
    ``split(resume)`` gives the follow-up call's keyword arguments."""
    full, _ = train(2)
    _, r1 = train(1)
    half, _ = train(1, **split(r1))
    _check(_eq(full, half), f"{name}: 1+1-chunk resume != 2 chunks")
    print(f"  {name}: 1+1-chunk resume == 2 uninterrupted chunks")


def phase_learners(ctx):
    import jax.numpy as jnp
    from gym_soccer_tpu.envs.soccer_alternating_env import build_alt_tables
    from gym_soccer_tpu.ops import altq_kernel as ak
    from gym_soccer_tpu.ops import iql_kernel as ik
    from gym_soccer_tpu.ops import learner_kernel as lk
    from gym_soccer_tpu.utils.policies import get_random_policy_array
    c54, c117, _ = _cfgs()
    B, T = CHUNK_B, CHUNK_T
    for cfg in (c54, c117):
        m, fields = _chunk_inputs(cfg, B)
        _compare_chunk(
            f"minimax chunk {cfg.width}x{cfg.height}",
            lambda be: lk.learner_chunk(cfg, 7, m, fields, B, T, backend=be),
            lambda acc: [lk.unpack_acc(cfg, acc)], ctx)
    mix = (c54, c117)
    m, (planes, fields) = _chunk_inputs(mix, B)
    _compare_chunk(
        "multigrid chunk 5x4+11x7",
        lambda be: lk.multigrid_learner_chunk(mix, 7, m, planes, fields, B,
                                              T, backend=be),
        lambda acc: [lk.unpack_acc(mix, acc)], ctx)
    rng = np.random.RandomState(4)
    nS = 761
    qa = jnp.asarray(rng.uniform(-1, 1, (nS, 5)), jnp.float32)
    qb = jnp.asarray(rng.uniform(-1, 1, (nS, 5)), jnp.float32)
    mi, fi = ik.pack_iql_m(c54, qa, qb), ik.init_iql_state_fields(c54, B)
    _compare_chunk(
        "iql chunk 5x4",
        lambda be: ik.iql_chunk(c54, 7, 19661, mi, fi, B, T, backend=be),
        lambda acc: (lambda r: [r[:2], r[2:]])(ik.unpack_iql_acc(c54, acc)),
        ctx)
    nSa = build_alt_tables(c54).nS
    qalt = jnp.asarray(rng.uniform(-1, 1, (nSa, 5)), jnp.float32)
    ma, fa = ak.pack_alt_m(c54, qalt), ak.init_alt_state_fields(c54, B)
    _compare_chunk(
        "altq chunk 5x4",
        lambda be: ak.altq_chunk(c54, 7, 19661, ma, fa, B, T, backend=be),
        lambda acc: [ak.unpack_alt_acc(c54, acc)], ctx)
    opp = get_random_policy_array(nS, 5, seed=42)
    opp_oh = jnp.asarray(np.eye(5, dtype=np.float32)[opp])
    mb = lk.pack_m(c54, jnp.full((nS, 5), 0.2), opp_oh, jnp.zeros(nS), 0.3,
                   eps_b=0.0)
    fb = lk.init_state_fields(c54, B)
    _compare_chunk(
        "best-response chunk 5x4",
        lambda be: lk.learner_chunk(c54, 7, mb, fb, B, T, backend=be),
        lambda acc: [lk.unpack_acc(c54, acc)], ctx)

    kw = dict(batch=B, chunk_len=T, seed=5, return_state=True)

    def minimax(cfg):
        def train(n, **more):
            out = lk.fused_minimax_train(cfg, n_chunks=n, lr=1.0, eps=0.3,
                                         eps_halflife=64, solver_iters=100,
                                         **kw, **more)
            return out[:4], out[5]
        return train

    def split_minimax(r):
        return dict(init=(r["q"], r["v"], r["pi_a"], r["pi_b"], r["n"]),
                    fields_init=r["fields"], start_chunk=r["next_chunk"])

    _check_resume("fused_minimax_train 5x4", minimax(c54), split_minimax)
    _check_resume("fused_minimax_train 5x4+11x7", minimax(mix),
                  split_minimax)

    def iql(n, **more):
        out = ik.fused_iql_train(c54, n_chunks=n, lr=0.5, eps=0.3, **kw,
                                 **more)
        return out[:2], out[3]
    _check_resume("fused_iql_train 5x4", iql, lambda r: dict(
        init=(r["q_a"], r["q_b"]), fields_init=r["fields"],
        start_chunk=r["next_chunk"]))

    def altq(n, **more):
        out = ak.fused_altq_train(c54, n_chunks=n, lr=0.5, eps=0.3, **kw,
                                  **more)
        return out[0], out[2]
    _check_resume("fused_altq_train 5x4", altq, lambda r: dict(
        init=r["q"], fields_init=r["fields"], start_chunk=r["next_chunk"]))

    def br(n, **more):
        out = lk.fused_best_response_train(c54, opp, "player_a", n_chunks=n,
                                           eps=0.3, eps_halflife=64, **kw,
                                           **more)
        return out[:4], out[5]
    _check_resume("fused_best_response_train 5x4", br, lambda r: dict(
        init=(r["q"], r["n"]), fields_init=r["fields"],
        start_chunk=r["next_chunk"]))


def phase_converge(ctx):
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "train_minimax", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "examples", "train_minimax.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    _, _, _, res = ex.converge((5, 4))
    print(f"  --converge 5x4: {res} ({ctx['card']})")
    _check(res["exploitability"] <= 0.010,
           f"exploitability {res['exploitability']} > 0.010")


def phase_golden(ctx):
    import json as _json
    import os
    import jax
    import jax.numpy as jnp
    from gym_soccer_tpu.core import parity, rules
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "parity_fixtures", os.path.join(root, "tests",
                                        "test_parity_batched.py"))
    fx_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx_mod)
    FIXTURES, fixture_script = fx_mod.FIXTURES, fx_mod.fixture_script
    groups = {}
    for name, (cfg, frozen, pol) in FIXTURES.items():
        groups.setdefault((cfg, frozen), []).append(name)
    n = 0
    for (cfg, frozen), names in groups.items():
        pt = parity.parity_tables(cfg, frozen, FIXTURES[names[0]][2])
        scripts = [fixture_script(nm) for nm in names]
        T = min(len(s[1]) for s in scripts)
        seeds = np.asarray([s[0] for s in scripts], np.uint32)
        rows = jnp.asarray(np.asarray(
            [[st["row"] for st in s[1][:T]] for s in scripts], np.int32).T)
        final, out = jax.jit(lambda s, r: parity.parity_rollout_device(
            cfg, pt, s, r))(jnp.asarray(seeds), rows)
        out = jax.tree.map(np.asarray, out)
        for lane, (name, (_, steps)) in enumerate(zip(names, scripts)):
            for t in range(T):
                exp = steps[t]
                _check(int(out.obs[t, lane]) == exp["obs"], f"{name} obs {t}")
                _check(np.float32(exp["reward"]).tobytes()
                       == out.reward_a[t, lane].tobytes(),
                       f"{name} reward {t}")
                _check(bool(out.done[t, lane]) == exp["done"],
                       f"{name} done {t}")
                _check(bool(out.truncated[t, lane]) == exp["trunc"],
                       f"{name} trunc {t}")
            got = rules.raw_decode(np, int(np.asarray(final.raw)[lane]), cfg)
            _check(list(got) == steps[T - 1]["state"], f"{name} final state")
            n += 1
    gold = _json.load(open(os.path.join(root, "tests", "golden",
                                        "reference_golden.json")))
    fx = gold["policy_eval_5x4_slip02_joint"]
    cfg = FIXTURES["traj_5x4_slip02_multi_seed123"][0]
    pt = parity.parity_tables(cfg)
    rows = parity.policy_rows(pt, np.asarray(fx["policy_a"], np.int32),
                              np.asarray(fx["policy_b"], np.int32))
    n_epi = 40
    lengths = fx["episode_lengths"][:n_epi]
    steps = sum(lengths)
    _, out = jax.jit(lambda s: parity.parity_policy_rollout_device(
        cfg, pt, s, rows, steps))(jnp.asarray([fx["reset_seed"]], jnp.uint32))
    term = np.asarray(out.done | out.truncated)[:, 0]
    got = np.diff(np.concatenate([[-1], np.nonzero(term)[0]]))[:n_epi]
    _check(got.tolist() == lengths, "policy-eval episode lengths")
    print(f"  golden parity: {n} trajectory fixtures + the reference "
          f"main()'s {n_epi}-episode policy eval, bit for bit")


def phase_four(ctx):
    import jax
    import jax.numpy as jnp
    from gym_soccer_tpu.agents.learners import solve_matrix_games
    from gym_soccer_tpu.ops import learner_kernel as lk
    from gym_soccer_tpu.parallel import mesh as pmesh
    _check(len(jax.devices()) >= 4, "--four needs four GPUs")
    mesh = pmesh.env_mesh(4)
    c54 = _cfgs()[0]
    B, T = 4 * CHUNK_B, CHUNK_T        # 65,536 lanes per card
    m, fields = _chunk_inputs(c54, B)
    fn = pmesh.sharded_learner_chunk_fn(c54, mesh, B, T)
    out_fields, acc, stats = fn(3, m, fields)
    rows = B // 4 // 128
    acc_sum, st_sum = None, np.zeros(3, np.int64)
    gold = 0x61C88647
    for i in range(4):
        bits = (3 ^ ((i * gold) & 0xFFFFFFFF)) & 0xFFFFFFFF
        sseed = np.int32(bits - (1 << 32) if bits >= 1 << 31 else bits)
        f_i = tuple(f[i * rows:(i + 1) * rows] for f in fields)
        of_i, acc_i, st_i = lk.learner_chunk(c54, sseed, m, f_i, B // 4, T)
        acc_sum = np.asarray(acc_i) if acc_sum is None else (
            acc_sum + np.asarray(acc_i))
        st_sum += np.asarray([int(x) for x in st_i])
        _check(_eq(of_i, tuple(f[i * rows:(i + 1) * rows]
                               for f in out_fields)),
               f"shard {i}: fields differ from its single-device chunk")
    _check(np.array_equal(np.asarray(acc), acc_sum),
           "psum'd accumulator != sum of the 4 shard chunks")
    _check(st_sum.tolist() == [int(x) for x in stats], "psum'd stats")
    print("  sharded chunk (4 GPUs): fields per shard and the psum'd "
          "integer accumulator equal the 4 single-device shard chunks")
    q, v, pa, pb, hist = lk.fused_minimax_train(
        c54, batch=B, n_chunks=4, chunk_len=T, lr=1.0, eps=0.3,
        solver_iters=100, mesh=mesh, seed=2)
    _check(np.isfinite(np.asarray(q)).all() and float(jnp.abs(v).max()) > 0,
           "fused_minimax_train(mesh) values")
    print(f"  fused_minimax_train(mesh=env_mesh(4)): 4 chunks, "
          f"{sum(h[1] for h in hist)} goals in the recorded chunks")
    rng = np.random.RandomState(3)
    qr = jnp.asarray(rng.uniform(-1, 1, (761, 5, 5)).astype(np.float32))
    want = jax.jit(lambda x: solve_matrix_games(x, iters=400))(qr)
    got = pmesh.sharded_solve_fn(mesh, iters=400)(qr)
    _check(_eq(got, want), "sharded solve != replicated solve")
    print("  sharded_solve_fn (4 GPUs) == replicated solve, bit for bit")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the data-parallel path on four GPUs")
    ap.add_argument("--only", default="",
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args()

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devs[0].platform}", file=sys.stderr)
        return 2
    from gym_soccer_tpu.utils.cache import enable_compile_cache
    from gym_soccer_tpu.utils.profiling import card_line, device_line
    cache = enable_compile_cache()
    dev = device_line()
    ctx = {"card": card_line()}
    print(f"card: {ctx['card']}")
    print(f"device: {dev}; compile cache: {cache}")
    sys.stdout.flush()

    if args.four:
        phases = ("four",)
    else:
        phases = tuple(p for p in args.only.split(",") if p) or PHASES
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        print(f"[{name}]")
        sys.stdout.flush()
        try:
            globals()[f"phase_{name}"](ctx)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        print(f"[{name}] {'FAILED' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s")
        sys.stdout.flush()
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
