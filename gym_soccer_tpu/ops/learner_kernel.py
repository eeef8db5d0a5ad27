"""Fused minimax-Q actor/TD chunks on the lane loop.

The XLA learner (agents/learners.minimax_train) steps, samples and
updates as separate array programs per step.  Here a whole
act -> step -> TD chunk runs per lane (ops/lane_loop.py: a Pallas-Triton
kernel or its plain XLA twin), one env lane per GPU thread:

* M, the chunk's table, is f32 [n_codes, M_COLS] indexed by the COMPACT
  closed-form cellpair code (core/rules.cellpair_encode -- arithmetic,
  no dense-lookup gather): the exploration-mixed policies pi_a, pi_b and
  the value v.  Each lane reads its own row (5x4: 1104 rows, 70 KB;
  11x7: 13,612 rows, 0.9 MB -- both L2-resident);
* M is FROZEN within a chunk, so the per-visit TD decomposes as
    (r + gamma*v(s') - v(s))  +  (v(s) - q[s, ja])
  where the second term is constant per (s, ja): the lane accumulates
  only the BELLMAN RESIDUAL delta = r + gamma*v(s') - v(s) and a visit
  count per (s, ja) cell, and the between-chunk update adds
  cnt*(v - q).  The v(s') a step's TD waits for is the v the NEXT step's
  row read fetches (terminated lanes mask it with cont=0, so the
  autoreset rewrite never corrupts a target); a trailing read retires
  the last step;
* the accumulator is int32 fixed point (`scatter_residual`, 2^-24
  steps): exact integer sums are independent of the order in which
  lanes add them,
  which keeps every chunk -- and so the trainers' checkpoint/resume --
  bit-reproducible on the GPU;
* the env transition is ops/step_kernel.transition_core (same
  branchless chain and counter PRNG as the rollouts).

The wrapper (`fused_minimax_train`) applies the count-normalized Q
update and the RM+ game re-solve between chunks -- the same cadence as
agents/learners.minimax_train with `resolve_every` == chunk length.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, N_ACTIONS
from . import lane_loop as ll
from . import step_kernel as sk

LANES = 128
NJ = N_ACTIONS * N_ACTIONS   # 25 joint actions
M_COLS = 16                  # f32 words per M row
COL_PI_A, COL_PI_B, COL_V = 0, 5, 10

# Accumulator: ACC_WORDS int32 per (state, action) cell.  In the kernel a
# visit adds its residual, rounded to q = round(delta * 2^FIX_BITS), as
# three limbs of LIMB_BITS (hi = q >> 18, signed; mid and lo in [0, 2^9)),
# and 1 to the count.  Rounding costs <= 2^-25 per visit: no coarser than
# a bf16-rounded residual (2^-9 * |delta|) for any |delta| >= 2^-16.
# delta is clamped to |delta| < 4 (|r| <= 1 and |v| <= 1 give
# |delta| <= 3), so every limb is at most 2^8 in magnitude and each word
# holds MAX_VISITS visits of one cell exactly -- guaranteed when
# batch * chunk_len <= MAX_VISITS on each device.
# `fold_acc` then carries the limbs into (whole, frac): the residual sum's
# integer part (|whole| <= 2^24) and its FIX_BITS fraction bits in
# [0, 2^24).  Chunks return folded words; those of up to MAX_SHARDS
# devices add (psum) without overflow, and `decode_acc` carries frac's
# excess into whole before it converts to f32.
ACC_WORDS = 4        # kernel: hi, mid, lo, count; folded: whole, frac, count, 0
FIX_BITS, LIMB_BITS = 24, 9
FIX_MAX = (1 << (FIX_BITS + 2)) - (1 << LIMB_BITS)
MAX_VISITS = 1 << 22
MAX_SHARDS = (1 << (31 - FIX_BITS)) - 1


def check_visits(batch: int, n_steps: int) -> None:
    """Overflow guard for the int32 accumulator words (see ACC_WORDS);
    ``batch`` is one device's lanes."""
    if batch * n_steps > MAX_VISITS:
        raise ValueError(
            f"batch * chunk_len = {batch * n_steps} exceeds {MAX_VISITS}, "
            f"the most visits the int32 accumulator holds exactly; use a "
            f"shorter chunk")


def scatter_residual(ctx, a: int, cell, delta, valid):
    """acc[cell] += (delta, 1) in fixed point, where ``valid`` (int32
    0/1) is set."""
    q = jnp.clip(jnp.floor(delta * float(1 << FIX_BITS) + 0.5),
                 -FIX_MAX, FIX_MAX).astype(jnp.int32)
    mask = (1 << LIMB_BITS) - 1
    base = cell * ACC_WORDS
    ctx.scatter_add(a, base, (q >> (2 * LIMB_BITS)) * valid)
    ctx.scatter_add(a, base + 1, ((q >> LIMB_BITS) & mask) * valid)
    ctx.scatter_add(a, base + 2, (q & mask) * valid)
    ctx.scatter_add(a, base + 3, valid)


def fold_acc(acc):
    """Kernel words (hi, mid, lo, count) -> folded (whole, frac, count,
    0), exactly: integer carries only (see ACC_WORDS)."""
    w = acc.reshape(-1, ACC_WORDS)
    hi, mid, lo, cnt = (w[:, k] for k in range(ACC_WORDS))
    mask = (1 << LIMB_BITS) - 1
    t = (mid & mask) + (lo >> LIMB_BITS)
    hi = hi + (mid >> LIMB_BITS) + (t >> LIMB_BITS)
    top = FIX_BITS - 2 * LIMB_BITS        # hi's bits below the unit
    frac = (((hi & ((1 << top) - 1)) << (2 * LIMB_BITS))
            | ((t & mask) << LIMB_BITS) | (lo & mask))
    return jnp.stack([hi >> top, frac, cnt, jnp.zeros_like(cnt)],
                     -1).reshape(-1)


def decode_acc(acc, cells):
    """(residual sums, counts) f32 of folded accumulator ``cells`` (any
    shape)."""
    w = acc.reshape(-1, ACC_WORDS)[cells]
    whole = w[..., 0] + (w[..., 1] >> FIX_BITS)
    frac = w[..., 1] & ((1 << FIX_BITS) - 1)
    return (whole.astype(jnp.float32)
            + frac.astype(jnp.float32) * float(2.0 ** -FIX_BITS),
            w[..., 2].astype(jnp.float32))


def sample5(cols5, u01):
    """First-exceedance sample from 5 probability columns."""
    total = cols5[0]
    for k in range(1, N_ACTIONS):
        total = total + cols5[k]
    target = u01 * total
    a = jnp.zeros(u01.shape, jnp.int32)
    c = cols5[0]
    for k in range(1, N_ACTIONS):
        a = a + (c <= target).astype(jnp.int32)
        c = c + cols5[k]
    return a


def n_codes(cfg) -> int:
    """Total compact cellpair codes (variants concatenated for tuples)."""
    from ..core import rules
    if isinstance(cfg, tuple):
        return int(sum(rules.n_cellpairs(c) for c in cfg))
    return rules.n_cellpairs(cfg)


def code_offsets(cfgs: tuple) -> np.ndarray:
    """Per-variant code offsets of the MULTIGRID tables: variants'
    compact code blocks are concatenated."""
    from ..core import rules
    sizes = [rules.n_cellpairs(c) for c in cfgs]
    return np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)


def _minimax_body(cfg, n_steps: int, gamma: float, max_steps: int = 0):
    """Per-lane fused actor/TD loop for ops/lane_loop.  ``cfg`` is a
    static EnvConfig, or None for the MULTIGRID body, whose lanes carry 6
    more planes after the 6 state fields (H, W, glo, ghi, q_int, code
    offset): geometry becomes data (ops/step_kernel.GeoPlanes) and each
    lane indexes its own variant's block of M/acc -- one compiled kernel
    trains any mixture of board variants."""
    from ..core import rules

    def body(ctx, lanes):
        seed = ctx.scalar(0).astype(jnp.uint32)
        if cfg is None:
            geo = sk.GeoPlanes(*lanes[6:11], max_steps=max_steps)
            q_int, off = geo.q_int, lanes[11]
        else:
            geo, q_int = cfg, int(round(cfg.slip_prob * 65536))
            off = None
        gamma_f = jnp.float32(gamma)

        def code_of(ra, ca, rb, cb, p):
            c = rules.cellpair_encode(jnp, ra, ca, rb, cb, p, geo)
            return c if off is None else c + off

        def read(code, col):
            return ctx.gather(0, code * M_COLS + col)

        def retire(v_here, pend):
            cell, r, cont, v_prev, valid = pend
            scatter_residual(ctx, 0, cell, r + cont * v_here - v_prev, valid)

        def step(i, c):
            ra, ca, rb, cb, p, t, pend, rew, goals, truncs = c
            bits0 = sk._random_word(seed, i, 0, ctx.lane)
            bits1 = sk._random_word(seed, i, 1, ctx.lane)
            bits2 = sk._random_word(seed, i, 2, ctx.lane)

            code = code_of(ra, ca, rb, cb, p)
            v_here = read(code, COL_V)
            retire(v_here, pend)

            inv = jnp.float32(1.0 / 65536.0)
            ua = sk._u16(bits0, 0).astype(jnp.float32) * inv
            ub = sk._u16(bits0, 1).astype(jnp.float32) * inv
            aa = sample5([read(code, COL_PI_A + k) for k in range(5)], ua)
            ab = sample5([read(code, COL_PI_B + k) for k in range(5)], ub)

            nra, nca, nrb, ncb, npz, goal, r = sk.transition_core(
                ra, ca, rb, cb, p, aa, ab, bits1, bits2, geo, q_int)
            nra, nca, nrb, ncb, npz, t2, trunc = sk.autoreset_core(
                nra, nca, nrb, ncb, npz, t, goal, bits2, geo)

            cont = jnp.where(goal | trunc, 0.0, gamma_f)
            new_pend = (code * NJ + aa * N_ACTIONS + ab,
                        r.astype(jnp.float32), cont, v_here,
                        jnp.ones_like(ra))
            return (nra, nca, nrb, ncb, npz, t2, new_pend,
                    rew + r, goals + goal.astype(jnp.int32),
                    truncs + trunc.astype(jnp.int32))

        zi = jnp.zeros_like(lanes[0])
        zf = jnp.zeros(zi.shape, jnp.float32)
        init = tuple(lanes[:6]) + ((zi, zf, zf, zf, zi), zi, zi, zi)
        ra, ca, rb, cb, p, t, pend, rew, goals, truncs = ctx.fori(
            n_steps, step, init)
        # trailing read retires the final step's TD
        retire(read(code_of(ra, ca, rb, cb, p), COL_V), pend)
        return ra, ca, rb, cb, p, t, rew, goals, truncs

    return body


def run_chunk(body, lanes, seed, batch: int, n_steps: int, n_fields: int,
              m, n_cells: int, scalars=(), name: str = "learner_chunk",
              **launch):
    """Launch a learner body: ``lanes`` [batch/128, 128] planes in, the
    first ``n_fields`` of them updated out.  Returns (new_fields, folded
    acc int32 [n_cells * ACC_WORDS], stats (reward_sum, goals,
    truncs))."""
    assert n_steps > 0
    assert batch % LANES == 0, f"batch must be a multiple of {LANES}"
    check_visits(batch, n_steps)
    outs, (acc,), _ = ll.run(
        body, batch=batch, lanes=sk._lanes(lanes, batch),
        scalars=(seed,) + tuple(scalars), tables=(m,),
        acc_sizes=(n_cells * ACC_WORDS,), n_out=n_fields + 3, name=name,
        **launch)
    stats = tuple(jnp.sum(o) for o in outs[n_fields:])
    return sk._planes(outs[:n_fields], batch), fold_acc(acc), stats


@ll.static_args("cfg", "batch", "n_steps", "gamma")
def learner_chunk(cfg: EnvConfig, seed, m, state_fields, batch: int,
                  n_steps: int, gamma: float = 0.99, backend: str = "triton",
                  block: int = ll.BLOCK,
                  interpret: bool = False):
    """Run one fused chunk.  ``m`` from `pack_m`; ``state_fields`` = 6
    int32 [batch/128, 128] planes.  Returns (new_fields, acc, stats[3]);
    decode acc with `unpack_acc`."""
    body = _minimax_body(cfg, n_steps, gamma)
    return run_chunk(body, state_fields, seed, batch, n_steps, 6, m,
                     n_codes(cfg) * NJ, backend=backend, block=block, interpret=interpret)


@ll.static_args("cfgs", "batch", "n_steps", "gamma")
def multigrid_learner_chunk(cfgs: tuple, seed, m, planes, state_fields,
                            batch: int, n_steps: int, gamma: float = 0.99,
                            backend: str = "triton", block: int = ll.BLOCK,
                            interpret: bool = False):
    """Run one fused chunk over a MIXED-geometry batch (BASELINE config
    4, training edition).  ``m`` from `pack_m` with the tuple ``cfgs``;
    ``planes`` = the 6 int32 [batch/128, 128] geometry planes from
    `init_state_fields`'s multigrid mode; ``state_fields`` = 6 int32
    planes.  Returns (new_fields, acc, stats[3])."""
    assert len({c.max_steps for c in cfgs}) == 1, \
        "variants must share max_steps"
    body = _minimax_body(None, n_steps, gamma, cfgs[0].max_steps)
    return run_chunk(body, tuple(state_fields) + tuple(planes), seed, batch,
                     n_steps, 6, m, n_codes(cfgs) * NJ,
                     name="multigrid_learner_chunk", backend=backend,
                     block=block, interpret=interpret)


@functools.lru_cache(maxsize=None)
def _cell_rows(cfg) -> np.ndarray:
    """Compact cellpair code of each dense state (dense row -> M row).
    A tuple cfg gives the MULTIGRID rows: per-variant codes shifted by
    the variant's block offset, concatenated in codec order
    (core/multigrid.build_codec's offsets)."""
    from ..core import rules, tables
    if isinstance(cfg, tuple):
        return np.concatenate([_cell_rows(c) + o
                               for c, o in zip(cfg, code_offsets(cfg))])
    d2r = tables.build_statespace(cfg).dense_to_raw.astype(np.int64)
    xa, ya, xb, yb, p = rules.raw_decode(np, d2r, cfg)
    return rules.cellpair_encode(np, xa, ya, xb, yb, p, cfg).astype(np.int32)


def pack_m(cfg, pi_a, pi_b, v, eps, eps_b=None) -> jnp.ndarray:
    """Pack (exploration-mixed) policies and v into the chunk's M, f32
    [n_codes(cfg) * M_COLS] indexed by compact cellpair code.

    ``eps`` mixes uniform exploration into pi_a; ``eps_b`` (default:
    same as ``eps``) into pi_b -- per-side epsilons are what let the
    frozen-opponent mode keep the opponent EXACT (eps 0) while the
    learner explores (the reference substitutes the frozen policy
    verbatim at table-build time, soccer_simultaneous_env.py:187-188).

    ``cfg`` may be a tuple of EnvConfigs (MULTIGRID): tables are then
    indexed by the global dense state (variants concatenated in
    core/multigrid.build_codec's offset order)."""
    if eps_b is None:
        eps_b = eps
    rows = jnp.asarray(_cell_rows(cfg))
    m = jnp.zeros((n_codes(cfg), M_COLS), jnp.float32)
    m = m.at[rows, COL_PI_A:COL_PI_A + 5].set(
        pi_a * (1 - eps) + eps / N_ACTIONS)
    m = m.at[rows, COL_PI_B:COL_PI_B + 5].set(
        pi_b * (1 - eps_b) + eps_b / N_ACTIONS)
    m = m.at[rows, COL_V].set(v)
    return m.reshape(-1)


def unpack_acc(cfg, acc) -> tuple[jnp.ndarray, jnp.ndarray]:
    """acc -> dense (sum_residual, cnt), each [nS, 5, 5] (for a tuple
    cfg: nS = the mixture's concatenated state count).  The per-visit TD
    is residual + (v - q) with v/q frozen in-chunk, so sum_td =
    sum_residual + cnt * (v - q)."""
    rows = jnp.asarray(_cell_rows(cfg))
    cells = rows[:, None] * NJ + jnp.arange(NJ)[None, :]
    sum_res, cnt = decode_acc(acc, cells)
    nS = rows.shape[0]
    return sum_res.reshape(nS, 5, 5), cnt.reshape(nS, 5, 5)


def init_state_fields(cfg, batch: int):
    """Lane-tiled initial state spread over the ISD (shared helper with
    the rollouts) plus a zeroed step counter.

    For a tuple cfg (MULTIGRID) returns ``(planes, fields)``: the 6
    geometry planes the multigrid body needs (H, W, glo, ghi, q_int,
    code offset) and the 6 state fields.  Lanes are assigned variants in
    CONTIGUOUS chunks ('blocked' layout), so almost every block of lanes
    reads only its own variant's rows."""
    shape = (batch // LANES, LANES)
    if isinstance(cfg, tuple):
        planes, isd_init = sk._mg_planes(cfg, batch, shape,
                                         layout="blocked")
        off = jnp.asarray(code_offsets(cfg))[planes[5]]   # vid -> offset
        fields = tuple(isd_init) + (jnp.zeros(shape, jnp.int32),)
        return tuple(planes[:5]) + (off,), fields
    return sk.isd_spread_fields(cfg, batch, shape) + (
        jnp.zeros(shape, jnp.int32),)


def fused_minimax_train(cfg, batch: int, n_chunks: int,
                        chunk_len: int = 64, lr: float = 0.3,
                        gamma: float = 0.99, eps: float = 0.3,
                        lr_halflife: int = 0, eps_halflife: int = 0,
                        solver_iters: int = 200, seed: int = 0,
                        count_lr_tau: float = 0.0,
                        count_lr_pow: float = 0.85,
                        eps_min: float = 0.0,
                        lr_anneal_start: int = 0,
                        lr_anneal_tau: float = 0.0,
                        lr_anneal_pow: float = 1.0,
                        avg_after: int = 0,
                        avg_q: bool = False,
                        final_solver_iters: int = 0,
                        backend: str = "triton",
                        single_dispatch: bool = False,
                        init: tuple | None = None,
                        mesh=None,
                        start_chunk: int = 0,
                        fields_init: tuple | None = None,
                        return_state: bool = False,
                        chunks_per_dispatch: int = 1):
    """Chunked fused minimax-Q training.  Returns (q, v, pi_a, pi_b,
    stats_history).  Semantics match agents/learners.minimax_train with
    resolve_every == chunk_len (chunk-stale TD baselines).

    Error model for this chunked learner (empirically verified on 5x4):
    each chunk applies ONE count-normalized mean update per visited cell
    against a chunk-stale V, so values propagate one Bellman backup per
    CHUNK — final bias ~ gamma^n_chunks — while per-chunk sample noise is
    already tiny (hundreds of visits per cell averaged).  Convergence
    therefore wants lr ~= 1.0 (each chunk = one full empirical Bellman
    backup; fastest contraction) followed by a polynomial tail that
    averages the noise: ``lr_anneal_start``/``lr_anneal_tau``/
    ``lr_anneal_pow`` give lr_k = lr * (1 + max(0, k-start)/tau)^(-pow)
    over the CHUNK index k (tau=1, pow=1 after start is exact harmonic
    averaging of the last chunks' backups).  ``count_lr_tau`` instead
    decays per-CELL over lifetime visit counts (Littman's per-visit
    alpha) — appropriate for per-step updates (agents/learners) but too
    aggressive here, where visits per cell per chunk are O(100).

    ``eps_min`` floors the exploration anneal so late training keeps
    visiting off-equilibrium cells.  ``final_solver_iters`` re-solves all
    state games once more at the end with a higher RM+ iteration budget
    (the returned policies' quality is otherwise capped by the in-loop
    ``solver_iters``).

    ``avg_after`` > 0 returns TIME-AVERAGED strategies over chunks
    >= avg_after instead of the final solve's: per-state equilibrium
    strategies of a noisy Q oscillate around near-ties, and (as in
    fictitious play / regret averaging) their average converges much
    faster than the iterates.  The returned (v, q) stay the final
    iterates; only (pi_a, pi_b) are averaged (then re-normalized).

    ``avg_q`` (with avg_after) averages the Q TABLE over the same tail
    window and returns the equilibrium of solve(mean Q) instead of the
    mean of the per-chunk equilibria: the matrix-game solve amplifies Q
    noise at near-ties, so solving the time-averaged game beats
    averaging the per-iterate solutions (see BASELINE.md's 11x7
    sweep).  The final solve uses ``final_solver_iters`` (or
    ``solver_iters`` if 0); returned v is solve(mean Q)'s value while q
    stays the final iterate.

    ``init``: optional (q, v, pi_a, pi_b) or (q, v, pi_a, pi_b, n) warm
    start — resume a previous run or chain phases with different lr/eps
    schedules (annealed fine-tuning measurably improves final
    exploitability).

    ``start_chunk``/``fields_init``/``return_state`` give EXACT
    checkpoint/resume (utils/checkpoint.py is the serializer): with
    ``return_state=True`` a sixth element ``resume`` is returned — a dict
    of (q, v, pi_a, pi_b, n, fields, next_chunk), the raw loop state
    BEFORE any avg_after/final_solver_iters post-processing — and a
    follow-up call with
    ``init=(resume['q'], resume['v'], resume['pi_a'], resume['pi_b'],
    resume['n'])``, ``fields_init=resume['fields']``,
    ``start_chunk=resume['next_chunk']`` continues BIT-IDENTICALLY to an
    uninterrupted run (chunk PRNG seeds, lr/eps schedules and the packed
    M all key off the absolute chunk index; on resume M is repacked with
    the epsilon chunk ``start_chunk`` saw in the continuous run, i.e.
    decayed at index start_chunk-1).  The chunk accumulators are exact
    integer sums, so this holds on the GPU as on the CPU.  ``avg_after``
    averaging windows are
    per-call: a resumed call restarts its strategy average at its own
    ``avg_after`` (pass absolute chunk indices to keep schedules aligned).

    ``single_dispatch`` wraps the whole run in one jitted lax.scan (one
    dispatch, one long compile); the default per-chunk loop dispatches
    each chunk and its between-chunk update separately.
    ``chunks_per_dispatch`` > 1 is the middle ground: a short jitted scan
    of that many (chunk + between) bodies per dispatch -- one compile
    (the scan length is static), g-fold fewer dispatches.  Like
    single_dispatch it computes schedules in-graph in f32 (can differ
    from the host f64 schedule by an ulp); the exact-resume contract
    remains on the default per-chunk mode.
    ``avg_after`` works in every dispatch mode (the scan modes carry the
    strategy sums in-graph).  ``stats_history`` cadence differs by mode:
    the default per-chunk loop records every 16th chunk (plus the last)
    while the scan modes record every chunk.

    ``cfg`` may be a TUPLE of EnvConfigs: the run then trains ONE
    concatenated table over a mixed-geometry batch (lanes round-robin
    across variants) through the multigrid kernel — per-variant results
    live at core/multigrid.build_codec's offsets.

    ``mesh`` (a jax.sharding.Mesh with an 'env' axis) shards the lane
    batch over devices: each device runs its own fused chunk and the
    TD/count accumulators are psum'd, so the replicated between-chunk
    update sees the whole batch -- DP scaling of the fused path
    (parallel/mesh.sharded_learner_chunk_fn).

    ``backend`` picks the chunk launcher (ops/lane_loop): the 'triton'
    kernel, or its plain 'xla' twin (what runs on CPU)."""
    from ..agents.learners import solve_matrix_games
    from ..core import tables
    if isinstance(cfg, tuple):
        nS = int(sum(tables.build_statespace(c).nS for c in cfg))
    else:
        nS = tables.build_statespace(cfg).nS
    launch = dict(backend=backend)

    n = jnp.zeros((nS, 5, 5), jnp.float32)
    if init is None:
        q = jnp.zeros((nS, 5, 5), jnp.float32)
        v = jnp.zeros(nS, jnp.float32)
        pi_a = jnp.full((nS, 5), 0.2, jnp.float32)
        pi_b = jnp.full((nS, 5), 0.2, jnp.float32)
    else:
        if len(init) == 5:
            *init, n = init
            n = jnp.asarray(n, jnp.float32)
        q, v, pi_a, pi_b = (jnp.asarray(x, jnp.float32) for x in init)
        assert q.shape == (nS, 5, 5) and v.shape == (nS,)
    planes = None
    if isinstance(cfg, tuple):
        planes, fields = init_state_fields(cfg, batch)
    else:
        fields = init_state_fields(cfg, batch)
    if fields_init is not None:
        fields = tuple(jnp.asarray(f) for f in fields_init)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import sharded_learner_chunk_fn
        sharded = sharded_learner_chunk_fn(cfg, mesh, batch, chunk_len,
                                           gamma=gamma, **launch)
        sh = NamedSharding(mesh, PartitionSpec("env", None))
        fields = tuple(jax.device_put(f, sh) for f in fields)
        if planes is not None:
            planes = tuple(jax.device_put(p, sh) for p in planes)

            def chunk(seed_k, m, fields):
                return sharded(seed_k, m, fields, planes)
        else:
            def chunk(seed_k, m, fields):
                return sharded(seed_k, m, fields)
    elif isinstance(cfg, tuple):
        def chunk(seed_k, m, fields):
            return multigrid_learner_chunk(cfg, seed_k, m, planes, fields,
                                           batch, chunk_len, gamma=gamma,
                                           **launch)
    else:
        def chunk(seed_k, m, fields):
            return learner_chunk(cfg, seed_k, m, fields, batch, chunk_len,
                                 gamma=gamma, **launch)

    if mesh is not None:
        # State-sharded re-solve: the solve's natural axis is the STATE,
        # not the env batch — each device solves nS/N games (bit-identical
        # results; see parallel/mesh.sharded_solve_fn).
        from ..parallel.mesh import sharded_solve_fn
        solve = sharded_solve_fn(mesh, solver_iters)
    else:
        def solve(q):
            return solve_matrix_games(q, iters=solver_iters)

    @jax.jit
    def between(q, n, v_chunk, acc, lr_now, eps_now):
        """Everything between chunks in ONE jitted dispatch:
        count-normalized Q update, RM+ re-solve, and repacking M with
        traced lr/eps.  ``v_chunk`` is the v that was packed into the
        chunk's M (the chunk accumulates residuals against it)."""
        sum_res, cnt = unpack_acc(cfg, acc)
        # per-visit td = residual + (v - q); both frozen in-chunk
        sum_td = sum_res + cnt * (v_chunk[:, None, None] - q)
        n = n + cnt
        lr_cell = lr_now
        if count_lr_tau > 0:
            lr_cell = lr_now * (1.0 + n / count_lr_tau) ** (-count_lr_pow)
        q = q + lr_cell * sum_td / jnp.maximum(cnt, 1.0)
        v, pa, pb = solve(q)
        return q, n, v, pa, pb, pack_m(cfg, pa, pb, v, eps_now)

    def decay(base, hl, k, floor=0.0):
        d = base * (0.5 ** (k * chunk_len / hl) if hl else 1.0)
        return jnp.maximum(d, floor) if isinstance(k, jax.Array) \
            else max(d, floor)

    def lr_at(k):
        d = decay(lr, lr_halflife, k)
        if lr_anneal_tau > 0:
            over = jnp.maximum(k - lr_anneal_start, 0.0) \
                if isinstance(k, jax.Array) else max(k - lr_anneal_start, 0)
            d = d * (1.0 + over / lr_anneal_tau) ** (-lr_anneal_pow)
        return d

    # On resume, chunk ``start_chunk`` must see the M the continuous run's
    # `between` packed after chunk start_chunk-1 — i.e. with THAT chunk's
    # decayed epsilon.  The resume dict below captures the raw loop state
    # BEFORE the avg_after/final_solver_iters post-processing, so those
    # options do not affect resume exactness.
    # (f32 scalar to match `between`'s jnp.float32 eps_now bit-for-bit;
    # the exact-resume contract is for the default per-chunk dispatch
    # mode — single_dispatch recomputes schedules in-graph in f32, which
    # can differ from the host f64 schedule by an ulp.)
    eps0 = eps if start_chunk == 0 else jnp.float32(
        decay(eps, eps_halflife, start_chunk - 1, eps_min))
    m0 = jax.jit(pack_m, static_argnums=(0,))(cfg, pi_a, pi_b, v, eps0)
    end_chunk = start_chunk + n_chunks

    zsum = jnp.zeros((nS, N_ACTIONS), jnp.float32)
    zq = jnp.zeros((nS, N_ACTIONS, N_ACTIONS), jnp.float32)

    def chunk_body(carry, k):
        # Shared by the single_dispatch and chunks_per_dispatch scans.
        # pa_sum/pb_sum (+ q_sum under avg_q) carry the avg_after
        # time-averages (zeros, and statically elided, when avg_after
        # == 0).
        fields, q, n, v, pa, pb, m, pa_sum, pb_sum, q_sum = carry
        fields, acc, stats = chunk(seed * 1_000_003 + k, m, fields)
        kf = k.astype(jnp.float32)
        q, n, v, pa, pb, m = between(
            q, n, v, acc, lr_at(kf),
            decay(eps, eps_halflife, kf, eps_min))
        if avg_after:
            w = (k >= avg_after).astype(jnp.float32)
            pa_sum = pa_sum + w * pa
            pb_sum = pb_sum + w * pb
            if avg_q:
                q_sum = q_sum + w * q
        return (fields, q, n, v, pa, pb, m, pa_sum, pb_sum,
                q_sum), jnp.stack([s.astype(jnp.int32) for s in stats])

    pa_sum = pb_sum = q_sum = None
    if single_dispatch:
        @jax.jit
        def whole_run(fields, q, n, v, pi_a, pi_b, m):
            carry, stats = jax.lax.scan(
                chunk_body,
                (fields, q, n, v, pi_a, pi_b, m, zsum, zsum, zq),
                jnp.arange(start_chunk, end_chunk))
            return carry + (stats,)

        (fields, q, n, v, pi_a, pi_b, _, pa_sum, pb_sum, q_sum,
         stats) = whole_run(fields, q, n, v, pi_a, pi_b, m0)
        history = [tuple(int(x) for x in row) for row in np.asarray(stats)]
    elif chunks_per_dispatch > 1:
        g = chunks_per_dispatch

        @jax.jit
        def seg_run(carry, ks):
            # ONE compile serves every segment: the scan length is the
            # static g, the chunk indices are traced data.
            carry, stats = jax.lax.scan(chunk_body, carry, ks)
            return carry, stats

        rem_body = jax.jit(chunk_body)
        carry = (fields, q, n, v, pi_a, pi_b, m0, zsum, zsum, zq)
        stats_rows = []
        full_end = start_chunk + ((end_chunk - start_chunk) // g) * g
        for s0 in range(start_chunk, full_end, g):
            carry, stats = seg_run(carry, jnp.arange(s0, s0 + g))
            stats_rows.append(stats)  # device arrays; fetched at the end
        for k in range(full_end, end_chunk):  # remainder, per chunk
            carry, stats = rem_body(carry, jnp.int32(k))
            stats_rows.append(stats[None])
        fields, q, n, v, pi_a, pi_b, _, pa_sum, pb_sum, q_sum = carry
        history = [tuple(int(x) for x in row)
                   for s in stats_rows for row in np.asarray(s)]
    else:
        m = m0
        history = []

        @jax.jit
        def accum(s, x):
            return x if s is None else s + x

        for k in range(start_chunk, end_chunk):
            fields, acc, stats = chunk(seed * 1_000_003 + k, m, fields)
            q, n, v, pi_a, pi_b, m = between(
                q, n, v, acc, jnp.float32(lr_at(k)),
                jnp.float32(decay(eps, eps_halflife, k, eps_min)))
            if avg_after and k >= avg_after:
                pa_sum = pi_a if pa_sum is None else accum(pa_sum, pi_a)
                pb_sum = pi_b if pb_sum is None else accum(pb_sum, pi_b)
                if avg_q:
                    q_sum = q if q_sum is None else accum(q_sum, q)
            if k % 16 == 0 or k == end_chunk - 1:
                # keep device scalars -- a host int() here would drain
                # the async dispatch pipeline every 16 chunks
                history.append(stats)
        history = [tuple(int(np.asarray(x)) for x in row) for row in history]
    raw_pis = (pi_a, pi_b)
    # Resume state captures `between`'s raw loop outputs BEFORE the
    # avg_after / final_solver_iters post-processing below can replace
    # pi/v — a continuation must see exactly what the next chunk of an
    # uninterrupted run would have seen.
    resume = {"q": q, "v": v, "pi_a": raw_pis[0], "pi_b": raw_pis[1],
              "n": n, "fields": fields, "next_chunk": end_chunk}
    averaged = avg_after and end_chunk - 1 >= avg_after
    if averaged and avg_q:
        W = end_chunk - max(avg_after, start_chunk)
        v, pi_a, pi_b = jax.jit(
            lambda qs: solve_matrix_games(
                qs / W, iters=final_solver_iters or solver_iters))(q_sum)
    elif averaged:
        norm = jax.jit(lambda s: s / s.sum(-1, keepdims=True))
        pi_a, pi_b = norm(pa_sum), norm(pb_sum)
    if final_solver_iters and not averaged:
        v, pi_a, pi_b = jax.jit(
            lambda q: solve_matrix_games(q, iters=final_solver_iters))(q)
    if return_state:
        return q, v, pi_a, pi_b, history, resume
    return q, v, pi_a, pi_b, history


def fused_best_response_train(cfg: EnvConfig, opp_policy, side: str,
                              batch: int, n_chunks: int,
                              chunk_len: int = 64, lr: float = 1.0,
                              gamma: float = 0.99, eps: float = 0.3,
                              eps_halflife: int = 0, eps_min: float = 0.05,
                              lr_anneal_start: int = 0,
                              lr_anneal_tau: float = 0.0,
                              lr_anneal_pow: float = 1.0,
                              seed: int = 0, backend: str = "triton",
                              mesh=None, init: tuple | None = None,
                              start_chunk: int = 0,
                              fields_init: tuple | None = None,
                              return_state: bool = False,
                              chunks_per_dispatch: int = 1):
    """Fused SINGLE-AGENT training: best response against a FROZEN
    opponent at full kernel speed — the training shape of the reference's
    single-agent mode, where the opponent's policy is substituted at
    table-build time (soccer_simultaneous_env.py:187-188, reward flip for
    a B-learner :242-244) and which all its planners and its main() demo
    require (:507-520).

    Runs the SAME fused chunk as `fused_minimax_train`; only the packing
    and the between-chunk update differ:

    * the frozen side's pi columns hold the one-hot policy with ZERO
      exploration (pack_m's per-side eps), so the opponent plays its
      policy exactly, as in the reference;
    * the learner's pi columns hold its greedy policy, eps-mixed;
    * between chunks the game solve is replaced by the best-response
      backup: for a learning A, v[s] = max_a q[s, a, opp[s]]; for a
      learning B (which maximizes -reward_a), v[s] = min_b q[s, opp[s],
      b].  Both leave q/v in A's reward perspective, matching the
      kernel's TD accumulation.

    ``opp_policy`` is a dense int policy [nS] (utils/policies array
    form); ``side`` is the LEARNING side ('player_a' or 'player_b').
    Returns (q, v, pi_a, pi_b, history) — v is A-perspective, so the
    learner's achieved value is v for A and -v for B; the learner's
    returned policy is its greedy one-hot, the opponent's its frozen
    one-hot.  ``init``: optional (q, n) warm start.  ``mesh`` shards the
    lane batch over devices exactly as in `fused_minimax_train`.

    ``start_chunk``/``fields_init``/``return_state`` give EXACT
    checkpoint/resume like the other fused trainers: with
    ``return_state=True`` a sixth element ``resume`` is returned — a
    dict of (q, n, fields, next_chunk) — and a follow-up call with
    ``init=(resume['q'], resume['n'])``,
    ``fields_init=resume['fields']``,
    ``start_chunk=resume['next_chunk']`` continues BIT-IDENTICALLY to an
    uninterrupted run (chunk seeds and schedules key off the absolute
    chunk index; the greedy pi/v and the packed M are pure functions of
    q, so only (q, n, fields) need saving).  ``stats_history``
    cadence differs by dispatch mode: the per-chunk loop records every
    16th chunk (plus the last); grouped dispatches record every
    chunk."""
    from ..core import tables
    assert side in ("player_a", "player_b")
    nS = tables.build_statespace(cfg).nS
    opp = jnp.asarray(opp_policy, jnp.int32)
    assert opp.shape == (nS,), f"opp_policy must be dense [{nS}]"
    opp_oh = jax.nn.one_hot(opp, N_ACTIONS, dtype=jnp.float32)
    learn_a = side == "player_a"
    launch = dict(backend=backend)

    q = jnp.zeros((nS, 5, 5), jnp.float32)
    n = jnp.zeros((nS, 5, 5), jnp.float32)
    if init is not None:
        q = jnp.asarray(init[0], jnp.float32)
        if len(init) > 1:
            n = jnp.asarray(init[1], jnp.float32)
    fields = init_state_fields(cfg, batch)
    if fields_init is not None:
        fields = tuple(jnp.asarray(f) for f in fields_init)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import sharded_learner_chunk_fn
        sharded = sharded_learner_chunk_fn(cfg, mesh, batch, chunk_len,
                                           gamma=gamma, **launch)
        sh = NamedSharding(mesh, PartitionSpec("env", None))
        fields = tuple(jax.device_put(f, sh) for f in fields)
        chunk = sharded
    else:
        def chunk(seed_k, m, fields):
            return learner_chunk(cfg, seed_k, m, fields, batch, chunk_len,
                                 gamma=gamma, **launch)

    def repack(pa, pb, v, ea, eb):
        return pack_m(cfg, pa, pb, v, ea, eps_b=eb)

    @jax.jit
    def between(q, n, v_chunk, acc, lr_now, eps_now):
        sum_res, cnt = unpack_acc(cfg, acc)
        sum_td = sum_res + cnt * (v_chunk[:, None, None] - q)
        n = n + cnt
        q = q + lr_now * sum_td / jnp.maximum(cnt, 1.0)
        if learn_a:
            q_eff = jnp.take_along_axis(
                q, opp[:, None, None], axis=2)[..., 0]      # [nS, 5] on a
            v = q_eff.max(-1)
            pi_l = jax.nn.one_hot(q_eff.argmax(-1), N_ACTIONS,
                                   dtype=jnp.float32)
            pa, pb = pi_l, opp_oh
            m = repack(pa, pb, v, eps_now, 0.0)
        else:
            q_eff = jnp.take_along_axis(
                q, opp[:, None, None], axis=1)[:, 0, :]     # [nS, 5] on b
            v = q_eff.min(-1)
            pi_l = jax.nn.one_hot(q_eff.argmin(-1), N_ACTIONS,
                                   dtype=jnp.float32)
            pa, pb = opp_oh, pi_l
            m = repack(pa, pb, v, 0.0, eps_now)
        return q, n, v, pa, pb, m

    def eps_at(k):
        d = eps * (0.5 ** (k * chunk_len / eps_halflife)
                   if eps_halflife else 1.0)
        return jnp.maximum(d, eps_min) if isinstance(k, jax.Array) \
            else max(d, eps_min)

    def lr_at(k):
        d = lr
        if lr_anneal_tau > 0:
            over = jnp.maximum(k - lr_anneal_start, 0.0) \
                if isinstance(k, jax.Array) else max(k - lr_anneal_start, 0)
            d = d * (1.0 + over / lr_anneal_tau) ** (-lr_anneal_pow)
        return d

    end_chunk = start_chunk + n_chunks
    if start_chunk == 0:
        uni = jnp.full((nS, 5), 0.2, jnp.float32)
        pa0, pb0 = (uni, opp_oh) if learn_a else (opp_oh, uni)
        ea0, eb0 = (eps, 0.0) if learn_a else (0.0, eps)
        v = jnp.zeros(nS, jnp.float32)
        m = jax.jit(repack)(pa0, pb0, v, ea0, eb0)
        pi_a, pi_b = pa0, pb0
    else:
        # Reconstruct exactly what the continuous run's `between` packed
        # after chunk start_chunk-1: greedy pi/v are pure functions of
        # the restored q, and that chunk saw eps_at(start_chunk-1) —
        # re-running `between` with a zero accumulator and lr 0 performs
        # precisely that recomputation (bit-identical jitted ops).
        zacc = jnp.zeros(n_codes(cfg) * NJ * ACC_WORDS, jnp.int32)
        q, n, v, pi_a, pi_b, m = between(
            q, n, jnp.zeros(nS, jnp.float32), zacc, jnp.float32(0.0),
            jnp.float32(eps_at(start_chunk - 1)))
    history = []
    if chunks_per_dispatch > 1:
        # Grouped dispatches (see fused_minimax_train): one jitted scan
        # of g (chunk + between) bodies per dispatch; schedules computed
        # in-graph in f32 (host-f64 per-chunk schedules can differ by an
        # ulp, so the exact-resume contract stays on the default mode).
        g = chunks_per_dispatch

        def chunk_body(carry, k):
            fields, q, n, v, pa, pb, m = carry
            fields, acc, stats = chunk(seed * 1_000_003 + k, m, fields)
            kf = k.astype(jnp.float32)
            q, n, v, pa, pb, m = between(q, n, v, acc, lr_at(kf),
                                         eps_at(kf))
            return (fields, q, n, v, pa, pb, m), jnp.stack(
                [s.astype(jnp.int32) for s in stats])

        @jax.jit
        def seg_run(carry, ks):
            return jax.lax.scan(chunk_body, carry, ks)

        rem_body = jax.jit(chunk_body)
        carry = (fields, q, n, v, pi_a, pi_b, m)
        stats_rows = []
        full_end = start_chunk + ((end_chunk - start_chunk) // g) * g
        for s0 in range(start_chunk, full_end, g):
            carry, stats = seg_run(carry, jnp.arange(s0, s0 + g))
            stats_rows.append(stats)
        for k in range(full_end, end_chunk):
            carry, stats = rem_body(carry, jnp.int32(k))
            stats_rows.append(stats[None])
        fields, q, n, v, pi_a, pi_b, m = carry
        history = [tuple(int(x) for x in row)
                   for s in stats_rows for row in np.asarray(s)]
    else:
        for k in range(start_chunk, end_chunk):
            fields, acc, stats = chunk(seed * 1_000_003 + k, m, fields)
            q, n, v, pi_a, pi_b, m = between(
                q, n, v, acc, jnp.float32(lr_at(k)), jnp.float32(eps_at(k)))
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats)
        history = [tuple(int(np.asarray(x)) for x in row)
                   for row in history]
    if return_state:
        return q, v, pi_a, pi_b, history, {
            "q": q, "n": n, "fields": fields, "next_chunk": end_chunk}
    return q, v, pi_a, pi_b, history
