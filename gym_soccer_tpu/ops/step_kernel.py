"""Fused lane-loop rollouts of the soccer game.

One env lane per GPU thread runs all T steps with its state in registers
(ops/lane_loop.py launches the same per-lane body as a Pallas-Triton
kernel or as its plain XLA twin):

* a counter-based PRNG (murmur3 finalizer over (seed, step, word, lane)
  counters) -- one 32-bit word per decision pair, 16-bit fixed-point
  thresholds (bias <= 2^-16, statistically negligible; the bit-exact
  reference-parity path is core/parity.py);
* transitions computed purely arithmetically (the same branchless
  collision chain as core/rules.py:resolve_outcomes, specialized inline --
  see the cross-distribution test in tests/test_pallas_kernel.py);
* random-vs-random behavior policy and per-lane episode statistics,
  so nothing leaves the lane until the end of the call.

The learner kernels (ops/learner_kernel, iql_kernel, altq_kernel) reuse
`transition_core`/`autoreset_core` with a learned policy in place of the
random one.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EnvConfig
from . import lane_loop as ll

LANES = 128


class GeoPlanes:
    """Per-lane geometry as int32 planes -- duck-types EnvConfig inside the
    kernel helpers (which are all elementwise, so static ints and planes
    are interchangeable).  This is what makes the MULTIGRID kernel one
    compilation for any mixture of board geometries (BASELINE config 4):
    geometry is data, not code."""

    def __init__(self, H, W, glo, ghi, q_int, max_steps: int):
        self.H, self.W = H, W
        self.glo, self.ghi = glo, ghi        # inclusive goal-row range
        self.q_int = q_int                    # round(slip * 65536)
        self.max_steps = max_steps            # static (shared across lanes)

    @property
    def goal_row_bounds(self):
        """Duck-types EnvConfig.goal_row_bounds so the closed-form cell
        codes (core/rules.cell_encode/cellpair_encode) work per-lane --
        what lets the fused MULTIGRID learner index its tables."""
        return self.glo, self.ghi


def _in_goal_rows(x, cfg):
    if isinstance(cfg, GeoPlanes):
        return (x >= cfg.glo) & (x <= cfg.ghi)
    m = x == cfg.goal_rows[0]
    for r in cfg.goal_rows[1:]:
        m = m | (x == r)
    return m


def _next_cell(x, y, mc, mr, ball, cfg: EnvConfig):
    nx = jnp.clip(x + mr, 0, cfg.H - 1)
    nyt = y + mc
    xoob = (nyt == 0) | (nyt == cfg.W - 1)
    goal = xoob & _in_goal_rows(nx, cfg) & ball
    ny = jnp.where(xoob & ~goal, y, nyt)
    return nx, ny


def _fmix32(x):
    """murmur3 finalizer: full-avalanche 32-bit mix (uint32 in/out)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _random_word(seed, step, widx, lane_ctr):
    """One uint32 of pseudo-randomness per lane from a unique counter
    (seed, step, word-index, lane)."""
    c = (seed * jnp.uint32(0x9E3779B9)
         + step.astype(jnp.uint32) * jnp.uint32(0x85EBCA77)
         + jnp.uint32(widx) * jnp.uint32(0xC2B2AE3D))
    return _fmix32(_fmix32(lane_ctr ^ c) + c)


def _action_move(a):
    """(dcol, drow) of an action, arithmetically (no table gather)."""
    mc = (a == 3).astype(jnp.int32) - (a == 4).astype(jnp.int32)
    mr = (a == 2).astype(jnp.int32) - (a == 1).astype(jnp.int32)
    return mc, mr


def _slipped_move(a, u16, q_int: int):
    """Apply the orthogonal-slip rule: keep the intended move with
    p = 1-q, else one of the two orthogonals (q/2 each).  ``u16`` uniform
    in [0, 65536); ``q_int`` = round(q * 65536)."""
    mc, mr = _action_move(a)
    t_keep = 65536 - q_int
    t_half = 65536 - q_int // 2
    keep = u16 < t_keep
    first = u16 < t_half
    # orthogonals of (mc, mr): (-mr, mc) then (mr, -mc)
    omc = jnp.where(first, -mr, mr)
    omr = jnp.where(first, mc, -mc)
    return jnp.where(keep, mc, omc), jnp.where(keep, mr, omr)


def isd_spread_fields(cfg: EnvConfig, batch: int, shape):
    """Lane-tiled initial state fields spread uniformly over the ISD.
    (Starting every lane in the same ISD entry measurably biases aggregate
    rewards: possession near your own goal is an own-goal risk under random
    play — a ~5-sigma effect over 8192 first episodes.)  Built from an
    iota on the device, so no batch-sized constant enters a program."""
    import numpy as np
    from ..core import rules, tables
    _, raws = tables.build_isd(cfg)
    fs = jnp.asarray(np.stack([np.array(rules.raw_decode(np, int(r), cfg),
                                        np.int32) for r in raws]))  # [nI, 5]
    lane_isd = (jnp.arange(batch, dtype=jnp.int32) % len(raws)).reshape(shape)
    return tuple(fs[lane_isd, f] for f in range(5))


def _isd_lookup(idx, cfg: EnvConfig):
    """Initial state fields by ISD index, arithmetically (nI is 2 or 4)."""
    from ..core import tables
    import numpy as np
    from ..core import rules as _rules
    _, raws = tables.build_isd(cfg)
    fields = [tuple(int(v) for v in _rules.raw_decode(np, int(r), cfg))
              for r in raws]
    outs = []
    for f in range(5):
        v = jnp.full_like(idx, fields[0][f])
        for i in range(1, len(fields)):
            v = jnp.where(idx == i, fields[i][f], v)
        outs.append(v)
    return outs


def _u16(w, hi):
    return ((w >> (16 if hi else 0)) & 0xFFFF).astype(jnp.int32)


def transition_core(ra, ca, rb, cb, p, aa, ab, bits1, bits2,
                    cfg: EnvConfig, q_int: int):
    """Pure game transition given CHOSEN actions: slips, collision chain,
    goal detection.  Returns (nra, nca, nrb, ncb, npz, goal, r) WITHOUT
    autoreset/bookkeeping — shared by the random-rollout and learner
    kernels."""
    u = _u16
    mca, mra = _slipped_move(aa, u(bits1, 0), q_int)
    mcb, mrb = _slipped_move(ab, u(bits1, 1), q_int)

    has_a, has_b = p == 0, p == 1
    nxa, nya = _next_cell(ra, ca, mca, mra, has_a, cfg)
    nxb, nyb = _next_cell(rb, cb, mcb, mrb, has_b, cfg)

    # collision chain (reference priority order; see core/rules.py)
    c1 = ((ra == rb) & (jnp.abs(ca - cb) == 1) & (nya == cb) & (nyb == ca)) | \
         ((ca == cb) & (jnp.abs(ra - rb) == 1) & (nxa == rb) & (nxb == ra))
    c2 = ~c1 & (((nxa == rb) & (nya == cb) & (ab == 0)) |
                ((nxb == ra) & (nyb == ca) & (aa == 0)))
    c3 = ~c1 & ~c2 & (
        ((ra == nxa) & (ca == nya) & (aa != 0) & (nxb == ra) & (nyb == ca)) |
        ((rb == nxb) & (cb == nyb) & (ab != 0) & (nxa == rb) & (nya == cb)))
    c4 = ~c1 & ~c2 & ~c3 & (nxa == nxb) & (nya == nyb)
    c5 = ~c1 & ~c2 & ~c3 & ~c4

    coin_poss = (u(bits2, 0) & 1).astype(jnp.int32)   # 50/50 possession
    coin_who = ((u(bits2, 0) >> 1) & 1) == 1          # c4: who advances

    a_moves = c5 | (c4 & coin_who)
    b_moves = c5 | (c4 & ~coin_who)
    nra = jnp.where(a_moves, nxa, ra)
    nca = jnp.where(a_moves, nya, ca)
    nrb = jnp.where(b_moves, nxb, rb)
    ncb = jnp.where(b_moves, nyb, cb)
    npz = jnp.where(c2, 1 - p, jnp.where(c1 | c3 | c4, coin_poss, p))

    ball_col = jnp.where(npz == 0, nca, ncb)
    # logical (not select) combination of the two goal-row tests
    a_ball = npz == 0
    gr = (a_ball & _in_goal_rows(nra, cfg)) | (~a_ball & _in_goal_rows(nrb, cfg))
    goal = gr & ((ball_col == 0) | (ball_col == cfg.W - 1))
    r = jnp.where(goal,
                  jnp.where(ball_col == cfg.W - 1, 1, -1), 0).astype(jnp.int32)
    return nra, nca, nrb, ncb, npz, goal, r


def _isd_fields_arith(idx, H, W, xp=jnp):
    """Initial state fields from the geometry, arithmetically (the kernel
    twin of core/multigrid._isd_fields — reference _generate_isd,
    soccer_simultaneous_env.py:146-165).  ``idx`` uniform in [0, 4) for
    even-H boards, [0, 2) for odd-H.  (For odd H the two middle-row
    formulas coincide: H//2 == (H-1)//2.)"""
    even = (H % 2) == 0
    mid_hi = H // 2
    mid_lo = (H - 1) // 2
    swap = (idx // 2) == 1
    ira = xp.where(even & swap, mid_hi, mid_lo)
    irb = xp.where(even & swap, mid_lo, mid_hi)
    ip = idx % 2
    ica = xp.full_like(ira, 2)
    icb = W - 3
    return ira, ica, irb, icb, ip


def autoreset_core(nra, nca, nrb, ncb, npz, t, goal, bits2,
                   cfg):
    """Truncation + uniform-ISD autoreset; returns updated fields, t,
    trunc flag.  ``cfg`` is a static EnvConfig or per-lane GeoPlanes."""
    t = t + 1
    trunc = (t >= cfg.max_steps) & ~goal
    term = goal | trunc
    if isinstance(cfg, GeoPlanes):
        n_entries = jnp.where((cfg.H % 2) == 0, 4, 2)
        isd_idx = _u16(bits2, 1) % n_entries    # exact: 65536 % {2,4} == 0
        ira, ica, irb, icb, ip = _isd_fields_arith(isd_idx, cfg.H, cfg.W)
    else:
        nI = 4 if len(cfg.goal_rows) % 2 == 0 else 2
        isd_idx = _u16(bits2, 1) % nI
        ira, ica, irb, icb, ip = _isd_lookup(isd_idx, cfg)
    nra = jnp.where(term, ira, nra)
    nca = jnp.where(term, ica, nca)
    nrb = jnp.where(term, irb, nrb)
    ncb = jnp.where(term, icb, ncb)
    npz = jnp.where(term, ip, npz)
    t = jnp.where(term, 0, t)
    return nra, nca, nrb, ncb, npz, t, trunc


def _step_once(carry, bits0, bits1, bits2, cfg: EnvConfig, q_int: int):
    ra, ca, rb, cb, p, t, rew, goals, truncs = carry
    aa = _u16(bits0, 0) % 5
    ab = _u16(bits0, 1) % 5
    nra, nca, nrb, ncb, npz, goal, r = transition_core(
        ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg, q_int)
    nra, nca, nrb, ncb, npz, t, trunc = autoreset_core(
        nra, nca, nrb, ncb, npz, t, goal, bits2, cfg)
    return (nra, nca, nrb, ncb, npz, t,
            rew + r, goals + goal.astype(jnp.int32),
            truncs + trunc.astype(jnp.int32))


def _journal_word(nra, nca, nrb, ncb, npz, aa, ab, goal, trunc, r, bits2,
                  cfg: EnvConfig):
    """Pack one journal word (layout above `pallas_journal_rollout`)."""
    from ..core import rules
    nI = 4 if len(cfg.goal_rows) % 2 == 0 else 2
    raw = rules.raw_encode(jnp, nra, nca, nrb, ncb, npz, cfg)
    isd_idx = _u16(bits2, 1) % nI     # the draw autoreset_core used
    return (raw
            | ((aa * 5 + ab) << 16)
            | (goal.astype(jnp.int32) << 21)
            | (trunc.astype(jnp.int32) << 22)
            | ((r == 1).astype(jnp.int32) << 23)
            | (isd_idx << 24))


def _journal_step(ctx, i, carry, bits0, bits1, bits2, cfg: EnvConfig,
                  q_int: int):
    """`_step_once` that also records the step's journal word."""
    ra, ca, rb, cb, p, t, rew, goals, truncs = carry
    aa = _u16(bits0, 0) % 5
    ab = _u16(bits0, 1) % 5
    nxt = transition_core(ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg,
                          q_int)
    goal, r = nxt[5], nxt[6]
    fra, fca, frb, fcb, fpz, t, trunc = autoreset_core(
        *nxt[:5], t, goal, bits2, cfg)
    ctx.record(i, _journal_word(*nxt[:5], aa, ab, goal, trunc, r, bits2,
                                cfg))
    return (fra, fca, frb, fcb, fpz, t,
            rew + r, goals + goal.astype(jnp.int32),
            truncs + trunc.astype(jnp.int32))


def _rollout_body(kind: str, cfg, n_steps: int, max_steps: int = 0):
    """Per-lane rollout body for ops/lane_loop.  ``kind``: 'sim'
    (simultaneous moves), 'alt' (alternating turns), 'mg' (per-lane
    geometry planes follow the 6 state fields) or 'journal' ('sim' plus
    one packed word per lane-step).  Outputs: the state fields, then
    per-lane (reward_sum, goals, truncs)."""
    n_fields = 7 if kind == "alt" else 6
    step_once = _alt_step_once if kind == "alt" else _step_once

    def body(ctx, lanes):
        seed = ctx.scalar(0).astype(jnp.uint32)
        off = ctx.scalar(1)      # absolute step offset (chained dispatch)
        fields = tuple(lanes[:n_fields])
        if kind == "mg":
            geo = GeoPlanes(*lanes[n_fields:n_fields + 5],
                            max_steps=max_steps)
            q_int = geo.q_int
        else:
            geo, q_int = cfg, int(round(cfg.slip_prob * 65536))

        def step(i, carry):
            bits = [_random_word(seed, i + off, w, ctx.lane)
                    for w in range(3)]
            if kind == "journal":
                return _journal_step(ctx, i, carry, *bits, geo, q_int)
            return step_once(carry, *bits, geo, q_int)

        zeros = jnp.zeros_like(fields[0])
        return ctx.fori(n_steps, step, fields + (zeros,) * 3)

    return body


def _lanes(init, batch):
    assert batch % LANES == 0, f"batch must be a multiple of {LANES}"
    return [jnp.asarray(f, jnp.int32).reshape(batch) for f in init]


def _planes(outs, batch):
    return tuple(o.reshape(batch // LANES, LANES) for o in outs)


@ll.static_args("cfg", "n_steps", "batch")
def pallas_rollout(cfg: EnvConfig, seed: jax.Array, batch: int,
                   n_steps: int, backend: str = "triton",
                   block: int = ll.BLOCK,
                   interpret: bool = False, init_fields=None, step_offset=0):
    """Run `n_steps` of random-vs-random self-play for `batch` envs in one
    fused call.  Returns (final_state_fields, (reward_sum, goals,
    truncs)); fields are [batch/128, 128] int32 planes (ra, ca, rb, cb,
    p, t).

    ``backend`` picks the launcher (ops/lane_loop: 'triton' kernel or its
    'xla' twin; both are bit-identical).  ``block`` lanes per Triton
    program; results are bit-invariant to it because the counter PRNG is
    keyed on the GLOBAL lane id.  ``init_fields``/``step_offset`` resume
    from a prior call's final fields at absolute step ``step_offset`` --
    chaining calls reproduces one long call's bit stream exactly (the PRNG
    counter is the absolute step index); see `pallas_rollout_chained`.
    """
    shape = (batch // LANES, LANES)
    if init_fields is None:
        init = list(isd_spread_fields(cfg, batch, shape))
        init.append(jnp.zeros(shape, jnp.int32))          # t
    else:
        init = list(init_fields)
        assert len(init) == 6, "init_fields = 6 arrays (ra,ca,rb,cb,p,t)"
    outs, _, _ = ll.run(
        _rollout_body("sim", cfg, n_steps), batch=batch,
        lanes=_lanes(init, batch), scalars=(seed, step_offset), n_out=9,
        backend=backend, block=block,
        interpret=interpret, name="rollout")
    stats = tuple(jnp.sum(o) for o in outs[6:])
    return _planes(outs[:6], batch), stats


def pallas_rollout_chained(cfg: EnvConfig, seed, batch: int, n_steps: int,
                           steps_per_call: int = 12288, **launch):
    """`pallas_rollout` split into chained shorter calls (state and stats
    carried between calls) -- bit-identical to one long call.  ``launch``
    passes backend/block/interpret through."""
    fields = None
    stats = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    done = 0
    while done < n_steps:
        t = min(steps_per_call, n_steps - done)
        fields, st = pallas_rollout(cfg, seed, batch, t, init_fields=fields,
                                    step_offset=done, **launch)
        stats = tuple(a + b for a, b in zip(stats, st))
        done += t
    return fields, stats


# ----------------------------------------------------------------------
# Alternating-turn fused rollout (envs/soccer_alternating_env semantics)
# ----------------------------------------------------------------------

def alt_transition_core(ra, ca, rb, cb, p, turn, a, bits1, cfg: EnvConfig,
                        q_int: int):
    """Alternating-turn transition, arithmetically (the fused twin of
    envs/soccer_alternating_env.alt_transition): the mover's slipped move,
    steal-on-contact (possession to the invaded opponent), goal check.
    Returns (nra, nca, nrb, ncb, npz, goal, r); the caller flips turn."""
    u = _u16
    mc, mr = _slipped_move(a, u(bits1, 0), q_int)
    a_moves = turn == 0
    mx = jnp.where(a_moves, ra, rb)
    my = jnp.where(a_moves, ca, cb)
    ox = jnp.where(a_moves, rb, ra)
    oy = jnp.where(a_moves, cb, ca)
    ball = p == turn
    nx, ny = _next_cell(mx, my, mc, mr, ball, cfg)
    collide = (nx == ox) & (ny == oy)
    nx = jnp.where(collide, mx, nx)
    ny = jnp.where(collide, my, ny)
    npz = jnp.where(collide, 1 - turn, p)
    nra = jnp.where(a_moves, nx, ra)
    nca = jnp.where(a_moves, ny, ca)
    nrb = jnp.where(a_moves, rb, nx)
    ncb = jnp.where(a_moves, cb, ny)
    a_ball = npz == 0
    ball_col = jnp.where(a_ball, nca, ncb)
    gr = (a_ball & _in_goal_rows(nra, cfg)) | \
         (~a_ball & _in_goal_rows(nrb, cfg))
    goal = gr & ((ball_col == 0) | (ball_col == cfg.W - 1))
    r = jnp.where(goal, jnp.where(ball_col == cfg.W - 1, 1, -1),
                  0).astype(jnp.int32)
    return nra, nca, nrb, ncb, npz, goal, r


def _alt_step_once(carry, bits0, bits1, bits2, cfg: EnvConfig, q_int: int):
    ra, ca, rb, cb, p, turn, t, rew, goals, truncs = carry
    a = _u16(bits0, 0) % 5
    nra, nca, nrb, ncb, npz, goal, r = alt_transition_core(
        ra, ca, rb, cb, p, turn, a, bits1, cfg, q_int)
    nra, nca, nrb, ncb, npz, t, trunc = autoreset_core(
        nra, nca, nrb, ncb, npz, t, goal, bits2, cfg)
    term = goal | trunc
    nturn = jnp.where(term, 0, 1 - turn)
    return (nra, nca, nrb, ncb, npz, nturn, t,
            rew + r, goals + goal.astype(jnp.int32),
            truncs + trunc.astype(jnp.int32))


@ll.static_args("cfg", "n_steps", "batch")
def pallas_alt_rollout(cfg: EnvConfig, seed: jax.Array, batch: int,
                       n_steps: int, backend: str = "triton",
                       block: int = ll.BLOCK,
                       interpret: bool = False, init_fields=None,
                       step_offset=0):
    """Fused random-play rollout of the ALTERNATING-turn game: `n_steps`
    single-mover ticks for `batch` envs (same launcher/counter-PRNG/
    chaining scheme as `pallas_rollout`).  Returns (final fields (ra, ca,
    rb, cb, p, turn, t), (reward_sum, goals, truncs))."""
    shape = (batch // LANES, LANES)
    if init_fields is None:
        init = list(isd_spread_fields(cfg, batch, shape))
        init.append(jnp.zeros(shape, jnp.int32))          # turn
        init.append(jnp.zeros(shape, jnp.int32))          # t
    else:
        init = list(init_fields)
        assert len(init) == 7, \
            "init_fields = 7 arrays (ra,ca,rb,cb,p,turn,t)"
    outs, _, _ = ll.run(
        _rollout_body("alt", cfg, n_steps), batch=batch,
        lanes=_lanes(init, batch), scalars=(seed, step_offset), n_out=10,
        backend=backend, block=block,
        interpret=interpret, name="alt_rollout")
    stats = tuple(jnp.sum(o) for o in outs[7:])
    return _planes(outs[:7], batch), stats


def pallas_alt_rollout_chained(cfg: EnvConfig, seed, batch: int,
                               n_steps: int, steps_per_call: int = 12288,
                               **launch):
    """`pallas_alt_rollout` split into chained shorter calls --
    bit-identical to one long call."""
    fields = None
    stats = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    done = 0
    while done < n_steps:
        t = min(steps_per_call, n_steps - done)
        fields, st = pallas_alt_rollout(cfg, seed, batch, t,
                                        init_fields=fields, step_offset=done,
                                        **launch)
        stats = tuple(a + b for a, b in zip(stats, st))
        done += t
    return fields, stats


# ----------------------------------------------------------------------
# Multigrid fused rollout: a MIXTURE of geometries in one kernel
# (BASELINE config 4 -- the fused twin of core/multigrid)
# ----------------------------------------------------------------------

def _mg_planes(cfgs, batch: int, shape, layout: str = "roundrobin"):
    """Per-lane geometry planes + arithmetic-ISD-spread initial state,
    built from an iota on the device.  ``layout``: 'roundrobin' assigns
    lane i -> cfgs[i % nV] (matching core/multigrid.lane_geometry);
    'blocked' assigns variants in contiguous near-equal chunks, so almost
    every block of lanes is single-variant and reads only its own
    variant's table rows.  Either layout is correct; they differ only in
    which lane runs which board."""
    nV = len(cfgs)
    lanes = jnp.arange(batch, dtype=jnp.int32)
    idx = lanes * nV // batch if layout == "blocked" else lanes % nV

    def per_variant(vals):
        return jnp.asarray(vals, jnp.int32)[idx]

    H = per_variant([c.H for c in cfgs])
    W = per_variant([c.W for c in cfgs])
    glo = per_variant([c.goal_row_bounds[0] for c in cfgs])
    ghi = per_variant([c.goal_row_bounds[1] for c in cfgs])
    q = per_variant([int(round(c.slip_prob * 65536)) for c in cfgs])
    n_entries = jnp.where(H % 2 == 0, 4, 2)
    isd = (lanes // nV) % n_entries
    init = _isd_fields_arith(isd, H, W, xp=jnp)
    return ([p.reshape(shape) for p in (H, W, glo, ghi, q, idx)],
            [jnp.asarray(f, jnp.int32).reshape(shape) for f in init])


@ll.static_args("cfgs", "n_steps", "batch")
def pallas_multigrid_rollout(cfgs: tuple, seed: jax.Array, batch: int,
                             n_steps: int, backend: str = "triton",
                             block: int = ll.BLOCK,
                             interpret: bool = False, init_fields=None,
                             step_offset=0):
    """Fused random-vs-random rollout over a MIXED-geometry batch: board
    height/width, goal-row range and slip probability are per-lane int32
    PLANES (GeoPlanes), so ONE compiled kernel steps any mixture of
    Littman-soccer variants -- the fused twin of core/multigrid.step
    (BASELINE config 4).  Lanes are assigned variants round-robin (lane
    i -> cfgs[i % len(cfgs)]).

    Returns (final fields (ra, ca, rb, cb, p, t),
    per-variant stats int32 [len(cfgs), 3] = (reward_sum, goals, truncs)).
    Chaining via (init_fields, step_offset) as in `pallas_rollout`."""
    assert len({c.max_steps for c in cfgs}) == 1, \
        "variants must share max_steps (truncation plane otherwise)"
    shape = (batch // LANES, LANES)
    planes, isd_init = _mg_planes(cfgs, batch, shape)
    if init_fields is None:
        init = isd_init + [jnp.zeros(shape, jnp.int32)]       # t
    else:
        init = list(init_fields)
        assert len(init) == 6, "init_fields = 6 arrays (ra,ca,rb,cb,p,t)"
    outs, _, _ = ll.run(
        _rollout_body("mg", None, n_steps, cfgs[0].max_steps), batch=batch,
        lanes=_lanes(init + planes[:5], batch), scalars=(seed, step_offset),
        n_out=9, backend=backend, block=block,
        interpret=interpret, name="multigrid_rollout")
    vid = planes[5].reshape(batch)
    stats = jnp.stack([jnp.stack([jnp.sum(jnp.where(vid == v, o, 0))
                                  for o in outs[6:]])
                       for v in range(len(cfgs))])
    return _planes(outs[:6], batch), stats


def pallas_multigrid_rollout_chained(cfgs: tuple, seed, batch: int,
                                     n_steps: int,
                                     steps_per_call: int = 12288, **launch):
    """`pallas_multigrid_rollout` as chained shorter calls -- see
    `pallas_rollout_chained`."""
    fields = None
    stats = jnp.zeros((len(cfgs), 3), jnp.int32)
    done = 0
    while done < n_steps:
        t = min(steps_per_call, n_steps - done)
        fields, st = pallas_multigrid_rollout(
            cfgs, seed, batch, t, init_fields=fields, step_offset=done,
            **launch)
        stats = stats + st
        done += t
    return fields, stats


# ----------------------------------------------------------------------
# JOURNALED fused rollout: full per-step trajectories
# ----------------------------------------------------------------------
# The reference's step() emits the full transition every tick -- obs,
# rewards, dones, truncateds, infos (soccer_simultaneous_env.py:375-408).
# The stats-only rollout above discards that stream; the XLA journaling
# path (core/batch.rollout) keeps it as [T, B] StepOut arrays.  This
# kernel journals ONE packed int32 word per lane-step while the lane's
# state stays in registers.
#
# Word layout (little end first):
#   bits  0-15  raw state code of the PRE-autoreset next state
#               (mixed-radix, core/rules.raw_encode; needs H*W*H*W*2
#               <= 65536 -- holds for every BASELINE grid incl. 11x7's
#               16562)
#   bits 16-20  joint action aa * 5 + ab
#   bit  21     goal (done)
#   bit  22     truncation
#   bit  23     reward sign (set iff reward_a == +1; with bit 21 this
#               reconstructs the exact reward in {-1, 0, +1})
#   bits 24-25  autoreset ISD index (which initial state a terminated
#               lane teleported to) -- makes the journal self-contained:
#               the post-reset observation is recovered WITHOUT replaying
#               the RNG
# `unpack_journal` decodes the stream into the reference-shaped
# per-step arrays (obs / final_obs / actions / reward / done / trunc).


@ll.static_args("cfg", "n_steps", "batch")
def pallas_journal_rollout(cfg: EnvConfig, seed: jax.Array, batch: int,
                           n_steps: int, backend: str = "triton",
                           block: int = ll.BLOCK,
                           interpret: bool = False, init_fields=None,
                           step_offset=0):
    """Random-vs-random fused rollout that JOURNALS every transition.

    Bit-identical trajectories to `pallas_rollout` (same counter PRNG on
    global lane ids, same transition path) plus a packed int32 journal
    [n_steps, batch/128, 128] -- one word per lane-step, layout above;
    decode with `unpack_journal`.  Returns (final_fields, stats,
    journal)."""
    n_raw = cfg.H * cfg.W * cfg.H * cfg.W * 2
    assert n_raw <= 65536, \
        f"raw state code needs {n_raw} values; journal word holds 16 bits"
    shape = (batch // LANES, LANES)
    if init_fields is None:
        init = list(isd_spread_fields(cfg, batch, shape))
        init.append(jnp.zeros(shape, jnp.int32))          # t
    else:
        init = list(init_fields)
        assert len(init) == 6, "init_fields = 6 arrays (ra,ca,rb,cb,p,t)"
    outs, _, journal = ll.run(
        _rollout_body("journal", cfg, n_steps), batch=batch,
        lanes=_lanes(init, batch), scalars=(seed, step_offset), n_out=9,
        journal_steps=n_steps, backend=backend, block=block, interpret=interpret, name="journal_rollout")
    stats = tuple(jnp.sum(o) for o in outs[6:])
    return (_planes(outs[:6], batch), stats,
            journal.reshape((n_steps,) + shape))


def pallas_journal_rollout_chained(cfg: EnvConfig, seed, batch: int,
                                   n_steps: int,
                                   steps_per_call: int = 4096,
                                   consume=None, **launch):
    """`pallas_journal_rollout` as chained calls -- bit-identical to one
    long call, with the journal handed over per call instead of held
    whole.  ``consume(journal, step_offset)`` is invoked with each
    chunk's [T_call, B/128, 128] device array (e.g. to host-fetch,
    decode, or hand off); by default the chunks are collected and
    returned as a list.  Returns (final_fields, stats,
    journals_or_None)."""
    fields = None
    stats = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    chunks = [] if consume is None else None
    done = 0
    while done < n_steps:
        t = min(steps_per_call, n_steps - done)
        fields, st, journal = pallas_journal_rollout(
            cfg, seed, batch, t, init_fields=fields, step_offset=done,
            **launch)
        stats = tuple(a + b for a, b in zip(stats, st))
        if consume is None:
            chunks.append(journal)
        else:
            consume(journal, done)
        done += t
    return fields, stats, chunks


def unpack_journal(cfg: EnvConfig, journal):
    """Decode a packed journal [T, B/128, 128] (or [T, B]) into the
    reference-shaped per-step stream (soccer_simultaneous_env.py:375-408
    emits exactly these fields each tick; core/batch.StepOut is the XLA
    twin).  Returns a dict of [T, B] arrays:

    obs        int32  post-step observation (post-autoreset, like the
                      batched engine's StepOut.obs)
    final_obs  int32  pre-autoreset observation — goal states map to
                      dense index 0, the reference's terminal obs codec
    actions_a/actions_b  int32  the actions the lanes played
    reward_a   float32  +1 / -1 / 0 (player-A perspective)
    done       bool   goal this step
    truncated  bool   truncation this step
    """
    from ..core import tables
    ss = tables.build_statespace(cfg)
    T = journal.shape[0]
    w = journal.reshape(T, -1)
    raw = w & 0xFFFF
    ja = (w >> 16) & 31
    goal = ((w >> 21) & 1).astype(bool)
    trunc = ((w >> 22) & 1).astype(bool)
    rpos = (w >> 23) & 1
    isd_idx = (w >> 24) & 3
    final_obs = jnp.asarray(ss.raw_to_dense)[raw]
    isd_dense = jnp.asarray(ss.raw_to_dense[ss.isd_raw])
    term = goal | trunc
    return {
        "obs": jnp.where(term, isd_dense[isd_idx], final_obs),
        "final_obs": final_obs,
        "actions_a": ja // 5,
        "actions_b": ja % 5,
        "reward_a": jnp.where(goal, jnp.where(rpos == 1, 1.0, -1.0),
                              0.0).astype(jnp.float32),
        "done": goal,
        "truncated": trunc,
    }
