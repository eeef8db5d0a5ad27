"""Fused Q-learner chunks for the ALTERNATING-turn game.

The XLA alternating learner (agents/learners.altq_train) steps, selects
and updates as separate array programs per step.  Here whole
act -> step -> TD chunks run per lane on the lane loop
(ops/lane_loop.py), the turn-based twin of ops/learner_kernel:

* the Q table sits in one f32 M [n_codes, M_COLS] indexed by the
  TURNLESS compact cellpair code (core/rules.cellpair_encode); the turn
  selects COLUMNS -- A-to-move Q in columns 0-4, B-to-move Q in 5-9 --
  so the row space is the simultaneous learner's;
* one row read per step fetches the mover's Q, which serves BOTH action
  selection (eps-greedy argmax for A / argmin for B -- Q is
  A-perspective) and the bootstrap value V(s') = max_a Q[s'] at
  A-to-move states, min_a at B-to-move states, that the PREVIOUS step's
  TD was waiting for (pipelined TD retirement, terminated lanes masked
  by cont=0);
* with M frozen in-chunk, each lane accumulates the Bellman RESIDUAL
  r + gamma*V(s') - V(s) and a visit count per (state, turn, action)
  cell in the exact int32 fixed-point accumulator
  (learner_kernel.scatter_residual); the between-chunk update completes
  the TD with cnt * (V - q[s, a]);
* the env transition is ops/step_kernel.alt_transition_core -- the same
  branchless single-mover rules and counter PRNG as the alternating
  rollout.

Turn alternation makes the update LP-free (no matrix-game solve): the
fixpoint of the max/min backup is the exact minimax value of
`envs.soccer_alternating_env.alt_value_iteration` -- Q-learning on the
turn-based minimax Bellman operator, like agents/learners.altq_step
(reference capability signal: soccer_alternating_env.py:100-200).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, N_ACTIONS
from . import lane_loop as ll
from . import step_kernel as sk
from .learner_kernel import (LANES, M_COLS, decode_acc, n_codes, run_chunk,
                             scatter_residual)


def _altq_body(cfg: EnvConfig, n_steps: int, gamma: float):
    """Per-lane act/step/TD loop for the alternating game.  Accumulator
    cells: (code * 2 + turn) * 5 + a."""
    from ..core import rules
    q_int = int(round(cfg.slip_prob * 65536))

    def body(ctx, lanes):
        seed = ctx.scalar(0).astype(jnp.uint32)
        eps_int = ctx.scalar(1)      # exploration threshold on u16 draws
        off = ctx.scalar(2)          # absolute step offset (chained seeds)
        gamma_f = jnp.float32(gamma)

        def mover_q(code, turn):
            return [ctx.gather(0, code * M_COLS + turn * N_ACTIONS + k)
                    for k in range(N_ACTIONS)]

        def minimax_v(qs, turn):
            vmax, vmin = qs[0], qs[0]
            for k in range(1, N_ACTIONS):
                vmax = jnp.maximum(vmax, qs[k])
                vmin = jnp.minimum(vmin, qs[k])
            return jnp.where(turn == 0, vmax, vmin)

        def retire(v_here, pend):
            cell, r, cont, v_prev, valid = pend
            scatter_residual(ctx, 0, cell, r + cont * v_here - v_prev, valid)

        def step(i, c):
            ra, ca, rb, cb, p, turn, t, pend, rew, goals, truncs = c
            bits0 = sk._random_word(seed, i + off, 0, ctx.lane)
            bits1 = sk._random_word(seed, i + off, 1, ctx.lane)
            bits2 = sk._random_word(seed, i + off, 2, ctx.lane)

            code = rules.cellpair_encode(jnp, ra, ca, rb, cb, p, cfg)
            qs = mover_q(code, turn)
            v_here = minimax_v(qs, turn)
            retire(v_here, pend)

            # eps-greedy mover action: A maximizes, B minimizes (the
            # table is A-perspective), both over the SAME row.
            sgn = jnp.where(turn == 0, 1.0, -1.0)
            best = jnp.zeros_like(ra)
            bestv = sgn * qs[0]
            for k in range(1, N_ACTIONS):
                sc = sgn * qs[k]
                best = jnp.where(sc > bestv, k, best)
                bestv = jnp.maximum(bestv, sc)
            u_expl = sk._u16(bits0, 0)
            rand = sk._u16(bits0, 1) % N_ACTIONS
            a = jnp.where(u_expl < eps_int, rand, best)

            nra, nca, nrb, ncb, npz, goal, r = sk.alt_transition_core(
                ra, ca, rb, cb, p, turn, a, bits1, cfg, q_int)
            nra, nca, nrb, ncb, npz, t2, trunc = sk.autoreset_core(
                nra, nca, nrb, ncb, npz, t, goal, bits2, cfg)
            term = goal | trunc
            nturn = jnp.where(term, 0, 1 - turn)
            cont = jnp.where(term, 0.0, gamma_f)
            new_pend = ((code * 2 + turn) * N_ACTIONS + a,
                        r.astype(jnp.float32), cont, v_here,
                        jnp.ones_like(ra))
            return (nra, nca, nrb, ncb, npz, nturn, t2, new_pend,
                    rew + r, goals + goal.astype(jnp.int32),
                    truncs + trunc.astype(jnp.int32))

        zi = jnp.zeros_like(lanes[0])
        zf = jnp.zeros(zi.shape, jnp.float32)
        init = tuple(lanes[:7]) + ((zi, zf, zf, zf, zi), zi, zi, zi)
        ra, ca, rb, cb, p, turn, t, pend, rew, goals, truncs = ctx.fori(
            n_steps, step, init)
        # trailing read retires the final step's TD
        code = rules.cellpair_encode(jnp, ra, ca, rb, cb, p, cfg)
        retire(minimax_v(mover_q(code, turn), turn), pend)
        return ra, ca, rb, cb, p, turn, t, rew, goals, truncs

    return body


@ll.static_args("cfg", "batch", "n_steps", "gamma")
def altq_chunk(cfg: EnvConfig, seed, eps_int, m, state_fields, batch: int,
               n_steps: int, gamma: float = 0.99, step_offset=0,
               backend: str = "triton", block: int = ll.BLOCK, interpret: bool = False):
    """Run one fused alternating-learner chunk.  ``m`` from `pack_alt_m`;
    ``state_fields`` = 7 int32 [batch/128, 128] planes (ra, ca, rb, cb,
    p, turn, t); ``eps_int`` = exploration threshold on u16 draws
    (round(eps*65536), traced so anneals don't recompile).  Returns
    (new_fields, acc, stats[3]); decode acc with `unpack_alt_acc`."""
    return run_chunk(_altq_body(cfg, n_steps, gamma), state_fields, seed,
                     batch, n_steps, 7, m, 2 * n_codes(cfg) * N_ACTIONS,
                     scalars=(eps_int, step_offset), name="altq_chunk",
                     backend=backend, block=block,
                     interpret=interpret)


# ----------------------------------------------------------------------
# Packing and the chunked training wrapper
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _alt_rows(cfg: EnvConfig) -> tuple[np.ndarray, np.ndarray]:
    """(cellpair row, turn) of each alternating dense state.  (row, turn)
    is unique per reachable state; dense 0 (the absorbing terminal) maps
    to a goal state's cellpair, which no reachable state shares and which
    the autoresetting chunk never visits."""
    from ..core import rules
    from ..envs.soccer_alternating_env import build_alt_tables
    tb = build_alt_tables(cfg)
    f = tb.fields.astype(np.int64)
    rows = rules.cellpair_encode(np, f[:, 0], f[:, 1], f[:, 2], f[:, 3],
                                 f[:, 4], cfg).astype(np.int32)
    return rows, tb.turn.astype(np.int32)


def _alt_cells(cfg: EnvConfig):
    """(row, turn) slot of each alternating dense state in M and acc."""
    rows, turn = _alt_rows(cfg)
    return jnp.asarray(rows), jnp.asarray(turn)


def pack_alt_m(cfg: EnvConfig, q) -> jnp.ndarray:
    """Pack the alternating Q table [nS_alt, 5] into M, f32 [n_codes *
    M_COLS] (turnless row, turn-split columns)."""
    rows, turn = _alt_cells(cfg)
    cols = turn[:, None] * N_ACTIONS + jnp.arange(N_ACTIONS)[None, :]
    m = jnp.zeros((n_codes(cfg), M_COLS), jnp.float32)
    m = m.at[rows[:, None], cols].set(jnp.asarray(q, jnp.float32))
    return m.reshape(-1)


def unpack_alt_acc(cfg: EnvConfig, acc) -> tuple[jnp.ndarray, jnp.ndarray]:
    """acc -> dense (sum_residual, cnt), each [nS_alt, 5].  The per-visit
    TD is residual + (V - q[s, a]) with V = max_a q (A to move) / min_a q
    (B to move), so sum_td = sum_res + cnt * (V[:, None] - q)."""
    rows, turn = _alt_cells(cfg)
    cells = ((rows * 2 + turn)[:, None] * N_ACTIONS
             + jnp.arange(N_ACTIONS)[None, :])
    return decode_acc(acc, cells)


def init_alt_state_fields(cfg: EnvConfig, batch: int):
    """Lane-tiled ISD spread + A-to-move turn + zeroed step counter."""
    shape = (batch // LANES, LANES)
    return sk.isd_spread_fields(cfg, batch, shape) + (
        jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32))


def fused_altq_train(cfg: EnvConfig, batch: int, n_chunks: int,
                     chunk_len: int = 64, lr: float = 0.5,
                     gamma: float = 0.99, eps: float = 0.3,
                     eps_min: float = 0.0, eps_halflife: int = 0,
                     lr_anneal_start: int = 0, lr_anneal_tau: float = 0.0,
                     lr_anneal_pow: float = 1.0, seed: int = 0,
                     backend: str = "triton",
                     init=None, mesh=None, start_chunk: int = 0,
                     fields_init=None, return_state: bool = False,
                     chunks_per_dispatch: int = 1):
    """Chunked fused alternating-turn Q-learning.  Returns (q,
    stats_history); ``q`` [nS_alt, 5] has `alt_value_iteration`'s exact
    minimax values as its fixpoint (extract a policy with
    agents.learners.altq_greedy_policy).

    The error model matches fused_minimax_train's: each chunk applies one
    count-normalized empirical Bellman backup per visited cell against a
    chunk-stale bootstrap, so lr ~ 1 contracts fastest and an
    ``lr_anneal_*`` polynomial tail averages the residual sample noise.
    ``init`` optionally warm-starts q (an [nS_alt, 5] array).  ``mesh``
    (a jax.sharding.Mesh with an 'env' axis) DP-shards the lane batch:
    per-device fused chunks with psum'd accumulators
    (parallel/mesh.sharded_altq_chunk_fn).  ``backend`` picks the chunk
    launcher as in ops/learner_kernel.fused_minimax_train.

    ``start_chunk``/``fields_init``/``return_state`` give EXACT
    checkpoint/resume (see ops/learner_kernel.fused_minimax_train): with
    ``return_state=True`` a third element ``resume`` is returned — a
    dict of (q, fields, next_chunk) — and a follow-up call with
    ``init=resume['q']``, ``fields_init=resume['fields']``,
    ``start_chunk=resume['next_chunk']`` continues bit-identically to an
    uninterrupted run (chunk PRNG seeds, the in-kernel step_offset and
    the lr/eps schedules all key off the absolute chunk index; M packs
    from q alone, so no schedule state needs recovering).
    ``stats_history`` cadence differs by dispatch mode: the per-chunk
    loop records every 16th chunk (plus the last); grouped dispatches
    (``chunks_per_dispatch`` > 1) record every chunk."""
    from ..envs.soccer_alternating_env import build_alt_tables
    nS = build_alt_tables(cfg).nS
    launch = dict(backend=backend)
    q = (jnp.zeros((nS, N_ACTIONS), jnp.float32) if init is None
         else jnp.asarray(init, jnp.float32))
    assert q.shape == (nS, N_ACTIONS)
    fields = init_alt_state_fields(cfg, batch)
    if fields_init is not None:
        fields = tuple(jnp.asarray(f) for f in fields_init)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import sharded_altq_chunk_fn
        sharded = sharded_altq_chunk_fn(cfg, mesh, batch, chunk_len,
                                        gamma=gamma, **launch)
        sh = NamedSharding(mesh, PartitionSpec("env", None))
        fields = tuple(jax.device_put(f, sh) for f in fields)

        def chunk(seed_k, eps_int, m, fields, step_offset):
            return sharded(seed_k, eps_int, m, fields, step_offset)
    else:
        def chunk(seed_k, eps_int, m, fields, step_offset):
            return altq_chunk(cfg, seed_k, eps_int, m, fields, batch,
                              chunk_len, gamma=gamma,
                              step_offset=step_offset, **launch)

    _, turn_arr = _alt_rows(cfg)
    is_a = jnp.asarray(turn_arr == 0)

    @jax.jit
    def between(q, acc, lr_now):
        sum_res, cnt = unpack_alt_acc(cfg, acc)
        v = jnp.where(is_a, q.max(-1), q.min(-1))
        sum_td = sum_res + cnt * (v[:, None] - q)
        q = q + lr_now * sum_td / jnp.maximum(cnt, 1.0)
        return q, pack_alt_m(cfg, q)

    def lr_at(k):
        d = lr
        if lr_anneal_tau > 0:
            over = jnp.maximum(k - lr_anneal_start, 0.0) \
                if isinstance(k, jax.Array) else max(k - lr_anneal_start, 0)
            d = d * (1.0 + over / lr_anneal_tau) ** (-lr_anneal_pow)
        return d

    def eps_at(k):
        d = eps * (0.5 ** (k * chunk_len / eps_halflife)
                   if eps_halflife else 1.0)
        return jnp.maximum(d, eps_min) if isinstance(k, jax.Array) \
            else max(d, eps_min)

    m = pack_alt_m(cfg, q)
    history = []
    end_chunk = start_chunk + n_chunks
    if chunks_per_dispatch > 1:
        # Grouped dispatches (see fused_minimax_train): in-graph f32
        # schedules; eps quantizes to the kernel's u16 threshold in-graph.
        g = chunks_per_dispatch

        def chunk_body(carry, k):
            fields, q, m = carry
            kf = k.astype(jnp.float32)
            eps_int = jnp.round(eps_at(kf) * 65536).astype(jnp.int32)
            fields, acc, stats = chunk(seed * 1_000_003 + k, eps_int, m,
                                       fields, k * chunk_len)
            q, m = between(q, acc, lr_at(kf))
            return (fields, q, m), jnp.stack(
                [st.astype(jnp.int32) for st in stats])

        @jax.jit
        def seg_run(carry, ks):
            return jax.lax.scan(chunk_body, carry, ks)

        rem_body = jax.jit(chunk_body)
        carry = (fields, q, m)
        stats_rows = []
        full_end = start_chunk + ((end_chunk - start_chunk) // g) * g
        for s0 in range(start_chunk, full_end, g):
            carry, st = seg_run(carry, jnp.arange(s0, s0 + g))
            stats_rows.append(st)
        for k in range(full_end, end_chunk):
            carry, st = rem_body(carry, jnp.int32(k))
            stats_rows.append(st[None])
        fields, q, m = carry
        history = [tuple(int(x) for x in row)
                   for st in stats_rows for row in np.asarray(st)]
    else:
        for k in range(start_chunk, end_chunk):
            fields, acc, stats = chunk(
                seed * 1_000_003 + k, int(round(eps_at(k) * 65536)),
                m, fields, k * chunk_len)
            q, m = between(q, acc, jnp.float32(lr_at(k)))
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats)  # device scalars; fetched at the end
        history = [tuple(int(np.asarray(x)) for x in row)
                   for row in history]
    if return_state:
        return q, history, {"q": q, "fields": fields,
                            "next_chunk": end_chunk}
    return q, history
