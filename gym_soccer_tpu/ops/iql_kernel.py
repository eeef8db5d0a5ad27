"""Fused INDEPENDENT-Q (IQL) chunks for the simultaneous game.

Completes the fused learner family (minimax: ops/learner_kernel,
alternating-turn: ops/altq_kernel): both players run eps-greedy
Q-learning on their OWN table -- A on reward r, B on -r (zero-sum,
reference soccer_simultaneous_env.py:400-402) -- with whole act/step/TD
chunks per lane on the lane loop (ops/lane_loop.py):

* both tables sit in one f32 M [n_codes, M_COLS] indexed by the compact
  cellpair code: A's Q in columns 0-4, B's in 5-9.  One row read per
  step serves both eps-greedy argmax action selection and the pipelined
  TD retirement's max-bootstraps (terminated lanes masked by cont=0);
* as in the minimax chunk, M is frozen within a chunk, so each lane
  accumulates the Bellman RESIDUAL per player (r_side + gamma*maxq(s') -
  maxq(s)) and a visit count in the exact int32 fixed-point accumulator
  (learner_kernel.scatter_residual); the between-chunk update completes
  the TD with cnt * (maxq - q[s, a]);
* the env transition is ops/step_kernel.transition_core -- identical
  rules and counter PRNG to the rollout and minimax chunks.

Self-play IQL has no equilibrium guarantee (that is minimax-Q's job); the
fused chunk covers the same self-play surface as agents/learners.iql_*;
for frozen-opponent best-response training use
ops/learner_kernel.fused_best_response_train (the reference's
single-agent mode on the minimax chunk).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnvConfig, N_ACTIONS
from . import lane_loop as ll
from . import step_kernel as sk
from .learner_kernel import (M_COLS, _cell_rows, decode_acc, n_codes,
                             run_chunk, scatter_residual)

COL_QA, COL_QB = 0, 5


def greedy_and_max(qs):
    """(first argmax, max) over 5 Q columns."""
    best = jnp.zeros(qs[0].shape, jnp.int32)
    bestv = qs[0]
    for k in range(1, N_ACTIONS):
        upd = qs[k] > bestv
        best = jnp.where(upd, k, best)
        bestv = jnp.maximum(bestv, qs[k])
    return best, bestv


def _iql_body(cfg: EnvConfig, n_steps: int, gamma: float):
    """Per-lane dual-actor/TD loop (pipelined retirement: step i's two
    TDs use the max-bootstraps read at step i+1, with a trailing read for
    the last step).  Accumulator cells: A's (code, a) at code*5 + a, B's
    at n_codes*5 + code*5 + b."""
    from ..core import rules
    q_int = int(round(cfg.slip_prob * 65536))
    b_base = n_codes(cfg) * N_ACTIONS

    def body(ctx, lanes):
        seed = ctx.scalar(0).astype(jnp.uint32)
        eps_int = ctx.scalar(1)
        off = ctx.scalar(2)
        gamma_f = jnp.float32(gamma)

        def qrow(code, base):
            return [ctx.gather(0, code * M_COLS + base + k)
                    for k in range(N_ACTIONS)]

        def retire(v_a, v_b, pend):
            cell_a, cell_b, r, cont, va_prev, vb_prev, valid = pend
            scatter_residual(ctx, 0, cell_a, r + cont * v_a - va_prev, valid)
            scatter_residual(ctx, 0, cell_b, -r + cont * v_b - vb_prev,
                             valid)

        def step(i, c):
            ra, ca, rb, cb, p, t, pend, rew, goals, truncs = c
            bits0 = sk._random_word(seed, i + off, 0, ctx.lane)
            bits1 = sk._random_word(seed, i + off, 1, ctx.lane)
            bits2 = sk._random_word(seed, i + off, 2, ctx.lane)
            bits3 = sk._random_word(seed, i + off, 3, ctx.lane)

            code = rules.cellpair_encode(jnp, ra, ca, rb, cb, p, cfg)
            ga, v_a = greedy_and_max(qrow(code, COL_QA))
            gb, v_b = greedy_and_max(qrow(code, COL_QB))
            retire(v_a, v_b, pend)

            ua_e = sk._u16(bits0, 0)
            ua_r = sk._u16(bits0, 1) % N_ACTIONS
            ub_e = sk._u16(bits3, 0)
            ub_r = sk._u16(bits3, 1) % N_ACTIONS
            aa = jnp.where(ua_e < eps_int, ua_r, ga)
            ab = jnp.where(ub_e < eps_int, ub_r, gb)

            nra, nca, nrb, ncb, npz, goal, r = sk.transition_core(
                ra, ca, rb, cb, p, aa, ab, bits1, bits2, cfg, q_int)
            nra, nca, nrb, ncb, npz, t2, trunc = sk.autoreset_core(
                nra, nca, nrb, ncb, npz, t, goal, bits2, cfg)
            cont = jnp.where(goal | trunc, 0.0, gamma_f)
            new_pend = (code * N_ACTIONS + aa, b_base + code * N_ACTIONS + ab,
                        r.astype(jnp.float32), cont, v_a, v_b,
                        jnp.ones_like(ra))
            return (nra, nca, nrb, ncb, npz, t2, new_pend,
                    rew + r, goals + goal.astype(jnp.int32),
                    truncs + trunc.astype(jnp.int32))

        zi = jnp.zeros_like(lanes[0])
        zf = jnp.zeros(zi.shape, jnp.float32)
        init = tuple(lanes[:6]) + ((zi, zi, zf, zf, zf, zf, zi), zi, zi, zi)
        ra, ca, rb, cb, p, t, pend, rew, goals, truncs = ctx.fori(
            n_steps, step, init)
        code = rules.cellpair_encode(jnp, ra, ca, rb, cb, p, cfg)
        retire(greedy_and_max(qrow(code, COL_QA))[1],
               greedy_and_max(qrow(code, COL_QB))[1], pend)
        return ra, ca, rb, cb, p, t, rew, goals, truncs

    return body


@ll.static_args("cfg", "batch", "n_steps", "gamma")
def iql_chunk(cfg: EnvConfig, seed, eps_int, m, state_fields, batch: int,
              n_steps: int, gamma: float = 0.99, step_offset=0,
              backend: str = "triton", block: int = ll.BLOCK, interpret: bool = False):
    """Run one fused IQL chunk.  ``m`` from `pack_iql_m`;
    ``state_fields`` = 6 int32 [batch/128, 128] planes; ``eps_int`` =
    round(eps * 65536) (traced).  Returns (new_fields, acc, stats[3]);
    decode acc with `unpack_iql_acc`."""
    return run_chunk(_iql_body(cfg, n_steps, gamma), state_fields, seed,
                     batch, n_steps, 6, m, 2 * n_codes(cfg) * N_ACTIONS,
                     scalars=(eps_int, step_offset), name="iql_chunk",
                     backend=backend, block=block,
                     interpret=interpret)


def pack_iql_m(cfg: EnvConfig, q_a, q_b) -> jnp.ndarray:
    """Pack both players' Q tables [nS, 5] into M, f32 [n_codes *
    M_COLS]."""
    rows = jnp.asarray(_cell_rows(cfg))
    m = jnp.zeros((n_codes(cfg), M_COLS), jnp.float32)
    m = m.at[rows, COL_QA:COL_QA + 5].set(jnp.asarray(q_a, jnp.float32))
    m = m.at[rows, COL_QB:COL_QB + 5].set(jnp.asarray(q_b, jnp.float32))
    return m.reshape(-1)


def unpack_iql_acc(cfg: EnvConfig, acc):
    """acc -> (sum_res_a, cnt_a, sum_res_b, cnt_b), each [nS, 5].  The
    per-visit TD is residual + (maxq - q[s, a]) with maxq/q frozen
    in-chunk, so sum_td = sum_res + cnt * (maxq[:, None] - q)."""
    rows = jnp.asarray(_cell_rows(cfg))
    cells = rows[:, None] * N_ACTIONS + jnp.arange(N_ACTIONS)[None, :]
    res_a, cnt_a = decode_acc(acc, cells)
    res_b, cnt_b = decode_acc(acc, cells + n_codes(cfg) * N_ACTIONS)
    return res_a, cnt_a, res_b, cnt_b


def init_iql_state_fields(cfg: EnvConfig, batch: int):
    from .learner_kernel import init_state_fields
    return init_state_fields(cfg, batch)


def fused_iql_train(cfg: EnvConfig, batch: int, n_chunks: int,
                    chunk_len: int = 64, lr: float = 0.3,
                    gamma: float = 0.99, eps: float = 0.3,
                    eps_min: float = 0.0, eps_halflife: int = 0,
                    lr_anneal_start: int = 0, lr_anneal_tau: float = 0.0,
                    lr_anneal_pow: float = 1.0, seed: int = 0,
                    backend: str = "triton",
                    init=None, mesh=None, start_chunk: int = 0,
                    fields_init=None, return_state: bool = False,
                    chunks_per_dispatch: int = 1):
    """Chunked fused independent-Q self-play.  Returns (q_a, q_b,
    stats_history).  ``init`` optionally warm-starts (q_a, q_b).
    ``backend`` picks the chunk launcher as in
    ops/learner_kernel.fused_minimax_train.

    ``mesh`` (a jax.sharding.Mesh with an 'env' axis) DP-shards the lane
    batch: per-device fused chunks with psum'd accumulators
    (parallel/mesh.sharded_iql_chunk_fn).

    ``start_chunk``/``fields_init``/``return_state`` give EXACT
    checkpoint/resume (see ops/learner_kernel.fused_minimax_train): with
    ``return_state=True`` a fourth element ``resume`` is returned — a
    dict of (q_a, q_b, fields, next_chunk) — and a follow-up call with
    ``init=(resume['q_a'], resume['q_b'])``,
    ``fields_init=resume['fields']``,
    ``start_chunk=resume['next_chunk']`` continues bit-identically to an
    uninterrupted run.  ``stats_history`` cadence differs by
    dispatch mode: the per-chunk loop records every 16th chunk (plus
    the last); grouped dispatches record every chunk."""
    from ..core import tables
    nS = tables.build_statespace(cfg).nS
    launch = dict(backend=backend)
    if init is None:
        q_a = jnp.zeros((nS, N_ACTIONS), jnp.float32)
        q_b = jnp.zeros((nS, N_ACTIONS), jnp.float32)
    else:
        q_a, q_b = (jnp.asarray(x, jnp.float32) for x in init)
    assert q_a.shape == (nS, N_ACTIONS)
    fields = init_iql_state_fields(cfg, batch)
    if fields_init is not None:
        fields = tuple(jnp.asarray(f) for f in fields_init)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        from ..parallel.mesh import sharded_iql_chunk_fn
        sharded = sharded_iql_chunk_fn(cfg, mesh, batch, chunk_len,
                                       gamma=gamma, **launch)
        sh = NamedSharding(mesh, PartitionSpec("env", None))
        fields = tuple(jax.device_put(f, sh) for f in fields)

        def chunk(seed_k, eps_int, m, fields, step_offset):
            return sharded(seed_k, eps_int, m, fields, step_offset)
    else:
        def chunk(seed_k, eps_int, m, fields, step_offset):
            return iql_chunk(cfg, seed_k, eps_int, m, fields, batch,
                             chunk_len, gamma=gamma,
                             step_offset=step_offset, **launch)

    @jax.jit
    def between(q_a, q_b, acc, lr_now):
        res_a, cnt_a, res_b, cnt_b = unpack_iql_acc(cfg, acc)
        sum_a = res_a + cnt_a * (q_a.max(-1)[:, None] - q_a)
        sum_b = res_b + cnt_b * (q_b.max(-1)[:, None] - q_b)
        q_a = q_a + lr_now * sum_a / jnp.maximum(cnt_a, 1.0)
        q_b = q_b + lr_now * sum_b / jnp.maximum(cnt_b, 1.0)
        return q_a, q_b, pack_iql_m(cfg, q_a, q_b)

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

    m = pack_iql_m(cfg, q_a, q_b)
    history = []
    end_chunk = start_chunk + n_chunks
    if chunks_per_dispatch > 1:
        # Grouped dispatches (see fused_minimax_train): in-graph f32
        # schedules; eps quantizes to the kernel's u16 threshold in-graph
        # (can differ from the host's f64 rounding by one count).
        g = chunks_per_dispatch

        def chunk_body(carry, k):
            fields, q_a, q_b, m = carry
            kf = k.astype(jnp.float32)
            eps_int = jnp.round(eps_at(kf) * 65536).astype(jnp.int32)
            fields, acc, stats = chunk(seed * 1_000_003 + k, eps_int, m,
                                       fields, k * chunk_len)
            q_a, q_b, m = between(q_a, q_b, acc, lr_at(kf))
            return (fields, q_a, q_b, m), jnp.stack(
                [st.astype(jnp.int32) for st in stats])

        @jax.jit
        def seg_run(carry, ks):
            return jax.lax.scan(chunk_body, carry, ks)

        rem_body = jax.jit(chunk_body)
        carry = (fields, q_a, q_b, m)
        stats_rows = []
        full_end = start_chunk + ((end_chunk - start_chunk) // g) * g
        for s0 in range(start_chunk, full_end, g):
            carry, st = seg_run(carry, jnp.arange(s0, s0 + g))
            stats_rows.append(st)
        for k in range(full_end, end_chunk):
            carry, st = rem_body(carry, jnp.int32(k))
            stats_rows.append(st[None])
        fields, q_a, q_b, m = carry
        history = [tuple(int(x) for x in row)
                   for st in stats_rows for row in np.asarray(st)]
    else:
        for k in range(start_chunk, end_chunk):
            fields, acc, stats = chunk(
                seed * 1_000_003 + k, int(round(eps_at(k) * 65536)),
                m, fields, k * chunk_len)
            q_a, q_b, m = between(q_a, q_b, acc, jnp.float32(lr_at(k)))
            if k % 16 == 0 or k == end_chunk - 1:
                history.append(stats)
        history = [tuple(int(np.asarray(x)) for x in row)
                   for row in history]
    if return_state:
        return q_a, q_b, history, {"q_a": q_a, "q_b": q_b,
                                   "fields": fields,
                                   "next_chunk": end_chunk}
    return q_a, q_b, history
