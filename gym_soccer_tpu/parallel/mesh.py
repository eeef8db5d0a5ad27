"""Data parallelism over the env batch via jax.sharding.

The reference is single-process/single-thread (SURVEY.md §5.8: no
communication backend at all); here the scale axis is the env batch
(§5.7 — there are no model weights or sequences to shard, so TP/PP/SP/EP
do not apply; see docs/PARALLELISM.md).  Design:

* a 1-D device mesh with axis ``env``;
* `EnvState` leaves sharded on their leading (batch) dim — env shards are
  embarrassingly parallel, XLA inserts zero collectives for stepping;
* learner Q-tables replicated; their per-step update deltas all-reduced
  with `psum` inside `shard_map` (NCCL over NVLink between the GPUs of a
  host);
* per-instance keys (fold_in of global instance id) make every env's
  stream placement-invariant: the same instance behaves identically on
  1 device or N, on any host (§7.3.7).

Multi-host: call `distributed_init()` once per process, then build the
mesh over `jax.devices()` (all hosts); per-host addressable shards follow
from the sharding.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EnvConfig
from ..core import batch


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the multi-process JAX runtime (no-op for a single
    process).  Replaces the reference's (absent) NCCL/MPI layer with JAX's
    distributed runtime; the coordinator address, process count and id
    must be given explicitly."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)


def env_mesh(n_devices: Optional[int] = None, axis: str = "env") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def batch_sharding(mesh: Mesh, axis: str = "env") -> NamedSharding:
    """Leading-dim sharding for every EnvState leaf / per-env array."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_state(state: batch.EnvState, mesh: Mesh,
                    axis: str = "env") -> batch.EnvState:
    sh = batch_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def sharded_init(cfg: EnvConfig, mesh: Mesh, key: jax.Array, n_envs: int,
                 axis: str = "env"):
    """jit-compiled env init with the batch laid out across the mesh.
    Instance ids are global, so the result is placement-invariant."""
    sh = batch_sharding(mesh, axis)
    fn = jax.jit(lambda k: batch.init(cfg, k, n_envs),
                 out_shardings=batch.EnvState(*([sh] * 8)))
    return fn(key)


def sharded_rollout_fn(cfg: EnvConfig, mesh: Mesh, policy_fn, n_steps: int,
                       axis: str = "env"):
    """jit a rollout whose env batch stays sharded over the mesh.  Stepping
    is elementwise over the batch, so XLA compiles it collective-free; only
    the summary reduction at the end crosses shards."""
    sh = batch_sharding(mesh, axis)
    state_sh = batch.EnvState(*([sh] * 8))

    def fn(state):
        state, out = batch.rollout(cfg, state, policy_fn, n_steps)
        return state, (out.reward_a.sum(), out.done.sum(),
                       out.truncated.sum())

    return jax.jit(fn, in_shardings=(state_sh,),
                   out_shardings=(state_sh, None))


def _env_specs(axis: str):
    from ..core.batch import EnvState
    return EnvState(*([P(axis)] * 8))


def sharded_iql_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh, n_steps: int,
                         axis: str = "env"):
    """Data-parallel fused IQL training: env batch sharded over the mesh,
    Q-tables replicated, per-step deltas all-reduced with psum."""
    from ..agents import learners

    specs = learners.IQLState(q_a=P(), q_b=P(), env=_env_specs(axis),
                              step=P())

    def local(state):
        st, td = learners.iql_train(cfg, lcfg, state, n_steps,
                                    psum_axis=axis)
        return st, jax.lax.pmean(td, axis)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(specs,),
                       out_specs=(specs, P()))
    return jax.jit(fn)


def sharded_minimax_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh, n_steps: int,
                             axis: str = "env"):
    """Data-parallel fused minimax-Q training (same layout as IQL; the
    periodic all-state game re-solve runs replicated on every shard)."""
    from ..agents import learners

    specs = learners.MinimaxQState(q=P(), v=P(), pi_a=P(), pi_b=P(),
                                   env=_env_specs(axis), step=P(), n=P())

    def local(state):
        st, td = learners.minimax_train(cfg, lcfg, state, n_steps,
                                        psum_axis=axis)
        return st, jax.lax.pmean(td, axis)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(specs,),
                       out_specs=(specs, P()))
    return jax.jit(fn)


def sharded_solve_fn(mesh: Mesh, iters: int, axis: str = "env"):
    """Shard the all-states zero-sum matrix-game re-solve over the mesh
    STATE-wise.

    The between-chunk RM+ re-solve (agents/learners.solve_matrix_games)
    is the one compute stage in this workload whose natural axis is NOT
    the env batch: it iterates ``iters`` regret-matching steps over every
    state's 5x5 payoff matrix (nS x iters work, independent per state).
    Replicating it wastes (N-1)/N of the mesh during the solve; here each
    device solves nS/N states and the jit-level consumer gathers the
    strategy tables back (one all_gather of ~nS*11 floats per chunk).
    Per-state arithmetic is untouched, so results are
    BIT-IDENTICAL to the replicated solve — the honest analogue of
    tensor/model parallelism for a tabular learner (docs/PARALLELISM.md).

    Returns a jitted ``fn(q [nS, 5, 5]) -> (v [nS], x [nS, 5],
    y [nS, 5])``; nS need not divide the mesh (zero-padded states solve to
    uniform strategies and are dropped)."""
    from ..agents.learners import solve_matrix_games
    n_dev = mesh.shape[axis]

    inner = jax.shard_map(
        lambda qp: solve_matrix_games(qp, iters=iters),
        mesh=mesh, in_specs=(P(axis),),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False)  # solver-internal zeros are axis-unvarying

    @jax.jit
    def fn(q):
        nS = q.shape[0]
        pad = (-nS) % n_dev
        qp = jnp.pad(q, ((0, pad), (0, 0), (0, 0))) if pad else q
        v, x, y = inner(qp)
        return v[:nS], x[:nS], y[:nS]

    return fn


def _check_batch(batch: int, n_steps: int, n_dev: int) -> int:
    from ..ops.learner_kernel import MAX_SHARDS, check_visits
    assert batch % (n_dev * 128) == 0, \
        f"batch must be a multiple of {n_dev * 128} on this mesh"
    # each device's kernel words hold its own shard's visits; the folded
    # words of up to MAX_SHARDS devices psum without overflow
    if n_dev > MAX_SHARDS:
        raise ValueError(f"{n_dev} devices exceed {MAX_SHARDS}, the most "
                         f"whose folded accumulators psum exactly")
    check_visits(batch // n_dev, n_steps)
    return batch // n_dev


def _shard_seed(seed, axis: str):
    ax = jax.lax.axis_index(axis).astype(jnp.int32)
    return jnp.asarray(seed, jnp.int32) ^ (ax * jnp.int32(0x61C88647))


def _reduce(fields, acc, stats, axis: str):
    return (fields, jax.lax.psum(acc, axis),
            tuple(jax.lax.psum(s, axis) for s in stats))


def sharded_learner_chunk_fn(cfg, mesh: Mesh, batch: int, n_steps: int,
                             gamma: float = 0.99, axis: str = "env",
                             **launch):
    """Data-parallel FUSED learner chunks (ops/learner_kernel): the lane
    batch is sharded over the mesh, each device runs its own chunk
    (per-shard PRNG seed decorrelated by axis index), and the integer
    TD/count accumulators are all-reduced with psum -- exact, so the
    replicated between-chunk update (count-normalized Q backup + game
    re-solve) sees the WHOLE batch's statistics, exactly like a
    single-device run over the combined batch.  ``cfg`` may be a tuple
    (multigrid mode; pass the matching ``planes`` argument from
    init_state_fields).  ``launch`` (backend, block) goes to the chunk.

    Returns a jitted ``fn(seed, m, fields [, planes]) -> (fields, acc,
    stats)`` where fields are sharded [batch/128, 128] planes and acc is
    replicated."""
    from ..ops import learner_kernel as lk
    n_dev = mesh.shape[axis]
    bpd = _check_batch(batch, n_steps, n_dev)
    fspec = P(axis, None)

    if isinstance(cfg, tuple):
        def local(seed, m, fields, planes):
            out = lk.multigrid_learner_chunk(
                cfg, _shard_seed(seed, axis), m, planes, fields, bpd,
                n_steps, gamma=gamma, **launch)
            return _reduce(*out, axis)

        in_specs = (P(), P(), (fspec,) * 6, (fspec,) * 6)
    else:
        def local(seed, m, fields):
            out = lk.learner_chunk(cfg, _shard_seed(seed, axis), m, fields,
                                   bpd, n_steps, gamma=gamma, **launch)
            return _reduce(*out, axis)

        in_specs = (P(), P(), (fspec,) * 6)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=in_specs,
        out_specs=((fspec,) * 6, P(), (P(),) * 3),
        check_vma=False)  # pallas out_shapes carry no vma
    return jax.jit(fn)


def _sharded_eps_chunk_fn(chunk_f, n_fields, cfg, mesh, batch, n_steps,
                          gamma, axis, launch):
    n_dev = mesh.shape[axis]
    bpd = _check_batch(batch, n_steps, n_dev)
    fspec = P(axis, None)

    def local(seed, eps_int, m, fields, step_offset):
        out = chunk_f(cfg, _shard_seed(seed, axis), eps_int, m, fields, bpd,
                      n_steps, gamma=gamma, step_offset=step_offset,
                      **launch)
        return _reduce(*out, axis)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), (fspec,) * n_fields, P()),
        out_specs=((fspec,) * n_fields, P(), (P(),) * 3),
        check_vma=False)
    return jax.jit(fn)


def sharded_altq_chunk_fn(cfg: EnvConfig, mesh: Mesh, batch: int,
                          n_steps: int, gamma: float = 0.99,
                          axis: str = "env", **launch):
    """Data-parallel fused ALTERNATING-turn learner chunks
    (ops/altq_kernel) -- same layout as sharded_learner_chunk_fn, with 7
    state planes."""
    from ..ops import altq_kernel as ak
    return _sharded_eps_chunk_fn(ak.altq_chunk, 7, cfg, mesh, batch,
                                 n_steps, gamma, axis, launch)


def sharded_iql_chunk_fn(cfg: EnvConfig, mesh: Mesh, batch: int,
                         n_steps: int, gamma: float = 0.99,
                         axis: str = "env", **launch):
    """Data-parallel fused INDEPENDENT-Q learner chunks (ops/iql_kernel)
    -- same layout as sharded_learner_chunk_fn (6 state planes,
    dual-table accumulator psum'd)."""
    from ..ops import iql_kernel as ik
    return _sharded_eps_chunk_fn(ik.iql_chunk, 6, cfg, mesh, batch,
                                 n_steps, gamma, axis, launch)


def sharded_altq_train_fn(cfg: EnvConfig, lcfg, mesh: Mesh, n_steps: int,
                          axis: str = "env"):
    """Data-parallel fused alternating-turn Q-learning (same layout:
    env lanes sharded, the single Q-table replicated via delta-psum)."""
    from ..agents import learners
    from ..envs.soccer_alternating_env import AltEnvState

    specs = learners.AltQState(q=P(), env=AltEnvState(*([P(axis)] * 9)),
                               step=P())

    def local(state):
        st, td = learners.altq_train(cfg, lcfg, state, n_steps,
                                     psum_axis=axis)
        return st, jax.lax.pmean(td, axis)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(specs,),
                       out_specs=(specs, P()))
    return jax.jit(fn)
