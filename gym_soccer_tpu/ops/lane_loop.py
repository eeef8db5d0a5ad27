"""Lane-loop launcher: one env lane per GPU thread for all T steps.

Every fused path in this package (random rollouts, the journaled rollout,
and the minimax, IQL and alternating-turn learner chunks) is written ONCE
as a per-lane body over 1-D lane vectors, and run by one of two
launchers:

* ``backend="triton"`` -- Pallas through Triton.  A 1-D grid over lane
  blocks; the time loop is a ``lax.fori_loop`` inside the kernel, so each
  lane's state stays in registers for the whole call.  Table reads are
  per-lane gathers from device memory (L1/L2 resident for every board
  this package builds); accumulators are integer atomics.
* ``backend="xla"`` -- the plain XLA twin: the same body over all lanes
  at once inside a ``lax.fori_loop``.  It is the reference the kernel is
  checked against, and what runs on CPU.

Both launchers give a lane the same global id (its flat index in the
batch), so the counter PRNG (step_kernel._random_word) draws identical
bits in either: integer outputs agree bit for bit.

Accumulators are int32 and only ever ADDED to, so their final value does
not depend on the order in which lanes or blocks land -- the property the
trainers' bit-exact resume needs on a GPU, where float atomics and XLA's
float scatter-add sum in a different order on each run.  (Interpret mode
is a CPU rehearsal of the Triton kernel; its atomics drop colliding
updates within a block, so check accumulators on the twin there.)
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# JAX versions on which `_fix_int_atomic_add` was checked on the card
# (tests/test_pallas_kernel.py::test_int32_atomic_add_exact).
ATOMIC_FIX_JAX = ("0.9.0",)
_atomic_fixed = False


def _fix_int_atomic_add() -> None:
    """Make Pallas-Triton's vector atomic_add on integers an integer add.

    JAX 0.9.0's Triton lowering of ``atomic_rmw`` picks ``fadd`` for any
    TENSOR value (it tests the tensor type, not its element type), so an
    int32 vector atomic_add adds float bit patterns and the counts come
    out as garbage on the card.  This re-registers the rule for integer
    ADD only, emitting ``tt.atomic_rmw add``; every other case goes to
    JAX's own rule.

    It patches JAX's process-global lowering table through private
    names, so it runs on the first Triton launch (never on import, nor
    for the twin or interpret mode), and only on a JAX in
    ATOMIC_FIX_JAX: any other version fails here, loudly, until the
    card test above passes on it and the version is added."""
    global _atomic_fixed
    if _atomic_fixed:
        return
    if jax.__version__ not in ATOMIC_FIX_JAX:
        raise RuntimeError(
            f"the integer atomic_add fix was checked on JAX "
            f"{ATOMIC_FIX_JAX}, not {jax.__version__}: run "
            f"tests/test_pallas_kernel.py::test_int32_atomic_add_exact on "
            f"a GPU and add the version to lane_loop.ATOMIC_FIX_JAX")
    from jax._src.pallas import primitives as pp
    from jax._src.pallas.triton import lowering as tl
    from jax._src.lib.triton import dialect as tt
    from jax._src.state import indexing

    jax_rule = tl.triton_lowering_rules[pp.atomic_rmw_p]

    def rule(ctx, *args_flat, args_tree, atomic_type):
        ptr, indexers, val, mask = args_tree.unflatten(args_flat)
        *_, value_aval, mask_aval = args_tree.unflatten(ctx.avals_in)
        if (atomic_type != pp.AtomicOpType.ADD
                or not jnp.issubdtype(value_aval.dtype, jnp.integer)
                or len(indexers) != 1
                or not isinstance(indexers[0], indexing.NDIndexer)):
            return jax_rule(ctx, *args_flat, args_tree=args_tree,
                            atomic_type=atomic_type)
        block_info, *_ = ctx.block_infos
        ptr = tl._compute_pointers_from_indices(ptr, block_info, indexers[0])
        val = tl._ensure_ir_value(val, value_aval)
        if mask is not None:
            mask = tl._ensure_ir_value(mask, mask_aval)
        return tl._atomic_rmw(tt.RMWOp.ADD, ptr, val, mask=mask)

    tl.register_lowering(pp.atomic_rmw_p)(rule)
    _atomic_fixed = True


BACKENDS = ("triton", "xla")
BLOCK = 128        # lanes per Triton program (one lane per thread)
NUM_WARPS = 4


def check_backend(backend: str, interpret: bool = False) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if interpret and backend != "triton":
        raise ValueError("interpret=True rehearses the Triton kernel; "
                         "the xla backend has no interpret mode")


class _TritonCtx:
    def __init__(self, lane, valid, s_ref, t_refs, a_refs, j_ref):
        self.lane, self.valid = lane, valid
        self._s, self._t, self._a, self._j = s_ref, t_refs, a_refs, j_ref

    def scalar(self, j):
        return self._s[j]

    def gather(self, t, idx):
        return self._t[t][idx]

    def scatter_add(self, a, idx, val):
        if self.valid is not None:
            val = jnp.where(self.valid, val, 0)
        plgpu.atomic_add(self._a[a], (idx,), val)

    def record(self, i, word):
        self._j[i, :] = word

    def fori(self, n, body, carry):
        return jax.lax.fori_loop(0, n, body, carry)


class _XlaCtx:
    def __init__(self, lane, s, tables, accs, journal):
        self.lane, self.valid = lane, None
        self._s, self._t = s, tables
        self.accs, self.journal = list(accs), journal

    def scalar(self, j):
        return self._s[j]

    def gather(self, t, idx):
        return self._t[t][idx]

    def scatter_add(self, a, idx, val):
        self.accs[a] = self.accs[a].at[idx].add(val)

    def record(self, i, word):
        self.journal = jax.lax.dynamic_update_slice(
            self.journal, word[None], (i, 0))

    def fori(self, n, body, carry):
        # Thread the side-effect state (accumulators, journal) through the
        # loop carry so the body can treat them as refs, as in the kernel.
        def step(i, c):
            carry, accs, journal = c
            self.accs, self.journal = list(accs), journal
            carry = body(i, carry)
            return carry, tuple(self.accs), self.journal

        carry, accs, self.journal = jax.lax.fori_loop(
            0, n, step, (carry, tuple(self.accs), self.journal))
        self.accs = list(accs)
        return carry


def run(body, *, batch: int, lanes, scalars, tables=(), acc_sizes=(),
        n_out: int, journal_steps: int = 0, backend: str = "triton",
        block: int = BLOCK, interpret: bool = False,
        name: str = "lane_loop"):
    """Run ``body(ctx, lane_values) -> n_out int32 lane vectors``.

    The body sees one context, whichever launcher runs it:
    ``ctx.lane`` (uint32 global lane ids), ``ctx.scalar(j)``,
    ``ctx.gather(t, idx)`` (read table t), ``ctx.scatter_add(a, idx,
    val)`` (add to int32 accumulator a), ``ctx.record(i, word)`` (journal
    row i) and ``ctx.fori(n, step, carry)`` (the time loop; the twin
    threads accumulators and journal through its carry).

    ``lanes``: 1-D [batch] arrays (the body's per-lane inputs: state
    fields and read-only geometry planes).  ``scalars``: int32 values the
    body reads with ``ctx.scalar(j)``.  ``tables``: read-only 1-D arrays
    for ``ctx.gather``.  ``acc_sizes``: sizes of zero-initialised int32
    accumulators for ``ctx.scatter_add``.  ``journal_steps`` > 0 adds an
    int32 [journal_steps, batch] output written by ``ctx.record``.

    Returns (outs, accs, journal_or_None); outs are [batch] int32.
    """
    check_backend(backend, interpret)
    s = jnp.stack([jnp.asarray(x, jnp.int32) for x in scalars])
    accs0 = tuple(jnp.zeros((n,), jnp.int32) for n in acc_sizes)
    if backend == "xla":
        lane = jnp.arange(batch, dtype=jnp.uint32)
        journal = (jnp.zeros((journal_steps, batch), jnp.int32)
                   if journal_steps else None)
        ctx = _XlaCtx(lane, s, tuple(tables), accs0, journal)
        outs = body(ctx, tuple(lanes))
        return tuple(outs), tuple(ctx.accs), ctx.journal

    if block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if acc_sizes and not interpret:
        _fix_int_atomic_add()
    padded = -(-batch // block) * block
    if padded != batch:
        # edge-replicated padding lanes hold valid states (gathers stay in
        # range); their accumulator updates are masked to zero
        lanes = [jnp.pad(x, (0, padded - batch), mode="edge") for x in lanes]
    s = jnp.pad(s, (0, (1 << max(1, math.ceil(math.log2(s.shape[0]))))
                    - s.shape[0]))
    n_in, n_t, n_a = len(lanes), len(tables), len(acc_sizes)

    def kernel(*refs):
        # Atomics go to the accumulator INPUT refs: XLA may drop an
        # aliased output's duplicate kernel parameter, so the aliased
        # outputs come last and are never referenced.
        s_ref = refs[0]
        lane_refs = refs[1:1 + n_in]
        t_refs = refs[1 + n_in:1 + n_in + n_t]
        a_refs = refs[1 + n_in + n_t:1 + n_in + n_t + n_a]
        o_refs = refs[1 + n_in + n_t + n_a:1 + n_in + n_t + n_a + n_out]
        j_ref = refs[1 + n_in + n_t + n_a + n_out] if journal_steps else None
        lane = (pl.program_id(0) * block
                + jax.lax.broadcasted_iota(jnp.int32, (block,), 0))
        valid = lane < batch if padded != batch else None
        ctx = _TritonCtx(lane.astype(jnp.uint32), valid, s_ref, t_refs,
                         a_refs, j_ref)
        outs = body(ctx, tuple(r[...] for r in lane_refs))
        for r, v in zip(o_refs, outs):
            r[...] = v

    lane_spec = pl.BlockSpec((block,), lambda b: (b,))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda b: (0,) * x.ndim)

    out_shape = [jax.ShapeDtypeStruct((padded,), jnp.int32)] * n_out
    out_specs = [lane_spec] * n_out
    if journal_steps:
        out_shape.append(jax.ShapeDtypeStruct((journal_steps, padded),
                                              jnp.int32))
        out_specs.append(pl.BlockSpec((journal_steps, block),
                                      lambda b: (0, b)))
    n_j = len(out_shape) - n_out
    out_shape += [jax.ShapeDtypeStruct((n,), jnp.int32) for n in acc_sizes]
    out_specs += [whole(a) for a in accs0]
    first_acc = 1 + n_in + n_t
    res = pl.pallas_call(
        kernel,
        grid=(padded // block,),
        in_specs=([whole(s)] + [lane_spec] * n_in
                  + [whole(t) for t in tables] + [whole(a) for a in accs0]),
        out_specs=out_specs,
        out_shape=out_shape,
        input_output_aliases={first_acc + k: n_out + n_j + k
                              for k in range(n_a)},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(s, *lanes, *tables, *accs0)
    outs = tuple(o[:batch] for o in res[:n_out])
    journal = res[n_out][:, :batch] if journal_steps else None
    accs = tuple(res[n_out + n_j:])
    return outs, accs, journal


def static_args(*names):
    """jax.jit with the launcher's static options plus ``names``."""
    return functools.partial(
        jax.jit, static_argnames=names + ("backend", "block", "interpret"))
