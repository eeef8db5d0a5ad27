"""gym_soccer_tpu — a batched JAX re-engineering of the Littman94
grid-soccer Markov game (reference: mimoralea/gym-soccer-littman94).

Layers:
  core/      pure rules kernel, vectorized table builder, batched engine,
             reference-RNG parity backend
  envs/      reference-compatible single-env facades (simultaneous +
             alternating-turn)
  agents/    planners (VI/PI/MPI) and on-device tabular learners
  parallel/  mesh/sharding data parallelism and collectives
  ops/       low-level device kernels
  utils/     policies, checkpointing, profiling
"""
from .config import EnvConfig, NOOP, NORTH, SOUTH, EAST, WEST  # noqa: F401
from .registry import make, register, registry_ids  # noqa: F401

__version__ = "0.1.0"
