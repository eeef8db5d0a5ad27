"""Debug-build invariant checks (SURVEY.md §5.2).

The reference guards its dynamics with plain asserts (probability sums
:285-287, no co-location :325-359, goal-state sanity :100-101) that only
run during table construction.  Here the equivalents are jit-compatible
checks over *batched runtime state*, usable two ways:

* `state_invariants(cfg, state)` — pure boolean diagnostics (cheap enough
  to run in tests or periodic validation sweeps);
* `checked_step(cfg)` — a `jax.experimental.checkify` wrapper around the
  batched step that turns violations into structured errors in debug runs
  (zero cost when not used; the production path stays check-free).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..config import EnvConfig, N_ACTIONS
from . import batch, rules


def state_invariants(cfg: EnvConfig, state: batch.EnvState) -> dict:
    """Boolean arrays [B], all True on a healthy state."""
    in_rows = lambda x: (x >= 0) & (x < cfg.H)
    in_cols = lambda y: (y >= 0) & (y < cfg.W)
    bounds = (in_rows(state.rows_a) & in_cols(state.cols_a) &
              in_rows(state.rows_b) & in_cols(state.cols_b))
    distinct = ~((state.rows_a == state.rows_b) &
                 (state.cols_a == state.cols_b))
    poss_ok = (state.poss == 0) | (state.poss == 1)
    t_ok = (state.t >= 0) & (state.t < cfg.max_steps)
    # live states are never terminal (autoreset) nor unreachable
    unreach = rules.is_unreachable(
        jnp, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    goal = rules.is_goal_state(
        jnp, state.rows_a, state.cols_a, state.rows_b, state.cols_b,
        state.poss, cfg)
    return {
        "in_bounds": bounds,
        "players_distinct": distinct,
        "possession_binary": poss_ok,
        "timestep_in_range": t_ok,
        "reachable": ~unreach,
        "not_absorbed": ~goal,
    }


def assert_invariants(cfg: EnvConfig, state: batch.EnvState) -> None:
    """Host-side hard assertion (tests / debugging).  One jitted dispatch
    and one transfer."""
    import numpy as np
    inv = jax.jit(state_invariants, static_argnums=0)(cfg, state)
    inv = jax.device_get(inv)
    for name, ok in inv.items():
        bad = np.flatnonzero(~np.asarray(ok))
        assert bad.size == 0, f"invariant {name} violated at lanes {bad[:8]}"


def checked_step(cfg: EnvConfig):
    """checkify-wrapped batched step: returns (err, (state, out)).  Call
    `err.throw()` to raise on the first violated invariant."""
    def stepper(state, aa, ab):
        inv = state_invariants(cfg, state)
        for name, ok in inv.items():
            checkify.check(jnp.all(ok), f"pre-step invariant {name} violated")
        checkify.check(
            jnp.all((aa >= 0) & (aa < N_ACTIONS) &
                    (ab >= 0) & (ab < N_ACTIONS)),
            "actions out of range")
        new, out = batch.step(cfg, state, aa, ab)
        for name, ok in state_invariants(cfg, new).items():
            checkify.check(jnp.all(ok), f"post-step invariant {name} violated")
        return new, out

    return checkify.checkify(stepper)
