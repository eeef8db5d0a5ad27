"""Vectorized environment facade: gym.vector-style API over the batched
engine.

The reference is a single-instance env (soccer_simultaneous_env.py:375-424,
one dict step at a time); its ecosystem's standard scale-out surface is
``gym.vector`` — batched reset/step over numpy arrays with autoreset and
``final_observation`` reporting.  This facade provides exactly that surface
on top of core/batch.py: one jitted lockstep transition per call, numpy in /
numpy out, thousands of instances per step on one device.

Operating modes mirror the reference ctor contract (:35-58):

* **multiagent** (no frozen policies): actions are a dict
  ``{"player_a": int array [N], "player_b": int array [N]}``; rewards,
  terminations, truncations and infos are dicts keyed the same way, with
  ``player_b`` rewards the negation of ``player_a`` (zero-sum, :400-402).
* **single-agent** (exactly one frozen opponent policy, a dict or array
  mapping dense state -> action): actions are a bare int array [N] for the
  learning agent; the opponent's action is looked up on device from its
  policy table (reference substitutes it at table-build time, :187-188);
  rewards are sign-flipped when the learner is player B (:242-244).

Autoreset follows gym.vector semantics: instances that terminate or
truncate return the NEXT episode's first observation, and the pre-reset
terminal observation is reported in ``infos["final_observation"]`` with
the standard ``infos["_final_observation"]`` mask.  Every step also reports
``infos["p"]`` — the sampled transition's probability rounded to 2 decimals
per lane, the batched form of the reference's per-agent info dict (:405).

For maximum throughput keep rollouts on device instead (core/batch.rollout
or ops/step_kernel.pallas_rollout); this facade pays one host round trip
per call by design — it exists for API compatibility and host-driven loops.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from .. import spaces
from ..config import EnvConfig, N_ACTIONS
from ..core import batch, tables
from ..utils.metrics import EpisodeStats, chunk_stats


class SoccerVectorEnv:
    """Batched Littman-soccer environment with a gym.vector-style API."""

    metadata = {"render_modes": []}

    def __init__(self, num_envs: int, width: int = 5, height: int = 4,
                 slip_prob: float = 0.0, player_a_policy=None,
                 player_b_policy=None, seed: int = 0, max_steps: int = 100):
        if player_a_policy is not None and player_b_policy is not None:
            raise ValueError(
                "Cannot freeze both players (reference ctor assert :38).")
        self.num_envs = int(num_envs)
        self.cfg = EnvConfig(width=width, height=height,
                             slip_prob=float(slip_prob),
                             max_steps=int(max_steps))
        self.nS = tables.build_statespace(self.cfg).nS
        self.nA = N_ACTIONS

        self._frozen = ("player_a" if player_a_policy is not None else
                        "player_b" if player_b_policy is not None else None)
        self.agents = (["player_a", "player_b"] if self._frozen is None else
                       ["player_b" if self._frozen == "player_a" else
                        "player_a"])
        pol = player_a_policy if player_a_policy is not None \
            else player_b_policy
        self._policy = None if pol is None else _policy_array(pol, self.nS)

        self.single_observation_space = spaces.Discrete(self.nS)
        self.single_action_space = spaces.Discrete(self.nA)
        self.observation_space = spaces.Dict(
            {a: spaces.MultiDiscrete([self.nS] * self.num_envs)
             for a in self.agents})
        self.action_space = spaces.Dict(
            {a: spaces.MultiDiscrete([self.nA] * self.num_envs)
             for a in self.agents})

        self._seed = int(seed)
        self._seed_list = None      # per-env seeds from reset(seed=[...])
        self._reset_count = 0
        self._state = None  # device EnvState; set by reset()
        self._stats = EpisodeStats.zero()

        # reset info "p": the ISD is uniform over its entries (reference
        # _generate_isd :146-165), so every lane's sampled entry has the
        # same probability 1/nI.
        n_isd = batch.device_maps(self.cfg).isd_fields.shape[0]
        self._isd_p = float(np.round(1.0 / n_isd, 2))

        cfg = self.cfg

        @jax.jit
        def _init(key):
            return batch.init(cfg, key, self.num_envs)

        @jax.jit
        def _init_keys(keys):
            return batch.init_from_keys(cfg, keys)

        pol_arr = (None if self._policy is None
                   else jnp.asarray(self._policy, jnp.int32))
        frozen = self._frozen

        @jax.jit
        def _step(state, acts):
            if frozen is None:
                aa, ab = acts[0], acts[1]
            else:
                obs = batch.observe(cfg, state)
                frozen_act = pol_arr[obs]
                learner = acts[0]
                aa = frozen_act if frozen == "player_a" else learner
                ab = frozen_act if frozen == "player_b" else learner
            state, out = batch.step(cfg, state, aa, ab)
            return state, (out.obs, out.reward_a, out.done, out.truncated,
                           out.final_obs, out.prob)

        self._init_fn = _init
        self._init_keys_fn = _init_keys
        self._step_fn = _step

    # -- gym.vector surface ------------------------------------------------

    def reset(self, seed=None):
        """Reset ALL instances.  Returns (obs, infos).

        Gym semantics: an explicit ``seed`` reseeds the env (identical
        trajectories thereafter); a bare ``reset()`` continues the seeded
        stream (each call starts fresh, distinct episodes).  ``seed`` may
        be a single int or a per-env sequence of ``num_envs`` ints
        (gym.vector's per-env seed list)."""
        if seed is not None:
            if np.ndim(seed) == 0:
                self._seed = int(seed)
                self._seed_list = None
            else:
                seeds = np.asarray(seed, np.uint32).ravel()
                if seeds.shape[0] != self.num_envs:
                    raise ValueError(
                        f"seed list must have num_envs={self.num_envs} "
                        f"entries, got {seeds.shape[0]}")
                self._seed_list = seeds
            self._reset_count = 0
        if self._seed_list is not None:
            keys = jax.vmap(jax.random.key)(jnp.asarray(self._seed_list))
            if self._reset_count:
                keys = jax.vmap(jax.random.fold_in, (0, None))(
                    keys, jnp.uint32(self._reset_count))
            self._state = self._init_keys_fn(keys)
        else:
            key = jax.random.key(self._seed)
            if self._reset_count:
                key = jax.random.fold_in(key, self._reset_count)
            self._state = self._init_fn(key)
        self._reset_count += 1
        self._stats = EpisodeStats.zero()
        obs = np.asarray(batch.observe(self.cfg, self._state))
        infos = {"p": np.full(self.num_envs, self._isd_p)}
        return self._keyed(obs), infos

    def step(self, actions):
        """Lockstep transition of the whole batch (numpy in / numpy out)."""
        if self._state is None:
            raise RuntimeError("reset() must be called before step()")
        acts = self._coerce_actions(actions)
        self._state, out = self._step_fn(self._state, acts)
        # One batched transfer: per-array np.asarray would pay one host
        # round trip EACH.
        obs, reward_a, done, trunc, final_obs, prob = jax.device_get(out)

        infos: dict = {"p": np.round(prob.astype(np.float64), 2)}
        ended = done | trunc
        if ended.any():
            infos["final_observation"] = np.where(ended, final_obs, 0)
            infos["_final_observation"] = ended
        self._stats = self._stats.merge(chunk_stats(SimpleNamespace(
            done=done, truncated=trunc, reward_a=reward_a)))

        ra = reward_a.astype(np.float64)
        # player_b's reward is the negation (zero-sum, :400-402); this also
        # realizes the single-agent-as-B sign flip (:242-244).
        rewards = {"player_a": ra, "player_b": -ra}
        return (self._keyed(obs),
                {a: rewards[a] for a in self.agents},
                {a: done.copy() for a in self.agents},
                {a: trunc.copy() for a in self.agents},
                infos)

    def close(self):
        self._state = None

    # -- metrics -------------------------------------------------------------

    @property
    def episode_stats(self) -> EpisodeStats:
        """Aggregated episode statistics since the last reset() — the
        batched analogue of the reference main()'s episode accounting
        (soccer_simultaneous_env.py:598-613)."""
        return self._stats

    # -- helpers -----------------------------------------------------------

    def _keyed(self, arr: np.ndarray):
        """Multiagent mode returns per-agent dicts (both agents see the same
        full-state index, like the reference's obs dicts :397); single-agent
        mode returns the bare array."""
        if self._frozen is None:
            return {a: arr.copy() for a in self.agents}
        return arr

    def _coerce_actions(self, actions) -> jnp.ndarray:
        N = self.num_envs

        def valid(arr, who):
            arr = np.asarray(arr, np.int32).reshape(N)
            if ((arr < 0) | (arr >= self.nA)).any():
                bad = arr[(arr < 0) | (arr >= self.nA)][0]
                raise ValueError(
                    f"invalid action {bad} for {who}: actions must be in "
                    f"[0, {self.nA}) (reference action encoding :8-13)")
            return arr

        if self._frozen is None:
            if not (isinstance(actions, dict)
                    and set(actions) == {"player_a", "player_b"}):
                raise ValueError(
                    "multiagent mode takes {'player_a': [N], "
                    "'player_b': [N]}")
            aa = valid(actions["player_a"], "player_a")
            ab = valid(actions["player_b"], "player_b")
            return jnp.stack([jnp.asarray(aa), jnp.asarray(ab)])
        a = valid(actions, self.agents[0])
        return jnp.asarray(a)[None, :]

    @property
    def device_state(self) -> batch.EnvState:
        """The underlying device EnvState — escape hatch for staying
        on-device (e.g. handing off to core/batch.rollout)."""
        return self._state


def _policy_array(policy, nS: int) -> np.ndarray:
    """Accept the reference's dict[state->action] or an int array [nS].

    A dict must cover every dense state: the reference raises KeyError for
    uncovered states at table-build time (soccer_simultaneous_env.py:188);
    silently defaulting them to NOOP would corrupt results."""
    if isinstance(policy, dict):
        missing = [s for s in range(nS) if s not in policy]
        if missing:
            raise KeyError(
                f"frozen policy missing {len(missing)} of {nS} states "
                f"(first: {missing[:5]})")
        arr = np.array([int(policy[s]) for s in range(nS)], np.int32)
        return arr
    arr = np.asarray(policy, np.int32)
    if arr.shape != (nS,):
        raise ValueError(f"policy must have shape ({nS},), got {arr.shape}")
    return arr
