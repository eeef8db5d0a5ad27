"""Train -> deploy interop: on-device learner outputs drop into the
reference-style API surfaces.

The reference persists policies as pickled dicts (policies.py:17-27) and
consumes them as frozen opponents at env construction (:187-188).  This
pins the full pipeline: batched learner -> greedy policy array -> dict ->
pickle round trip -> single-env facade AND vector env as the frozen
opponent.
"""
import numpy as np
import jax
import jax.numpy as jnp

from gym_soccer_tpu.config import EnvConfig
from gym_soccer_tpu.agents import learners
from gym_soccer_tpu.envs import SoccerSimultaneousEnv, SoccerVectorEnv
from gym_soccer_tpu.utils.policies import load_policy, save_policy

CFG = EnvConfig(width=5, height=4, slip_prob=0.2)


def test_learned_policy_deploys_through_reference_surfaces(tmp_path):
    lcfg = learners.MinimaxQConfig(lr=0.3, eps=0.3, resolve_every=64,
                                   solver_iters=50)
    st = jax.jit(lambda k: learners.minimax_init(CFG, k, 256))(
        jax.random.key(0))
    st, _ = jax.jit(lambda s: learners.minimax_train(CFG, lcfg, s, 300))(st)

    greedy_b = np.asarray(jnp.argmax(st.pi_b, axis=-1), np.int64)
    policy_dict = {s: int(a) for s, a in enumerate(greedy_b)}

    # reference persistence path: pickle round trip
    path = str(tmp_path / "policy_b.pkl")
    save_policy(policy_dict, path)
    loaded = load_policy(path)
    assert loaded == policy_dict

    # single-env facade with the learned frozen opponent
    env = SoccerSimultaneousEnv(width=5, height=4, slip_prob=0.2,
                                player_b_policy=loaded, seed=0)
    obs, _ = env.reset(seed=1)
    assert set(obs) == {"player_a"}
    for _ in range(30):
        if env.needs_reset:
            env.reset()
        obs, rew, done, trunc, info = env.step({"player_a": env.EAST})
        assert set(rew) == {"player_a"}

    # vector env with the same opponent as a raw array
    venv = SoccerVectorEnv(64, width=5, height=4, slip_prob=0.2,
                           player_b_policy=greedy_b)
    vobs, _ = venv.reset(seed=2)
    total_goals = 0
    for _ in range(120):
        vobs, vrew, vdone, vtrunc, _ = venv.step(np.full(64, 3))
        total_goals += int(vdone["player_a"].sum())
    assert total_goals > 0  # the pipeline plays real episodes end to end
