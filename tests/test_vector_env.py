"""SoccerVectorEnv: the gym.vector-style batched facade.

Covers the multiagent and frozen-opponent single-agent contracts, autoreset
with final_observation reporting, seeding determinism, and distributional
sanity of rewards under random play.
"""
import numpy as np
import pytest

from gym_soccer_tpu.envs import SoccerVectorEnv

N = 64


@pytest.fixture(scope="module")
def venv():
    env = SoccerVectorEnv(N, width=5, height=4, slip_prob=0.2, seed=0)
    env.reset(seed=7)
    return env


def test_reset_shapes_and_keys(venv):
    obs, infos = venv.reset(seed=7)
    assert set(obs) == {"player_a", "player_b"}
    for a in obs:
        assert obs[a].shape == (N,) and obs[a].dtype == np.int32
        assert (obs[a] > 0).all() and (obs[a] < venv.nS).all()
    assert np.array_equal(obs["player_a"], obs["player_b"])
    # the 5x4 ISD is uniform over 4 entries (reference :151-157), so the
    # reset info "p" is 0.25 per lane (reference :420 rounds to 2 decimals)
    assert np.allclose(infos["p"], 0.25)


def test_step_contract_multiagent(venv):
    venv.reset(seed=7)
    acts = {"player_a": np.full(N, 3), "player_b": np.full(N, 4)}
    obs, rew, done, trunc, infos = venv.step(acts)
    assert set(rew) == {"player_a", "player_b"}
    assert np.array_equal(rew["player_a"], -rew["player_b"])  # zero-sum
    for d in (done, trunc):
        assert d["player_a"].dtype == bool and d["player_a"].shape == (N,)
    assert set(np.unique(rew["player_a"])) <= {-1.0, 0.0, 1.0}


def test_autoreset_and_final_observation(venv):
    venv.reset(seed=3)
    rng = np.random.RandomState(0)
    saw_end = False
    for _ in range(150):
        acts = {"player_a": rng.randint(0, 5, N),
                "player_b": rng.randint(0, 5, N)}
        obs, rew, done, trunc, infos = venv.step(acts)
        ended = done["player_a"] | trunc["player_a"]
        if ended.any():
            saw_end = True
            assert np.array_equal(infos["_final_observation"], ended)
            # goal terminations report the terminal obs 0; truncations
            # report the ordinary (nonzero) last state
            goals = done["player_a"]
            assert (infos["final_observation"][goals] == 0).all()
            # after autoreset the returned obs is a fresh start state
            assert (obs["player_a"][ended] > 0).all()
        else:
            assert "final_observation" not in infos
        # rewards only on goal terminations
        assert (rew["player_a"][~done["player_a"]] == 0).all()
        assert (rew["player_a"][done["player_a"]] != 0).all()
    assert saw_end, "150 random steps at 100-step truncation must end episodes"


def test_seeding_determinism():
    def run(seed):
        env = SoccerVectorEnv(16, width=5, height=4, slip_prob=0.2)
        obs, _ = env.reset(seed=seed)
        tot = [obs["player_a"]]
        rng = np.random.RandomState(1)
        for _ in range(40):
            acts = {"player_a": rng.randint(0, 5, 16),
                    "player_b": rng.randint(0, 5, 16)}
            obs, rew, *_ = env.step(acts)
            tot.append(obs["player_a"])
        return np.stack(tot)

    a, b, c = run(11), run(11), run(12)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_single_agent_mode_frozen_b():
    """Learner A marching EAST against a standing B: A either starts with
    the ball or steals it by walking into the NOOP'er (collision rule 2,
    deterministic flip), then scores right — positive return, many goals."""
    from gym_soccer_tpu.utils.policies import get_stand_policy
    env = SoccerVectorEnv(32, width=5, height=4, slip_prob=0.0,
                          player_b_policy=get_stand_policy(761))
    assert env.agents == ["player_a"]
    obs, _ = env.reset(seed=5)
    assert isinstance(obs, np.ndarray) and obs.shape == (32,)
    total, goals = 0.0, 0
    for _ in range(120):
        obs, rew, done, trunc, infos = env.step(np.full(32, 3))  # all EAST
        assert set(rew) == {"player_a"}
        total += rew["player_a"].sum()
        goals += int(done["player_a"].sum())
    assert goals > 50 and total > 0


def test_single_agent_mode_frozen_a_sign_flip():
    """Learner B marching WEST against a frozen standing A scores into the
    LEFT goal: A-perspective reward is -1, so B — whose rewards are the
    negation (:242-244, :400-402) — must see a POSITIVE return."""
    from gym_soccer_tpu.utils.policies import get_stand_policy
    env = SoccerVectorEnv(32, width=5, height=4, slip_prob=0.0,
                          player_a_policy=get_stand_policy(761))
    obs, _ = env.reset(seed=9)
    assert env.agents == ["player_b"]
    total, goals = 0.0, 0
    for _ in range(120):
        obs, rew, done, trunc, infos = env.step(np.full(32, 4))  # all WEST
        total += rew["player_b"].sum()
        goals += int(done["player_b"].sum())
    assert goals > 50 and total > 0


def test_action_validation(venv):
    venv.reset(seed=1)
    with pytest.raises(ValueError):
        venv.step(np.zeros(N, np.int32))  # multiagent needs a dict
    with pytest.raises(ValueError):
        venv.step({"player_a": np.full(N, 7),  # out-of-range action
                   "player_b": np.zeros(N, np.int64)})
    with pytest.raises(ValueError):
        venv.step({"player_a": np.zeros(N)})  # missing player_b
    env1 = SoccerVectorEnv(8, width=5, height=4)
    with pytest.raises(RuntimeError):
        env1.step({"player_a": np.zeros(8)})  # step before reset
    with pytest.raises(ValueError):
        SoccerVectorEnv(8, player_a_policy=np.zeros(761, np.int32),
                        player_b_policy=np.zeros(761, np.int32))


def test_step_info_p(venv):
    """info['p'] reports the sampled transition's probability rounded to 2
    decimals (reference :405).  At slip 0.2 every unmerged-entry probability
    is a product of combo probs {0.64, 0.08, 0.01} and outcome weights
    {1, 0.5, 0.25}."""
    venv.reset(seed=2)
    rng = np.random.RandomState(3)
    allowed = set()
    for cp in (0.64, 0.08, 0.01):
        for w in (1.0, 0.5, 0.25):
            allowed.add(round(cp * w, 2))
    seen = set()
    for _ in range(30):
        acts = {"player_a": rng.randint(0, 5, N),
                "player_b": rng.randint(0, 5, N)}
        _, _, _, _, infos = venv.step(acts)
        assert infos["p"].shape == (N,)
        seen.update(np.unique(infos["p"]).tolist())
    assert seen <= allowed, f"unexpected probs {seen - allowed}"
    assert 0.64 in seen  # the no-slip no-collision case dominates


def test_per_env_seed_list():
    """gym.vector-style per-env seed lists: same list => same trajectories;
    permuting the list permutes the lanes (placement-invariance)."""
    seeds = [5, 6, 7, 8] * 4
    env = SoccerVectorEnv(16, width=5, height=4, slip_prob=0.2)
    a, _ = env.reset(seed=seeds)
    rng = np.random.RandomState(0)
    acts = [{"player_a": rng.randint(0, 5, 16),
             "player_b": rng.randint(0, 5, 16)} for _ in range(20)]
    tr_a = np.stack([env.step(ac)[0]["player_a"] for ac in acts])

    b, _ = env.reset(seed=seeds)
    assert np.array_equal(a["player_a"], b["player_a"])
    tr_b = np.stack([env.step(ac)[0]["player_a"] for ac in acts])
    assert np.array_equal(tr_a, tr_b)

    with pytest.raises(ValueError):
        env.reset(seed=[1, 2, 3])  # wrong length

    # identical per-env seeds (and identical actions) replay identical
    # per-lane streams: lanes 0 and 4 share seed 5
    env2 = SoccerVectorEnv(16, width=5, height=4, slip_prob=0.2)
    env2.reset(seed=seeds)
    same_acts = [{"player_a": np.full(16, ac["player_a"][0]),
                  "player_b": np.full(16, ac["player_b"][0])}
                 for ac in acts]
    tr = np.stack([env2.step(ac)[0]["player_a"] for ac in same_acts])
    assert np.array_equal(tr[:, 0], tr[:, 4])
    assert np.array_equal(tr[:, 1], tr[:, 5])


def test_max_steps_truncation_horizon():
    """A non-default max_steps truncates end-to-end (the registration
    horizon must actually apply)."""
    env = SoccerVectorEnv(8, width=5, height=4, slip_prob=0.0, max_steps=7)
    env.reset(seed=0)
    noop = {"player_a": np.zeros(8, np.int64),
            "player_b": np.zeros(8, np.int64)}
    for i in range(7):
        _, _, done, trunc, _ = env.step(noop)
        assert not done["player_a"].any()
        assert trunc["player_a"].all() == (i == 6)


def test_episode_stats_accumulation():
    """utils/metrics wiring: counts since reset() are exact and exclusive
    (goals + truncations == episodes)."""
    env = SoccerVectorEnv(32, width=5, height=4, slip_prob=0.2, max_steps=25)
    env.reset(seed=1)
    rng = np.random.RandomState(4)
    manual_eps = 0
    for _ in range(60):
        acts = {"player_a": rng.randint(0, 5, 32),
                "player_b": rng.randint(0, 5, 32)}
        _, _, done, trunc, _ = env.step(acts)
        manual_eps += int((done["player_a"] | trunc["player_a"]).sum())
    s = env.episode_stats
    assert int(s.episodes) == manual_eps > 0
    assert int(s.goals) + int(s.truncations) == int(s.episodes)
    assert int(s.wins_a) + int(s.wins_b) == int(s.goals)
    assert int(s.steps) == 60 * 32
    assert 0 < s.mean_length <= 25
    env.reset()
    assert int(env.episode_stats.episodes) == 0


def test_reset_semantics_reseed_vs_continue():
    """Explicit seed => identical restart; bare reset() => fresh episodes."""
    env = SoccerVectorEnv(16, width=5, height=4, slip_prob=0.2)
    a, _ = env.reset(seed=4)

    def advance(env, n=10):
        rng = np.random.RandomState(2)
        for _ in range(n):
            obs, *_ = env.step({"player_a": rng.randint(0, 5, 16),
                                "player_b": rng.randint(0, 5, 16)})
        return obs

    t1 = advance(env)
    b, _ = env.reset()           # continue the stream: new episodes
    t2 = advance(env)
    c, _ = env.reset(seed=4)     # reseed: replay exactly
    assert np.array_equal(a["player_a"], c["player_a"])
    t3 = advance(env)
    assert np.array_equal(t1["player_a"], t3["player_a"])
    assert not np.array_equal(t1["player_a"], t2["player_a"])
