"""Smoke test for the scaling-efficiency bench harness (tools/bench_scaling).

The harness answers BASELINE.json's ">=0.8 linear efficiency at N>=2"
north star.  This validates that the sweep runs end-to-end on the
virtual 8-device CPU mesh (the same sharded code paths the GPUs run,
with the fused chunks on their XLA twin) and emits well-formed
throughput + efficiency rows; the proxy numbers themselves are not gated
(all virtual devices share the host's cores).
"""
import jax
import pytest

from tools.bench_scaling import sweep


def test_scaling_sweep_smoke():
    if len(jax.devices()) < 2:
        pytest.skip("needs >=2 devices")
    rows = sweep([1, 2], envs_per_device=64, n_steps=10, reps=1)

    assert {r["path"] for r in rows} == {"rollout", "minimax_train",
                                         "fused_learner_chunk",
                                         "sharded_solve"}
    assert {r["n_devices"] for r in rows} == {1, 2}
    for r in rows:
        assert r["steps_per_s"] > 0
        if r["path"] == "fused_learner_chunk":
            # clamped to the fused chunk's 128-lane minimum per device
            assert r["n_envs"] == 128 * r["n_devices"]
        elif r["path"] == "sharded_solve":
            assert r["n_envs"] == 761  # strong scaling: fixed state count
        else:
            assert r["n_envs"] == 64 * r["n_devices"]
    effs = [r["efficiency_vs_linear"] for r in rows]
    assert len(effs) == len(rows)  # every row got an efficiency
    assert all(e > 0 for e in effs)
    # 1-device rows define the linear baseline
    assert all(r["efficiency_vs_linear"] == 1.0 for r in rows
               if r["n_devices"] == 1)
