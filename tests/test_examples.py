"""The shipped examples run end-to-end (subprocess smoke; the demos ARE
the reference main() equivalent and the alternating capability demo, so
CI proves the user-facing entry points, not just the library)."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORCE_CPU = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
             "import sys, runpy; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")


def _run(script, *args):
    out = subprocess.run(
        [sys.executable, "-c", FORCE_CPU, os.path.join(ROOT, script), *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _events(stdout):
    return {e.get("event", e.get("phase")): e
            for e in (json.loads(ln) for ln in stdout.splitlines()
                      if ln.startswith("{"))}


def test_demo_main_equivalent():
    """examples/demo.py reproduces the reference main() contract: all
    four planners agree (asserted inside the demo) and the VI policy's
    1000-episode eval wins every game vs the frozen random opponent."""
    stdout = _run("examples/demo.py")
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("All 1000 episodes finished")]
    assert line, stdout[-1000:]
    avg_reward = float(line[0].split("average reward ")[1].split(" ")[0])
    assert avg_reward > 0.9
    assert "eval_1000_episodes" in _events(stdout)


def test_alternating_demo():
    events = _events(_run("examples/alternating_demo.py", "--quick"))
    assert events["tables"]["nS"] == 1521
    assert events["best_response_vs_random"]["losses"] == 0
    assert events["best_response_vs_random"]["win_rate"] > 0.95


def test_train_best_response_example():
    """--best-response trains the reference's single-agent shape (frozen
    random opponent) end-to-end on the fused learner and reports the gap
    to the exact best-response value."""
    ev = _events(_run("examples/train_minimax.py",
                      "--best-response", "player_a", "--backend", "xla",
                      "--steps", "1280", "--envs", "512"))
    fin = ev["finished_best_response"]
    assert fin["side"] == "player_a"
    assert fin["env_steps"] == 1280 * 512
    assert fin["mean_gap_to_exact_br"] < 1.0   # smoke: field exists + sane
    assert "eval_episode_stats" in ev


def test_train_fused_checkpoint_resume(tmp_path):
    """The flagship fused trainer checkpoints and resumes exactly:
    a second invocation with a larger --steps picks up at the saved
    chunk (XLA twin, tiny batch)."""
    ck = str(tmp_path / "fused_ck.npz")
    ev1 = _events(_run("examples/train_minimax.py", "--fused",
                       "--backend", "xla", "--steps", "128", "--envs", "256",
                       "--ckpt", ck))
    assert ev1["checkpointed"]["chunk"] == 2
    assert "resumed_fused" not in ev1
    ev2 = _events(_run("examples/train_minimax.py", "--fused",
                       "--backend", "xla", "--steps", "256", "--envs", "256",
                       "--ckpt", ck))
    assert ev2["resumed_fused"]["chunk"] == 2
    # The resumed segment reuses the FIRST segment's anneal anchor
    # (n_chunks//2 of the original invocation), so the composite run's
    # lr schedule is self-consistent across segments.
    assert ev2["resumed_fused"]["lr_anneal_start"] == 1
    assert ev2["checkpointed"]["chunk"] == 4
    assert ev2["finished_fused"]["env_steps"] == 2 * 64 * 256
    # Re-running with the same --steps is a no-op, not an extra chunk.
    ev3 = _events(_run("examples/train_minimax.py", "--fused",
                       "--backend", "xla", "--steps", "256", "--envs", "256",
                       "--ckpt", ck))
    assert ev3["already_complete"]["chunk"] == 4
    assert "finished_fused" not in ev3
