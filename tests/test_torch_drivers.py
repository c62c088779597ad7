"""The port's run drivers against the JAX package's scripts, on the CPU.

`anakin_breakout_train`, `anakin_r2d2_train`, `eval_anakin_replay`,
`evaluate` and `long_run` at the port package's root are the
counterparts of `scripts/<same name>.py`:

- argv: each parses its JAX script's own argv to the same fields, with
  `device` where the JAX script has `platform`;
- the Breakout driver writes the `config.json` of the JAX script, key
  for key, at the same small argv, and its LR horizon is the JAX
  script's (`scripts/anakin_breakout_train.py:118-121`);
- short runs of both Anakin drivers (2 envs, LSTM 16): the JAX rows'
  keys, frames counted as JAX counts them, checkpoints with `frames` and
  `chunk` (and R2D2's `episodes_per_env`), and `--resume` going on at the
  next chunk from the saved parameters bit for bit; R2D2's counters
  restored, its warm-up run again, its ring priced as it is allocated
  and a ring too large refused without naming a TPU;
- `eval_anakin_replay` on port checkpoints of both replay families: the
  JAX keys and the mean pooled by episode;
- `evaluate` on a `train_local` checkpoint (the twin of
  `tests/test_launch.py::test_train_local_checkpoints_and_evaluate`);
- `long_run`: two child processes that resume one another, the JAX
  records' keys, the driver resuming from its JSONL, `STOP`, and the
  abort after 3 failed children.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu_torch import (
    anakin_breakout_train, anakin_r2d2_train, eval_anakin_replay, evaluate, long_run,
    train_apex, train_r2d2)
from distributed_reinforcement_learning_tpu_torch.envs import breakout_device
from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2
from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local
from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _jax_script(name: str):
    """`scripts/<name>.py` as a module (it puts the repo root on sys.path)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _namespace(main, argv: list[str], monkeypatch) -> dict:
    """The fields `main` parses from `argv` (stopped right after parsing)."""
    orig = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        m.setattr(sys, "argv", ["script", *argv])
        with pytest.raises(_Parsed) as got:
            main()
    return dict(vars(got.value.args[0]))


ARGV = {
    "anakin_breakout_train": [
        "--out", "o", "--env", "pong", "--num-envs", "8", "--trajectory", "10",
        "--updates-per-chunk", "3", "--total-frames", "1000", "--num-actions", "9",
        "--lstm", "32", "--entropy", "0.02", "--baseline-coef", "0.25", "--lr", "1e-3",
        "--end-lr", "1e-5", "--learning-frames", "500", "--reward-clip", "none",
        "--clip-norm", "10", "--torso", "resnet", "--torso-width", "2", "--seed", "3",
        "--platform", "cpu", "--f32", "--checkpoint-every", "2", "--eval-every", "4",
        "--eval-envs", "3", "--eval-steps", "7", "--resume"],
    "anakin_r2d2_train": [
        "--out", "o", "--env", "pong", "--num-envs", "8", "--seq-len", "12", "--burn-in", "4",
        "--lstm", "32", "--capacity", "100", "--batch-size", "16", "--updates-per-collect", "3",
        "--updates-per-chunk", "5", "--total-frames", "999", "--lr", "3e-4", "--discount", "0.99",
        "--priority-eta", "-1", "--adam-clip", "5", "--target-sync", "50", "--epsilon-decay",
        "0.2", "--epsilon-floor", "0.05", "--warmup-collects", "2", "--seed", "4",
        "--platform", "cpu", "--f32", "--checkpoint-every", "3", "--eval-every", "2",
        "--eval-envs", "5", "--eval-steps", "11", "--resume"],
    "eval_anakin_replay": [
        "--algo", "r2d2", "--config", "c.json", "--section", "r2d2", "--checkpoint_dir", "ck",
        "--eval-envs", "3", "--eval-steps", "9", "--seeds", "2", "--platform", "cpu"],
    "evaluate": [
        "--config", "c.json", "--section", "r2d2", "--checkpoint_dir", "ck", "--episodes", "3",
        "--max_unrolls", "9", "--seed", "5", "--platform", "cpu"],
    "long_run": [
        "--config", "c.json", "--section", "impala_cartpole", "--out", "o.jsonl", "--chunk", "4",
        "--max-updates", "8", "--checkpoint-interval", "2", "--seed", "1", "--ckpt-dir", "ck"],
}
PORT = {"anakin_breakout_train": anakin_breakout_train, "anakin_r2d2_train": anakin_r2d2_train,
        "eval_anakin_replay": eval_anakin_replay, "evaluate": evaluate, "long_run": long_run}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_each_driver_parses_the_jax_argv_to_the_same_fields(name, monkeypatch):
    argv = ARGV[name]
    want = _namespace(_jax_script(name).main, argv, monkeypatch)
    got = _namespace(PORT[name].main, argv, monkeypatch)
    assert got.pop("device") == want.pop("platform", None)
    assert got == want
    # --device is the port's spelling of --platform (long_run adds it).
    spelled = [("--device" if a == "--platform" else a) for a in argv]
    if "--device" not in spelled:
        spelled += ["--device", "cpu"]
    assert PORT[name].parse_args(spelled).device == "cpu"


def test_breakout_driver_writes_the_jax_config_and_lr_horizon(tmp_path, monkeypatch):
    """At one small argv the two drivers' config.json agree key for key
    (`out` aside), and so does the LR horizon in optimizer updates. The
    JAX side stops before its env and parameters are built (`init`
    stubbed): `--total-frames 0` runs no chunk."""
    from distributed_reinforcement_learning_tpu.agents import impala as jax_impala
    from distributed_reinforcement_learning_tpu.runtime import anakin as jax_anakin

    argv = ["--num-envs", "2", "--lstm", "16", "--trajectory", "4", "--total-frames", "0",
            "--learning-frames", "1000"]
    seen = {}
    jax_init = jax_impala.ImpalaAgent.__init__

    def record_cfg(self, cfg, *a, **k):
        seen["cfg"] = cfg
        jax_init(self, cfg, *a, **k)

    monkeypatch.setattr(jax_impala.ImpalaAgent, "__init__", record_cfg)
    monkeypatch.setattr(jax_anakin.AnakinImpala, "init", lambda self, key: None)
    monkeypatch.setattr(sys, "argv", ["script", "--out", str(tmp_path / "jax"), *argv,
                                      "--platform", "cpu"])
    _jax_script("anakin_breakout_train").main()
    got = anakin_breakout_train.main(["--out", str(tmp_path / "port"), *argv, "--device", "cpu"])

    want = json.loads((tmp_path / "jax" / "config.json").read_text())
    port = json.loads((tmp_path / "port" / "config.json").read_text())
    assert want.pop("out") != port.pop("out")
    assert port == want
    assert port["dtype"] == "float32" and port["platform"] == "cpu"
    assert got["rows"] == [] and not (tmp_path / "port" / "progress.jsonl").exists()
    assert got["anakin"].agent.cfg.learning_frame == seen["cfg"].learning_frame == 1000 // 8
    assert got["anakin"].agent.cfg.fold_normalize and seen["cfg"].fold_normalize


IMPALA_ROW = {"chunk", "updates", "frames", "fps", "chunk_s", "total_loss", "entropy",
              "grad_norm", "lr", "return_sum", "episodes", "mean_return", "boundaries", "wall_s",
              "eval_mean_return", "eval_episodes", "eval_s", "checkpoint"}
R2D2_ROW = (IMPALA_ROW - {"total_loss", "entropy", "lr"}) | {"loss", "epsilon", "replay_size"}


def _params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.train.params.items()}


def _spy_restore(monkeypatch) -> list:
    """Record the parameters every `Checkpointer.restore` hands back."""
    restored = []
    orig = Checkpointer.restore

    def spy(self, template, step=None):
        got = orig(self, template, step)
        if got is not None:
            restored.append(({k: v.detach().clone() for k, v in got[0].params.items()}, got[2]))
        return got

    monkeypatch.setattr(Checkpointer, "restore", spy)
    return restored


def _bit_equal(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_breakout_driver_runs_checkpoints_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "run"
    base = ["--out", str(out), "--num-envs", "2", "--trajectory", "4", "--lstm", "16",
            "--updates-per-chunk", "2", "--eval-every", "1", "--eval-envs", "2",
            "--eval-steps", "5", "--checkpoint-every", "1", "--device", "cpu"]
    fpc = 2 * 4 * 2  # num_envs x trajectory x updates a chunk
    seeds = []
    orig_eval = AnakinImpala.greedy_eval

    def eval_spy(self, params, num_envs, num_steps, seed=0):
        seeds.append(seed)
        return orig_eval(self, params, num_envs, num_steps, seed)

    monkeypatch.setattr(AnakinImpala, "greedy_eval", eval_spy)
    first = anakin_breakout_train.main([*base, "--total-frames", str(2 * fpc)])
    rows = first["rows"]
    assert [set(r) for r in rows] == [IMPALA_ROW, IMPALA_ROW]
    assert [(r["chunk"], r["updates"], r["frames"], r["checkpoint"]) for r in rows] == [
        (1, 2, fpc, 2), (2, 4, 2 * fpc, 4)]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    assert first["anakin"].agent.cfg.learning_frame == 2 * fpc // 8  # horizon = total frames
    lines = [json.loads(x) for x in (out / "progress.jsonl").read_text().splitlines()]
    assert lines == rows
    ck = Checkpointer(out / "ckpt")
    assert ck.steps() == [2, 4]
    assert json.loads((out / "ckpt" / "ckpt_0000000004.extra.json").read_text()) == {
        "frames": 2 * fpc, "chunk": 2}
    saved = _params(first["state"])

    restored = _spy_restore(monkeypatch)
    again = anakin_breakout_train.main([*base, "--total-frames", str(3 * fpc), "--resume"])
    assert len(restored) == 1 and restored[0][1] == 4
    assert _bit_equal(restored[0][0], saved)
    assert [(r["chunk"], r["updates"], r["frames"]) for r in again["rows"]] == [(3, 6, 3 * fpc)]
    assert set(again["rows"][0]) == IMPALA_ROW
    assert len((out / "progress.jsonl").read_text().splitlines()) == 3
    # Each eval is seeded by its chunk, so the resumed run's eval draws anew.
    assert seeds == [1001, 1002, 1003]


def test_r2d2_driver_runs_restores_counters_and_refuses_a_large_ring(tmp_path, monkeypatch):
    out = tmp_path / "run"
    base = ["--out", str(out), "--num-envs", "2", "--seq-len", "4", "--burn-in", "2",
            "--lstm", "16", "--capacity", "9", "--batch-size", "4", "--updates-per-collect", "2",
            "--updates-per-chunk", "2", "--warmup-collects", "2", "--eval-every", "1",
            "--eval-envs", "2", "--eval-steps", "5", "--checkpoint-every", "1", "--device", "cpu"]
    fpu = 2 * 4  # num_envs x seq_len
    warm_starts = []
    orig_collect = AnakinR2D2.collect_chunk

    def spy_collect(self, state, n):
        warm_starts.append(state.episodes.clone())
        return orig_collect(self, state, n)

    monkeypatch.setattr(AnakinR2D2, "collect_chunk", spy_collect)
    first = anakin_r2d2_train.main([*base, "--total-frames", str(2 * fpu + 2 * 2 * fpu)])
    rows = first["rows"]
    assert [set(r) for r in rows] == [R2D2_ROW, R2D2_ROW]
    # Frames count the warm-up collects, then each chunk's (JAX's accounting).
    assert [(r["chunk"], r["updates"], r["frames"], r["replay_size"]) for r in rows] == [
        (1, 4, 2 * fpu + 2 * fpu, 8), (2, 8, 2 * fpu + 4 * fpu, 8)]
    assert first["config"]["capacity"] == 8  # aligned to num_envs
    state = first["state"]
    assert state.replay.nbytes() == anakin_r2d2_train.ring_bytes(
        8, 4, breakout_device.OBS_SHAPE, 16)
    extra_path = out / "ckpt" / "ckpt_0000000008.extra.json"
    extra = json.loads(extra_path.read_text())
    assert extra == {"frames": 6 * fpu, "chunk": 2,
                     "episodes_per_env": state.episodes.tolist()}
    # A counter state a long run would reach, so that its restore shows.
    extra["episodes_per_env"] = [3, 7]
    extra_path.write_text(json.dumps(extra))
    saved = _params(state)

    restored = _spy_restore(monkeypatch)
    warm_starts.clear()
    again = anakin_r2d2_train.main([*base, "--total-frames", str(6 * fpu + 2 * fpu + 2 * fpu),
                                    "--resume"])
    assert _bit_equal(restored[0][0], saved) and restored[0][1] == 8
    # The warm-up ran again, from the restored counters.
    assert len(warm_starts) == 1 and warm_starts[0].tolist() == [3, 7]
    assert warm_starts[0].dtype == torch.int32
    (row,) = again["rows"]
    assert (row["chunk"], row["updates"], row["frames"]) == (3, 12, 10 * fpu)
    assert row["replay_size"] == 8
    assert row["epsilon"] < 1.0  # 1 / (0.1 * episodes + 1) below 1 from [3, 7]

    with pytest.raises(SystemExit) as refused:
        anakin_r2d2_train.main(["--out", str(tmp_path / "big"), "--capacity", str(10**9),
                                "--device", "cpu"])
    message = str(refused.value)
    assert "GiB" in message and "free on cpu" in message
    assert "TPU" not in message and "v5e" not in message and "HBM" not in message
    assert not (tmp_path / "big").exists()
    with pytest.raises(SystemExit):
        anakin_r2d2_train.main(["--out", str(tmp_path / "few"), "--capacity", "1",
                                "--num-envs", "2", "--device", "cpu"])


_APEX_CARTPOLE = {
    "num_actors": 1, "env": ["CartPole-v0"], "available_action": [2], "envs_per_actor": 4,
    "model_input": [4], "model_output": 2, "batch_size": 16, "replay_capacity": 2000,
    "target_sync_interval": 10, "start_learning_rate": 0.001,
}

JAX_EVAL_KEYS = {"algo", "section", "train_step", "greedy_mean_return", "per_seed", "episodes",
                 "eval_envs", "eval_steps"}


@pytest.mark.parametrize("algo", ["apex", "r2d2"])
def test_eval_anakin_replay_pools_by_episode(algo, tmp_path, monkeypatch, capsys):
    config = tmp_path / "config.json"
    sections = json.loads(CONFIG.read_text())
    config.write_text(json.dumps({"apex_cartpole": _APEX_CARTPOLE, "r2d2": sections["r2d2"]}))
    section = "apex_cartpole" if algo == "apex" else "r2d2"
    ckpt = tmp_path / "ckpt"
    train = train_apex if algo == "apex" else train_r2d2
    train.main(["--config", str(config), "--section", section, "--mode", "anakin", "--updates",
                "2", "--checkpoint_dir", str(ckpt), "--device", "cpu"])
    step = Checkpointer(ckpt).latest_step()
    assert step >= 2
    capsys.readouterr()

    argv = ["--algo", algo, "--config", str(config), "--section", section, "--checkpoint_dir",
            str(ckpt), "--eval-envs", "4", "--eval-steps", "40", "--seeds", "2", "--device", "cpu"]
    out = eval_anakin_replay.main(argv)
    assert set(out) == JAX_EVAL_KEYS
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["train_step"] == step and out["episodes"] > 0 and len(out["per_seed"]) == 2

    # Pooled by episode, not by seed: canned rollouts of 1 and 3 games.
    canned = iter([{"mean_return": 10.0, "episodes": 1}, {"mean_return": 20.0, "episodes": 3}])
    from distributed_reinforcement_learning_tpu_torch.runtime import anakin_apex, anakin_r2d2

    loop_cls = anakin_apex.AnakinApex if algo == "apex" else anakin_r2d2.AnakinR2D2
    monkeypatch.setattr(loop_cls, "greedy_eval", lambda self, *a: next(canned))
    pooled = eval_anakin_replay.main(argv)
    assert pooled["greedy_mean_return"] == 17.5 and pooled["per_seed"] == [10.0, 20.0]
    assert pooled["episodes"] == 4


def test_evaluate_restores_a_train_local_checkpoint(tmp_path):
    """Twin of tests/test_launch.py::test_train_local_checkpoints_and_evaluate."""
    ckpt_dir = tmp_path / "ckpts"
    result = train_local(str(CONFIG), "impala_cartpole", num_updates=4, device="cpu",
                         checkpoint_dir=str(ckpt_dir), checkpoint_interval=2)
    assert result["frames"] == 4 * 16 * 16
    assert Checkpointer(ckpt_dir).steps() == [2, 4]
    out = evaluate.main(["--config", str(CONFIG), "--section", "impala_cartpole",
                         "--checkpoint_dir", str(ckpt_dir), "--episodes", "2",
                         "--max_unrolls", "200", "--device", "cpu"])
    assert set(out) == {"section", "algorithm", "checkpoint_step", "episodes", "return_mean",
                        "return_std", "return_min", "return_max", "unrolls"}
    assert out["checkpoint_step"] == 4
    assert out["episodes"] == 2
    assert out["return_mean"] > 0


JAX_LONG_RUN_KEYS = {"updates", "frames_total", "chunk_frames", "wall_s", "frames_per_s",
                     "max_rss_mb", "episodes", "mean_return", "last20", "returns", "t"}


def _records(path: Path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_long_run_resumes_children_stops_and_aborts(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "runs" / "cartpole.jsonl"
    argv = ["--config", str(CONFIG), "--section", "impala_cartpole", "--out", str(out),
            "--chunk", "4", "--checkpoint-interval", "4", "--device", "cpu"]
    long_run.main([*argv, "--max-updates", "8"])
    recs = _records(out)
    assert [set(r) for r in recs] == [JAX_LONG_RUN_KEYS, JAX_LONG_RUN_KEYS]
    assert [r["updates"] for r in recs] == [4, 8]
    # The second child resumed from the first's checkpoint: it trained 4
    # updates (4 x 16 x 16 frames), not 8.
    assert [r["chunk_frames"] for r in recs] == [1024, 1024]
    assert recs[-1]["frames_total"] == 2048
    assert all(r["max_rss_mb"] > 0 for r in recs)
    assert Checkpointer(out.parent / "ckpt_cartpole").latest_step() == 8

    # The driver resumes from its own records: nothing is left to do.
    long_run.main([*argv, "--max-updates", "8"])
    assert len(_records(out)) == 2
    # STOP beside --out halts it before the next child.
    (out.parent / "STOP").write_text("")
    long_run.main([*argv, "--max-updates", "12"])
    assert len(_records(out)) == 2

    sleeps = []
    monkeypatch.setattr(long_run.time, "sleep", sleeps.append)
    bad = tmp_path / "bad" / "x.jsonl"
    with pytest.raises(SystemExit) as aborted:
        long_run.main(["--config", str(CONFIG), "--section", "no_such_section", "--out",
                       str(bad), "--chunk", "2", "--max-updates", "4", "--device", "cpu"])
    assert aborted.value.code == 1
    assert sleeps == [long_run.RETRY_SLEEP_S] * 2
    errs = _records(bad)
    assert len(errs) == 3 and all(r["error"] == "child rc=1" and r["updates"] == 0 for r in errs)
