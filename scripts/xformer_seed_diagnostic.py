"""Feed the PyTorch port's Transformer-R2D2 learning run the JAX run's
random numbers, to tell a learning difference from seed luck.

The runs are those of `tests/test_e2e.py::test_xformer_trains_cartpole_pomdp`
and its port twin `tests/test_torch_xformer_learns.py` (d_model 32, 2
heads, 2 layers, seq_len 10, burn-in 5, Adam 2e-3, batch 16, 8 CartPole
POMDP envs, target sync every 20, 600 updates). For each seed:

- `jax`: the JAX test's run as it is (its own PRNG streams);
- `jax_fed`: the JAX run with its epsilon-greedy draws taken from a numpy
  stream (`RandomState(10_000 + seed)`: one uniform and one random action
  per env and act call); it records its initial parameters and the
  replay indices and IS weights of every train step;
- `port_fed`: the port from the JAX run's initial parameters (converted),
  with the same numpy exploration stream, and every train step forced to
  the JAX run's sample indices and IS weights.

Where the two packages learn alike, `port_fed` follows `jax_fed`: the
greedy actions agree act for act until float rounding flips an argmax.
The script prints one JSON line a seed: the late-20 returns of the three
runs, the first act call whose greedy actions differ, the share of agreeing
greedy actions, and how often the port's own stratified draw picked the
JAX run's indices.

    JAX_PLATFORMS=cpu python scripts/xformer_seed_diagnostic.py --seed 0

`--spread` measures instead how far the return moves with the seed: it
runs the twin configuration in both packages on their own streams (the
JAX test's run; the port test's run, parameters from `init_seed=seed`,
replay from `RandomState(0)`) for every seed of `--seeds`, `--jobs`
processes at a time, one thread each. It prints one JSON line a run, then
a summary: each package's late-20 returns, mean and standard deviation,
the share of seeds above the per-seed bar (25), the share of 3-seed
windows (consecutive seeds, and all 3-seed subsets) whose mean clears
60, and the decision of the rule "the port's mean lies below JAX's by
more than twice the standard error of the difference".

    JAX_PLATFORMS=cpu python scripts/xformer_seed_diagnostic.py --spread \
        --seeds 0-15 --jobs 6

Runs on the CPU (one torch thread); imports both packages.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UPDATES = 600
CFG = dict(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, d_model=32, num_heads=2,
           num_layers=2, learning_rate=2e-3)
LEARNER = dict(batch_size=16, replay_capacity=5_000, target_sync_interval=20)


def _fed_choice(q: np.ndarray, eps: np.ndarray, draws: np.random.RandomState):
    greedy = q.argmax(-1)
    u = draws.uniform(size=greedy.shape)
    rand = draws.randint(0, CFG["num_actions"], size=greedy.shape)
    return np.where(u <= np.asarray(eps, np.float32), rand, greedy).astype(np.int32), greedy


def run_jax(seed: int, fed: bool, updates: int) -> dict:
    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu.agents.xformer import XformerAgent, XformerConfig
    from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu.envs.cartpole import VectorCartPole, pomdp_project
    from distributed_reinforcement_learning_tpu.runtime import xformer_runner
    from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore

    agent = XformerAgent(XformerConfig(**CFG))
    log: dict = {"greedy": [], "samples": []}
    if fed:
        draws = np.random.RandomState(10_000 + seed)
        jit_act = agent.act

        def act(params, obs, pa, done, eps, rng):
            _, q = jit_act(params, obs, pa, done, eps, rng)
            action, greedy = _fed_choice(np.asarray(q), np.asarray(eps), draws)
            log["greedy"].append(greedy)
            return jnp.asarray(action), q

        agent.act = act
    queue, weights = TrajectoryQueue(capacity=128), WeightStore()
    learner = xformer_runner.XformerLearner(agent, queue, weights, rng=jax.random.PRNGKey(seed),
                                            **LEARNER)
    log["init"] = jax.tree.map(np.asarray, learner.state.params)
    if fed:
        sample = learner.replay.sample

        def recorded(n, rng):
            out = sample(n, rng)
            log["samples"].append((np.asarray(out[1]).copy(), np.asarray(out[2]).copy()))
            return out

        learner.replay.sample = recorded
    actor = xformer_runner.XformerActor(agent, VectorCartPole(num_envs=8, seed=seed), queue,
                                        weights, seed=seed + 1, obs_transform=pomdp_project)
    result = xformer_runner.run_sync(learner, [actor], num_updates=updates)
    log["late20"] = float(np.mean(result["episode_returns"][-20:]))
    return log


def run_port_fed(seed: int, ref: dict, updates: int) -> dict:
    import torch

    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, tree_map
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
        VectorCartPole, pomdp_project)
    from distributed_reinforcement_learning_tpu_torch.models.convert import (
        transformer_params_from_jax)
    from distributed_reinforcement_learning_tpu_torch.runtime import xformer_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    torch.set_num_threads(1)
    agent = XformerAgent(XformerConfig(**CFG), device="cpu")
    draws = np.random.RandomState(10_000 + seed)
    out: dict = {"greedy": [], "own_idx_agree": []}
    model_act = agent.act

    def act(params, obs, pa, done, eps, generator):
        _, q = model_act(params, obs, pa, done, eps, generator)
        action, greedy = _fed_choice(q.numpy(), eps.numpy(), draws)
        out["greedy"].append(greedy)
        return torch.from_numpy(action), q

    agent.act = act
    queue, weights = TrajectoryQueue(capacity=128), WeightStore()
    learner = xformer_runner.XformerLearner(agent, queue, weights, init_seed=seed, **LEARNER)
    learner.state = agent.sync_target(agent.state_from_params(
        transformer_params_from_jax(ref["init"])))
    weights.publish(learner.state.params, 0)
    replay = learner.replay
    sample = replay.sample
    feed = iter(ref["samples"])
    cap = replay.tree.capacity

    def forced(n, rng):
        _, idxs, _ = sample(n, rng)  # keeps beta and the draw stream in step
        jidx, jw = next(feed)
        out["own_idx_agree"].append(float(np.mean(np.asarray(idxs) == jidx)))
        slots = jidx - (cap - 1)
        return tree_map(lambda s: s[slots], replay._store), jidx, jw

    replay.sample = forced
    actor = xformer_runner.XformerActor(agent, VectorCartPole(num_envs=8, seed=seed), queue,
                                        weights, seed=seed + 1, obs_transform=pomdp_project)
    result = xformer_runner.run_sync(learner, [actor], num_updates=updates)
    out["late20"] = float(np.mean(result["episode_returns"][-20:]))
    return out


def run_port(seed: int, updates: int) -> float:
    """The port test's run (tests/test_torch_xformer_learns.py) for one seed."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
        VectorCartPole, pomdp_project)
    from distributed_reinforcement_learning_tpu_torch.runtime import xformer_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    torch.set_num_threads(1)
    agent = XformerAgent(XformerConfig(**CFG), device="cpu")
    queue, weights = TrajectoryQueue(capacity=128), WeightStore()
    learner = xformer_runner.XformerLearner(agent, queue, weights, init_seed=seed, **LEARNER)
    actor = xformer_runner.XformerActor(agent, VectorCartPole(num_envs=8, seed=seed), queue,
                                        weights, seed=seed + 1, obs_transform=pomdp_project)
    result = xformer_runner.run_sync(learner, [actor], num_updates=updates)
    return float(np.mean(result["episode_returns"][-20:]))


def _seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def spread_summary(returns: dict[str, list[float]], bar: float = 25.0,
                   mean_bar: float = 60.0) -> dict:
    """Each package's spread, the 3-seed window shares and the rule's
    decision from the per-seed late-20 returns (seed order)."""
    out: dict = {}
    for pkg, r in returns.items():
        a = np.asarray(r, np.float64)
        windows = [np.mean(a[i:i + 3]) > mean_bar for i in range(len(a) - 2)]
        subsets = [np.mean(c) > mean_bar for c in itertools.combinations(a, 3)]
        out[pkg] = {"late20": [round(float(x), 2) for x in a], "mean": float(a.mean()),
                    "std": float(a.std(ddof=1)), "share_above_bar": float(np.mean(a > bar)),
                    "share_consecutive_windows_clear": float(np.mean(windows)),
                    "share_3_subsets_clear": float(np.mean(subsets))}
    j, p = out["jax"], out["port"]
    se = float(np.sqrt(j["std"] ** 2 / len(returns["jax"])
                       + p["std"] ** 2 / len(returns["port"])))
    diff = p["mean"] - j["mean"]
    out["rule"] = {"port_minus_jax": diff, "se_difference": se,
                   "divergence": bool(diff < -2 * se)}
    return out


def spread(seeds: list[int], jobs: int, updates: int) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    runs = [(pkg, s) for s in seeds for pkg in ("jax", "port")]
    returns: dict[str, dict[int, float]] = {"jax": {}, "port": {}}
    running: list = []
    while runs or running:
        while runs and len(running) < jobs:
            pkg, s = runs.pop(0)
            cmd = [sys.executable, os.path.abspath(__file__), "--one", pkg, "--seed", str(s),
                   "--updates", str(updates)]
            running.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True))
        proc = running.pop(0)
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{proc.args} exited {proc.returncode}")
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        returns[line["package"]][line["seed"]] = line["late20"]
    ordered = {pkg: [r[s] for s in seeds] for pkg, r in returns.items()}
    print(json.dumps({"seeds": seeds, "updates": updates, **spread_summary(ordered)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--updates", type=int, default=UPDATES)
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--seeds", default="0-15")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--one", choices=("jax", "port"), default=None)
    args = ap.parse_args()
    if args.spread:
        spread(_seeds(args.seeds), args.jobs, args.updates)
        return
    if args.seed is None:
        ap.error("--seed is required without --spread")
    if args.one is not None:
        late = (run_jax(args.seed, fed=False, updates=args.updates)["late20"]
                if args.one == "jax" else run_port(args.seed, args.updates))
        print(json.dumps({"package": args.one, "seed": args.seed, "late20": late}), flush=True)
        return
    plain = run_jax(args.seed, fed=False, updates=args.updates)
    ref = run_jax(args.seed, fed=True, updates=args.updates)
    port = run_port_fed(args.seed, ref, args.updates)
    n = min(len(ref["greedy"]), len(port["greedy"]))
    same = [bool(np.array_equal(ref["greedy"][i], port["greedy"][i])) for i in range(n)]
    first_diff = next((i for i, s in enumerate(same) if not s), None)
    agree = port["own_idx_agree"]
    print(json.dumps({
        "seed": args.seed, "updates": args.updates,
        "jax_late20": plain["late20"], "jax_fed_late20": ref["late20"],
        "port_fed_late20": port["late20"],
        "act_calls": n, "first_greedy_difference_at_act": first_diff,
        "greedy_agree_share": float(np.mean(same)) if same else None,
        "own_index_agree_first_50_steps": float(np.mean(agree[:50])) if agree else None,
        "own_index_agree_all_steps": float(np.mean(agree)) if agree else None,
    }), flush=True)


if __name__ == "__main__":
    main()
