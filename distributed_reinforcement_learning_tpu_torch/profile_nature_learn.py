"""Decompose the Nature-CNN learn step at batch B (default 32).

Counterpart of the JAX package's `scripts/profile_nature_learn.py`: the
`impala` defaults in bfloat16 on `utils/synthetic.py:synthetic_impala_batch`,
with frames pre-normalised to float so that a scalar `c` can be mixed
in, and the step's parts measured on their own:

  conv   the NatureConv tower alone on the flat [B*T] frames
  fwd    the stored-state forward (conv tower + embed + LSTM cell + heads)
  post   everything after the forward (V-trace x2, losses) from a fixed
         policy and value
  loss   fwd + post in one call
  grad   the gradient of the full loss (fwd + bwd)
  opt    the clip + RMSProp update alone on fixed gradients
  learn  the full learn step (grad + opt)

The JAX script scans K and 2K carry-coupled iterations of each. Eager
PyTorch hoists nothing, so each part is timed two ways, as
`profile_learn_decomp` times its variants: wall ms from K = 16 and 2K
eager iterations between CUDA events, (t(2K) - t(K)) / K, the median of
5 repeats; and the device kernels' own ms in one iteration (torch.profiler).
`opt` and `learn` write the parameters and RMSProp state in place: each
window starts from a clone of the same train state. Beside them the
derived fields (`bwd_ms_derived`, `sum_grad_opt_ms`, `sum_over_learn`,
`fwd_minus_conv_ms`, `loss_minus_fwd_ms`), from wall times as in the JAX
script and from device times, and the port's kernels' launches in the
run. Writes `runs/nature_cnn_profile/RESULTS.json`
(the JAX script writes under `benchmarks/`, where the port writes
nothing) and prints it. Runs on CUDA unless `--device` names another
device.

    python -m distributed_reinforcement_learning_tpu_torch.profile_nature_learn [B]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.ops.kernels import launch_counts
from distributed_reinforcement_learning_tpu_torch.profile_learn_decomp import (
    Variant, clone_state, device_ms, grads_of, nature_conv, setup, window_ms)
from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

K = 16
REPS = 5
OUT_DIR = Path("runs") / "nature_cnn_profile"
C0 = 1e-6  # the JAX script's carry at the first iteration


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("B", type=int, nargs="?", default=32)
    add_device_arg(p)
    return p.parse_args(argv)


def parts(agent, state, batch, conv, conv_params) -> list[Variant]:
    """The seven parts; each `step(carry)` runs one iteration at the
    JAX script's first carry `c` = 1e-6 and returns its value."""
    from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
    from distributed_reinforcement_learning_tpu_torch.models.impala_net import apply_stored_state
    from distributed_reinforcement_learning_tpu_torch.ops import vtrace

    cfg, params = agent.cfg, state.params
    obs_f = batch.state.to(torch.float32) / 255.0
    flat = obs_f.reshape((-1,) + tuple(cfg.obs_shape))
    shifted = batch._replace(state=obs_f + C0)

    def fwd(_):
        with torch.no_grad():
            policy, value = apply_stored_state(agent.model, params, obs_f + C0,
                                               batch.previous_action, batch.initial_h,
                                               batch.initial_c)
            return (policy.mean() + value.mean()).float()

    def conv_step(_):
        with torch.no_grad():
            return functional_call(conv, conv_params, (flat + C0,)).mean().float()

    with torch.no_grad():
        policy0, value0 = apply_stored_state(agent.model, params, obs_f, batch.previous_action,
                                             batch.initial_h, batch.initial_c)

    def post(_):
        with torch.no_grad():
            policy, value = policy0 + C0, value0 + C0
            clipped_r = torch.clamp(batch.reward, -1.0, 1.0)
            discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
            first_p, middle_p, _ = vtrace.split_data(policy)
            first_v, middle_v, last_v = vtrace.split_data(value)
            first_a, middle_a, _ = vtrace.split_data(batch.action)
            first_r, middle_r, _ = vtrace.split_data(clipped_r)
            first_d, middle_d, _ = vtrace.split_data(discounts)
            first_b, middle_b, _ = vtrace.split_data(batch.behavior_policy)
            vs, rho = vtrace.from_softmax(
                behavior_policy=first_b, target_policy=first_p, actions=first_a,
                discounts=first_d, rewards=first_r, values=first_v, next_values=middle_v)
            vs1, _ = vtrace.from_softmax(
                behavior_policy=middle_b, target_policy=middle_p, actions=middle_a,
                discounts=middle_d, rewards=middle_r, values=middle_v, next_values=last_v)
            adv = rho * (first_r + first_d * vs1 - first_v)
            total = (vtrace.policy_gradient_loss(first_p, first_a, adv)
                     + cfg.baseline_loss_coef * vtrace.baseline_loss(vs, first_v)
                     + cfg.entropy_coef * vtrace.entropy_loss(first_p))
            return total.float()

    def loss(_):
        with torch.no_grad():
            return agent.loss(params, shifted)[0].float()

    def grad(_):
        return grads_of(agent.loss(params, shifted)[0], params)

    grads0 = grads_of(agent.loss(params, batch)[0], params)

    def opt(st):
        g = {k: v * (1.0 + C0 * 1e-9) for k, v in grads0.items()}
        agent.tx.apply(st, g)
        return st.params

    def learn(st):
        return agent.learn(st, batch)[0].params

    fresh = lambda: clone_state(state)  # noqa: E731
    return [Variant("conv", conv_step), Variant("fwd", fwd), Variant("post", post),
            Variant("loss", loss), Variant("grad", grad), Variant("opt", opt, fresh),
            Variant("learn", learn, fresh)]


def timed_ms(v: Variant, device) -> float:
    """(t(2K) - t(K)) / K, the median of REPS samples."""
    samples = []
    for _ in range(REPS):
        t1 = window_ms(v, K, device)
        t2 = window_ms(v, 2 * K, device)
        samples.append((t2 - t1) / K)
    ms = float(np.median(samples))
    iqr = float(np.subtract(*np.percentile(samples, [75, 25])))
    print(f"[profile] {v.label}: {ms:.3f} ms (iqr {iqr:.3f})", file=sys.stderr, flush=True)
    return ms


def derived(r: dict, suffix: str) -> dict:
    """The JAX script's derived fields over the `*{suffix}` times."""
    get = lambda name: r[f"{name}{suffix}"]  # noqa: E731
    grad_opt = get("grad") + get("opt")
    return {f"bwd{suffix}_derived": round(get("grad") - get("fwd"), 4),
            f"sum_grad_opt{suffix}": round(grad_opt, 4),
            f"sum_over_learn{suffix.removesuffix('_ms')}": round(grad_opt / get("learn"), 3),
            f"fwd_minus_conv{suffix}": round(get("fwd") - get("conv"), 4),
            f"loss_minus_fwd{suffix}": round(get("loss") - get("fwd"), 4)}


def main(argv: list[str] | None = None) -> dict:
    """Time every part; -> the results written to RESULTS.json."""
    args = parse_args(argv)
    agent, state, batch = setup(args.B, args.device)
    device = agent.device
    conv, conv_params = nature_conv(agent.cfg.dtype, device, seed=1)
    results: dict = {"B": args.B, "K": K, "dtype": "bfloat16",
                     "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"}
    variants = parts(agent, state, batch, conv, conv_params)
    for v in variants:
        window_ms(v, 1, device)  # warm-up
        results[f"{v.label}_ms"] = round(timed_ms(v, device), 4)
    on_card = device.type == "cuda"
    for v in variants:
        dev = device_ms(v, device)
        results[f"{v.label}_device_ms"] = None if dev is None else round(dev, 4)
        results[f"{v.label}_busy"] = (None if dev is None
                                      else round(dev / results[f"{v.label}_ms"], 4))
    results.update(derived(results, "_ms"))
    if on_card:
        results.update(derived(results, "_device_ms"))
    results["launches"] = launch_counts()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "RESULTS.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
