"""Decompose the IMPALA learn step's time by sub-module.

Counterpart of the JAX package's `scripts/profile_learn_decomp.py`: the
`impala` defaults (Breakout frames 84x84x4, NatureConv, LSTM 256, 18
actions, T 20) in bfloat16 at batch `B` (default 128) on
`utils/synthetic.py:synthetic_impala_batch`, and nine variants:

    A  the full learn step            F  the NatureConv tower forward
    B  the loss gradient (no opt)     G  F forward + backward
    C  the loss forward               H  normalize_obs alone
    D  the model forward (no V-trace) I  the two V-trace views
    E  D forward + backward              forward + backward

The JAX script repeats each variant K times inside one `lax.scan` (its
one-element `bump` keeps XLA from hoisting work out of the loop). Eager
PyTorch hoists nothing, so each variant is timed two ways:

- wall ms: K1 = 8 and K2 = 32 eager iterations between CUDA events,
  (median t(K2) - median t(K1)) / (K2 - K1) over 3 repeats;
- device ms: the device kernels' own time in one iteration, summed from
  torch.profiler's events.

Their ratio is the variant's busy share; the JSON line also carries the
port's kernels' launches in the run (`ops/kernels.launch_counts`). A and the optimizer write the
parameters and RMSProp state in place: each window starts from a clone
of the same train state. Prints a line a variant and one JSON line. Runs
on CUDA unless `--device` names another device (on the CPU the wall
time is the host clock's and the device time is not measured).

    python -m distributed_reinforcement_learning_tpu_torch.profile_learn_decomp [B]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.ops.kernels import launch_counts
from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

K1, K2, REPS = 8, 32, 3


class Variant(NamedTuple):
    """`step(carry)` runs one iteration and returns its value; `init()`
    makes a window's carry (a clone of the train state, or None)."""

    label: str
    step: Callable
    init: Callable = lambda: None


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("B", type=int, nargs="?", default=128)
    add_device_arg(p)
    return p.parse_args(argv)


def clone_state(state):
    """A train state with its own copies of the parameters and optimizer
    state, for a variant that writes them in place."""
    return type(state)(params={k: v.detach().clone().requires_grad_(True)
                               for k, v in state.params.items()},
                       nu={k: v.clone() for k, v in state.nu.items()}, step=state.step)


def grads_of(loss: torch.Tensor, params: dict) -> dict:
    names = list(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))


def nature_conv(dtype: torch.dtype, device, seed: int):
    """-> (a structure-only NatureConv on 4 channels, its Glorot
    parameters drawn from `seed`)."""
    from distributed_reinforcement_learning_tpu_torch.models.torso import NatureConv, init_glorot_

    conv = NatureConv(4, dtype=dtype)
    init_glorot_(conv, torch.Generator().manual_seed(seed))
    params = {k: v.detach().to(device).requires_grad_(True)
              for k, v in conv.state_dict().items()}
    return conv.to("meta"), params


def vtrace_loss(cfg, batch, pol: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The IMPALA loss from a policy and value `[B, T]`: V-trace over the
    first and middle views, the policy-gradient, baseline and entropy
    terms (the JAX script's `vt_loss`)."""
    from distributed_reinforcement_learning_tpu_torch.agents import common
    from distributed_reinforcement_learning_tpu_torch.ops import vtrace as V

    clipped_r = common.clip_rewards(batch.reward, cfg.reward_clipping)
    discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
    fp, mp, _ = V.split_data(pol)
    fv, mv, lv = V.split_data(val)
    fa, ma, _ = V.split_data(batch.action)
    fr, mr, _ = V.split_data(clipped_r)
    fd, md, _ = V.split_data(discounts)
    fb, mb, _ = V.split_data(batch.behavior_policy)
    vs, rho = V.from_softmax(behavior_policy=fb, target_policy=fp, actions=fa,
                             discounts=fd, rewards=fr, values=fv, next_values=mv)
    vs1, _ = V.from_softmax(behavior_policy=mb, target_policy=mp, actions=ma,
                            discounts=md, rewards=mr, values=mv, next_values=lv)
    adv = (rho * (fr + fd * vs1 - fv)).detach()
    return (V.policy_gradient_loss(fp, fa, adv) + V.baseline_loss(vs, fv)
            + cfg.entropy_coef * V.entropy_loss(fp))


def variants(agent, state, batch, conv, conv_params) -> list[Variant]:
    """The nine variants over `agent` (its train `state`) and a batch of
    tensors on its device; `conv`, `conv_params`: the tower of F and G."""
    from distributed_reinforcement_learning_tpu_torch.agents import common
    from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
    from distributed_reinforcement_learning_tpu_torch.models.impala_net import apply_stored_state

    cfg, dtype, params = agent.cfg, agent.cfg.dtype, state.params
    flat_obs = batch.state.reshape(-1, *cfg.obs_shape)

    def learn(st):
        return agent.learn(st, batch)[0].params

    def model_fwd(p):
        pol, val = apply_stored_state(agent.model, p, common.normalize_obs(batch.state, dtype),
                                      batch.previous_action, batch.initial_h, batch.initial_c)
        return pol.sum() + val.sum()

    def conv_fwd(p):
        return functional_call(conv, p, (common.normalize_obs(flat_obs, dtype),)).float().sum()

    pol0 = batch.behavior_policy
    val0 = torch.zeros(batch.reward.shape, dtype=torch.float32, device=pol0.device)

    def vt_grads(_):
        # The JAX variant's loop-variant shift of the policy by the first
        # frame byte times 1e-9, kept so that the values match.
        pol = (pol0 + batch.state.reshape(-1)[0].float() * 1e-9).requires_grad_(True)
        val = val0.clone().requires_grad_(True)
        return torch.autograd.grad(vtrace_loss(cfg, batch, pol, val), [pol, val])

    def under_no_grad(fn):
        def run(_):
            with torch.no_grad():
                return fn()
        return run

    return [
        Variant("A full learn step", learn, lambda: clone_state(state)),
        Variant("B loss grad (no opt)", lambda _: grads_of(agent.loss(params, batch)[0], params)),
        Variant("C loss forward only", under_no_grad(lambda: agent.loss(params, batch)[0])),
        Variant("D model fwd (no vtrace)", under_no_grad(lambda: model_fwd(params))),
        Variant("E model fwd+bwd (no vtrace)", lambda _: grads_of(model_fwd(params), params)),
        Variant("F conv fwd (+normalize)", under_no_grad(lambda: conv_fwd(conv_params))),
        Variant("G conv fwd+bwd (+normalize)",
                lambda _: grads_of(conv_fwd(conv_params), conv_params)),
        Variant("H normalize_obs alone",
                under_no_grad(lambda: common.normalize_obs(flat_obs, dtype).float().sum())),
        Variant("I vtrace 2 views fwd+bwd", vt_grads),
    ]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_ms(variant: Variant, k: int, device: torch.device) -> float:
    """ms for `k` iterations from a fresh carry: CUDA events on the card,
    the host clock elsewhere."""
    carry = variant.init()
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            variant.step(carry)
        return 1e3 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        variant.step(carry)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_us(e) -> float:
    """An event's own device time (the attribute's name changed across
    PyTorch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ms(variant: Variant, device: torch.device) -> float | None:
    """The device kernels' own ms in one iteration (torch.profiler, device
    activity only); None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    carry = variant.init()
    variant.step(carry)  # outside the profiler: first-call costs
    carry = variant.init()
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        variant.step(carry)
        _sync(device)
    return sum(device_us(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3


def setup(B: int, device, dtype: torch.dtype = torch.bfloat16):
    """-> (agent, train state, batch on the device): the `impala` defaults
    in `dtype`, parameters from seed 0, the JAX script's synthetic batch
    (`uniform_behavior=False`)."""
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.utils.synthetic import (
        synthetic_impala_batch)

    cfg = ImpalaConfig(dtype=dtype)
    agent = ImpalaAgent(cfg, device=device)
    state = agent.init_state(0)
    batch = synthetic_impala_batch(B, cfg.trajectory, cfg.obs_shape, cfg.num_actions,
                                   cfg.lstm_size, uniform_behavior=False, device=agent.device)
    return agent, state, batch


def main(argv: list[str] | None = None) -> dict:
    """Time every variant; -> the printed JSON object."""
    args = parse_args(argv)
    agent, state, batch = setup(args.B, args.device)
    device = agent.device
    conv, conv_params = nature_conv(agent.cfg.dtype, device, seed=0)
    N = args.B * agent.cfg.trajectory
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} kind={kind} B={args.B} N={N} dtype=bfloat16")
    out: dict = {"B": args.B, "N": N, "dtype": "bfloat16", "device": kind,
                 "k1": K1, "k2": K2, "reps": REPS, "variants": {}}
    for v in variants(agent, state, batch, conv, conv_params):
        window_ms(v, 1, device)  # warm-up: allocator, cuDNN plans, kernel builds
        t1 = statistics.median(window_ms(v, K1, device) for _ in range(REPS))
        t2 = statistics.median(window_ms(v, K2, device) for _ in range(REPS))
        wall = (t2 - t1) / (K2 - K1)
        dev = device_ms(v, device)
        busy = None if dev is None else dev / wall
        out["variants"][v.label] = {"wall_ms": round(wall, 4),
                                    "device_ms": None if dev is None else round(dev, 4),
                                    "busy": None if busy is None else round(busy, 4)}
        dev_s = "not measured" if dev is None else f"{dev:8.3f} ms device, {100 * busy:5.1f}% busy"
        print(f"{v.label:32s}: {wall:8.3f} ms wall, {dev_s}", flush=True)
        if v.label.startswith("A "):
            out["frames_per_s"] = round(N / (wall / 1e3), 1)
            print(f"{'':34s}-> {N / (wall / 1e3):,.0f} frames/s")
    out["launches"] = launch_counts()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
