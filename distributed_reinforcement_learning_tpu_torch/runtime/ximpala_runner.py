"""Transformer-IMPALA actor/learner loops.

Counterpart of the JAX package's `runtime/ximpala_runner.py`. The
learner is the IMPALA learner (it only touches `agent.learn`,
`agent.init_state` and stacked unrolls from the queue), and `run_sync`
and `run_async` are topology only, so all three are reused. Only the
actor differs from `ImpalaActor`: instead of carrying (h, c) it keeps a
window of the current unroll's steps and records the window-final
softmax as the behavior policy; it has the pipeline's slice protocol.
With `remote_act` the windows go to a service as rows (the action and
the behaviour policy come back), the windows stay here, and no weights
are pulled.
With a config whose learn step is sharded (a sequence, pipeline or
expert axis) the actor's agent is the plain-apply twin's and the
learner's is built over the learner's mesh (`runtime/launch.make_agent`).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.ximpala import XImpalaAgent
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, put_round
from distributed_reinforcement_learning_tpu_torch.data.structures import (
    SlicedAccumulators, XImpalaTrajectoryAccumulator)
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import (
    PipelineSlice, push_window, shape_life_loss, slice_seed, split_batched_env,
    sync_slices_params)
from distributed_reinforcement_learning_tpu_torch.runtime.impala_runner import (  # noqa: F401
    ImpalaLearner,
    run_async,  # re-exported: topology only
    run_sync,  # re-exported: topology only
)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


class XImpalaLearner(ImpalaLearner):
    """ImpalaLearner bound to an XImpalaAgent; see the module docstring."""


class XImpalaActor:
    def __init__(
        self,
        agent: XImpalaAgent,
        env,  # VectorEnv-like: reset() -> [N, ...], step([N]) -> obs, r, done, infos
        queue: TrajectoryQueue,
        weights: WeightStore,
        seed: int = 0,
        available_action: int | None = None,
        life_loss_shaping: bool = False,
        obs_transform=None,  # e.g. envs.cartpole.pomdp_project
        remote_act=None,  # a served act: row dict -> reply dict; no weight pulls
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.remote_act = remote_act
        self.available_action = available_action
        self.life_loss_shaping = life_loss_shaping
        self.obs_transform = obs_transform or (lambda x: x)

        self._seed = seed  # slice seeds derive from it (actor_pipeline)
        self._generator = torch.Generator(device=agent.device).manual_seed(seed)
        self._obs = self.obs_transform(env.reset())
        n = self._obs.shape[0]
        w = agent.cfg.trajectory
        # Window, oldest first; pad slots are marked done, so segment
        # masking keeps them out of the real steps' context.
        self._win_obs = np.zeros((n, w, *self._obs.shape[1:]), self._obs.dtype)
        self._win_pa = np.zeros((n, w), np.int32)
        self._win_done = np.ones((n, w), bool)
        self._prev_action = np.zeros(n, np.int32)
        self._params = None
        self._version = -1
        self._lives = np.full(n, -1)
        self.episode_returns: list[float] = []

    def _sync_params(self) -> None:
        """Per-unroll weight pull."""
        got = self.weights.get_if_newer(self._version)
        if got is not None:
            self._params, self._version = got

    def _act(self, params, win_obs, win_pa, win_done, generator) -> tuple:
        """One batched act over the windows -> host (action, behaviour
        policy): through the service when `remote_act` is set, else the
        agent's act."""
        if self.remote_act is not None:
            r = self.remote_act({"obs": win_obs, "prev_action": win_pa, "done": win_done})
            return np.asarray(r["action"], np.int32), np.asarray(r["policy"])
        device = self.agent.device
        out = self.agent.act(
            params, torch.as_tensor(win_obs, device=device), torch.as_tensor(win_pa, device=device),
            torch.as_tensor(win_done, device=device), generator)
        return out.action.cpu().numpy().astype(np.int32), out.policy.cpu().numpy()

    def run_unroll(self) -> int:
        """Collect one T-step unroll from all N envs; enqueue N trajectories.

        The window RESETS at each unroll start (pad slots marked done):
        the behavior policy at unroll position t is computed from exactly
        steps 0..t of the current unroll, the context the learner's
        forward sees, so V-trace's rho compares policies under the same
        conditioning. Returns the number of env frames generated (N * T).
        """
        cfg = self.agent.cfg
        if self.remote_act is None:
            self._sync_params()
            if self._params is None:
                raise RuntimeError("no weights published yet")
        acc = XImpalaTrajectoryAccumulator()
        n = self._obs.shape[0]
        self._win_obs[:] = 0
        self._win_pa[:] = 0
        self._win_done[:] = True

        for _ in range(cfg.trajectory):
            push_window(self._win_obs, self._win_pa, self._win_done, self._obs,
                        self._prev_action)
            action, policy = self._act(self._params, self._win_obs, self._win_pa,
                                       self._win_done, self._generator)
            env_actions = action % self.available_action if self.available_action else action
            next_obs_raw, reward, done, infos = self.env.step(env_actions)
            next_obs = self.obs_transform(next_obs_raw)

            rec_reward, rec_done = reward.astype(np.float32), done.copy()
            if self.life_loss_shaping:
                rec_reward, rec_done, self._lives = shape_life_loss(
                    self._lives, reward, done, infos)

            acc.append(
                state=self._obs,
                reward=rec_reward,
                action=action,
                done=rec_done,  # shaped -> V-trace discounts
                env_done=done,  # true episode ends -> attention segments
                behavior_policy=policy,
                previous_action=self._prev_action,
            )

            self._win_done[:, -1] = done  # now known; later windows see it
            self._prev_action = np.where(done, 0, action).astype(np.int32)
            self._obs = next_obs
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))

        with _OBS.span("actor_put"):
            put_round(self.queue, acc.extract())
        return n * cfg.trajectory

    # -- slice protocol (runtime/actor_pipeline.py) --------------------

    def pipeline_round_steps(self) -> int:
        return self.agent.cfg.trajectory

    def pipeline_make_slices(self, k: int) -> list[PipelineSlice]:
        self._slice_accs = SlicedAccumulators(XImpalaTrajectoryAccumulator, k)
        w = self.agent.cfg.trajectory
        slices = []
        lo = 0
        for i, env in enumerate(split_batched_env(self.env, k)):
            hi = lo + env.num_envs
            n = env.num_envs
            seed = slice_seed(self._seed, i)
            obs = self._obs[lo:hi].copy()
            slices.append(PipelineSlice(
                i, env, seed,
                generator=torch.Generator(device=self.agent.device).manual_seed(seed),
                obs=obs,
                win_obs=np.zeros((n, w, *obs.shape[1:]), obs.dtype),
                win_pa=np.zeros((n, w), np.int32),
                win_done=np.ones((n, w), bool),
                prev_action=np.zeros(n, np.int32),
                lives=np.full(n, -1),
            ))
            lo = hi
        return slices

    pipeline_sync_weights = sync_slices_params

    def slice_begin_round(self, sl: PipelineSlice, steps: int) -> None:
        if self.remote_act is None and sl.params is None:
            raise RuntimeError("no weights published yet")
        self._slice_accs.reset_slice(sl.index)
        sl.win_obs[:] = 0
        sl.win_pa[:] = 0
        sl.win_done[:] = True

    def slice_act(self, sl: PipelineSlice) -> tuple:
        push_window(sl.win_obs, sl.win_pa, sl.win_done, sl.obs, sl.prev_action)
        return self._act(sl.params, sl.win_obs, sl.win_pa, sl.win_done, sl.generator)

    def slice_step(self, sl: PipelineSlice, out: tuple) -> tuple:
        action, policy = out
        env_actions = action % self.available_action if self.available_action else action
        next_obs_raw, reward, done, infos = sl.env.step(env_actions)
        next_obs = self.obs_transform(next_obs_raw)
        rec_reward, rec_done = reward.astype(np.float32), done.copy()
        if self.life_loss_shaping:
            rec_reward, rec_done, sl.lives = shape_life_loss(sl.lives, reward, done, infos)
        self._slice_accs.append_slice(
            sl.index, state=sl.obs, reward=rec_reward, action=action, done=rec_done,
            env_done=done, behavior_policy=policy, previous_action=sl.prev_action)
        sl.win_done[:, -1] = done
        sl.prev_action = np.where(done, 0, action).astype(np.int32)
        sl.obs = next_obs
        for ret in completed_returns(infos, done):
            sl.episode_returns.append(float(ret))
        return ()

    def slice_end_round(self, sl: PipelineSlice) -> tuple:
        return (("round", self._slice_accs.extract_slice(sl.index)),)
