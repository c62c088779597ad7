"""Transformer-R2D2 actor/learner loops.

Counterpart of the JAX package's `runtime/xformer_runner.py`. The learner
is the R2D2 learner (it only touches `agent.{init_state, td_error, learn,
learn_many, sync_target}` and sequence batches from the queue or the
replay, all of which the transformer agent provides), and `run_sync` and
`run_async` are topology only, so all three are reused.

Only the actor differs from `R2D2Actor`: instead of carrying (h, c) it
keeps a rolling window of the last seq_len (obs, prev_action, done)
steps per env and acts on the window's final position. Padding slots are
marked done, so segment masking keeps them (and every slot before an
episode reset) out of the live episode's context; the window never needs
clearing. Per-env epsilon `max(1/(0.1*episode+1), floor)` with a floor of
0.15 by default: the transformer's Q takes longer than the LSTM's to
tell states apart, and the reference's per-episode decay would starve
exploration before then. The actor has the pipeline's slice protocol,
with the window persisting across rounds per slice; an act the pipeline
discards is un-pushed (`slice_discard_act`). `timeout_nonterminal`
records a time-limit truncation as non-terminal, as `R2D2Actor` does.

Not ported: `remote_act` (ROADMAP item 12d).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.xformer import XformerAgent
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, put_round
from distributed_reinforcement_learning_tpu_torch.data.structures import (
    SlicedAccumulators, XformerSequenceAccumulator)
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import (
    PipelineSlice, push_window, shape_timeout, slice_seed, split_batched_env,
    sync_slices_params, unpush_window)
from distributed_reinforcement_learning_tpu_torch.runtime.r2d2_runner import (  # noqa: F401
    R2D2Learner,
    run_async,  # re-exported: topology only
    run_sync,  # re-exported: topology only
)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


class XformerLearner(R2D2Learner):
    """R2D2Learner bound to an XformerAgent; see the module docstring."""


class XformerActor:
    def __init__(
        self,
        agent: XformerAgent,
        env,  # VectorEnv over full observations
        queue: TrajectoryQueue,
        weights: WeightStore,
        seed: int = 0,
        epsilon_decay: float = 0.1,
        epsilon_floor: float = 0.15,
        timeout_nonterminal: bool = False,  # see R2D2Actor
        obs_transform=None,  # e.g. envs.cartpole.pomdp_project
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.epsilon_decay = epsilon_decay
        self.epsilon_floor = epsilon_floor
        self.timeout_nonterminal = timeout_nonterminal
        self.obs_transform = obs_transform or (lambda x: x)

        self._seed = seed  # slice seeds derive from it (actor_pipeline)
        self._generator = torch.Generator(device=agent.device).manual_seed(seed)
        self._obs = self.obs_transform(env.reset())
        n = self._obs.shape[0]
        w = agent.cfg.seq_len
        # Rolling window, oldest first; padding slots are marked done.
        self._win_obs = np.zeros((n, w, *self._obs.shape[1:]), self._obs.dtype)
        self._win_pa = np.zeros((n, w), np.int32)
        self._win_done = np.ones((n, w), bool)
        self._prev_action = np.zeros(n, np.int32)
        self._episodes = np.zeros(n, np.int64)
        self._params = None
        self._version = -1
        self.episode_returns: list[float] = []

    def _epsilon(self, episodes: np.ndarray) -> np.ndarray:
        return np.maximum(1.0 / (self.epsilon_decay * episodes + 1.0), self.epsilon_floor)

    @property
    def epsilon(self) -> np.ndarray:
        return self._epsilon(self._episodes)

    def _sync_params(self) -> None:
        got = self.weights.get_if_newer(self._version)
        if got is not None:
            self._params, self._version = got

    def _act(self, params, win_obs, win_pa, win_done, episodes, generator) -> np.ndarray:
        device = self.agent.device
        action, _ = self.agent.act(
            params, torch.as_tensor(win_obs, device=device),
            torch.as_tensor(win_pa, device=device), torch.as_tensor(win_done, device=device),
            torch.as_tensor(self._epsilon(episodes), dtype=torch.float32, device=device),
            generator)
        return action.cpu().numpy().astype(np.int32)

    def run_unroll(self) -> int:
        """One seq_len unroll from all envs -> N sequences into the queue.
        Returns the number of env frames generated (N * seq_len)."""
        cfg = self.agent.cfg
        self._sync_params()
        if self._params is None:
            raise RuntimeError("no weights published yet")
        acc = XformerSequenceAccumulator()
        n = self._obs.shape[0]

        for _ in range(cfg.seq_len):
            push_window(self._win_obs, self._win_pa, self._win_done, self._obs,
                        self._prev_action)
            action = self._act(self._params, self._win_obs, self._win_pa, self._win_done,
                               self._episodes, self._generator)
            next_obs_raw, reward, done, infos = self.env.step(action)
            rec_done = shape_timeout(done, infos, self.timeout_nonterminal)
            acc.append(state=self._obs, previous_action=self._prev_action, action=action,
                       reward=reward.astype(np.float32), done=rec_done)

            self._win_done[:, -1] = rec_done  # now known; later windows see it
            self._prev_action = np.where(rec_done, 0, action).astype(np.int32)
            self._obs = self.obs_transform(next_obs_raw)
            # Exploration anneals per recorded episode.
            self._episodes += rec_done
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))

        with _OBS.span("actor_put"):
            put_round(self.queue, acc.extract())
        return n * cfg.seq_len

    # -- slice protocol (runtime/actor_pipeline.py) --------------------
    # The rolling window persists across rounds per slice; everything
    # else mirrors run_unroll over the slice's own envs and generator.

    def pipeline_round_steps(self) -> int:
        return self.agent.cfg.seq_len

    def pipeline_make_slices(self, k: int) -> list[PipelineSlice]:
        self._slice_accs = SlicedAccumulators(XformerSequenceAccumulator, k)
        w = self.agent.cfg.seq_len
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
                episodes=np.zeros(n, np.int64),
            ))
            lo = hi
        return slices

    pipeline_sync_weights = sync_slices_params

    def slice_begin_round(self, sl: PipelineSlice, steps: int) -> None:
        if sl.params is None:
            raise RuntimeError("no weights published yet")
        self._slice_accs.reset_slice(sl.index)

    def slice_act(self, sl: PipelineSlice) -> np.ndarray:
        # The window persists across rounds, so keep what the push evicts:
        # an act the pipeline discards must be un-pushed.
        sl.evicted = (sl.win_obs[:, 0].copy(), sl.win_pa[:, 0].copy(),
                      sl.win_done[:, 0].copy())
        push_window(sl.win_obs, sl.win_pa, sl.win_done, sl.obs, sl.prev_action)
        return self._act(sl.params, sl.win_obs, sl.win_pa, sl.win_done, sl.episodes,
                         sl.generator)

    def slice_discard_act(self, sl: PipelineSlice, out) -> None:
        """An in-flight act the pipeline discarded, settled (`out` its
        output) or raised (`out` None; the push precedes anything in
        slice_act that can raise), pushed this slice's window: restore
        the pre-push bytes, so that the retry does not condition every
        later act on a duplicated step."""
        unpush_window(sl.win_obs, sl.win_pa, sl.win_done, sl.evicted)

    def slice_step(self, sl: PipelineSlice, action: np.ndarray) -> tuple:
        next_obs_raw, reward, done, infos = sl.env.step(action)
        rec_done = shape_timeout(done, infos, self.timeout_nonterminal)
        self._slice_accs.append_slice(
            sl.index, state=sl.obs, previous_action=sl.prev_action, action=action,
            reward=reward.astype(np.float32), done=rec_done)
        sl.win_done[:, -1] = rec_done
        sl.prev_action = np.where(rec_done, 0, action).astype(np.int32)
        sl.obs = self.obs_transform(next_obs_raw)
        sl.episodes += rec_done
        for ret in completed_returns(infos, done):
            sl.episode_returns.append(float(ret))
        return ()

    def slice_end_round(self, sl: PipelineSlice) -> tuple:
        return (("round", self._slice_accs.extract_slice(sl.index)),)
