"""Transformer-R2D2 agent: prioritized sequence replay on the causal
transformer, and the transformer model construction both transformer
agents share.

Counterpart of the JAX package's `agents/xformer.py`. R2D2's replay
semantics (`agents/r2d2.py`) with the LSTM swapped for `TransformerQNet`:

- burn-in: the first `burn_in` steps are sliced out of the loss, not the
  forward; for a transformer they are attention context;
- double-Q over sequences with value rescaling on the target; loss: the
  IS-weighted mean over time of the squared TD, plus the MoE routers'
  load-balancing term (`moe_aux_weight` x the sum over layers) when
  `num_experts > 0`, from the online forward only; priority |mean TD|
  (or the eta mixture in `learn`, `priority_eta`); plain Adam.
- Nothing is stored in place of (h, c): the sequence is the state. `act`
  runs the forward over each env's rolling window of the last `seq_len`
  steps and acts epsilon-greedily on the window's final position.

Parameters are explicit tensors run through `models.functional.functional_call`
on a meta-device model, one per thread (`common.ThreadLocalModelMixin`).
The target forward runs under `torch.no_grad()`. On CUDA tensors every
attention call whose T divides by a power-of-two block of at least 8
runs the flash kernels K3a (forward), K3b and K3c (backward); the
sections' seq_len of 10 takes the dense route.

The body features that need a mesh raise and name ROADMAP item 13c:
sequence-parallel attention, the pipeline, expert parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.models.transformer_net import TransformerQNet
from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

_ITEM_13 = "needs a mesh, which is not ported (ROADMAP item 13c)"


@dataclasses.dataclass(frozen=True)
class XformerConfig:
    """R2D2 replay hyperparameters + transformer body knobs, mirroring the
    `xformer` blocks of `config.json`."""

    obs_shape: tuple[int, ...] = (2,)
    num_actions: int = 2
    seq_len: int = 10
    burn_in: int = 5
    d_model: int = 256
    num_heads: int = 4
    num_layers: int = 2
    discount_factor: float = 0.997
    learning_rate: float = 1e-4
    rescale_eps: float = 1e-3
    # "dense" only: "ring" / "ring_zigzag" / "ulysses" shard the sequence
    # over a mesh.
    attention: str = "dense"
    # Mixture-of-experts MLPs in every block when > 0 (`ops/moe.py`); the
    # routers' load-balancing term enters the loss scaled by moe_aux_weight.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    # GPipe stages over a mesh's `pipe` axis: not ported.
    pipeline: bool = False
    pipeline_microbatches: int = 2
    pipeline_stages: int = 0
    # Recompute each block in the backward pass (activation memory stops
    # growing with num_layers x seq_len, for about one more forward).
    remat: bool = False
    # The stacked [num_layers, ...] parameter layout (dense attention).
    stacked: bool = False
    # None = the reference's |mean TD| priority; a float (paper: 0.9) =
    # eta*max|TD| + (1-eta)*mean|TD| in `learn`.
    priority_eta: float | None = None
    # None = plain unclipped Adam; a float adds a global-norm clip.
    gradient_clip_norm: float | None = None


class XformerBatch(NamedTuple):
    """Sequence batch: the R2D2 payload minus the stored (h, c)."""

    state: Any  # [B, T, *obs]
    previous_action: Any  # [B, T] int
    action: Any  # [B, T] int
    reward: Any  # [B, T] f32
    done: Any  # [B, T] bool


def check_dense_body(cfg) -> None:
    """Raise on a transformer body feature that needs a mesh."""
    if cfg.attention != "dense":
        raise ValueError(f"attention={cfg.attention!r} (sequence-parallel attention) "
                         f"{_ITEM_13}")
    if cfg.pipeline:
        raise ValueError(f"pipeline=True (GPipe stages over a pipe axis) {_ITEM_13}")


def build_transformer_models(cfg, mesh=None, *, seq_len: int, head: str = "dueling_q",
                             generator: torch.Generator | None = None):
    """(model, plain-apply twin) for any transformer-family config. On one
    device the twin is the model itself, as in the JAX package when no
    sharded feature is on. A mesh (sequence, pipeline or expert
    parallelism) raises."""
    if mesh is not None:
        raise ValueError(f"a mesh (sequence, pipeline or expert parallelism) {_ITEM_13}")
    check_dense_body(cfg)
    model = TransformerQNet(
        num_actions=cfg.num_actions, obs_shape=cfg.obs_shape, d_model=cfg.d_model,
        num_heads=cfg.num_heads, num_layers=cfg.num_layers, max_len=max(seq_len, 16),
        head=head, num_experts=cfg.num_experts, moe_top_k=cfg.moe_top_k,
        moe_capacity_factor=cfg.moe_capacity_factor, stack_layers=cfg.stacked,
        remat=cfg.remat, generator=generator)
    return model, model


def init_transformer_params(cfg, *, seq_len: int, seed: int,
                            head: str = "dueling_q") -> dict[str, torch.Tensor]:
    """Fresh parameters drawn on the CPU from `seed` (Glorot-uniform
    kernels, zero biases, unit LayerNorm scales)."""
    model, _ = build_transformer_models(cfg, seq_len=seq_len, head=head,
                                        generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


def moe_aux_term(cfg, aux: list[torch.Tensor]):
    """`moe_aux_weight` x the sum of the layers' router terms (0.0 without
    experts), as the JAX agents add the sown `losses` collection."""
    return cfg.moe_aux_weight * sum(aux) if aux else 0.0


class XformerAgent(common.SequenceReplayLearnMixin, common.ThreadLocalModelMixin):
    """Config + model + optimizer; `act`, `td_error`, `learn` and
    `learn_many` on `device`."""

    def __init__(self, cfg: XformerConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._init_models()
        self.tx = common.AdamWithClip(cfg.learning_rate, clip_norm=cfg.gradient_clip_norm)

    def _build_model(self, generator: torch.Generator | None) -> TransformerQNet:
        return build_transformer_models(self.cfg, seq_len=self.cfg.seq_len,
                                        generator=generator)[0]

    # -- init ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> common.TargetTrainState:
        """Fresh parameters drawn on the CPU from `seed` (the same numbers
        whatever the device), moved to the agent's device; the target
        network starts as a copy."""
        return self.state_from_params(
            init_transformer_params(self.cfg, seq_len=self.cfg.seq_len, seed=seed))

    def _forward(self, params, obs, previous_action, done, return_aux: bool = False):
        return functional_call(self.model, params,
                               (common.normalize_obs(obs), previous_action, done),
                               {"return_aux": return_aux})

    # -- act -------------------------------------------------------------
    @torch.no_grad()
    def act(self, params, obs_win: torch.Tensor, prev_action_win: torch.Tensor,
            done_win: torch.Tensor, epsilon: torch.Tensor | float,
            generator: torch.Generator):
        """Batched epsilon-greedy over the LAST step of each env's rolling
        window (`[N, W, ...]`, the actor's recent history: the transformer's
        counterpart of carrying (h, c)) -> (action [N], q [N, A])."""
        q = self._forward(params, obs_win, prev_action_win.long(), done_win)[:, -1]
        return common.epsilon_greedy(q, epsilon, self.cfg.num_actions, generator), q

    # -- sequence target math (SequenceReplayLearnMixin) -----------------
    def _sequence_td(self, params, target_params, batch: XformerBatch):
        """-> (target value, Q(s, a), aux term): the online forward
        collects the routers' terms, the target forward (no gradient) does
        not."""
        cfg = self.cfg
        main_q, aux = self._forward(params, batch.state, batch.previous_action, batch.done,
                                    return_aux=True)
        with torch.no_grad():
            target_q = self._forward(target_params, batch.state, batch.previous_action,
                                     batch.done)
        discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
        tv, sav = common.sequence_double_q_td(
            main_q, target_q, batch.action, batch.reward, discounts,
            burn_in=cfg.burn_in, rescale_eps=cfg.rescale_eps)
        return tv, sav, moe_aux_term(cfg, aux)

    @torch.no_grad()
    def _td_error(self, state: common.TargetTrainState, batch: XformerBatch) -> torch.Tensor:
        """|mean_t TD| a sequence, whatever `priority_eta` says: the JAX
        agent's `_td_error` scores ingest so (its `learn` priorities take
        the eta mixture)."""
        tv, sav, _ = self._sequence_td(state.params, state.target_params, batch)
        return torch.abs(torch.mean(tv - sav, dim=1))
