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

With `mesh=` (a `parallel/mesh.RankMesh`) the learn step is one rank's
part of a step sharded as the config says (`build_transformer_models`):
the sequence over `seq` (`attention` "ring", "ring_zigzag", "ulysses"),
the layers over `pipe` (`pipeline`), the experts over `expert`. Acting
and scoring ingest run the plain-apply twin: the same parameter layout
(whole tensors), no collective.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.models.transformer_net import TransformerQNet
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, PIPE_AXIS, SEQ_AXIS)
from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device


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
    # "dense" on one device; "ring" / "ring_zigzag" / "ulysses" shard the
    # sequence over the mesh's `seq` axis (pass the mesh at construction).
    attention: str = "dense"
    # Mixture-of-experts MLPs in every block when > 0 (`ops/moe.py`); the
    # routers' load-balancing term enters the loss scaled by moe_aux_weight.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    # GPipe stages over the mesh's `pipe` axis, each owning num_layers /
    # stages contiguous layers, each batch split into this many
    # microbatches; the stacked layout, exclusive with ring/ulysses and MoE.
    # pipeline_stages 0 is one stage a layer, else >= 2 dividing num_layers.
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


def _sequence_attention(body, mesh, q, k, v, segs):
    """A `parallel/sequence.py` per-rank body as the model's attention_fn."""
    return body(mesh, q, k, v, segs, causal=True)


def build_transformer_models(cfg, mesh=None, *, seq_len: int, head: str = "dueling_q",
                             generator: torch.Generator | None = None):
    """(model, plain-apply twin) for any transformer-family config, with
    the JAX package's checks. The twin applies the same parameters (whole
    tensors) with dense attention, no pipeline and no mesh, for acting on
    windows and scoring ingest; it is the model itself when no sharded
    feature is on. Over a mesh the routers route the mesh's union batch,
    whatever its expert axis (JAX's GSPMD does)."""
    from distributed_reinforcement_learning_tpu_torch.parallel import sequence as sp

    attention_fn = seq_mesh = sequence_perm = None
    if cfg.attention != "dense":
        if mesh is None:
            raise ValueError(f"attention={cfg.attention!r} needs a mesh")
        bodies = {"ring": sp.ring_shard, "ring_zigzag": sp.ring_shard_zigzag,
                  "ulysses": sp.ulysses_shard}
        if cfg.attention not in bodies:
            raise ValueError(f"unknown attention {cfg.attention!r}; one of "
                             f"['dense', {', '.join(map(repr, bodies))}]")
        attention_fn = functools.partial(_sequence_attention, bodies[cfg.attention], mesh)
        seq_mesh = mesh
        if cfg.attention == "ring_zigzag":
            sequence_perm = sp.zigzag_permutation(seq_len, mesh.size(SEQ_AXIS))
    moe_mesh = mesh if cfg.num_experts and mesh is not None else None
    pipeline_mesh = None
    if cfg.pipeline:
        if mesh is None:
            raise ValueError("pipeline=True needs a mesh with a 'pipe' axis")
        if cfg.attention != "dense" or cfg.num_experts:
            raise ValueError("pipeline is exclusive with sequence-parallel attention and MoE")
        if cfg.pipeline_stages < 0 or cfg.pipeline_stages == 1:
            raise ValueError(f"pipeline_stages must be 0 (one stage per layer) or >= 2, "
                             f"got {cfg.pipeline_stages}")
        want = cfg.pipeline_stages or cfg.num_layers
        if cfg.num_layers % want != 0:
            raise ValueError(f"pipeline_stages={cfg.pipeline_stages} must divide "
                             f"num_layers={cfg.num_layers}")
        have = mesh.size(PIPE_AXIS)
        if have != want:
            raise ValueError(f"mesh pipe axis is {have} but the config asks for {want} "
                             f"stages (pipeline_stages={cfg.pipeline_stages}, "
                             f"num_layers={cfg.num_layers})")
        pipeline_mesh = mesh

    def make(fn=None, perm=None, pipe=None, moe=None, smesh=None):
        return TransformerQNet(
            num_actions=cfg.num_actions, obs_shape=cfg.obs_shape, d_model=cfg.d_model,
            num_heads=cfg.num_heads, num_layers=cfg.num_layers, max_len=max(seq_len, 16),
            head=head, num_experts=cfg.num_experts, moe_top_k=cfg.moe_top_k,
            moe_capacity_factor=cfg.moe_capacity_factor,
            stack_layers=cfg.pipeline or cfg.stacked, remat=cfg.remat, generator=generator,
            attention_fn=fn, seq_mesh=smesh, sequence_perm=perm, moe_mesh=moe,
            pipeline_mesh=pipe, pipeline_microbatches=cfg.pipeline_microbatches)

    model = make(attention_fn, sequence_perm, pipeline_mesh, moe_mesh, seq_mesh)
    sharded = attention_fn is not None or pipeline_mesh is not None or moe_mesh is not None
    return model, (make() if sharded else model)


def init_transformer_params(cfg, *, seq_len: int, seed: int,
                            head: str = "dueling_q") -> dict[str, torch.Tensor]:
    """Fresh whole parameters drawn on the CPU from `seed` (Glorot-uniform
    kernels, zero biases, unit LayerNorm scales), in the layout of the
    config's model (stacked for a pipeline)."""
    twin_cfg = dataclasses.replace(cfg, attention="dense", pipeline=False,
                                   stacked=cfg.pipeline or cfg.stacked)
    model, _ = build_transformer_models(twin_cfg, seq_len=seq_len, head=head,
                                        generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


class TwinModelMixin(common.ThreadLocalModelMixin):
    """`model` (the mesh-sharded learn-step module) and `twin` (the
    plain-apply module over the same parameter names), one each a thread.
    The host class provides `mesh` and `_build_models(generator)` ->
    (model, twin)."""

    def _build_model(self, generator):
        return self._build_models(generator)[0]

    @property
    def twin(self):
        models = self.__dict__.setdefault("_twins", threading.local())
        twin = getattr(models, "twin", None)
        if twin is None:
            model, twin = self._build_models(None)
            twin = models.twin = self.model if twin is model else twin.to("meta")
        return twin

    @property
    def seq_sharded(self) -> bool:
        """Whether the learn step's stream is split over `seq` (each
        parameter's gradient is then a part, summed over the axis)."""
        return self.mesh is not None and self.cfg.attention != "dense"

    def aux_share(self, aux):
        """This rank's share of the routers' term: over `data` the learner
        sums the IMPALA losses (`loss_reduction` "sum"), so each of the D
        ranks adds aux / D; the replay losses are averaged, and each adds
        it whole."""
        d = 1 if self.mesh is None else self.mesh.size(DATA_AXIS)
        return aux / d if (d > 1 and self.loss_reduction == "sum") else aux


def moe_aux_term(cfg, aux: list[torch.Tensor]):
    """`moe_aux_weight` x the sum of the layers' router terms (0.0 without
    experts), as the JAX agents add the sown `losses` collection."""
    return cfg.moe_aux_weight * sum(aux) if aux else 0.0


class XformerAgent(common.SequenceReplayLearnMixin, TwinModelMixin):
    """Config + model + optimizer; `act`, `td_error`, `learn` and
    `learn_many` on `device`; over `mesh` the learn step is one rank's
    part of the sharded one."""

    loss_reduction = "mean"

    def __init__(self, cfg: XformerConfig, device: str | torch.device | None = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self._init_models()
        self.twin  # noqa: B018 — build now, so a bad config raises here
        self.tx = common.AdamWithClip(cfg.learning_rate, clip_norm=cfg.gradient_clip_norm)

    def _build_models(self, generator: torch.Generator | None):
        return build_transformer_models(self.cfg, self.mesh, seq_len=self.cfg.seq_len,
                                        generator=generator)

    # -- init ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> common.TargetTrainState:
        """Fresh parameters drawn on the CPU from `seed` (the same numbers
        whatever the device), moved to the agent's device; the target
        network starts as a copy."""
        return self.state_from_params(
            init_transformer_params(self.cfg, seq_len=self.cfg.seq_len, seed=seed))

    def _forward(self, params, obs, previous_action, done, return_aux: bool = False,
                 model=None):
        return functional_call(model or self.model, params,
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
        q = self._forward(params, obs_win, prev_action_win.long(), done_win,
                          model=self.twin)[:, -1]
        return common.epsilon_greedy(q, epsilon, self.cfg.num_actions, generator), q

    # -- sequence target math (SequenceReplayLearnMixin) -----------------
    def _sequence_td(self, params, target_params, batch: XformerBatch, model=None):
        """-> (target value, Q(s, a), aux term): the online forward
        collects the routers' terms, the target forward (no gradient) does
        not. `model` (the twin) replaces the learn step's."""
        cfg = self.cfg
        main_q, aux = self._forward(params, batch.state, batch.previous_action, batch.done,
                                    return_aux=True, model=model)
        with torch.no_grad():
            target_q = self._forward(target_params, batch.state, batch.previous_action,
                                     batch.done, model=model)
        discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
        tv, sav = common.sequence_double_q_td(
            main_q, target_q, batch.action, batch.reward, discounts,
            burn_in=cfg.burn_in, rescale_eps=cfg.rescale_eps)
        return tv, sav, self.aux_share(moe_aux_term(cfg, aux))

    @torch.no_grad()
    def _td_error(self, state: common.TargetTrainState, batch: XformerBatch) -> torch.Tensor:
        """|mean_t TD| a sequence, whatever `priority_eta` says: the JAX
        agent's `_td_error` scores ingest so (its `learn` priorities take
        the eta mixture), on the plain-apply twin."""
        tv, sav, _ = self._sequence_td(state.params, state.target_params, batch,
                                       model=self.twin)
        return torch.abs(torch.mean(tv - sav, dim=1))
