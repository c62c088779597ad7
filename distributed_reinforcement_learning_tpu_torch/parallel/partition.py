"""Partition rules over parameter names, and the shard plans they give.

Counterpart of the rule matcher in the JAX package's
`parallel/partition.py`: regex rules over `/`-joined leaf names give
each leaf a partition spec, and `shard_plan` groups the leaves of a
parameter tree by the key of their spec. The sharded weight plane
(`runtime/weight_shards.py`) publishes one blob per group. A spec is a
plain tuple of mesh axis names or None per dimension (the JAX package's
`PartitionSpec`); `()` replicates.

Leaf names and order come from the codec's canonical flatten
(`data/codec.flatten_with_paths`: sorted dict keys), so a plan's leaf
`i` is the same array in the shard blobs and in a whole-blob encode.

The port's parameters are a flat `{name: array}` dict of its own module
names (`torso.conv0.weight`, leaf name `torso/conv0/weight`), where the
JAX package's are flax trees (`params/torso/conv0_kernel`). The JAX
rules, run on the port's names, would replicate almost every leaf, so
`default_partition_rules` is written over the port's names: each leaf
lands in the shard whose key the JAX rules give its counterpart under
`models/convert.py`'s name map (`tests/test_torch_weight_shards.py`,
every family). A spec names the dims of the JAX layout: a Linear
`weight` is `[out, in]` where the flax kernel is `[in, out]`, and its
spec `(None, "model")` is the kernel's, so that both packages key it
`-,model`. The matcher takes any rule list: given the JAX rules and a
tree with flax names, it gives the JAX package's plan.

`build_exchange_plan` lays the same classes over the learner tier's
flat gradient vector (`parallel/collective.py:ExchangePlan`), walking
the parameter dict in its own order, the order of
`runtime/learner_tier.flatten_tree`. Left out: every device mesh,
ROADMAP item 13b.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data import codec

# The mesh axis names of the JAX package's `parallel/mesh.py`.
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"

# Leaves below this many elements stay replicated whatever rule their
# name matches: the weight plane pools small leaves into the replicated
# shard rather than one micro-shard a LayerNorm scale.
MIN_PARTITION_SIZE = 4096

REPLICATED_KEY = "rep"

Spec = tuple


def leaf_name(codec_path: str) -> str:
    """codec `_flatten` path -> rule-matching name: `$.a.b[2].c` ->
    `a/b[2]/c`."""
    name = codec_path[2:] if codec_path.startswith("$.") else codec_path.lstrip("$")
    return name.replace(".", "/")


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any, sep: str = "/") -> Any:
    """Map `fn(name, leaf)` over a tree with `/`-joined path names, in
    the codec's canonical order."""
    skel, pairs = codec.flatten_with_paths(tree)
    out = [fn(leaf_name(path).replace("/", sep), arr) for path, arr in pairs]
    return codec.assemble(skel, out)


def default_partition_rules() -> tuple[tuple[str, Spec], ...]:
    """(regex, spec) rules over the port's names, first match wins; each
    gives a leaf the key the JAX rules give its flax counterpart:

    - the stacked transformer body (`blocks_stacked/*`) -> `pipe`;
    - the experts' stacked tensors (`moe_w*`, `moe_b*`) -> `expert`;
    - Nature-conv and ResNet-stem kernels, `conv{i}/weight` (flax
      `conv{i}_kernel`, which no JAX rule matches) -> replicated;
    - LayerNorm scales (`ln1`, `ln2`, `final_ln`; flax `scale`) ->
      replicated;
    - every other `weight` (flax `kernel`: Dense layers, ResNet section
      convs, `trunk_out`) and the router gate `moe_gate` -> the JAX
      kernel's `(None, model)`;
    - everything else (biases, the LSTM's fused `gates_kernel`) ->
      replicated, the catch-all, so this rule set never raises.
    """
    return (
        (r"blocks_stacked/", (PIPE_AXIS,)),
        (r"(^|/)moe_(w|b)\d*$", (EXPERT_AXIS,)),
        (r"(^|/)conv\d+/weight$", ()),
        (r"(^|/)(ln\d+|final_ln)/weight$", ()),
        (r"(^|/)(weight|moe_gate)$", (None, MODEL_AXIS)),
        (r".*", ()),
    )


def leaf_spec(rules: Sequence[tuple[str, Spec]], name: str, leaf) -> Spec:
    """The one per-leaf decision: a scalar, size-1 or sub-
    `MIN_PARTITION_SIZE` leaf is never partitioned; otherwise the first
    rule whose regex `search`es the name wins. Raises ValueError when no
    rule matches."""
    arr = np.asarray(leaf)
    if arr.ndim == 0 or arr.size <= 1 or arr.size < MIN_PARTITION_SIZE:
        return ()
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return tuple(spec)
    raise ValueError(f"partition rule not found for param: {name}")


def match_partition_rules(rules: Sequence[tuple[str, Spec]], params: Any) -> Any:
    """The tree of specs, one a leaf, by `leaf_spec`."""
    return named_tree_map(lambda name, leaf: leaf_spec(rules, name, leaf), params)


def spec_key(spec: Spec) -> str:
    """Stable, wire-safe shard key of a spec: `()` -> "rep",
    `(None, "model")` -> "-,model", `("expert",)` -> "expert". Keys are
    manifest and protocol identifiers, the JAX package's for the same
    spec."""
    dims = tuple(spec)
    if not dims or all(d is None for d in dims):
        return REPLICATED_KEY
    return ",".join("-" if d is None else str(d) for d in dims)


class ShardPlan:
    """How one parameter schema splits into named shards: `skel` is the
    codec skeleton, `paths` and `specs` are per leaf in its order, and
    `shards` maps each key to its ascending leaf indices. Every leaf is
    in exactly one shard."""

    __slots__ = ("skel", "paths", "specs", "shards")

    def __init__(self, skel: Any, paths: list[str], specs: list[Spec],
                 shards: dict[str, list[int]]):
        self.skel = skel
        self.paths = paths
        self.specs = specs
        self.shards = shards

    @property
    def keys(self) -> list[str]:
        return list(self.shards)


def shard_plan(params: Any, rules: Sequence[tuple[str, Spec]] | None = None) -> ShardPlan:
    """Split `params` into spec-keyed shards (sorted keys, so two
    processes planning the same schema agree on shard identity and leaf
    order)."""
    if rules is None:
        rules = default_partition_rules()
    skel, pairs = codec.flatten_with_paths(params)
    paths = [leaf_name(p) for p, _ in pairs]
    specs: list[Spec] = []
    groups: dict[str, list[int]] = {}
    for i, (name, (_, arr)) in enumerate(zip(paths, pairs)):
        spec = leaf_spec(rules, name, arr)
        specs.append(spec)
        groups.setdefault(spec_key(spec), []).append(i)
    return ShardPlan(skel, paths, specs, {k: groups[k] for k in sorted(groups)})


def _named_leaves(tree: Any, prefix: str = ""):
    """(rule-matching name, leaf) of a nested dict in its insertion
    order: the order of the port's `state.params` and of the tier's flat
    vector. A name is the codec's, `torso.conv0.weight` ->
    `torso/conv0/weight`."""
    for key, val in tree.items():
        name = prefix + str(key).replace(".", "/")
        if isinstance(val, dict):
            yield from _named_leaves(val, name + "/")
        else:
            yield name, val


def build_exchange_plan(params: Any, rules: Sequence[tuple[str, Spec]] | None = None,
                        quant: str = "f32", overlap: int = 0, tail: int = 0):
    """Classify every leaf of `params` (a gradient-shaped dict of tensors
    or arrays) into its partition-spec class and lay the classes out over
    the learner tier's flat vector: a `parallel/collective.ExchangePlan`.

    The entries walk the dict in its own order, as `flatten_tree` does,
    so the plan's segment `i` is the vector's leaf `i`; the class of each
    leaf is `leaf_spec`'s, by name. `tail` appends that many replicated
    elements for the values the tier rides on the vector's end (the
    loss). Two seats building a plan from the same schema, rules and
    config get byte-identical entries and so the same `plan_hash`; the
    classes and sizes equal the JAX package's plan leaf by leaf name,
    though flax orders its leaves otherwise."""
    from distributed_reinforcement_learning_tpu_torch.parallel.collective import ExchangePlan

    if rules is None:
        rules = default_partition_rules()
    entries = []
    for name, leaf in _named_leaves(params):
        # A zero-stride view: leaf_spec reads only the rank and the size,
        # and a device tensor is never copied to the host for them.
        shape = np.broadcast_to(np.float32(0), tuple(np.shape(leaf)))
        entries.append((spec_key(leaf_spec(rules, name, shape)), int(shape.size)))
    if tail:
        entries.append((REPLICATED_KEY, int(tail)))
    return ExchangePlan(entries, quant=quant, overlap=overlap)
