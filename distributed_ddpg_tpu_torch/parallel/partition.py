"""The regex partition-rule engine: param-tree paths -> placement specs.

Counterpart of distributed_ddpg_tpu/parallel/partition.py, with its
semantics and messages. A spec is a tuple with one entry per dim of its
leaf, "model" where the dim is split over the model axis and None where
it is whole (the JAX package's PartitionSpec, as a plain tuple: `()` is a
scalar's, `(None, "model")` a column-parallel kernel's).

- paths: a leaf's path is its tree path '/'-joined (the actor's layer-2
  kernel is `2/w`); rules are matched with `re.search`;
- the first matching rule wins;
- a spec shorter than its leaf aligns to the trailing dims, so one rule
  covers a critic kernel [in, out] and the TD3 ensemble's [2, in, out];
- a leaf whose sharded dim does not divide the model axis is replicated
  whole (the critic's action-insert layer, hidden + act wide, usually);
- scalars are replicated without consulting the table;
- a path no rule matches raises PartitionRuleError.

The default table (`mlp_rules`) is Megatron's alternation: even layers
column-parallel (the output dim split, the bias with it), odd layers
row-parallel (the input dim split, the bias whole: it adds after the sum
over the model group), the last layer whole. `state_pspec` derives the
Adam moments and the targets from the params' own tables, so params and
optimizer state never split differently.

`shard_tree` and `unshard_tree` move a tree between its logical form and
one rank's shards: a dim marked "model" is cut into M contiguous blocks
and model rank m holds block m (the JAX package's NamedSharding over a
(data, model) mesh places blocks the same way).
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Sequence, Tuple

from distributed_ddpg_tpu_torch.models.mlp import NetTP
from distributed_ddpg_tpu_torch.types import OptState, TrainState

Spec = Tuple[Optional[str], ...]
# One rule: (regex over the '/'-joined tree path, spec).
Rule = Tuple[str, Spec]
MODEL = "model"


class PartitionRuleError(ValueError):
    """A param-tree path matched no rule in the table. Every leaf must be
    placed on purpose: extend the table rather than let a new layer
    replicate silently."""


DEFAULT_MLP_RULES: Tuple[Rule, ...] = (
    # even layers: column-parallel (the output dim split; the bias too)
    (r"(^|/)\d*[02468]/w$", (None, MODEL)),
    (r"(^|/)\d*[02468]/b$", (MODEL,)),
    # odd layers: row-parallel (the input dim split; the bias whole)
    (r"(^|/)\d*[13579]/w$", (MODEL, None)),
    (r"(^|/)\d*[13579]/b$", (None,)),
)


def mlp_rules(num_layers: int) -> Tuple[Rule, ...]:
    """The default table for an MLP of `num_layers` {w, b} layers: the
    last layer whole (its override first), the rest by parity."""
    last = num_layers - 1
    return (
        (rf"(^|/){last}/w$", (None, None)),
        (rf"(^|/){last}/b$", (None,)),
    ) + DEFAULT_MLP_RULES


def _fit(spec: Spec, shape: Tuple[int, ...], model_size: int) -> Spec:
    """`spec` aligned to a leaf of `shape` under a model axis of
    `model_size`: trailing-dim alignment, and the whole leaf replicated
    when model_size is 1 or a sharded dim does not divide it."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise PartitionRuleError(
            f"rule spec {spec} has rank {len(spec)} but the leaf has "
            f"shape {shape} — a spec must not outrank its leaf"
        )
    full = (None,) * (len(shape) - len(spec)) + spec
    replicated = (None,) * len(shape)
    if model_size == 1:
        return replicated
    for dim, ax in zip(shape, full):
        if ax is not None and dim % model_size != 0:
            return replicated
    return full


def _map_with_path(fn, tree, path=()):
    """fn('/'-joined path, leaf) over a tree of dicts, lists, tuples and
    NamedTuples (fields by name); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def match_partition_rules(rules: Sequence[Rule], tree, model_size: int):
    """The spec tree of `tree` under the ordered rule table: scalars
    replicate, the first matching rule's spec is fitted by _fit, and an
    unmatched path raises PartitionRuleError."""

    def place(name, leaf):
        shape = tuple(int(d) for d in getattr(leaf, "shape", ()))
        if len(shape) == 0:
            return ()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return _fit(spec, shape, model_size)
        raise PartitionRuleError(
            f"no partition rule matches param path {name!r} (shape "
            f"{shape}) — extend the rule table (docs/MESH.md 'add a "
            "rule'); every leaf must be placed on purpose"
        )

    return _map_with_path(place, tree)


def net_pspec(params, model_size: int, rules: Optional[Sequence[Rule]] = None):
    """Spec tree of one {w, b}-layer param tuple; the default rules are
    mlp_rules(len(params))."""
    return match_partition_rules(
        mlp_rules(len(params)) if rules is None else rules, params, model_size)


def state_pspec(state: TrainState, model_size: int,
                actor_rules: Optional[Sequence[Rule]] = None,
                critic_rules: Optional[Sequence[Rule]] = None) -> TrainState:
    """The spec tree of a TrainState: the params, their targets and their
    Adam moments from one table a net; the step, the counts and SAC's
    temperature replicated."""
    actor = net_pspec(state.actor_params, model_size, rules=actor_rules)
    critic = net_pspec(state.critic_params, model_size, rules=critic_rules)
    return TrainState(
        actor_params=actor,
        critic_params=critic,
        target_actor_params=actor,
        target_critic_params=critic,
        actor_opt=OptState(mu=actor, nu=actor, count=()),
        critic_opt=OptState(mu=critic, nu=critic, count=()),
        step=(),
        log_alpha=None if state.log_alpha is None else (),
        alpha_opt=None if state.alpha_opt is None else OptState(mu=(), nu=(), count=()),
    )


def _zip_map(fn, tree, specs):
    """fn(leaf, spec) over a tree and its spec tree (the same structure,
    with a spec tuple in each leaf's place)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def sharded_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over the model axis, or None (replicated)."""
    dims = [i for i, ax in enumerate(spec) if ax == MODEL]
    if len(dims) > 1:
        raise PartitionRuleError(f"spec {spec} splits more than one dim over 'model'")
    return dims[0] if dims else None


def shard_tree(tree, specs, model_rank: int, model_size: int):
    """Model rank `model_rank`'s shards of a logical tree (torch tensors or
    numpy arrays): each sharded dim cut into `model_size` contiguous blocks,
    block `model_rank` kept (a copy); replicated leaves pass as they are."""

    def cut(leaf, spec):
        d = sharded_dim(spec)
        if d is None or model_size == 1:
            return leaf
        n = leaf.shape[d] // model_size
        index = [slice(None)] * len(leaf.shape)
        index[d] = slice(model_rank * n, (model_rank + 1) * n)
        part = leaf[tuple(index)]
        return part.clone() if hasattr(part, "clone") else part.copy()

    return _zip_map(cut, tree, specs)


def unshard_tree(shards, specs, group):
    """The logical tree from each model rank's shards: every sharded leaf
    gathered over `group` (the model group, a parallel/mesh.DataGroup) and
    its blocks joined along the sharded dim, in model-rank order. A
    collective: every rank of the group calls it. Without a group, or with
    one rank, the shards themselves."""
    if group is None or group.world_size == 1:
        return shards
    import torch

    from distributed_ddpg_tpu_torch.parallel.mesh import all_gather

    def join(leaf, spec):
        d = sharded_dim(spec)
        if d is None:
            return leaf
        return torch.cat(all_gather(leaf.contiguous(), group).unbind(0), dim=d)

    return _zip_map(join, shards, specs)


class TP(NamedTuple):
    """A rank's tensor-parallel split of the two nets (models/mlp.NetTP
    each), what the learner step and the losses take as `tp`."""

    actor: NetTP
    critic: NetTP


def layer_kinds(net_specs) -> Tuple[str, ...]:
    """Each layer's Megatron kind from a net's spec tree: "col" (w's output
    dim split, b split with it), "row" (w's input dim split, b whole) or
    "rep" (both whole). Any other placement raises PartitionRuleError:
    the apply (models/mlp.py) knows these three."""
    kinds = []
    for i, layer in enumerate(net_specs):
        w, b = layer["w"], layer["b"]
        dw, db = sharded_dim(w), sharded_dim(b)
        if dw is None and db is None:
            kinds.append("rep")
        elif dw == len(w) - 1 and db == len(b) - 1:
            kinds.append("col")
        elif dw == len(w) - 2 and db is None:
            kinds.append("row")
        else:
            raise PartitionRuleError(
                f"layer {i} is placed w {w}, b {b}: no Megatron split (column: the "
                "output dim of w and b; row: the input dim of w, b whole)")
    return tuple(kinds)


def make_tp(specs: TrainState, model_group) -> Optional[TP]:
    """The TP of a state's spec tree over `model_group` (a
    parallel/mesh.DataGroup view); None with no group or a group of one."""
    if model_group is None or model_group.world_size == 1:
        return None
    return TP(NetTP(layer_kinds(specs.actor_params), model_group),
              NetTP(layer_kinds(specs.critic_params), model_group))
