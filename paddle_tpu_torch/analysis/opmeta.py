"""Shared op-metadata registry (the port of ``paddle_tpu.analysis.
opmeta``): ONE place that classifies op types as pure / effectful /
stateful / host / sub-block-carrying.

Its consumers in the JAX package are the dead-op lint, the optimization
passes (DCE may only remove what is provably effect-free, CSE may only
merge what is provably pure, fusion may only collapse what is provably
elementwise-pure) and the static cost model; they are ported after it
and must import the classification from HERE: a scanner test
(``tests/test_torch_optim.py``) fails any module of the port that grows
its own effect-op list.

The primitive facts come from the op registry itself
(:class:`paddle_tpu_torch.ops.registry.OpDef`: ``host``, ``uses_rng``,
``stateful_outputs``) plus the runtime families the registry cannot
express per-opdef (readers, CSP channels, persistence ops).
"""

from __future__ import annotations

from paddle_tpu_torch import framework

__all__ = ["EFFECT_OP_TYPES", "ELEMENTWISE_PURE_OPS", "sub_blocks",
           "has_sub_block", "has_effects", "is_pure", "is_host",
           "uses_rng", "stateful_output_names", "needs_rng_key",
           "writes_persistable"]

#: op families with effects beside their dataflow outputs even though
#: their opdef declares none: executor-rewritten ops, host I/O,
#: CSP/channel runtime ops, counters mutated in place (mirrors
#: ``executor._SKIP_OPS`` + the runtime channel family).  This is the
#: ONE owning definition — the dead-op lint and the DCE pass both
#: import it (scanner-enforced).
EFFECT_OP_TYPES = frozenset({
    "feed", "fetch", "read", "print", "assert", "save", "load",
    "save_combine", "load_combine", "send", "recv", "go", "select",
    "channel_send", "channel_recv", "channel_close", "increment",
})

#: pure elementwise op types the fusion pass may collapse into one
#: traced closure: output shape == X's shape, no RNG, no state, no
#: sub-block, value depends only on the listed inputs.  Deliberately a
#: closed allow-list (not "everything pure"): fusion changes trace
#: structure, so each member is vouched for individually.
ELEMENTWISE_PURE_OPS = frozenset({
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "abs", "square",
    "softsign", "softplus", "relu6", "leaky_relu", "elu", "gelu",
    "hard_sigmoid", "swish", "brelu", "pow", "reciprocal", "floor",
    "ceil", "round", "sin", "cos", "clip", "scale",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "cast", "fill_zeros_like", "label_smooth",
})


def sub_blocks(op):
    """The Block attrs an op carries (while/cond/recurrent bodies)."""
    for a in op.attrs.values():
        if isinstance(a, framework.Block):
            yield a


def has_sub_block(op):
    return any(True for _ in sub_blocks(op))


def has_effects(op, registry=None):
    """True when removing this op could change anything beside its
    dataflow outputs: host ops, declared in-place state updates, RNG
    consumers, reader/CSP/persistence families, sub-block carriers.
    The dead-op lint's exemption predicate AND the DCE pass's removal
    guard — one definition, so they can never disagree."""
    if registry is None:
        from paddle_tpu_torch.ops import registry
    if op.type in EFFECT_OP_TYPES or op.type.startswith("create_"):
        return True
    opdef = registry.lookup(op.type)
    if opdef is not None and (opdef.host or opdef.stateful_outputs or
                              opdef.uses_rng):
        return True
    return has_sub_block(op)


def writes_persistable(op, block):
    """True when any output var of ``op`` is persistable in ``block``'s
    scope chain — a persistable write IS an effect (state survives the
    step), whatever the opdef says."""
    for n in op.output_arg_names:
        if not n:
            continue
        try:
            v = block.var(n)
        except KeyError:
            continue
        if getattr(v, "persistable", False):
            return True
    return False


def is_pure(op, block, registry=None):
    """Provably pure: no effects, no persistable writes — removing or
    deduplicating the op is observationally invisible as long as its
    outputs are re-derivable.  The CSE/fold eligibility predicate."""
    if registry is None:
        from paddle_tpu_torch.ops import registry
    return not has_effects(op, registry) and \
        not writes_persistable(op, block)


def is_host(op, registry=None):
    if registry is None:
        from paddle_tpu_torch.ops import registry
    opdef = registry.lookup(op.type)
    return opdef is not None and opdef.host


def uses_rng(op, registry=None):
    if registry is None:
        from paddle_tpu_torch.ops import registry
    opdef = registry.lookup(op.type)
    return opdef is not None and opdef.uses_rng


def stateful_output_names(op, registry=None):
    """Names this op updates IN PLACE per its opdef's
    ``stateful_outputs`` declaration (the donation planner's facts)."""
    if registry is None:
        from paddle_tpu_torch.ops import registry
    opdef = registry.lookup(op.type)
    if opdef is None or not opdef.stateful_outputs:
        return []
    return [n for slot in opdef.stateful_outputs
            for n in op.output(slot) if n]


def needs_rng_key(op, registry=None):
    """Whether the executor must hand this op a seeded generator:
    declared RNG consumers, sub-block carriers (their body ops draw from
    the op's seed), and unknown op types (no opdef — assume the worst).  Ops outside this set never call
    ``ctx.generator()`` (the registry contract: auto-vjp refuses RNG
    forwards, so ``*_grad`` of an RNG op always has an explicit,
    generator-free grad lowering)."""
    if registry is None:
        from paddle_tpu_torch.ops import registry
    opdef = registry.lookup(op.type)
    if opdef is None:
        if op.type.endswith("_grad"):
            fwd = registry.lookup(op.type[:-len("_grad")])
            if fwd is not None:
                # grads of RNG forwards carry explicit key-free
                # lowerings (registry contract), but stay conservative
                # and key them anyway; grads of key-free forwards
                # auto-vjp the forward, which never sees a key
                return bool(fwd.uses_rng)
        return True
    return bool(opdef.uses_rng) or has_sub_block(op)
