"""Operator registry: shape inference and forward lowerings over torch
tensors (the forward half of ``paddle_tpu.ops.registry``; reference
``paddle/fluid/framework/op_registry.h:62``).

Each op registers ONE ``lower`` function, a function from input tensors
to output tensors; the port's Executor calls them op by op.  Shape
inference is the JAX package's, unchanged, so a program built with the
port serializes to the same IR dict.  Gradient ops wait for the training
slice.
"""

from __future__ import annotations

__all__ = [
    "OpDef", "register_op", "lookup", "all_ops", "resolve_lowering",
    "LowerContext", "run_lowering", "ShapeInferenceSkip",
    "infer_shape_unary", "infer_shape_elementwise",
]

_REGISTRY = {}


class ShapeInferenceSkip(Exception):
    """Raised by infer_shape when shapes cannot be determined at build time."""


class OpDef:
    def __init__(self, type, lower=None, infer_shape=None):
        self.type = type
        self.lower = lower
        self.infer_shape = infer_shape


def register_op(type, *, infer_shape=None):
    """Decorator: register ``fn(ctx)`` as the lowering for op ``type``."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, lower=fn, infer_shape=infer_shape)
        return fn

    return deco


def lookup(type):
    return _REGISTRY.get(type)


def all_ops():
    return dict(_REGISTRY)


def resolve_lowering(op_type):
    """The registered :class:`OpDef` of ``op_type``; raises when the port
    has no lowering for it."""
    opdef = lookup(op_type)
    if opdef is None or opdef.lower is None:
        raise NotImplementedError(
            f"no lowering registered for op {op_type!r} in paddle_tpu_torch")
    return opdef


# ---------------------------------------------------------------------------
# common shape-inference helpers (copied from the JAX package so the IR
# dicts of the two packages agree)
# ---------------------------------------------------------------------------

def infer_shape_unary(in_slot="X", out_slot="Out"):
    """Out has the same shape/dtype as the (first) input."""

    def fn(op, block):
        xs = op.input(in_slot)
        outs = op.output(out_slot)
        if not xs or not outs:
            raise ShapeInferenceSkip()
        x = block.var(xs[0])
        for o in outs:
            ov = block.var(o)
            ov.shape = x.shape
            ov.dtype = x.dtype
            ov.lod_level = x.lod_level

    return fn


def infer_shape_elementwise(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape  # paddle semantics: Out matches X (Y broadcasts)
    out.dtype = x.dtype
    out.lod_level = x.lod_level


# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------

class LowerContext:
    """Hands an op lowering its input tensors / attrs; collects outputs.

    ``env`` maps variable name -> torch tensor.  ``aux`` carries
    executor-level services: ``device`` (the run's ``torch.device``) and
    ``generator`` (the run's ``torch.Generator`` for random init ops).
    """

    def __init__(self, op, env, block, aux=None):
        self.op = op
        self.env = env
        self.block = block
        self.aux = aux or {}
        self.outputs = {}

    @property
    def device(self):
        return self.aux["device"]

    # -- inputs ------------------------------------------------------------
    def input(self, slot):
        names = self.op.input(slot)
        if not names:
            return None
        return self.env[names[0]]

    # -- attrs -------------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attr(name, default)

    # -- outputs -----------------------------------------------------------
    def set_output(self, slot, value):
        names = self.op.output(slot)
        if not names:
            return
        self.outputs[names[0]] = value


def run_lowering(op, env, block, aux=None):
    """Execute one op's lowering against ``env``; merge outputs into env."""
    opdef = resolve_lowering(op.type)
    ctx = LowerContext(op, env, block, aux=aux)
    opdef.lower(ctx)
    env.update(ctx.outputs)
    return ctx.outputs
