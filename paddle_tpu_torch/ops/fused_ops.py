"""The ``fused_elementwise`` op (the port of ``paddle_tpu.ops.fused_ops``):
one op replaying a run of pure elementwise member ops.

Emitted only by the optimization pipeline
(``analysis/opt/passes.py::fuse_elementwise_pass``) — never by the
layers API — so its contract is the pass's contract: members are pure
(no RNG, no state, no sub-blocks, no host), every intermediate is
internal to the run, and the single ``Out`` is the last member's
output.  The lowering replays each member's REGISTERED lowering (the
member lowerings ARE the semantics — AMP slot casts included, since
each member context resolves casts by its own op type), so a fused
program computes the same tensors as its unfused form.  It is not a
kernel: in the eager executor it saves the per-op dispatch of the
members after the first.
"""

from __future__ import annotations

from paddle_tpu_torch.ops.registry import LowerContext, lookup, register_op

__all__ = []


class _OverlayEnv(dict):
    """Local write overlay over the step env: member outputs land here
    (intermediates never leak into the outer env), reads fall through
    to the step env."""

    def __init__(self, base):
        super().__init__()
        self._base = base

    def __missing__(self, key):
        return self._base[key]

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in self._base

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


def _member_ops(op, block):
    """Reconstruct (and cache on the op) the member Operator list from
    the serialized ``sub_ops`` attr."""
    cached = getattr(op, "_fused_members", None)
    if cached is not None:
        return cached
    from paddle_tpu_torch.framework import Operator
    members = [Operator(block, d["type"], d["inputs"], d["outputs"],
                        d["attrs"])
               for d in op.attr("sub_ops", [])]
    op._fused_members = members
    return members


@register_op("fused_elementwise", no_gradient=True)
def fused_elementwise_lower(ctx):
    env = _OverlayEnv(ctx.env)
    for member in _member_ops(ctx.op, ctx.block):
        opdef = lookup(member.type)
        if opdef is None or opdef.lower is None:
            raise NotImplementedError(
                f"fused_elementwise member {member.type!r} has no "
                f"registered lowering")
        mctx = LowerContext(member, env, ctx.block, aux=ctx.aux,
                            op_index=ctx.op_index)
        opdef.lower(mctx)
        env.update(mctx.outputs)
    out = ctx.op.output("Out")[0]
    ctx.set_output("Out", env[out])
