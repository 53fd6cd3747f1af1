"""Shape & dtype inference pass: dataflow over the Program IR (the
port's copy of ``paddle_tpu.analysis.typecheck``, with the same rules and
messages, so a finding reads the same in both packages).

Unlike the build-time ``registry.infer_shape`` hooks (best-effort hints
that mutate the Variables as layers are appended), this pass trusts
NOTHING it cannot prove.  It seeds a shadow environment from the
program's declared roots — ``is_data`` feeds, Parameters and other
persistables (whose shapes/dtypes the user or the initializer pinned) —
and propagates shapes/dtypes forward through per-op-type **rules**
registered with :func:`rule`.  An op type without a rule propagates
*unknown* for its outputs and lands on the warn-list
(``TypeEnv.uncovered``) instead of guessing; a rule only reports a
mismatch (PTA005/PTA006) when every participating dim/dtype is
statically known.  That is the zero-false-positive contract: silence is
allowed, wrong noise is not.

Registering a rule for a new op::

    from paddle_tpu_torch.analysis import typecheck

    @typecheck.rule("my_op")
    def _my_op(op, tc):
        x = tc.info(op.input("X")[0])
        if x.dtype is not None and x.dtype not in ("float32", "bfloat16"):
            tc.report("PTA005", f"my_op needs a float X, got {x.dtype}",
                      op=op, var=op.input("X")[0])
        tc.set_output(op, "Out", shape=x.shape, dtype=x.dtype)

``-1``/``None`` dims mean *unknown* and match anything; ``dtype=None``
likewise.  PTA010 (int64 → i32 lane truncation) also lives here: the
``fill_constant``/``fill`` rules prove from the literal attr value that
a device-side int64 constant exceeds int32 range.  That is a contract of
the IR shared with the JAX package, which runs int64 as int32 (its
x64-off mode and the pipeline transpiler's i32 carrier lane): such a
value silently wraps there, so the program is flagged in both packages.
"""

from __future__ import annotations

import logging

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.analysis.diagnostics import Diagnostic

logger = logging.getLogger(__name__)

__all__ = ["rule", "check_types", "TypeEnv", "VarInfo", "covered_op_types",
           "INT32_MAX", "INT32_MIN", "int64_fits_i32_lane"]

INT32_MAX = np.iinfo(np.int32).max
INT32_MIN = np.iinfo(np.int32).min

_RULES = {}

_INT_DTYPES = ("int8", "uint8", "int16", "int32", "int64", "bool")


def rule(*op_types):
    """Decorator registering ``fn(op, tc)`` as the inference rule for
    one or more op types (the analysis-side analog of
    ``registry.register_op``'s ``infer_shape``)."""

    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn

    return deco


def covered_op_types():
    return set(_RULES)


def int64_fits_i32_lane(values):
    """True when every value is exactly representable in int32 — the
    contract of the pipeline transpiler's i32 carrier lane and of JAX's
    x64-off int handling."""
    a = np.asarray(values)
    if a.size == 0:
        return True
    return bool(a.max() <= INT32_MAX and a.min() >= INT32_MIN)


class VarInfo:
    __slots__ = ("shape", "dtype")

    def __init__(self, shape=None, dtype=None):
        # normalize: unknown dims -> -1; unknown shape -> None
        self.shape = None if shape is None else tuple(
            -1 if d is None or int(d) < 0 else int(d) for d in shape)
        self.dtype = dtype

    def __repr__(self):
        return f"VarInfo(shape={self.shape}, dtype={self.dtype})"


_UNKNOWN = VarInfo()


class TypeEnv:
    """Shadow (shape, dtype) environment threaded through one block."""

    def __init__(self, block, diags, uncovered, op_index=None):
        self.block = block
        self.diags = diags
        self.uncovered = uncovered
        self.op_index = op_index
        self._env = {}

    # -- reads -------------------------------------------------------------
    def info(self, name):
        if not name:
            return _UNKNOWN
        if name in self._env:
            return self._env[name]
        # trusted roots: declared feeds and persistable state carry
        # user/initializer-pinned metadata; scratch vars do not (their
        # declared dtype is just the auto-declare default)
        try:
            v = self.block.var(name)
        except KeyError:
            return _UNKNOWN
        if getattr(v, "is_data", False) or getattr(v, "persistable", False):
            return VarInfo(v.shape, v.dtype)
        return _UNKNOWN

    def input_info(self, op, slot):
        names = op.input(slot)
        return self.info(names[0]) if names else _UNKNOWN

    # -- writes ------------------------------------------------------------
    def set(self, name, shape=None, dtype=None):
        if name:
            self._env[name] = VarInfo(shape, dtype)

    def set_output(self, op, slot, shape=None, dtype=None):
        for n in op.output(slot):
            self.set(n, shape=shape, dtype=dtype)

    def copy_unary(self, op, in_slot="X", out_slot="Out"):
        x = self.input_info(op, in_slot)
        self.set_output(op, out_slot, shape=x.shape, dtype=x.dtype)

    # -- reporting ---------------------------------------------------------
    def report(self, code, message, op=None, var=None):
        self.diags.append(Diagnostic(
            code, message, block_idx=self.block.idx,
            op_index=self.op_index,
            op_type=op.type if op is not None else None, var=var,
            site=getattr(op, "creation_site", None)))


def _dims_conflict(a, b):
    """Both known and different (the provable-mismatch predicate)."""
    return a != -1 and b != -1 and a != b


def check_types(program):
    """Run the inference pass over every block reachable from block 0.

    Returns ``(diagnostics, uncovered_op_types)`` where the second item
    is the warn-list: op types seen in the program that have no
    registered inference rule (their outputs propagated as unknown)."""
    diags = []
    uncovered = set()
    _check_block(program.global_block(), diags, uncovered, parent_env=None)
    return diags, uncovered


def _check_block(block, diags, uncovered, parent_env):
    tc = TypeEnv(block, diags, uncovered)
    if parent_env is not None:
        tc._env.update(parent_env)
    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        tc.op_index = i
        fn = _RULES.get(op.type)
        if fn is None:
            uncovered.add(op.type)
            for n in op.output_arg_names:
                tc.set(n)  # unknown stops propagation, never misreports
        else:
            try:
                fn(op, tc)
            except Exception:  # lint must never crash on the malformed
                # programs it exists to diagnose (e.g. an op that lost a
                # required input slot): degrade this op to no-rule
                # behavior — outputs unknown, op on the warn-list — and
                # let the structural pass name the actual defect
                logger.warning(
                    "analysis rule for op %r failed; treating the op as "
                    "uncovered", op.type, exc_info=True)
                uncovered.add(op.type)
                for n in op.output_arg_names:
                    tc.set(n)
        for a in op.attrs.values():
            if isinstance(a, framework.Block):
                _check_block(a, diags, uncovered, parent_env=tc._env)
    return tc


# ---------------------------------------------------------------------------
# core rules
# ---------------------------------------------------------------------------

_UNARY_OPS = (
    "relu", "sigmoid", "tanh", "exp", "log", "sqrt", "abs", "square",
    "softmax", "softsign", "softplus", "relu6", "leaky_relu", "elu",
    "gelu", "hard_sigmoid", "swish", "brelu", "pow", "reciprocal",
    "floor", "ceil", "round", "sin", "cos", "clip", "scale", "assign",
    "dropout", "label_smooth", "sequence_softmax", "fill_zeros_like",
)


@rule(*_UNARY_OPS)
def _r_unary(op, tc):
    tc.copy_unary(op)


@rule("mul")
def _r_mul(op, tc):
    x = tc.input_info(op, "X")
    y = tc.input_info(op, "Y")
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    out_shape = None
    if x.dtype is not None and y.dtype is not None and x.dtype != y.dtype:
        tc.report("PTA005",
                  f"mul operands disagree on dtype: X `{op.input('X')[0]}` "
                  f"is {x.dtype}, Y `{op.input('Y')[0]}` is {y.dtype}",
                  op=op, var=op.input("X")[0])
    if x.shape is not None and y.shape is not None and \
            len(x.shape) >= xn and len(y.shape) >= yn:
        k_x = _prod(x.shape[xn:])
        k_y = _prod(y.shape[:yn])
        if k_x is not None and k_y is not None and k_x != k_y:
            tc.report("PTA006",
                      f"mul inner dimensions differ: X "
                      f"`{op.input('X')[0]}` {x.shape} flattens to "
                      f"[*, {k_x}] but Y `{op.input('Y')[0]}` {y.shape} "
                      f"flattens to [{k_y}, *]",
                      op=op, var=op.input("X")[0])
        out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    tc.set_output(op, "Out", shape=out_shape, dtype=x.dtype)


def _prod(dims):
    n = 1
    for d in dims:
        if d == -1:
            return None
        n *= d
    return n


@rule("matmul")
def _r_matmul(op, tc):
    x = tc.input_info(op, "X")
    y = tc.input_info(op, "Y")
    if x.dtype is not None and y.dtype is not None and x.dtype != y.dtype:
        tc.report("PTA005",
                  f"matmul operands disagree on dtype: {x.dtype} vs "
                  f"{y.dtype}", op=op, var=op.input("X")[0])
    out_shape = None
    if x.shape is not None and y.shape is not None and \
            len(x.shape) >= 2 and len(y.shape) >= 2:
        xs = list(x.shape)
        ys = list(y.shape)
        if op.attr("transpose_X", False):
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if op.attr("transpose_Y", False):
            ys[-1], ys[-2] = ys[-2], ys[-1]
        if _dims_conflict(xs[-1], ys[-2]):
            tc.report("PTA006",
                      f"matmul contraction dims differ: X "
                      f"`{op.input('X')[0]}` {x.shape} contracts "
                      f"{xs[-1]} against Y `{op.input('Y')[0]}` "
                      f"{y.shape}'s {ys[-2]}",
                      op=op, var=op.input("X")[0])
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        out_shape = tuple(batch) + (xs[-2], ys[-1])
    tc.set_output(op, "Out", shape=out_shape, dtype=x.dtype)


@rule("elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "elementwise_max", "elementwise_min",
      "elementwise_pow")
def _r_elementwise(op, tc):
    x = tc.input_info(op, "X")
    y = tc.input_info(op, "Y")
    if x.dtype is not None and y.dtype is not None and x.dtype != y.dtype:
        tc.report("PTA005",
                  f"{op.type} operands disagree on dtype: X "
                  f"`{op.input('X')[0]}` is {x.dtype}, Y "
                  f"`{op.input('Y')[0]}` is {y.dtype} (insert a cast)",
                  op=op, var=op.input("Y")[0])
    if x.shape is not None and y.shape is not None:
        axis = op.attr("axis", -1)
        if axis == -1:
            axis = len(x.shape) - len(y.shape)
        ok = 0 <= axis and axis + len(y.shape) <= len(x.shape)
        if ok:
            for i, dy in enumerate(y.shape):
                dx = x.shape[axis + i]
                if dy != 1 and _dims_conflict(dx, dy):
                    ok = False
                    break
        if not ok:
            tc.report("PTA006",
                      f"{op.type}: Y `{op.input('Y')[0]}` {y.shape} does "
                      f"not broadcast into X `{op.input('X')[0]}` "
                      f"{x.shape} at axis {op.attr('axis', -1)}",
                      op=op, var=op.input("Y")[0])
    tc.set_output(op, "Out", shape=x.shape, dtype=x.dtype)


@rule("sum")
def _r_sum(op, tc):
    infos = [tc.info(n) for n in op.input("X")]
    shape = None
    dtype = None
    for n, inf in zip(op.input("X"), infos):
        if inf.dtype is not None:
            if dtype is not None and inf.dtype != dtype:
                tc.report("PTA005",
                          f"sum inputs disagree on dtype: `{n}` is "
                          f"{inf.dtype}, earlier inputs are {dtype}",
                          op=op, var=n)
            dtype = dtype or inf.dtype
        if inf.shape is not None:
            if shape is not None and len(shape) == len(inf.shape) and \
                    any(_dims_conflict(a, b)
                        for a, b in zip(shape, inf.shape)):
                tc.report("PTA006",
                          f"sum inputs disagree on shape: `{n}` is "
                          f"{inf.shape}, earlier inputs are {shape}",
                          op=op, var=n)
            shape = shape or inf.shape
    tc.set_output(op, "Out", shape=shape, dtype=dtype)


@rule("cast")
def _r_cast(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Out", shape=x.shape,
                  dtype=op.attr("out_dtype", op.attr("dtype")))


@rule("mean")
def _r_mean(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Out", shape=(1,), dtype=x.dtype)


@rule("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
      "reduce_prod")
def _r_reduce(op, tc):
    x = tc.input_info(op, "X")
    shape = None
    if x.shape is not None:
        dims = op.attr("dim")
        keep = op.attr("keep_dim", False)
        if op.attr("reduce_all", False) or dims is None:
            shape = (1,) * len(x.shape) if keep else (1,)
        else:
            dims = [d % len(x.shape) for d in
                    (dims if isinstance(dims, (list, tuple)) else [dims])]
            shape = tuple(1 if i in dims else d
                          for i, d in enumerate(x.shape)) if keep else \
                tuple(d for i, d in enumerate(x.shape) if i not in dims) \
                or (1,)
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("cross_entropy")
def _r_cross_entropy(op, tc):
    x = tc.input_info(op, "X")
    label = tc.input_info(op, "Label")
    if not op.attr("soft_label", False) and label.dtype is not None and \
            label.dtype not in ("int32", "int64"):
        tc.report("PTA005",
                  f"cross_entropy with hard labels needs an integer "
                  f"Label, got {label.dtype} for "
                  f"`{op.input('Label')[0]}`",
                  op=op, var=op.input("Label")[0])
    if x.shape is not None and label.shape is not None and \
            len(x.shape) == len(label.shape) and \
            _dims_conflict(x.shape[0], label.shape[0]):
        tc.report("PTA006",
                  f"cross_entropy batch dims differ: X {x.shape} vs "
                  f"Label {label.shape}", op=op, var=op.input("X")[0])
    shape = None
    if x.shape is not None:
        shape = tuple(x.shape[:-1]) + (1,)
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("softmax_with_cross_entropy")
def _r_softmax_xent(op, tc):
    x = tc.input_info(op, "Logits")
    tc.set_output(op, "Softmax", shape=x.shape, dtype=x.dtype)
    shape = tuple(x.shape[:-1]) + (1,) if x.shape is not None else None
    tc.set_output(op, "Loss", shape=shape, dtype=x.dtype)


@rule("accuracy")
def _r_accuracy(op, tc):
    out = tc.input_info(op, "Out")
    label = tc.input_info(op, "Label")
    if label.dtype is not None and label.dtype not in ("int32", "int64"):
        tc.report("PTA005",
                  f"accuracy needs an integer Label, got {label.dtype}",
                  op=op, var=op.input("Label")[0])
    if out.shape is not None and label.shape is not None and \
            _dims_conflict(out.shape[0], label.shape[0]):
        tc.report("PTA006",
                  f"accuracy batch dims differ: Out {out.shape} vs "
                  f"Label {label.shape}", op=op, var=op.input("Out")[0])
    tc.set_output(op, "Accuracy", shape=(1,), dtype="float32")
    tc.set_output(op, "Correct", shape=(1,), dtype="int64")
    tc.set_output(op, "Total", shape=(1,), dtype="int64")


@rule("top_k")
def _r_top_k(op, tc):
    x = tc.input_info(op, "X")
    k = op.attr("k", 1)
    shape = tuple(x.shape[:-1]) + (k,) if x.shape is not None else None
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)
    tc.set_output(op, "Indices", shape=shape, dtype="int64")


@rule("lookup_table")
def _r_lookup_table(op, tc):
    ids = tc.input_info(op, "Ids")
    w = tc.input_info(op, "W")
    if ids.dtype is not None and ids.dtype not in ("int32", "int64"):
        tc.report("PTA005",
                  f"lookup_table Ids `{op.input('Ids')[0]}` must be "
                  f"integer, got {ids.dtype}",
                  op=op, var=op.input("Ids")[0])
    shape = None
    if ids.shape is not None and w.shape is not None and \
            len(w.shape) == 2:
        lead = ids.shape[:-1] if ids.shape and ids.shape[-1] == 1 \
            else ids.shape
        shape = tuple(lead) + (w.shape[1],)
    tc.set_output(op, "Out", shape=shape, dtype=w.dtype)


# -- sparse / CTR family (ops/sparse_ops.py) --------------------------------
#
# SelectedRows values flow through ordinary variables; their static
# type is the LOGICAL dense shape ([height, dim]) — the same convention
# ``lookup_table_grad``'s mirror rule applies to its SelectedRows
# cotangent (W@GRAD gets W's [vocab, dim] shape regardless of how many
# rows the batch touched), so the optimizer Param/Grad agreement check
# sees through the sparse path unchanged.

@rule("merge_selected_rows", "get_tensor_from_selected_rows")
def _r_selected_rows_unary(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Out", shape=x.shape, dtype=x.dtype)


@rule("split_ids")
def _r_split_ids(op, tc):
    ids = tc.input_info(op, "Ids")
    if ids.dtype is not None and ids.dtype not in ("int32", "int64"):
        tc.report("PTA005",
                  f"split_ids Ids `{op.input('Ids')[0]}` must be "
                  f"integer, got {ids.dtype}",
                  op=op, var=op.input("Ids")[0])
    n = None
    if ids.shape is not None:
        n = 1
        for d in ids.shape:
            if d is None or d < 0:
                n = -1
                break
            n *= int(d)
    for name in op.output("Out"):
        tc.set(name, shape=None if n is None else (n, 1),
               dtype=ids.dtype)


@rule("split_selected_rows")
def _r_split_selected_rows(op, tc):
    x = tc.input_info(op, "X")
    sections = op.attr("height_sections", []) or []
    names = op.output("Out")
    for i, name in enumerate(names):
        shape = None
        if x.shape is not None and len(x.shape) >= 2 and \
                i < len(sections):
            shape = (int(sections[i]),) + tuple(x.shape[1:])
        tc.set(name, shape=shape, dtype=x.dtype)


@rule("nce")
def _r_nce(op, tc):
    x = tc.input_info(op, "Input")
    label = tc.input_info(op, "Label")
    if label.dtype is not None and label.dtype not in ("int32", "int64"):
        tc.report("PTA005",
                  f"nce Label `{op.input('Label')[0]}` must be "
                  f"integer, got {label.dtype}",
                  op=op, var=op.input("Label")[0])
    n = x.shape[0] if x.shape is not None else None
    num_true = (label.shape[1] if label.shape is not None and
                len(label.shape) == 2 else 1)
    num_sampled = num_true + int(op.attr("num_neg_samples", 10))
    tc.set_output(op, "Cost", shape=None if n is None else (n, 1),
                  dtype=x.dtype)
    for slot, dt in (("SampleLogits", x.dtype),
                     ("SampleLabels", "int64")):
        if op.output(slot):
            tc.set(op.output(slot)[0],
                   shape=None if n is None else (n, num_sampled),
                   dtype=dt)


@rule("fill_constant", "fill")
def _r_fill_constant(op, tc):
    dtype = op.attr("dtype", "float32")
    shape = op.attr("shape")
    value = op.attr("value", 0.0)
    if dtype in ("int64",) and value is not None:
        try:
            fits = int64_fits_i32_lane(value)
        except (TypeError, ValueError):
            fits = True
        if not fits:
            name = op.output("Out")[0] if op.output("Out") else None
            tc.report("PTA010",
                      f"{op.type} writes int64 value(s) outside int32 "
                      f"range into `{name}` — under JAX x64-off (and on "
                      f"the pipeline i32 carrier lane) the value "
                      f"silently wraps; keep ids within int32 range or "
                      f"stage them host-side",
                      op=op, var=name)
    tc.set_output(op, "Out", shape=shape, dtype=dtype)


@rule("uniform_random", "gaussian_random")
def _r_random_init(op, tc):
    tc.set_output(op, "Out", shape=op.attr("shape"),
                  dtype=op.attr("dtype", "float32"))


@rule("fill_constant_batch_size_like")
def _r_fill_batch_like(op, tc):
    x = tc.input_info(op, "Input")
    shape = list(op.attr("shape") or ())
    if shape:
        out_idx = op.attr("output_dim_idx", 0)
        in_idx = op.attr("input_dim_idx", 0)
        if x.shape is not None and in_idx < len(x.shape) and \
                out_idx < len(shape):
            shape[out_idx] = x.shape[in_idx]
    tc.set_output(op, "Out", shape=shape or None,
                  dtype=op.attr("dtype", "float32"))


@rule("reshape", "reshape2")
def _r_reshape(op, tc):
    x = tc.input_info(op, "X")
    shape = list(op.attr("shape") or ())
    if shape and x.shape is not None:
        n_in = _prod(x.shape)
        unknown = sum(1 for d in shape if d in (-1, 0))
        if n_in is not None and unknown == 0:
            n_out = _prod(shape)
            if n_out is not None and n_out != n_in:
                tc.report("PTA006",
                          f"reshape of `{op.input('X')[0]}` {x.shape} "
                          f"({n_in} elements) to {tuple(shape)} "
                          f"({n_out} elements) changes the element "
                          f"count", op=op, var=op.input("X")[0])
    tc.set_output(op, "Out", shape=shape or None, dtype=x.dtype)


@rule("transpose", "transpose2")
def _r_transpose(op, tc):
    x = tc.input_info(op, "X")
    perm = op.attr("axis") or op.attr("perm")
    shape = None
    if x.shape is not None and perm and len(perm) == len(x.shape):
        shape = tuple(x.shape[p] for p in perm)
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("concat")
def _r_concat(op, tc):
    infos = [tc.info(n) for n in op.input("X")]
    axis = op.attr("axis", 0)
    shape = None
    dtype = None
    known = [i for i in infos if i.shape is not None]
    for n, inf in zip(op.input("X"), infos):
        if inf.dtype is not None:
            if dtype is not None and inf.dtype != dtype:
                tc.report("PTA005",
                          f"concat inputs disagree on dtype: `{n}` is "
                          f"{inf.dtype}, earlier inputs are {dtype}",
                          op=op, var=n)
            dtype = dtype or inf.dtype
    if known and all(len(i.shape) == len(known[0].shape) for i in known):
        rank = len(known[0].shape)
        ax = axis % rank if rank else 0
        for d in range(rank):
            if d == ax:
                continue
            dims = {i.shape[d] for i in known if i.shape[d] != -1}
            if len(dims) > 1:
                tc.report("PTA006",
                          f"concat inputs disagree on non-concat dim "
                          f"{d}: {sorted(dims)}", op=op,
                          var=op.input("X")[0])
                break
        if len(known) == len(infos):
            cat = 0
            for i in known:
                if i.shape[ax] == -1:
                    cat = -1
                    break
                cat += i.shape[ax]
            shape = tuple(cat if d == ax else known[0].shape[d]
                          for d in range(rank))
    tc.set_output(op, "Out", shape=shape, dtype=dtype)


@rule("conv2d")
def _r_conv2d(op, tc):
    x = tc.input_info(op, "Input")
    w = tc.input_info(op, "Filter")
    shape = None
    if x.shape is not None and w.shape is not None and \
            len(x.shape) == 4 and len(w.shape) == 4:
        if _dims_conflict(x.shape[1],
                          w.shape[1] * op.attr("groups", 1)):
            tc.report("PTA006",
                      f"conv2d channel mismatch: Input "
                      f"`{op.input('Input')[0]}` has {x.shape[1]} "
                      f"channels but Filter `{op.input('Filter')[0]}` "
                      f"expects {w.shape[1] * op.attr('groups', 1)}",
                      op=op, var=op.input("Input")[0])
        stride = _pair(op.attr("strides", [1, 1]))
        pad = _pair(op.attr("paddings", [0, 0]))
        dil = _pair(op.attr("dilations", [1, 1]))
        hw = []
        for i in (0, 1):
            d_in = x.shape[2 + i]
            if d_in == -1 or w.shape[2 + i] == -1:
                hw.append(-1)
            else:
                k = dil[i] * (w.shape[2 + i] - 1) + 1
                hw.append((d_in + 2 * pad[i] - k) // stride[i] + 1)
        shape = (x.shape[0], w.shape[0], hw[0], hw[1])
    tc.set_output(op, "Output", shape=shape, dtype=x.dtype)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@rule("pool2d")
def _r_pool2d(op, tc):
    x = tc.input_info(op, "X")
    shape = None
    if x.shape is not None and len(x.shape) == 4:
        if op.attr("global_pooling", False):
            shape = (x.shape[0], x.shape[1], 1, 1)
        else:
            k = _pair(op.attr("ksize", [1, 1]))
            stride = _pair(op.attr("strides", [1, 1]))
            pad = _pair(op.attr("paddings", [0, 0]))
            ceil = op.attr("ceil_mode", False)
            hw = []
            for i in (0, 1):
                d_in = x.shape[2 + i]
                if d_in == -1:
                    hw.append(-1)
                    continue
                num = d_in + 2 * pad[i] - k[i]
                hw.append((num + stride[i] - 1) // stride[i] + 1 if ceil
                          else num // stride[i] + 1)
            shape = (x.shape[0], x.shape[1], hw[0], hw[1])
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("batch_norm")
def _r_batch_norm(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Y", shape=x.shape, dtype=x.dtype)


@rule("layer_norm")
def _r_layer_norm(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Y", shape=x.shape, dtype=x.dtype)


# ---------------------------------------------------------------------------
# gradient-op rules: the single largest warn-list family.  Every
# ``<type>_grad`` op built by ``registry.default_grad_maker`` follows
# one slot convention — inputs carry the forward slots (same names) and
# outputs carry ``<slot>@GRAD`` per differentiable forward input — and
# the cotangent of a tensor always has THAT TENSOR's shape and dtype.
# So one mirror rule covers the family soundly: each ``<slot>@GRAD``
# output copies the shape/dtype of the forward input it differentiates,
# index-aligned within the slot (nothing is ever *reported* here —
# propagation only, so downstream rules like the optimizer Param/Grad
# agreement can see through backward chains).
# ---------------------------------------------------------------------------

_GRAD_MIRROR_OPS = tuple(
    t + "_grad" for t in _UNARY_OPS + (
        "mul", "matmul", "elementwise_add", "elementwise_sub",
        "elementwise_mul", "elementwise_div", "elementwise_max",
        "elementwise_min", "elementwise_pow", "sum", "mean", "concat",
        "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
        "reduce_prod", "cross_entropy", "softmax_with_cross_entropy",
        "lookup_table", "nce", "reshape", "reshape2", "transpose",
        "transpose2", "conv2d", "pool2d", "batch_norm", "layer_norm",
        "sequence_pool", "lstm", "write_to_array", "read_from_array",
        "array_to_lod_tensor", "lod_tensor_to_array",
        "reorder_lod_tensor_by_rank",
    ))


@rule(*_GRAD_MIRROR_OPS)
def _r_grad_mirror(op, tc):
    for slot, names in op.outputs.items():
        if not slot.endswith(framework.GRAD_SUFFIX):
            # auxiliary outputs (saved state, scratch): unknown
            tc.set_output(op, slot)
            continue
        fwd = op.input(slot[:-len(framework.GRAD_SUFFIX)])
        for i, n in enumerate(names):
            src = tc.info(fwd[i]) if i < len(fwd) else _UNKNOWN
            tc.set(n, shape=src.shape, dtype=src.dtype)


@rule("increment")
def _r_increment(op, tc):
    tc.copy_unary(op)


@rule("assign_value")
def _r_assign_value(op, tc):
    tc.set_output(op, "Out", shape=op.attr("shape"),
                  dtype=op.attr("dtype", "float32"))


@rule("max_sequence_len")
def _r_max_sequence_len(op, tc):
    tc.set_output(op, "Out", shape=(1,), dtype="int64")


@rule("sequence_expand")
def _r_sequence_expand(op, tc):
    # row count follows the LoD expansion (unknown statically);
    # feature dims and dtype carry through
    x = tc.input_info(op, "X")
    shape = (-1,) + tuple(x.shape[1:]) if x.shape is not None else None
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("less_than", "less_equal", "greater_than", "greater_equal",
      "equal", "not_equal")
def _r_compare(op, tc):
    x = tc.input_info(op, "X")
    tc.set_output(op, "Out", shape=x.shape, dtype="bool")


@rule("sequence_pool")
def _r_sequence_pool(op, tc):
    # rows collapse per sequence: the batch dim is LoD-dependent
    # (unknown statically), the feature dims and dtype carry through
    x = tc.input_info(op, "X")
    shape = (-1,) + tuple(x.shape[1:]) if x.shape is not None else None
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)
    tc.set_output(op, "MaxIndex", shape=shape, dtype="int32")


# ---------------------------------------------------------------------------
# LoD/array plumbing + recurrent ops: coverage the cost model rides
# (shape inference is the prerequisite for bytes costing).  Row counts
# are LoD-dependent (unknown statically, -1); trailing feature dims and
# dtypes carry through exactly — propagation only, nothing reported.
# ---------------------------------------------------------------------------

@rule("write_to_array", "read_from_array", "array_to_lod_tensor",
      "lod_tensor_to_array", "reorder_lod_tensor_by_rank")
def _r_lod_array_plumbing(op, tc):
    x = tc.input_info(op, "X")
    shape = (-1,) + tuple(x.shape[1:]) if x.shape is not None else None
    tc.set_output(op, "Out", shape=shape, dtype=x.dtype)


@rule("lod_rank_table")
def _r_lod_rank_table(op, tc):
    # produces a rank-table object, not a tensor: nothing to propagate,
    # but the op is KNOWN (off the warn-list) — consumers' rules treat
    # the table input as unknown by construction
    tc.set_output(op, "Out")


@rule("lstm")
def _r_lstm(op, tc):
    x = tc.input_info(op, "Input")
    w = tc.input_info(op, "Weight")
    hidden = None
    if w.shape is not None and len(w.shape) == 2 and w.shape[0] != -1:
        hidden = w.shape[0]
    rows = x.shape[0] if x.shape is not None else -1
    shape = (rows, hidden) if hidden is not None else None
    tc.set_output(op, "Hidden", shape=shape, dtype=x.dtype)
    tc.set_output(op, "Cell", shape=shape, dtype=x.dtype)
    tc.set_output(op, "BatchGate")
    tc.set_output(op, "BatchCellPreAct")


@rule("sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
      "decayed_adagrad", "rmsprop", "ftrl", "lars_momentum")
def _r_optimizer(op, tc):
    p = tc.input_info(op, "Param")
    g = tc.input_info(op, "Grad")
    if p.shape is not None and g.shape is not None and \
            (len(p.shape) != len(g.shape) or
             any(_dims_conflict(a, b) for a, b in zip(p.shape, g.shape))):
        tc.report("PTA006",
                  f"{op.type}: Param `{op.input('Param')[0]}` {p.shape} "
                  f"and Grad `{op.input('Grad')[0]}` {g.shape} differ "
                  f"in shape", op=op, var=op.input("Param")[0])
    if p.dtype is not None and g.dtype is not None and p.dtype != g.dtype:
        tc.report("PTA005",
                  f"{op.type}: Param dtype {p.dtype} differs from Grad "
                  f"dtype {g.dtype}", op=op, var=op.input("Param")[0])
    tc.set_output(op, "ParamOut", shape=p.shape, dtype=p.dtype)


@rule("paged_attention")
def _r_paged_attention(op, tc):
    q = tc.input_info(op, "Q")
    kc = tc.input_info(op, "KCache")
    vc = tc.input_info(op, "VCache")
    for slot in ("PageTable", "Lens"):
        inf = tc.input_info(op, slot)
        if inf.dtype is not None and inf.dtype not in ("int32", "int64"):
            tc.report("PTA005",
                      f"paged_attention {slot} "
                      f"`{op.input(slot)[0]}` must be an integer index "
                      f"tensor, got {inf.dtype}",
                      op=op, var=op.input(slot)[0])
    if kc.shape is not None and vc.shape is not None and \
            (len(kc.shape) != len(vc.shape) or
             any(_dims_conflict(a, b)
                 for a, b in zip(kc.shape, vc.shape))):
        tc.report("PTA006",
                  f"paged_attention K/V pools disagree on geometry: "
                  f"KCache `{op.input('KCache')[0]}` {kc.shape} vs "
                  f"VCache `{op.input('VCache')[0]}` {vc.shape}",
                  op=op, var=op.input("KCache")[0])
    if q.shape is not None and kc.shape is not None and \
            q.shape[-1] > 0 and kc.shape[-1] > 0 and \
            q.shape[-1] != kc.shape[-1]:
        tc.report("PTA006",
                  f"paged_attention Q `{op.input('Q')[0]}` feature dim "
                  f"{q.shape[-1]} differs from the page pool's "
                  f"{kc.shape[-1]} — the scatter would write misshapen "
                  f"rows", op=op, var=op.input("Q")[0])
    n_head = op.attr("n_head", None)
    if n_head and q.shape is not None and q.shape[-1] > 0 and \
            q.shape[-1] % int(n_head):
        tc.report("PTA006",
                  f"paged_attention feature dim {q.shape[-1]} is not "
                  f"divisible by n_head={n_head}",
                  op=op, var=op.input("Q")[0])
    tc.set_output(op, "Out", shape=q.shape, dtype=q.dtype)
    tc.set_output(op, "KCacheOut", shape=kc.shape, dtype=kc.dtype)
    tc.set_output(op, "VCacheOut", shape=vc.shape, dtype=vc.dtype)
