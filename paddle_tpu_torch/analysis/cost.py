"""Static FLOPs/bytes cost model over the Program IR (the port's copy of
``paddle_tpu.analysis.cost``: the same rules, so both packages price a
program alike).

Per-op ``@cost.rule`` functions ride the typecheck pass's shape
inference (``analysis/typecheck.py``): :func:`estimate` propagates
shapes/dtypes from the program's trusted roots exactly like
``check_types`` and hands each cost rule the resolved
:class:`~paddle_tpu_torch.analysis.typecheck.VarInfo` of the op's operands.
A rule returns ``(flops, bytes)``; an op type without a rule (or with
unknown shapes) contributes zero and lands on the report's
``uncovered`` list rather than guessing — the same silence-over-noise
contract the type checker holds.

The JAX package cross-checks these rules against its compiler's own
cost analysis; the port holds them equal to the JAX package's
(``tests/test_torch_cost.py``).

Consumers:

* ``lod.select_bucket_edges`` — :func:`row_cost_fn` fits cost as a
  function of batch rows so bucket edges minimize expected padded
  FLOPs instead of defaulting to powers of two;
* ``gen.GenScheduler`` — :meth:`GenPredictor.prefill_cost` prices a
  prompt's prefill from the bundle's prefill program, and the
  scheduler's per-iteration admission budget weighs admissions by it;
* the optimization pipeline's report and its amortization gate
  (``analysis/opt``).

Registering a rule for a new op::

    from paddle_tpu_torch.analysis import cost

    @cost.rule("my_op")
    def _my_op(op, info):
        x = info(op.input("X")[0])
        n = cost.numel(x.shape)
        if n is None:
            return None          # unknown shapes -> uncovered
        return 3 * n, cost.io_bytes(op, info)
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.analysis import typecheck
from paddle_tpu_torch.analysis.typecheck import TypeEnv, VarInfo, _UNKNOWN

__all__ = ["rule", "covered_op_types", "estimate", "op_flops",
           "numel", "io_bytes", "CostReport", "validate_cost_report",
           "row_cost_fn", "REPORT_KEYS"]

_RULES = {}

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "float32": 4, "int32": 4, "float16": 2,
    "bfloat16": 2, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
}


def rule(*op_types):
    """Decorator registering ``fn(op, info) -> (flops, bytes) | None``
    as the cost rule for one or more op types.  ``info(name)`` resolves
    a variable to its inferred :class:`VarInfo`.  Returning None (or
    raising) degrades the op to the uncovered list."""

    def deco(fn):
        for t in op_types:
            _RULES[t] = fn
        return fn

    return deco


def covered_op_types():
    return set(_RULES)


def numel(shape, default_dim=1):
    """Element count of a static shape; unknown (-1) dims count as
    ``default_dim`` so batch-relative costs stay comparable; ``None``
    shape -> None."""
    if shape is None:
        return None
    n = 1
    for d in shape:
        n *= default_dim if d is None or d < 0 else int(d)
    return n


def _var_bytes(inf, default_dim=1):
    n = numel(inf.shape, default_dim)
    if n is None:
        return None
    return n * _DTYPE_BYTES.get(str(inf.dtype), 4)


def io_bytes(op, info, default_dim=1):
    """Bytes moved through the op's known-shape inputs and outputs —
    the default bytes estimate every rule can fall back on.  Unknown
    operands contribute zero (undercount, never a guess)."""
    total = 0
    for names in list(op.inputs.values()) + list(op.outputs.values()):
        for n in names:
            b = _var_bytes(info(n), default_dim)
            if b:
                total += b
    return total


# ---------------------------------------------------------------------------
# estimation walk (rides the typecheck rules for shape propagation)
# ---------------------------------------------------------------------------

class CostReport:
    """Per-program cost estimate: total flops/bytes, a per-op table,
    and the uncovered op-type list (coverage gap, not a claim)."""

    def __init__(self, total_flops, total_bytes, per_op, uncovered):
        self.total_flops = int(total_flops)
        self.total_bytes = int(total_bytes)
        self.per_op = list(per_op)
        self.uncovered = sorted(uncovered)

    def by_op_type(self):
        out = {}
        for row in self.per_op:
            agg = out.setdefault(row["op_type"],
                                 {"flops": 0, "bytes": 0, "count": 0})
            agg["flops"] += row["flops"]
            agg["bytes"] += row["bytes"]
            agg["count"] += 1
        return out

    def to_dict(self):
        return {"format": 1, "total_flops": self.total_flops,
                "total_bytes": self.total_bytes,
                "per_op": self.per_op, "uncovered": self.uncovered}

    def __repr__(self):
        return (f"CostReport(flops={self.total_flops:,}, "
                f"bytes={self.total_bytes:,}, "
                f"uncovered={len(self.uncovered)})")


REPORT_KEYS = ("format", "total_flops", "total_bytes", "per_op",
               "uncovered")


def validate_cost_report(obj):
    """Schema problems of a ``CostReport.to_dict()`` body (the
    selfcheck ``opt`` section's gate) as a list of strings."""
    problems = []
    if not isinstance(obj, dict):
        return [f"cost report must be an object, got "
                f"{type(obj).__name__}"]
    for k in REPORT_KEYS:
        if k not in obj:
            problems.append(f"missing key {k!r}")
    if problems:
        return problems
    if obj["format"] != 1:
        problems.append(f"format must be 1, got {obj['format']!r}")
    for k in ("total_flops", "total_bytes"):
        v = obj[k]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            problems.append(f"{k} must be a non-negative integer")
    if not isinstance(obj["uncovered"], list):
        problems.append("uncovered must be a list")
    if not isinstance(obj["per_op"], list):
        return problems + ["per_op must be a list"]
    for i, row in enumerate(obj["per_op"]):
        where = f"per_op[{i}]"
        if not isinstance(row, dict):
            problems.append(f"{where}: must be an object")
            continue
        for k in ("op_index", "op_type", "flops", "bytes"):
            if k not in row:
                problems.append(f"{where}: missing key {k!r}")
                continue
            if k != "op_type" and (not isinstance(row[k], int)
                                   or isinstance(row[k], bool)
                                   or row[k] < 0):
                problems.append(f"{where}: {k} must be a non-negative "
                                f"integer")
    return problems


def estimate(program):
    """Walk the global block with typecheck shape propagation and price
    each op through its cost rule (unknown dims count as 1 — totals
    undercount rather than guess).  Returns a :class:`CostReport`."""
    from paddle_tpu_torch import profiler as _profiler
    block = program.global_block()
    diags = []
    tc_uncovered = set()
    tc = TypeEnv(block, diags, tc_uncovered)
    total_flops = 0
    total_bytes = 0
    per_op = []
    uncovered = set()
    for i, op in enumerate(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        tc.op_index = i

        def info(name, _tc=tc):
            inf = _tc.info(name)
            if inf.shape is None and name:
                # fall back to the build-time declared shape (the
                # pipeline transpiler's source of truth) when dataflow
                # could not prove one
                try:
                    v = block.var(name)
                except KeyError:
                    return inf
                if v.shape is not None:
                    return VarInfo(v.shape, v.dtype)
            return inf

        flops_bytes = None
        fn = _RULES.get(op.type)
        if fn is not None:
            try:
                flops_bytes = fn(op, info)
            except Exception:
                flops_bytes = None
        if flops_bytes is None:
            uncovered.add(op.type)
            flops, nbytes = 0, 0
        else:
            flops, nbytes = flops_bytes
            flops = max(int(flops), 0)
            nbytes = max(int(nbytes), 0)
        per_op.append({"op_index": i, "op_type": op.type,
                       "flops": flops, "bytes": nbytes})
        total_flops += flops
        total_bytes += nbytes
        # propagate shapes through the typecheck rule so downstream
        # cost rules see resolved operand shapes
        tfn = typecheck._RULES.get(op.type)
        if tfn is None:
            for n in op.output_arg_names:
                tc.set(n)
        else:
            try:
                tfn(op, tc)
            except Exception:
                for n in op.output_arg_names:
                    tc.set(n)
    _profiler.runtime_metrics.inc("cost.estimates")
    return CostReport(total_flops, total_bytes, per_op, uncovered)


def op_flops(op, block, default=None):
    """FLOPs of one op priced from the BLOCK's declared var shapes (the
    build-time ``infer_shape`` metadata) — the pipeline transpiler's
    stage-balancing weight.  Falls back to ``default`` (or 0) when the
    op has no rule or unknown shapes."""

    def info(name):
        if not name:
            return _UNKNOWN
        try:
            v = block.var(name)
        except KeyError:
            return _UNKNOWN
        return VarInfo(v.shape, v.dtype) if v.shape is not None \
            else _UNKNOWN

    fn = _RULES.get(op.type)
    if fn is None:
        return default
    try:
        out = fn(op, info)
    except Exception:
        return default
    if out is None:
        return default
    return max(int(out[0]), 0)


def row_cost_fn(program, batch_var=None, dim=0, probe_rows=(8, 16)):
    """Fit ``flops(size)`` as an affine function of dim ``dim`` of
    ``batch_var`` (default: the program's first ``is_data`` var):
    estimate the program at two sizes and interpolate.  The returned
    callable prices a padded bucket for
    ``lod.select_bucket_edges`` — batch-size buckets probe the row
    dim, the gen prefill's prompt buckets probe the length dim."""
    block = program.global_block()
    if batch_var is None:
        for v in block.vars.values():
            if getattr(v, "is_data", False):
                batch_var = v.name
                break
    if batch_var is None:
        return lambda rows: float(rows)
    var = block.var(batch_var)
    saved = var.shape
    points = []
    try:
        for rows in probe_rows:
            shape = list(saved or (-1,))
            shape[dim] = int(rows)
            var.shape = tuple(shape)
            points.append((rows, estimate(program).total_flops))
    finally:
        var.shape = saved
    (r0, f0), (r1, f1) = points
    if r1 == r0 or f1 <= f0:
        return lambda rows: float(max(f0, 1)) * rows / max(r0, 1)
    slope = (f1 - f0) / (r1 - r0)
    const = f0 - slope * r0

    def fn(rows):
        return max(const + slope * rows, 0.0)

    return fn


# ---------------------------------------------------------------------------
# rules — the compute-dominant families first (matmul/conv), then the
# per-element families, mirroring the typecheck rule layout
# ---------------------------------------------------------------------------

def _shape(info, op, slot):
    names = op.input(slot)
    return info(names[0]).shape if names else None


@rule("mul")
def _c_mul(op, info):
    x = info(op.input("X")[0]) if op.input("X") else _UNKNOWN
    y = info(op.input("Y")[0]) if op.input("Y") else _UNKNOWN
    if x.shape is None or y.shape is None:
        return None
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    m = numel(x.shape[:xn])
    k = numel(x.shape[xn:])
    n = numel(y.shape[yn:])
    if None in (m, k, n):
        return None
    return 2 * m * k * n, io_bytes(op, info)


@rule("matmul")
def _c_matmul(op, info):
    x = info(op.input("X")[0]) if op.input("X") else _UNKNOWN
    y = info(op.input("Y")[0]) if op.input("Y") else _UNKNOWN
    if x.shape is None or y.shape is None or len(x.shape) < 2 or \
            len(y.shape) < 2:
        return None
    xs, ys = list(x.shape), list(y.shape)
    if op.attr("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attr("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = numel(xs[:-2]) if len(xs) >= len(ys) else numel(ys[:-2])
    m, k, n = xs[-2], xs[-1], ys[-1]
    if any(d is None or d < 0 for d in (m, k, n)) or batch is None:
        return None
    return 2 * batch * m * k * n, io_bytes(op, info)


# grads of a dot: dX = dOut @ Y^T and dY = X^T @ dOut — two dots of the
# forward's geometry, so 2x the forward FLOPs (the standard 2N fwd / 4N
# bwd split behind the bench's 6N accounting)
@rule("mul_grad")
def _c_mul_grad(op, info):
    fwd = _c_mul(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))


@rule("matmul_grad")
def _c_matmul_grad(op, info):
    fwd = _c_matmul(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))


@rule("conv2d", "depthwise_conv2d")
def _c_conv2d(op, info):
    w = info(op.input("Filter")[0]) if op.input("Filter") else _UNKNOWN
    # on the _grad op the forward's Output arrives as an INPUT slot
    outs = op.output("Output") or op.input("Output")
    o = info(outs[0]) if outs else _UNKNOWN
    if w.shape is None or o.shape is None or len(w.shape) != 4 or \
            len(o.shape) != 4:
        return None
    co, ci, kh, kw = w.shape
    n, _, ho, wo = o.shape
    if any(d < 0 for d in (co, ci, kh, kw, ho, wo)):
        return None
    n = 1 if n < 0 else n
    return 2 * n * ho * wo * co * ci * kh * kw, io_bytes(op, info)


@rule("conv2d_grad", "depthwise_conv2d_grad")
def _c_conv2d_grad(op, info):
    fwd = _c_conv2d(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))


@rule("scaled_dot_product_attention")
def _c_sdpa(op, info):
    q = info(op.input("Q")[0]) if op.input("Q") else _UNKNOWN
    if q.shape is None or len(q.shape) != 4:
        return None
    b, h, s, d = q.shape
    if any(x < 0 for x in (h, s, d)):
        return None
    b = 1 if b < 0 else b
    return 4 * b * h * s * s * d, io_bytes(op, info)


@rule("paged_attention")
def _c_paged_attention(op, info):
    """Paged decode attention prices the pages ACTUALLY addressed by
    the step's page-table feed ([S, P] -> S*P*page_len token rows of
    K and V), not the full pool — the whole point of the layout; a
    full-pool ``io_bytes`` would price every bucket identically and
    hide the occupancy win from ``row_cost_fn``/``gen.decode_mfu``."""
    q = info(op.input("Q")[0]) if op.input("Q") else _UNKNOWN
    kc = info(op.input("KCache")[0]) if op.input("KCache") else _UNKNOWN
    pt = info(op.input("PageTable")[0]) if op.input("PageTable") \
        else _UNKNOWN
    if q.shape is None or kc.shape is None or pt.shape is None or \
            len(kc.shape) != 3 or len(pt.shape) != 2:
        return None
    hd, pl, p = kc.shape[-1], kc.shape[1], pt.shape[1]
    if any(x < 0 for x in (hd, pl, p)):
        return None
    s = q.shape[0] if q.shape[0] > 0 else 1
    t = p * pl
    item = _DTYPE_BYTES.get(str(kc.dtype), 4)
    flops = 4 * s * t * hd                       # QK^T + PV per head-row
    bytes_ = (2 * s * t * hd          # K/V pages gathered
              + 4 * s * hd            # q, k, v rows in + out
              + 2 * s * hd) * item    # tail-page scatter write (k + v)
    return flops, bytes_


def _per_element(mult):
    def fn(op, info):
        n = None
        for slot in ("X", "Logits", "Out"):
            names = op.input(slot)
            if names:
                n = numel(info(names[0]).shape)
                break
        if n is None:
            # grad ops / odd slot names: the largest known operand
            # (grads mirror their primal's geometry)
            for name in op.input_arg_names:
                m = numel(info(name).shape)
                if m is not None:
                    n = m if n is None else max(n, m)
        if n is None:
            return None
        return mult * n, io_bytes(op, info)

    return fn


#: cheap elementwise families: ~1 FLOP per element
_ELEMENTWISE_1X = (
    "relu", "abs", "square", "scale", "clip", "floor", "ceil", "round",
    "cast", "assign", "fill_zeros_like", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "dropout", "label_smooth",
    "sum", "mean", "increment", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal", "not_equal",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "sequence_pool", "sequence_expand", "top_k",
    "accuracy", "transpose", "transpose2", "reshape", "reshape2",
    "concat", "lod_reset",
)

#: transcendental elementwise families: ~10 FLOPs per element (exp/log/
#: div chains — the conventional softmax/activation accounting)
_ELEMENTWISE_10X = (
    "sigmoid", "tanh", "exp", "log", "sqrt", "softsign", "softplus",
    "relu6", "leaky_relu", "elu", "gelu", "hard_sigmoid", "swish",
    "brelu", "pow", "reciprocal", "sin", "cos", "softmax",
    "sequence_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "batch_norm",
)

rule(*_ELEMENTWISE_1X)(_per_element(1))
rule(*_ELEMENTWISE_10X)(_per_element(10))

# the per-element families' grads move ~the same element counts
rule(*[t + "_grad" for t in _ELEMENTWISE_1X
       if t not in ("less_than", "less_equal", "greater_than",
                    "greater_equal", "equal", "not_equal", "accuracy",
                    "increment", "assign")])(_per_element(2))
rule(*[t + "_grad" for t in _ELEMENTWISE_10X])(_per_element(10))


@rule("lookup_table")
def _c_lookup_table(op, info):
    ids = info(op.input("Ids")[0]) if op.input("Ids") else _UNKNOWN
    w = info(op.input("W")[0]) if op.input("W") else _UNKNOWN
    n = numel(ids.shape)
    if n is None or w.shape is None or len(w.shape) != 2:
        return None
    width = w.shape[1]
    if width < 0:
        return None
    # a gather: no FLOPs, ids*width elements moved
    return 0, n * width * _DTYPE_BYTES.get(str(w.dtype), 4)


@rule("lookup_table_grad")
def _c_lookup_table_grad(op, info):
    fwd = _c_lookup_table(op, info)
    if fwd is None:
        return None
    # scatter-add back into the table: one add per gathered element
    return fwd[1] // 4, 2 * fwd[1]


@rule("merge_selected_rows")
def _c_merge_selected_rows(op, info):
    x = info(op.input("X")[0]) if op.input("X") else _UNKNOWN
    n = numel(x.shape)
    if n is None:
        return None
    # sort rows + segment-sum the values: one add per element, values
    # read once and written once (the static-shape merge keeps the full
    # row set, so the logical [height, dim] numel is the honest bound)
    item = _DTYPE_BYTES.get(str(x.dtype), 4)
    return n, 2 * n * item


@rule("get_tensor_from_selected_rows")
def _c_get_tensor_from_selected_rows(op, info):
    x = info(op.input("X")[0]) if op.input("X") else _UNKNOWN
    n = numel(x.shape)
    if n is None:
        return None
    # scatter-add into a zeroed [height, dim] tensor
    item = _DTYPE_BYTES.get(str(x.dtype), 4)
    return n, 2 * n * item


@rule("split_ids")
def _c_split_ids(op, info):
    ids = info(op.input("Ids")[0]) if op.input("Ids") else _UNKNOWN
    n = numel(ids.shape)
    if n is None:
        return None
    shards = max(len(op.output("Out")), 1)
    # one mod-compare per (id, shard) pair; padded outputs move n ids
    # per shard
    item = _DTYPE_BYTES.get(str(ids.dtype), 8)
    return n * shards, (1 + shards) * n * item


@rule("split_selected_rows")
def _c_split_selected_rows(op, info):
    x = info(op.input("X")[0]) if op.input("X") else _UNKNOWN
    n = numel(x.shape)
    if n is None:
        return None
    shards = max(len(op.output("Out")), 1)
    item = _DTYPE_BYTES.get(str(x.dtype), 4)
    return n * shards, (1 + shards) * n * item


@rule("nce")
def _c_nce(op, info):
    x = info(op.input("Input")[0]) if op.input("Input") else _UNKNOWN
    label = info(op.input("Label")[0]) if op.input("Label") else _UNKNOWN
    if x.shape is None or len(x.shape) != 2:
        return None
    rows, d = x.shape
    rows = rows if rows >= 0 else 1
    if d < 0:
        return None
    num_true = (label.shape[1] if label.shape is not None and
                len(label.shape) == 2 else 1)
    s = num_true + int(op.attr("num_neg_samples", 10))
    # per (row, sample): a D-dot + ~10-FLOP sigmoid/log chain
    return rows * s * (2 * d + 10), io_bytes(op, info)


@rule("nce_grad")
def _c_nce_grad(op, info):
    fwd = _c_nce(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))


@rule("fill_constant", "fill", "fill_constant_batch_size_like",
      "assign_value", "uniform_random", "gaussian_random",
      "shape", "max_sequence_len", "lod_rank_table")
def _c_fill(op, info):
    outs = op.output("Out")
    o = info(outs[0]) if outs else _UNKNOWN
    n = numel(o.shape)
    if n is None:
        n = numel(op.attr("shape")) or 0
    return 0, n * _DTYPE_BYTES.get(str(o.dtype), 4)


@rule("sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
      "decayed_adagrad", "rmsprop", "ftrl", "lars_momentum")
def _c_optimizer(op, info):
    p = info(op.input("Param")[0]) if op.input("Param") else _UNKNOWN
    n = numel(p.shape)
    if n is None:
        return None
    # Adam-class updates: ~10 FLOPs per parameter (two moment EMAs,
    # bias correction, the update itself); SGD-class overcounts
    # harmlessly (the step is bandwidth-bound either way)
    return 10 * n, io_bytes(op, info)


@rule("pool2d")
def _c_pool2d(op, info):
    outs = op.output("Out") or op.input("Out")
    o = info(outs[0]) if outs else _UNKNOWN
    n = numel(o.shape)
    if n is None:
        return None
    k = op.attr("ksize", [1, 1])
    kk = int(np.prod(k)) if isinstance(k, (list, tuple)) else int(k) ** 2
    return n * max(kk, 1), io_bytes(op, info)


@rule("pool2d_grad")
def _c_pool2d_grad(op, info):
    fwd = _c_pool2d(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))


@rule("lstm")
def _c_lstm(op, info):
    x = info(op.input("Input")[0]) if op.input("Input") else _UNKNOWN
    w = info(op.input("Weight")[0]) if op.input("Weight") else _UNKNOWN
    if x.shape is None or w.shape is None or len(w.shape) != 2:
        return None
    rows = x.shape[0] if x.shape[0] >= 0 else 1
    hidden = w.shape[0]
    if hidden < 0:
        return None
    # per row: input projection rides a separate mul op; here the
    # recurrent 4H x H dot + gate activations
    return rows * (2 * hidden * 4 * hidden + 40 * hidden), \
        io_bytes(op, info)


@rule("lstm_grad")
def _c_lstm_grad(op, info):
    fwd = _c_lstm(op, info)
    return None if fwd is None else (2 * fwd[0], io_bytes(op, info))
