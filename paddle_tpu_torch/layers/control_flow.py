"""Control-flow layers (the port of ``paddle_tpu.layers.control_flow``;
reference ``python/paddle/fluid/layers/control_flow.py``).

``While`` (:608), ``StaticRNN`` (:383), ``DynamicRNN`` (:1354),
``IfElse`` (:1252), ``Switch`` (:1163), plus the array/rank-table helpers.
Sub-blocks are real IR blocks, built as in the JAX package (so the two
packages' programs serialize to the same dict); the executor runs them
as Python loops and branches (``paddle_tpu_torch/ops/control_flow_ops.py``).
"""

from __future__ import annotations

import contextlib

from paddle_tpu_torch.framework import Variable, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import tensor as tensor_layers

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
    "ConditionalBlock", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "array_read",
    "array_write", "array_length", "create_array", "increment",
    "less_than", "equal", "not_equal", "greater_than", "greater_equal",
    "less_equal", "shrink_memory", "reorder_lod_tensor_by_rank",
    "is_empty", "Print",
]


# ---------------------------------------------------------------------------
# comparisons / counters (thin wrappers over registered ops)
# ---------------------------------------------------------------------------

def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


def Print(input, first_n=-1, message=None, summarize=-1, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True,
          print_tensor_lod=True, print_phase="both"):
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n, "message": message or "",
                            "summarize": summarize,
                            "print_phase": print_phase})
    return out


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------

def create_array(dtype):
    helper = LayerHelper("create_array")
    return helper.main_program.current_block().create_var(
        name=unique_name("array"), dtype=dtype, type="tensor_array")


def array_write(x, i, array=None, capacity=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    attrs = {}
    if capacity is not None:
        attrs["capacity"] = int(capacity)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]}, attrs=attrs)
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(dtype=array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(dtype="int32")
    out.stop_gradient = True
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# rank table / lod<->array
# ---------------------------------------------------------------------------

def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table")
    table = helper.main_program.current_block().create_var(
        name=unique_name("lod_rank_table"), dtype=x.dtype,
        type="lod_rank_table")
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_tmp_variable(dtype="int32")
    out.stop_gradient = True
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.main_program.current_block().create_var(
        name=unique_name("lod_tensor_to_array"), dtype=x.dtype,
        type="tensor_array")
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """``while cond: body`` over a sub-block (reference control_flow.py:608).

    Usage::
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ...build body...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)   # recompute condition
    """

    def __init__(self, cond, name=None):
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool variable")
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program.create_block()
        yield
        program.rollback()
        written = _written_vars(sub)
        # external data deps must be declared so IR autodiff can route
        # gradients into the loop (the reference computes the same set in
        # while_op.cc by scanning the sub-block)
        ext = _external_reads(sub, parent)
        ext = [n for n in ext if n != self.cond_var.name]
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var], "X": ext},
            outputs={"Out": written, "StepScopes": []},
            attrs={"sub_block": sub})


def _written_vars(block):
    from paddle_tpu_torch.ops.control_flow_ops import _collect_written
    return _collect_written(block)


def _external_reads(block, parent):
    """Names read by ``block`` (recursively) that it does not produce
    itself and that resolve in an ancestor block."""
    produced = set()
    ext = []
    def walk(b):
        for op in b.ops:
            for n in op.input_arg_names:
                if n and n not in produced and not b.has_var_local(n):
                    if parent.has_var(n) and n not in ext:
                        ext.append(n)
            for n in op.output_arg_names:
                produced.add(n)
            for a in op.attrs.values():
                if hasattr(a, "ops"):
                    walk(a)
    walk(block)
    # rank tables are static metadata, not runtime arrays
    out = []
    for n in ext:
        try:
            v = parent.var(n)
        except KeyError:
            continue
        if getattr(v, "type", "") != "lod_rank_table":
            out.append(n)
    return out


# ---------------------------------------------------------------------------
# StaticRNN
# ---------------------------------------------------------------------------

class StaticRNN:
    """Unrolled-over-time RNN builder: one ``recurrent`` op, run as a
    Python loop over time (reference control_flow.py:383; C++
    recurrent_op.cc:222).

    Step inputs are [B, T, D] (batch-major); ``step_input`` exposes the
    per-step [B, D] slice inside the block.
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.sub_block = None
        self.seq_len = None
        self.step_inputs = {}    # outer name -> step var name
        self.memories = []       # {pre, mem, init}
        self.step_outputs = {}   # step var name -> outer name
        self._outer_outputs = []

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self.status = StaticRNN.IN_RNN_BLOCK
        self.sub_block = program.create_block()
        yield
        program.rollback()
        self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete_op()

    def _assert_in_rnn_block(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError(f"StaticRNN.{method} must be called "
                             f"inside rnn.step()")

    def step_input(self, x):
        self._assert_in_rnn_block("step_input")
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("StaticRNN step input needs [B, T, ...] shape")
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        ipt = self.sub_block.create_var(
            name=unique_name(x.name + "@step"), shape=(x.shape[0],) + tuple(
                x.shape[2:]), dtype=x.dtype)
        self.step_inputs[x.name] = ipt.name
        return ipt

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_rnn_block("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            parent = self.sub_block.parent_block
            cur = self.helper.main_program._current_block_idx
            self.helper.main_program._current_block_idx = parent.idx
            try:
                init = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref, shape=[batch_ref.shape[0]] + list(shape),
                    dtype="float32", value=init_value)
            finally:
                self.helper.main_program._current_block_idx = cur
        pre = self.sub_block.create_var(
            name=unique_name(init.name + "@pre"), shape=init.shape,
            dtype=init.dtype)
        self.memories.append({"pre": pre.name, "mem": None,
                              "init": init.name})
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn_block("update_memory")
        for m in self.memories:
            if m["pre"] == mem.name:
                m["mem"] = var.name
                return
        raise ValueError("update_memory on an unknown memory")

    def step_output(self, o):
        self._assert_in_rnn_block("step_output")
        outer = self.sub_block.parent_block.create_var(
            name=unique_name(o.name + "@stacked"), dtype=o.dtype,
            shape=None if o.shape is None else
            (o.shape[0], self.seq_len) + tuple(o.shape[1:]))
        self.step_outputs[o.name] = outer.name
        self._outer_outputs.append(outer)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete_op(self):
        for m in self.memories:
            if m["mem"] is None:
                raise ValueError("every StaticRNN memory needs "
                                 "update_memory")
        parent = self.sub_block.parent_block
        ext = _external_reads(self.sub_block, parent)
        inner = set(self.step_inputs.values()) | {
            m["pre"] for m in self.memories}
        ext = [n for n in ext
               if n not in inner and n not in self.step_inputs
               and n not in {m["init"] for m in self.memories}]
        parent.append_op(
            type="recurrent",
            inputs={"X": list(self.step_inputs),
                    "InitStates": [m["init"] for m in self.memories],
                    "Params": ext},
            outputs={"Out": list(self.step_outputs.values())},
            attrs={"sub_block": self.sub_block,
                   "step_inputs": dict(self.step_inputs),
                   "memories": [dict(m) for m in self.memories],
                   "step_outputs": dict(self.step_outputs)})

    def __call__(self):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("StaticRNN outputs read after step block")
        if len(self._outer_outputs) == 1:
            return self._outer_outputs[0]
        return self._outer_outputs


# ---------------------------------------------------------------------------
# DynamicRNN — ragged batch over the same scan machinery
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _block_guard(program, block_idx):
    """Temporarily switch the program's current block (used to emit prep
    ops into the parent block while building a loop body)."""
    prev = program._current_block_idx
    program._current_block_idx = block_idx
    try:
        yield
    finally:
        program._current_block_idx = prev


class DynamicRNN:
    """Variable-length RNN (reference control_flow.py:1354).

    As in the JAX package: the ragged LoD input becomes a time-major
    TensorArray of full-batch steps once (lod_tensor_to_array); the body
    is one ``while`` over the steps; the outputs restore to ragged form
    (array_to_lod_tensor).  Usage mirrors the reference::

        drnn = DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sentence)
            prev = drnn.memory(shape=[H])
            hidden = fc(input=[word, prev], size=H, act='relu')
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.lod_rank_table = None
        self.max_seq_len = None
        self.step_idx = None
        self.input_array = []
        self.mem_link = []
        self.output_array = []
        self.cond = self.helper.create_tmp_variable(dtype="bool")
        self.cond.stop_gradient = True
        self.while_op = While(self.cond)

    def _parent_block(self):
        program = self.helper.main_program
        return program.block(program.current_block().parent_idx)

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be invoked once")
        self.step_idx = tensor_layers.fill_constant(
            shape=[1], dtype="int32", value=0)
        self.step_idx.stop_gradient = False
        self.status = DynamicRNN.IN_RNN
        with self.while_op.block():
            yield
            increment(x=self.step_idx, value=1.0, in_place=True)
            for new_mem, mem_array in self.mem_link:
                array_write(x=new_mem, i=self.step_idx, array=mem_array)
            less_than(x=self.step_idx, y=self.max_seq_len, cond=self.cond)
        self.status = DynamicRNN.AFTER_RNN

    def step_input(self, x):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("step_input() must be inside rnn.block()")
        program = self.helper.main_program
        parent = self._parent_block()
        with _block_guard(program, parent.idx):
            if self.lod_rank_table is None:
                self.lod_rank_table = lod_rank_table(x)
                self.max_seq_len = max_sequence_len(self.lod_rank_table)
                less_than(x=self.step_idx, y=self.max_seq_len,
                          cond=self.cond)
            array = lod_tensor_to_array(x, self.lod_rank_table)
        self.input_array.append(array)
        return array_read(array=array, i=self.step_idx)

    def static_input(self, x):
        if self.lod_rank_table is None:
            raise ValueError("static_input() must follow step_input()")
        program = self.helper.main_program
        with _block_guard(program, self._parent_block().idx):
            return reorder_lod_tensor_by_rank(x, self.lod_rank_table)

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("memory() must be inside rnn.block()")
        if self.lod_rank_table is None:
            raise ValueError("memory() must follow step_input()")
        program = self.helper.main_program
        parent = self._parent_block()
        with _block_guard(program, parent.idx):
            if init is not None:
                mem = reorder_lod_tensor_by_rank(init, self.lod_rank_table)
            else:
                first = array_read(array=self.input_array[0],
                                   i=tensor_layers.fill_constant(
                                       shape=[1], dtype="int32", value=0))
                mem = tensor_layers.fill_constant_batch_size_like(
                    input=first, shape=[-1] + list(shape), dtype=dtype,
                    value=value)
            arr = array_write(x=mem, i=tensor_layers.fill_constant(
                shape=[1], dtype="int32", value=0), array=None)
        return array_read(array=arr, i=self.step_idx)

    def update_memory(self, ex_mem, new_mem):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("update_memory() must be inside rnn.block()")
        read_op = ex_mem.op
        arr_name = read_op.input("X")[0]
        arr = ex_mem.block.var(arr_name)
        self.mem_link.append((new_mem, arr))

    def output(self, *outputs):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("output() must be inside rnn.block()")
        for each in outputs:
            outside_array = array_write(x=each, i=self.step_idx, array=None)
            self.output_array.append(outside_array)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("rnn() read before block() completes")
        result = [array_to_lod_tensor(a, self.lod_rank_table)
                  for a in self.output_array]
        return result[0] if len(result) == 1 else result


# ---------------------------------------------------------------------------
# ConditionalBlock / IfElse / Switch
# ---------------------------------------------------------------------------

class ConditionalBlock:
    def __init__(self, inputs, is_scalar_condition=False, name=None):
        for each in inputs:
            assert isinstance(each, Variable)
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program.create_block()
        yield
        program.rollback()
        written = _written_vars(sub)
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": [v.name for v in self.inputs]},
            outputs={"Out": written, "Scope": []},
            attrs={"sub_block": sub,
                   "is_scalar_condition": self.is_scalar_condition})


class IfElse:
    """Batch-row routed if/else (reference control_flow.py:1252).

    As in the JAX package, both branches compute over the FULL batch; ``true_block``
    rows and ``false_block`` rows are merged per row by the boolean
    condition (merge_lod_tensor = where(mask)).
    """

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = [[], []]  # [false_outs, true_outs]

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be inside a branch block")
        # both branches see the full batch
        return x

    @contextlib.contextmanager
    def _block(self, status):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("nested IfElse branch")
        self.status = status
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def true_block(self):
        return self._block(IfElse.IN_IF_ELSE_TRUE_BLOCKS)

    def false_block(self):
        return self._block(IfElse.IN_IF_ELSE_FALSE_BLOCKS)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be inside a branch block")
        is_true = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        self.output_table[1 if is_true else 0].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ outside blocks")
        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            raise ValueError("true/false blocks must emit matching outputs")
        helper = LayerHelper("merge_lod_tensor")
        rets = []
        for t, f in zip(true_outs, false_outs):
            out = helper.create_tmp_variable(dtype=t.dtype)
            helper.append_op(
                type="merge_lod_tensor",
                inputs={"Mask": [self.cond], "InTrue": [t],
                        "InFalse": [f], "X": [t]},
                outputs={"Out": [out]}, attrs={"level": 0})
            rets.append(out)
        return rets[0] if len(rets) == 1 else rets


class Switch:
    """Scalar multi-way branch (reference control_flow.py:1163): a chain of
    scalar conditional_blocks; exactly the first true case runs."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case() outside with switch.block()")
        if len(self.pre_not_conditions) == 0:
            cond_block = ConditionalBlock([condition],
                                          is_scalar_condition=True)
            not_cond = _logical_not(condition)
            self.pre_not_conditions.append(not_cond)
        else:
            pre = self.pre_not_conditions[-1]
            new_cond = _logical_and(pre, condition)
            not_cond = _logical_and(pre, _logical_not(condition))
            self.pre_not_conditions.append(not_cond)
            cond_block = ConditionalBlock([new_cond],
                                          is_scalar_condition=True)
        with cond_block.block():
            yield

    @contextlib.contextmanager
    def default(self):
        if len(self.pre_not_conditions) == 0:
            raise ValueError("default() requires at least one case")
        cond_block = ConditionalBlock([self.pre_not_conditions[-1]],
                                      is_scalar_condition=True)
        with cond_block.block():
            yield

    @contextlib.contextmanager
    def block(self):
        self.inside_scope = True
        yield
        self.inside_scope = False


def _logical_not(x):
    helper = LayerHelper("logical_not")
    out = helper.create_tmp_variable(dtype="bool")
    out.stop_gradient = True
    helper.append_op(type="logical_not", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def _logical_and(x, y):
    helper = LayerHelper("logical_and")
    out = helper.create_tmp_variable(dtype="bool")
    out.stop_gradient = True
    helper.append_op(type="logical_and", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out
