"""Program IR: Program / Block / Operator / Variable.

The port's copy of ``paddle_tpu.framework`` (the reference Fluid IR,
``paddle/fluid/framework/framework.proto:20-176``).  Python layer calls
append ``Operator``s to ``Block``s of a ``Program``; the port's Executor
then runs a block op by op on torch tensors.  ``to_dict``/``from_dict``
give the same serialization as the JAX package, so programs and saved
models cross between the two packages unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading

import numpy as np

__all__ = [
    "Variable",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "unique_name",
    "grad_var_name",
    "convert_np_dtype",
    "Parameter",
]

# ---------------------------------------------------------------------------
# dtype handling
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "int32": "int32", "int64": "int64",
    "bool": "bool",
}


def convert_np_dtype(dtype):
    """Normalize a dtype-ish value to a canonical string name."""
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    # jnp.bfloat16 / np dtypes / python types
    name = np.dtype(dtype).name if not _is_bfloat16(dtype) else "bfloat16"
    return convert_np_dtype(name)


def _is_bfloat16(dtype):
    try:
        return "bfloat16" in str(dtype)
    except Exception:  # pragma: no cover
        return False


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self._ids = collections.defaultdict(int)
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            idx = self._ids[key]
            self._ids[key] += 1
        return f"{key}_{idx}"


_name_generator = _UniqueNameGenerator()


def unique_name(key):
    return _name_generator(key)


@contextlib.contextmanager
def unique_name_scope(prefix):
    """Deterministic name scope: inside the guard, generated names restart
    from zero under ``prefix`` — so re-running the same layer-building code
    in the guard reproduces IDENTICAL parameter names, which is how
    unrolled decode loops (legacy ``beam_search``) share weights across
    timesteps.  Distinct prefixes keep scopes from colliding with the
    outer program's names."""
    global _name_generator
    saved = _name_generator
    fresh = _UniqueNameGenerator()
    _name_generator = lambda key: fresh(f"{prefix}{key}")
    try:
        yield
    finally:
        _name_generator = saved


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """A named tensor in a Block (reference: ``VarDesc`` + python ``Variable``,
    ``python/paddle/fluid/framework.py:117``).

    ``shape`` may contain -1 for dimensions unknown until feed time (batch).
    ``persistable`` variables live across executor runs (parameters, optimizer
    state); everything else is scratch within one lowered computation.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, initializer=None, trainable=True,
                 type="lod_tensor"):
        self.block = block
        if name is None:
            name = unique_name("_generated_var")
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        self.trainable = trainable
        self.type = type  # lod_tensor | selected_rows | tensor_array | reader

    # -- program topology helpers -----------------------------------------
    @property
    def op(self):
        """The op that (last) outputs this variable, or None."""
        for op in reversed(self.block.ops):
            if self.name in op.output_arg_names:
                return op
        return None

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "trainable": self.trainable,
            "type": self.type,
        }
        if isinstance(self, Parameter):
            d["is_parameter"] = True
            d["optimize_attr"] = dict(self.optimize_attr or {})
        return d

    @staticmethod
    def from_dict(block, d):
        if d.get("is_parameter"):
            v = Parameter(block, d["shape"], d["dtype"], name=d["name"],
                          lod_level=d.get("lod_level", 0),
                          trainable=d.get("trainable", True))
            v.optimize_attr = d.get("optimize_attr",
                                    {"learning_rate": 1.0})
            v.stop_gradient = d.get("stop_gradient", False)
            v.is_data = d.get("is_data", False)
            return v
        v = Variable(block, name=d["name"],
                     shape=d["shape"], dtype=d["dtype"],
                     lod_level=d.get("lod_level", 0),
                     persistable=d.get("persistable", False),
                     stop_gradient=d.get("stop_gradient", False),
                     is_data=d.get("is_data", False),
                     trainable=d.get("trainable", True),
                     type=d.get("type", "lod_tensor"))
        return v

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    # numpy-style convenience mirrored from math_op_patch (monkey-patched in
    # paddle_tpu_torch.layers.math_op_patch to avoid a circular import).


class Parameter(Variable):
    """A trainable persistable variable (reference ``framework.py:Parameter``)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.do_model_average = kwargs.pop("do_model_average", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _creation_site():
    """(filename, lineno) of the first stack frame OUTSIDE paddle_tpu_torch —
    the user code that (transitively) appended this op.  The static
    analyzer points its diagnostics here, so
    "shape mismatch in op #12" becomes "…at model.py:42".  A plain
    frame walk (no traceback object) keeps this ~1us per op, paid once
    at program build time."""
    f = sys._getframe(2)
    while f is not None:
        if not f.f_code.co_filename.startswith(_PKG_DIR):
            return (f.f_code.co_filename, f.f_lineno)
        f = f.f_back
    return None


class Operator:
    """One node of the IR (reference ``OpDesc``, ``framework.proto:157``).

    inputs / outputs: dict of slot name -> list of variable names.
    attrs: plain-python attribute dict; a sub-block is referenced by storing
    the Block object itself under the attr (serialized as block index).
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) if isinstance(v, (list, tuple)) else [v]
                       for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) if isinstance(v, (list, tuple)) else [v]
                        for k, v in (outputs or {}).items()}
        # normalize Variable objects to names
        for d in (self.inputs, self.outputs):
            for k, vs in d.items():
                d[k] = [v.name if isinstance(v, Variable) else v for v in vs]
        self.attrs = dict(attrs or {})
        self.creation_site = _creation_site()

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            elif isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                attrs[k] = v
        out = {"type": self.type, "inputs": self.inputs,
               "outputs": self.outputs, "attrs": attrs}
        # keep the diagnostic pointer across save/load round-trips:
        # replay --localize names an op of a DESERIALIZED program, and
        # without the site the report can only say "op #12"
        if self.creation_site is not None:
            out["creation_site"] = list(self.creation_site)
        return out

    @staticmethod
    def from_dict(block, d, program):
        attrs = {}
        for k, v in d["attrs"].items():
            if isinstance(v, dict) and "__block__" in v:
                attrs[k] = program.block(v["__block__"])
            elif isinstance(v, dict) and "__ndarray__" in v:
                attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
            else:
                attrs[k] = v
        op = Operator(block, d["type"], d["inputs"], d["outputs"], attrs)
        site = d.get("creation_site")
        if site:
            op.creation_site = (site[0], site[1])
        return op

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Op(type={self.type}, inputs={ins}, outputs={outs})"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """An ordered list of ops plus its variable symbol table
    (reference ``BlockDesc``, ``framework.proto:163``)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    @property
    def parent_block(self):
        return None if self.parent_idx < 0 else self.program.block(self.parent_idx)

    # -- variables ---------------------------------------------------------
    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, shape, dtype, **kwargs):
        p = Parameter(self, shape, dtype, **kwargs)
        # parameters always live in the root (global) block, like the reference
        gblock = self.program.global_block()
        p.block = gblock
        gblock.vars[p.name] = p
        return p

    def var(self, name):
        """Find a variable by name, searching ancestor blocks."""
        block = self
        while block is not None:
            if name in block.vars:
                return block.vars[name]
            block = block.parent_block
        raise KeyError(f"variable {name!r} not found in block {self.idx} "
                       f"or its ancestors")

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def has_var_local(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ---------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self._infer_shape(op)
        self.program.bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self._infer_shape(op)
        self.program.bump_version()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self._infer_shape(op)
        self.program.bump_version()
        return op

    def remove_op(self, index):
        self.ops.pop(index)
        self.program.bump_version()

    def _infer_shape(self, op):
        # late import to avoid cycle; infer_shape is best-effort at build time
        from paddle_tpu_torch.ops import registry
        # declare any still-undeclared outputs (grad vars, temporaries)
        for n in op.output_arg_names:
            if n and not self.has_var(n):
                v = Variable(self, name=n)
                v.shape = None
                self.vars[n] = v
        opdef = registry.lookup(op.type)
        if opdef is not None and opdef.infer_shape is not None:
            try:
                opdef.infer_shape(op, self)
            except (registry.ShapeInferenceSkip, KeyError, TypeError):
                pass

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """A whole computation: list of blocks, block 0 is global
    (reference ``ProgramDesc``, ``framework.proto:176``)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0  # bumped on mutation; part of the jit cache key
        self.random_seed = 0
        # parity with reference Program attributes
        self._is_inference = False
        # mixed precision (bf16 compute, f32 master weights).  None = defer
        # to the PADDLE_TPU_AMP env var; True/False = explicit per-program.
        self.amp = None
        # programs that deliberately carry host ops (metrics, decoding,
        # persistence) set this to suppress the host-op-cliff warning —
        # it stays on for programs that hit the cliff unexpectedly
        self.expect_host_ops = False

    # -- blocks ------------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx=None):
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    @property
    def num_blocks(self):
        return len(self.blocks)

    def bump_version(self):
        self._version += 1

    # -- cloning / pruning -------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy the program.  With for_test=True, ops flip their
        ``is_test`` attr (dropout/batch_norm behave in inference mode),
        mirroring reference ``Program.clone`` semantics."""
        p = Program.from_dict(self.to_dict())
        self._copy_param_attrs_to(p)
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in op.attrs or op.type in ("dropout", "batch_norm"):
                        op.attrs["is_test"] = True
        return p

    def _copy_param_attrs_to(self, other):
        """Carry non-serializable Parameter attrs (regularizer, clip) onto
        a program reconstructed via from_dict."""
        src = {v.name: v for v in self.global_block().vars.values()
               if isinstance(v, Parameter)}
        for v in other.global_block().vars.values():
            if isinstance(v, Parameter) and v.name in src:
                s = src[v.name]
                v.regularizer = s.regularizer
                v.gradient_clip_attr = s.gradient_clip_attr
                v.do_model_average = s.do_model_average

    def prune(self, targets):
        """Backward-slice the global block to the ops needed for ``targets``
        (reference ``framework/prune.cc``).  Control-flow ops keep their
        sub-blocks intact.  Returns a new Program."""
        target_names = set()
        for t in targets:
            target_names.add(t.name if isinstance(t, Variable) else t)
        src = self.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(src.ops):
            if any(o in needed for o in op.output_arg_names):
                kept.append(op)
                needed.update(op.input_arg_names)
        kept.reverse()

        pruned = Program()
        pruned.random_seed = self.random_seed
        pruned.amp = self.amp
        # copy sub-blocks wholesale (indices preserved) so block attrs resolve
        for b in self.blocks[1:]:
            nb = Block(pruned, len(pruned.blocks), parent_idx=b.parent_idx)
            pruned.blocks.append(nb)
            for v in b.vars.values():
                nb.vars[v.name] = Variable.from_dict(nb, v.to_dict())
            for op in b.ops:
                nb.ops.append(Operator.from_dict(nb, op.to_dict(), pruned))
        dst = pruned.global_block()
        for v in src.vars.values():
            dst.vars[v.name] = Variable.from_dict(dst, v.to_dict())
        for op in kept:
            dst.ops.append(Operator.from_dict(dst, op.to_dict(), pruned))
        self._copy_param_attrs_to(pruned)
        return pruned

    def inference_optimize(self):
        p = self.clone(for_test=True)
        p._is_inference = True
        return p

    # -- serialization -----------------------------------------------------
    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks],
                "random_seed": self.random_seed,
                "amp": self.amp,
                "expect_host_ops": self.expect_host_ops}

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.amp = d.get("amp")
        p.expect_host_ops = d.get("expect_host_ops", False)
        # create all blocks first so sub-block attrs can resolve
        for bd in d["blocks"][1:]:
            b = Block(p, bd["idx"], parent_idx=bd["parent_idx"])
            p.blocks.append(b)
        for b, bd in zip(p.blocks, d["blocks"]):
            for vd in bd["vars"]:
                b.vars[vd["name"]] = Variable.from_dict(b, vd)
            for od in bd["ops"]:
                b.ops.append(Operator.from_dict(b, od, p))
        return p

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                lines.append(f"  var {v.name}: shape={v.shape} dtype={v.dtype}"
                             + (" persistable" if v.persistable else ""))
            for op in b.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)

    __str__ = to_string

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()


# ---------------------------------------------------------------------------
# default programs / guards (reference framework.py:1235,1277)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program):
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
