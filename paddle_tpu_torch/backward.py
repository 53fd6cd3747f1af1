"""IR-level reverse-mode autodiff (the port's copy of
``paddle_tpu.backward``, so the two packages append the same grad ops).

One repair: a grad maker may leave the forward input out of its grad
op's inputs (``dropout_grad`` takes ``Out@GRAD`` and ``Mask``, not
``X``).  The JAX package then never records that ``X@GRAD`` exists, and
the chain of grads stops at every dropout: with dropout on, no parameter
upstream of one is trained.  Here the maker's ``input_grad_map`` names
the forward variable instead, so the grads flow on.  Programs without
such an op get the same grad ops as in the JAX package.

Re-design of the reference's ``python/paddle/fluid/backward.py``:
``append_backward(loss)`` walks the block's ops in reverse, asks each op's
grad maker for ``<type>_grad`` op descs (``_append_backward_ops_:273``),
sums duplicated gradients (``_addup_repetitive_outputs_:117``), prunes
branches where no path leads to a trainable input
(``_remove_no_grad_branch_:167``), and appends the grad ops to the program.

The grad ops are ordinary IR ops; the port's executor runs them op by
op after the forward, like any other op.
"""

from __future__ import annotations

import collections

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import grad_var_name, GRAD_SUFFIX, unique_name
from paddle_tpu_torch.ops import registry

__all__ = ["append_backward", "calc_gradient"]


def _get_grad_maker(op):
    opdef = registry.lookup(op.type)
    if opdef is not None and not opdef.has_grad:
        return None
    if opdef is not None and opdef.grad_maker is not None:
        return opdef.grad_maker
    return registry.default_grad_maker


def _collect_no_grad_set(block, no_grad_set):
    result = set(no_grad_set or ())
    for var in block.vars.values():
        if var.stop_gradient:
            result.add(var.name)
    parent = block.parent_block
    while parent is not None:
        for var in parent.vars.values():
            if var.stop_gradient:
                result.add(var.name)
        parent = parent.parent_block
    return result


def _ops_on_path(block, loss_name, no_grad_set):
    """Indices of ops on a differentiable path from inputs to the loss."""
    needed = {loss_name}
    on_path = []
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        if any(o in needed for o in op.output_arg_names):
            on_path.append(idx)
            needed.update(op.input_arg_names)
    return set(on_path)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, target_gradient=None):
    """Append grad ops for ``loss``; returns list of (param, grad_var)
    (reference ``backward.py:425``).  ``target_gradient`` optionally seeds
    d(loss) with a caller-supplied cotangent Variable instead of ones."""
    assert isinstance(loss, framework.Variable)
    block = loss.block
    program = block.program
    no_grad = _collect_no_grad_set(block, no_grad_set)

    on_path = _ops_on_path(block, loss.name, no_grad)

    # seed: d loss / d loss = 1 (or the supplied cotangent)
    loss_grad_name = grad_var_name(loss.name)
    if target_gradient is not None:
        block.append_op(type="assign",
                        inputs={"X": [target_gradient.name]},
                        outputs={"Out": [loss_grad_name]})
    else:
        block.append_op(
            type="fill_constant",
            outputs={"Out": [loss_grad_name]},
            attrs={"shape": list(loss.shape or (1,)), "value": 1.0,
                   "dtype": loss.dtype})
    gv = block.create_var(name=loss_grad_name, shape=loss.shape or (1,),
                          dtype=loss.dtype)
    gv.stop_gradient = True

    # available grads: forward var name -> list of grad var names feeding it
    grads_of = collections.defaultdict(list)
    grads_of[loss.name].append(loss_grad_name)

    fwd_ops = [(i, op) for i, op in enumerate(block.ops[:])]

    for idx, op in reversed(fwd_ops):
        if idx not in on_path:
            continue
        maker = _get_grad_maker(op)
        if maker is None:
            continue
        # does any output of this op have a pending gradient?
        out_has_grad = any(n in grads_of for n in op.output_arg_names)
        if not out_has_grad:
            continue

        # materialize summed grads for this op's outputs
        for out_name in set(op.output_arg_names):
            glist = grads_of.get(out_name)
            if glist and len(glist) > 1:
                summed = grad_var_name(out_name)
                # sum into the canonical name (reference _addup_repetitive_)
                tmp = unique_name(summed + "@RENAME")
                block.append_op(type="sum", inputs={"X": list(glist)},
                                outputs={"Out": [tmp]})
                v0 = block.var(glist[0])
                nv = block.create_var(name=tmp, shape=v0.shape,
                                      dtype=v0.dtype)
                nv.stop_gradient = True
                grads_of[out_name] = [tmp]

        grad_descs, input_grad_map = maker(op, block, no_grad)
        # forward var of each grad output the maker named: a maker may
        # leave the forward input slot out of its desc (dropout_grad takes
        # Out@GRAD and Mask, not X), so its input_grad_map is the fallback
        fwd_of_grad = {g: n for n, g in input_grad_map.items()}

        def fwd_name_of(desc, in_slot, i, gname):
            fwd_names = desc["inputs"].get(in_slot)
            if fwd_names is not None:
                return fwd_names[i] if i < len(fwd_names) else None
            return fwd_of_grad.get(gname)

        for desc in grad_descs:
            # rewire grad-op inputs: slot S@GRAD names are canonical
            # grad_var_name()s; replace with the actual available grad vars
            actual_inputs = {}
            for slot, names in desc["inputs"].items():
                if slot.endswith(GRAD_SUFFIX):
                    base_names = desc["inputs"].get(slot[:-len(GRAD_SUFFIX)],
                                                    [])
                    actual = []
                    for i, n in enumerate(names):
                        base = base_names[i] if i < len(base_names) else None
                        if base is None and n.endswith(GRAD_SUFFIX):
                            # maker omitted the forward-output slot (e.g.
                            # dropout_grad takes Out@GRAD but not Out);
                            # canonical grad names encode the base var
                            base = n[:-len(GRAD_SUFFIX)]
                        if base is not None and base in grads_of:
                            actual.append(grads_of[base][0])
                        else:
                            actual.append("")  # missing grad -> zeros
                    actual_inputs[slot] = actual
                else:
                    actual_inputs[slot] = names
            # rename grad outputs that would collide with an existing
            # pending contribution (reference _addup_repetitive_outputs_:
            # a var read by N ops receives N distinct grad names, summed
            # at consumption time)
            actual_outputs = {}
            for slot, names in desc["outputs"].items():
                if not slot.endswith(GRAD_SUFFIX):
                    actual_outputs[slot] = list(names)
                    continue
                in_slot = slot[:-len(GRAD_SUFFIX)]
                renamed = []
                for i, gname in enumerate(names):
                    if not gname:
                        renamed.append(gname)
                        continue
                    fwd_name = fwd_name_of(desc, in_slot, i, gname)
                    if fwd_name is not None and grads_of.get(fwd_name):
                        gname = unique_name(gname + "@RENAME")
                    renamed.append(gname)
                actual_outputs[slot] = renamed
            gop = block.append_op(type=desc["type"], inputs=actual_inputs,
                                  outputs=actual_outputs,
                                  attrs=desc["attrs"])
            if callbacks:
                for cb in callbacks:
                    cb(block, gop)
            # declare grad output vars + record availability
            for slot, names in actual_outputs.items():
                if not slot.endswith(GRAD_SUFFIX):
                    continue
                in_slot = slot[:-len(GRAD_SUFFIX)]
                for i, gname in enumerate(names):
                    if not gname:
                        continue
                    fwd_name = fwd_name_of(desc, in_slot, i,
                                           desc["outputs"][slot][i])
                    if fwd_name is not None:
                        fv = block.var(fwd_name)
                        nv = block.create_var(name=gname, shape=fv.shape,
                                              dtype=fv.dtype)
                        nv.stop_gradient = True
                        if gname not in grads_of[fwd_name]:
                            grads_of[fwd_name].append(gname)

    # final dedup: leaf vars (params, feeds) have no producing op on the
    # path, so their pending contributions were never summed — sum them
    # into the canonical grad name now
    for fwd_name, glist in list(grads_of.items()):
        if len(glist) <= 1:
            continue
        canonical = grad_var_name(fwd_name)
        block.append_op(type="sum", inputs={"X": list(glist)},
                        outputs={"Out": [canonical]})
        try:
            fv = block.var(fwd_name)
            nv = block.create_var(name=canonical, shape=fv.shape,
                                  dtype=fv.dtype)
            nv.stop_gradient = True
        except KeyError:
            pass
        grads_of[fwd_name] = [canonical]

    param_and_grads = []
    if parameter_list is not None:
        params = [block.program.global_block().var(p)
                  if isinstance(p, str) else p for p in parameter_list]
    else:
        params = [p for p in program.global_block().all_parameters()
                  if p.trainable]
    for p in params:
        glist = grads_of.get(p.name, [])
        if not glist:
            continue
        if len(glist) > 1:
            canonical = grad_var_name(p.name)
            block.append_op(type="sum", inputs={"X": list(glist)},
                            outputs={"Out": [canonical]})
            nv = block.create_var(name=canonical, shape=p.shape,
                                  dtype=p.dtype)
            nv.stop_gradient = True
            grads_of[p.name] = [canonical]
        grad_var = block.var(grads_of[p.name][0])
        param_and_grads.append((p, grad_var))

    # post-transpile contract (paddle_tpu_torch.analysis): the grad ops this
    # pass just appended must leave the program structurally well-formed
    # — a broken grad maker fails HERE with named ops/vars, not as a
    # missing variable at the first Executor.run
    from paddle_tpu_torch.analysis import verify_transpiled
    verify_transpiled(program, where="backward.append_backward")
    return param_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of ``targets`` w.r.t. ``inputs`` (reference
    ``backward.py:555``).  Returns grad Variables aligned with inputs."""
    if isinstance(targets, framework.Variable):
        targets = [targets]
    if isinstance(inputs, framework.Variable):
        inputs = [inputs]
    if target_gradients is not None and not isinstance(target_gradients,
                                                      (list, tuple)):
        target_gradients = [target_gradients]
    assert len(targets) == 1, "calc_gradient supports a single target"
    names = [v.name for v in inputs]
    seed = target_gradients[0] if target_gradients else None
    pg = append_backward(targets[0], parameter_list=[],
                         no_grad_set=no_grad_set, target_gradient=seed)
    block = targets[0].block
    result = []
    for name in names:
        g = grad_var_name(name)
        result.append(block.var(g) if block.has_var(g) else None)
    return result
