"""Spawned gloo worlds for the port's multi-rank CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_collective.py``,
``test_torch_mesh_ckpt.py``, ``test_torch_pipeline_transpiler.py``,
``test_torch_sharded_table.py``).  Not a test module: it imports only numpy,
torch and the port, so a spawned rank never loads JAX.

:func:`run_world` starts ``world`` ranks with the ``spawn`` start method;
each joins a gloo world through a ``FileStore`` under the test's
``tmp_path`` (no TCP port, so parallel test workers cannot collide),
runs one job function of this module on a pickled payload, and rank 0's
return value comes back.  :func:`spawn_world` starts the ranks before
the payload is sent, so that their start-up overlaps the caller's work.  Every rank is joined within ``timeout``
seconds; a rank that fails or overstays has every rank killed and the
test fails with the rank's traceback.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

#: seconds a world may take from spawn to its last rank's exit
WORLD_TIMEOUT = 120


def run_world(job, world, tmp_path, payload, timeout=WORLD_TIMEOUT):
    """Rank 0's ``job(rank, world, payload)`` of a spawned ``world``."""
    return start_world(job, world, tmp_path, payload, timeout)()


def start_world(job, world, tmp_path, payload, timeout=WORLD_TIMEOUT):
    """Spawn the world and return ``result()``, which joins it (so the
    caller can work meanwhile) and returns rank 0's value."""
    send, result = spawn_world(job, world, tmp_path, timeout)
    send(payload)
    return result


def spawn_world(job, world, tmp_path, timeout=WORLD_TIMEOUT):
    """Spawn the world before its payload exists: ``(send, result)``.
    The ranks import the port and join their process group, then wait
    for ``send(payload)``, so the caller builds the payload meanwhile;
    ``result()`` joins the world and returns rank 0's value."""
    import multiprocessing as mp
    d = os.path.join(str(tmp_path), f"world-{job.__name__}-{time.time_ns()}")
    os.makedirs(d)
    ctx = mp.get_context("spawn")
    # daemons: a caller that fails before it sends leaves no rank behind
    procs = [ctx.Process(target=_entry, args=(job.__name__, r, world, d,
                                              timeout), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout

    def send(payload):
        tmp = os.path.join(d, "payload.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, os.path.join(d, "payload.pkl"))

    return send, lambda: _join(job, world, d, procs, deadline, timeout)


def _join(job, world, d, procs, deadline, timeout):
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > deadline:
                failed = "timeout"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    if failed is not None:
        msgs = []
        for r in range(world):
            path = os.path.join(d, f"error-{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    msgs.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"world of {world} for {job.__name__} failed "
                           f"({'timed out after ' + str(timeout) + ' s' if failed == 'timeout' else 'rank ' + str(failed)})"
                           + ("\n" + "\n".join(msgs) if msgs else ""))
    with open(os.path.join(d, "result.pkl"), "rb") as f:
        return pickle.load(f)


def _entry(name, rank, world, d, timeout):
    try:
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import parallel
        parallel.init_parallel_env(
            num_processes=world, process_id=rank, place=pt.CPUPlace(),
            init_method=f"file://{os.path.join(d, 'store')}", timeout_s=90)
        path = os.path.join(d, "payload.pkl")
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError("no payload was sent")
            time.sleep(0.02)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        result = globals()[name](rank, world, payload)
        if rank == 0:
            with open(os.path.join(d, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
        parallel.destroy_parallel_env()
    except BaseException:
        with open(os.path.join(d, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

_MESHES = {}


def multi(rank, world, jobs):
    """Several jobs in one world: ``[(job name, payload), ...]``."""
    return [globals()[name](rank, world, payload) for name, payload in jobs]


def _mesh(shape, names):
    """One mesh of each shape a world (each makes process groups)."""
    from paddle_tpu_torch.parallel import make_mesh
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, names)
    return _MESHES[key]


def _numpy(v):
    from paddle_tpu_torch.convert import to_numpy
    return to_numpy(v)


def train_cases(rank, world, cases):
    """Each case trains a program (a JAX package ``Program.to_dict()``)
    through ``ParallelExecutor`` from the given state: ``{"program",
    "state", "feeds" (one dict a step), "fetch", "mesh": (shape, names),
    "shardings", "zero", "rank_state": rank 0's state differs from the
    others' until the first step's broadcast, "pipeline": drive it with
    run_pipeline}``.  Returns per case the fetches of every step, the
    final state, and the ZeRO plan's placements, skips and rank 0's local
    shard shapes."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel import ParallelExecutor
    out = []
    for case in cases:
        prog = pt.Program.from_dict(case["program"])
        state = dict(case["state"])
        if case.get("rank_state") and rank != 0:
            rng = np.random.RandomState(rank)
            state = {n: (rng.standard_normal(np.shape(a)).astype(a.dtype)
                         if np.asarray(a).dtype.kind == "f" else a)
                     for n, a in state.items()}
        scope = scope_from_numpy(state, pt.CPUPlace())
        mesh = _mesh(*case["mesh"])
        pexe = ParallelExecutor(main_program=prog, mesh=mesh,
                                param_shardings=case.get("shardings"),
                                zero=case.get("zero", False))
        if case.get("pipeline"):
            import paddle_tpu_torch.datapipe as dp
            pipe = dp.InMemorySource(case["rows"]).batch(
                case["batch"], drop_last=True)
            fetches = pexe.run_pipeline(prog, pipe,
                                        fetch_list=case["fetch"],
                                        scope=scope)
        else:
            fetches = [pexe.run(feed=f, fetch_list=case["fetch"],
                                scope=scope) for f in case["feeds"]]
        names = sorted(n for n, v in scope.items()
                       if isinstance(v, torch.Tensor))
        final = {n: _numpy(scope.find_var(n)) for n in names}
        unchanged = prog.to_dict() == pt.Program.from_dict(
            case["program"]).to_dict()
        plan = pexe.zero_plan
        local = {}
        if plan:
            local = {n: tuple(scope.find_var(n).to_local().shape)
                     for n in plan.placements
                     if hasattr(scope.find_var(n), "to_local")}
        out.append({"fetches": [[np.asarray(x) for x in f]
                                for f in fetches],
                    "state": final,
                    "placements": dict(plan.placements) if plan else {},
                    "skipped": dict(plan.skipped) if plan else {},
                    "local_shapes": local,
                    "broadcasts": dict(pexe.broadcast_stats),
                    "program_unchanged": unchanged})
    return out


def ring_cases(rank, world, cases):
    """``ring_attention`` of whole q, k, v on a ``(world,)`` ``seq`` mesh
    and the grads of ``sum(out * cot)``: ``{"q", "k", "v", "cot",
    "causal"}`` each; returns ``(out, dq, dk, dv)`` each."""
    import torch
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    mesh = _mesh((world,), ("seq",))
    out = []
    for case in cases:
        q, k, v = (torch.from_numpy(case[n]).requires_grad_()
                   for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, mesh, axis="seq", causal=case["causal"])
        (o * torch.from_numpy(case["cot"])).sum().backward()
        out.append(tuple(t.detach().numpy() for t in
                         (o, q.grad, k.grad, v.grad)))
    return out


def collective_cases(rank, world, _payload):
    """The helpers of ``parallel.collective`` on a ``(world,)`` ``x``
    mesh, each rank holding ``arange(8) + 8 * rank``: every rank's
    results, gathered to rank 0 through the files the ranks write."""
    import torch
    from paddle_tpu_torch.parallel import collective
    mesh = _mesh((world,), ("x",))
    x = torch.arange(8.0) + 8 * rank
    res = {
        "all_reduce": collective.all_reduce(x, "x", mesh=mesh),
        "all_reduce_max": collective.all_reduce(x, "x", "max", mesh=mesh),
        "all_gather": collective.all_gather(x, "x", mesh=mesh),
        "reduce_scatter": collective.reduce_scatter(x, "x", mesh=mesh),
        "broadcast": collective.broadcast(x, "x", root=3 % world,
                                          mesh=mesh),
        "all_to_all": collective.all_to_all(x.reshape(world, -1), "x", 0, 1,
                                            mesh=mesh),
    }
    xg = x.clone().requires_grad_()
    (collective.all_reduce(xg, "x", mesh=mesh) *
     (rank + 1)).sum().backward()
    res["all_reduce_grad"] = xg.grad
    xg = x.clone().requires_grad_()
    (collective.all_gather(xg, "x", mesh=mesh) *
     torch.arange(8.0 * world)).sum().backward()
    res["all_gather_grad"] = xg.grad
    res = {k: v.detach().numpy() for k, v in res.items()}
    return _gather_objects(res)


def _gather_objects(obj):
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def collective_op_cases(rank, world, cases):
    """Programs of ``c_*`` ops (a JAX package ``to_dict()``) through
    ``ParallelExecutor`` on a ``(world,)`` ``data`` mesh, each rank fed
    its own ``x`` (``feeds[rank]``, ``x`` replicated as a feed whose
    batch the mesh does not split): every rank's fetches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import ParallelExecutor
    mesh = _mesh((world,), ("data",))
    out = []
    for case in cases:
        prog = pt.Program.from_dict(case["program"])
        pexe = ParallelExecutor(main_program=prog, mesh=mesh)
        got = pexe.run(feed=case["feeds"][rank], fetch_list=case["fetch"],
                       scope=pt.Scope())
        out.append(_gather_objects([np.asarray(g) for g in got]))
    return out


def ckpt_save(rank, world, case):
    """Train ``case`` (as :func:`train_cases`) on a dp mesh with ZeRO,
    then ``io.save_checkpoint(mesh=, shard_specs=plan)`` into
    ``case["dir"]``; returns the saved state and the plan's specs."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel import ParallelExecutor
    prog = pt.Program.from_dict(case["program"])
    scope = scope_from_numpy(case["state"], pt.CPUPlace())
    mesh = _mesh(*case["mesh"])
    pexe = ParallelExecutor(main_program=prog, mesh=mesh, zero=True)
    for f in case["feeds"]:
        pexe.run(feed=f, fetch_list=case["fetch"], scope=scope)
    path = pt.io.save_checkpoint(pexe, case["dir"], prog, step=7,
                                 scope=scope, mesh=mesh,
                                 shard_specs=pexe.zero_plan.checkpoint_specs())
    # the same state through a CheckpointManager on the mesh
    from paddle_tpu_torch.fault import CheckpointManager
    CheckpointManager(case["dir"] + "-mgr", keep=2, executor=pexe,
                      main_program=prog, scope=scope, mesh=mesh,
                      shard_specs=pexe.zero_plan.checkpoint_specs()).save(9)
    names = sorted(n for n, v in scope.items()
                   if isinstance(v, torch.Tensor))
    state = {n: _numpy(scope.find_var(n)) for n in names}
    return {"path": path, "state": state,
            "specs": pexe.zero_plan.checkpoint_specs()}


def ckpt_restore(rank, world, case):
    """``io.load_checkpoint(mesh=)`` of ``case["dir"]`` onto a
    ``case["mesh"]`` mesh, with ZeRO's plan for this world checking the
    placements, then ``case["feeds"]`` more steps: the restored state
    (global values), the placements restored, rank 0's local shapes and
    the steps' fetches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import ParallelExecutor
    prog = pt.Program.from_dict(case["program"])
    scope = pt.Scope()
    mesh = _mesh(*case["mesh"])
    pexe = ParallelExecutor(main_program=prog, mesh=mesh, zero=True)
    step = pt.io.load_checkpoint(pexe, case["dir"], prog, scope=scope,
                                 mesh=mesh)
    names = sorted(n for n, v in scope.items()
                   if isinstance(v, torch.Tensor))
    restored = {n: _numpy(scope.find_var(n)) for n in names}
    # the split dim of each mesh axis (None: not split)
    placements = {n: [p.dim if p.is_shard() else None
                      for p in scope.find_var(n).placements]
                  for n in names}
    local = {n: tuple(scope.find_var(n).to_local().shape) for n in names}
    fetches = [pexe.run(feed=f, fetch_list=case["fetch"], scope=scope)
               for f in case.get("feeds", ())]
    out = {"step": step, "state": restored, "placements": placements,
           "local_shapes": local, "fetches": fetches,
           "plan": dict(pexe.zero_plan.placements)}
    if case.get("manager"):
        from paddle_tpu_torch.fault import CheckpointManager
        mscope = pt.Scope()
        mgr = CheckpointManager(case["dir"] + "-mgr", executor=pexe,
                                main_program=prog, scope=mscope, mesh=mesh)
        out["manager_step"] = mgr.restore_latest()
        out["manager_state"] = {n: _numpy(mscope.find_var(n))
                                for n in names}
    return out


def ckpt_save_async(rank, world, case):
    """``CheckpointManager(mesh=).save_async`` while the ranks keep
    stepping: train ``case`` with ZeRO for its first feed, start the save,
    then run the other feeds while the writer thread is held (every shard
    write waits until the steps ended), then ``wait_pending()``.  Returns
    the state at the save (global values), the committed path, the
    future's path, the later steps' fetches, and the threads that ran
    the save's collectives (the pieces' redistribution, the commit's
    agreement)."""
    import threading

    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.fault import CheckpointManager, shard_ckpt
    from paddle_tpu_torch.parallel import ParallelExecutor
    prog = pt.Program.from_dict(case["program"])
    scope = scope_from_numpy(case["state"], pt.CPUPlace())
    mesh = _mesh(*case["mesh"])
    pexe = ParallelExecutor(main_program=prog, mesh=mesh, zero=True)
    first, *rest = case["feeds"]
    pexe.run(feed=first, fetch_list=case["fetch"], scope=scope)
    names = sorted(n for n, v in scope.items()
                   if isinstance(v, torch.Tensor))
    at_save = {n: _numpy(scope.find_var(n)) for n in names}
    steps_done = threading.Event()
    patched = {(shard_ckpt, "_write_one"), (shard_ckpt, "mesh_pieces"),
               (io, "_mesh_flag")}
    real = {(m, n): getattr(m, n) for m, n in patched}
    threads = set()

    def held(*args):
        if not steps_done.wait(60):
            raise TimeoutError("the steps did not end")
        return real[shard_ckpt, "_write_one"](*args)

    def collective(module, name):
        def run(*args, **kwargs):
            threads.add(threading.current_thread().name)
            return real[module, name](*args, **kwargs)
        return run

    shard_ckpt._write_one = held
    shard_ckpt.mesh_pieces = collective(shard_ckpt, "mesh_pieces")
    io._mesh_flag = collective(io, "_mesh_flag")
    try:
        mgr = CheckpointManager(case["dir"], keep=2, executor=pexe,
                                main_program=prog, scope=scope, mesh=mesh,
                                shard_specs=pexe.zero_plan.checkpoint_specs())
        future = mgr.save_async(5)
        fetches = [pexe.run(feed=f, fetch_list=case["fetch"], scope=scope)
                   for f in rest]
        pending = not future.done()
        steps_done.set()
        path = mgr.wait_pending()
    finally:
        for (module, name), fn in real.items():
            setattr(module, name, fn)
    return {"state": at_save, "path": path, "future": future.result(),
            "pending_while_stepping": pending, "fetches": fetches,
            "collective_threads": threads,
            "after": {n: _numpy(scope.find_var(n)) for n in names}}


def pipeline_cases(rank, world, cases):
    """Each case runs a program (a JAX package ``Program.to_dict()``)
    through the port's pipeline transpiler from the given state:
    ``{"program", "state", "batches" (one feed dict a microbatch),
    "feeds", "fetch", "stages", "mesh": (shape, names), "data_axis",
    "grads": differentiate the sum of the first fetch}``.  Returns per
    case every fetch ``[M, ...]``, the named grads, whether every rank
    got the same fetches and grads, the carrier lanes and the stage op
    counts; or ``{"error": message}`` where the transpiler raised
    ``ValueError``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.pipeline_transpiler import \
        pipeline_transpiler
    out = []
    for case in cases:
        prog = pt.Program.from_dict(case["program"])
        scope = scope_from_numpy(case["state"], pt.CPUPlace())
        mesh = _mesh(*case["mesh"])
        try:
            pp = pipeline_transpiler(prog, case["stages"], case["feeds"],
                                     case["fetch"], mesh)
            pp.build(scope, case["batches"][0])
            xs = pp.stack_microbatches(case["batches"])
            packed = {lane: v.clone().requires_grad_(lane != "i32")
                      for lane, v in pp.packed_params.items()}
            outs = pp.run_fn(data_axis=case.get("data_axis"))(packed, xs)
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        fetches = {n: pp.select_fetch(outs, n).detach().numpy()
                   for n in case["fetch"]}
        grads = None
        if case.get("grads"):
            pp.select_fetch(outs, case["fetch"][0]).sum().backward()
            grads = pp.unpack_grads({lane: v.grad for lane, v in
                                     packed.items() if v.grad is not None})
        mine = (fetches, grads)
        every = _gather_objects(mine)
        same = all(_same(mine, other) for other in every)
        out.append({"fetches": fetches, "grads": grads,
                    "same_on_every_rank": same,
                    "carrier_lanes": pp.carrier_lanes,
                    "stage_ops": [len(s) for s in pp.stage_ops],
                    "n_outputs": {lane: tuple(v.shape)
                                  for lane, v in outs.items()}})
    return out


def _same(a, b):
    """Equal nested fetch/grad structures, array by array, bitwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def gpipe_cases(rank, world, cases):
    """``gpipe`` of ``x + tanh(x @ w + b)`` stages (the JAX package's
    ``tests/test_pipeline.py`` stage): ``{"kind": "grads" | "train" |
    "encoder", ...}``.  ``grads``: the outputs and the grads of
    ``sum(out ** 2)`` for the stacked ``w``, ``b`` and the microbatches;
    ``train``: the losses of ``steps`` SGD steps on the pipelined MSE;
    ``encoder``: a lowered Transformer encoder layer (a JAX package
    ``Program.to_dict()``) as the stage function, its parameters
    stacked a stage."""
    import torch
    from paddle_tpu_torch.parallel.pipeline import gpipe, stack_stage_params
    out = []
    for case in cases:
        mesh = _mesh(*case["mesh"])
        if case["kind"] == "encoder":
            out.append(_gpipe_encoder(case, mesh))
            continue
        per_stage = [{k: torch.from_numpy(v) for k, v in p.items()}
                     for p in case["per_stage"]]
        params = {k: v.requires_grad_() for k, v in
                  stack_stage_params(per_stage).items()}
        xs = torch.from_numpy(case["xs"]).requires_grad_()

        def stage_fn(p, x):
            return x + torch.tanh(x @ p["w"] + p["b"])

        if case["kind"] == "grads":
            got = gpipe(stage_fn, params, xs, mesh, axis="pipe")
            (got ** 2).sum().backward()
            out.append({"out": got.detach().numpy(),
                        "w": params["w"].grad.numpy(),
                        "b": params["b"].grad.numpy(),
                        "xs": xs.grad.numpy()})
            continue
        target = torch.from_numpy(case["target"])
        losses = []
        for _ in range(case["steps"]):
            for v in params.values():
                v.grad = None
            loss = ((gpipe(stage_fn, params, xs.detach(), mesh,
                           axis="pipe") - target) ** 2).mean()
            loss.backward()
            with torch.no_grad():
                for v in params.values():
                    v -= 0.1 * v.grad
            losses.append(float(loss.detach()))
        out.append({"losses": losses})
    return out


def _gpipe_encoder(case, mesh):
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.executor import lower_block
    from paddle_tpu_torch.parallel.pipeline import gpipe, stack_stage_params
    prog = pt.Program.from_dict(case["program"])
    block = prog.global_block()
    per_stage = [{n: torch.from_numpy(a) for n, a in p.items()}
                 for p in case["per_stage"]]

    def stage_fn(params, x):
        env = dict(params)
        env["x"] = x
        aux = {"device": torch.device("cpu"), "rng_counter": -1,
               "lower_block": lower_block, "lod": {}}
        lower_block(block, env, aux)
        return env[case["out"]]

    got = gpipe(stage_fn, stack_stage_params(per_stage),
                torch.from_numpy(case["xs"]), mesh, axis="pipe")
    return {"out": got.detach().numpy()}


def sharded_table_cases(rank, world, case):
    """Row-sharded tables on a ``(world,)`` ``data`` mesh.  The exchange:
    ``sharded_gather`` of ``case["ids"]`` from each rank's block of
    ``case["w"]``, and ``sharded_scatter_add`` of ``(case["rows"],
    case["vals"])`` into zero blocks (every rank's new block).  The
    training: ``case["program"]`` (a JAX package ``to_dict()``) from
    ``case["state"]`` through ``ParallelExecutor`` over ``case["feeds"]``,
    once with ``plan_sharded_tables``' rules and once replicated: the
    losses, the final state (global values) and, sharded, rank 0's local
    heights of the planned tensors."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.embedding import (plan_sharded_tables,
                                            sharded_gather,
                                            sharded_scatter_add)
    from paddle_tpu_torch.parallel import ParallelExecutor
    mesh = _mesh((world,), ("data",))
    per = case["w"].shape[0] // world
    block = torch.from_numpy(case["w"][rank * per:(rank + 1) * per])
    out = {"gather": sharded_gather(block, torch.from_numpy(case["ids"]),
                                    "data", mesh).numpy()}
    new = sharded_scatter_add(torch.zeros_like(block),
                              torch.from_numpy(case["rows"]),
                              torch.from_numpy(case["vals"]), "data", mesh)
    out["scatter_blocks"] = _gather_objects(new.numpy())
    prog = pt.Program.from_dict(case["program"])
    plan = plan_sharded_tables(prog, mesh_axis="data", mesh=mesh)
    for name, rules in (("sharded", plan.rules()), ("replicated", None)):
        scope = scope_from_numpy(case["state"], pt.CPUPlace())
        pexe = ParallelExecutor(loss_name=case["fetch"][0],
                                main_program=prog, mesh=mesh,
                                param_shardings=rules)
        losses = [np.asarray(pexe.run(feed=f, fetch_list=case["fetch"],
                                      scope=scope)[0])
                  for f in case["feeds"]]
        names = sorted(n for n, v in scope.items()
                       if isinstance(v, torch.Tensor))
        out[name] = {"losses": losses,
                     "state": {n: _numpy(scope.find_var(n)) for n in names}}
        if rules:
            out[name]["local_rows"] = {
                n: tuple(scope.find_var(n).to_local().shape)[0]
                for n in plan.all_placements()}
            out[name]["placements"] = plan.checkpoint_specs()
    return out
