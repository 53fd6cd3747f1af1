"""Numerics observatory: per-op tensor-stat probes and the fused
training-health norms (the port of ``paddle_tpu.obs.numerics``;
``docs/observability.md`` "Run ledger & numerics").

Two halves, both cheap when disarmed:

* **Op probes.**  A CUDA graph replays the whole step at once, so the
  walk that names the first op with a non-finite output only exists in
  the executor's op-by-op eager step.  Arming a :class:`ProbeCollector`
  (``with numerics.probe(collector): ...``) forces that step, as op
  profiling does (probing enters the executor's signature), and
  ``executor.lower_block`` calls :func:`record_op` after each op with its
  outputs.  The collector keeps small stats (finite fraction, absmax,
  zero fraction, mean and std over the finite entries) for a bounded
  trail of recent ops and captures the FIRST op with a non-finite output,
  with its ``creation_site`` and the stats of its inputs at that moment.
  :func:`tensor_stats` reduces a tensor where it lies (on the card for a
  CUDA tensor) and reads back its five numbers only.
  :func:`localize_bundle` wires this into the sentinel's quarantine
  bundles: ``python -m paddle_tpu_torch replay <bundle> --localize``
  re-executes the step on the CPU op by op and names the poisoned op.
  The disarmed per-op cost is one module-global ``is None`` check.

* **Health norms.**  :func:`fused_check_fn` builds the reduction the
  sentinel runs on guarded steps: the all-finite test over every floating
  fetch and written state, the global parameter norm and the update norm
  of the step (and the loss), as one tensor read back with ONE host sync.
  The JAX package jits this into one XLA computation; here it is plain
  torch on the step's device (multi-tensor launches where torch has
  them), no hand-written kernel.  :func:`set_health_gauges` publishes the
  ``train.param_norm`` / ``train.grad_norm`` / ``train.update_ratio``
  gauges (``train.grad_norm`` is the l2 norm of the applied parameter
  update, the optimizer-scaled step).
"""

from __future__ import annotations

import collections
import contextlib
import logging

import numpy as np
import torch

__all__ = ["ProbeCollector", "probe", "probing_enabled", "record_op",
           "tensor_stats", "localize_bundle", "fused_check_fn",
           "split_fused", "health_from_norms", "set_health_gauges"]

logger = logging.getLogger(__name__)

# the armed probe collector; the disarmed per-op cost is this one read
_PROBE = None


def probing_enabled():
    """True while a probe collector is armed (forces the eager step, like
    ``profiler.op_profiling_enabled``: the per-op hook only exists in
    op-by-op execution)."""
    return _PROBE is not None


def _dtype_name(dtype):
    """A torch dtype under its numpy name (``float32``, ``bool``)."""
    return str(dtype).replace("torch.", "")


def as_tensor(value):
    """``value`` as a torch tensor (where it lies; a numpy value on the
    CPU, an ml_dtypes float widened to float32, a SelectedRows as its
    rows), or None when it has no tensor form (then its stats degrade to
    its type name)."""
    if isinstance(value, torch.Tensor):
        return value
    rows = getattr(value, "value", None)
    if isinstance(rows, torch.Tensor):
        return rows          # a SelectedRows: the stats of its rows
    try:
        arr = np.asarray(value)
    except Exception:
        return None
    kind = arr.dtype.kind
    if kind in ("O", "S", "U", "M", "m"):
        return None
    if kind == "V":
        # ml_dtypes low-precision floats (a JAX bundle's bfloat16)
        if "float" not in str(arr.dtype):
            return None
        arr = arr.astype("float32")
    # (ascontiguousarray makes a 0-d array 1-d: keep the shape)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def tensor_stats(value):
    """Small stats of one tensor: finite fraction, absmax, zero fraction,
    mean/std (over finite entries), dtype and shape.  A tensor is reduced
    on its own device and only these numbers come back (one read).  Never
    raises: a value with no tensor form degrades to its type name."""
    try:
        t = as_tensor(value)
    except Exception:
        t = None
    if t is None:
        return {"kind": type(value).__name__}
    out = {"dtype": _dtype_name(t.dtype), "shape": list(t.shape)}
    if t.numel() == 0:
        out.update(finite_frac=1.0, absmax=0.0, zero_frac=0.0,
                   mean=0.0, std=0.0)
        return out
    if t.is_complex():
        t = t.abs()
    with torch.no_grad():
        if not t.is_floating_point():
            a = t.to(torch.float64)
            got = torch.stack([a.abs().max(), (a == 0).to(torch.float64)
                               .mean(), a.mean(), a.std(correction=0)])
            absmax, zero, mean, std = got.tolist()
            out.update(finite_frac=1.0, absmax=absmax, zero_frac=zero,
                       mean=mean, std=std)
            return out
        # float32 covers bfloat16 and float16, as the JAX package casts
        a = t.to(torch.float32) if t.dtype != torch.float64 else t
        finite = torch.isfinite(a)
        n_finite = finite.sum()
        fin = torch.where(finite, a, torch.zeros((), dtype=a.dtype,
                                                  device=a.device))
        denom = n_finite.clamp(min=1).to(a.dtype)
        mean = fin.sum() / denom
        var = (torch.where(finite, a - mean, torch.zeros(
            (), dtype=a.dtype, device=a.device)) ** 2).sum() / denom
        got = torch.stack([n_finite.to(a.dtype),
                           (a == 0).sum().to(a.dtype), fin.abs().max(),
                           mean, var.sqrt()]).tolist()
    n, zeros, absmax, mean, std = got
    size = t.numel()
    out["finite_frac"] = int(n) / size
    out["zero_frac"] = zeros / size
    if n:
        out.update(absmax=absmax, mean=mean, std=std)
    else:
        out.update(absmax=None, mean=None, std=None)
    return out


def _non_finite(stats):
    frac = stats.get("finite_frac")
    return frac is not None and frac < 1.0


class ProbeCollector:
    """Per-op stat collector for one op-by-op execution.

    ``trail`` bounds the rolling window of recent op stat rows;
    ``poison_var`` (used by :func:`localize_bundle` on
    ``sentinel.nan``-injected bundles) NaNs that variable at its
    producing op, so the op-level poison lands exactly where the
    sentinel's post-step poison *would have* originated and the drill
    exercises the same localization machinery an organic fault does."""

    def __init__(self, trail=16, poison_var=None):
        self.trail = collections.deque(maxlen=max(1, int(trail)))
        self.poison_var = poison_var
        self.poisoned = False
        self.first_bad = None
        self.ops_probed = 0

    def record_op(self, op, outputs, env):
        from paddle_tpu_torch.profiler import runtime_metrics
        self.ops_probed += 1
        runtime_metrics.inc("numerics.ops_probed")
        if self.poison_var is not None and not self.poisoned \
                and self.poison_var in outputs:
            v = env[self.poison_var]
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                env[self.poison_var] = torch.full_like(v, float("nan"))
                self.poisoned = True
        out_stats = {n: tensor_stats(env.get(n))
                     for n in op.output_arg_names if n}
        row = {"index": self.ops_probed - 1, "type": op.type,
               "outputs": out_stats}
        self.trail.append(row)
        if self.first_bad is None and \
                any(_non_finite(s) for s in out_stats.values()):
            runtime_metrics.inc("numerics.non_finite_ops")
            in_stats = {n: tensor_stats(env.get(n))
                        for n in op.input_arg_names
                        if n and env.get(n) is not None}
            self.first_bad = {
                "index": self.ops_probed - 1,
                "type": op.type,
                "creation_site": list(getattr(op, "creation_site", None)
                                      or ()) or None,
                "outputs": out_stats,
                "inputs": in_stats,
                "trail": [dict(r) for r in self.trail],
            }


@contextlib.contextmanager
def probe(collector):
    """Arm ``collector`` as the process-global probe for the body."""
    global _PROBE
    prev = _PROBE
    _PROBE = collector
    try:
        yield collector
    finally:
        _PROBE = prev


def record_op(op, outputs, env):
    """Executor hook: called after each lowered op of the eager step
    while a probe is armed (``lower_block``)."""
    p = _PROBE
    if p is not None:
        p.record_op(op, outputs, env)


# ---------------------------------------------------------------------------
# op-level fault localization (`python -m paddle_tpu_torch replay --localize`)
# ---------------------------------------------------------------------------

def _poison_target(program, fetch_names, loss_name=None):
    """The variable an injected bundle's op-level poison lands on: the
    recorded loss fetch when its producing op is in the program, else
    the first fetch produced by any op."""
    block = program.global_block()
    produced = set()
    for op in block.ops:
        produced.update(n for n in op.output_arg_names if n)
    if loss_name and loss_name in produced:
        return loss_name
    for name in fetch_names:
        if name in produced:
            return name
    return None


def localize_bundle(path, trail=16):
    """Re-execute a quarantine bundle op by op on the CPU with probes
    armed and name the first op producing a non-finite output.

    Returns ``{"localized": bool, "first_bad_op": {...} | None, "step",
    "reason", "injected", "ops_probed", "bad", "health"}``:
    ``first_bad_op`` carries the op type, its ``creation_site`` (file,
    line of the user code that appended it), per-output stats, the stats
    of its inputs at that moment, and the trailing stat rows leading into
    it.  Bundles whose fault the ``sentinel.nan`` failpoint made poison
    the loss-producing op during the re-execution (the sentinel's poison
    is post-step, so no op would produce the NaN itself).  Malformed or
    unreplayable bundles raise ``ValueError`` (the CLI's exit 2), as
    :func:`paddle_tpu_torch.fault.sentinel.replay_bundle` does, and the
    report carries its ``rng_device`` and ``rng_device_mismatch``.
    Bundles written by either package load here."""
    from paddle_tpu_torch.fault.sentinel import (load_bundle,
                                                 rebuild_repro,
                                                 rng_device_mismatch)

    bundle = load_bundle(path)
    exe, program, scope, feed, fetch_names = rebuild_repro(path, bundle)
    det = bundle.get("detector") or {}
    collector = ProbeCollector(trail=trail)
    if bundle.get("injected"):
        collector.poison_var = _poison_target(
            program, fetch_names, loss_name=det.get("loss_name"))
    try:
        with probe(collector):
            exe.run(program, feed=feed, fetch_list=fetch_names,
                    scope=scope)
    except Exception as e:
        raise ValueError(
            f"{path}: bundle does not re-execute: {e}") from e
    return {
        "localized": collector.first_bad is not None,
        "first_bad_op": collector.first_bad,
        "step": bundle.get("step"),
        "reason": bundle.get("reason"),
        "injected": bool(bundle.get("injected")),
        "ops_probed": collector.ops_probed,
        "bad": list(bundle.get("bad") or []),
        "health": bundle.get("health"),
        "rng_device": bundle["repro"].get("rng_device"),
        "rng_device_mismatch": rng_device_mismatch(bundle, program),
    }


# ---------------------------------------------------------------------------
# fused training-health norms (the sentinel's guarded-step reduction)
# ---------------------------------------------------------------------------

def _all_finite(arrs, device):
    """A one-element float32 tensor on ``device``: 1 when every tensor of
    ``arrs`` is finite.  One multi-tensor launch per (device, dtype) group
    (the AMP unscale check at a scale of 1, which leaves every value as it
    was)."""
    groups = {}
    for a in arrs:
        groups.setdefault((a.device, a.dtype), []).append(a)
    bad = []
    for (dev, dtype), group in groups.items():
        found = torch.zeros(1, device=dev)
        if dtype in (torch.float32, torch.float16, torch.bfloat16):
            torch._amp_foreach_non_finite_check_and_unscale_(
                group, found, torch.ones(1, device=dev))
        else:
            for a in group:
                found += (~torch.isfinite(a).all()).to(torch.float32)
        bad.append(found.to(device))
    return (torch.stack(bad).sum() == 0).to(torch.float32).reshape(1)


def _ssq(xs):
    """Sum of squares of every element of ``xs``, in float32."""
    norms = torch._foreach_norm([x if x.dtype in (
        torch.float32, torch.float64) else x.to(torch.float32) for x in xs])
    return torch.stack([n.to(torch.float32) for n in norms]).square().sum()


def fused_check_fn():
    """Build the fused guarded-step reduction: all-finite over every
    floating check tensor PLUS the global parameter/update norms, as ONE
    small float32 tensor on the step's device, which the caller reads
    back once (the one host sync of a guarded step).

    Signature: ``fn(arrs, new_params, old_params, extra=()) -> flat`` with
    ``flat = [all_finite, param_norm, update_norm, *extra]``: ``all_finite``
    1.0 or 0.0, the two norms only when parameter pairs were passed, and
    the first element of each tensor of ``extra`` (the sentinel passes the
    loss, so the spike detector needs no second read).  Use
    :func:`split_fused` on the values read back."""

    def _fused(arrs, new_params, old_params, extra=()):
        ref = list(arrs) + list(new_params) + list(extra)
        device = ref[0].device if ref else torch.device("cpu")
        with torch.no_grad():
            parts = [_all_finite(arrs, device) if arrs
                     else torch.ones(1, device=device)]
            if new_params:
                p = _ssq(list(new_params)).sqrt()
                u = _ssq(torch._foreach_sub(
                    [n.to(torch.float32) for n in new_params],
                    [o.to(torch.float32) for o in old_params])).sqrt()
                parts.append(torch.stack([p, u]).to(device))
            for e in extra:
                parts.append(e.detach().reshape(-1)[:1].to(
                    device=device, dtype=torch.float32))
            return torch.cat(parts)

    return _fused


def split_fused(values, with_norms):
    """``(all_finite, norms, extra)`` of a fused reduction's values read
    back as a list (``norms`` empty without parameter pairs)."""
    n = 2 if with_norms else 0
    return values[0] > 0, values[1:1 + n], values[1 + n:]


def health_from_norms(norms):
    """``(param_norm, update_norm)`` host floats -> the health dict the
    sentinel stashes in its escalation context (quarantine bundles,
    rollback post-mortems).  ``update_ratio`` is update/param: the
    step-size signal that precedes most divergences."""
    if norms is None or len(norms) < 2:
        return None
    param_norm = float(norms[0])
    grad_norm = float(norms[1])
    ratio = grad_norm / (param_norm + 1e-12)
    return {"param_norm": param_norm, "grad_norm": grad_norm,
            "update_ratio": ratio}


def set_health_gauges(metrics, health):
    """Publish the health dict as gauges.  The disabled path (no health
    computed this step) is the ``None`` check: nothing else runs."""
    if metrics is None or health is None:
        return
    metrics.set_gauge("train.param_norm", health["param_norm"])
    metrics.set_gauge("train.grad_norm", health["grad_norm"])
    metrics.set_gauge("train.update_ratio", health["update_ratio"])
