"""Recurrent ops: ``lstm``, ``gru`` and ``lstmp`` over a ragged batch, and
the one-step cells ``lstm_unit`` and ``gru_unit`` (the port of
``paddle_tpu.ops.rnn_ops``; reference ``paddle/fluid/operators/
lstm_op.cc``, ``gru_op.cc``, ``lstmp_op.h``, ``lstm_unit_op.cc``,
``gru_unit_op.cc``).

The ragged input ``[N, G]`` is gathered into time-major ``[T, B, G]``
by the LoD's pad table (``lod.pad_tables``: built once per LoD per run,
zero rows past each sequence's end), a Python loop runs the ``T = max
length`` steps on the device, a finished sequence keeps its last state
(the JAX package's mask blend ``m * new + (1 - m) * prev`` with m 0 or
1, here a ``where`` on the step's live mask: the same values and
grads), and the states scatter back to the flat rows.  ``is_reverse``
walks each sequence backwards inside its own length.  Grads are the
auto-vjp of these lowerings, as the JAX package's are ``jax.vjp`` of its
``lax.scan``.

Gate layouts follow the reference: ``lstm`` Weight ``[H, 4H]`` in gate
order (c, i, f, o), Bias ``[1, 4H]`` plus the peepholes ``w_ic``,
``w_fc``, ``w_oc`` at ``[4H:5H]``, ``[5H:6H]``, ``[6H:7H]``; ``gru``
Weight ``[H, 3H] = [W_u | W_r | W_c]``.

``lstm``, ``lstmp`` and ``gru`` are ``eager_only`` (their pad tables
are copied from the host LoD each run); the cells are not.  Under the
bucketed LoD mode (``lod.DynLoD``) the pad tables are built from the
splits tensor on the device (``lod.dyn_pad_tables``, the JAX package's
``_lod_pad_tables`` dynamic branch): the loop runs ``T = `` the length
bucket steps, masked by the runtime lengths, and the padding rows
scatter back as zeros; these three ops are then ``eager_dyn_ok``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import dyn_pad_tables, is_dyn, pad_tables
from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "linear": lambda x: x,
}

#: ``gru_unit``'s integer activation codes (reference gru_unit_op.h)
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _infer_rnn(op, block):
    w = block.var(op.input("Weight")[0])
    H = w.shape[0]
    for slot in ("Hidden", "Cell"):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = (-1, H)
            v.dtype = w.dtype
            x = block.var(op.input("Input")[0])
            v.lod_level = x.lod_level


def _infer_unit(op, block):
    prev = block.var(op.input("C_prev" if op.input("C_prev")
                              else "HiddenPrev")[0])
    for slot in ("C", "H", "Hidden"):
        names = op.output(slot)
        if names:
            v = block.var(names[0])
            v.shape = prev.shape
            v.dtype = prev.dtype


def _infer_lstmp(op, block):
    x = block.var(op.input("Input")[0])
    pw = block.var(op.input("ProjWeight")[0])
    if x.shape is None or pw.shape is None:
        raise ShapeInferenceSkip()
    h, p = pw.shape[0], pw.shape[1]
    proj = block.var(op.output("Projection")[0])
    proj.shape = (x.shape[0], p)
    proj.dtype = x.dtype
    proj.lod_level = x.lod_level
    cell = block.var(op.output("Cell")[0])
    cell.shape = (x.shape[0], h)
    cell.dtype = x.dtype
    cell.lod_level = x.lod_level


def _ragged_input(ctx):
    """``(x [N, G], its LoD, the LoD's pad tables)``; raises without a
    LoD on ``Input``."""
    x = ctx.input("Input")
    lod = ctx.input_lod("Input")
    if lod is None:
        raise ValueError(f"{ctx.op.type} op requires LoD on Input")
    reverse = ctx.attr("is_reverse", False)
    if is_dyn(lod):
        return x, lod, dyn_pad_tables(ctx.aux, lod, ctx.env, x.shape[0],
                                      reverse)
    return x, lod, pad_tables(ctx.aux, lod, x.device, reverse)


def _to_padded(x, pad):
    """Flat ``[N, G]`` -> ``[T, B, G]``, zeros past each sequence.
    ``index_select`` (not ``src[gather]``): its grad is an ``index_add``,
    where advanced indexing's sorts the indices on every backward."""
    src = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return src.index_select(0, pad.gather.reshape(-1)).reshape(
        (pad.T, pad.B) + tuple(x.shape[1:]))


def _to_flat(steps, pad):
    """The states of every step, ``[T, B, H]`` as a list of ``[B, H]``,
    back to the flat rows ``[N, H]`` (bucketed: a zero row appended, the
    padding rows' slot)."""
    ys = torch.stack(steps)
    ys = ys.reshape((pad.T * pad.B,) + tuple(ys.shape[2:]))
    if pad.pad_row:
        ys = torch.cat([ys, ys.new_zeros((1,) + tuple(ys.shape[1:]))])
    return ys.index_select(0, pad.scatter)


def _set_ragged_outputs(ctx, lod, pad, **steps):
    out_lod = lod if is_dyn(lod) else [list(level) for level in lod]
    for slot, states in steps.items():
        ctx.set_output(slot, _to_flat(states, pad))
        ctx.set_output_lod(slot, out_lod)


def _lstm_steps(ctx, xp, pad, recur, H, r0, c0, proj=None):
    """The LSTM recurrence over ``xp`` ``[T, B, 4H]`` from the states
    ``r0`` (the state fed back: ``h``, or lstmp's projection ``r =
    proj(h)``) and ``c0``; ``recur`` ``[D, 4H]`` is the fed-back state's
    weight.  Returns the per-step (fed-back state, cell) lists."""
    bias = ctx.input("Bias")
    if bias is not None:
        xp = xp + bias[:, :4 * H]
    peep = ctx.attr("use_peepholes", False)
    if peep:
        w_if = bias[:, 4 * H:6 * H].reshape(1, 2, H)     # w_ic, w_fc
        w_oc = bias[:, 6 * H:7 * H]
    act_gate = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    act_cell = _ACTS[ctx.attr("cell_activation", "tanh")]
    act_cand = _ACTS[ctx.attr("candidate_activation", "tanh")]
    r, c = r0, c0
    rs, cs = [], []
    for t in range(pad.T):
        g = torch.addmm(xp[t], r, recur).view(-1, 4, H)  # (c, i, f, o)
        if peep:
            i_f = act_gate(torch.addcmul(g[:, 1:3], c[:, None, :], w_if))
        else:
            i_f = act_gate(g[:, 1:3])
        cand = act_cand(g[:, 0])
        c_new = torch.addcmul(i_f[:, 1] * c, i_f[:, 0], cand)
        g_o = torch.addcmul(g[:, 3], c_new, w_oc) if peep else g[:, 3]
        h = act_gate(g_o) * act_cell(c_new)
        if proj is not None:
            h = proj(h)
        live = pad.live[t]
        r = torch.where(live, h, r)
        c = torch.where(live, c_new, c)
        rs.append(r)
        cs.append(c)
    return rs, cs


# ---------------------------------------------------------------------------
# lstm (layer: dynamic_lstm)
# ---------------------------------------------------------------------------

@register_op("lstm", infer_shape=_infer_rnn,
             eager_only=True, eager_dyn_ok=True)
def lstm_lower(ctx):
    x, lod, pad = _ragged_input(ctx)    # [N, 4H], pre-projected
    weight = ctx.input("Weight")        # [H, 4H]
    H = weight.shape[0]
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    zeros = x.new_zeros((pad.B, H))
    hs, cs = _lstm_steps(ctx, _to_padded(x, pad), pad, weight, H,
                         h0 if h0 is not None else zeros,
                         c0 if c0 is not None else zeros)
    _set_ragged_outputs(ctx, lod, pad, Hidden=hs, Cell=cs)


# ---------------------------------------------------------------------------
# lstmp (layer: dynamic_lstmp): the recurrence runs over r = act(h P)
# ---------------------------------------------------------------------------

@register_op("lstmp", infer_shape=_infer_lstmp,
             eager_only=True, eager_dyn_ok=True)
def lstmp_lower(ctx):
    x, lod, pad = _ragged_input(ctx)    # [N, 4H], pre-projected
    weight = ctx.input("Weight")        # [P, 4H], over r
    proj_weight = ctx.input("ProjWeight")   # [H, P]
    H, P = proj_weight.shape
    act_proj = _ACTS[ctx.attr("proj_activation", "tanh")]
    rs, cs = _lstm_steps(ctx, _to_padded(x, pad), pad, weight, H,
                         x.new_zeros((pad.B, P)), x.new_zeros((pad.B, H)),
                         proj=lambda h: act_proj(h @ proj_weight))
    _set_ragged_outputs(ctx, lod, pad, Projection=rs, Cell=cs)


# ---------------------------------------------------------------------------
# gru (layer: dynamic_gru)
# ---------------------------------------------------------------------------

@register_op("gru", infer_shape=_infer_rnn,
             eager_only=True, eager_dyn_ok=True)
def gru_lower(ctx):
    x, lod, pad = _ragged_input(ctx)    # [N, 3H]
    weight = ctx.input("Weight")        # [H, 3H] = [W_u | W_r | W_c]
    bias = ctx.input("Bias")            # [1, 3H]
    H = weight.shape[0]
    act_gate = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    act_cand = _ACTS[ctx.attr("activation", "tanh")]
    w_ur, w_c = weight[:, :2 * H], weight[:, 2 * H:]
    xp = _to_padded(x, pad)
    if bias is not None:
        xp = xp + bias
    h0 = ctx.input("H0")
    h = h0 if h0 is not None else x.new_zeros((pad.B, H))
    hs = []
    for t in range(pad.T):
        x_t = xp[t]
        ur = act_gate(torch.addmm(x_t[:, :2 * H], h, w_ur))
        u, r = ur[:, :H], ur[:, H:]
        cand = act_cand(torch.addmm(x_t[:, 2 * H:], r * h, w_c))
        # reference math/detail/gru_kernel.h: h = prev + u * (cand - prev)
        h = torch.where(pad.live[t], h + u * (cand - h), h)
        hs.append(h)
    _set_ragged_outputs(ctx, lod, pad, Hidden=hs)


# ---------------------------------------------------------------------------
# single-step cells
# ---------------------------------------------------------------------------

@register_op("lstm_unit", infer_shape=_infer_unit)
def lstm_unit_lower(ctx):
    """One LSTM step (reference lstm_unit_op.cc): X ``[B, 4H]``
    pre-projected, C_prev ``[B, H]`` -> C, H.  Gate order (i, f, o, g)
    per the reference lstm_unit_op.h:63-66 kernels."""
    x = ctx.input("X")
    c_prev = ctx.input("C_prev")
    H = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :H])
    f = torch.sigmoid(x[:, H:2 * H] + ctx.attr("forget_bias", 0.0))
    o = torch.sigmoid(x[:, 2 * H:3 * H])
    g = torch.tanh(x[:, 3 * H:])
    c = f * c_prev + i * g
    ctx.set_output("C", c)
    ctx.set_output("H", o * torch.tanh(c))


def _unit_act(ctx, name, default):
    v = ctx.attr(name, default)
    return _ACTS[_ACT_CODES.get(v, _ACT_CODES[default])
                 if isinstance(v, int) else v]


@register_op("gru_unit", infer_shape=_infer_unit)
def gru_unit_lower(ctx):
    """One GRU step (reference gru_unit_op.cc)."""
    x = ctx.input("Input")          # [B, 3H]
    h_prev = ctx.input("HiddenPrev")
    weight = ctx.input("Weight")    # [H, 3H]
    bias = ctx.input("Bias")
    act_gate = _unit_act(ctx, "gate_activation", 1)
    act_cand = _unit_act(ctx, "activation", 2)
    H = h_prev.shape[-1]
    if bias is not None:
        x = x + bias
    g_ur = x[:, :2 * H] + h_prev @ weight[:, :2 * H]
    u = act_gate(g_ur[:, :H])
    r = act_gate(g_ur[:, H:])
    reset_h = r * h_prev
    cand = act_cand(x[:, 2 * H:] + reset_h @ weight[:, 2 * H:])
    # reference gru_unit_op.h: h = prev + u * (cand - prev)
    ctx.set_output("Gate", torch.cat([u, r, cand], dim=-1))
    ctx.set_output("ResetHiddenPrev", reset_h)
    ctx.set_output("Hidden", h_prev + u * (cand - h_prev))
