"""CSP concurrency DSL: Go, Select, make_channel, channel_send/recv/close
(the port of ``paddle_tpu.concurrency``; reference
``python/paddle/fluid/concurrency.py``).  Programs built here equal the
JAX package's; they run through ``ops/csp_ops.py`` (host threads,
Go-style channels from ``paddle_tpu_torch/channel.py``).
"""

from __future__ import annotations

from paddle_tpu_torch.framework import default_main_program, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["Go", "make_channel", "channel_send", "channel_recv",
           "channel_close", "Select"]


def _external_reads(sub_block):
    produced = set()
    reads = []
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if n and n not in produced and n not in reads:
                reads.append(n)
        for n in op.output_arg_names:
            produced.add(n)
    return [n for n in reads if not sub_block.has_var_local(n)]


class Go:
    """``with fluid.Go():`` — run the body as a goroutine
    (reference ``concurrency.py:27``)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("go", name=name)

    def __enter__(self):
        self._program = self.helper.main_program
        self._parent = self._program.current_block()
        self._sub = self._program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self._program.rollback()
        ext = _external_reads(self._sub)
        self._parent.append_op(
            type="go", inputs={"X": ext}, outputs={},
            attrs={"sub_block": self._sub})
        return True


def make_channel(dtype=None, capacity=0):
    """Create a channel variable (reference ``concurrency.py:279`` —
    channel_create op; capacity 0 = unbuffered rendezvous)."""
    helper = LayerHelper("channel_create")
    main_block = default_main_program().current_block()
    ch = main_block.create_var(name=unique_name("channel"))
    ch.persistable = True
    ch.stop_gradient = True
    main_block.append_op(
        type="channel_create", inputs={}, outputs={"Out": [ch]},
        attrs={"capacity": int(capacity),
               "data_type": str(dtype) if dtype is not None else None})
    return ch


def channel_send(channel, value, is_copy=False):
    """Send ``value`` into ``channel``; returns a bool status variable
    (reference ``concurrency.py:335``)."""
    helper = LayerHelper("channel_send")
    x = value
    if is_copy:
        copied = helper.create_tmp_variable(dtype=value.dtype)
        helper.append_op(type="assign", inputs={"X": [value]},
                         outputs={"Out": [copied]})
        x = copied
    status = helper.create_tmp_variable(dtype="bool", stop_gradient=True)
    helper.append_op(type="channel_send",
                     inputs={"Channel": [channel], "X": [x]},
                     outputs={"Status": [status]})
    return status


def channel_recv(channel, return_value):
    """Receive into ``return_value``; returns (value, status)
    (reference ``concurrency.py:385``)."""
    helper = LayerHelper("channel_recv")
    status = helper.create_tmp_variable(dtype="bool", stop_gradient=True)
    helper.append_op(type="channel_recv",
                     inputs={"Channel": [channel]},
                     outputs={"Out": [return_value], "Status": [status]})
    return return_value, status


def channel_close(channel):
    """Close the channel (reference ``concurrency.py:429``)."""
    helper = LayerHelper("channel_close")
    helper.append_op(type="channel_close", inputs={"Channel": [channel]},
                     outputs={})


class Select:
    """``with fluid.Select() as select:`` + ``select.case(...)`` /
    ``select.default()`` (reference ``concurrency.py:79,193``).

    Each case body is captured into its own sub-block
    (``case_block_<i>`` attr); the select op probes the cases and runs
    exactly one body (csp_ops.select_lower)."""

    DEFAULT, SEND, RECEIVE = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("select", name=name)
        self._cases = []        # serialized "idx,action,ch,val"
        self._case_blocks = {}  # idx -> Block
        self._channels = []
        self._values = []

    def __enter__(self):
        self._program = self.helper.main_program
        self._parent = self._program.current_block()
        return self

    def _case_guard(self, action, channel=None, value=None):
        select = self
        idx = len(select._cases)

        class _CaseGuard:
            def __enter__(self_):
                self_._sub = select._program.create_block()
                return self_

            def __exit__(self_, exc_type, exc_val, exc_tb):
                if exc_type is not None:
                    return False
                select._program.rollback()
                ch_name = channel.name if channel is not None else ""
                val_name = value.name if value is not None else ""
                select._cases.append(f"{idx},{action},{ch_name},{val_name}")
                select._case_blocks[idx] = self_._sub
                if channel is not None:
                    select._channels.append(channel)
                if value is not None:
                    select._values.append(value)
                return True

        return _CaseGuard()

    def case(self, channel_action_fn, channel, value, is_copy=False):
        if channel_action_fn is channel_send:
            x = value
            if is_copy:
                copied = self.helper.create_tmp_variable(dtype=value.dtype)
                self.helper.append_op(type="assign", inputs={"X": [value]},
                                      outputs={"Out": [copied]})
                x = copied
            return self._case_guard(self.SEND, channel, x)
        if channel_action_fn is channel_recv:
            return self._case_guard(self.RECEIVE, channel, value)
        raise ValueError("case() needs channel_send or channel_recv")

    def default(self):
        return self._case_guard(self.DEFAULT)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        # inputs: channels + sent values + everything the case bodies read
        ext = set()
        for blk in self._case_blocks.values():
            ext.update(_external_reads(blk))
        outs = set()
        for blk in self._case_blocks.values():
            for op in blk.ops:
                outs.update(n for n in op.output_arg_names
                            if self._parent.has_var(n))
        # recv targets are written by the select op itself
        for c in self._cases:
            parts = c.split(",")
            if int(parts[1]) == self.RECEIVE and parts[3]:
                outs.add(parts[3])
        attrs = {"cases": list(self._cases)}
        for idx, blk in self._case_blocks.items():
            attrs[f"case_block_{idx}"] = blk
        self._parent.append_op(
            type="select",
            inputs={"X": sorted(ext),
                    "case_to_execute": []},
            outputs={"Out": sorted(outs)},
            attrs=attrs)
        return True
