"""The port's CSP layer (``channel.py``, ``ops/csp_ops.py``,
``concurrency.py``) against the JAX package, mirroring the 14 tests of
``tests/test_concurrency.py``: the channel semantics of the reference's
``channel_test.cc`` on ``paddle_tpu_torch.channel.Channel``, then the Go
routine, daisy chain, buffered select and fibonacci programs through the
port's ``Executor`` on the CPU.  Then parity: the same CSP programs
built by each package give equal IR dicts and equal fetches; a ``go``
body runs device ops on a tensor it received through a channel; a block
with CSP ops stays out of a CUDA graph; a failing routine fails the
run."""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as torch_executor
from chip_smoke import (csp_daisy_chain as daisy_chain,
                        csp_device_routine as device_routine,
                        csp_fibonacci as fibonacci, csp_run as run_program,
                        csp_select_buffered_send as select_buffered_send,
                        csp_simple_routine as simple_routine)
from chip_smoke import _csp_var as _var
from paddle_tpu_torch.channel import Channel, ChannelClosedError



# ===========================================================================
# Part 1: channel semantics (channel_test.cc ports)
# ===========================================================================

class TestChannelSemantics:
    def test_capacity(self):
        assert Channel(capacity=10).cap() == 10
        assert Channel().cap() == 0

    def test_sufficient_buffer_doesnt_block(self):
        ch = Channel(capacity=10)
        for i in range(10):
            ch.send(i)
        for i in range(10):
            v, ok = ch.receive()
            assert ok and v == i

    def test_send_on_closed_buffered_panics(self):
        ch = Channel(capacity=1)
        ch.send(1)
        ch.close()
        with pytest.raises(ChannelClosedError):
            ch.send(2)

    def test_send_on_closed_unbuffered_panics(self):
        ch = Channel()
        ch.close()
        with pytest.raises(ChannelClosedError):
            ch.send(1)

    def test_residual_values_after_close(self):
        ch = Channel(capacity=10)
        for i in range(10):
            ch.send(i)
        ch.close()
        for i in range(10):
            v, ok = ch.receive()
            assert ok and v == i
        for _ in range(2):
            _, ok = ch.receive()
            assert not ok

    def test_unbuffered_order_matches_send_order(self):
        ch = Channel()
        got = []
        t = threading.Thread(target=lambda: [ch.send(i) for i in range(20)])
        t.start()
        for _ in range(20):
            v, ok = ch.receive()
            assert ok
            got.append(v)
        t.join(timeout=5)
        assert not t.is_alive() and got == list(range(20))

    def test_buffered_order_matches_send_order(self):
        ch = Channel(capacity=3)
        got = []
        t = threading.Thread(target=lambda: [ch.send(i) for i in range(50)])
        t.start()
        for _ in range(50):
            v, ok = ch.receive()
            assert ok
            got.append(v)
        t.join(timeout=5)
        assert not t.is_alive() and got == list(range(50))

    def test_close_unblocks_receivers(self):
        for cap in (0, 3):
            ch = Channel(capacity=cap)
            ended = [False] * 4

            def recv(i):
                _, ok = ch.receive()
                assert not ok
                ended[i] = True

            threads = [threading.Thread(target=recv, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.05)
            assert not any(ended)
            ch.close()
            for t in threads:
                t.join(timeout=5)
            assert all(ended)

    def test_close_unblocks_senders(self):
        for cap in (0, 2):
            ch = Channel(capacity=cap)
            for i in range(cap):
                ch.send(i)
            results = [None] * 4

            def send(i):
                try:
                    ch.send(i)
                    results[i] = "sent"
                except ChannelClosedError:
                    results[i] = "closed"

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.05)
            assert all(r is None for r in results)
            ch.close()
            for t in threads:
                t.join(timeout=5)
            assert all(r == "closed" for r in results)

    def test_unbuffered_less_receive_more_send(self):
        ch = Channel()
        sent = []

        def sender():
            for i in range(4):
                try:
                    ch.send(i)
                    sent.append(i)
                except ChannelClosedError:
                    return

        t = threading.Thread(target=sender)
        t.start()
        for i in range(3):
            v, ok = ch.receive()
            assert ok and v == i
        time.sleep(0.05)
        assert sent == [0, 1, 2]
        ch.close()
        t.join(timeout=5)
        assert not t.is_alive()

    def test_concurrent_send_sufficient_buffer(self):
        ch = Channel(capacity=10)
        threads = [threading.Thread(target=ch.send, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=5)
        assert sorted(ch.receive()[0] for _ in range(10)) == list(range(10))


# ===========================================================================
# Part 2: the IR-level flows, built by either package
# ===========================================================================

FLOWS = {"simple_routine": (simple_routine, 1234),
         "daisy_chain": (daisy_chain, 21),
         "select_buffered_send": (select_buffered_send, 10),
         "fibonacci": (fibonacci, 34)}


class TestRoutineOp:
    def test_simple_routine(self):
        (out,), _ = run_program(pt, simple_routine)
        assert float(out.reshape(-1)[0]) == 1234

    def test_daisy_chain(self):
        (out,), _ = run_program(pt, daisy_chain)
        assert int(out.reshape(-1)[0]) == 21

    def test_select_buffered_send(self):
        (out,), _ = run_program(pt, select_buffered_send)
        assert float(out.reshape(-1)[0]) == 10

    def test_fibonacci(self):
        (out,), _ = run_program(pt, fibonacci)
        assert int(out.reshape(-1)[0]) == 34


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_matches_reference(name):
    """Equal IR dicts (names from one counter state) and equal fetches."""
    from paddle_tpu.framework import unique_name_scope as jax_names
    from paddle_tpu_torch.framework import unique_name_scope as torch_names
    build, want = FLOWS[name]
    results = {}
    for pkg, names in ((fluid, jax_names), (pt, torch_names)):
        with names("csp_"):
            results[pkg] = run_program(pkg, build)
    (jout,), jmain = results[fluid]
    (tout,), tmain = results[pt]
    assert _strip(tmain.to_dict()) == _strip(jmain.to_dict())
    np.testing.assert_array_equal(tout.reshape(-1), jout.reshape(-1))
    assert float(tout.reshape(-1)[0]) == want


def test_device_ops_in_a_routine():
    (out,), _ = run_program(pt, device_routine)
    np.testing.assert_array_equal(out, np.full((2, 3), 4.5, np.float32))
    (ref,), _ = run_program(fluid, device_routine)
    np.testing.assert_array_equal(out, ref)


def test_csp_block_stays_eager():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        fibonacci(pt)
    assert torch_executor._has_host_ops(main.global_block())
    assert {"go", "select", "channel_send", "channel_recv",
            "channel_create", "channel_close"} <= set(
        torch_executor._host_ops(main.global_block()))


def test_failing_routine_fails_the_run():
    """An op that raises inside a ``go`` body closes the routine's
    channels (the block's receive returns) and fails the run."""
    def build(pkg):
        L = pkg.layers
        ch_in = pkg.make_channel(dtype="float32", capacity=1)
        ch = pkg.make_channel(dtype="float32")
        with pkg.Go():
            got, _ = pkg.channel_recv(ch_in, _var(pkg, "got", "float32"))
            # [2] + [3]: raises at run time
            pkg.channel_send(ch, L.elementwise_add(got, L.fill_constant(
                shape=[3], dtype="float32", value=1.0)))
        pkg.channel_send(ch_in, L.fill_constant(shape=[2], dtype="float32",
                                                value=1.0))
        out, _ = pkg.channel_recv(ch, _var(pkg, "out", "float32"))
        return [out]
    with pytest.raises(RuntimeError, match="go routine"):
        run_program(pt, build)


def test_cuda_place_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        run_program(pt, simple_routine, place=pt.CUDAPlace(0))
