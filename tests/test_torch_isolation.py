"""The PyTorch port stands alone: it imports with JAX blocked, neither it
nor ``chip_smoke.py`` imports the JAX package, and its entry points
raise rather than fall back to the CPU when CUDA is absent."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.gen import GenPredictor
from paddle_tpu_torch.models import gen_lm

PKG_DIR = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
ROOT = os.path.dirname(PKG_DIR)


def _port_modules():
    names = ["paddle_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], "paddle_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _port_sources():
    files = [os.path.join(ROOT, n) for n in (
        "chip_smoke.py", "profile_torch_decode.py", "profile_torch_train.py",
        "exp_torch_smalls_attn.py", "exp_torch_resnet_conv.py",
        "exp_torch_bshd_attn.py", "exp_torch_attention_builds.py",
        "exp_torch_top_k.py", "exp_torch_decode_kernels.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def test_every_port_module_imports_with_jax_blocked():
    modules = _port_modules()
    assert "paddle_tpu_torch.kernels.paged_decode" in modules
    for new in ("kernels.smalls_attention", "nets", "analysis.opmeta",
                "ops.logic_ops", "layers.learning_rate_scheduler",
                "kernels.conv3x3", "ops.metric_ops", "models.resnet",
                "models.vgg", "models.mnist", "analysis.flops",
                "kernels.bshd_attention", "selected_rows", "ops.sparse_ops",
                "embedding", "embedding.tables", "models.wide_and_deep",
                "lod", "ops.rnn_ops", "ops.sequence_ops", "layers.sequence",
                "models.stacked_lstm", "ops.control_flow_ops",
                "ops.io_ops", "ops.beam_search_ops", "layers.control_flow",
                "models.seq2seq", "serving", "cli", "profiler",
                "obs.trace", "obs.flight", "obs.prom", "obs.slo",
                "obs.perf", "fault.chaos", "fault.retry", "fleet.sessions",
                "analysis.distributed", "analysis.typecheck",
                "analysis.cost", "analysis.lints", "analysis.visualize",
                "analysis.opt", "analysis.opt.passes",
                "analysis.opt.pipeline", "memory_optimization_transpiler",
                "ops.fused_ops", "ops.detection_ops", "ops.csp_ops",
                "layers.detection", "channel", "concurrency", "native",
                "datapipe", "datapipe.prefetch", "obs.ledger",
                "obs.bench_history", "debuger", "parallel",
                "parallel.mesh", "parallel.distributed",
                "parallel.collective", "parallel.zero",
                "parallel.distribute_transpiler",
                "parallel.parallel_executor", "parallel.ring_attention",
                "ops.collective_ops"):
        assert f"paddle_tpu_torch.{new}" in modules
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(n == 'jax' or n.startswith('jax.')\n"
            "               for n, v in sys.modules.items() if v)\n"
            "print('ok', len(" f"{modules!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{path}:{node.lineno} imports {m}"


def test_gen_predictor_without_a_place_raises_when_cuda_is_absent(
        tmp_path, monkeypatch):
    d = str(tmp_path / "bundle")
    gen_lm.export_gen_model(d, gen_lm.GenConfig(), num_slots=2,
                            place=CPUPlace())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenPredictor(d)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen_lm.export_gen_model(str(tmp_path / "b2"), gen_lm.GenConfig(),
                                num_slots=2)
    # the CPU is used only when asked for
    assert GenPredictor(d, place=CPUPlace()).device.type == "cpu"


def _mlp_bundle(d):
    main, startup = paddle_tpu_torch.Program(), paddle_tpu_torch.Program()
    with paddle_tpu_torch.program_guard(main, startup):
        x = paddle_tpu_torch.layers.data("x", shape=[4], dtype="float32")
        y = paddle_tpu_torch.layers.fc(x, 2)
    exe = paddle_tpu_torch.Executor(CPUPlace())
    scope = paddle_tpu_torch.Scope()
    with paddle_tpu_torch.scope_guard(scope):
        exe.run(startup)
        paddle_tpu_torch.io.save_inference_model(d, ["x"], [y], exe, main)
    return d


def test_serving_entry_points_without_a_place_raise_when_cuda_is_absent(
        tmp_path, monkeypatch):
    from paddle_tpu_torch import cli, serving
    mlp = _mlp_bundle(str(tmp_path / "mlp"))
    gen = str(tmp_path / "gen")
    gen_lm.export_gen_model(gen, gen_lm.GenConfig(), num_slots=2,
                            place=CPUPlace())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for d in (mlp, gen):
        for make in (lambda: serving.InferenceServer(d),
                     lambda: serving.InferenceServer(d, async_load=True),
                     lambda: serving.serve(d, port=0),
                     lambda: cli.main(["serve", "--model", d, "--port",
                                       "0", "--warmup"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.Predictor(mlp)
    # the CPU is used only when asked for
    assert serving.Predictor(mlp, place=CPUPlace()).device.type == "cpu"
    srv = serving.InferenceServer(gen, place=CPUPlace())
    srv.start_background()
    try:
        assert srv.ready and srv.gen_predictor.device.type == "cpu"
    finally:
        srv.shutdown()


@pytest.mark.parametrize("argv,match", [
    (["--master"], "registers"),
    (["--compile-cache", "/nonexistent"], "no XLA compilation cache"),
])
def test_cli_serve_options_the_port_lacks_raise(tmp_path, argv, match):
    """``--compile-cache`` raises (the port has no XLA cache);
    ``serve --master`` on the CPU enrolls the replica with the port's
    master, serves, and on SIGTERM deregisters and exits 0."""
    import signal
    import time

    import numpy as np

    from paddle_tpu_torch import cli, serving
    d = _mlp_bundle(str(tmp_path / "mlp"))
    if match != "registers":
        with pytest.raises(NotImplementedError, match=match):
            cli.main(["serve", "--model", d, "--place", "cpu"] + argv)
        return
    from paddle_tpu_torch.parallel.master import (MasterServer,
                                                  MasterService)
    svc = MasterService(replica_ttl=3.0)
    master = MasterServer(svc, port=0)
    master.start_background()
    maddr = f"{master.addr[0]}:{master.addr[1]}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", "--model", d,
         "--place", "cpu", "--port", "0", "--replica-id", "cli-r0",
         "--lease-ttl", "1.0"] + argv + [maddr],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 60
        while not svc.list_replicas() and time.time() < deadline \
                and proc.poll() is None:
            time.sleep(0.1)
        (rec,) = svc.list_replicas()
        assert rec["id"] == "cli-r0"
        client = serving.ServingClient(rec["addr"])
        (out,) = client.predict({"x": np.ones((3, 4), "float32")})
        assert out.shape == (3, 2)
        time.sleep(1.2)          # past one TTL: the heartbeat renewed it
        assert [r["id"] for r in svc.list_replicas()] == ["cli-r0"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err[-2000:]
        assert "fleet replica cli-r0 serving" in out and "cpu" in out
        assert svc.list_replicas() == []     # drained: deregistered
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        master.shutdown()


def test_weight_norm_param_attr_is_exported_at_the_top():
    """``paddle_tpu_torch.WeightNormParamAttr``, as
    ``paddle_tpu.WeightNormParamAttr``."""
    from paddle_tpu_torch.param_attr import WeightNormParamAttr
    assert paddle_tpu_torch.WeightNormParamAttr is WeightNormParamAttr
    attr = paddle_tpu_torch.WeightNormParamAttr(dim=0, name="w")
    assert isinstance(attr, paddle_tpu_torch.ParamAttr)
    assert attr.dim == 0 and attr.name == "w"



def _native_sources():
    native = os.path.join(PKG_DIR, "native")
    return sorted(os.path.join(native, n) for n in os.listdir(native)
                  if n.endswith(".cpp"))


@pytest.mark.parametrize("path", _native_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_sources_embed_only_the_port(path):
    """The port's C and C++ sources import (``PyImport_ImportModule``) or
    name in a string no module but the port's: no ``paddle_tpu`` module,
    no JAX."""
    import re
    with open(path) as f:
        src = f.read()
    assert not re.findall(r'"(jax[\w.]*)', src), path
    imported = re.findall(r'PyImport_\w+\(\s*"([^"]+)"', src)
    for module in imported:
        assert module.split(".")[0] == "paddle_tpu_torch", (path, module)
    for name in re.findall(r'"(paddle_tpu[\w.]*)', src):
        assert name.split(".")[0] == "paddle_tpu_torch", (path, name)
    if path.endswith("capi.cpp"):
        assert imported == ["paddle_tpu_torch.serving"]


def test_parallel_entry_points_without_a_place_raise_when_cuda_is_absent(
        monkeypatch):
    """``init_parallel_env`` forms an NCCL world on the card unless given
    ``CPUPlace()``; without CUDA it raises, and no process group forms.
    A mesh needs a world."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("PADDLE_TRAINERS", "TRAINERS", "WORLD_SIZE",
                "PADDLE_INIT_NUM_GRADIENT_SERVERS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.init_parallel_env()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        parallel.make_mesh()
    assert parallel.get_world_size() == 1 and parallel.get_rank() == 0


def test_csp_and_detection_modules_are_the_ports():
    """The CSP and detection surfaces are the port's own, at the
    package root as in the JAX package."""
    from paddle_tpu_torch import channel, concurrency, evaluator, layers
    assert paddle_tpu_torch.Go is concurrency.Go
    assert paddle_tpu_torch.CSPChannel is channel.Channel
    assert layers.ssd_loss is layers.detection.ssd_loss
    assert evaluator.DetectionMAP.__module__ == "paddle_tpu_torch.evaluator"
    assert paddle_tpu_torch.native.load_capi.__module__ == \
        "paddle_tpu_torch.native"
