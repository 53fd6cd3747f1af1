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
        "chip_smoke.py", "profile_torch_decode.py", "profile_torch_train.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def test_every_port_module_imports_with_jax_blocked():
    modules = _port_modules()
    assert "paddle_tpu_torch.kernels.paged_decode" in modules
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
