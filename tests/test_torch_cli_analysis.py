"""The port's ``lint`` and ``opt`` commands against the JAX package's:
``--zoo M --json`` prints the same diagnostics and the same per-pass
stats for every zoo model (keys and values; a diagnostic's creation site
is a path into each package's own model file, and is left out).  The
multi-program modes and ``selfcheck`` raise, naming where they wait in
ROADMAP queue 1."""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu import cli as jax_cli
from paddle_tpu.models import ZOO_MODELS
from paddle_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the port keeps the grad through ``dropout`` (ROADMAP "In the
#: reference"), so these two train programs differ from the JAX
#: package's by design; their forward programs are the same
DROPOUT_MODELS = ("transformer", "vgg")


def _cases():
    out = []
    for m in ZOO_MODELS:
        out.append((m, "--no-backward"))
        if m not in DROPOUT_MODELS:
            out.append((m, None))
    return out


def _json(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.fixture
def fresh_names(monkeypatch):
    """Each package's CLI builds its own zoo programs: start both name
    counters from zero so the two builds name their variables alike,
    whatever earlier tests in the process built."""
    from paddle_tpu import framework as jax_framework
    from paddle_tpu_torch import framework

    def reset():
        for mod in (jax_framework, framework):
            monkeypatch.setattr(mod, "_name_generator",
                                mod._UniqueNameGenerator())
    return reset


def _no_site(body):
    for t in body["targets"]:
        for d in t.get("diagnostics", ()):
            d.pop("site")
    return body


@pytest.mark.parametrize("case", _cases(),
                         ids=lambda c: f"{c[0]}{'-fwd' if c[1] else ''}")
def test_lint_and_opt_json_match(case, capsys, fresh_names):
    name, flag = case
    argv = ["--zoo", name, "--json"] + ([flag] if flag else [])
    fresh_names()
    jrc, want = _json(jax_cli.main, ["lint"] + argv, capsys)
    fresh_names()
    rc, got = _json(cli.main, ["lint"] + argv, capsys)
    assert rc == jrc == 0
    assert _no_site(got) == _no_site(want)
    fresh_names()
    jrc, want = _json(jax_cli.main, ["opt"] + argv, capsys)
    fresh_names()
    rc, got = _json(cli.main, ["opt"] + argv, capsys)
    assert rc == jrc == 0
    assert got == want
    assert [t["target"] for t in got["targets"]] == [name, f"{name}/startup"]


@pytest.mark.parametrize("name", DROPOUT_MODELS)
def test_port_train_programs_lint_and_optimize_clean(name, capsys):
    rc, body = _json(cli.main, ["lint", "--zoo", name, "--json",
                                "--strict"], capsys)
    assert rc == 0 and body["errors"] == body["warnings"] == 0
    rc, body = _json(cli.main, ["opt", "--zoo", name, "--json"], capsys)
    assert rc == 0
    main = body["targets"][0]
    assert not [p for p in main["passes"] if p["status"] == "aborted"]
    assert main["ops_after"] <= main["ops_before"]


@pytest.mark.parametrize("pkg", ["paddle_tpu", "paddle_tpu_torch"])
def test_python_dash_m_entry_points(pkg):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    outs = {}
    for cmd in ("lint", "opt"):
        out = subprocess.run(
            [sys.executable, "-m", pkg, cmd, "--zoo", "mnist", "--json"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr
        outs[cmd] = json.loads(out.stdout)
    assert outs["lint"]["errors"] == 0
    assert outs["opt"]["targets"][0]["target"] == "mnist"


def test_text_reports(tmp_path, capsys):
    assert cli.main(["lint", "--zoo", "mnist", "--verbose"]) == 0
    assert "lint: 2 program(s): 0 error(s), 0 warning(s)" in \
        capsys.readouterr().out
    assert cli.main(["opt", "--zoo", "mnist", "--passes", "dce,cse"]) == 0
    out = capsys.readouterr().out
    assert "optimization report" in out and "dce" in out
    assert "constant_fold" not in out
    dot = tmp_path / "m.dot"
    assert cli.main(["lint", "--zoo", "mnist", "--dot", str(dot)]) == 0
    assert dot.read_text().startswith("digraph Program {")
    assert cli.main(["lint", "--zoo", "all", "--dot", str(dot)]) == 2
    assert cli.main(["lint"]) == 2
    assert cli.main(["opt", "--zoo", "nope"]) == 2
    assert cli.main(["lint", str(tmp_path / "missing")]) == 2


def test_lint_of_a_saved_model_and_a_gen_bundle(tmp_path, capsys):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import gen_lm
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[4], dtype="float32")
        y = pt.layers.fc(x, 2)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt.io.save_inference_model(str(tmp_path / "m"), ["x"], [y], exe,
                                   main_program=main)
    assert cli.main(["lint", str(tmp_path / "m"), "--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["errors"] == 0
    assert cli.main(["opt", str(tmp_path / "m"), "--json"]) == 0
    capsys.readouterr()
    hp = gen_lm.GenConfig()
    gen_lm.export_gen_model(str(tmp_path / "g"), hp, num_slots=2,
                            place=pt.CPUPlace())
    assert cli.main(["lint", str(tmp_path / "g"), "--json"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert [t["target"] for t in body["targets"]][:2] == ["prefill",
                                                          "decode"]


def test_multi_program_modes_and_selfcheck_raise(tmp_path):
    # --pair came with item 7a (tests/test_torch_analysis_distributed.py):
    # an unloadable pair is a bad target
    assert cli.main(["lint", "--pair", "a", "b"]) == 2
    # --pipeline came with item 7b (tests/test_torch_analysis_distributed.py)
    assert cli.main(["lint", "--zoo", "mnist", "--pipeline", "2"]) == 0
    # the rest of item 10, selfcheck, is the next slice
    with pytest.raises(NotImplementedError, match="rest of ROADMAP queue 1 "
                                                  "item 10"):
        cli.main(["selfcheck"])
