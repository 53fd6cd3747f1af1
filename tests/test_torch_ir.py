"""The PyTorch port builds the same Program IR as the JAX package: the
prefill, paged-decode and dense-decode programs of the generative LM
(and their startup programs) serialize to equal ``to_dict()`` dicts,
ignoring only each op's ``creation_site`` (the file that built it)."""

import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu.models.gen_lm_long import GenLongConfig as JaxLong
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import gen_lm as torch_gen_lm
from paddle_tpu_torch.models.gen_lm_long import GenLongConfig as TorchLong


def _strip(d):
    """Program dict without the ops' ``creation_site``."""
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, make):
    main, startup = pkg.Program(), pkg.Program()
    with names("ir_"), pkg.program_guard(main, startup):
        feeds, fetches = make()
    return (_strip(main.to_dict()), _strip(startup.to_dict()), feeds,
            [v.name for v in fetches])


def _program_fns(mod, hp):
    return {
        "prefill": lambda: mod.build_prefill_program(hp),
        "paged_decode": lambda: mod.build_paged_decode_program(
            hp, 8, 16, 8 * (-(-hp.max_len // 16))),
        "dense_decode": lambda: mod.build_decode_program(hp, 4),
    }


@pytest.mark.parametrize("config", ["GenConfig", "GenLongConfig"])
@pytest.mark.parametrize("program", ["prefill", "paged_decode",
                                     "dense_decode"])
def test_programs_match_reference_ir(config, program):
    jax_hp = jax_gen_lm.GenConfig() if config == "GenConfig" else JaxLong()
    torch_hp = torch_gen_lm.GenConfig() if config == "GenConfig" \
        else TorchLong()
    want = _build(fluid, jax_names,
                  _program_fns(jax_gen_lm, jax_hp)[program])
    got = _build(pt, torch_names,
                 _program_fns(torch_gen_lm, torch_hp)[program])
    assert got[2:] == want[2:]          # feed and fetch names
    assert got[0] == want[0]            # main program
    assert got[1] == want[1]            # startup program


def test_ir_round_trips_across_packages():
    """A dict built by either package loads in the other and serializes
    back unchanged (bundles carry exactly this dict)."""
    hp = TorchLong()
    main, _, _, _ = _build(pt, torch_names,
                           _program_fns(torch_gen_lm, hp)["paged_decode"])
    via_jax = fluid.Program.from_dict(main).to_dict()
    back = pt.Program.from_dict(via_jax).to_dict()
    assert _strip(via_jax) == main
    assert _strip(back) == main
