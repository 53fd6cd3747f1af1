"""Generation-bundle checks (the gen-bundle part of
``paddle_tpu.analysis.distributed``): the constant-signature contract
of an exported prefill/decode pair against its ``gen_meta.json``.

``check_gen_bundle`` returns the findings: PTA018 (warning) for a bucket
ladder a request can escape or a declared bucket nothing can reach,
PTA019 (error) for signature drift between the two programs and the
meta.  ``GenPredictor`` raises on the errors at load,
``models.gen_lm.export_gen_model`` after export (``verify_gen_bundle``).
On the port a bucket escape does not recompile (the executor is eager),
but it runs a shape that warmup never built or checked, so the codes and
their messages stay the JAX package's.
"""

from __future__ import annotations

import json
import os

from paddle_tpu_torch.analysis.analyzer import AnalysisResult, lint_program
from paddle_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                   ProgramVerificationError)
from paddle_tpu_torch.framework import Program

__all__ = ["check_gen_bundle", "load_saved_program", "lint_gen_bundle",
           "verify_gen_bundle"]


def _var_meta(block, name):
    """Declared (shape, dtype) of ``name`` or (None, None)."""
    try:
        v = block.var(name)
    except KeyError:
        return None, None
    shape = None if v.shape is None else tuple(int(d) for d in v.shape)
    return shape, v.dtype


def check_gen_bundle(prefill, decode, meta):
    """``prefill``/``decode``: ``(program, feed_names, fetch_names)``;
    ``meta``: the parsed ``gen_meta.json``.  Proves the
    constant-jit-key contract of the pair."""
    def _names(targets):
        return None if targets is None else \
            [getattr(t, "name", t) for t in targets]

    diags = []
    pre_prog, pre_feeds, pre_fetches = prefill
    dec_prog, dec_feeds, dec_fetches = decode
    pre_feeds, pre_fetches = _names(pre_feeds), _names(pre_fetches)
    dec_feeds, dec_fetches = _names(dec_feeds), _names(dec_fetches)
    cache_vars = list(meta.get("cache_vars") or ())
    num_slots = meta.get("num_slots")
    max_len = meta.get("max_len")
    page_len = meta.get("page_len")
    paged = page_len is not None
    num_pages = meta.get("num_pages")
    pt_feed = meta.get("page_table_feed", "gen_page_table")
    pages_per_slot = None
    if paged and max_len is not None and int(page_len) > 0:
        pages_per_slot = -(-int(max_len) // int(page_len))

    # -- PTA018: prompt buckets must be sane and inside the cache ------
    buckets = list(meta.get("prompt_buckets") or ())
    if not buckets:
        diags.append(Diagnostic(
            "PTA018",
            "gen bundle declares no prompt_buckets — every distinct "
            "prompt length compiles a fresh prefill executable",
            program="gen_meta"))
    else:
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            diags.append(Diagnostic(
                "PTA018",
                f"prompt_buckets {buckets} are not strictly "
                f"increasing — row_bucket's edge walk needs sorted "
                f"edges, so lookups past the disorder fall off the "
                f"declared (warmed) ladder", program="gen_meta"))
        if max_len is not None and buckets[-1] > int(max_len):
            diags.append(Diagnostic(
                "PTA018",
                f"largest prompt bucket {buckets[-1]} exceeds the "
                f"cache length {max_len} — the bucket is declared but "
                f"never warmed (warmup skips it), so a prompt landing "
                f"there compiles at request time",
                program="gen_meta"))

    # -- PTA018: page buckets — the paged decode jit-signature ladder --
    if paged:
        pbuckets = list(meta.get("page_buckets") or ())
        if not pbuckets:
            diags.append(Diagnostic(
                "PTA018",
                "paged gen bundle declares no page_buckets — every "
                "distinct live page count compiles a fresh decode "
                "executable", program="gen_meta"))
        else:
            if any(b2 <= b1 for b1, b2 in zip(pbuckets, pbuckets[1:])):
                diags.append(Diagnostic(
                    "PTA018",
                    f"page_buckets {pbuckets} are not strictly "
                    f"increasing — row_bucket's edge walk needs sorted "
                    f"edges, so lookups past the disorder fall off the "
                    f"declared (warmed) ladder", program="gen_meta"))
            if pages_per_slot is not None and \
                    pbuckets[-1] < pages_per_slot:
                diags.append(Diagnostic(
                    "PTA018",
                    f"largest page bucket {pbuckets[-1]} covers only "
                    f"{pbuckets[-1] * int(page_len)} of max_len "
                    f"{max_len} — a slot growing past it escapes the "
                    f"declared (warmed) ladder and compiles at request "
                    f"time", program="gen_meta"))
            if pages_per_slot is not None and \
                    pbuckets[-1] > pages_per_slot:
                diags.append(Diagnostic(
                    "PTA018",
                    f"largest page bucket {pbuckets[-1]} exceeds the "
                    f"per-slot page count {pages_per_slot} — the "
                    f"bucket is declared (and warmed) but no slot can "
                    f"ever reach it", program="gen_meta"))

    # -- PTA019: decode signature must be constant ---------------------
    # (the paged page-table feed is the ONE sanctioned dynamic dim: its
    # width is bucketed by the predictor, so the jit key is the bucket)
    dec_block = dec_prog.global_block()
    for name in dec_feeds or ():
        shape, _ = _var_meta(dec_block, name)
        if paged and name == pt_feed:
            if shape is not None and len(shape) == 2 and \
                    num_slots is not None and shape[0] != int(num_slots):
                diags.append(Diagnostic(
                    "PTA019",
                    f"page-table feed `{name}` is {shape} but must "
                    f"carry one row per slot "
                    f"(num_slots={num_slots})", var=name,
                    program="decode"))
            continue
        if shape is None or any(d < 0 for d in shape):
            diags.append(Diagnostic(
                "PTA019",
                f"decode feed `{name}` has dynamic shape "
                f"{shape} — every decode step must share ONE jit "
                f"signature; admission/eviction would recompile",
                var=name, program="decode"))
    if paged and pt_feed not in (dec_feeds or ()):
        diags.append(Diagnostic(
            "PTA019",
            f"paged gen bundle's decode program does not feed "
            f"`{pt_feed}` — page-bucketed decode cannot address the "
            f"pool", var=pt_feed, program="decode"))
    if paged and num_pages is not None and pages_per_slot is not None \
            and int(num_pages) < pages_per_slot:
        diags.append(Diagnostic(
            "PTA019",
            f"page pool has {num_pages} page(s) but one full-length "
            f"slot needs {pages_per_slot} — a single request hitting "
            f"max_len {max_len} cannot be served", program="gen_meta"))

    # -- PTA019: cache tensors must match the meta geometry ------------
    for name in cache_vars:
        if not dec_block.has_var(name):
            diags.append(Diagnostic(
                "PTA019",
                f"gen_meta names cache var `{name}` but the decode "
                f"program does not declare it", var=name,
                program="decode"))
            continue
        v = dec_block.var(name)
        if not getattr(v, "persistable", False):
            diags.append(Diagnostic(
                "PTA019",
                f"cache var `{name}` is not persistable in the decode "
                f"program — the KV pool would not live across steps",
                var=name, program="decode"))
        shape, _ = _var_meta(dec_block, name)
        if paged:
            if shape is not None and num_pages is not None and \
                    len(shape) >= 2 and \
                    (shape[0] != int(num_pages) or
                     shape[1] != int(page_len)):
                diags.append(Diagnostic(
                    "PTA019",
                    f"cache var `{name}` is {shape} but gen_meta "
                    f"declares [num_pages={num_pages}, "
                    f"page_len={page_len}, ...] — the bundle drifted "
                    f"between export and meta",
                    var=name, program="decode"))
        elif shape is not None and num_slots is not None and \
                max_len is not None and len(shape) >= 2 and \
                (shape[0] != int(num_slots) or shape[1] != int(max_len)):
            diags.append(Diagnostic(
                "PTA019",
                f"cache var `{name}` is {shape} but gen_meta declares "
                f"[num_slots={num_slots}, max_len={max_len}, ...] — "
                f"the bundle drifted between export and meta",
                var=name, program="decode"))

    # -- PTA019: prefill fetch list must seed exactly the cache --------
    if cache_vars and pre_fetches is not None:
        want = 1 + len(cache_vars)  # logits + per-layer K/V
        if len(pre_fetches) != want:
            diags.append(Diagnostic(
                "PTA019",
                f"prefill fetches {len(pre_fetches)} value(s) but the "
                f"decode cache needs {want} (logits + "
                f"{len(cache_vars)} K/V tensors) — the prefill/decode "
                f"signatures drifted", program="prefill"))
        else:
            pre_block = pre_prog.global_block()
            for fetch_name, cache_name in zip(pre_fetches[1:],
                                              cache_vars):
                f_shape, _ = _var_meta(pre_block, fetch_name)
                c_shape, _ = _var_meta(dec_block, cache_name)
                if f_shape is not None and c_shape is not None and \
                        f_shape[-1] > 0 and c_shape[-1] > 0 and \
                        f_shape[-1] != c_shape[-1]:
                    diags.append(Diagnostic(
                        "PTA019",
                        f"prefill K/V fetch `{fetch_name}` has feature "
                        f"dim {f_shape[-1]} but cache `{cache_name}` "
                        f"expects {c_shape[-1]} — seeding the slot "
                        f"would write misshapen rows",
                        var=fetch_name, program="prefill"))
    return diags


def load_saved_program(target):
    """(program, feed_names, fetch_names) from a save_inference_model
    dir (its ``__model__``) or a ``__model__`` json file — the shared
    static loader behind the bundle lint (no params,
    no executor).  Raises the underlying OSError/ValueError/KeyError
    on a malformed target; callers map those to exit code 2."""
    path = os.path.join(target, "__model__") \
        if os.path.isdir(target) else target
    with open(path) as f:
        model = json.load(f)
    return (Program.from_dict(model["program"]),
            model.get("feed_var_names"), model.get("fetch_var_names"))


def lint_gen_bundle(dirname):
    """Multi-program lint of an exported generation bundle
    (``<dirname>/prefill``, ``<dirname>/decode``, ``gen_meta.json``):
    each program through the single-program lint (the structural pass:
    ``analyzer.lint_program``), plus the cross-program PTA018/PTA019
    checks.  Returns a list of
    ``(label, AnalysisResult)`` plus a cross-check AnalysisResult."""
    with open(os.path.join(dirname, "gen_meta.json")) as f:
        meta = json.load(f)
    prefill = load_saved_program(os.path.join(dirname, "prefill"))
    decode = load_saved_program(os.path.join(dirname, "decode"))
    results = [
        ("prefill", lint_program(prefill[0], feed_names=prefill[1],
                                 fetch_names=prefill[2])),
        ("decode", lint_program(decode[0], feed_names=decode[1],
                                fetch_names=decode[2])),
        ("bundle", AnalysisResult(check_gen_bundle(prefill, decode,
                                                   meta))),
    ]
    return results


def verify_gen_bundle(dirname, where="gen.export"):
    """Raising form of :func:`lint_gen_bundle` — the post-export
    self-check ``export_gen_model`` runs, so a drifted bundle fails at
    export, not at the first ``/generate``.  Error-severity findings
    (PTA019 drift) raise; warning-severity recompile hazards (PTA018)
    are logged at warning level — the bundle works, but the operator
    should see the hazard at export time, not in a latency dashboard."""
    import logging

    errors = []
    for label, result in lint_gen_bundle(dirname):
        errors.extend(result.errors)
        for d in result.warnings:
            logging.getLogger(__name__).warning(
                "gen bundle %s: [%s] %s", dirname, label, d.format())
    if errors:
        raise ProgramVerificationError(errors, where=where)
    return errors
