"""Program visualization: GraphViz DOT rendering + pseudo-code pretty
printing (the port's copy of ``paddle_tpu.analysis.visualize``;
reference ``python/paddle/fluid/debuger.py`` + ``graphviz.py`` +
``net_drawer.py``).  Text only: no graphviz binary is needed.

:func:`program_dot` renders a whole Program — every block as a
clustered subgraph, ops as boxes, vars as ellipses, gradients
highlighted — annotated with the analysis facts the repo already
computes: each op's ``creation_site`` as a node tooltip, and the
donation plan (``memory_optimization_transpiler.plan_donation``
attaches ``program._donation_plan``) as per-var feed-donation /
in-place-update decorations.  Exposed as ``python -m paddle_tpu_torch lint <model>
--dot out.dot`` — render with any dot tool; no binary needed to
produce the file.
"""

from __future__ import annotations

__all__ = ["program_dot", "draw_block_graphviz", "pprint_program_codes",
           "pprint_block_codes"]

from paddle_tpu_torch.ops.registry import GRAD_SUFFIX


def _var_label(block, name):
    try:
        v = block.var(name)
        shape = "x".join(str(d) for d in (v.shape or ())) or "?"
        return f"{name}\\n{v.dtype}[{shape}]"
    except KeyError:
        return name


def _esc(text):
    return str(text).replace("\\", "\\\\").replace('"', '\\"')


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Write a .dot graph of one block (reference ``debuger.py``
    draw_block_graphviz).  Returns the dot source text."""
    highlights = set(highlights or ())
    lines = ["digraph G {", "  rankdir=TB;"]
    _emit_block(lines, block, highlights, donation=None, cluster=False)
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def _emit_block(lines, block, highlights, donation, cluster=True,
                indent="  "):
    """One block's nodes/edges; sub-block attrs recurse as nested
    clusters (control-flow ops own their body blocks)."""
    from paddle_tpu_torch import framework
    donated_feeds = set()
    inplace = {}
    if donation:
        donated_feeds = set(donation.get("donatable_feeds") or ())
        inplace = donation.get("inplace_updates") or {}
    seen_vars = set()
    prefix = f"b{block.idx}_"

    def var_node(name):
        nid = (prefix + f"var_{name}").replace(".", "_") \
            .replace("@", "_AT_")
        if name not in seen_vars:
            seen_vars.add(name)
            color = "orange" if name.endswith(GRAD_SUFFIX) else \
                ("red" if name in highlights else "lightblue")
            label = _var_label(block, name)
            extra = ""
            if name in donated_feeds:
                label += "\\n[donated feed]"
                extra = ", peripheries=2"
            elif name in inplace:
                upd = inplace[name]
                label += (f"\\n[in-place @ op {upd['op_index']} "
                          f"{upd['op_type']}]")
                extra = ", peripheries=2"
            lines.append(
                f'{indent}"{nid}" [label="{label}", '
                f'shape=ellipse, style=filled, fillcolor={color}'
                f'{extra}];')
        return nid

    for i, op in enumerate(block.ops):
        op_id = f"{prefix}op_{i}_{op.type}"
        tooltip = ""
        site = getattr(op, "creation_site", None)
        if site:
            tooltip = f', tooltip="{_esc(site[0])}:{site[1]}"'
        lines.append(f'{indent}"{op_id}" [label="{op.type}", shape=box, '
                     f'style=filled, fillcolor=palegreen{tooltip}];')
        for n in op.input_arg_names:
            if n:
                lines.append(f'{indent}"{var_node(n)}" -> "{op_id}";')
        for n in op.output_arg_names:
            if n:
                lines.append(f'{indent}"{op_id}" -> "{var_node(n)}";')
        for key, attr in sorted(op.attrs.items()):
            if isinstance(attr, framework.Block):
                lines.append(f'{indent}subgraph cluster_b{attr.idx} {{')
                lines.append(f'{indent}  label="block {attr.idx} '
                             f'({op.type}.{key})"; style=dashed;')
                _emit_block(lines, attr, highlights, donation=None,
                            indent=indent + "  ")
                lines.append(f"{indent}}}")
                lines.append(f'{indent}"{op_id}" -> '
                             f'"b{attr.idx}_anchor" [style=dotted];')
    if cluster:
        # an invisible anchor lets a parent op point at this cluster
        lines.append(f'{indent}"{prefix[:-1]}_anchor" '
                     f'[shape=point, style=invis];')


def program_dot(program, highlights=None, path=None):
    """DOT source of a whole Program: the global block at top level,
    every sub-block as a dashed cluster under its owning control-flow
    op, donation-plan annotations when the program was planned
    (``plan_donation``), and op ``creation_site`` tooltips.  Writes to
    ``path`` when given; returns the text either way."""
    plan = getattr(program, "_donation_plan", None)
    donation = plan.to_dict() if plan is not None else None
    lines = ["digraph Program {", "  rankdir=TB;",
             # the JAX package's title: both render the same IR alike
             '  labelloc=t; label="paddle_tpu Program";']
    if donation and donation.get("dropped"):
        notes = "\\n".join(
            f"{d['var']}: {d['reason']}"
            for d in donation["dropped"][:8])
        lines.append(f'  "donation_dropped" [shape=note, '
                     f'label="not donatable:\\n{_esc(notes)}"];')
    _emit_block(lines, program.global_block(), set(highlights or ()),
                donation=donation, cluster=False)
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def pprint_block_codes(block, show_backward=True):
    """Pseudo-code rendering of one block (reference ``debuger.py``
    pprint_block_codes)."""
    out = []
    for op in block.ops:
        if not show_backward and op.type.endswith("_grad"):
            continue
        outs = ", ".join(n for ns in op.outputs.values() for n in ns if n)
        ins = ", ".join(n for ns in op.inputs.values() for n in ns if n)
        attrs = ", ".join(
            f"{k}={v!r}" for k, v in sorted(op.attrs.items())
            if not hasattr(v, "ops"))  # skip sub-blocks
        call = f"{op.type}({ins}"
        if attrs:
            call += f", {attrs}"
        call += ")"
        out.append(f"{outs or '_'} = {call}" if outs else call)
    return "\n".join(out)


def pprint_program_codes(program, show_backward=True):
    chunks = []
    for blk in program.blocks:
        chunks.append(f"# block {blk.idx}")
        chunks.append(pprint_block_codes(blk, show_backward))
    return "\n".join(chunks)
