"""The port's detection ops and layers against the JAX package, on the
CPU, mirroring ``tests/test_detection.py``.

Each of the ten op types runs ``chip_smoke.detection_op_cases()`` (the
card's sweep runs the same cases) in both packages on the same seeded
numpy inputs: float outputs within ``atol = rtol = 1e-5``, integer
outputs equal; the grads of ``roi_pool`` and ``scale_sub_region``
likewise.  Every class of ``tests/test_detection.py`` is mirrored on the
port.  Then a cut-down MobileNet-SSD (``chip_smoke.mobilenet_ssd`` at 64
x 64, widths / 8, six maps) built by each package: equal IR dicts, the
JAX startup's state moved across, two RMSProp steps with losses and
grads within ``SSD_TOL``, then the test program's detections and
``DetectionMAP`` equal."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from chip_smoke import (_fam_forward, _fam_named, detection_op_cases,
                        ssd_batches, ssd_programs, voc_map_recount)
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from test_torch_ops import _grad_program_dict, _op_dict

TOL = 1e-5
#: the cut-down SSD's two steps: float32 convolutions and batch norms
#: summed in other orders through 27 conv layers
SSD_TOL = 1e-4
SSD_SMALL = dict(image=64, classes=5, scale=0.125, batch=3, lr=0.001,
                 boundaries=(40000, 60000), l2=5e-5, nms_threshold=0.45,
                 max_boxes=3, difficult=0.2)
PKGS = {fluid: jax_names, pt: torch_names}


def _run_jax(case):
    _, op_type, inputs, out_slots, attrs, lods = case
    d = _op_dict(op_type, inputs, out_slots, attrs)
    prog = fluid.Program.from_dict(d)
    block = prog.global_block()
    env = {n: jnp.asarray(a) for n, a in _fam_named(inputs).items()}
    op = block.ops[0]
    jax_registry.run_lowering(
        op, env, block, rng_key=None, training=False,
        aux={"lod": {f"in_{s}": lod for s, lod in lods.items()}})
    return {n: np.asarray(env[n]) for n in op.output_arg_names}


@pytest.mark.parametrize("case", detection_op_cases(), ids=lambda c: c[0])
def test_detection_op_matches_reference(case):
    want = _run_jax(case)
    got = _fam_forward(pt, case, torch.device("cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_every_detection_op_has_a_case():
    from paddle_tpu_torch.ops import detection_ops
    ported = {t for t, d in pt.ops.registry.all_ops().items()
              if d.lower is not None and d.lower.__module__ ==
              detection_ops.__name__}
    assert len(ported) == 10
    assert ported == {c[1] for c in detection_op_cases()}


@pytest.mark.parametrize("case", [c for c in detection_op_cases()
                                  if c[1] in ("roi_pool",
                                              "scale_sub_region")],
                         ids=lambda c: c[0])
def test_detection_grad_matches_reference(case):
    _, op_type, inputs, out_slots, attrs, _ = case
    d = _grad_program_dict(op_type, inputs, out_slots, attrs)
    out_shape = _run_jax(case)[f"out_{out_slots[0]}"].shape
    feed = _fam_named(inputs)
    feed["cot"] = np.random.RandomState(5).randn(*out_shape).astype(
        np.float32)
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        grads = sorted(n for n in prog.global_block().vars
                       if n.startswith("in_") and n.endswith("@GRAD"))
        vals = pkg.Executor(pkg.CPUPlace()).run(
            prog, feed=feed, fetch_list=grads, scope=pkg.Scope())
        results.append(dict(zip(grads, [np.asarray(v) for v in vals])))
    want, got = results
    assert set(got) == set(want) == {"in_X@GRAD"}
    np.testing.assert_allclose(got["in_X@GRAD"], want["in_X@GRAD"],
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# tests/test_detection.py, on the port
# ---------------------------------------------------------------------------

def _np_iou(a, b):
    n, m = a.shape[0], b.shape[0]
    out = np.zeros((n, m), np.float32)
    for i in range(n):
        for j in range(m):
            iw = max(min(a[i, 2], b[j, 2]) - max(a[i, 0], b[j, 0]), 0.0)
            ih = max(min(a[i, 3], b[j, 3]) - max(a[i, 1], b[j, 1]), 0.0)
            inter = iw * ih
            union = ((a[i, 2] - a[i, 0]) * (a[i, 3] - a[i, 1]) +
                     (b[j, 2] - b[j, 0]) * (b[j, 3] - b[j, 1]) - inter)
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def _rand_boxes(rng, n):
    x1 = rng.rand(n) * 0.5
    y1 = rng.rand(n) * 0.5
    x2 = x1 + rng.rand(n) * 0.5
    y2 = y1 + rng.rand(n) * 0.5
    return np.stack([x1, y1, x2, y2], axis=1).astype("float32")


def _data(name, shape, dtype="float32", lod_level=0):
    return pt.layers.data(name=name, shape=list(shape), dtype=dtype,
                          append_batch_size=False, lod_level=lod_level)


def _run_port(build, feed):
    """``build() -> fetch list`` in fresh port programs, run once on the
    CPU."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        fetch = build()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def test_iou_similarity_matches_numpy():
    rng = np.random.RandomState(0)
    a, b = _rand_boxes(rng, 5), _rand_boxes(rng, 7)
    (got,) = _run_port(lambda: [pt.layers.iou_similarity(
        x=_data("x", a.shape), y=_data("y", b.shape))], {"x": a, "y": b})
    np.testing.assert_allclose(got, _np_iou(a, b), rtol=1e-5, atol=1e-6)


def test_box_coder_encode_decode_roundtrip():
    rng = np.random.RandomState(1)
    prior = _rand_boxes(rng, 6)
    pvar = rng.rand(6, 4).astype("float32") * 0.3 + 0.1
    target = _rand_boxes(rng, 3)

    def build():
        pb, pv, tb = (_data(n, s) for n, s in (("pb", prior.shape),
                                                ("pv", pvar.shape),
                                                ("tb", target.shape)))
        enc = pt.layers.box_coder(prior_box=pb, prior_box_var=pv,
                                  target_box=tb,
                                  code_type="encode_center_size")
        return [enc, pt.layers.box_coder(prior_box=pb, prior_box_var=pv,
                                         target_box=enc,
                                         code_type="decode_center_size")]
    enc, dec = _run_port(build, {"pb": prior, "pv": pvar, "tb": target})
    assert enc.shape == (3, 6, 4)
    for j in range(6):
        np.testing.assert_allclose(dec[:, j, :], target, rtol=1e-4,
                                   atol=1e-5)


def test_prior_box_shapes_and_values():
    feat = np.zeros((1, 8, 2, 2), np.float32)
    img = np.zeros((1, 3, 8, 8), np.float32)
    b, v = _run_port(lambda: list(pt.layers.prior_box(
        _data("feat", feat.shape), _data("img", img.shape),
        min_sizes=[4.0], max_sizes=[8.0], aspect_ratios=[2.0], flip=True,
        clip=True)), {"feat": feat, "img": img})
    assert b.shape == v.shape == (2, 2, 4, 4)
    np.testing.assert_allclose(v[0, 0, 0], [0.1, 0.1, 0.2, 0.2], rtol=1e-6)
    c = 0.5 * (8 / 2)
    np.testing.assert_allclose(b[0, 0, 0], [(c - 2) / 8, (c - 2) / 8,
                                            (c + 2) / 8, (c + 2) / 8],
                               rtol=1e-5)
    assert b.min() >= 0.0 and b.max() <= 1.0


def _np_bipartite(dist):
    """The reference's greedy ``BipartiteMatch`` (bipartite_match_op.cc)."""
    row, col = dist.shape
    match_idx = np.full(col, -1, np.int32)
    match_dist = np.zeros(col, np.float32)
    row_pool = list(range(row))
    while row_pool:
        max_idx = max_row = -1
        max_d = -1.0
        for j in range(col):
            if match_idx[j] != -1:
                continue
            for m in row_pool:
                if dist[m, j] < 1e-6:
                    continue
                if dist[m, j] > max_d:
                    max_idx, max_row, max_d = j, m, dist[m, j]
        if max_idx == -1:
            break
        match_idx[max_idx] = max_row
        match_dist[max_idx] = max_d
        row_pool.remove(max_row)
    return match_idx, match_dist


def test_bipartite_match_vs_reference_greedy():
    rng = np.random.RandomState(3)
    dist = rng.rand(11, 7).astype("float32")
    mi, md = _run_port(lambda: list(pt.layers.bipartite_match(
        _data("d", dist.shape, lod_level=1))), {"d": (dist, [[0, 5, 11]])})
    for i, (lo, hi) in enumerate([(0, 5), (5, 11)]):
        want_idx, want_dist = _np_bipartite(dist[lo:hi])
        np.testing.assert_array_equal(mi[i], want_idx)
        np.testing.assert_allclose(md[i], want_dist, rtol=1e-5)


def test_bipartite_match_per_prediction():
    rng = np.random.RandomState(4)
    dist = rng.rand(4, 10).astype("float32")
    mi, md = _run_port(lambda: list(pt.layers.bipartite_match(
        _data("d", dist.shape), match_type="per_prediction",
        dist_threshold=0.5)), {"d": dist})
    base_idx, _ = _np_bipartite(dist)
    for j in range(10):
        if base_idx[j] != -1:
            assert mi[0, j] == base_idx[j]
        elif dist[:, j].max() >= 0.5:
            assert mi[0, j] == dist[:, j].argmax()
            np.testing.assert_allclose(md[0, j], dist[:, j].max(),
                                       rtol=1e-5)
        else:
            assert mi[0, j] == -1


def test_target_assign_with_lod():
    x = np.arange(6, dtype="float32").reshape(3, 1, 2)
    match = np.array([[0, -1, 1], [-1, 0, -1]], np.int32)
    out, w = _run_port(lambda: list(pt.layers.target_assign(
        _data("x", x.shape, lod_level=1),
        _data("m", match.shape, dtype="int32"), mismatch_value=9)),
        {"x": (x, [[0, 2, 3]]), "m": match})
    np.testing.assert_allclose(out[0, 0], x[0, 0])
    np.testing.assert_allclose(out[0, 1], [9, 9])
    np.testing.assert_allclose(out[0, 2], x[1, 0])
    np.testing.assert_allclose(out[1, 1], x[2, 0])
    np.testing.assert_allclose(w.reshape(2, 3), [[1, 0, 1], [0, 1, 0]])


def test_mine_hard_examples_max_negative():
    cls_loss = np.array([[0.1, 0.9, 0.5, 0.3, 0.7]], np.float32)
    match = np.array([[0, -1, -1, -1, -1]], np.int32)
    match_dist = np.array([[0.8, 0.1, 0.2, 0.3, 0.1]], np.float32)

    def build():
        helper = pt.layer_helper.LayerHelper("mine_hard_examples")
        neg = helper.create_tmp_variable(dtype="int32")
        upd = helper.create_tmp_variable(dtype="int32")
        helper.append_op(
            type="mine_hard_examples",
            inputs={"ClsLoss": _data("cl", cls_loss.shape),
                    "MatchIndices": _data("mi", match.shape, "int32"),
                    "MatchDist": _data("md", match_dist.shape)},
            outputs={"NegIndices": neg, "UpdatedMatchIndices": upd},
            attrs={"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.5,
                   "mining_type": "max_negative", "sample_size": 0})
        return [neg, upd]
    neg, upd = _run_port(build, {"cl": cls_loss, "mi": match,
                                 "md": match_dist})
    assert set(neg[0][neg[0] >= 0].tolist()) == {1, 4}
    np.testing.assert_array_equal(upd, match)


def test_multiclass_nms_suppression():
    bboxes = np.array([[[0.1, 0.1, 0.4, 0.4], [0.11, 0.11, 0.41, 0.41],
                        [0.6, 0.6, 0.9, 0.9]]], np.float32)
    scores = np.array([[[0.1, 0.2, 0.3], [0.9, 0.85, 0.8]]], np.float32)

    def build():
        helper = pt.layer_helper.LayerHelper("multiclass_nms")
        out = helper.create_tmp_variable(dtype="float32")
        helper.append_op(type="multiclass_nms",
                         inputs={"BBoxes": _data("b", bboxes.shape),
                                 "Scores": _data("s", scores.shape)},
                         outputs={"Out": out},
                         attrs={"background_label": 0, "nms_threshold": 0.5,
                                "nms_top_k": 10, "keep_top_k": 10,
                                "score_threshold": 0.01, "nms_eta": 1.0})
        return [out]
    (got,) = _run_port(build, {"b": bboxes, "s": scores})
    assert got.shape == (2, 6)
    assert set(got[:, 0].astype(int).tolist()) == {1}
    np.testing.assert_allclose(sorted(got[:, 1], reverse=True), [0.9, 0.8],
                               rtol=1e-5)


def _roi_pool_case():
    rng = np.random.RandomState(7)
    x = rng.rand(2, 3, 6, 6).astype("float32")
    rois = np.array([[0, 0, 0, 3, 3], [1, 2, 2, 5, 5]], np.int64)
    out = np.zeros((2, 3, 2, 2), np.float32)
    for r, roi in enumerate(rois):
        b, x1, y1, x2, y2 = [int(v) for v in roi]
        rh, rw = max(y2 - y1 + 1, 1), max(x2 - x1 + 1, 1)
        for c in range(3):
            for ph in range(2):
                for pw in range(2):
                    hs = min(max(int(math.floor(ph * rh / 2.)) + y1, 0), 6)
                    he = min(max(int(math.ceil((ph + 1) * rh / 2.)) + y1,
                                 0), 6)
                    ws = min(max(int(math.floor(pw * rw / 2.)) + x1, 0), 6)
                    we = min(max(int(math.ceil((pw + 1) * rw / 2.)) + x1,
                                 0), 6)
                    patch = x[b, c, hs:he, ws:we]
                    out[r, c, ph, pw] = patch.max() if patch.size else 0.0
    return x, rois, out


def _numeric_grad(build, x, cot, delta=5e-3):
    """Central differences of ``sum(build(x) * cot)`` in float64."""
    grad = np.zeros(x.shape, np.float64)
    for i in np.ndindex(*x.shape):
        up, down = x.copy(), x.copy()
        up[i] += delta
        down[i] -= delta
        grad[i] = (np.sum(build(up) * cot) - np.sum(build(down) * cot)) / \
            (2 * delta)
    return grad


def _outs(op_type):
    return ["Out", "Argmax"] if op_type == "roi_pool" else ["Out"]


def _op_grad(op_type, inputs, attrs, cot):
    """The port's input grad of ``sum(op(inputs).Out * cot)``."""
    d = _grad_program_dict(op_type, inputs, _outs(op_type), attrs)
    prog = pt.Program.from_dict(d)
    pt.append_backward(prog.global_block().var("loss"))
    feed = _fam_named(inputs)
    feed["cot"] = cot
    (g,) = pt.Executor(pt.CPUPlace()).run(
        prog, feed=feed, fetch_list=["in_X@GRAD"], scope=pt.Scope())
    return g


def _op_out(op_type, inputs, attrs):
    case = (op_type, op_type, inputs, _outs(op_type), attrs, {})
    return _fam_forward(pt, case, torch.device("cpu"))["out_Out"]


ROI_ATTRS = {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}


def test_roi_pool_forward():
    x, rois, want = _roi_pool_case()
    np.testing.assert_allclose(
        _op_out("roi_pool", {"X": x, "ROIs": rois}, ROI_ATTRS), want,
        rtol=1e-5, atol=1e-6)


def test_roi_pool_grad():
    x, rois, want = _roi_pool_case()
    cot = np.random.RandomState(1).rand(*want.shape).astype(np.float32)
    got = _op_grad("roi_pool", {"X": x, "ROIs": rois}, ROI_ATTRS, cot)
    num = _numeric_grad(lambda v: _op_out(
        "roi_pool", {"X": v, "ROIs": rois}, ROI_ATTRS), x, cot)
    np.testing.assert_allclose(got, num, rtol=0.02, atol=1e-3)


def _detection_map_run(dets, labels, det_lod):
    def build():
        det = _data("det", [6, 6], lod_level=1)
        lab = _data("lab", [4, 6], lod_level=1)
        return [pt.layers.detection_map(det, lab, class_num=3,
                                        overlap_threshold=0.5)]
    return _run_port(build, {"det": (dets, det_lod),
                             "lab": (labels, [[0, 1]])})[0]


def test_detection_map_perfect_detection():
    dets = np.array([[1, 0.9, 0.1, 0.1, 0.4, 0.4]], np.float32)
    labels = np.array([[1, 0, 0.1, 0.1, 0.4, 0.4]], np.float32)
    np.testing.assert_allclose(_detection_map_run(dets, labels, [[0, 1]]),
                               [1.0], atol=1e-6)


def test_detection_map_false_positive_halves_ap():
    labels = np.array([[1, 0, 0.1, 0.1, 0.4, 0.4]], np.float32)
    dets = np.array([[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                     [1, 0.8, 0.6, 0.6, 0.9, 0.9]], np.float32)
    np.testing.assert_allclose(_detection_map_run(dets, labels, [[0, 2]]),
                               [1.0], atol=1e-6)
    flipped = np.array([[1, 0.9, 0.6, 0.6, 0.9, 0.9],
                        [1, 0.8, 0.1, 0.1, 0.4, 0.4]], np.float32)
    np.testing.assert_allclose(
        _detection_map_run(flipped, labels, [[0, 2]]), [0.5], atol=1e-6)


def test_ssd_head_loss_decreases():
    rng = np.random.RandomState(11)
    images = rng.rand(2, 3, 8, 8).astype("float32")
    gt_box = np.array([[0.1, 0.1, 0.45, 0.45], [0.5, 0.5, 0.95, 0.95],
                       [0.2, 0.3, 0.6, 0.7]], np.float32)
    gt_label = np.array([[1], [2], [1]], np.int32)
    lod = [[0, 2, 3]]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = _data("img", [2, 3, 8, 8])
        gb = _data("gb", [3, 4], lod_level=1)
        gl = _data("gl", [3, 1], dtype="int32", lod_level=1)
        feat = pt.layers.conv2d(input=img, num_filters=8, filter_size=3,
                                padding=1, act="relu")
        locs, confs, box, var = pt.layers.multi_box_head(
            inputs=[feat], image=img, base_size=8, num_classes=3,
            aspect_ratios=[[2.0]], min_sizes=[3.0], max_sizes=[6.0],
            flip=True, clip=True)
        avg = pt.layers.reduce_mean(pt.layers.ssd_loss(locs, confs, gb, gl,
                                                       box, var))
        pt.optimizer.SGD(learning_rate=0.05).minimize(avg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"img": images, "gb": (gt_box, lod), "gl": (gt_label, lod)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[avg],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


SSR_IDX = np.array([[1, 2, 1, 3, 2, 4], [2, 4, 2, 5, 1, 6],
                    [3, 3, 1, 1, 1, 1]], np.float32)


def test_scale_sub_region_output():
    x = np.random.RandomState(7).rand(3, 4, 5, 6).astype("float32")
    want = x.copy()
    for n in range(3):
        c0, c1, h0, h1, w0, w1 = SSR_IDX[n].astype(int)
        want[n, c0 - 1:c1, h0 - 1:h1, w0 - 1:w1] *= 2.5
    np.testing.assert_allclose(
        _op_out("scale_sub_region", {"X": x, "Indices": SSR_IDX},
                {"value": 2.5}), want, rtol=1e-6)


def test_scale_sub_region_grad():
    x = np.random.RandomState(7).rand(3, 4, 5, 6).astype("float32")
    cot = np.random.RandomState(2).rand(*x.shape).astype(np.float32)
    got = _op_grad("scale_sub_region", {"X": x, "Indices": SSR_IDX},
                   {"value": 2.5}, cot)
    want = cot.copy()
    for n in range(3):
        c0, c1, h0, h1, w0, w1 = SSR_IDX[n].astype(int)
        want[n, c0 - 1:c1, h0 - 1:h1, w0 - 1:w1] *= 2.5
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# a cut-down MobileNet-SSD in both packages
# ---------------------------------------------------------------------------

def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _ssd(pkg):
    with PKGS[pkg]("ssd_"):
        return ssd_programs(pkg, SSD_SMALL)


@pytest.fixture(scope="module")
def ssd_pair():
    """Both packages' cut-down SSD programs, the JAX startup's state and
    three seeded batches (two to train on, one held out)."""
    jax_progs, torch_progs = _ssd(fluid), _ssd(pt)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jax_progs[1], scope=jscope)
    state = {n: np.asarray(jscope.find_var(n))
             for n in persistable_names(torch_progs[0])}
    return jax_progs, torch_progs, state, ssd_batches(SSD_SMALL, 3, 5)


def test_ssd_programs_equal_the_reference(ssd_pair):
    (jm, js, jt, *_), (tm, ts, tt, *_), _, _ = ssd_pair
    for a, b in ((jm, tm), (js, ts), (jt, tt)):
        assert _strip(b.to_dict()) == _strip(a.to_dict())
    priors = [op for op in tm.global_block().ops if op.type == "prior_box"]
    assert len(priors) == 6


def _f64_program(main):
    """``main`` with every float32 variable and attr float64: the port's
    float64 step, against which each float32 step's own error is read."""
    return pt.Program.from_dict(json.loads(
        json.dumps(main.to_dict()).replace('"float32"', '"float64"')))


def _f64(values):
    if isinstance(values, dict):
        return {k: _f64(v) for k, v in values.items()}
    if isinstance(values, tuple):
        return (_f64(values[0]), values[1])
    return values.astype(np.float64) if values.dtype == np.float32 \
        else values


def _sgd_steps(pkg, main, net, state, feeds, f64=False):
    """``[loss, grads...]`` of one SGD step a feed from ``state``."""
    grads = sorted(op.input("Grad")[0] for op in main.global_block().ops
                   if op.type == "sgd")
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is pt:
        scope = scope_from_numpy(state, pt.CPUPlace(), main)
    else:
        scope = fluid.Scope()
        for n, v in state.items():
            scope.set_var(n, jnp.asarray(v))
    out = []
    with pkg.scope_guard(scope):
        for feed in feeds:
            out.append([np.asarray(v, np.float64) for v in exe.run(
                main, feed=_f64(feed) if f64 else feed,
                fetch_list=[net["loss"].name] + grads)])
    return out, scope


def _f64_bound(want, f64):
    """What a float32 result may differ from ``want`` (the JAX
    package's): twice the JAX package's own distance from the port's
    float64 run, plus ``TOL`` of its norm."""
    return 2 * np.linalg.norm(want - f64) + TOL * np.linalg.norm(want)


def test_ssd_sgd_steps_match(ssd_pair):
    """Two SGD steps of the cut-down SSD from one state (the JAX
    startup's) in both packages and in the port at float64: each step's
    loss and every parameter's grad in the port no farther from the JAX
    package's than twice the JAX package's own distance from the float64
    run (plus ``TOL`` of its norm).  At these widths that distance is
    large: the batch norms over a few values (the 1 x 1 extra maps) and
    the first layers' scale grads, sums that cancel, leave float32
    grads percents from float64 in either package (the first step's
    losses agree to ~1e-6)."""
    batches = ssd_pair[3]
    progs = {pkg: _ssd_sgd(pkg) for pkg in (fluid, pt)}
    main, net = progs[pt][0], progs[pt][3]
    assert _strip(main.to_dict()) == _strip(progs[fluid][0].to_dict())
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(progs[fluid][1], scope=jscope)
    state = {n: np.asarray(jscope.find_var(n))
             for n in persistable_names(main)}
    runs = {pkg: _sgd_steps(pkg, p[0], p[3], state, batches[:2])[0]
            for pkg, p in progs.items()}
    f64 = _sgd_steps(pt, _f64_program(main), net, _f64(state), batches[:2],
                     f64=True)[0]
    for step, (j, t, d) in enumerate(zip(runs[fluid], runs[pt], f64)):
        for i, (gj, gt, gd) in enumerate(zip(j, t, d)):
            assert np.linalg.norm(gt - gj) <= _f64_bound(gj, gd), (step, i)
    np.testing.assert_allclose(runs[pt][0][0], runs[fluid][0][0],
                               rtol=TOL)


def _ssd_sgd(pkg):
    """The cut-down SSD's programs with SGD (1e-4) in place of RMSProp,
    whose first steps scale every grad to about its sign."""
    with PKGS[pkg]("ssd_"):
        main, startup, test, net, nmsed, map_eval = ssd_programs(
            pkg, SSD_SMALL, optimize=False)
        with pkg.program_guard(main, startup):
            pkg.optimizer.SGD(learning_rate=1e-4).minimize(net["loss"])
    return main, startup, test, net, nmsed, map_eval


def test_ssd_detections_and_map_match(ssd_pair):
    """The test program on the held-out batch from one state: the
    detection rows (and their image LoD) and both mAPs equal in the two
    packages, and the streamed mAP equal to
    ``chip_smoke.voc_map_recount``."""
    jax_progs, torch_progs, state, batches = ssd_pair
    results = []
    for pkg, (main, _, test, net, nmsed, map_eval) in (
            (fluid, jax_progs), (pt, torch_progs)):
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is pt:
            scope = scope_from_numpy(state, pt.CPUPlace(), main)
        else:
            scope = fluid.Scope()
            for n, v in state.items():
                scope.set_var(n, jnp.asarray(v))
        with pkg.scope_guard(scope):
            map_eval.reset(exe)
            results.append([np.asarray(v) for v in exe.run(
                test, feed=batches[2], fetch_list=[nmsed] +
                map_eval.metrics)] + [exe])
    (jdets, jcur, jaccum, _), (tdets, tcur, taccum, texe) = results
    assert tdets.shape == jdets.shape and tdets.shape[1] == 6
    np.testing.assert_array_equal(tdets[:, 0], jdets[:, 0])
    np.testing.assert_allclose(tdets, jdets, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tcur, jcur, atol=TOL)
    np.testing.assert_allclose(taccum, jaccum, atol=TOL)
    lod = texe.last_fetch_lods[torch_progs[4].name][0]
    assert lod[-1] == len(tdets) and len(lod) == SSD_SMALL["batch"] + 1
    assert np.float32(voc_map_recount([(batches[2], tdets, lod)])) == \
        taccum.reshape(())


def _two_batch_map(pkg):
    """``DetectionMAP`` over two runs: a hit, then a false positive (one
    ground-truth box each): ``[[cur, accum], [cur, accum]]``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        L = pkg.layers
        det = L.data(name="det", shape=[6], lod_level=1)
        lab = L.data(name="lab", shape=[1], lod_level=1)
        box = L.data(name="box", shape=[4], lod_level=1)
        ev = pkg.evaluator.DetectionMAP(det, lab, box, class_num=3,
                                        overlap_threshold=0.5)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    gt = {"lab": (np.array([[1]], np.float32), [[0, 1]]),
          "box": (np.array([[0.1, 0.1, 0.4, 0.4]], np.float32), [[0, 1]])}
    out = []
    with pkg.scope_guard(scope):
        exe.run(startup)
        ev.reset(exe)
        for d in ([1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.6, 0.6, 0.9, 0.9]):
            feed = dict(gt, det=(np.array([d], np.float32), [[0, 1]]))
            out.append([float(np.asarray(v).reshape(-1)[0])
                        for v in exe.run(main, feed=feed,
                                         fetch_list=ev.metrics)])
    return out


def test_detection_map_streams_across_runs():
    """The port keeps the accumulated positives' LoD in the scope, so the
    second run's streamed mAP counts the first run's hit: precision 1
    then 1/2 at recall 1/2, AP 0.5.  The JAX package seeds LoDs from the
    feeds only: its second run drops the first's positives and keeps
    their count, giving 0 (ROADMAP queue 3, "In the reference")."""
    assert _two_batch_map(pt) == [[1.0, 1.0], [0.0, 0.5]]
    assert _two_batch_map(fluid) == [[1.0, 1.0], [0.0, 0.0]]
