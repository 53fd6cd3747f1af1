"""Detection layers: the SSD pipeline (the port of
``paddle_tpu.layers.detection``; reference
``python/paddle/fluid/layers/detection.py``).  The same functions build
the same programs as the JAX package's, over the port's detection ops
(``paddle_tpu_torch/ops/detection_ops.py``).
"""

from __future__ import annotations

from functools import reduce

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import nn

__all__ = [
    "prior_box", "multi_box_head", "bipartite_match", "target_assign",
    "detection_output", "ssd_loss", "detection_map", "iou_similarity",
    "box_coder", "roi_pool", "scale_sub_region",
]


def iou_similarity(x, y, name=None):
    """IoU matrix between row boxes of ``x`` [N,4] and ``y`` [M,4]."""
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    """Encode/decode target boxes against prior boxes
    (reference ``box_coder_op.h``)."""
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_tmp_variable(dtype=target_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": out},
                     attrs={"code_type": code_type})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              step_w=0.0, step_h=0.0, offset=0.5, name=None):
    """SSD prior boxes for one feature map (reference ``prior_box_op.h``)."""
    helper = LayerHelper("prior_box", **locals())
    dtype = input.dtype
    attrs = {
        "min_sizes": list(min_sizes),
        "aspect_ratios": list(aspect_ratios or []),
        "variances": list(variance),
        "flip": flip,
        "clip": clip,
        "step_w": step_w,
        "step_h": step_h,
        "offset": offset,
    }
    if max_sizes:
        attrs["max_sizes"] = list(max_sizes)
    box = helper.create_tmp_variable(dtype)
    var = helper.create_tmp_variable(dtype)
    helper.append_op(type="prior_box",
                     inputs={"Input": input, "Image": image},
                     outputs={"Boxes": box, "Variances": var}, attrs=attrs)
    box.stop_gradient = True
    var.stop_gradient = True
    return box, var


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (reference ``bipartite_match_op.cc``)."""
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_tmp_variable(dtype="int32")
    match_distance = helper.create_tmp_variable(dtype=dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": dist_matrix},
        attrs={"match_type": match_type, "dist_threshold": dist_threshold},
        outputs={"ColToRowMatchIndices": match_indices,
                 "ColToRowMatchDist": match_distance})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Assign per-prediction targets/weights via match indices
    (reference ``target_assign_op.h``)."""
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    out_weight = helper.create_tmp_variable(dtype="float32")
    inputs = {"X": input, "MatchIndices": matched_indices}
    if negative_indices is not None:
        inputs["NegIndices"] = negative_indices
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": out, "OutWeight": out_weight},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode predictions + multi-class NMS (reference
    ``layers/detection.py:45``).  Output is a LoD tensor [No, 6] of
    [label, confidence, xmin, ymin, xmax, ymax] rows."""
    helper = LayerHelper("detection_output", **locals())
    decoded_box = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                            target_box=loc, code_type="decode_center_size")
    old_shape = scores.shape
    scores2 = nn.reshape(x=scores, shape=(-1, old_shape[-1]))
    scores2 = nn.softmax(scores2)
    scores2 = nn.reshape(x=scores2, shape=old_shape)
    scores2 = nn.transpose(scores2, perm=[0, 2, 1])
    scores2.stop_gradient = True
    nmsed_outs = helper.create_tmp_variable(dtype=decoded_box.dtype)
    helper.append_op(
        type="multiclass_nms",
        inputs={"Scores": scores2, "BBoxes": decoded_box},
        outputs={"Out": nmsed_outs},
        attrs={
            "background_label": background_label,
            "nms_threshold": nms_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "score_threshold": score_threshold,
            "nms_eta": nms_eta,
        })
    nmsed_outs.stop_gradient = True
    return nmsed_outs


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """Streaming VOC mAP (reference ``layers/detection.py:156``)."""
    helper = LayerHelper("detection_map", **locals())

    def _var(dtype):
        return helper.create_tmp_variable(dtype=dtype)

    map_out = _var("float32")
    accum_pos_count_out = out_states[0] if out_states else _var("int32")
    accum_true_pos_out = out_states[1] if out_states else _var("float32")
    accum_false_pos_out = out_states[2] if out_states else _var("float32")

    pos_count = input_states[0] if input_states else None
    true_pos = input_states[1] if input_states else None
    false_pos = input_states[2] if input_states else None

    inputs = {"Label": label, "DetectRes": detect_res}
    for slot, v in (("HasState", has_state), ("PosCount", pos_count),
                    ("TruePos", true_pos), ("FalsePos", false_pos)):
        if v is not None:
            inputs[slot] = v
    helper.append_op(
        type="detection_map", inputs=inputs,
        outputs={
            "MAP": map_out,
            "AccumPosCount": accum_pos_count_out,
            "AccumTruePos": accum_true_pos_out,
            "AccumFalsePos": accum_false_pos_out,
        },
        attrs={
            "overlap_threshold": overlap_threshold,
            "evaluate_difficult": evaluate_difficult,
            "ap_type": ap_version,
            "class_num": class_num,
            "background_label": background_label,
        })
    return map_out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    """Max-pool features inside each ROI (reference ``roi_pool_op.h``)."""
    helper = LayerHelper("roi_pool", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    argmax = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="roi_pool",
                     inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out, "Argmax": argmax},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (reference ``layers/detection.py:349``): match,
    mine hard negatives, assign targets, weighted conf+loc loss."""
    helper = LayerHelper("ssd_loss", **locals())
    if mining_type not in ("max_negative", "hard_example"):
        raise ValueError("mining_type must be max_negative or hard_example")

    num, num_prior, num_class = confidence.shape

    def _to_2d(var):
        return nn.reshape(x=var, shape=[-1, var.shape[-1]])

    # 1. match priors to ground truth
    iou = iou_similarity(x=gt_box, y=prior_box)
    matched_indices, matched_dist = bipartite_match(iou, match_type,
                                                    overlap_threshold)

    # 2. confidence loss for mining
    gt_label_r = nn.reshape(x=gt_label, shape=tuple(gt_label.shape) + (1,))
    gt_label_r.stop_gradient = True
    target_label, _ = target_assign(gt_label_r, matched_indices,
                                    mismatch_value=background_label)
    confidence2 = _to_2d(confidence)
    target_label2 = nn.cast(x=_to_2d(target_label), dtype="int64")
    target_label2.stop_gradient = True
    conf_loss = nn.softmax_with_cross_entropy(confidence2, target_label2)

    # 3. mine hard examples
    conf_loss = nn.reshape(x=conf_loss, shape=(num, num_prior))
    conf_loss.stop_gradient = True
    neg_indices = helper.create_tmp_variable(dtype="int32")
    updated_matched_indices = helper.create_tmp_variable(dtype="int32")
    helper.append_op(
        type="mine_hard_examples",
        inputs={"ClsLoss": conf_loss, "MatchIndices": matched_indices,
                "MatchDist": matched_dist},
        outputs={"NegIndices": neg_indices,
                 "UpdatedMatchIndices": updated_matched_indices},
        attrs={
            "neg_pos_ratio": neg_pos_ratio,
            "neg_dist_threshold": neg_overlap,
            "mining_type": mining_type,
            "sample_size": sample_size,
        })
    neg_indices.stop_gradient = True
    updated_matched_indices.stop_gradient = True

    # 4. assign regression + classification targets
    encoded_bbox = box_coder(prior_box=prior_box,
                             prior_box_var=prior_box_var,
                             target_box=gt_box,
                             code_type="encode_center_size")
    target_bbox, target_loc_weight = target_assign(
        encoded_bbox, updated_matched_indices,
        mismatch_value=background_label)
    target_label, target_conf_weight = target_assign(
        gt_label_r, updated_matched_indices, negative_indices=neg_indices,
        mismatch_value=background_label)

    # 5. weighted losses
    target_label = nn.cast(x=_to_2d(target_label), dtype="int64")
    target_label.stop_gradient = True
    conf_loss = nn.softmax_with_cross_entropy(confidence2, target_label)
    target_conf_weight = _to_2d(target_conf_weight)
    target_conf_weight.stop_gradient = True
    conf_loss = conf_loss * target_conf_weight

    location2 = _to_2d(location)
    target_bbox = _to_2d(target_bbox)
    target_bbox.stop_gradient = True
    loc_loss = nn.smooth_l1(location2, target_bbox)
    target_loc_weight2 = _to_2d(target_loc_weight)
    target_loc_weight2.stop_gradient = True
    loc_loss = loc_loss * target_loc_weight2

    loss = conf_loss * conf_loss_weight + loc_loss * loc_loss_weight
    loss = nn.reshape(x=loss, shape=(-1, num_prior))
    loss = nn.reduce_sum(loss, dim=1, keep_dim=True)
    if normalize:
        normalizer = nn.reduce_sum(target_loc_weight)
        loss = loss / normalizer
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """SSD multi-box head over a list of feature maps (reference
    ``layers/detection.py:567``): per-map prior boxes + conv loc/conf
    predictions, concatenated."""
    helper = LayerHelper("multi_box_head", **locals())

    def _is_seq(v):
        return isinstance(v, (list, tuple))

    num_layer = len(inputs)
    if min_sizes is None:
        # derive sizes from min/max ratio (reference behavior)
        assert num_layer >= 3, "multi_box_head needs min_sizes for <3 inputs"
        min_sizes = []
        max_sizes = []
        step = int((max_ratio - min_ratio) / (num_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    if steps is not None:
        step_w = step_h = steps
    step_w = step_w or [0.0] * num_layer
    step_h = step_h or [0.0] * num_layer

    locs, confs, boxes_list, vars_list = [], [], [], []
    for i, inp in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else None
        if not _is_seq(min_size):
            min_size = [min_size]
        if max_size is not None and not _is_seq(max_size):
            max_size = [max_size]
        ar = aspect_ratios[i]
        if not _is_seq(ar):
            ar = [ar]
        box, var = prior_box(inp, image, min_size, max_size, ar,
                             list(variance), flip, clip,
                             float(step_w[i]), float(step_h[i]), offset)
        boxes_list.append(box)
        vars_list.append(var)
        num_boxes = box.shape[2]

        # location predictions: conv -> [N, H*W*priors, 4]
        mbox_loc = nn.conv2d(input=inp, num_filters=num_boxes * 4,
                             filter_size=kernel_size, padding=pad,
                             stride=stride)
        mbox_loc = nn.transpose(mbox_loc, perm=[0, 2, 3, 1])
        n = mbox_loc.shape[0]
        flat = reduce(lambda a, b: a * b, mbox_loc.shape[1:])
        mbox_loc = nn.reshape(x=mbox_loc, shape=[n, flat // 4, 4])
        locs.append(mbox_loc)

        # confidence predictions: conv -> [N, H*W*priors, C]
        conf = nn.conv2d(input=inp, num_filters=num_boxes * num_classes,
                         filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        flat = reduce(lambda a, b: a * b, conf.shape[1:])
        conf = nn.reshape(x=conf, shape=[n, flat // num_classes, num_classes])
        confs.append(conf)

    mbox_locs = nn.concat(locs, axis=1)
    mbox_confs = nn.concat(confs, axis=1)
    boxes2 = [nn.reshape(x=b, shape=[-1, 4]) for b in boxes_list]
    vars2 = [nn.reshape(x=v, shape=[-1, 4]) for v in vars_list]
    box = nn.concat(boxes2)
    var = nn.concat(vars2)
    box.stop_gradient = True
    var.stop_gradient = True
    return mbox_locs, mbox_confs, box, var


def scale_sub_region(x, indices, value=1.0):
    """Scale a per-sample [C,H,W] sub-region of ``x`` [N,C,H,W] by
    ``value``; ``indices`` [N, 6] holds one-based inclusive
    (c0, c1, h0, h1, w0, w1) ranges (reference
    ``gserver/layers/ScaleSubRegionLayer.cpp:1``)."""
    helper = LayerHelper("scale_sub_region", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="scale_sub_region",
                     inputs={"X": x, "Indices": indices},
                     outputs={"Out": out},
                     attrs={"value": float(value)})
    return out
