"""Evaluators: streaming metrics kept as IR state (the port of
``paddle_tpu.evaluator``; reference ``python/paddle/fluid/evaluator.py``).

An Evaluator owns persistable state variables that its ops update every
minibatch; ``eval()`` combines the accumulated state read from the
global scope, ``reset()`` zeroes it (a program of ``fill_constant``
ops, as the reference builds)."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.framework import Program, program_guard, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP",
           "CTCErrorEvaluator"]

def _clone_var(block, var):
    return block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                            persistable=True)


def _state_value(var):
    """The first element of a state variable in the global scope, as a
    Python float."""
    from paddle_tpu_torch.scope import global_scope
    return float(to_numpy(global_scope().find_var(var.name)).reshape(-1)[0])


class Evaluator:
    """Base (reference ``evaluator.py:43``): subclasses create state vars
    with ``create_state`` and append their update ops in ``__init__``."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero the accumulator state (reference ``evaluator.py:70``)."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                g_var = _clone_var(reset_program.current_block(), var)
                layers.fill_constant(shape=g_var.shape, value=0.0,
                                     dtype=g_var.dtype, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def create_state(self, suffix, dtype, shape):
        state = self.helper.main_program.current_block().create_var(
            name=unique_name(self.helper.name + "_" + suffix),
            shape=list(shape), dtype=dtype)
        state.persistable = True
        self.states.append(state)
        return state


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (reference ``evaluator.py:115``): the counts of
    inferred, labelled and correct chunks summed over minibatches."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None):
        super().__init__("chunk_eval")
        if self.helper.main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")
        self.num_infer_chunks = self.create_state(
            "num_infer_chunks", "int64", (1,))
        self.num_label_chunks = self.create_state(
            "num_label_chunks", "int64", (1,))
        self.num_correct_chunks = self.create_state(
            "num_correct_chunks", "int64", (1,))
        (precision, recall, f1, num_infer, num_label, num_correct) = \
            layers.chunk_eval(input=input, label=label,
                              chunk_scheme=chunk_scheme,
                              num_chunk_types=num_chunk_types,
                              excluded_chunk_types=excluded_chunk_types)
        layers.sums(input=[self.num_infer_chunks, num_infer],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, num_label],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, num_correct],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program=None):
        num_infer = _state_value(self.num_infer_chunks)
        num_label = _state_value(self.num_label_chunks)
        num_correct = _state_value(self.num_correct_chunks)
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if num_correct else 0.0)
        return np.array([precision]), np.array([recall]), np.array([f1])


class EditDistance(Evaluator):
    """Streaming average edit distance and the share of sequences with a
    nonzero one (reference ``evaluator.py:180``)."""

    def __init__(self, input, label, ignored_tokens=None,
                 normalized=False, name="edit_distance"):
        super().__init__(name)
        self.total_distance = self.create_state(
            "total_distance", "float32", (1,))
        self.seq_num = self.create_state("seq_num", "int64", (1,))
        self.instance_error = self.create_state(
            "instance_error", "int64", (1,))
        helper = self.helper
        dist = helper.create_tmp_variable("float32")
        seq_num = helper.create_tmp_variable("int64")
        helper.append_op(type="edit_distance",
                         inputs={"Hyps": [input], "Refs": [label]},
                         outputs={"Out": [dist], "SequenceNum": [seq_num]},
                         attrs={"normalized": normalized})
        zero = layers.fill_constant(shape=[1], value=0.0, dtype="float32")
        erroneous = helper.create_tmp_variable("int64")
        helper.append_op(type="greater_than",
                         inputs={"X": [dist], "Y": [zero]},
                         outputs={"Out": [erroneous]})
        err_count = layers.reduce_sum(layers.cast(erroneous, "int64"))
        batch_dist = layers.reduce_sum(dist)
        layers.sums(input=[self.total_distance, batch_dist],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        layers.sums(input=[self.instance_error, err_count],
                    out=self.instance_error)
        self.metrics.append(batch_dist)

    def eval(self, executor, eval_program=None):
        total = _state_value(self.total_distance)
        n = _state_value(self.seq_num)
        err = _state_value(self.instance_error)
        return (np.array([total / n if n else 0.0]),
                np.array([err / n if n else 0.0]))


class DetectionMAP(Evaluator):
    """Streaming VOC mAP over the ``detection_map`` op's accumulator state
    (reference ``evaluator.py:258``): ``cur_map`` is the batch's mAP,
    ``accum_map`` the mAP of every batch since ``reset``.  The
    accumulated true and false positives carry a per-class LoD, which
    the executor keeps in the scope between runs."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__("map_eval")
        from paddle_tpu_torch.layers import detection
        if gt_difficult is not None:
            label = layers.concat([gt_label, gt_difficult, gt_box], axis=1)
        else:
            label = layers.concat([gt_label, gt_box], axis=1)
        # batch mAP (stateless)
        self.cur_map = detection.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)
        # streaming mAP through carried accumulators
        self.has_state = self.helper.main_program.current_block().create_var(
            name=unique_name("map_eval_has_state"), dtype="int32",
            shape=(1,))
        self.has_state.persistable = True
        self.states = [self.has_state]
        pos_count = self.create_state("pos_count", "int32", (class_num, 1))
        true_pos = self.create_state("true_pos", "float32", (0, 2))
        false_pos = self.create_state("false_pos", "float32", (0, 2))
        self.accum_map = detection.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult,
            has_state=self.has_state,
            input_states=[pos_count, true_pos, false_pos],
            out_states=[pos_count, true_pos, false_pos],
            ap_version=ap_version)
        layers.fill_constant(shape=[1], value=1, dtype="int32",
                             out=self.has_state)
        self.metrics.extend([self.cur_map, self.accum_map])

    def get_map_var(self):
        return self.cur_map, self.accum_map

    def reset(self, executor, reset_program=None):
        """Empty the state in the global scope: ``has_state`` 0, the
        counts and positives of no batch, their LoDs dropped."""
        from paddle_tpu_torch.scope import global_scope
        scope = global_scope()
        scope.set_var(self.has_state.name, np.zeros((1,), np.int32))
        for var in self.states[1:]:
            shape = [0 if d is None else max(d, 0) for d in var.shape]
            scope.set_var(var.name, np.zeros(shape, var.dtype))
            scope.set_lod(var.name, None)


class CTCErrorEvaluator(EditDistance):
    """Streaming CTC sequence error rate: ``ctc_align`` of the network's
    ids, then the length-normalised edit distance to the label (reference
    ``gserver/evaluators/CTCErrorEvaluator.cpp``)."""

    def __init__(self, input, label, blank=0):
        helper = LayerHelper("ctc_error")
        aligned = helper.create_tmp_variable("int64")
        helper.append_op(type="ctc_align", inputs={"Input": [input]},
                         outputs={"Output": [aligned]},
                         attrs={"blank": blank, "merge_repeated": True})
        super().__init__(aligned, label, normalized=True, name="ctc_error")

    def eval(self, executor, eval_program=None):
        avg_rate, _ = super().eval(executor, eval_program)
        return avg_rate
