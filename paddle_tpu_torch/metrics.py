"""Python-side streaming metric accumulators
(the port of ``paddle_tpu.metrics``; reference
``python/paddle/fluid/metrics.py``): numpy accumulators of fetched
values, no ops."""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "ChunkEvaluator",
           "EditDistance", "DetectionMAP", "Auc"]


def _is_numpy_(var):
    return isinstance(var, (np.ndarray, np.generic))


class MetricBase:
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {attr: value for attr, value in self.__dict__.items()
                  if not attr.startswith("_")}
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        return {attr: value for attr, value in self.__dict__.items()
                if not attr.startswith("_")}

    def update(self, preds, labels):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("metric should be an instance of MetricBase")
        self._metrics.append(metric)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).item())
        self.num_label_chunks += int(np.asarray(num_label_chunks).item())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).item())

    def eval(self):
        precision = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        recall = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.0
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        seq_num = int(np.asarray(seq_num).item())
        self.seq_num += seq_num
        self.instance_error += int(np.sum(distances > 0))
        self.total_distance += float(np.sum(distances))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated into EditDistance")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / self.seq_num
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def update(self, preds, labels):
        if not _is_numpy_(labels) or not _is_numpy_(preds):
            raise ValueError("labels and preds must be numpy arrays")
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        labels = labels.reshape(-1)
        pos_score = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        for idx_thresh, thresh in enumerate(thresholds):
            pred_pos = pos_score >= thresh
            self.tp_list[idx_thresh] += np.sum(pred_pos & (labels > 0))
            self.fp_list[idx_thresh] += np.sum(pred_pos & (labels <= 0))
            self.fn_list[idx_thresh] += np.sum(~pred_pos & (labels > 0))
            self.tn_list[idx_thresh] += np.sum(~pred_pos & (labels <= 0))

    def eval(self):
        epsilon = 1e-6
        num_thresholds = self._num_thresholds
        tpr = (self.tp_list.astype("float32") +
               epsilon) / (self.tp_list + self.fn_list + epsilon)
        fpr = self.fp_list.astype("float32") / (
            self.fp_list + self.tn_list + epsilon)
        rec = (self.tp_list.astype("float32") + epsilon) / (
            self.tp_list + self.fp_list + epsilon)
        x = fpr[:num_thresholds - 1] - fpr[1:]
        y = (tpr[:num_thresholds - 1] + tpr[1:]) / 2.0
        auc_value = np.sum(x * y)
        return auc_value


class DetectionMAP(MetricBase):
    """Running mean of the per-batch mAP produced by the ``detection_map``
    op (reference ``python/paddle/fluid/metrics.py`` DetectionMAP)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(np.asarray(value).reshape(-1)[0]) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("DetectionMAP: no batches accumulated")
        return self.value / self.weight
