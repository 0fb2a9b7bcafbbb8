"""Dataset-level pixel metrics over every pixel of an evaluation run: the
port's copy of ``multimodal_fusion_fpn_tpu/metrics/global_metrics.py``
(the original project's ``common/metrics.py:14-68``), in numpy, without
scikit-learn.

Each metric computes what the JAX package's scikit-learn call computes
(scikit-learn 1.9.0 was the one held against):

  * ``AUROC`` is ``roc_auc_score``: the ROC curve from the scores sorted
    descending, one point per distinct score (the true and false positive
    counts as float64 cumulative sums at the last index of each run of
    ties), (0, 0) prepended and the collinear points dropped, then the
    trapezoid rule.  A ground truth of one class gives NaN.
  * ``AUPR`` is ``auc(recall, precision)`` over ``precision_recall_curve``
    (the curve reversed, precision 1 at recall 0 appended); with no
    positive pixel the recall is 1 at every threshold.
  * ``AP`` is ``average_precision_score``: ``max(0, -sum(diff(recall) *
    precision[:-1]))`` over the same curve with positive label 1.
  * ``F1`` is ``f1_score`` of the prediction thresholded at 0.5 (``>=``),
    positive label 1, 0.0 where ``2 tp + fp + fn`` is 0.
  * ``Spec``, ``Sens`` and ``Acc`` come from the 2 x 2 confusion matrix of
    the labels present (sorted), as int64 counts, so 0 / 0 is NaN.  When
    the ground truth and the thresholded prediction hold one label
    between them, or more than two, the matrix is not 2 x 2 and the
    metric raises ValueError, as the JAX package's unpacking does.

The ground truth is classified as scikit-learn's ``type_of_target`` does:
a float with a non-integer value is "continuous", more than two distinct
values "multiclass"; both raise ValueError wherever scikit-learn refuses
them, and so does a non-finite value or a score that is not finite (for
the curves).  ``gt`` may be boolean or float64 (the harness concatenates
the masks into float64).
"""

import numpy as np


def _classes(y: np.ndarray) -> np.ndarray:
    """``np.unique(y)``, without sorting ``y`` when it holds at most two
    values (a mask's labels)."""
    lo, hi = y.min(), y.max()
    if ((y == lo) | (y == hi)).all():
        return np.unique(np.array([lo, hi], y.dtype))
    return np.unique(y)


def _target_type(y: np.ndarray) -> str:
    """'binary', 'multiclass' or 'continuous' for a 1-D label array."""
    if y.dtype.kind == "f":
        if not np.isfinite(y).all():
            raise ValueError("Input y_true contains NaN or infinity.")
        if (y != y.astype(int)).any():
            return "continuous"
    return "multiclass" if _classes(y).size > 2 else "binary"


def _finite_scores(scores: np.ndarray) -> np.ndarray:
    scores = np.asarray(scores).ravel()
    if not np.isfinite(scores).all():
        raise ValueError("Input contains NaN or infinity.")
    return scores


def _curve_counts(positive: np.ndarray, scores: np.ndarray):
    """(fps, tps, thresholds): the false and true positive counts (float64)
    at each distinct score, the scores in descending order."""
    order = np.argsort(scores, kind="stable")[::-1]
    scores = scores[order]
    positive = positive[order].astype(np.float64)
    last = np.r_[np.nonzero(np.diff(scores))[0], positive.size - 1]
    tps = np.cumsum(positive)[last]
    fps = 1 + last.astype(np.float64) - tps
    return fps, tps, scores[last]


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    return (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute the area")
    direction = 1
    dx = np.diff(x)
    if (dx < 0).any():
        if not (dx <= 0).all():
            raise ValueError("x is neither increasing nor decreasing")
        direction = -1
    return float(direction * _trapezoid(y, x))


def _pr_curve(positive: np.ndarray, scores: np.ndarray):
    """(precision, recall) of ``precision_recall_curve``."""
    fps, tps, _ = _curve_counts(positive, scores)
    precision = tps / (tps + fps)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


def _positives_of_binary(gt: np.ndarray) -> np.ndarray:
    """The positive pixels when the positive label is left to the data:
    the labels must be {0, 1}, {-1, 1} or one of them alone."""
    kind = _target_type(gt)
    if kind != "binary":
        raise ValueError(f"{kind} format is not supported")
    classes = _classes(gt)
    if not any(classes.size == len(ok) and (classes == ok).all()
               for ok in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(f"y_true takes value in {classes.tolist()} and "
                         "pos_label is not specified")
    return gt == 1


class GlobalMetric:
    def calculate(self, gt_values: np.ndarray,
                  pred_values: np.ndarray) -> float:
        raise NotImplementedError


class AUROC(GlobalMetric):
    def calculate(self, gt_values, pred_values) -> float:
        gt = np.asarray(gt_values).ravel()
        kind = _target_type(gt)
        scores = _finite_scores(pred_values)
        if kind != "binary":
            raise ValueError(f"{kind} targets: AUROC needs two classes")
        classes = _classes(gt)
        if classes.size != 2:
            return float("nan")
        fps, tps, _ = _curve_counts(gt == classes[1], scores)
        if fps.shape[0] > 2:
            keep = np.r_[True, np.logical_or(np.diff(fps, 2),
                                             np.diff(tps, 2)), True]
            fps, tps = fps[keep], tps[keep]
        fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
        return _auc(fps / fps[-1], tps / tps[-1])


class AUPR(GlobalMetric):
    def calculate(self, gt_values, pred_values) -> float:
        gt = np.asarray(gt_values).ravel()
        positive = _positives_of_binary(gt)
        precision, recall = _pr_curve(positive, _finite_scores(pred_values))
        return _auc(recall, precision)


class AP(GlobalMetric):
    def calculate(self, gt_values, pred_values) -> float:
        gt = np.asarray(gt_values).ravel()
        kind = _target_type(gt)
        if kind != "binary":
            raise ValueError(f"{kind} format is not supported")
        classes = _classes(gt)
        if classes.size == 2 and not (classes == 1).any():
            raise ValueError(f"pos_label=1 is not a valid label: {classes}")
        precision, recall = _pr_curve(gt == 1, _finite_scores(pred_values))
        return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _thresholded(gt_values, pred_values):
    """(gt, the prediction at >= 0.5, the labels present in either)."""
    gt = np.asarray(gt_values).ravel()
    pred = np.where(np.asarray(pred_values).ravel() >= 0.5, 1.0, 0.0)
    if _target_type(gt) == "continuous":
        raise ValueError("Classification metrics can't handle a mix of "
                         "continuous and binary targets")
    return gt, pred, np.union1d(_classes(gt), _classes(pred))


class F1(GlobalMetric):
    def calculate(self, gt_values, pred_values) -> float:
        gt, pred, labels = _thresholded(gt_values, pred_values)
        if labels.size > 2:
            raise ValueError("Target is multiclass but average='binary'")
        if labels.size == 2 and not (labels == 1).any():
            raise ValueError(f"pos_label=1 is not a valid label: {labels}")
        tp = np.count_nonzero((gt == 1) & (pred == 1))
        denominator = float(np.count_nonzero(gt == 1)) + float(
            np.count_nonzero(pred == 1))
        if denominator == 0:
            return 0.0
        return float(2.0 * tp / denominator)


class ClassMetric(GlobalMetric):
    def calculate(self, gt_values, pred_values) -> float:
        gt, pred, labels = _thresholded(gt_values, pred_values)
        if labels.size != 2:
            raise ValueError(f"the confusion matrix of labels "
                             f"{labels.tolist()} is not 2 x 2")
        t, p = gt == labels[1], pred == labels[1]
        tn, fp, fn, tp = (np.int64(np.count_nonzero(~t & ~p)),
                          np.int64(np.count_nonzero(~t & p)),
                          np.int64(np.count_nonzero(t & ~p)),
                          np.int64(np.count_nonzero(t & p)))
        with np.errstate(invalid="ignore"):
            return self.get_metric(tn, fp, fn, tp)

    def get_metric(self, tn, fp, fn, tp) -> float:
        raise NotImplementedError


class Spec(ClassMetric):
    def get_metric(self, tn, fp, fn, tp) -> float:
        return tn / (tn + fp)


class Sens(ClassMetric):
    def get_metric(self, tn, fp, fn, tp) -> float:
        return tp / (tp + fn)


class Acc(ClassMetric):
    def get_metric(self, tn, fp, fn, tp) -> float:
        return (tp + tn) / (tp + tn + fp + fn)
