"""Evaluation metrics: the port of the JAX package's ``utils/metrics.py``.

* Class metrics (``:23-254`` there), in numpy on the host as in the JAX
  package: accuracy, top-k accuracy, precision / recall / F1 (micro and
  binary), micro average precision, the package's own ``roc_curve`` (with
  ``drop_intermediate``), ``auc`` and ``roc_auc_score``, the per-image
  metrics and the chunk-streaming counts.
* Image metrics of the RD harness (``:256-309`` there): MSE, RMSE, PSNR,
  SSIM (skimage's conventions: a 7x7 uniform window, VALID, the sample
  covariance factor, the mean over channels) and the mean CIE76 delta-E.
  They run in float64 on the tensor's device (numpy inputs go to
  ``device``, None: the CPU).  SSIM's window means are one
  ``F.avg_pool2d`` a statistic, where the JAX package averages
  ``sliding_window_view`` windows on the host.
"""

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.color import as_float64, deltaE_cie76, rgb2lab

# numpy < 2 names the trapezoid rule ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# --- ranking / classification primitives -------------------------------------


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def accuracy_score(target, pred_class):
    return float(np.mean(np.asarray(target) == np.asarray(pred_class)))


def top_k_accuracy_score(target, pred_scores, k=5, labels=None):
    del labels
    topk = np.argsort(pred_scores, axis=1)[:, -k:]
    return float(np.mean(np.any(topk == np.asarray(target).reshape(-1, 1),
                                axis=1)))


def precision_recall_f1(target, pred_class, binary: bool = False):
    target = np.asarray(target).ravel()
    pred_class = np.asarray(pred_class).ravel()
    if binary:
        tp = np.sum((pred_class == 1) & (target == 1))
        fp = np.sum((pred_class == 1) & (target == 0))
        fn = np.sum((pred_class == 0) & (target == 1))
    else:
        # micro average over multiclass == accuracy-style counting
        tp = np.sum(pred_class == target)
        fp = target.size - tp
        fn = target.size - tp
    prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    rec = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * tp / (2 * tp + fp + fn)) if (2 * tp + fp + fn) > 0 else 0.0
    return float(prec), float(rec), float(f1)


def average_precision_score(one_hot_target, pred_scores):
    """Micro-averaged AP over flattened (sample, class) pairs."""
    y = np.asarray(one_hot_target).ravel().astype(np.float64)
    s = np.asarray(pred_scores).ravel().astype(np.float64)
    order = np.argsort(-s, kind="stable")
    y = y[order]
    tp_cum = np.cumsum(y)
    precision = tp_cum / np.arange(1, y.size + 1)
    total_pos = y.sum()
    if total_pos == 0:
        return float("nan")
    return float(np.sum(precision * y) / total_pos)


def roc_curve(target, pred_scores, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) like sklearn.roc_curve."""
    target = np.asarray(target).ravel().astype(bool)
    scores = np.asarray(pred_scores).ravel().astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    target = target[order]

    distinct = np.where(np.diff(scores))[0]
    threshold_idxs = np.r_[distinct, target.size - 1]

    tps = np.cumsum(target)[threshold_idxs]
    fps = 1 + threshold_idxs - tps

    if drop_intermediate and len(tps) > 2:
        optimal = np.where(np.r_[True,
                                 np.logical_or(np.diff(fps, 2),
                                               np.diff(tps, 2)),
                                 True])[0]
        fps, tps = fps[optimal], tps[optimal]
        threshold_idxs = threshold_idxs[optimal]

    thresholds = scores[threshold_idxs]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[thresholds[0] + 1 if thresholds.size else 1,
                       thresholds]

    p = target.sum()
    n = target.size - p
    tpr = tps / p if p > 0 else np.zeros_like(tps, np.float64)
    fpr = fps / n if n > 0 else np.zeros_like(fps, np.float64)
    return (fpr.astype(np.float32), tpr.astype(np.float32),
            thresholds.astype(np.float32))


def auc(x, y):
    return float(_trapezoid(y, x))


def roc_auc_score(target, pred_scores):
    fpr, tpr, _ = roc_curve(target, pred_scores, drop_intermediate=False)
    return auc(fpr, tpr)


def compute_roc_curve(pred_scores, target):
    """(fpr, tpr, thresholds, auc)."""
    fpr, tpr, thrsh = roc_curve(target, pred_scores)
    return fpr, tpr, thrsh, auc(fpr, tpr)


# --- per-image / aggregate classification metrics ----------------------------


def compute_class_metrics(pred_class, target, top_k, num_classes,
                          labels=None, pred_scores=None, pred_class_top=None,
                          one_hot_target=None) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    target = np.asarray(target)

    if num_classes > 1:
        metrics["acc_top"] = top_k_accuracy_score(target, pred_scores,
                                                  k=top_k)
        metrics["avg_prec"] = average_precision_score(one_hot_target,
                                                      pred_scores)
        tp = int((pred_class == target).sum())
        tp_top = int((pred_class_top
                      == target.reshape(-1, 1)).any(axis=1).sum())
        metrics.update(tp=tp, tp_top=tp_top, tn=0,
                       fp=target.size - tp, fn=target.size - tp,
                       p=target.size, n=0)
        metrics["acc"] = accuracy_score(target, pred_class)
        prec, rec, f1 = precision_recall_f1(target, pred_class, binary=False)
        metrics.update(prec=prec, rec=rec, f1=f1)
    else:
        target = (target > 0.5).astype(np.int64)
        pred_class = np.asarray(pred_class).astype(np.int64).ravel()
        tgt = target.ravel()
        tp = int(np.sum(pred_class & tgt))
        metrics.update(
            tp=tp, tp_top=tp,
            tn=int(np.sum((1 - pred_class) & (1 - tgt))),
            fp=int(np.sum(pred_class & (1 - tgt))),
            fn=int(np.sum((1 - pred_class) & tgt)),
            p=int(tgt.sum()), n=int(tgt.size - tgt.sum()))
        metrics["auc"] = (roc_auc_score(tgt, pred_scores[:, 0])
                          if metrics["p"] > 0 else float("nan"))
        metrics["acc"] = accuracy_score(tgt, pred_class)
        prec, rec, f1 = precision_recall_f1(tgt, pred_class, binary=True)
        metrics.update(prec=prec, rec=rec, f1=f1)

    return metrics


def compute_metrics_per_image(pred, target, top_k=5, num_classes=None,
                              seg_threshold=0.90) -> Dict[str, float]:
    """Multiclass or binary-segmentation metrics of one batch; ``pred`` is
    logits, NHWC for dense predictions."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    if num_classes is None:
        num_classes = pred.shape[-1]
    top_k = min(top_k, num_classes)

    if pred.ndim == 4:
        if target.ndim == 4 and target.shape[-1] > 1 and num_classes == 1:
            target = target[..., 1:]
        target = target.reshape(-1, num_classes) if target.ndim == 4 \
            else target.reshape(-1)
        pred = pred.reshape(-1, num_classes)

    if num_classes > 1:
        pred_scores = _softmax(pred, axis=1)
        pred_class_top = np.argsort(pred_scores, axis=1)[:, -top_k:]
        pred_class = np.argmax(pred, axis=1)
        one_hot = np.eye(num_classes)[np.asarray(target).ravel()
                                      .astype(np.int64)]
        return compute_class_metrics(pred_class, target, top_k, num_classes,
                                     range(num_classes), pred_scores,
                                     pred_class_top, one_hot)

    pred_scores = _sigmoid(pred)
    pred_class = (pred_scores > seg_threshold).astype(np.int64)
    return compute_class_metrics(pred_class, target, top_k, num_classes,
                                 None, pred_scores, None, None)


def compute_class_metrics_streaming(chunks: Iterable[Tuple[np.ndarray,
                                                           np.ndarray]],
                                    num_classes: int,
                                    pred_class_top_chunks=None
                                    ) -> Dict[str, float]:
    """Out-of-core counting metrics over (pred_class, target) chunk pairs."""
    tp = tn = fp = fn = p = n = tp_top = 0
    for i, (pred_class, target) in enumerate(chunks):
        pred_class = np.asarray(pred_class)
        target = np.asarray(target)
        if num_classes > 1:
            p += target.size
            tp += int(np.sum(pred_class == target))
            if pred_class_top_chunks is not None:
                top = np.asarray(pred_class_top_chunks[i])
                tp_top += int(np.sum(np.any(
                    top == target.reshape(-1, 1), axis=1)))
        else:
            tgt = (target > 0.5).astype(np.int64).ravel()
            prd = pred_class.astype(np.int64).ravel()
            tp += int(np.sum(prd & tgt))
            tn += int(np.sum((1 - prd) & (1 - tgt)))
            fp += int(np.sum(prd & (1 - tgt)))
            fn += int(np.sum((1 - prd) & tgt))
            p += int(tgt.sum())
            n += int(tgt.size - tgt.sum())

    if num_classes > 1:
        fp = p - tp
        fn = 0
        tp_top_total = tp_top
        tn_top = 0
    else:
        tp_top_total = tp
        tn_top = tn

    total = tp + tn + fp + fn
    metrics = dict(tp=tp, tp_top=tp_top_total, tn=tn, fp=fp, fn=fn, p=p, n=n)
    metrics["acc"] = (tp + tn) / total if total > 0 else float("nan")
    metrics["top_acc"] = ((tp_top_total + tn_top) / total if total > 0
                          else float("nan"))
    metrics["prec"] = tp / (tp + fp) if (tp + fp) > 0 else float("nan")
    metrics["rec"] = tp / (tp + fn) if (tp + fn) > 0 else float("nan")
    metrics["f1"] = (2 * tp / (2 * tp + fp + fn)) if (2 * tp + fp + fn) > 0 \
        else float("nan")
    return metrics


# --- image quality metrics (RD harness) --------------------------------------


def mean_squared_error(x, x_r, device=None) -> float:
    x = as_float64(x, device)
    return float(torch.mean((x - as_float64(x_r, x.device)) ** 2))


def compute_rmse(x, x_r, device=None) -> float:
    return float(np.sqrt(mean_squared_error(x, x_r, device)))


def compute_psnr(x, x_r, max_val=255, device=None) -> float:
    mse = mean_squared_error(x, x_r, device)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(max_val) - 10 * np.log10(mse))


def structural_similarity(x, x_r, channel_axis=2, data_range=None,
                          win_size=7, k1=0.01, k2=0.03, device=None) -> float:
    """skimage-convention SSIM: ``win_size``² uniform window, VALID, the
    per-channel means averaged."""
    x = as_float64(x, device)
    x_r = as_float64(x_r, x.device)
    if data_range is None:
        data_range = 255.0 if float(x.max()) > 1.5 else 1.0
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    if x.dim() == 2:
        x, x_r = x[..., None], x_r[..., None]
    # (C, 1, H, W): one image per channel
    a = torch.movedim(x, channel_axis, 0)[:, None]
    b = torch.movedim(x_r, channel_axis, 0)[:, None]

    def mean_filter(img):
        return F.avg_pool2d(img, win_size, stride=1)

    cov_norm = win_size ** 2 / (win_size ** 2 - 1)  # sample covariance
    ux, uy = mean_filter(a), mean_filter(b)
    uxx, uyy, uxy = mean_filter(a * a), mean_filter(b * b), mean_filter(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / \
        ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return float(s.mean(dim=(1, 2, 3)).mean())


def compute_delta_cielab(x, x_r, device=None) -> float:
    lab = rgb2lab(x, device)
    return float(torch.mean(deltaE_cie76(lab, rgb2lab(x_r, lab.device))))
