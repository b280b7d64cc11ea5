"""Model evaluation reports: a confusion matrix and per-class statistics.

Port of ``satellite_computervision_tpu/train/evaluate.py``: the confusion
matrix accumulates on the device the batches are on (``models.metrics``);
one read-back at the end, then the report in numpy, as the JAX function
computes it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from satellite_computervision_tpu_torch.models import metrics as metrics_lib


def _labels_int(y: torch.Tensor) -> torch.Tensor:
    """One-hot labels argmaxed, (B, H, W, 1) squeezed, integer maps as is."""
    if y.ndim == 4:
        return torch.argmax(y, -1) if y.shape[-1] > 1 else y[..., 0]
    return y


def evaluate_confusion(
    predict_classes: Callable,
    batches,
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> Dict:
    """Run ``predict_classes(x) -> (B, H, W) int classes`` over (x, y)
    batches; return counts, rates, and per-class precision/recall/IoU/F1.

    ``y`` may be one-hot (argmaxed) or integer maps (numpy or tensors).
    """
    cm = None
    for x, y in batches:
        batch_cm = metrics_lib.confusion_matrix(_labels_int(torch.as_tensor(y)),
                                                predict_classes(x), num_classes)
        cm = batch_cm if cm is None else cm + batch_cm
    if cm is None:
        cm = metrics_lib.init_metric_state(num_classes)

    counts = cm.cpu().numpy()
    rates = metrics_lib.normalize_confusion_matrix(cm).cpu().numpy()
    tp = np.diagonal(counts)
    fp = counts.sum(axis=0) - tp
    fn = counts.sum(axis=1) - tp
    union = tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        iou = np.where(union > 0, tp / union, 0.0)
        f1 = np.where(
            precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0
        )

    names = list(class_names) if class_names else [str(i) for i in range(num_classes)]
    per_class = {
        name: {
            "precision": float(p),
            "recall": float(r),
            "iou": float(i),
            "f1": float(f),
            "support": int(s),
        }
        for name, p, r, i, f, s in zip(names, precision, recall, iou, f1, counts.sum(1))
    }
    overall = {k: float(v) for k, v in metrics_lib.finalize_metrics(cm).items()}
    return {
        "counts": counts,
        "rates": rates,
        "per_class": per_class,
        "overall": overall,
    }


def format_confusion_report(report: Dict) -> str:
    """Human-readable table of the :func:`evaluate_confusion` output."""
    lines = ["class        prec   recall  iou    f1     support"]
    for name, row in report["per_class"].items():
        lines.append(
            f"{name:<12} {row['precision']:<6.3f} {row['recall']:<7.3f} "
            f"{row['iou']:<6.3f} {row['f1']:<6.3f} {row['support']}"
        )
    o = report["overall"]
    lines.append(
        f"overall      acc={o['accuracy']:.4f} mean_iou={o['mean_iou']:.4f} f1={o['f1']:.4f}"
    )
    return "\n".join(lines)
