"""Streaming segmentation metrics: confusion matrix, accuracy, mean IoU, F1.

Port of ``satellite_computervision_tpu/models/metrics.py``: an
accumulate/finalize pair whose state is one (n, n) float32 tensor that
stays on the device until finalized.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


_ROW = 4096  # pairs a row of partial counts takes (many rows: few atomic adds on one bin)


def confusion_matrix(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """Dense (num_classes, num_classes) float32 counts, rows = true class.

    Each pair's flat index ``true * n + pred`` is counted with
    ``scatter_add_`` into fixed int64 bins on the inputs' device, one row
    of n² + 1 bins for each ``_ROW`` pairs, and the rows summed; an index
    outside [0, n²) goes to the spare bin and is dropped. ``torch.bincount``
    would read the largest index back to the host on CUDA, which drains a
    step's queue and breaks a CUDA graph's capture; one row of bins would
    put every pair's atomic add on n² addresses (4x the time on an H100)."""
    n = num_classes
    y_true = torch.as_tensor(y_true).reshape(-1).long()
    y_pred = torch.as_tensor(y_pred).reshape(-1).long().to(y_true.device)
    flat = y_true * n + y_pred
    flat = torch.where((flat >= 0) & (flat < n * n), flat, n * n)
    rows = -(-flat.numel() // _ROW)
    flat = F.pad(flat, (0, rows * _ROW - flat.numel()), value=n * n).view(rows, _ROW)
    counts = torch.zeros((rows, n * n + 1), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    return counts.sum(0)[: n * n].reshape(n, n).float()


def normalize_confusion_matrix(cm) -> torch.Tensor:
    """Row-normalize counts to rates."""
    cm = torch.as_tensor(cm).float()
    return cm / cm.sum(dim=1, keepdim=True).clamp(min=1.0)


def mean_iou_from_cm(cm) -> torch.Tensor:
    """Keras MeanIoU semantics: mean over classes of TP/(TP+FP+FN), classes
    absent from both truth and prediction left out of the mean."""
    cm = torch.as_tensor(cm).float()
    tp = torch.diagonal(cm)
    union = cm.sum(dim=0) + cm.sum(dim=1) - tp
    iou = torch.where(union > 0, tp / union.clamp(min=1e-12), torch.zeros_like(tp))
    return iou.sum() / (union > 0).float().sum().clamp(min=1.0)


def accuracy_from_cm(cm) -> torch.Tensor:
    cm = torch.as_tensor(cm).float()
    return torch.diagonal(cm).sum() / cm.sum().clamp(min=1.0)


def f1_from_cm(cm, positive_class: int = 1) -> torch.Tensor:
    """Binary F1 for a designated positive class."""
    cm = torch.as_tensor(cm).float()
    tp = cm[positive_class, positive_class]
    fp = cm[:, positive_class].sum() - tp
    fn = cm[positive_class, :].sum() - tp
    return 2.0 * tp / (2.0 * tp + fp + fn).clamp(min=1e-12)


def init_metric_state(num_classes: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.float32, device=device)


def update_metric_state(state: torch.Tensor, y_true, y_pred) -> torch.Tensor:
    return state + confusion_matrix(y_true, y_pred, state.shape[0])


def finalize_metrics(state: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "accuracy": accuracy_from_cm(state),
        "mean_iou": mean_iou_from_cm(state),
        "f1": f1_from_cm(state),
    }
