"""Per-class IoU with the reference's ``iouEval`` semantics — the
counterpart of the JAX ``metrics/iou.py``.

  * ``IouEval(n_classes, ignore_index=19)``: pixels whose ground truth is
    the ignore class count toward neither tp, fp nor fn.
  * ``get_iou() -> (mean, per_class)`` with iou = tp / (tp + fp + fn +
    1e-15), the mean over every non-ignored class (absent classes count
    as 0).
  * The ANSI-colored printing (``colors``, ``get_color_entry``).

The (C, C) confusion matrix is one ``index_add_`` of ones per batch on
the device that holds the predictions (``torch.bincount`` would read the
largest index back to the host on a card, a synchronisation per batch);
it stays there across batches, and only ``get_iou`` copies its 400
counts to the host.  The counts are integers, so their sum is exact in
any order.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix_update(cm, preds, labels):
    """cm[g, p] += count(gt == g & pred == p); preds and labels (B, H, W)
    integer maps with values in [0, n)."""
    n = cm.shape[0]
    g = labels.reshape(-1).to(device=cm.device, dtype=torch.int64)
    p = preds.reshape(-1).to(device=cm.device, dtype=torch.int64)
    counts = torch.zeros(n * n, dtype=torch.int64, device=cm.device)
    counts.index_add_(0, g * n + p, torch.ones_like(g))
    return cm + counts.reshape(n, n)


def iou_from_confusion(cm, ignore_index=19):
    """(mean_iou, per_class_iou) over classes != ignore_index.  fp of class
    c leaves out the pixels whose ground truth is the ignore class (the
    reference's fpmult = x_onehot * (1 - y_onehot - ignores))."""
    if isinstance(cm, torch.Tensor):
        cm = cm.cpu().numpy()
    cm = np.asarray(cm, dtype=np.float64)
    n = cm.shape[0]
    keep = np.arange(n) != ignore_index
    tp = np.diag(cm)
    fn = cm.sum(axis=1) - tp
    fp = cm[keep].sum(axis=0) - tp
    iou = tp / (tp + fp + fn + 1e-15)
    per_class = iou[keep]
    return float(per_class.mean()), per_class


class IouEval:
    """Behavioural equivalent of the reference's iouEval class."""

    def __init__(self, n_classes=20, ignore_index=19):
        self.n_classes = n_classes
        self.ignore_index = ignore_index if n_classes > 1 else -1
        self.reset()

    def reset(self):
        self.cm = None

    def add_batch(self, preds, labels):
        preds = torch.as_tensor(preds)
        if self.cm is None:
            self.cm = torch.zeros((self.n_classes, self.n_classes),
                                  dtype=torch.int64, device=preds.device)
        self.cm = confusion_matrix_update(self.cm, preds,
                                          torch.as_tensor(labels))

    # reference method name
    addBatch = add_batch

    def get_iou(self):
        cm = (np.zeros((self.n_classes, self.n_classes)) if self.cm is None
              else self.cm)
        return iou_from_confusion(cm, self.ignore_index)

    getIoU = get_iou


class colors:
    RED = "\033[31;1m"
    GREEN = "\033[32;1m"
    YELLOW = "\033[33;1m"
    BLUE = "\033[34;1m"
    MAGENTA = "\033[35;1m"
    CYAN = "\033[36;1m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"
    ENDC = "\033[0m"


def get_color_entry(val):
    if not isinstance(val, float):
        return colors.ENDC
    if val < .20:
        return colors.RED
    elif val < .40:
        return colors.YELLOW
    elif val < .60:
        return colors.BLUE
    elif val < .80:
        return colors.CYAN
    return colors.GREEN


getColorEntry = get_color_entry
