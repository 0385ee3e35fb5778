"""Meters and eval metrics (``cgnn_tpu/train/metrics.py``).

The device-side metric sums of the training loop (``accumulate_on_device``,
``fetch_device_sums``, ``means_from_sums``): each step's sums are added on
the device, with no host sync a step, and fetched once, in ONE
device-to-host copy. The host-side meters and metrics (``AverageMeter``,
``mae``, and the binary-classification ``class_eval`` with its
rank-based AUC) are numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def accumulate_on_device(sums: dict | None, metrics: dict) -> dict:
    """Add one step's metric sums into the running sums, on the device;
    a key that first appears mid-epoch starts its own sum."""
    if sums is None:
        return {k: v.detach().clone() for k, v in metrics.items()}
    for k, v in metrics.items():
        if k in sums:
            sums[k].add_(v)
        else:
            sums[k] = v.detach().clone()
    return sums


def fetch_device_sums(sums: dict | None) -> dict:
    """The device sums as Python floats, in ONE device-to-host copy."""
    if not sums:
        return {}
    keys = sorted(sums)
    values = torch.stack([sums[k].double() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def means_from_sums(sums: dict, steps: int) -> dict:
    """Epoch means from '<name>_sum' totals: each divides by its
    '<name>_count' when there is one, else by the global 'count'."""
    count = max(sums.get("count", 1.0), 1.0)
    out = {
        k[: -len("_sum")]: v / max(sums.get(k[: -len("_sum")] + "_count",
                                            count), 1.0)
        for k, v in sums.items() if k.endswith("_sum")
    }
    out["count"] = sums.get("count", 0.0)
    out["steps"] = steps
    return out


class AverageMeter:
    """Running (value, average) meter: the reference's training display."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: float = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)


def mae(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(target))))


def _binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), ties by midranks."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        ranks[order[i: j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def class_eval(log_probs: np.ndarray, labels: np.ndarray) -> dict:
    """accuracy, and for two classes precision, recall, F1 and AUC."""
    log_probs = np.asarray(log_probs)
    labels = np.asarray(labels).astype(int)
    pred = log_probs.argmax(axis=-1)
    acc = float((pred == labels).mean()) if len(labels) else float("nan")
    out = {"accuracy": acc}
    if log_probs.shape[-1] == 2:
        tp = float(((pred == 1) & (labels == 1)).sum())
        fp = float(((pred == 1) & (labels == 0)).sum())
        fn = float(((pred == 0) & (labels == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else float("nan")
        recall = tp / (tp + fn) if tp + fn else float("nan")
        f1 = (2 * precision * recall / (precision + recall)
              if precision == precision and recall == recall
              and precision + recall else float("nan"))
        out.update(precision=precision, recall=recall, f1=f1,
                   auc=_binary_auc(np.exp(log_probs[:, 1]), labels))
    return out
