"""Meters and eval metrics (``cgnn_tpu/train/metrics.py``).

The device-side metric sums of the training loop (``DeviceSums``, the
port's form of the JAX ``accumulate_on_device``; ``fetch_device_sums``,
``means_from_sums``): each step's sums are added on the device, with no
host sync a step, and fetched once, in ONE device-to-host copy
(``snapshot_device_sums``: the same copy without blocking). The
host-side meters and metrics (``AverageMeter``, ``mae``, and the
binary-classification ``class_eval`` with its rank-based AUC) are numpy.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


class DeviceSums:
    """Static metric accumulators on the device, one 0-d tensor a key: a
    captured step adds its sums into them (``add``), the host zeroes them
    once an epoch and fetches them in one copy. A key must first appear
    outside a capture (the graph's warm-up runs), where its tensor is
    made; a key that first appears mid-epoch starts from zero."""

    def __init__(self):
        self.sums: dict = {}

    def add(self, metrics: dict) -> dict:
        for k, v in metrics.items():
            acc = self.sums.get(k)
            if acc is None:
                if v.is_cuda and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        f"metric {k!r} first appeared inside a capture")
                acc = self.sums[k] = torch.zeros_like(v.detach())
            acc.add_(v.detach())
        return self.sums

    def zero(self) -> None:
        for v in self.sums.values():
            v.zero_()


def fetch_device_sums(sums: dict | None) -> dict:
    """The device sums as Python floats, in ONE device-to-host copy."""
    return snapshot_device_sums(sums)()


def snapshot_device_sums(sums: dict | None) -> Callable[[], dict]:
    """Copy the device sums now, on the current stream, into one fresh
    tensor (an in-place zero of the accumulators enqueued later does not
    reach it), and from there to page-locked host memory without
    blocking -> ``result()``, which waits for the copy and returns the
    floats."""
    if not sums:
        return dict
    keys = sorted(sums)
    stacked = torch.stack([sums[k].double() for k in keys])
    done = None
    if stacked.is_cuda:
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(stacked.device))
    else:
        host = stacked

    def result() -> dict:
        if done is not None:
            wait_event(done)
        return dict(zip(keys, host.tolist()))

    return result


def wait_event(event, poll_s: float = 1e-4) -> None:
    """Wait for a CUDA event by polling it (``query``, then a short
    sleep): between polls the waiting thread holds neither the
    interpreter nor the driver, whatever the event's sync flags."""
    while not event.query():
        time.sleep(poll_s)


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
