"""Crash-safe checkpoints and resume (``cgnn_tpu/train/checkpoint.py``).

Every epoch saves the full training state (parameters, BatchNorm
statistics, optimizer state, step, normalizer) plus its meta (configs,
epoch, best metric), with the JAX package's on-disk protocol for
processes that die mid-save:

- every save goes to a FRESH versioned directory (``ckpt-00000012``),
  written under ``.tmp-<name>`` and committed with ``os.replace``, so a
  kill at any instant leaves every committed checkpoint intact;
- the integrity manifest (``resilience.integrity``: per-leaf shape,
  dtype, crc32) is written LAST: it is the commit marker, and a
  directory without one is never offered for restore;
- restore walks a fallback chain (newest committed -> older -> best),
  verifying each candidate against its manifest, and reports every
  candidate it skipped and why (``last_restore_report``);
- retention keeps the newest ``keep`` saves plus the target of the
  ``best.json`` pointer, which is replaced atomically;
- stale ``.tmp-*`` directories are swept by the first SAVE only, never
  by a reader (a predict process must not delete a running trainer's
  save in progress).

Saves are async: the caller's thread only copies the state to the host
(``t.detach().to("cpu", copy=True)``: on the card that copy is the
device fetch; on the CPU it is a snapshot, so the next in-place
optimizer update cannot race the write); one ordered finalizer thread
writes, commits and applies retention. A failure surfaces at the next
``wait()``, ``restore()`` or ``close()``.

Where it differs from the JAX package:

- the state is ``state.npz`` (``np.savez``, loaded with
  ``allow_pickle=False``) in place of orbax's ``state/``. Its tree holds
  ``step``; ``params`` and ``batch_stats`` in the JAX layout
  (``convert.to_flax_variables``); ``opt_state``: the torch optimizer's
  tensors by parameter name and state key, plus ``count``, so the
  step-counted lr milestones resume; and ``normalizer`` (``mean``,
  ``std``). ``rng`` holds only the dropout generator's state, where the
  model draws a mask (``graphs.state_generators``): the data order is
  seeded per ``fit``;
- the legacy tag layout (orbax only) is not read; a JAX save found in a
  port directory (a ``ckpt-*`` without ``state.npz``) fails
  verification, is reported in the chain and is skipped;
- a checkpoint without ``opt_state`` (``jax_checkpoint_to_torch.py``
  writes one) serves ``restore_for_inference`` but not ``restore``;
- the telemetry spans are not ported yet (ROADMAP Queue 1, item 11).

The finalizer has the JAX package's three fault-injection crash points
(``resilience.faultinject.crash_point``): ``after_write`` (state and
nothing else written), ``before_commit`` (the manifest written, the
rename not done) and ``after_commit``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import sys
import threading
from typing import Callable

import numpy as np
import torch

from cgnn_tpu_torch import convert
from cgnn_tpu_torch.observe.metrics_io import jsonfinite
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.resilience.integrity import (
    read_manifest,
    tree_manifest,
    verify_tree,
    write_manifest,
)
from cgnn_tpu_torch.train.graphs import state_generators
from cgnn_tpu_torch.train.normalizer import Normalizer

_LATEST = "latest"
_BEST = "best"
_PREVIOUS = "previous"
_SAVE_RE = re.compile(r"^ckpt-(\d{8})$")
_TMP_PREFIX = ".tmp-"
_BEST_POINTER = "best.json"
STATE_FILE = "state.npz"
META_FILE = "meta.json"


class CheckpointRestoreError(RuntimeError):
    """No candidate in the restore fallback chain was usable."""

    def __init__(self, tag: str, attempts: list[str]):
        self.attempts = attempts
        detail = "; ".join(attempts) if attempts else "no checkpoints found"
        super().__init__(f"no restorable {tag!r} checkpoint: {detail}")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that shares no storage with ``t`` (a snapshot)."""
    return t.detach().to("cpu", copy=True)


def _named_params(state) -> list[tuple[str, torch.Tensor]]:
    """(name, parameter) of each parameter the optimizer updates, in its
    order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [(names[id(p)], p) for p in state.optimizer.params]


def state_tree(state) -> dict:
    """The checkpoint tree of a TrainState, as host numpy copies."""
    sd = {k: _host(v) for k, v in state.model.state_dict().items()}
    variables = convert.to_flax_variables(sd)
    inner = state.optimizer.inner.state
    opt: dict = {"count": np.asarray(state.optimizer.count, np.int64)}
    for name, p in _named_params(state):
        slots = {k: _host(v).numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)
                 for k, v in inner.get(p, {}).items() if v is not None}
        if slots:
            opt[name] = slots
    tree = {
        "step": np.asarray(state.optimizer.count, np.int64),
        "params": variables["params"],
        # empty for the force field, whose trunk has no BatchNorm
        "batch_stats": variables.get("batch_stats", {}),
        "opt_state": opt,
        "normalizer": {"mean": _host(state.normalizer.mean).numpy(),
                       "std": _host(state.normalizer.std).numpy()},
    }
    gens = state_generators(state)
    if gens:
        # the dropout generator's state (the JAX ``rng``): a resumed run
        # draws the masks the uninterrupted one would
        tree["rng"] = {f"gen{i}": g.get_state().numpy().copy()
                       for i, g in enumerate(gens)}
    return tree


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    # (ascontiguousarray would make a 0-d leaf 1-d)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _model_state_dict(tree, model) -> dict:
    """The model's state_dict from a tree's JAX-layout variables; raises
    unless it has exactly the model's keys and shapes."""
    sd = convert.from_flax_variables(
        {"params": tree["params"],
         "batch_stats": tree.get("batch_stats", {})})
    want = model.state_dict()
    if set(sd) != set(want):
        raise ValueError(
            f"tensors differ from the model's: missing "
            f"{sorted(set(want) - set(sd))[:4]}, extra "
            f"{sorted(set(sd) - set(want))[:4]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != the model's "
                             f"{tuple(want[k].shape)}")
    return sd


def _optimizer_state_dict(tree, state) -> dict:
    """The torch optimizer's state_dict from a tree's ``opt_state``;
    raises when it has none or names a parameter the model lacks."""
    if "opt_state" not in tree:
        raise ValueError(
            "no optimizer state (an inference-only checkpoint): it cannot "
            "resume training")
    opt = dict(tree["opt_state"])
    opt.pop("count", None)
    named = _named_params(state)
    index = {name: i for i, (name, _) in enumerate(named)}
    unknown = sorted(set(opt) - set(index))
    if unknown:
        raise ValueError(f"optimizer state for unknown parameters "
                         f"{unknown[:4]}")
    sd = state.optimizer.inner.state_dict()
    sd["state"] = {index[name]: {k: torch.from_numpy(np.array(v))
                                 for k, v in slots.items()}
                   for name, slots in opt.items()}
    return sd


def load_tree(path: str) -> dict:
    """A saved ``state.npz`` as its tree of numpy arrays (unverified)."""
    with np.load(path, allow_pickle=False) as z:
        return convert.unflatten({k: z[k] for k in z.files})


class CheckpointManager:
    """Versioned atomic saves + fallback-chain restores (module docstring).
    ``keep`` bounds retention (newest ``keep`` saves + the best target;
    ``keep=0`` keeps all)."""

    def __init__(self, directory: str, keep: int = 3,
                 log_fn: Callable | None = None):
        # restore-fallback reports are operator diagnostics: stderr
        self._log = log_fn or (lambda msg: print(msg, file=sys.stderr))
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._jobs: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._errors: list[BaseException] = []
        self.last_restore_report: list[str] = []
        # the candidate the most recent restore loaded (None until one
        # succeeds): the chain can fall back past the newest save
        self.last_restored: str | None = None
        self._swept_tmp = False
        self._next_seq = 1 + max(
            (int(m.group(1)) for m in map(_SAVE_RE.match,
                                          os.listdir(self.directory)) if m),
            default=-1)

    # ---- directory inventory ----

    def _committed_saves(self) -> list[str]:
        """Committed (manifest-bearing) save names, newest first."""
        names = [n for n in os.listdir(self.directory)
                 if _SAVE_RE.match(n)
                 and read_manifest(os.path.join(self.directory, n))
                 is not None]
        return sorted(names, reverse=True)

    def newest_committed(self) -> str | None:
        """Name of the newest committed save (None when there is none).
        Read-only: safe from a process that never saves."""
        saves = self._committed_saves()
        return saves[0] if saves else None

    def is_committed(self, name: str) -> bool:
        """True iff ``name`` is a committed versioned save here."""
        return bool(_SAVE_RE.match(name)) and read_manifest(
            os.path.join(self.directory, name)) is not None

    def _best_target(self) -> str | None:
        try:
            with open(os.path.join(self.directory, _BEST_POINTER)) as f:
                name = json.load(f).get("save")
        except (OSError, ValueError, AttributeError):
            return None
        if name and _SAVE_RE.match(name) and os.path.isdir(
                os.path.join(self.directory, name)):
            return name
        return None

    def _candidates(self, tag: str) -> list[str]:
        """The restore fallback chain for ``tag``, best-first."""
        saves = self._committed_saves()
        best = self._best_target()
        if tag == _BEST:
            return [best] if best else []
        if tag == _PREVIOUS:
            return saves[1:]
        if tag == _LATEST:  # newest -> older -> best
            return saves + ([best] if best and best not in saves else [])
        if _SAVE_RE.match(tag):
            # an explicit save: exactly that one, no fallback
            return [tag] if tag in saves else []
        return []

    # ---- metadata ----

    def read_meta(self, tag: str = _LATEST) -> dict:
        for name in self._candidates(tag):
            try:
                with open(os.path.join(self.directory, name,
                                       META_FILE)) as f:
                    return json.load(f)
            except (OSError, ValueError):
                continue
        return {}

    def exists(self, tag: str = _LATEST) -> bool:
        return bool(self._candidates(tag))

    # ---- save path ----

    def save(self, state, meta: dict, is_best: bool = False) -> None:
        """Commit a new versioned save of a TrainState: the caller's
        thread copies the state to the host; the write, manifest, commit
        rename, best pointer and retention run on the finalizer."""
        self.save_tree(state_tree(state), meta, is_best)

    def save_tree(self, tree: dict, meta: dict,
                  is_best: bool = False) -> None:
        """``save`` for a tree of host arrays the caller no longer
        mutates (a converted checkpoint)."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        self._sweep_stale_tmp()
        self._ensure_worker()
        self._jobs.put((seq, tree, dict(meta), is_best))

    def _sweep_stale_tmp(self):
        """Remove the uncommitted temp dirs a crashed predecessor left,
        from the first save only (module docstring)."""
        if self._swept_tmp:
            return
        self._swept_tmp = True
        for entry in os.listdir(self.directory):
            if entry.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, entry),
                              ignore_errors=True)

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain_jobs, daemon=True, name="ckpt-finalizer")
            self._worker.start()

    def _drain_jobs(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                self._finalize(*job)
            except BaseException as e:  # noqa: BLE001 — surfaced at wait()
                self._errors.append(e)
                print(f"checkpoint save failed: {e!r}", file=sys.stderr)
            finally:
                self._jobs.task_done()

    def _finalize(self, seq: int, tree: dict, meta: dict, is_best: bool):
        name = f"ckpt-{seq:08d}"
        final = os.path.join(self.directory, name)
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{name}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # a failure before the os.replace leaves the temp dir behind, as
        # a crash would: invisible to restore, swept by the next saver
        tree = _contiguous(tree)
        np.savez(os.path.join(tmp, STATE_FILE), **convert.flatten(tree))
        faultinject.crash_point("after_write")
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(jsonfinite(meta), f, indent=1, allow_nan=False)
        # the manifest LAST: it is the commit marker
        write_manifest(tmp, tree_manifest(tree))
        faultinject.crash_point("before_commit")
        os.replace(tmp, final)
        faultinject.crash_point("after_commit")
        if is_best:
            self._point_best(name, meta)
        self._apply_retention()

    def _point_best(self, name: str, meta: dict):
        pointer = os.path.join(self.directory, _BEST_POINTER)
        tmp = pointer + ".tmp"
        with open(tmp, "w") as f:
            json.dump(jsonfinite({"save": name, "meta": meta}), f, indent=1,
                      allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, pointer)

    def _apply_retention(self):
        if self.keep <= 0:
            return
        saves = self._committed_saves()
        protected = set(saves[: self.keep])
        best = self._best_target()
        if best:
            protected.add(best)
        for name in saves[self.keep:]:
            if name not in protected:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def wait(self):
        """Block until every dispatched save committed; raise the first
        finalizer failure (later ones are dropped: almost always the same
        root cause repeating)."""
        self._jobs.join()
        if self._errors:
            err = self._errors[0]
            self._errors.clear()
            raise err

    # ---- restore path ----

    def _verified_restore(self, name: str, check: Callable):
        """(tree, meta) of one candidate: its state.npz loaded and held to
        its manifest, ``check(tree)`` passed, its meta read and
        non-empty."""
        d = os.path.join(self.directory, name)
        manifest = read_manifest(d)
        if manifest is None:
            raise RuntimeError(
                "integrity manifest missing (uncommitted save?)")
        tree = load_tree(os.path.join(d, STATE_FILE))
        verify_tree(tree, manifest)
        check(tree)
        meta_path = os.path.join(d, META_FILE)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint meta unreadable ({meta_path}): {e} — refusing "
                f"to resume blind (a silent epoch-0 restart would retrain "
                f"over the checkpoint)") from None
        if not isinstance(meta, dict) or not meta:
            raise RuntimeError(
                f"checkpoint meta empty ({meta_path}) — refusing to resume "
                f"blind")
        return tree, meta

    def _restore_chain(self, tag: str, check: Callable):
        """Walk the fallback chain -> (tree, meta)."""
        self.wait()
        self.last_restore_report = []
        chain = self._candidates(tag)
        for i, name in enumerate(chain):
            try:
                tree, meta = self._verified_restore(name, check)
            except Exception as e:  # noqa: BLE001 — chain to the next one
                msg = f"{name}: {type(e).__name__}: {e}"
                self.last_restore_report.append(msg)
                self._log(f"checkpoint restore: skipping {msg}")
                continue
            if i > 0:
                self._log(f"checkpoint restore: fell back to {name} ({i} "
                          f"newer candidate(s) skipped — see above)")
            self.last_restored = name
            return tree, meta
        raise CheckpointRestoreError(tag, self.last_restore_report)

    def restore(self, state, tag: str = _LATEST) -> tuple:
        """Restore into the TrainState ``state`` (in place: model,
        optimizer with its ``count``, normalizer; a captured graph keeps
        its addresses, so a rollback mid-``fit`` captures nothing) ->
        (state, meta). Falls back newest -> older -> best; raises
        ``CheckpointRestoreError`` when the chain is exhausted."""
        loaded = {}

        def check(tree):  # both raise on a tree the state cannot take
            loaded["model"] = _model_state_dict(tree, state.model)
            loaded["optimizer"] = _optimizer_state_dict(tree, state)

        tree, meta = self._restore_chain(tag, check)
        state.model.load_state_dict(loaded["model"])
        state.optimizer.inner.load_state_dict(loaded["optimizer"])
        state.optimizer.count = int(tree["opt_state"]["count"])
        for i, g in enumerate(state_generators(state)):
            saved = tree.get("rng", {}).get(f"gen{i}")
            if saved is not None:
                g.set_state(torch.from_numpy(np.array(saved, np.uint8)))
        norm = _normalizer(tree, state.normalizer.mean.device)
        state.normalizer.mean.copy_(norm.mean)
        state.normalizer.std.copy_(norm.std)
        return state, meta

    def restore_for_inference(self, state, tag: str = _LATEST):
        """Restore parameters, BatchNorm statistics and the normalizer
        only, into ``state`` (anything with ``model`` and ``normalizer``:
        an InferenceState or a TrainState) -> state. In place, the
        normalizer too: a captured predict graph reads its mean and std
        by address."""
        loaded = {}

        def check(tree):
            loaded["model"] = _model_state_dict(tree, state.model)
            norm = tree["normalizer"]
            for k in ("mean", "std"):
                want = tuple(getattr(state.normalizer, k).shape)
                if np.shape(norm[k]) != want:
                    raise ValueError(f"normalizer {k} has shape "
                                     f"{np.shape(norm[k])}, want {want}")

        tree, _ = self._restore_chain(tag, check)
        state.model.load_state_dict(loaded["model"])
        norm = _normalizer(tree, state.normalizer.mean.device)
        with torch.no_grad():
            state.normalizer.mean.copy_(norm.mean)
            state.normalizer.std.copy_(norm.std)
        return state

    def close(self):
        try:
            self.wait()
        finally:
            if self._worker is not None and self._worker.is_alive():
                self._jobs.put(None)
                self._worker.join(timeout=30)


def inference_state(meta: dict, device):
    """An InferenceState for the model ``meta`` describes, on ``device``,
    with an identity normalizer. Inference admits any structure that fits
    its ladder, so training-set-derived bounds are widened
    (``for_arbitrary_inputs``)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.step import InferenceState

    model_cfg = ModelConfig.from_meta(meta["model"]).for_arbitrary_inputs()
    model = build_model(model_cfg, DataConfig.from_meta(meta["data"]),
                        device=device, task=meta.get("task", "regression"))
    return InferenceState(model, Normalizer.identity(model_cfg.num_targets,
                                                     device=device))


def load_for_inference(directory: str, tag: str = _LATEST, device="cuda"):
    """(InferenceState, meta, version) from a checkpoint directory: the
    model its meta describes (``inference_state``) with ``tag``'s weights
    and normalizer restored and verified; the version is the save the
    chain actually loaded (it can fall back past a corrupt newest one).
    Raises FileNotFoundError when ``tag`` has no checkpoint."""
    mgr = CheckpointManager(directory)
    try:
        if not mgr.exists(tag):
            raise FileNotFoundError(
                f"no {tag!r} checkpoint under {directory}")
        meta = mgr.read_meta(tag)
        state = mgr.restore_for_inference(inference_state(meta, device), tag)
        return state, meta, mgr.last_restored or tag
    finally:
        mgr.close()


def _normalizer(tree, device) -> Normalizer:
    return Normalizer.from_arrays(tree["normalizer"]["mean"],
                                  tree["normalizer"]["std"], device=device)
