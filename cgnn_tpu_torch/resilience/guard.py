"""Divergence recovery (``cgnn_tpu/resilience/guard.py``): skip bad
updates on the device, roll back on a blow-up.

**The in-graph skip** (``guard_step``) wraps the port's train body
(``(state, batch) -> metric sums``, train/step.py). Before the body it
copies every tensor a step writes (parameters, BatchNorm buffers, the
optimizer's buffers and its device count) into a shadow buffer made at
the first call, which is a graph's eager warm-up run, so a capture
holds its address. After the update it checks that the new parameters
and BatchNorm statistics and the step's ``loss_sum`` are all finite,
and writes the state back as ``torch.where(ok, new, old)``, the
floating tensors through one flat buffer (a few launches, not one a
tensor): device ops only, with no host read, so the select is captured
inside the replayed CUDA graph (train/graphs.py). When nothing fires the select
is the identity and the trajectory is bit-equal to the unguarded one. A
skipped step leaves the device count where it was, zeroes its metric
sums and counts (``torch.where``, not a multiply: NaN * 0 is NaN) and
reports ``guard_skipped_sum`` (1 - ok) and ``guard_skipped_count`` (1)
through ``DeviceSums``. The host mirror of the count, which a replay
raises by one whatever the step did, is settled at the epoch's one fetch
(train/loop.py ``settle_count``).

**The data-parallel guard** (``StepGuard``, the JAX
``make_parallel_train_step(guard=True)``): the data-parallel step
(parallel/data_parallel.py) saves the shadow before its forward and
selects after the collective and the update, on the averaged parameters
and BatchNorm statistics and the loss summed over the ranks, so a NaN on
any rank makes every rank skip the same step and the ranks stay
bit-equal. Its ``DivergenceMonitor`` reads the checkpoint through
``data_parallel.CoordinatedCheckpoint``: process 0 restores from its own
save and every rank takes the restored state from it by broadcast.

**The host rollback** (``DivergenceMonitor``) watches each epoch's skip
count. When ``max_skips`` or more steps of an epoch were skipped, or the
epoch's loss is not finite, it restores the last good checkpoint through
``CheckpointManager.restore`` (in place: the graphs keep their
addresses), cuts the learning rate and goes on, at most
``max_rollbacks`` times (then ``DivergenceError``).

The cut is ``Optimizer.scale_lr``: it rewrites the device rate table in
place, so no graph is captured again. The JAX package wraps the
optimizer in ``scale_updates``, which multiplies the update optax emits
by the factor f. Scaling the rate instead gives the same update up to
f32 round-off for every optimizer the port has, because the rate
multiplies the whole update in each: SGD with momentum steps
p -= lr * buf (the buffer does not see the rate), Adam p -= lr * m̂ /
(√v̂ + eps) (the moments do not see it), and AdamW adds the decoupled
decay p *= 1 - lr * wd, which takes the cut rate as well, as optax
scales AdamW's whole update, decay included. The optimizer's state is
untouched, so checkpoints before and after a cut restore alike.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable

import torch


class DivergenceError(RuntimeError):
    """Training diverged and the bounded rollback retries are spent."""


class _Shadow:
    """The tensors a train step of one state writes, and their copy from
    before the step in one flat buffer: the floating tensors (the
    parameters and BatchNorm statistics first, the ones the finiteness
    check reads, then the optimizer's buffers) are copied in and selected
    back with a handful of launches whatever their number; the rest (the
    device count) one by one."""

    def __init__(self, state):
        model = state.model
        checked = list(model.parameters()) + [
            b for b in model.buffers() if b.is_floating_point()]
        rest = ([b for b in model.buffers() if not b.is_floating_point()]
                + state.optimizer.tensors())
        self.flat = checked + [t for t in rest if t.is_floating_point()]
        self.other = [t for t in rest if not t.is_floating_point()]
        self.n_checked = sum(t.numel() for t in checked)
        self.sizes = [t.numel() for t in self.flat]
        with torch.no_grad():
            self.old = self.flat[0].new_empty(sum(self.sizes))
            self.old_other = [torch.empty_like(t) for t in self.other]

    @torch.no_grad()
    def save(self) -> None:
        torch.cat([t.reshape(-1) for t in self.flat], out=self.old)
        for t, old in zip(self.other, self.old_other):
            old.copy_(t)

    @torch.no_grad()
    def select(self, loss_sum) -> torch.Tensor:
        """Keep the step where the checked tensors and the loss are all
        finite, else put the old state back -> that verdict (0-d bool, on
        the device)."""
        new = torch.cat([t.reshape(-1) for t in self.flat])
        ok = torch.isfinite(new[: self.n_checked]).all()
        if loss_sum is not None:
            ok = ok & torch.isfinite(loss_sum.float())
        kept = torch.where(ok, new, self.old)
        torch._foreach_copy_(self.flat, [
            v.view(t.shape) for v, t in zip(kept.split(self.sizes),
                                            self.flat)])
        for t, old in zip(self.other, self.old_other):
            torch.where(ok, t, old, out=t)
        return ok


class StepGuard:
    """The in-graph skip in two halves, for a step split around a
    collective (the data-parallel step, parallel/data_parallel.py):
    ``save(state)`` before the step writes anything, ``select(state,
    metrics)`` after its update -> the guarded metric sums. Taken after
    the collective, the verdict reads the averaged parameters and
    statistics and the summed ``loss_sum``, so every rank keeps or skips
    the same step."""

    def __init__(self):
        self._shadows: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def save(self, state) -> None:
        shadow = self._shadows.get(state.optimizer)
        if shadow is None:
            shadow = self._shadows[state.optimizer] = _Shadow(state)
        shadow.save()

    def select(self, state, metrics: dict) -> dict:
        ok = self._shadows[state.optimizer].select(metrics.get("loss_sum"))
        out = {k: torch.where(ok, v, 0.0) for k, v in metrics.items()}
        okf = ok.to(torch.float32)
        out["guard_skipped_sum"] = 1.0 - okf
        out["guard_skipped_count"] = torch.ones_like(okf)
        return out


def guard_step(body: Callable) -> Callable:
    """Wrap a train body so non-finite updates are skipped on the device
    (module docstring)."""
    guard = StepGuard()

    def guarded(state, batch) -> dict:
        guard.save(state)
        return guard.select(state, body(state, batch))

    return guarded


def skipped_steps(train_m: dict) -> int:
    """The steps an epoch's guard skipped, from its metric means."""
    return round(train_m.get("guard_skipped", 0.0) * train_m.get("steps", 0))


class DivergenceMonitor:
    """Epoch-level watchdog: rollback with an LR cut on sustained
    divergence (module docstring).

    ``observe(state, epoch, train_m) -> (state, rolled_back)`` is called
    once an epoch by ``fit`` with the epoch's train metric means. An
    epoch is bad when its loss is not finite (the guard off or
    overwhelmed) or when ``max_skips`` or more of its steps were skipped.
    ``on_rollback(reason)`` runs after every rollback (an incident hook,
    whose failure never breaks the recovery)."""

    def __init__(self, ckpt, max_skips: int = 3, lr_cut: float = 0.5,
                 max_rollbacks: int = 3, log_fn: Callable = print):
        if max_skips < 1:
            raise ValueError(f"max_skips must be >= 1, got {max_skips}")
        if not 0.0 < lr_cut < 1.0:
            raise ValueError(f"lr_cut must be in (0, 1), got {lr_cut}")
        self.ckpt = ckpt
        self.max_skips = max_skips
        self.lr_cut = lr_cut
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self.lr_scale = 1.0
        self._log = log_fn
        self.on_rollback: Callable | None = None

    def _is_bad(self, train_m: dict) -> tuple[bool, str]:
        loss = train_m.get("loss", float("nan"))
        if not math.isfinite(loss):
            return True, f"non-finite train loss {loss}"
        skipped = skipped_steps(train_m)
        if skipped >= self.max_skips:
            return True, (f"{skipped} steps skipped by the divergence guard "
                          f"(threshold {self.max_skips})")
        return False, ""

    def meta(self) -> dict:
        """Progress to keep in every checkpoint's meta: the cut and the
        retry budget must survive a preemption requeue, or a resumed run
        restarts at the full rate that diverged with a fresh budget (an
        unbounded diverge -> rollback -> preempt loop)."""
        return {"guard_lr_scale": self.lr_scale,
                "guard_rollbacks": self.rollbacks}

    def resume_from_meta(self, state, meta: dict):
        """Reapply the kept progress after a resume (the inverse of
        ``meta()``) -> state, its rate table cut in place when a cut was
        active."""
        self.rollbacks = int(meta.get("guard_rollbacks", 0))
        scale = float(meta.get("guard_lr_scale", 1.0))
        if scale >= 1.0:
            return state
        self.lr_scale = scale
        state.optimizer.scale_lr(scale)
        self._log(f"divergence guard: resumed with lr x{scale:g} and "
                  f"{self.rollbacks}/{self.max_rollbacks} rollbacks spent")
        return state

    def observe(self, state, epoch: int, train_m: dict):
        bad, why = self._is_bad(train_m)
        if not bad:
            return state, False
        if self.rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f"epoch {epoch}: {why}; {self.rollbacks} rollbacks already "
                f"spent (max {self.max_rollbacks}) — giving up")
        # saves commit on the manager's finalizer thread: a save made at
        # the last epoch's end may not be on disk yet, and on a card an
        # epoch can outrun its commit
        self.ckpt.wait()
        if not self.ckpt.exists("latest"):
            self._log(f"divergence guard: epoch {epoch} diverged ({why}) but "
                      f"no checkpoint exists yet to roll back to — "
                      f"continuing")
            return state, False
        restored, meta = self.ckpt.restore(state)
        self.rollbacks += 1
        self.lr_scale *= self.lr_cut
        restored.optimizer.scale_lr(self.lr_cut)
        self._log(f"divergence guard: epoch {epoch} diverged ({why}) — "
                  f"rolled back to checkpoint epoch {meta.get('epoch', '?')} "
                  f"with lr x{self.lr_scale:g} (rollback {self.rollbacks}/"
                  f"{self.max_rollbacks})")
        if self.on_rollback is not None:
            try:
                self.on_rollback(f"epoch {epoch}: {why}")
            except Exception:  # noqa: BLE001 — an incident hook must
                pass           # never break the recovery it records
        return restored, True


@contextlib.contextmanager
def debug_nans(model: torch.nn.Module):
    """Fail fast at the first NaN (``--debug-nans``): eager steps only (a
    captured graph cannot stop mid-replay). Every module's forward output
    is checked, and the first that is not finite raises
    ``FloatingPointError`` naming the module; the backward runs under
    ``torch.autograd.detect_anomaly(check_nan=True)``, which names the
    backward op that made a NaN and the forward call that recorded it."""

    def hook_for(name):
        def hook(module, inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for o in outs:
                if (isinstance(o, torch.Tensor) and o.is_floating_point()
                        and not bool(torch.isfinite(o).all())):
                    raise FloatingPointError(
                        f"--debug-nans: non-finite output of module "
                        f"{name or type(module).__name__!r} "
                        f"({type(module).__name__})")
        return hook

    handles = [m.register_forward_hook(hook_for(n))
               for n, m in model.named_modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()
