"""Deterministic fault injection (``cgnn_tpu/resilience/faultinject.py``):
the training and checkpoint half.

Faults are declared in the ``CGNN_TPU_FAULTS`` environment variable (or
with ``set_plan``) as ``;``-separated ``key=value`` pairs, in the JAX
package's grammar, so one spec string drives either trainer. They fire
at exact, countable points:

- ``nan_batch=N``: poison the N-th (0-based) training batch of the run
  with NaN targets (and NaN node features where the nodes are floats),
  before pack-once or device-resident staging takes it, so a staged
  stack carries it and the divergence guard meets it every epoch;
- ``sigterm_epoch=N``: deliver SIGTERM to this process at the end of
  epoch N;
- ``crash=POINT:N``: raise ``InjectedCrash`` at the N-th (1-based) hit
  of a checkpoint crash point (``after_write``, ``before_commit``,
  ``after_commit`` in the checkpoint finalizer); ``crash=POINT:N:exit``
  dies with ``os._exit(137)`` instead, which the filesystem cannot tell
  from ``kill -9``;
- ``loader_exc=N``: raise ``InjectedLoaderError`` in place of the N-th
  training batch.

The serving keys, counted over the serving worker's flush dispatches
and the HTTP front door (``python -m cgnn_tpu_torch.serve``):

- ``dispatch_exc=N[:COUNT]``: raise ``InjectedDispatchError`` at the
  N-th (0-based) flush dispatch, or at each of ``[N, N+COUNT)``: that
  flush fails alone, its clients get a 500;
- ``wedge_flush=N[:SECS]``: stall the N-th dispatch SECS seconds
  (default 600), the case the bounded ``--drain-timeout`` exit 3 is for;
- ``slow_dispatch=MS[:EVERY]``: add MS ms to every EVERY-th dispatch;
- ``drop_conn=N``: close every N-th ``/predict`` connection unanswered;
- ``boot_crash=N``: ``os._exit(7)`` between the listener's bind and
  ``warm()`` for the first N boots (counted across processes in the file
  ``CGNN_TPU_FAULT_STATE`` names; without it every boot crashes);
  ``wedge_warm[=SECS]``: hang there instead;
- ``exit75_at=N``: SIGTERM this process at the N-th dispatch; after the
  drain the entry point exits 75.

The continual trainer's ``label_noise`` parses and describes as in the
JAX package; its hook is not ported (ROADMAP Queue 1, item 12), and
``unported_keys`` names it when a plan sets it.

Without a plan every hook is a cheap no-op: ``plan()`` is None and
iterators are returned unwrapped. ``corrupt_checkpoint`` damages a
committed save in place, the way disk faults present, to drive the
restore fallback chain.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Iterable, Iterator

import torch

ENV_VAR = "CGNN_TPU_FAULTS"
# the file whose size counts boots across processes (``boot_crash``: a
# crashed boot keeps no state of its own)
STATE_ENV = "CGNN_TPU_FAULT_STATE"
# serving counters are bumped from several threads (HTTP handlers)
_serve_lock = threading.Lock()


class InjectedCrash(RuntimeError):
    """A crash point fired (a simulated death mid-save)."""


class InjectedLoaderError(RuntimeError):
    """An injected data-loader failure."""


class InjectedDispatchError(RuntimeError):
    """An injected serving dispatch failure."""


@dataclasses.dataclass
class FaultPlan:
    nan_batch: int | None = None
    sigterm_epoch: int | None = None
    crash_point: str | None = None
    crash_hit: int = 1
    crash_exit: bool = False
    loader_exc: int | None = None
    # serving faults
    dispatch_exc: int | None = None
    dispatch_exc_count: int = 1
    wedge_flush: int | None = None
    wedge_secs: float = 600.0
    slow_dispatch_ms: float | None = None
    slow_every: int = 1
    drop_conn: int | None = None
    boot_crash: int | None = None
    wedge_warm: float | None = None
    exit75_at: int | None = None
    # the continual trainer's fault: parsed, its hook not ported
    label_noise_round: int | None = None
    label_noise_scale: float = 10.0
    # the hit counters (the determinism bookkeeping)
    _crash_hits: dict = dataclasses.field(default_factory=dict)
    _batches_seen: int = 0
    _sigterm_fired: bool = False
    _dispatches_seen: int = 0
    _conns_seen: int = 0
    _exit75_fired: bool = False

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            key, _, value = part.partition("=")
            fields = value.split(":")
            given = len(fields) > 1 and fields[1]
            if key == "nan_batch":
                plan.nan_batch = int(value)
            elif key == "sigterm_epoch":
                plan.sigterm_epoch = int(value)
            elif key == "loader_exc":
                plan.loader_exc = int(value)
            elif key == "crash":
                plan.crash_point = fields[0]
                if given:
                    plan.crash_hit = int(fields[1])
                plan.crash_exit = len(fields) > 2 and fields[2] == "exit"
            elif key == "dispatch_exc":
                plan.dispatch_exc = int(fields[0])
                if given:
                    plan.dispatch_exc_count = max(1, int(fields[1]))
            elif key == "wedge_flush":
                plan.wedge_flush = int(fields[0])
                if given:
                    plan.wedge_secs = float(fields[1])
            elif key == "slow_dispatch":
                plan.slow_dispatch_ms = float(fields[0])
                if given:
                    plan.slow_every = max(1, int(fields[1]))
            elif key == "drop_conn":
                plan.drop_conn = int(value)
            elif key == "boot_crash":
                plan.boot_crash = int(value)
            elif key == "wedge_warm":
                plan.wedge_warm = float(value) if value else 600.0
            elif key == "exit75_at":
                plan.exit75_at = int(value)
            elif key == "label_noise":
                plan.label_noise_round = int(fields[0])
                if given:
                    plan.label_noise_scale = float(fields[1])
            else:
                raise ValueError(
                    f"unknown fault key {key!r} in {ENV_VAR}={spec!r}")
        return plan

    def describe(self) -> str:
        parts = []
        if self.nan_batch is not None:
            parts.append(f"NaN batch @{self.nan_batch}")
        if self.sigterm_epoch is not None:
            parts.append(f"SIGTERM @epoch {self.sigterm_epoch}")
        if self.crash_point is not None:
            how = "os._exit(137)" if self.crash_exit else "InjectedCrash"
            parts.append(f"{how} @{self.crash_point} hit {self.crash_hit}")
        if self.loader_exc is not None:
            parts.append(f"loader exception @batch {self.loader_exc}")
        if self.dispatch_exc is not None:
            if self.dispatch_exc_count > 1:
                parts.append(
                    f"dispatch exceptions @flushes {self.dispatch_exc}.."
                    f"{self.dispatch_exc + self.dispatch_exc_count - 1}")
            else:
                parts.append(f"dispatch exception @flush {self.dispatch_exc}")
        if self.wedge_flush is not None:
            parts.append(
                f"wedge @flush {self.wedge_flush} ({self.wedge_secs:g} s)")
        if self.slow_dispatch_ms is not None:
            parts.append(f"+{self.slow_dispatch_ms:g} ms every "
                         f"{self.slow_every} dispatch(es)")
        if self.drop_conn is not None:
            parts.append(f"drop every {self.drop_conn}th connection")
        if self.boot_crash is not None:
            parts.append(f"crash first {self.boot_crash} boot(s)")
        if self.wedge_warm is not None:
            parts.append(f"wedge warm() ({self.wedge_warm:g} s)")
        if self.exit75_at is not None:
            parts.append(f"preempt (exit 75) @flush {self.exit75_at}")
        if self.label_noise_round is not None:
            parts.append(f"label shift +{self.label_noise_scale:g} "
                         f"@fine-tune round {self.label_noise_round}")
        return ", ".join(parts) or "none"


# the keys whose hooks are not ported (the continual trainer's)
_UNPORTED = (("label_noise_round", "label_noise"),)
# the serving keys, which the train entry point does not run
_SERVING = (("dispatch_exc", "dispatch_exc"),
                ("wedge_flush", "wedge_flush"),
                ("slow_dispatch_ms", "slow_dispatch"),
                ("drop_conn", "drop_conn"), ("boot_crash", "boot_crash"),
                ("wedge_warm", "wedge_warm"), ("exit75_at", "exit75_at"))


def unported_keys(p: FaultPlan | None) -> list[str]:
    """The spec keys ``p`` sets whose hooks are not ported."""
    return _set_keys(p, _UNPORTED)


def serving_keys(p: FaultPlan | None) -> list[str]:
    """The serving spec keys ``p`` sets (hooks of the serving path)."""
    return _set_keys(p, _SERVING)


def _set_keys(p: FaultPlan | None, table) -> list[str]:
    if p is None:
        return []
    return [key for attr, key in table if getattr(p, attr) is not None]


_plan: FaultPlan | None = None
_parsed_env: str | None = None


def set_plan(p: FaultPlan | None) -> None:
    """Install a plan programmatically (tests); None clears it and
    parses the environment variable again (a sticky override would
    silently disable every later configured fault in the process)."""
    global _plan, _parsed_env
    _plan = p
    _parsed_env = "<programmatic>" if p is not None else None


def plan() -> FaultPlan | None:
    """The active plan (parsed from the environment once), or None."""
    global _plan, _parsed_env
    if _parsed_env == "<programmatic>":
        return _plan
    spec = os.environ.get(ENV_VAR, "")
    if spec != _parsed_env:
        _parsed_env = spec
        _plan = FaultPlan.parse(spec) if spec else None
    return _plan


def crash_point(name: str) -> None:
    """Die here if the plan says so (the checkpoint finalizer's points)."""
    p = plan()
    if p is None or p.crash_point != name:
        return
    hits = p._crash_hits.get(name, 0) + 1
    p._crash_hits[name] = hits
    if hits != p.crash_hit:
        return
    if p.crash_exit:
        os._exit(137)  # the kill -9 twin: no cleanup, no atexit, no flush
    raise InjectedCrash(f"injected crash at {name!r} (hit {hits})")


def maybe_sigterm(epoch: int) -> None:
    """Deliver SIGTERM to this process at the configured epoch's end."""
    p = plan()
    if p is None or p.sigterm_epoch != epoch or p._sigterm_fired:
        return
    p._sigterm_fired = True
    os.kill(os.getpid(), signal.SIGTERM)


def poison_nan(batch):
    """The batch with NaN targets, and NaN node features where its nodes
    are floats (a ``CompactBatch`` stages integral vocabulary rows: only
    its targets carry the fault, which is enough for regression)."""
    updates = {"targets": torch.full_like(batch.targets, float("nan"))}
    nodes = getattr(batch, "nodes", None)
    if nodes is not None and nodes.is_floating_point():
        updates["nodes"] = torch.full_like(nodes, float("nan"))
    return dataclasses.replace(batch, **updates)


def poison_batches(batches: Iterable) -> Iterator:
    """A training-batch iterator with the plan's batch faults. Counts
    batches across epochs and iterators (one counter a run), so
    ``nan_batch=N`` lands in a later epoch when N is past the first.
    Returned unwrapped when no batch fault is configured."""
    p = plan()
    if p is None or (p.nan_batch is None and p.loader_exc is None):
        return iter(batches)

    def wrapped():
        for b in batches:
            i = p._batches_seen
            p._batches_seen += 1
            if p.loader_exc is not None and i == p.loader_exc:
                raise InjectedLoaderError(
                    f"injected loader failure at batch {i}")
            yield poison_nan(b) if i == p.nan_batch else b

    return wrapped()


def boot_point() -> None:
    """The boot fault point, between the listener's bind and ``warm()``
    (``python -m cgnn_tpu_torch.serve``): ``boot_crash=N`` appends one
    byte to the ``CGNN_TPU_FAULT_STATE`` file and dies with
    ``os._exit(7)`` while it holds at most N bytes, so the first N boots
    crash; without a state file every boot crashes. ``wedge_warm``
    hangs here."""
    p = plan()
    if p is None or (p.boot_crash is None and p.wedge_warm is None):
        return
    if p.boot_crash is not None:
        state = os.environ.get(STATE_ENV, "")
        boots = p.boot_crash + 1  # no state file: crash every boot
        if state:
            fd = os.open(state, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, b"b")
            finally:
                os.close(fd)
            boots = os.path.getsize(state)
        if boots <= p.boot_crash:
            os._exit(7)  # a death mid-boot: no cleanup, no drain
    if p.wedge_warm is not None:
        time.sleep(p.wedge_warm)


def exit75_requested() -> bool:
    """True once ``exit75_at`` has fired: the serve entry point's clean
    drain then exits 75 instead of 0."""
    p = plan()
    return p is not None and p._exit75_fired


def dispatch_point() -> None:
    """The serving fault point, called once a flush dispatch by the
    serving worker: counts dispatches over the run and fires the slow,
    wedge, exception and exit-75 faults at their ordinals."""
    p = plan()
    if p is None or (p.dispatch_exc is None and p.wedge_flush is None
                     and p.slow_dispatch_ms is None
                     and p.exit75_at is None):
        return
    with _serve_lock:
        i = p._dispatches_seen
        p._dispatches_seen += 1
        fire75 = (p.exit75_at is not None and i >= p.exit75_at
                  and not p._exit75_fired)
        if fire75:
            p._exit75_fired = True
    if fire75:
        # a preemption notice mid-load: the graceful drain runs, then the
        # entry point exits 75
        os.kill(os.getpid(), signal.SIGTERM)
    if p.slow_dispatch_ms is not None and i % p.slow_every == 0:
        time.sleep(p.slow_dispatch_ms / 1e3)
    if p.wedge_flush is not None and i == p.wedge_flush:
        time.sleep(p.wedge_secs)
    if (p.dispatch_exc is not None
            and p.dispatch_exc <= i < p.dispatch_exc + p.dispatch_exc_count):
        raise InjectedDispatchError(
            f"injected dispatch failure at flush {i}")


def drop_connection() -> bool:
    """True when this ``/predict`` connection is to be closed without a
    response (every N-th, ``drop_conn=N``)."""
    p = plan()
    if p is None or p.drop_conn is None or p.drop_conn < 1:
        return False
    with _serve_lock:
        i = p._conns_seen
        p._conns_seen += 1
    return i % p.drop_conn == p.drop_conn - 1


def corrupt_checkpoint(save_dir: str, mode: str = "garble") -> str:
    """Corrupt a committed save in place -> the damaged file.

    ``garble`` flips the bits of a span in the middle of the largest data
    file (the manifest's crc32 catches it even where loading succeeds);
    ``truncate`` cuts the largest file in half (a load error); ``meta``
    overwrites ``meta.json`` with bytes that are not JSON.
    """
    if mode == "meta":
        path = os.path.join(save_dir, "meta.json")
        with open(path, "w") as f:
            f.write("{not json")
        return path
    largest, size = None, -1
    for root, _, files in os.walk(save_dir):
        for name in files:
            if name in ("meta.json", "MANIFEST.json"):
                continue
            path = os.path.join(root, name)
            s = os.path.getsize(path)
            if s > size:
                largest, size = path, s
    if largest is None:
        raise FileNotFoundError(f"no data files under {save_dir}")
    if mode == "truncate":
        with open(largest, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "garble":
        with open(largest, "r+b") as f:
            f.seek(size // 2)
            span = f.read(64) or b"\x00"
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in span))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return largest
