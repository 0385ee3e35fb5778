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

The serving and fleet keys (``dispatch_exc``, ``wedge_flush``,
``slow_dispatch``, ``drop_conn``, ``boot_crash``, ``wedge_warm``,
``exit75_at``) and the continual trainer's ``label_noise`` parse and
describe as in the JAX package; their hooks are not ported (ROADMAP
Queue 1, items 11 and 12), and ``unported_keys`` names the ones a plan
sets, so the train entry point says so instead of ignoring them.

Without a plan every hook is a cheap no-op: ``plan()`` is None and
iterators are returned unwrapped. ``corrupt_checkpoint`` damages a
committed save in place, the way disk faults present, to drive the
restore fallback chain.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Iterable, Iterator

import torch

ENV_VAR = "CGNN_TPU_FAULTS"


class InjectedCrash(RuntimeError):
    """A crash point fired (a simulated death mid-save)."""


class InjectedLoaderError(RuntimeError):
    """An injected data-loader failure."""


@dataclasses.dataclass
class FaultPlan:
    nan_batch: int | None = None
    sigterm_epoch: int | None = None
    crash_point: str | None = None
    crash_hit: int = 1
    crash_exit: bool = False
    loader_exc: int | None = None
    # serving and fleet faults: parsed, their hooks not ported
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
    label_noise_round: int | None = None
    label_noise_scale: float = 10.0
    # the hit counters (the determinism bookkeeping)
    _crash_hits: dict = dataclasses.field(default_factory=dict)
    _batches_seen: int = 0
    _sigterm_fired: bool = False

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


# the keys whose hooks live in the serving, fleet and continual layers
_UNPORTED = (("dispatch_exc", "dispatch_exc"), ("wedge_flush", "wedge_flush"),
             ("slow_dispatch_ms", "slow_dispatch"), ("drop_conn", "drop_conn"),
             ("boot_crash", "boot_crash"), ("wedge_warm", "wedge_warm"),
             ("exit75_at", "exit75_at"), ("label_noise_round", "label_noise"))


def unported_keys(p: FaultPlan | None) -> list[str]:
    """The spec keys ``p`` sets whose hooks are not ported."""
    if p is None:
        return []
    return [key for attr, key in _UNPORTED if getattr(p, attr) is not None]


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
