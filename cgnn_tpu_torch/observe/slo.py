"""Declarative SLOs (``cgnn_tpu/observe/slo.py``): error budgets,
multi-window burn rates, and an alert state machine whose firing action
is a flight-recorder trigger.

An ``SLOObjective`` declares what "good" means (availability: the event
succeeded; latency: it succeeded within a threshold) and the target
fraction of good events over an accounting window; the error BUDGET is
the allowed bad fraction (1 - target). The BURN RATE over a window is

    burn = (bad / total over the window) / (1 - target)

A ``BurnRateRule`` pairs a FAST window with a SLOW one: the alert holds
only while both burn above ``factor``. Per (objective, rule) the engine
runs ``inactive -> pending -> firing -> resolved`` (``for_s`` is the
pending hold; a resolved alert re-arms). The firing transition calls
``on_fire``, which the server wires to ``FlightRecorder.trigger(
"slo_burn_<objective>", ...)``.

Events aggregate into per-second buckets an objective (bounded by the
longest window, not by traffic), so recording is O(1). Host-side only;
injectable clock; thread-safe.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Callable

# the classic fast/slow pairs (Google SRE workbook ch. 5), scaled to a
# 1h budget window by default; smoke tests inject seconds-scale rules
DEFAULT_RULES = None  # sentinel: SLOEngine builds from the objectives


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """What "good" means and how much of it we promise.

    ``latency_threshold_ms`` None -> availability objective (good =
    the event succeeded); set -> latency objective (good = succeeded
    AND answered within the threshold). ``window_s`` is the error-
    budget accounting window. ``klass`` scopes the objective to one
    priority class: only events recorded with a matching
    ``klass`` feed its windows — None keeps the legacy behavior (the
    objective sees every event, whatever its class).
    """

    name: str
    target: float
    latency_threshold_ms: float | None = None
    window_s: float = 3600.0
    klass: str | None = None

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target} "
                f"(a target of 1.0 has zero budget: any error is an "
                f"instant page, which is not an SLO, it is an alarm)"
            )
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0: {self.window_s}")
        if (self.latency_threshold_ms is not None
                and self.latency_threshold_ms <= 0):
            raise ValueError(
                f"latency_threshold_ms must be > 0: "
                f"{self.latency_threshold_ms}"
            )

    def good(self, ok: bool, latency_ms: float | None) -> bool:
        if self.latency_threshold_ms is None:
            return bool(ok)
        return bool(ok) and (latency_ms is not None
                             and latency_ms <= self.latency_threshold_ms)


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Fire while burn(fast) > factor AND burn(slow) > factor, held
    for ``for_s``."""

    fast_s: float
    slow_s: float
    factor: float
    for_s: float = 0.0

    def __post_init__(self):
        if not 0 < self.fast_s <= self.slow_s:
            raise ValueError(
                f"need 0 < fast_s <= slow_s, got {self.fast_s}/"
                f"{self.slow_s}"
            )
        if self.factor <= 0 or self.for_s < 0:
            raise ValueError(
                f"bad rule: factor={self.factor}, for_s={self.for_s}"
            )

    @property
    def key(self) -> str:
        return f"{self.fast_s:g}s_{self.slow_s:g}s_x{self.factor:g}"


def default_rules(window_s: float) -> tuple:
    """The two standard pairs scaled to the accounting window: a page
    rule (fast spend, 5%-of-window fast window) and a warn rule (slower
    spend, longer windows)."""
    return (
        BurnRateRule(fast_s=max(window_s / 12.0, 1.0),
                     slow_s=window_s, factor=14.4,
                     for_s=max(window_s / 60.0, 0.0)),
        BurnRateRule(fast_s=max(window_s / 4.0, 1.0),
                     slow_s=window_s, factor=6.0,
                     for_s=max(window_s / 24.0, 0.0)),
    )


class _Window:
    """Per-second (good, total) buckets, bounded by the horizon."""

    def __init__(self, horizon_s: float):
        self.horizon = int(math.ceil(horizon_s)) + 1
        self._buckets: collections.deque = collections.deque()
        # (t_sec, good, total); newest last

    def record(self, t: float, good: bool) -> None:
        sec = int(t)
        if self._buckets and self._buckets[-1][0] == sec:
            ts, g, n = self._buckets[-1]
            self._buckets[-1] = (ts, g + int(good), n + 1)
        else:
            self._buckets.append((sec, int(good), 1))
        cutoff = sec - self.horizon
        while self._buckets and self._buckets[0][0] < cutoff:
            self._buckets.popleft()

    def totals(self, now: float, window_s: float) -> tuple:
        """(good, total) over the trailing window at ``now``."""
        cutoff = now - window_s
        good = total = 0
        for ts, g, n in reversed(self._buckets):
            if ts < cutoff:
                break
            good += g
            total += n
        return good, total


class SLOEngine:
    """Feed it events, evaluate periodically, read alerts/budgets.

    ``record(ok, latency_ms)`` is the per-event feed (attempt-level at
    the router — retries hide errors from clients, they must NOT hide
    them from the budget; response-level on a replica).
    ``evaluate()`` advances every (objective, rule) state machine and
    returns the transitions it made. ``on_fire``/``on_resolve`` run
    OUTSIDE the engine lock (a flight-recorder dump must never block
    recording).
    """

    def __init__(self, objectives, rules=DEFAULT_RULES,
                 clock: Callable[[], float] = time.monotonic,
                 on_fire: Callable[[dict], None] | None = None,
                 on_resolve: Callable[[dict], None] | None = None,
                 max_transitions: int = 256):
        self.objectives = tuple(objectives)
        if not self.objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self._rules = {}
        for obj in self.objectives:
            obj_rules = (default_rules(obj.window_s) if rules is None
                         else tuple(rules))
            self._rules[obj.name] = obj_rules
        self._clock = clock
        self.on_fire = on_fire
        self.on_resolve = on_resolve
        self._lock = threading.Lock()
        horizon = {
            o.name: max([o.window_s]
                        + [r.slow_s for r in self._rules[o.name]])
            for o in self.objectives
        }
        self._windows = {o.name: _Window(horizon[o.name])
                         for o in self.objectives}
        # (objective, rule.key) -> {"state", "since", ...}
        self._alerts = {
            (o.name, r.key): {"state": "inactive", "since": None,
                              "fired_at": None, "resolved_at": None,
                              "fire_count": 0}
            for o in self.objectives for r in self._rules[o.name]
        }
        self.transitions: collections.deque = collections.deque(
            maxlen=max_transitions)
        self.events = 0

    # ---- feed ----

    def record(self, ok: bool, latency_ms: float | None = None,
               now: float | None = None,
               klass: str | None = None) -> None:
        """One event into every objective it scopes to: class-agnostic
        objectives (``obj.klass`` None) see all events; class-scoped
        ones see only their class. An event with no class
        feeds the class-agnostic objectives alone."""
        now = self._clock() if now is None else now
        with self._lock:
            self.events += 1
            for obj in self.objectives:
                if obj.klass is not None and obj.klass != klass:
                    continue
                self._windows[obj.name].record(
                    now, obj.good(ok, latency_ms))

    def note_status(self, status: int, latency_ms: float | None = None,
                    now: float | None = None) -> None:
        """HTTP feed: 5xx burns budget, everything else is good — a
        429/400 is the server protecting itself or the client's fault,
        not an availability failure."""
        self.record(int(status) < 500, latency_ms, now)

    # ---- evaluation ----

    def burn_rate(self, objective: str, window_s: float,
                  now: float | None = None) -> float:
        now = self._clock() if now is None else now
        obj = self._objective(objective)
        with self._lock:
            good, total = self._windows[objective].totals(now, window_s)
        if total == 0:
            return 0.0
        bad_rate = (total - good) / total
        return bad_rate / (1.0 - obj.target)

    def budget(self, objective: str, now: float | None = None) -> dict:
        """Error-budget accounting over the objective's window."""
        now = self._clock() if now is None else now
        obj = self._objective(objective)
        with self._lock:
            good, total = self._windows[objective].totals(
                now, obj.window_s)
        bad = total - good
        allowed = (1.0 - obj.target) * total
        return {
            "window_s": obj.window_s,
            "total": total,
            "bad": bad,
            "allowed": allowed,
            "remaining_frac": (1.0 - bad / allowed) if allowed > 0
            else 1.0,
        }

    def evaluate(self, now: float | None = None) -> list:
        """Advance every state machine; returns the transitions made,
        each ``{"t", "objective", "rule", "from", "to", ...}``. Fire/
        resolve hooks run after the lock is released."""
        now = self._clock() if now is None else now
        made: list = []
        hooks: list = []
        with self._lock:
            for obj in self.objectives:
                for rule in self._rules[obj.name]:
                    a = self._alerts[(obj.name, rule.key)]
                    fast = self._burn_locked(obj, rule.fast_s, now)
                    slow = self._burn_locked(obj, rule.slow_s, now)
                    cond = fast > rule.factor and slow > rule.factor
                    state = a["state"]
                    if state in ("inactive", "resolved") and cond:
                        self._move(a, obj, rule, "pending", now, made,
                                   fast, slow)
                        a["since"] = now
                        state = "pending"
                    if state == "pending":
                        if not cond:
                            self._move(a, obj, rule, "inactive", now,
                                       made, fast, slow)
                        elif now - a["since"] >= rule.for_s:
                            self._move(a, obj, rule, "firing", now,
                                       made, fast, slow)
                            a["fired_at"] = now
                            a["fire_count"] += 1
                            hooks.append(("fire", made[-1]))
                    elif state == "firing" and not cond:
                        self._move(a, obj, rule, "resolved", now, made,
                                   fast, slow)
                        a["resolved_at"] = now
                        hooks.append(("resolve", made[-1]))
        for kind, transition in hooks:
            cb = self.on_fire if kind == "fire" else self.on_resolve
            if cb is not None:
                try:
                    cb(transition)
                except Exception:  # noqa: BLE001 — a broken hook must
                    pass           # not stop alert evaluation

        return made

    def _burn_locked(self, obj, window_s: float, now: float) -> float:
        good, total = self._windows[obj.name].totals(now, window_s)
        if total == 0:
            return 0.0
        return ((total - good) / total) / (1.0 - obj.target)

    def _move(self, a, obj, rule, to: str, now: float, made: list,
              fast: float, slow: float) -> None:
        made.append({
            "t": now, "objective": obj.name, "rule": rule.key,
            "from": a["state"], "to": to,
            "burn_fast": round(fast, 4), "burn_slow": round(slow, 4),
            "factor": rule.factor,
        })
        a["state"] = to
        self.transitions.append(made[-1])

    # ---- views ----

    def _objective(self, name: str) -> SLOObjective:
        for o in self.objectives:
            if o.name == name:
                return o
        raise KeyError(f"unknown objective {name!r} "
                       f"(have: {[o.name for o in self.objectives]})")

    def alerts(self) -> dict:
        """{objective: {rule_key: alert-state dict}} (copies)."""
        with self._lock:
            out: dict = {}
            for (obj, key), a in self._alerts.items():
                out.setdefault(obj, {})[key] = dict(a)
            return out

    def firing(self) -> list:
        with self._lock:
            return [{"objective": obj, "rule": key, **a}
                    for (obj, key), a in self._alerts.items()
                    if a["state"] == "firing"]

    def state(self, now: float | None = None) -> dict:
        """The /stats view: per objective, budget + burn per rule +
        alert states; plus the transition history tail."""
        now = self._clock() if now is None else now
        with self._lock:
            out = {"objectives": {}, "events": self.events,
                   "transitions": list(self.transitions)}
        for obj in self.objectives:
            rules = {}
            for rule in self._rules[obj.name]:
                a = self.alerts()[obj.name][rule.key]
                rules[rule.key] = {
                    "fast_s": rule.fast_s, "slow_s": rule.slow_s,
                    "factor": rule.factor, "for_s": rule.for_s,
                    "burn_fast": self.burn_rate(obj.name, rule.fast_s,
                                                now),
                    "burn_slow": self.burn_rate(obj.name, rule.slow_s,
                                                now),
                    **a,
                }
            out["objectives"][obj.name] = {
                "target": obj.target,
                "latency_threshold_ms": obj.latency_threshold_ms,
                "budget": self.budget(obj.name, now),
                "rules": rules,
            }
        return out

    def gauges(self) -> dict:
        """Registry-provider gauges: budget remaining + worst burn per
        objective + the count of alerts currently firing."""
        out = {"slo_alerts_firing": float(len(self.firing()))}
        for obj in self.objectives:
            b = self.budget(obj.name)
            out[f"slo_{obj.name}_budget_remaining"] = b["remaining_frac"]
            burns = [self.burn_rate(obj.name, r.fast_s)
                     for r in self._rules[obj.name]]
            out[f"slo_{obj.name}_burn_fast"] = max(burns) if burns else 0.0
        return out
