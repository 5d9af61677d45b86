"""Bounded structured tracer emitting Chrome trace-event JSON.

A copy of the JAX package's ``obs/trace.py``, which is pure Python (this
package imports nothing of the JAX package).  MISO's pitch (paper §IV) is
that dependability is an *observable property of execution*: strikes are
detected, attributed, and repaired at specific cells and ticks.  Every
event lands in one bounded host-side ring buffer and exports as Chrome
trace-event JSON that loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.  The executors'
``on_event`` hook feeds it (``Tracer.executor_hook()``), and so does the
serving engine (``EngineConfig(tracer=...)``).

Design constraints:

  * **Zero cost when absent.**  Tracing is opt-in: producers hold
    ``tracer = None`` by default and guard every emission with an
    ``if tracer is not None``: no event objects are allocated and no
    clock is read.
  * **Bounded when present.**  Events append to a ``deque(maxlen=...)``
    ring: a long-running server traces forever in O(capacity) host
    memory; the oldest events fall off.  ``dropped`` counts evictions.
  * **Valid on export.**  ``events()`` sanitizes the ring snapshot:
    orphaned ``E``/flow events whose partner was evicted are dropped, and
    spans still open at export time are closed at the snapshot timestamp
    (export is a consistent cut, not a teardown).

Track model: one process (pid 1, "miso"), one thread (tid) per *track*.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import time
from typing import Any, Callable, Optional

#: the single trace process id (one host process drives the engine)
PID = 1

#: default ring capacity — ~64k events ≈ a few thousand engine ticks
#: with a handful of resident requests
DEFAULT_CAPACITY = 1 << 16


class Tracer:
    """Ring-buffered structured tracer; one instance per engine/run.

    Emission API (all host-side, all O(1)):

      begin(name, track, **args) / end(track, name)   -- B/E span pair
      complete(name, track, ts_us, dur_us, **args)    -- X span (measured)
      instant(name, track, **args)                    -- i event
      flow_id() ; flow_start(fid, track, name)        -- s/f flow arrow
                  flow_end(fid, track, name)
      counter(name, track, **values)                  -- C series

    ``track`` is a string lane name ("engine", a request id, ...);
    thread ids are interned on first use and exported as
    ``thread_name`` metadata.  ``now_us()`` is the tracer clock
    (microseconds since construction) for callers that bracket work
    themselves and report it via ``complete``.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._t0 = clock()
        self._buf: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._tids: dict[str, int] = {}
        self._flow_ids = itertools.count(1)
        self.emitted = 0  # total events ever appended (>= len(ring))

    # -- clock / track interning ------------------------------------------
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def tid(self, track: str) -> int:
        """Intern a track name; tids are stable for the tracer's life."""
        t = self._tids.get(track)
        if t is None:
            t = len(self._tids) + 1
            self._tids[track] = t
        return t

    @property
    def dropped(self) -> int:
        """Events evicted from the ring so far."""
        return self.emitted - len(self._buf)

    def _event(self, ph: str, name: str, track: str, **fields: Any) -> None:
        ev = {"ph": ph, "name": name, "pid": PID, "tid": self.tid(track)}
        ev.update(fields)
        self._buf.append(ev)
        self.emitted += 1

    # -- emission ----------------------------------------------------------
    def begin(self, name: str, track: str, **args: Any) -> None:
        """Open a span on ``track`` (closed by ``end``; spans may stay
        open across host calls — a request's lifecycle span opens at
        submit and closes at its terminal status)."""
        self._event("B", name, track, ts=self.now_us(), args=args)

    def end(self, track: str, name: str = "", **args: Any) -> None:
        self._event("E", name, track, ts=self.now_us(), args=args)

    def complete(
        self, name: str, track: str, ts_us: float, dur_us: float, **args: Any
    ) -> None:
        """A measured span (caller bracketed the work with ``now_us``)."""
        self._event("X", name, track, ts=ts_us, dur=max(dur_us, 0.0), args=args)

    def instant(self, name: str, track: str, **args: Any) -> None:
        self._event("i", name, track, ts=self.now_us(), s="t", args=args)

    def counter(self, name: str, track: str, **values: float) -> None:
        """A counter sample (Perfetto renders a value track)."""
        self._event("C", name, track, ts=self.now_us(), args=values)

    @contextlib.contextmanager
    def span(self, name: str, track: str, **args: Any):
        """Bracket a host-side block as one measured X span."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, track, t0, self.now_us() - t0, **args)

    # -- flow arrows (strike -> repair) ------------------------------------
    def flow_id(self) -> int:
        return next(self._flow_ids)

    def flow_start(self, fid: int, track: str, name: str) -> None:
        self._event("s", name, track, ts=self.now_us(), id=fid)

    def flow_end(self, fid: int, track: str, name: str) -> None:
        # bp=e binds the arrow head to the enclosing slice/instant
        self._event("f", name, track, ts=self.now_us(), id=fid, bp="e")

    # -- executor hook adapter --------------------------------------------
    def executor_hook(self, track: str = "executor"):
        """An ``on_event`` callable for ``miso.compile(on_event=...)``:
        executor-protocol events (step timing, scan segments,
        checkpoints, compare mismatches, recoveries) become trace
        events on ``track``.  Events carrying ``dur_us`` (and
        optionally ``ts_us``) render as measured X spans; the rest as
        instants."""

        def on_event(name: str, attrs: dict) -> None:
            attrs = dict(attrs)
            dur = attrs.pop("dur_us", None)
            ts = attrs.pop("ts_us", None)
            if dur is not None:
                t0 = ts if ts is not None else self.now_us() - dur
                self.complete(name, track, t0, dur, **attrs)
            else:
                self.instant(name, track, **attrs)

        return on_event

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict]:
        """A sanitized snapshot of the ring as a Chrome trace-event list.

        Ring eviction can orphan one half of a B/E or s/f pair; open
        spans (a still-running request) have no E yet.  The snapshot
        repairs both so the export is always schema-valid: orphaned E
        and unmatched flow halves are dropped, open B spans are closed
        at the snapshot timestamp.
        """
        now = self.now_us()
        events = list(self._buf)
        # metadata first: stable process/thread names for every track
        proc = {"ph": "M", "name": "process_name", "pid": PID, "tid": 0, "ts": 0}
        proc["args"] = {"name": "miso"}
        out: list[dict] = [proc]
        for track, t in self._tids.items():
            ev = {"ph": "M", "name": "thread_name", "pid": PID, "tid": t, "ts": 0}
            ev["args"] = {"name": track}
            out.append(ev)
        # flow halves must both be inside the snapshot
        starts = {e["id"] for e in events if e["ph"] == "s"}
        ends = {e["id"] for e in events if e["ph"] == "f"}
        ok_flows = starts & ends
        open_spans: dict[int, list[dict]] = {}
        for e in events:
            ph = e["ph"]
            if ph in ("s", "f") and e["id"] not in ok_flows:
                continue
            if ph == "B":
                open_spans.setdefault(e["tid"], []).append(e)
            elif ph == "E":
                stack = open_spans.get(e["tid"])
                if not stack:
                    continue  # opening B was evicted from the ring
                stack.pop()
            out.append(e)
        for tid, stack in open_spans.items():
            for b in reversed(stack):  # close innermost-first
                close = {"ph": "E", "name": b["name"], "pid": PID, "tid": tid}
                close["ts"] = now
                out.append(close)
        return out

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        """Write the trace as Chrome trace-event JSON (Perfetto-loadable);
        validated structurally by ``tools/validate_trace.py``."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")


#: convenience: producers type their slot as ``Optional[Tracer]``
OptionalTracer = Optional[Tracer]
