"""Requests and the admission queue of the continuous batcher (a copy of
``repro/serving/request.py`` on this package's ``RedundancyPolicy``).

A ``Request`` is one decode job: a prompt, a token budget, an optional
deadline, and — the MISO twist — a per-request ``RedundancyPolicy``: the
*caller* chooses how dependable their own decode should be (none / DMR /
TMR), and pays for it in slots of the resident batch, without affecting
anyone else's latency or bytes.

``RequestQueue`` is the host-side admission layer: bounded depth
(back-pressure by rejection), FIFO ordering, lazy deadline expiry (a
request whose deadline passes while queued is never started), and
cancellation of queued work.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Optional

from ..core.cell import NO_REDUNDANCY, RedundancyPolicy

# request lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
EXPIRED = "expired"
REJECTED = "rejected"

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One decode request.

    prompt          -- model-specific payload (LM: (P,) int32 token array).
    max_new_tokens  -- decode budget (the prefill continuation counts as
                       token 1).
    policy          -- per-request dependability: level 1 = none, 2 = DMR
                       (detect + §IV third-execution tie-break), 3 = TMR
                       (detect + majority repair).  Costs ``level`` slots.
    deadline        -- absolute time (engine clock) after which the
                       request is dropped: while queued it expires
                       unstarted; while running it is evicted with
                       partial output.
    stop_token      -- optional early-stop token id.
    spec            -- optional speculative-decoding ask, read by the
                       adapter (LM: ``models.lm_cells.SpecConfig``, whose
                       ``draft_len`` is clamped to the engine's resident
                       draft).  The output is the same either way; spec
                       only changes how many tokens one tick commits.
    """

    prompt: Any
    max_new_tokens: int = 16
    policy: RedundancyPolicy = NO_REDUNDANCY
    deadline: Optional[float] = None
    stop_token: Optional[int] = None
    spec: Any = None
    id: Optional[str] = None

    def __post_init__(self):
        if self.id is None:
            self.id = f"r{next(_ids)}"
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def n_slots(self) -> int:
        return self.policy.level

    @property
    def prompt_len(self) -> int:
        """Leading-axis length of the prompt payload (LM: token count).
        The paged-KV admission path sizes its worst-case page reservation
        from this plus ``max_new_tokens``."""
        return len(self.prompt)


class RequestQueue:
    """Bounded FIFO admission queue with deadlines and cancellation."""

    def __init__(
        self,
        max_depth: int = 64,
        time_fn: Callable[[], float] = time.monotonic,
        on_expire: Optional[Callable[[Request], None]] = None,
    ):
        self.max_depth = max_depth
        self.time_fn = time_fn
        self.on_expire = on_expire  # called per request dropped by expiry
        self._q: collections.deque[Request] = collections.deque()
        self.status: dict[str, str] = {}
        self.rejected = 0
        self.expired = 0
        self._deadlines = 0  # deadline-bearing entries currently queued

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> bool:
        """Admit or reject (bounded queue = explicit back-pressure).

        The expiry sweep runs FIRST: dead entries anywhere in the deque
        must not hold ``depth`` against a fresh submission (a queue full
        of deadline-passed requests would otherwise reject live traffic
        — false back-pressure)."""
        self._expire()
        if len(self._q) >= self.max_depth:
            self.status[req.id] = REJECTED
            self.rejected += 1
            return False
        self.status[req.id] = QUEUED
        self._q.append(req)
        if req.deadline is not None:
            self._deadlines += 1
        return True

    def cancel(self, rid: str) -> bool:
        """Cancel a *queued* request (running ones are the engine's to
        evict).  True if it was found waiting.  Removal is by index —
        never by value: ``deque.remove`` would run the dataclass __eq__
        against every earlier entry, and ndarray prompts make that raise
        (ambiguous array truth value)."""
        for i, req in enumerate(self._q):
            if req.id == rid:
                del self._q[i]
                if req.deadline is not None:
                    self._deadlines -= 1
                self.status[rid] = CANCELLED
                return True
        return False

    def _expire(self) -> None:
        """Drop every deadline-passed request, wherever it sits in the
        deque.  (Head-only expiry left mid-queue corpses counted in
        ``depth``, causing false back-pressure rejections.)  O(1) when no
        queued request carries a deadline (the common case; peek runs
        every engine tick), one-pass partition rebuild otherwise — no
        value-based removal that would trip dataclass __eq__ on ndarray
        prompts."""
        if self._deadlines == 0:
            return
        now = self.time_fn()
        live: collections.deque[Request] = collections.deque()
        for r in self._q:
            if r.deadline is not None and r.deadline <= now:
                self.status[r.id] = EXPIRED
                self.expired += 1
                self._deadlines -= 1
                if self.on_expire is not None:
                    self.on_expire(r)
            else:
                live.append(r)
        self._q = live

    def peek(self) -> Optional[Request]:
        """Next admissible request (deadline-expired entries are dropped)."""
        self._expire()
        return self._q[0] if self._q else None

    def pop(self) -> Optional[Request]:
        self._expire()
        if not self._q:
            return None
        req = self._q.popleft()
        if req.deadline is not None:
            self._deadlines -= 1
        self.status[req.id] = RUNNING
        return req

    def take(self, req: Request) -> bool:
        """Pop a specific request the caller just ``peek``-validated —
        NO expiry re-sweep, so the head cannot change between the
        admission check and the pop (pop() re-runs expiry against a
        fresh clock reading: under deadline traffic it can return None
        or a request whose slot fit was never checked).  False if ``req``
        is no longer the head."""
        if self._q and self._q[0] is req:
            self._q.popleft()
            if req.deadline is not None:
                self._deadlines -= 1
            self.status[req.id] = RUNNING
            return True
        return False
