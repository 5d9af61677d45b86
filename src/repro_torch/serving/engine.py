"""The continuous-batching serving engine (a port of
``repro/serving/engine.py`` with temporal replica slots).

One resident decoder program (a weights cell + a slot-masked decoder
cell) is compiled once and driven through ``Executor.stream``; the engine
multiplexes many independent decode requests onto its fixed batch:

  * between ticks, the stream's ``swap`` hook scatters freshly prefilled
    prompt caches into free slots (join) and scrubs finished ones;
  * per tick, the engine harvests each running request's new token,
    checks stop/budget/deadline, and evicts finished requests;
  * per-request dependability: a request's ``RedundancyPolicy`` maps onto
    *replica slots* of the same batch (DMR = the same prompt in 2 slots,
    TMR = 3).  The engine compares their 128-bit per-slot fingerprints
    after every tick, attributes a mismatch to the *owning request* in
    its FaultLedger, repairs (TMR: copy a majority slot over the
    minority; DMR: the paper's §IV third execution — ``pure_step``
    replays the tick from the immutable previous buffer — decides, and
    both replicas adopt the replay), and only then emits the token;
  * speculative decoding: a tick of a speculating slot commits up to
    K+1 tokens, which the harvest emits one at a time;
  * tracing (``EngineConfig.tracer``): ticks split into host dispatch,
    device time and harvest, request lifecycles, prefills, verify walks,
    §IV replays and the strike timeline, as Chrome trace events.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core import executor as _ex
from ..core.redundancy import FaultLedger
from ..obs import MetricsRegistry, Tracer
from .request import CANCELLED, DONE, EXPIRED, QUEUED, REJECTED, RUNNING, Request, RequestQueue
from .slots import SlotManager, SlotSurgery, default_surgery

Tree = Any


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fence(x: Tree) -> None:
    """Block until the device work behind ``x`` (its first leaf) is done:
    the traced paths bracket device time this way.  Only a tracer calls
    it, so the untraced engine adds no synchronisation."""
    while isinstance(x, (dict, list, tuple)):
        x = next(iter(x.values())) if isinstance(x, dict) else x[0]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything ``ServingEngine`` needs beyond the program + adapter.

    backend          -- executor backend name.
    placement        -- "temporal" (replica slots are batch rows of one
                        device); "spatial" is not ported yet.
    max_queue        -- bounded admission queue depth (back-pressure).
    retain_results   -- finished records kept for ``result()`` pickup.
    compare_every    -- executor compare cadence (None = backend default).
    checkpoint_cb/checkpoint_every -- executor checkpoint segmentation.
    tracer           -- optional ``obs.Tracer``: the engine's spans and
                        the executor's events (through ``on_event``).
    registry         -- metrics registry (a fresh one when None).
    """

    backend: str = "lockstep"
    placement: str = "temporal"
    max_queue: int = 64
    retain_results: int = 1024
    compare_every: Optional[int] = None
    checkpoint_cb: Optional[Callable] = None
    checkpoint_every: int = 0
    tracer: Optional[Tracer] = None
    registry: Optional[MetricsRegistry] = None

    def __post_init__(self):
        if self.placement != "temporal":
            raise NotImplementedError("spatial replica placement is not ported yet")


class EngineParts(NamedTuple):
    """Named return of ``lm_engine_parts``: the program and its adapter."""

    program: Any
    adapter: "SlotAdapter"


@dataclasses.dataclass(frozen=True)
class SlotAdapter:
    """What the engine needs to know about the slotted program.

    cell        -- name of the slot-masked decoder cell.
    n_slots     -- its batch width.
    slot_axes   -- per-leaf slot-axis tree of the cell state.
    prefill     -- ``(request, states) -> (slot_state, first_token | None,
                   n_pending)``: run the prompt (or its first chunk) and
                   return a width-1 slot state ready to join; ``n_pending``
                   > 0 means the transition still walks that many prompt
                   tokens before the first token is emitted.
    read_tokens -- ``(cell_state) -> (B, ...)`` each slot's last token.
    make_empty  -- ``() -> slot_state``: a width-1 *inactive* slot state.
    validate    -- optional ``(request) -> str | None`` admission check.
    stats       -- optional ``() -> dict`` merged into ``metrics()``.
    surgery     -- optional ``SlotSurgery`` (paged: page-table routed).
    has_capacity-- optional ``(request) -> bool`` extra admission gate.
    pre_tick    -- optional ``(states) -> states`` run after admission,
                   before the tick's input buffer is kept for replays.
    walk_chunk  -- prompt-tail tokens the transition consumes per tick.
    contiguous_replicas -- replica slots need one adjacent run.
    read_spec   -- optional ``(cell_state) -> (spec_out, spec_n)``: the
                   speculative harvest, (B, K+1) committed tokens and (B,)
                   their count (0 = the slot decoded plainly this tick).
    attach_tracer -- optional ``(tracer) -> None``: hands the engine's
                   tracer to adapter closures that emit events (the paged
                   pre-tick's page faults); called only under a tracer.
    """

    cell: str
    n_slots: int
    slot_axes: Tree
    prefill: Callable[[Request, dict], tuple]
    read_tokens: Callable[[Tree], torch.Tensor]
    make_empty: Callable[[], Tree]
    validate: Optional[Callable[[Request], Optional[str]]] = None
    stats: Optional[Callable[[], dict]] = None
    surgery: Optional[SlotSurgery] = None
    has_capacity: Optional[Callable[[Request], bool]] = None
    pre_tick: Optional[Callable[[dict], dict]] = None
    walk_chunk: int = 1
    contiguous_replicas: bool = True
    read_spec: Optional[Callable[[Tree], tuple]] = None
    attach_tracer: Optional[Callable[[Tracer], None]] = None


@dataclasses.dataclass
class RequestRecord:
    """Engine-side lifecycle record of one request."""

    req: Request
    status: str
    submitted_at: float
    slots: list[int] = dataclasses.field(default_factory=list)
    tokens: list[np.ndarray] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    faults: int = 0
    cancel_requested: bool = False
    #: chunked prefill: prompt-tail tokens the transition still has to
    #: consume before this request emits its first token
    prefill_remaining: int = 0
    #: tracing: a ``prefill_walk`` span is open on this request's track
    trace_walk_open: bool = False

    @property
    def id(self) -> str:
        return self.req.id

    def token_ids(self) -> list[int]:
        return [int(t.reshape(-1)[0]) for t in self.tokens]


class ServingEngine:
    """Continuous batcher over one compiled ``Executor``.

    Construct through ``repro_torch.api.serve(program, adapter, ...)``::

        engine.start(0)                # seed, Generator, or states=...
        engine.submit(Request(prompt, max_new_tokens=32))
        engine.pump()                  # tick until drained
        engine.result("r0")            # tokens, status, ttft, faults
        engine.metrics()               # tokens/s, TTFT p50/p99, ledger
    """

    def __init__(
        self,
        program,
        adapter: SlotAdapter,
        config: Optional[EngineConfig] = None,
        *,
        device="cuda",
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self.config = cfg = config if config is not None else EngineConfig()
        self.adapter = adapter
        #: None (the default) costs nothing: every emission is guarded
        self.tracer = tracer = cfg.tracer
        self.registry = cfg.registry if cfg.registry is not None else MetricsRegistry()
        if tracer is not None and adapter.attach_tracer is not None:
            adapter.attach_tracer(tracer)
        self.exe = _ex.compile(
            program,
            backend=cfg.backend,
            device=device,
            compare_every=cfg.compare_every,
            checkpoint_cb=cfg.checkpoint_cb,
            checkpoint_every=cfg.checkpoint_every,
            # executor events land on the tracer's "executor" track
            on_event=tracer.executor_hook() if tracer is not None else None,
        )
        if type(self.exe).pure_step is _ex.Executor.pure_step:
            raise ValueError(
                f"backend {self.exe.name!r} has no pure_step replay; the engine "
                "needs it for DMR tie-breaks"
            )
        self.queue = RequestQueue(
            max_depth=cfg.max_queue, time_fn=time_fn, on_expire=self._on_queue_expire
        )
        self.slots = SlotManager(adapter.n_slots)
        self.ledger = FaultLedger()  # keyed by REQUEST id, not cell name
        self.time_fn = time_fn
        self.retain_results = cfg.retain_results
        self.requests: dict[str, RequestRecord] = {}
        self._finished: collections.deque[str] = collections.deque()
        self._states: Optional[dict] = None
        self._override: Optional[dict] = None
        self._tick_input: Optional[dict] = None
        self._tick_step: int = 0
        R = self.registry
        self._m_ticks = R.counter("serving_ticks_total", "engine ticks executed")
        self._m_tokens = R.counter("serving_tokens_emitted_total", "tokens emitted to requests")
        self._m_submitted = R.counter("serving_requests_submitted_total", "requests submitted")
        self._m_rejected_invalid = R.counter(
            "serving_requests_rejected_invalid_total", "requests rejected by admission validation"
        )
        self._m_defrag = R.counter("serving_defrag_moves_total", "slot relocations by defrag")
        self._m_strikes = R.counter(
            "serving_strikes_detected_total", "replica mismatches detected, attributed, and repaired"
        )
        self._m_replays = R.counter("serving_replays_total", "§IV pure_step replays of a tick")
        #: speculation: verify passes, the tokens they committed, and the
        #: smallest single commit (1 = a first draft token was rejected)
        self._m_spec_ticks = R.counter("serving_spec_verify_ticks_total", "speculative verify passes")
        self._m_spec_tokens = R.counter(
            "serving_spec_tokens_committed_total", "tokens committed by speculative verify passes"
        )
        self._spec_min_commit: Optional[int] = None
        self._m_terminal = {
            DONE: R.counter("serving_requests_done_total", "requests completed"),
            CANCELLED: R.counter("serving_requests_cancelled_total", "requests cancelled"),
            EXPIRED: R.counter("serving_requests_expired_total", "requests past deadline"),
        }
        self._h_ttft = R.histogram("serving_ttft_seconds", "submit-to-first-token latency")
        self._h_latency = R.histogram(
            "serving_request_latency_seconds", "submit-to-terminal-status latency"
        )
        self._h_tick = R.histogram(
            "serving_tick_seconds",
            "wall time per engine tick (swap + dispatch + harvest); sum = busy_s",
        )
        self._trace_tick_ts0 = 0.0  # tracer clock at the current tick's start
        self._t0: Optional[float] = None
        self._ops = adapter.surgery or default_surgery(
            adapter.cell, adapter.slot_axes, adapter.make_empty
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self, generator: torch.Generator | int = 0, *, states: Optional[dict] = None):
        """Initialize the resident states (weights + empty slots) from a
        seed or generator, or take ready-made ``states`` (the parity tests
        hand over the JAX package's, through ``repro_torch.bridge``)."""
        self._states = states if states is not None else self.exe.init(generator)
        self._t0 = self.time_fn()

    def _on_queue_expire(self, req: Request) -> None:
        """Queue expiry hook: a queued request past its deadline shows in
        the trace (its lifecycle span closes at ``_reconcile``)."""
        if self.tracer is not None:
            self.tracer.instant("request_expired", req.id)

    def submit(self, req: Request) -> bool:
        """Admission control + enqueue.  False = rejected (queue full, too
        many replica slots, or adapter validation)."""
        reason = None
        if req.n_slots > self.adapter.n_slots:
            reason = f"policy needs {req.n_slots} slots, engine has {self.adapter.n_slots}"
        elif self.adapter.validate is not None:
            reason = self.adapter.validate(req)
        rec = RequestRecord(req=req, status=QUEUED, submitted_at=self.time_fn())
        self.requests[req.id] = rec
        self._m_submitted.inc()
        if self.tracer is not None:
            # the lifecycle span: one track per request, open from
            # submission to terminal status (_finish_record)
            self.tracer.begin(
                "request",
                req.id,
                prompt_len=req.prompt_len,
                level=req.policy.level,
                max_new_tokens=req.max_new_tokens,
            )
            self.tracer.instant("queued", req.id)
        if reason is not None:
            self._m_rejected_invalid.inc()
            self._finish_record(rec, REJECTED)
            return False
        ok = self.queue.submit(req)
        rec.status = self.queue.status[req.id]
        if not ok:
            self._finish_record(rec, REJECTED)
        return ok

    def cancel(self, rid: str) -> bool:
        """Cancel a queued request now, or a running one at the next tick."""
        rec = self.requests.get(rid)
        if rec is None:
            return False
        if rec.status == QUEUED and self.queue.cancel(rid):
            self._finish_record(rec, CANCELLED)
            return True
        if rec.status == RUNNING:
            rec.cancel_requested = True
            return True
        return False

    def _reconcile(self) -> None:
        """Pull lazily-updated queue statuses (deadline expiry) into the
        engine records."""
        self.queue.peek()
        for rec in list(self.requests.values()):
            if rec.status == QUEUED:
                status = self.queue.status.get(rec.id, rec.status)
                if status != QUEUED:
                    self._finish_record(rec, status)

    def result(self, rid: str) -> dict:
        self._reconcile()
        rec = self.requests[rid]
        tokens: Any = list(rec.tokens)
        if rec.tokens and rec.tokens[0].size == 1:
            tokens = rec.token_ids()
        return {
            "status": rec.status,
            "tokens": tokens,
            "n_tokens": len(rec.tokens),
            "ttft_s": rec.ttft,
            "faults": rec.faults,
            "slots": list(rec.slots),
        }

    # -- the serving loop --------------------------------------------------
    def has_work(self) -> bool:
        return self.queue.peek() is not None or self.slots.active > 0

    def pump(self, max_ticks: Optional[int] = None, *, faults=None) -> int:
        """Drive the stream until drained (or ``max_ticks``).  Returns the
        number of ticks executed.  ``faults`` (FaultSpecs keyed on global
        step index) thread into the executor's step."""
        if self._states is None:
            raise RuntimeError("call start() before pump()")
        if not self.has_work():
            return 0
        ticks = 0
        tr = self.tracer
        stream = self.exe.stream(self._states, swap=self._swap, faults=faults)
        try:
            while True:
                tick_t0 = self.time_fn()
                if tr is not None:
                    ts0 = tr.now_us()
                try:
                    states, _reports = next(stream)
                except StopIteration:
                    break
                if tr is not None:
                    # host dispatch vs device: next() returns once the
                    # step is dispatched, and the fence brackets the
                    # device work
                    ts1 = tr.now_us()
                    _fence(states[self.adapter.cell])
                    ts2 = tr.now_us()
                    self._trace_tick_ts0 = ts0
                states = self._postprocess(self._tick_step, states)
                self._states = states
                self._override = states
                self._m_ticks.inc()
                self._h_tick.observe(self.time_fn() - tick_t0)
                if tr is not None:
                    ts3 = tr.now_us()
                    tr.complete(
                        "tick",
                        "engine",
                        ts0,
                        ts3 - ts0,
                        step=self._tick_step,
                        dispatch_us=ts1 - ts0,
                        device_us=ts2 - ts1,
                        harvest_us=ts3 - ts2,
                    )
                ticks += 1
                if max_ticks is not None and ticks >= max_ticks:
                    break
                if not self.has_work():
                    break
        finally:
            stream.close()
        return ticks

    def _swap(self, t: int, states: dict) -> dict:
        """The stream's pre-tick hook: apply the previous tick's repairs
        and evictions, then join newly admitted requests."""
        if self._override is not None:
            states = self._override
            self._override = None
        states = self._admit(t, states)
        if self.adapter.pre_tick is not None:
            # paged demand growth runs BEFORE the replay snapshot, so a §IV
            # replay of this tick sees the same page tables
            states = self.adapter.pre_tick(states)
        self._tick_input = states  # immutable prev buffer (§IV replays)
        self._tick_step = t
        return states

    # -- admission: queue -> slots ----------------------------------------
    def _admit(self, t: int, states: dict) -> dict:
        while True:
            req = self.queue.peek()
            if req is None or self.slots.free < req.n_slots:
                break  # FIFO: no overtaking of a head that doesn't fit
            cap = self.adapter.has_capacity
            if cap is not None and not cap(req):
                break  # paged: not enough free pages for its worst case
            contig = self.adapter.contiguous_replicas and req.n_slots > 1
            if contig and self.slots.find_run(req.n_slots) is None:
                # capacity exists but no adjacent run: defragment
                states = self._defrag(states, req.n_slots)
            if not self.queue.take(req):
                continue  # head expired underneath us: re-validate
            rec = self.requests[req.id]
            if self.tracer is not None:
                with self.tracer.span("prefill", req.id, prompt_len=req.prompt_len):
                    slot_state, first, pending = self.adapter.prefill(req, states)
                    _fence(slot_state)
            else:
                slot_state, first, pending = self.adapter.prefill(req, states)
            slots = self.slots.alloc(req.id, req.n_slots, contiguous=contig)
            for s in slots:
                states = self._ops.join(states, slot_state, s, req=req)
            now = self.time_fn()
            rec.slots = slots
            rec.status = RUNNING
            rec.started_at = now
            rec.prefill_remaining = int(pending)
            if self.tracer is not None:
                self.tracer.instant("admitted", req.id, step=t, slots=list(slots))
                if pending:
                    # the walk's span ends when prefill_remaining drains
                    self.tracer.begin("prefill_walk", req.id, pending=int(pending))
                    rec.trace_walk_open = True
            if pending == 0:
                # the prefill's greedy continuation IS the first token
                self._emit(rec, _host(first).reshape(-1), now)
            status = self._should_finish(rec, now)
            if status is not None:  # e.g. max_new_tokens == 1
                states = self._evict(states, rec, status)
        return states

    def _defrag(self, states: dict, n: int) -> dict:
        """Relocate running requests' slots (bitwise copy + scrub) until an
        ``n``-slot adjacent free run exists."""
        for src, dst in self.slots.defrag_plan(n) or ():
            states = self._ops.copy(states, src, dst)
            states = self._ops.scrub(states, src)
            rid = self.slots.relocate(src, dst)
            rec = self.requests.get(rid)
            if rec is not None:
                rec.slots[rec.slots.index(src)] = dst
            self._m_defrag.inc()
            if self.tracer is not None:
                self.tracer.instant("defrag_move", "engine", src=src, dst=dst, rid=rid)
        return states

    # -- per-tick postprocessing: repair -> harvest -> evict ---------------
    def _postprocess(self, t: int, states: dict) -> dict:
        running = [r for r in self.requests.values() if r.status == RUNNING]
        replicated = [r for r in running if r.req.policy.level > 1]
        if replicated:
            states = self._check_replicas(t, states, replicated)
        if not running:
            return states
        dec = states[self.adapter.cell]
        toks = _host(self.adapter.read_tokens(dec))
        sout = sn = None
        if self.adapter.read_spec is not None:
            sout, sn = (_host(x) for x in self.adapter.read_spec(dec))
        now = self.time_fn()
        for rec in running:
            if rec.status != RUNNING:
                continue
            if rec.prefill_remaining > 0:
                # this tick consumed up to walk_chunk pending prompt tokens
                rec.prefill_remaining -= min(self.adapter.walk_chunk, rec.prefill_remaining)
                if rec.prefill_remaining > 0:
                    status = self._should_finish(rec, now)
                    if status is not None:
                        states = self._evict(states, rec, status)
                    continue
                if self.tracer is not None and rec.trace_walk_open:
                    self.tracer.end(rec.id, "prefill_walk")
                    rec.trace_walk_open = False
                # the tick consuming the LAST prompt token produced the
                # first real continuation token -> harvest it
            slot = rec.slots[0]
            n_commit = int(sn[slot]) if sn is not None else 0
            if n_commit > 0:
                # a verify walk committed n tokens: emit them one at a
                # time, so stop/budget/deadline trip on the token plain
                # decode would stop on (the surplus leaves with the slot)
                self._m_spec_ticks.inc()
                self._m_spec_tokens.inc(n_commit)
                self._spec_min_commit = (
                    n_commit if self._spec_min_commit is None
                    else min(self._spec_min_commit, n_commit)
                )
                if self.tracer is not None:
                    # the walk ran inside this tick's step: span it over
                    # the tick so far
                    ts0 = self._trace_tick_ts0
                    self.tracer.complete(
                        "verify_walk",
                        rec.id,
                        ts0,
                        self.tracer.now_us() - ts0,
                        step=t,
                        committed=n_commit,
                        accepted=n_commit - 1,
                    )
                status = None
                for i in range(n_commit):
                    self._emit(rec, sout[slot, i : i + 1], now)
                    status = self._should_finish(rec, now)
                    if status is not None:
                        break
            else:
                self._emit(rec, toks[slot].reshape(-1), now)
                status = self._should_finish(rec, now)
            if status is not None:
                states = self._evict(states, rec, status)
        return states

    def _check_replicas(self, t: int, states: dict, recs: list[RequestRecord]) -> dict:
        """Compare each replicated request's replica-slot fingerprints;
        attribute mismatches to the owning request and repair."""
        fps = _host(self._ops.fingerprints(states[self.adapter.cell]))
        replay = rfps = None  # lazy: one §IV replay serves every event this tick
        for rec in recs:
            s = rec.slots
            eq = [np.array_equal(fps[s[0]], fps[s[i]]) for i in range(1, len(s))]
            if all(eq) and (len(s) < 3 or np.array_equal(fps[s[1]], fps[s[2]])):
                continue
            level = rec.req.policy.level
            tr = self.tracer
            fid = None
            if tr is not None:
                # detect -> attribute -> repair on the struck request's
                # track, with a flow arrow from detection into repair
                fid = tr.flow_id()
                tr.instant("strike_detected", rec.id, step=t, level=level)
                tr.flow_start(fid, rec.id, "strike")
            if level == 3:
                pairs = [
                    (0, 1, np.array_equal(fps[s[0]], fps[s[1]])),
                    (0, 2, np.array_equal(fps[s[0]], fps[s[2]])),
                    (1, 2, np.array_equal(fps[s[1]], fps[s[2]])),
                ]
                agree = [(i, j) for i, j, ok in pairs if ok]
                if agree:
                    i, j = agree[0]
                    bad = ({0, 1, 2} - {i, j}).pop()
                    # real damage: elements of the struck replica slot
                    # differing from a majority slot (pre-repair)
                    dmg = self._ops.damage(states, s[i], s[bad])
                    if tr is not None:
                        tr.instant("strike_attributed", rec.id, step=t, replicas=[bad],
                                   damage_elems=float(dmg))
                    states = self._ops.copy(states, s[i], s[bad])
                    self._attribute(rec, t, [bad], level, dmg)
                    if tr is not None:
                        tr.instant("strike_repaired", rec.id, step=t, repair="tmr_vote")
                        tr.flow_end(fid, rec.id, "strike")
                    continue
                bad = [0, 1, 2]  # triple divergence: fall through to replay
            else:
                bad = None  # DMR: symmetric — the replay decides
            if replay is None:
                # paper §IV: "a third equal transition should be executed to
                # decide between the two possible outcomes" — replay the
                # tick (no armed fault) from the immutable pre-tick buffer
                if tr is not None:
                    with tr.span("dmr_replay", "engine", step=t):
                        replay, _ = self.exe.pure_step(self._tick_input, t)
                        _fence(replay[self.adapter.cell])
                else:
                    replay, _ = self.exe.pure_step(self._tick_input, t)
                self._m_replays.inc()
                rfps = _host(self._ops.fingerprints(replay[self.adapter.cell]))
            if bad is None:
                bad = [i for i, sl in enumerate(s) if not np.array_equal(fps[sl], rfps[sl])]
            dmg = sum(self._ops.damage_vs(states, replay, s[b]) for b in bad)
            if tr is not None:
                tr.instant("strike_attributed", rec.id, step=t, replicas=list(bad),
                           damage_elems=float(dmg))
            for sl in s:
                states = self._ops.adopt(states, replay, sl)
            self._attribute(rec, t, bad, level, dmg)
            if tr is not None:
                tr.instant("strike_repaired", rec.id, step=t, repair="dmr_replay")
                tr.flow_end(fid, rec.id, "strike")
        return states

    def _attribute(self, rec: RequestRecord, t: int, bad: list[int], level: int, damage: float):
        """One detected strike, charged to the owning request in the engine
        ledger.  ``damage`` is the real corruption size (state elements of
        the struck replica slot(s) differing from the repaired value);
        ``per_replica`` is sized to the request's level."""
        rec.faults += 1
        self._m_strikes.inc()
        per = [0.0] * level
        for b in bad:
            per[b] = 1.0
        entry = {"events": 1.0, "mismatch_elems": max(damage, 1.0), "per_replica": per}
        self.ledger.update(t, {rec.id: entry})

    # -- emit / finish / evict --------------------------------------------
    def _emit(self, rec: RequestRecord, token: np.ndarray, now: float) -> None:
        rec.tokens.append(token)
        self._m_tokens.inc()
        if rec.ttft is None:
            rec.ttft = now - rec.submitted_at
            self._h_ttft.observe(rec.ttft)
            if self.tracer is not None:
                self.tracer.instant("first_token", rec.id, ttft_s=rec.ttft)

    def _should_finish(self, rec: RequestRecord, now: float) -> Optional[str]:
        if rec.cancel_requested:
            return CANCELLED
        # DONE checks come BEFORE the deadline: a request whose final token
        # was just emitted has delivered its full output
        if len(rec.tokens) >= rec.req.max_new_tokens:
            return DONE
        if rec.req.stop_token is not None and rec.tokens:
            if int(rec.tokens[-1].reshape(-1)[0]) == rec.req.stop_token:
                return DONE
        if rec.req.deadline is not None and now >= rec.req.deadline:
            return EXPIRED
        return None

    def _evict(self, states: dict, rec: RequestRecord, status: str) -> dict:
        """Leave: scrub the request's slots back to empty and free them."""
        for s in self.slots.release(rec.id):
            states = self._ops.scrub(states, s)
        self._finish_record(rec, status)
        return states

    def _finish_record(self, rec: RequestRecord, status: str) -> None:
        rec.status = status
        rec.finished_at = self.time_fn()
        self.queue.status[rec.id] = status
        if status in self._m_terminal:
            self._m_terminal[status].inc()
        self._h_latency.observe(rec.finished_at - rec.submitted_at)
        if self.tracer is not None:
            if rec.trace_walk_open:  # evicted mid-walk: close the inner span
                self.tracer.end(rec.id, "prefill_walk")
                rec.trace_walk_open = False
            self.tracer.instant(status, rec.id)
            self.tracer.end(rec.id, "request", status=status, n_tokens=len(rec.tokens),
                            faults=rec.faults)
        self._finished.append(rec.id)
        while len(self._finished) > self.retain_results:
            self.drop(self._finished[0])

    def drop(self, rid: str) -> bool:
        """Release a finished request's record and status; flagged-suspect
        ledger entries survive."""
        rec = self.requests.get(rid)
        if rec is None or rec.status in (QUEUED, RUNNING):
            return False
        if rid in self._finished:
            self._finished.remove(rid)
        del self.requests[rid]
        self.queue.status.pop(rid, None)
        if rid not in self.ledger.flagged:
            self.ledger.totals.pop(rid, None)
            self.ledger.recent.pop(rid, None)
        return True

    # -- the metrics / SLO surface ----------------------------------------
    def metrics(self) -> dict:
        """The engine's SLO surface, read back from the registry.
        ``busy_s`` is the tick-loop occupancy (sum of per-tick wall
        times); ``tokens_per_s_busy`` divides by it."""
        self._reconcile()
        recs = list(self.requests.values())
        wall = (self.time_fn() - self._t0) if self._t0 is not None else 0.0
        busy = self._h_tick.sum
        running = sum(1 for r in recs if r.status == RUNNING)
        tokens_out = int(self._m_tokens.value)
        R = self.registry
        R.gauge("serving_queue_depth", "requests waiting").set(self.queue.depth)
        R.gauge("serving_active_requests", "requests resident").set(running)
        R.gauge("serving_free_slots", "unoccupied batch slots").set(self.slots.free)
        R.counter(
            "serving_requests_rejected_queue_full_total", "requests shed by queue back-pressure"
        ).value = float(self.queue.rejected)
        self.exe.export_metrics(R)
        m = {
            "backend": self.exe.name,
            "placement": self.config.placement,
            "n_slots": self.adapter.n_slots,
            "ticks": int(self._m_ticks.value),
            "replays": int(self._m_replays.value),
            "queue_depth": self.queue.depth,
            "active_requests": running,
            "free_slots": self.slots.free,
            "submitted": int(self._m_submitted.value),
            "done": int(self._m_terminal[DONE].value),
            "cancelled": int(self._m_terminal[CANCELLED].value),
            "expired": int(self._m_terminal[EXPIRED].value),
            "rejected_queue_full": self.queue.rejected,
            "rejected_invalid": int(self._m_rejected_invalid.value),
            "rejected": self.queue.rejected + int(self._m_rejected_invalid.value),
            "defrag_moves": int(self._m_defrag.value),
            "tokens_out": tokens_out,
            "wall_s": wall,
            "busy_s": busy,
            "utilization": busy / wall if wall > 0 else 0.0,
            "tokens_per_s": tokens_out / wall if wall > 0 else 0.0,
            "tokens_per_s_busy": tokens_out / busy if busy > 0 else 0.0,
            "request_faults": {r.id: r.faults for r in recs if r.faults},
            "fault_totals": self.ledger.totals,
            "suspects": self.ledger.permanent_fault_suspects(),
        }
        if self.adapter.read_spec is not None:
            spec_ticks = int(self._m_spec_ticks.value)
            spec_tokens = int(self._m_spec_tokens.value)
            m["spec_ticks"] = spec_ticks
            m["spec_tokens"] = spec_tokens
            m["spec_min_commit"] = self._spec_min_commit
            m["spec_tokens_per_tick"] = spec_tokens / spec_ticks if spec_ticks else 0.0
        if self._h_ttft.count:
            m["ttft_p50_s"] = self._h_ttft.quantile(0.5)
            m["ttft_p99_s"] = self._h_ttft.quantile(0.99)
        if self.adapter.stats is not None:
            m.update(self.adapter.stats())
        return m
