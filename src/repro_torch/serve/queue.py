"""Async request queue with admission control for the serving engine.

Requests move through a small state machine::

    submit() ──► QUEUED ──► PREFILL ──► DECODE ──► DONE
                   │
                   └──► REJECTED        (graceful: state + reason, never
                                         an exception on the data plane)

Admission control happens at two points.  :meth:`RequestQueue.submit`
enforces the **queue-depth cap** — a full queue rejects instead of growing
without bound.  The engine rejects at *admission time* (when a slot would
be assigned) for requests whose prompt exceeds the token budget or whose
deadline lapsed while waiting.  Rejected and finished requests stay in the
registry so :meth:`RequestQueue.poll` can always answer for a known rid.

Every rejection carries both a human ``reason`` string (free-form, may
embed numbers) and a machine ``reason_code`` from the closed
:data:`REJECT_CODES` vocabulary, and every rejection — whichever code
path raised it — is counted in :attr:`RequestQueue.rejections`, so
telemetry never has to re-parse reason strings.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

# Request lifecycle states.
QUEUED = "QUEUED"        # admitted to the queue, waiting for a slot
PREFILL = "PREFILL"      # owns a slot; prompt chunks being spliced
DECODE = "DECODE"        # in the continuous decode batch
DONE = "DONE"            # finished (EOS / length / max_new); output final
REJECTED = "REJECTED"    # refused admission; see ``reason``

TERMINAL = (DONE, REJECTED)

# Machine-readable rejection codes.  ``Request.reason`` stays the human
# string (tests pin some of those verbatim); ``reason_code`` is the stable
# counter key.
REJECT_QUEUE_FULL = "queue-full"
REJECT_PROMPT_OVER_BUDGET = "prompt-over-budget"
REJECT_RESERVATION_OVER_POOL = "reservation-over-pool"
REJECT_DEADLINE_EXPIRED = "deadline-expired"
REJECT_RETRY_EXHAUSTED = "retry-exhausted"
REJECT_WATCHDOG_ABORT = "watchdog-abort"
# Pinned append-only vocabulary (tests/test_obs.py): dashboards and
# committed metric samples key on these — extend only by appending.
REJECT_CODES = (REJECT_QUEUE_FULL, REJECT_PROMPT_OVER_BUDGET,
                REJECT_RESERVATION_OVER_POOL, REJECT_DEADLINE_EXPIRED,
                REJECT_RETRY_EXHAUSTED, REJECT_WATCHDOG_ABORT)


@dataclasses.dataclass
class Request:
    """One serving request and its full lifecycle record."""
    rid: int
    prompt: np.ndarray                  # (P,) int32 prompt tokens
    max_new: int                        # cap on sampled continuation length
    deadline_steps: Optional[int] = None  # engine steps allowed in QUEUED
    state: str = QUEUED
    reason: str = ""                    # set when REJECTED (human string)
    reason_code: str = ""               # set when REJECTED (REJECT_* slug)
    output: list = dataclasses.field(default_factory=list)  # sampled tokens
    blocks: list = dataclasses.field(default_factory=list)  # owned block ids
    slot: int = -1                      # decode-batch slot while scheduled
    prefill_pos: int = 0                # prompt tokens already spliced
    retries: int = 0                    # times re-queued after an abort
    submit_step: int = -1               # engine step at submit()
    start_step: int = -1                # engine step entering PREFILL
    finish_step: int = -1               # engine step entering a terminal state
    submit_time: float = 0.0            # wall clock at submit()
    first_token_time: float = 0.0       # wall clock of first sampled token
    finish_time: float = 0.0            # wall clock entering a terminal state

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def reject(self, reason: str, step: int, code: str = "") -> None:
        self.state = REJECTED
        self.reason = reason
        self.reason_code = code
        self.finish_step = step
        self.finish_time = time.monotonic()


class RequestQueue:
    """FIFO admission queue with a hard depth cap.

    ``submit`` never raises for a full queue: the request comes back in
    state ``REJECTED`` with ``reason="queue full"`` and is recorded in the
    registry, so callers see the same poll surface for accepted and
    refused work.
    """

    def __init__(self, max_depth: int = 64):
        self.max_depth = int(max_depth)
        self._q: deque[Request] = deque()
        self._registry: dict[int, Request] = {}
        self._next_rid = 0
        # First-class rejection counters, keyed by REJECT_* code.  All
        # rejection paths — queue-level and engine-driven — route through
        # :meth:`reject`, so these can never drift from poll()'s view.
        self.rejections: dict[str, int] = {c: 0 for c in REJECT_CODES}

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, prompt, max_new: int, deadline_steps: Optional[int],
               step: int) -> Request:
        req = Request(rid=self._next_rid,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new=int(max_new), deadline_steps=deadline_steps,
                      submit_step=step, submit_time=time.monotonic())
        self._next_rid += 1
        self._registry[req.rid] = req
        if len(self._q) >= self.max_depth:
            self.reject(req, "queue full", step, REJECT_QUEUE_FULL)
        else:
            self._q.append(req)
        return req

    def reject(self, req: Request, reason: str, step: int,
               code: str) -> Request:
        """Terminal-reject ``req`` (dequeuing it first if still queued) and
        bump the per-code rejection counter.  The single funnel for every
        rejection path, so counters and poll() state cannot disagree."""
        if code not in REJECT_CODES:
            raise ValueError(f"unknown rejection code {code!r}; "
                             f"expected one of {REJECT_CODES}")
        if req in self._q:
            self._q.remove(req)
        req.reject(reason, step, code)
        self.rejections[code] += 1
        return req

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        return self._q.popleft()

    def withdraw(self, req: Request) -> None:
        """Remove a still-queued request (caller sets its terminal state)."""
        self._q.remove(req)

    def requeue(self, req: Request) -> None:
        """Put an aborted in-flight request back at the *front* of the
        queue (retry path: it already waited its turn once — a retry must
        not pay the full queue again).  The caller has already released
        the request's slot/blocks and reset its progress."""
        req.state = QUEUED
        self._q.appendleft(req)

    def expire(self, step: int) -> list:
        """Reject every queued request whose deadline lapsed; return them."""
        expired = [r for r in self._q
                   if r.deadline_steps is not None
                   and step - r.submit_step > r.deadline_steps]
        for r in expired:
            self.reject(r, "deadline exceeded while queued", step,
                        REJECT_DEADLINE_EXPIRED)
        return expired

    def poll(self, rid: int) -> Request:
        return self._registry[rid]

    def known(self, rid: int) -> bool:
        return rid in self._registry
