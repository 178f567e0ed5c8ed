"""Production serving engine: chunked prefill, paged KV cache, continuous
batching.

Engine contract
---------------

* **Paged KV cache** — each layer owns a pool of ``num_blocks`` physical
  blocks of ``block_size`` token positions; a slot references its pages
  through a per-slot block table shared across layers.  ``max_len`` is a
  per-request *token budget*, not a dense allocation; the pool-wide budget
  is ``(num_blocks - 1) * block_size`` tokens (block 0 is the null write
  sink).  Blocks are reserved in full at admission
  (``ceil(min(max_len, prompt + max_new) / block_size)``), so an admitted
  request can never hit OOM mid-flight.

* **Chunked prefill** — prompts are spliced into the cache
  ``prefill_chunk`` tokens at a time by :func:`repro_torch.nn.prefill_chunk`,
  which writes KV lines directly; no
  per-token decode loop ever runs for prompt tokens.  At most ONE chunk
  runs per engine step, interleaved with the batched decode step, so a
  long prompt delays concurrent decodes by at most one chunk's compute.

* **Continuous batching** — finished slots are refilled from an async
  request queue (:meth:`submit` / :meth:`poll`) without draining the
  batch.  Admission control rejects gracefully (state ``REJECTED`` +
  reason, never an exception): queue-depth cap, prompt vs. token budget,
  and per-request deadlines (engine steps spent queued).

* **Numerics** — every matmul routes through the layer's
  :meth:`~repro_torch.core.spec.LNSRuntime.linear_infer`: the fused
  forward ⊞-MAC (``matmul_fused``, kernel row 1) on Δ-spec'd paths,
  bit-identical to the training forward by the fusion contract.  The
  engine runs on the device of ``params``: the kernels on the card, their
  plain versions on the CPU.  The model functions are plain calls under
  ``torch.no_grad``.

Sampling is per-request seeded (``fold_in(key(seed), rid)`` then
``fold_in(·, token_index)``, on the port's threefry, ``resil/prng.py``):
which slot a request lands in, and when, cannot change its sampled
continuation.  Under greedy decoding the output for a prompt is
bit-identical to :func:`reference_generate`, the dense token-by-token
oracle: the serving model functions take their float reductions in an
order-free form (``nn/model.py``), so a token's logits do not depend on
the batch or chunk it is computed in.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.numerics import get_plan
from ..core.spec import TORCH_DTYPES
from ..nn.config import ModelConfig
from ..nn.model import (PAGED_FAMILIES, Runtime, decode_step,
                        decode_step_paged, init_decode_caches,
                        init_paged_caches, known_layer_paths, prefill_chunk)
from ..nn.paged import NULL_BLOCK
from ..obs.registry import MetricsRegistry
from ..pytree import tree_leaves
from ..resil import inject as _inj
from ..resil import prng
from .paged_cache import BlockManager
from .queue import (DECODE, DONE, PREFILL, QUEUED,
                    REJECT_DEADLINE_EXPIRED, REJECT_PROMPT_OVER_BUDGET,
                    REJECT_RESERVATION_OVER_POOL, REJECT_RETRY_EXHAUSTED,
                    REJECT_WATCHDOG_ABORT, REJECTED, TERMINAL, Request,
                    RequestQueue)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512           # per-request token budget (prompt + new)
    eos_token: int = 2
    temperature: float = 0.0     # 0 → greedy
    seed: int = 0
    block_size: int = 16         # KV lines per physical block
    num_blocks: Optional[int] = None  # pool size; None → full occupancy
    prefill_chunk: int = 16      # prompt tokens spliced per engine step
    max_queue: int = 128         # admission queue depth cap
    retry_budget: int = 0        # re-queues allowed after an engine abort
                                 # (0 = abort is terminal)
    watchdog_s: float = 0.0      # wall-clock step budget; a slower step
                                 # trips the watchdog (0 = off; injected
                                 # hang faults trip it regardless, so
                                 # drills stay wall-clock-free)

    @property
    def table_width(self) -> int:
        return -(-self.max_len // self.block_size)

    def pool_blocks(self) -> int:
        """Physical blocks incl. the null block.  The default sizes the
        pool so ``max_batch`` slots can all hold ``max_len`` tokens —
        paged layout, dense-equivalent capacity.  Pass ``num_blocks`` to
        oversubscribe (queueing admits by actual reservation)."""
        if self.num_blocks is not None:
            return self.num_blocks
        return 1 + self.max_batch * self.table_width


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def _sample(logits_row, temperature: float, seed: int, rid: int,
            index: int) -> int:
    """Greedy (``temperature == 0``) or the request's own stream:
    ``categorical(fold_in(fold_in(key(seed), rid), index), logits / T)``,
    as ``jax.random`` draws it."""
    if temperature == 0.0:
        return int(torch.argmax(logits_row))
    k = prng.fold_in(prng.fold_in(prng.prng_key(seed), rid), index)
    return int(prng.categorical(k, logits_row / temperature))


class ServingEngine:
    """Continuous-batching engine over a paged KV cache.

    Async surface: :meth:`submit` → rid, :meth:`step` to advance,
    :meth:`poll` to read request state/output.  :meth:`run` is the
    synchronous convenience wrapper (submit all, drain, return outputs in
    request order).
    """

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 rt: Runtime = Runtime(),
                 registry: Optional[MetricsRegistry] = None,
                 faults=None):
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"ServingEngine serves {PAGED_FAMILIES} families; "
                f"{cfg.family!r} has no paged KV cache — use "
                f"repro.serve.reference_generate for it")
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.rt = rt
        # Resolve the model's numerics plan once: every decode/prefill
        # matmul routes through its per-layer runtimes (fused infer path).
        # Validating the rule patterns here makes a bad spec/plan string
        # fail fast, before any device work.
        self.plan = get_plan(cfg.numerics).validate_paths(
            known_layer_paths(cfg))
        self.numerics = self.plan.runtime()
        self.device = _device_of(params)

        nb = sc.pool_blocks()
        self.bm = BlockManager(nb, sc.block_size)
        self.queue = RequestQueue(sc.max_queue)
        self.caches = init_paged_caches(cfg, nb, sc.block_size,
                                        TORCH_DTYPES[cfg.param_dtype],
                                        device=self.device)
        w = sc.table_width
        self.bt = np.full((sc.max_batch, w), NULL_BLOCK, np.int32)
        self.pos = np.zeros((sc.max_batch,), np.int32)
        self.tok = np.zeros((sc.max_batch, 1), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * sc.max_batch
        self.step_count = 0
        self.stats = {"decode_steps": 0, "prefill_chunks": 0,
                      "tokens_generated": 0, "occupancy_sum": 0,
                      "stall_steps": 0}
        # Structured telemetry: rejection counters by reason code, queue
        # depth / occupancy gauges, per-request TTFT / TPOT / latency
        # histograms.  Observer-only — nothing on the data plane reads it.
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        # Fault surface (resil/inject): engine-level faults live under
        # the pseudo-path 'serve' of a FaultPlan (hang_step: simulate one
        # hung engine step; slow_req: every rid % N == 0 slot decodes at
        # half speed).  ``faults=None`` leaves every hot path untouched.
        self.fault_plan = _inj.FaultPlan.parse(faults)
        self._serve_faults = _inj.serve_faults(self.fault_plan)
        self._hung = False           # set by the hang fault (or a real
        self._last_step_s = None     # over-budget step vs watchdog_s)

    # ------------------------------------------------------ reporting ---
    @property
    def matmul_path(self) -> str:
        """The matmul path serving runs on, straight from the runtime's
        inference dispatch (``LNSRuntime.infer_path`` lives next to
        ``linear_infer`` so it cannot drift from the actual dispatch).
        Under a per-layer plan the default path is reported with the
        number of per-layer overrides appended."""
        path = self.numerics.infer_path
        if not self.plan.is_uniform:
            path += (f" (+{len(self.plan.rules)} per-layer override"
                     f"{'s' if len(self.plan.rules) != 1 else ''})")
        return path

    @property
    def active(self) -> np.ndarray:
        """Decode-batch mask: slots with a request in DECODE state."""
        return np.array([r is not None and r.state == DECODE
                         for r in self.slot_req])

    @property
    def occupancy(self) -> float:
        """Mean busy slots per decode step so far (0 if none ran)."""
        d = self.stats["decode_steps"]
        return self.stats["occupancy_sum"] / d if d else 0.0

    # ------------------------------------------------------ admission ---
    def submit(self, prompt, max_new: int = 32,
               deadline_steps: Optional[int] = None) -> int:
        """Queue one request; returns its rid (check state via poll).

        Rejections are graceful — the rid is still valid and ``poll``
        reports ``state == "REJECTED"`` with a reason:

        * ``queue full`` — depth cap hit;
        * ``prompt exceeds max_len`` — even 1 sampled token wouldn't fit
          the per-request budget;
        * ``reservation exceeds pool`` — the block reservation could
          never be satisfied, even by a drained pool.
        """
        req = self.queue.submit(prompt, max_new, deadline_steps,
                                self.step_count)
        if req.state != QUEUED:
            self.registry.counter_inc("serve.rejected",
                                      reason=req.reason_code)
            return req.rid
        reason, code = None, ""
        if req.prompt_len + 1 > self.sc.max_len:
            reason = (f"prompt exceeds max_len "
                      f"({req.prompt_len} + 1 > {self.sc.max_len})")
            code = REJECT_PROMPT_OVER_BUDGET
        elif not self.bm.fits_ever(self._reservation_tokens(req)):
            reason = (f"reservation exceeds pool "
                      f"({self.bm.blocks_for(self._reservation_tokens(req))}"
                      f" > {self.bm.capacity} blocks)")
            code = REJECT_RESERVATION_OVER_POOL
        if reason is not None:
            self.queue.reject(req, reason, self.step_count, code)
            self.registry.counter_inc("serve.rejected", reason=code)
        return req.rid

    def poll(self, rid: int) -> Request:
        """Request state/output; valid for accepted AND rejected rids."""
        return self.queue.poll(rid)

    def _reservation_tokens(self, req: Request) -> int:
        # KV lines the request can write: prompt + one per decode step
        # (≤ max_new - 1 after the prefill-sampled token, +1 for the line
        # the final step writes), capped by the per-request budget.
        return min(self.sc.max_len, req.prompt_len + req.max_new)

    # ------------------------------------------------------ scheduling --
    def _refill(self):
        """Admit queued requests into free slots (FIFO, all-or-nothing)."""
        free = [s for s in range(self.sc.max_batch)
                if self.slot_req[s] is None]
        while free and self.queue.depth:
            req = self.queue.peek()
            blocks = self.bm.alloc(
                self.bm.blocks_for(self._reservation_tokens(req)))
            if blocks is None:
                break  # head-of-line waits for blocks to free up
            self.queue.pop()
            slot = free.pop(0)
            req.state = PREFILL
            req.slot = slot
            req.blocks = blocks
            req.start_step = self.step_count
            req.prefill_pos = 0
            self.slot_req[slot] = req
            row = np.full((self.sc.table_width,), NULL_BLOCK, np.int32)
            row[:len(blocks)] = blocks
            self.bt[slot] = row
            self.pos[slot] = 0
            self.tok[slot, 0] = 0

    def _prefill_one(self):
        """Splice ONE chunk for the oldest mid-prefill request."""
        cands = [r for r in self.slot_req
                 if r is not None and r.state == PREFILL]
        if not cands:
            return
        req = min(cands, key=lambda r: (r.start_step, r.rid))
        c = self.sc.prefill_chunk
        chunk = req.prompt[req.prefill_pos:req.prefill_pos + c]
        nv = len(chunk)
        toks = np.zeros((1, c), np.int32)
        toks[0, :nv] = chunk
        with torch.no_grad():
            logits, self.caches = prefill_chunk(
                self.params, self._tensor(toks), self.caches,
                self._tensor(self.bt[req.slot]), req.prefill_pos, nv,
                self.cfg, self.rt)
        req.prefill_pos += nv
        self.stats["prefill_chunks"] += 1
        if req.prefill_pos >= req.prompt_len:
            # Prompt fully spliced: sample the first continuation token
            # from the last valid position's logits and join the batch.
            nxt = self._sample(logits[0, -1], req)
            req.output.append(nxt)
            req.first_token_time = time.monotonic()
            self.stats["tokens_generated"] += 1
            self.pos[req.slot] = req.prompt_len
            self.tok[req.slot, 0] = nxt
            if len(req.output) >= req.max_new:
                self._finish(req)
            else:
                req.state = DECODE

    def _decode_active(self):
        """One batched decode step for every DECODE slot."""
        act = self.active
        slow = self._serve_faults.get("slow_req")
        if slow:
            # Injected slow-request fault: every rid % slow == 0 slot
            # only participates in every other decode step — the
            # deterministic way a straggler pushes an admitted request
            # past its deadline *mid-flight*.
            for slot in range(self.sc.max_batch):
                r = self.slot_req[slot]
                if (r is not None and r.state == DECODE
                        and r.rid % slow == 0 and self.step_count % 2):
                    act[slot] = False
        if not act.any():
            return
        with torch.no_grad():
            logits, self.caches = decode_step_paged(
                self.params, self._tensor(self.tok), self.caches,
                self._tensor(self.bt), self._tensor(self.pos),
                self._tensor(act), self.cfg, self.rt)
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += int(act.sum())
        # One host read of every slot's greedy token.
        greedy = (torch.argmax(logits[:, -1], dim=-1).tolist()
                  if self.sc.temperature == 0.0 else None)
        for slot in range(self.sc.max_batch):
            req = self.slot_req[slot]
            if req is None or req.state != DECODE or not act[slot]:
                continue
            self.pos[slot] += 1
            nxt = (greedy[slot] if greedy is not None
                   else self._sample(logits[slot, -1], req))
            req.output.append(nxt)
            self.stats["tokens_generated"] += 1
            self.tok[slot, 0] = nxt
            if (nxt == self.sc.eos_token
                    or int(self.pos[slot]) >= self.sc.max_len - 1
                    or len(req.output) >= req.max_new):
                self._finish(req)

    def _finish(self, req: Request):
        req.state = DONE
        req.finish_step = self.step_count
        req.finish_time = time.monotonic()
        slot = req.slot
        if slot >= 0:
            self.bm.free(req.blocks)
            self.bt[slot] = NULL_BLOCK
            self.slot_req[slot] = None
            req.slot = -1
        # Per-request latency telemetry (all wall-clock ms).
        reg = self.registry
        reg.counter_inc("serve.requests_finished")
        reg.counter_inc("serve.tokens_out", len(req.output))
        reg.histogram_record(
            "serve.latency_ms", 1e3 * (req.finish_time - req.submit_time))
        if req.first_token_time:
            reg.histogram_record(
                "serve.ttft_ms",
                1e3 * (req.first_token_time - req.submit_time))
            if len(req.output) > 1:
                reg.histogram_record(
                    "serve.tpot_ms",
                    1e3 * (req.finish_time - req.first_token_time)
                    / (len(req.output) - 1))

    # ------------------------------------------------- failure handling --
    def _abort_request(self, req: Request, reason: str, code: str,
                       allow_retry: bool = True):
        """Tear an in-flight request out of the batch on *any* failure
        path: its slot and blocks are released first (block conservation
        holds on every exit path — ``BlockManager.check_conserved``),
        then the request either re-queues at the front (within
        ``retry_budget``, progress reset — re-admission re-reserves
        blocks, so a retry can never leak or double-book) or terminally
        rejects through the single ``RequestQueue.reject`` funnel."""
        slot = req.slot
        if slot >= 0:
            self.bm.free(req.blocks)
            self.bt[slot] = NULL_BLOCK
            self.slot_req[slot] = None
            req.slot = -1
            req.blocks = []
        req.output = []
        req.prefill_pos = 0
        req.first_token_time = 0.0
        if allow_retry and self.sc.retry_budget > 0:
            if req.retries < self.sc.retry_budget:
                req.retries += 1
                self.queue.requeue(req)
                self.registry.counter_inc("serve.retries")
                return
            reason = (f"retry budget exhausted after {req.retries} "
                      f"retries: {reason}")
            code = REJECT_RETRY_EXHAUSTED
        self.queue.reject(req, reason, self.step_count, code)
        self.registry.counter_inc("serve.rejected", reason=code)

    def force_abort(self, reason: str = "engine abort"):
        """Abort every in-flight request (no retry) — the operator's big
        red button, and the drill's stand-in for an engine crash.  Queued
        requests stay queued; block conservation holds."""
        for req in list(self.slot_req):
            if req is not None:
                self._abort_request(req, reason, REJECT_WATCHDOG_ABORT,
                                    allow_retry=False)

    def _watchdog_check(self):
        """Fire the step watchdog when the previous step hung.

        Two triggers: the injected ``hang_step`` fault (deterministic —
        what the drills use) or a real wall-clock over-budget step
        (``watchdog_s > 0``).  Firing aborts every in-flight request
        through the retry path: requests are re-queued within their
        budget, terminally rejected (``watchdog-abort`` /
        ``retry-exhausted``) beyond it."""
        hung, self._hung = self._hung, False
        if (not hung and self.sc.watchdog_s > 0
                and self._last_step_s is not None
                and self._last_step_s > self.sc.watchdog_s):
            hung = True
        if not hung:
            return
        self.registry.counter_inc("serve.watchdog_fired")
        for req in list(self.slot_req):
            if req is not None:
                self._abort_request(req, "step watchdog fired (hung step)",
                                    REJECT_WATCHDOG_ABORT)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits_row, req: Request) -> int:
        # Per-request stream: seed folds in the rid, then the token index.
        # Slot assignment and refill order cannot perturb a request's
        # sampled continuation.
        return _sample(logits_row, self.sc.temperature, self.sc.seed,
                       req.rid, len(req.output))

    # ----------------------------------------------------- engine loop --
    def step(self):
        """One engine step: expire deadlines, refill free slots, splice at
        most one prefill chunk, then one batched decode step.

        Also maintains the engine's own telemetry: ``stats["stall_steps"]``
        counts steps where a prefill chunk displaced ready decode work
        (decode-ready slots existed at the top of the step, a chunk was
        spliced, and no decode step ran) — chunked prefill interleaves, so
        this should stay 0; the registry gets a queue-depth gauge plus any
        deadline-expiry rejection counters."""
        decoders_before = int(self.active.sum())
        d0 = self.stats["decode_steps"]
        p0 = self.stats["prefill_chunks"]
        t0 = time.monotonic()
        self.step_count += 1
        if self._serve_faults.get("hang_step") == self.step_count:
            self._hung = True  # injected hung step: watchdog fires below
        self._watchdog_check()
        for r in self.queue.expire(self.step_count):
            self.registry.counter_inc("serve.rejected", reason=r.reason_code)
        # Mid-flight deadline: an admitted request whose budget lapses
        # during prefill/decode is aborted (not retried — its deadline is
        # already gone), releasing slot + blocks on the spot.
        for req in list(self.slot_req):
            if (req is not None and req.deadline_steps is not None
                    and self.step_count - req.submit_step
                    > req.deadline_steps):
                self._abort_request(req, "deadline exceeded mid-flight",
                                    REJECT_DEADLINE_EXPIRED,
                                    allow_retry=False)
        self._refill()
        self._prefill_one()
        self._decode_active()
        self._last_step_s = time.monotonic() - t0
        ran_prefill = self.stats["prefill_chunks"] > p0
        ran_decode = self.stats["decode_steps"] > d0
        if ran_prefill and decoders_before > 0 and not ran_decode:
            self.stats["stall_steps"] += 1
        self.registry.gauge_set("serve.queue_depth", self.queue.depth)
        self.registry.gauge_set("serve.occupancy", self.occupancy)

    @property
    def busy(self) -> bool:
        return (self.queue.depth > 0
                or any(r is not None for r in self.slot_req))

    def run(self, prompts: list, max_new: int = 32):
        """Serve prompts to completion; outputs in request order.

        Synchronous wrapper over submit/step/poll for scripts and tests.
        If the queue cap is hit, steps the engine until depth frees up, so
        any number of prompts can be passed.  Rejected requests (e.g. a
        prompt over the token budget) yield an empty output list.
        """
        rids = []
        for p in prompts:
            while True:
                rid = self.submit(p, max_new=max_new)
                req = self.poll(rid)
                if req.state == REJECTED and req.reason == "queue full":
                    self.step()
                    continue
                rids.append(rid)
                break
        while any(self.poll(r).state not in TERMINAL for r in rids):
            self.step()
        return [list(self.poll(r).output[:max_new]) for r in rids]


# ----------------------------------------------------------- oracle ------
def reference_generate(cfg: ModelConfig, params, prompt, max_new: int = 32,
                       *, eos_token: int = 2, max_len: int = 512,
                       temperature: float = 0.0, seed: int = 0,
                       rid: int = 0, rt: Runtime = Runtime()):
    """Dense token-by-token oracle for ONE prompt, on the device of
    ``params``.

    The semantics the engine is pinned against: teacher-force the prompt
    through ``decode_step`` into a dense cache, sample the first
    continuation token from the final prompt logits, then decode until
    EOS is sampled, the position budget ``max_len`` is reached, or
    ``max_new`` tokens exist.  Greedy outputs depend only on the prompt,
    so this is also the cross-request-contamination check: the engine
    must reproduce it for every request in any arrival order.  With
    ``temperature > 0`` pass the engine-assigned ``rid`` and shared
    ``seed`` to reproduce the per-request sampling stream.
    """
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    dev = _device_of(params)
    caches = init_decode_caches(cfg, 1, max_len,
                                TORCH_DTYPES[cfg.param_dtype],
                                enc_len=max_len, device=dev)

    def step(tok, pos, caches):
        with torch.no_grad():
            return decode_step(
                params, torch.full((1, 1), int(tok), dtype=torch.int32,
                                   device=dev),
                caches, torch.full((1,), pos, dtype=torch.int32,
                                   device=dev), cfg, rt)

    logits = None
    for t, tok in enumerate(prompt):
        logits, caches = step(tok, t, caches)
    pos = len(prompt)

    def sample(row, idx):
        return _sample(row, temperature, seed, rid, idx)

    out = [sample(logits[0, -1], 0)]
    while len(out) < max_new:
        logits, caches = step(out[-1], pos, caches)
        pos += 1
        nxt = sample(logits[0, -1], len(out))
        out.append(nxt)
        if nxt == eos_token or pos >= max_len - 1:
            break
    return out[:max_new]
