"""Step tracing: profiler ranges and host-side step timers.

Two clocks:

* ``phase_scope(name)`` — a ``torch.profiler.record_function`` range, and
  an NVTX range when a card is present, around a phase of a step (``fwd``
  / ``dx`` / ``dw`` / ``reduce`` / ``update``).  It names the phase in a
  profiler trace and changes no result.  The ranges open only inside a
  ``profiler_session``; elsewhere ``phase_scope`` is a null context, so a
  step that is not being profiled does no work for them.
* ``StepTimer`` — host ``perf_counter`` wall times around spans.  Built
  with a CUDA ``device`` it calls ``torch.cuda.synchronize()`` at both
  ends of every span, so a span holds the device work it launched (the
  number a user waits for), not only the time to enqueue it.

``profiler_session`` / ``maybe_profile`` write a ``torch.profiler``
Chrome trace (``trace.json``) of a region into a directory given as an
argument or in ``$REPRO_TRACE_DIR``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

#: Environment variable that, set to a directory, makes ``maybe_profile``
#: write a trace there even without an explicit argument.
TRACE_DIR_ENV = "REPRO_TRACE_DIR"


#: One entry per open ``profiler_session``: whether it also opens NVTX
#: ranges (a card was present when it began).
_SESSIONS: list = []


def phase_scope(name):
    """Profiler-visible range named ``name`` inside a ``profiler_session``,
    else a null context; results unchanged."""
    if not _SESSIONS:
        return contextlib.nullcontext()
    return _ranges(name, _SESSIONS[-1])


@contextlib.contextmanager
def _ranges(name, nvtx):
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Named host-side monotonic timers with simple summaries.

    >>> t = StepTimer(device="cuda")
    >>> with t.span("train.step"):
    ...     out = model.train_step(...)
    >>> t.last("train.step")  # ms, the card's work included
    """

    def __init__(self, device=None):
        self._samples: dict = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    def record(self, name, ms):
        self._samples.setdefault(name, []).append(float(ms))

    @contextlib.contextmanager
    def span(self, name):
        if self._sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self.record(name, (time.perf_counter() - t0) * 1e3)

    def last(self, name):
        s = self._samples.get(name)
        return s[-1] if s else None

    def samples(self, name):
        return list(self._samples.get(name, ()))

    def summary(self, skip_first=0):
        """Per-name stats dict: count / mean_ms / p50_ms / best_ms.
        ``skip_first`` drops warmup samples from the stats of every series
        that has more than that many samples."""
        out = {}
        for name, s in sorted(self._samples.items()):
            body = s[skip_first:] if len(s) > skip_first else s
            srt = sorted(body)
            out[name] = {
                "count": len(s),
                "mean_ms": sum(body) / len(body),
                "p50_ms": srt[len(srt) // 2],
                "best_ms": srt[0],
            }
        return out


@contextlib.contextmanager
def profiler_session(trace_dir):
    """Profile the enclosed region (the CPU, and the card when present)
    and write its Chrome trace to ``<trace_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _SESSIONS.append(torch.cuda.is_available())
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _SESSIONS.pop()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    """``profiler_session`` if a directory is given as the argument or in
    ``$REPRO_TRACE_DIR``; otherwise a context that does nothing."""
    trace_dir = trace_dir or os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield None
        return
    with profiler_session(trace_dir):
        yield trace_dir
