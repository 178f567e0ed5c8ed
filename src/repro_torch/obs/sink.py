"""JSONL metric sinks: one JSON object per line, append-only.

Rows come from ``MetricsRegistry.rows()``; the sink stamps each with the
flush ``step`` plus any row-level extras the caller passes (loss,
step_time_ms, ...).  ``read_jsonl`` is the strict loader;
``read_jsonl_tolerant`` is the crash-safe one — a process killed
mid-write leaves at most one torn final line, which the tolerant reader
drops instead of raising.
"""
from __future__ import annotations

import json
import os


class JsonlSink:
    """Append metric rows to ``path`` as JSON lines.

    Opens lazily and truncates on first write, so constructing a sink is
    free and re-running a tool overwrites rather than appends to stale
    runs.  Use as a context manager or call ``close()``.
    """

    def __init__(self, path):
        self.path = str(path)
        self._fh = None

    def _ensure(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "w")
        return self._fh

    def write(self, rows, step=None, **extra):
        """Write each row dict on its own line, stamped with ``step`` and
        ``extra``.  Row-local keys win over stamps."""
        fh = self._ensure()
        stamp = dict(extra)
        if step is not None:
            stamp["step"] = int(step)
        for row in rows:
            # Per-row flush: a crash mid-batch loses at most the row
            # being written (a torn tail read_jsonl_tolerant drops),
            # never whole flushed batches.
            fh.write(json.dumps({**stamp, **row}, sort_keys=True) + "\n")
            fh.flush()

    def write_row(self, row, step=None, **extra):
        self.write([row], step=step, **extra)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path):
    """Load a JSONL metrics file back into a list of dicts (strict:
    any unparsable line raises)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def read_jsonl_tolerant(path):
    """Load a JSONL file, dropping unparsable lines (the torn tail a
    mid-write kill leaves behind).

    Every line that parses is kept — with per-row flushing
    (:class:`JsonlSink`, the search journal) a crash can tear at most
    the final line, so tolerance never hides whole batches.
    """
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows
