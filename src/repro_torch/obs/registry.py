"""Structured metric registry: counters / gauges / histograms → rows.

``MetricsRegistry`` is the host-side aggregation point for everything the
numerics side channel (``obs.metrics``) and the host-side components (the
guardrails, step timers) want to report.  Instruments are
identified by ``(name, sorted label items)``; labels are plain string
pairs (``layer``, ``op``, ``spec``, ``backend``, ``lane``, ...).  The
registry is deliberately dumb — no time-series, no windows — because the
sink (``obs.sink.JsonlSink``) flushes full snapshots per step and the
report tooling does the math offline.

Histograms keep **raw samples** (host-side, low-rate series — a few
thousand floats at most), so consumers compute quantiles from exactly the
data.  The dhist taps arrive already bucketed and are recorded as
``bucketed_histogram`` rows against the pinned ``DHIST_EDGES``.
"""
from __future__ import annotations

from .metrics import DHIST_EDGES


def _key(name, labels):
    return (name, tuple(sorted((labels or {}).items())))


class MetricsRegistry:
    """Counters, gauges, and histograms with string labels.

    ``base_labels`` are merged under every instrument's own labels —
    use them for run-wide dimensions (spec string, backend, arch).
    """

    def __init__(self, base_labels=None):
        self.base_labels = dict(base_labels or {})
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._bucketed: dict = {}

    # -- instruments -------------------------------------------------------
    def counter_inc(self, name, amount=1, **labels):
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0) + int(amount)

    def counter_value(self, name, **labels):
        return self._counters.get(_key(name, labels), 0)

    def gauge_set(self, name, value, **labels):
        self._gauges[_key(name, labels)] = float(value)

    def histogram_record(self, name, value, **labels):
        self._hists.setdefault(_key(name, labels), []).append(float(value))

    def histogram_values(self, name, **labels):
        return list(self._hists.get(_key(name, labels), ()))

    def bucketed_record(self, name, counts, edges, **labels):
        """Record an already-bucketed histogram (len(counts) ==
        len(edges) + 1); repeated records accumulate per bucket."""
        counts = [int(c) for c in counts]
        if len(counts) != len(edges) + 1:
            raise ValueError(
                f"bucketed histogram {name!r}: {len(counts)} counts for "
                f"{len(edges)} edges (want {len(edges) + 1})")
        k = _key(name, labels)
        prev, _ = self._bucketed.get(k, (None, None))
        if prev is not None:
            counts = [a + b for a, b in zip(prev, counts)]
        self._bucketed[k] = (counts, tuple(float(e) for e in edges))

    # -- tap ingestion ---------------------------------------------------
    def merge_numerics_taps(self, taps, lanes=None, **labels):
        """Fold a ``label → value`` dict of a step's taps into the
        registry: host values (``obs.metrics.host_taps``: numpy arrays or
        ints), not one device tensor at a time.

        Labels of the form ``"<layer>/<op>/<counter>"`` become
        ``numerics.<counter>`` counters with ``layer``/``op`` labels;
        1-D values are treated as dhist buckets against ``DHIST_EDGES``.
        ``lanes`` optionally maps layer path → the lane that ran it
        (``"cuda"``: the kernels on a card; ``"cpu"``: their plain
        versions), recorded as a ``lane`` label so every row says which
        datapath produced it.
        """
        lanes = lanes or {}
        for label, value in taps.items():
            parts = label.split("/")
            if len(parts) != 3:
                raise ValueError(f"malformed numerics tap label: {label!r}")
            layer, op, counter = parts
            row_labels = dict(labels, layer=layer, op=op)
            if layer in lanes:
                row_labels["lane"] = lanes[layer]
            shape = getattr(value, "shape", ())
            if len(shape) == 1:
                self.bucketed_record(f"numerics.{counter}",
                                     [int(v) for v in value],
                                     DHIST_EDGES, **row_labels)
            else:
                self.counter_inc(f"numerics.{counter}", int(value),
                                 **row_labels)

    # -- snapshot ----------------------------------------------------------
    def rows(self, reset=False):
        """Snapshot every instrument as a list of flat dicts (one per
        instrument), ready for the JSONL sink.  ``reset=True`` clears
        gauges and histograms but keeps counters (they are cumulative by
        contract)."""
        out = []
        for (name, lab), v in sorted(self._counters.items()):
            out.append({"kind": "counter", "name": name, "value": v,
                        **self.base_labels, **dict(lab)})
        for (name, lab), v in sorted(self._gauges.items()):
            out.append({"kind": "gauge", "name": name, "value": v,
                        **self.base_labels, **dict(lab)})
        for (name, lab), vs in sorted(self._hists.items()):
            out.append({"kind": "histogram", "name": name,
                        "count": len(vs), "sum": sum(vs),
                        "min": min(vs), "max": max(vs),
                        "values": list(vs),
                        **self.base_labels, **dict(lab)})
        for (name, lab), (counts, edges) in sorted(self._bucketed.items()):
            out.append({"kind": "bucketed_histogram", "name": name,
                        "counts": counts, "edges": list(edges),
                        **self.base_labels, **dict(lab)})
        if reset:
            self._gauges.clear()
            self._hists.clear()
        return out
