"""Numerics counters: a side channel for LNS health that never changes
results.

The collection model is **observer-only**: every counter is computed from
the *inputs or outputs* of an op with pure reads (comparisons and integer
sums); the op's own arithmetic is never touched.  A counter is a 0-d int32
tensor on the operands' device, accumulated on a collector that a
metrics entry point (e.g. ``LNSMLP.train_step_metrics``) pushes for the
length of one step and returns beside the step's outputs.  Nothing here
reads a value to the host: the caller reads a step's taps once
(:func:`host_taps`, one copy), never one tap at a time.  With no collector
active every helper returns at once, so the plain entry points run the
ops they ran before this module existed.

Tap sites are **scope-gated**: the instrumented core ops (``encode``,
``convert_format``, the epilogues of the ⊞-MAC dispatcher) record only
under an ambient ``scope(layer, op)``; ``suspended()`` switches
collection off for a region (the data-parallel step's per-segment
backward, gather and combine).

Counter vocabulary (all int32 element counts):

* ``elems`` / ``sat`` / ``zero``       — code-plane health of an LNS
  tensor: total elements, codes pinned at ``fmt.code_max`` and
  zero-sentinel codes.
* ``q_elems`` / ``q_sat`` / ``q_flush`` — float→LNS quantization
  (``encode``): elements whose rounded log-magnitude clipped at
  ``code_max``, and *nonzero* values flushed to the zero code.
* ``convert_elems`` / ``convert_sat`` / ``convert_flush`` — the format
  crossing (``convert_format``): nonzero codes that saturated at or
  flushed out of the destination grid.
* ``dhist`` — int32 histogram (length ``len(DHIST_EDGES) + 1``) of the
  ``|d| = |X - Y|`` entering the Δ engine during a sequential ⊞-MAC, in
  log2-magnitude buckets: the Δ table's occupancy.

Labels are ``"<layer>/<op>/<counter>"``; repeated taps under one label add
up.  The module imports nothing of ``repro_torch.core``: core ops import
*it*, and the contract is duck-typed ``(code, sign)`` tensors and
``LNSFormat``-shaped attributes.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

#: The Δ-table occupancy buckets' edges, in log2-magnitude units of |d|
#: (format-independent; put on each format's code grid at tap time).
#: Buckets: [0,1) [1,2) [2,4) [4,8) [8,10) [10,∞): the last is beyond the
#: paper's table (d ≥ d_max = 10).  Identical to the JAX package's; extend
#: only by appending.
DHIST_EDGES = (1.0, 2.0, 4.0, 8.0, 10.0)

# ``None`` on the collector stack means "collection suspended".
_COLLECTORS: list = []
_SCOPES: list = []


class NumericsCollector:
    """Accumulates labeled int32 tensors during one step."""

    def __init__(self):
        self._taps: dict = {}

    def add(self, label: str, value: torch.Tensor) -> None:
        prev = self._taps.get(label)
        self._taps[label] = value if prev is None else prev + value

    def taps(self) -> dict:
        """The accumulated ``label → int32 tensor`` dict, keys sorted."""
        return {k: self._taps[k] for k in sorted(self._taps)}


def enabled() -> bool:
    """True iff a live (not suspended) collector is on the stack."""
    return bool(_COLLECTORS) and _COLLECTORS[-1] is not None


def scope_active() -> bool:
    """True iff collection is enabled AND an ambient scope is set."""
    return enabled() and bool(_SCOPES)


def current_scope():
    """The innermost ambient ``(layer, op)``, or ``(None, None)``."""
    return _SCOPES[-1] if _SCOPES else (None, None)


@contextlib.contextmanager
def collecting():
    """Push a fresh collector; yields it.  A metrics entry point returns
    ``collector.taps()`` beside its step's outputs."""
    col = NumericsCollector()
    _COLLECTORS.append(col)
    try:
        yield col
    finally:
        _COLLECTORS.pop()


@contextlib.contextmanager
def suspended():
    """Switch collection off for a region."""
    _COLLECTORS.append(None)
    try:
        yield
    finally:
        _COLLECTORS.pop()


@contextlib.contextmanager
def scope(layer=None, op=None):
    """Set the ambient (layer, op) label of scope-gated taps; ``None``
    inherits the enclosing scope's value."""
    cl, co = current_scope()
    _SCOPES.append((layer if layer is not None else cl,
                    op if op is not None else co))
    try:
        yield
    finally:
        _SCOPES.pop()


def _label(counter: str, layer, op) -> str:
    cl, co = current_scope()
    layer = layer if layer is not None else (cl or "default")
    op = op if op is not None else (co or "op")
    return f"{layer}/{op}/{counter}"


def tap(counter: str, value: torch.Tensor, *, layer=None, op=None) -> None:
    """Record one labeled int32 tensor (no-op unless collection is on)."""
    if enabled():
        _COLLECTORS[-1].add(_label(counter, layer, op),
                            value.to(torch.int32))


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _size(t: torch.Tensor) -> torch.Tensor:
    # A fill on the tensor's device: no host-to-device copy.
    return t.new_full((), t.numel(), dtype=torch.int32)


def observe_codes(a, fmt, *, layer=None, op=None) -> None:
    """Code-plane health of an LNS tensor: elems / sat / zero, pure reads
    of ``a.code``."""
    if not enabled():
        return
    tap("elems", _size(a.code), layer=layer, op=op)
    tap("sat", _count(a.code == fmt.code_max), layer=layer, op=op)
    tap("zero", _count(a.code == fmt.zero_code), layer=layer, op=op)


def observe_quantize(raw_code, nonzero_mask, fmt, *, layer=None,
                     op=None) -> None:
    """Float→LNS quantization health from the rounded code before its
    clip (``raw_code``; garbage on zero lanes, which ``nonzero_mask``
    hides).  Called by ``core.lns.encode`` under an ambient scope."""
    if not scope_active():
        return
    tap("q_elems", _size(raw_code), layer=layer, op=op)
    tap("q_sat", _count(nonzero_mask & (raw_code > fmt.code_max)),
        layer=layer, op=op)
    tap("q_flush", _count(nonzero_mask & (raw_code < fmt.min_nonzero_code)),
        layer=layer, op=op)


def observe_convert(src_nonzero, raw_code, dst_fmt, *, layer=None,
                    op=None) -> None:
    """Format-crossing health: the shifted ``raw_code`` (before its clip)
    against the destination grid, over lanes nonzero in the source.
    Called by ``core.lns.convert_format`` under a scope."""
    if not scope_active():
        return
    tap("convert_elems", _size(raw_code), layer=layer, op=op)
    tap("convert_sat", _count(src_nonzero & (raw_code > dst_fmt.code_max)),
        layer=layer, op=op)
    tap("convert_flush",
        _count(src_nonzero & (raw_code < dst_fmt.min_nonzero_code)),
        layer=layer, op=op)


def observe_float(v: torch.Tensor, fmt, *, layer=None, op=None) -> None:
    """Health of a float tensor against an LNS format: exact zeros, and
    magnitudes at or above the format's largest value.  ``fmt=None``
    records only ``elems`` / ``zero``."""
    if not enabled():
        return
    mag = torch.abs(v)
    tap("elems", _size(mag), layer=layer, op=op)
    tap("zero", _count(mag == 0), layer=layer, op=op)
    if fmt is not None:
        ceil = float(np.float32(2.0) ** (np.float32(fmt.code_max)
                                         / np.float32(fmt.scale)))
        tap("sat", _count(mag >= ceil), layer=layer, op=op)


def dhist_edges_codes(fmt, device="cpu", edges_log2=DHIST_EDGES
                      ) -> torch.Tensor:
    """``edges_log2`` (default the pinned DHIST_EDGES) on ``fmt``'s integer
    code grid, on ``device``.  Built and copied to the device once per
    grid, device and edges, then cached: callers must not write to it."""
    return _edges_codes(float(fmt.scale), str(torch.device(device)),
                        tuple(edges_log2))


@functools.lru_cache(maxsize=None)
def _edges_codes(scale, device, edges_log2):
    return torch.tensor([int(round(e * scale)) for e in edges_log2],
                        dtype=torch.int32, device=device)


def host_taps(taps: dict) -> dict:
    """A step's taps as numpy int32 arrays, read to the host in one copy:
    the tensors are joined on their device, copied once and split."""
    if not taps:
        return {}
    keys = list(taps)
    flat = [taps[k].reshape(-1) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for k, f in zip(keys, flat):
        n = f.numel()
        out[k] = host[i:i + n].reshape(tuple(taps[k].shape))
        i += n
    return out
