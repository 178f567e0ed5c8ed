"""Guardrails: detectors over the numerics taps, wired to recovery.

The telemetry (``obs/``) gives the training loop sensors (saturation and
quantize-flush counters, the loss readout); this module makes something
*act* on them.  Three detectors — saturation storm, zero-flush spike,
nonfinite or spiking loss — feed three recovery policies:

* **Step rollback** from a bounded :class:`SnapshotRing` of state copies
  (weight codes, ⊞-momentum, rng): the cheap undo for transient faults (a
  bit-flip storm inside one step window).
* **Format widening**: a persistent saturation storm in a narrow layer
  becomes a :class:`~repro_torch.core.plan.NumericsPlan` override
  (``plan.with_rule(layer, fmt=<wider>)``); the model is rebuilt under
  the widened plan and the layer's codes are converted with the exact
  integer shifts of :func:`~repro_torch.core.lns.convert_format`, so
  widening loses nothing.  The override is counted (``guard.widened``)
  and the event log carries both plan strings.
* **Recovery of lost segment partials** (:func:`recover_segment_partials`):
  the canonical segmentation of the data-parallel reduce makes each
  segment partial a function of its own batch rows alone, so a lost
  rank's segments are *recomputed* and spliced into the surviving stack,
  and the fixed-schedule ⊞ combine gives codes **bit-identical** to the
  undamaged combine.

Everything here is host-side policy around the step: the step functions
stay as they are, and with the guardrails off the loop trains the codes
of ``train_step_metrics`` driven by hand.  Taps and the loss are read to
the host once per step.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..core.lns import convert_format
from ..obs.metrics import host_taps
from ..obs.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Detector thresholds + recovery policy switches.

    The all-off config (``GuardConfig(rollback=False, widen=False)``)
    reduces :class:`GuardedTrainer` to a plain metrics loop — same
    trained codes as driving ``train_step_metrics`` by hand.
    """

    sat_frac: float = 0.25      # saturations / elems per layer → storm
    flush_frac: float = 0.60    # zero-flushes (or q_flush) / elems → spike
    loss_abs: float = 1.0e4     # absolute loss ceiling
    loss_spike: float = 10.0    # × median of recent losses
    ring: int = 4               # snapshots kept (bounded memory)
    snapshot_every: int = 1     # push cadence in steps
    rollback: bool = True
    widen: bool = True
    widen_fmt: str = "lns16"    # target format of the widening override
    cooldown: int = 2           # steps to hold fire after a recovery


@dataclasses.dataclass(frozen=True)
class Alert:
    kind: str            # 'saturation-storm' | 'zero-flush-spike' |
                         # 'nonfinite-loss' | 'loss-spike'
    layer: Optional[str]  # None for loss alerts (not layer-attributable)
    value: float         # the offending fraction / loss value
    step: int


def _snapshot(tree):
    """A copy of a state tree (dicts of LNS tensors, tensors or numpy
    arrays) that no later step can alter; tensors stay on their device."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if hasattr(tree, "code") and hasattr(tree, "sign"):
        return type(tree)(_snapshot(tree.code), _snapshot(tree.sign))
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return np.array(tree, copy=True)


class SnapshotRing:
    """Bounded ring of training-state snapshots.

    Entries are copies (tensors cloned on their own device, so a snapshot
    costs no host sync), so a rollback is immune to whatever a later step
    does.  ``rng`` rides along for steps that thread one (the paper MLP's
    step has none; the slot keeps the snapshot's form stable).
    """

    def __init__(self, capacity: int):
        self._ring = collections.deque(maxlen=max(1, capacity))

    def push(self, step: int, params, momentum=None, rng=None):
        self._ring.append(
            (step, (_snapshot(params), _snapshot(momentum), _snapshot(rng))))

    def latest(self):
        """``(step, (params, momentum, rng))`` of the newest snapshot, or
        ``None`` when empty."""
        return self._ring[-1] if self._ring else None

    def __len__(self):
        return len(self._ring)


def detect(taps: dict, loss: float, cfg: GuardConfig,
           recent_losses=(), step: int = 0) -> List[Alert]:
    """Run the three detectors over one step's taps + loss readout.

    ``taps`` is the ``"layer/op/counter"`` dict a ``*_metrics`` entry
    point returns, read to the host (``obs.metrics.host_taps``).  Saturation and flush fractions are computed per
    (layer, op) pair against that pair's own ``elems``/``q_elems``
    denominator, and the *worst* offending pair per layer raises the
    alert — detectors read the raw taps, so they see exactly what the
    arithmetic saw (including injected faults: detection latency in the
    drills is measured in steps from injection to the first alert).
    """
    alerts: List[Alert] = []
    worst_sat: dict = {}
    worst_flush: dict = {}
    for label, v in taps.items():
        parts = label.split("/")
        if len(parts) != 3:
            continue
        layer, op, counter = parts
        v = np.asarray(v)
        if v.ndim != 0:
            continue  # dhist buckets etc.
        v = int(v)
        if counter == "sat":
            denom = int(np.asarray(taps.get(f"{layer}/{op}/elems", 0)))
            if denom:
                frac = v / denom
                if frac > worst_sat.get(layer, 0.0):
                    worst_sat[layer] = frac
        elif counter in ("zero", "q_flush"):
            dkey = f"{layer}/{op}/" + (
                "elems" if counter == "zero" else "q_elems")
            denom = int(np.asarray(taps.get(dkey, 0)))
            if denom:
                frac = v / denom
                if frac > worst_flush.get(layer, 0.0):
                    worst_flush[layer] = frac
    for layer in sorted(worst_sat):
        if worst_sat[layer] >= cfg.sat_frac:
            alerts.append(Alert("saturation-storm", layer,
                                worst_sat[layer], step))
    for layer in sorted(worst_flush):
        if worst_flush[layer] >= cfg.flush_frac:
            alerts.append(Alert("zero-flush-spike", layer,
                                worst_flush[layer], step))
    loss = float(loss)
    if not math.isfinite(loss):
        alerts.append(Alert("nonfinite-loss", None, loss, step))
    else:
        if loss > cfg.loss_abs:
            alerts.append(Alert("loss-spike", None, loss, step))
        elif recent_losses:
            med = float(np.median(np.asarray(recent_losses)))
            if med > 0 and loss > cfg.loss_spike * med:
                alerts.append(Alert("loss-spike", None, loss, step))
    return alerts


def _inner(model):
    """The per-layer LNSMLP view of a (possibly data-parallel) model."""
    return getattr(model, "inner", model)


class GuardedTrainer:
    """Host-side training loop: snapshot → step → detect → act.

    Drives the model's metrics entry point (``train_step_faults_metrics``
    with the step number when the model carries a
    :class:`~repro_torch.resil.inject.FaultPlan`, ``train_step_metrics``
    otherwise), reads the taps and the loss to the host once, feeds them
    to :func:`detect`, and applies the configured recovery:

    * loss alerts (nonfinite / spike) → **rollback** to the newest
      snapshot (this step's *pre*-state at ``snapshot_every=1``: the
      damaged update is discarded);
    * layer alerts (saturation storm / flush spike) → **widen** the layer
      via a plan override (and roll back when enabled, so the widened
      format resumes from undamaged codes).

    A ``cooldown`` holds recovery off for a few steps afterwards so that
    a fault window longer than one step cannot thrash the ring.  Every
    recovery is appended to :attr:`events` and counted in the registry
    (``guard.alerts`` / ``guard.rollbacks`` / ``guard.widened``).
    """

    def __init__(self, model, params, momentum=None, *,
                 guard: GuardConfig = GuardConfig(),
                 registry: Optional[MetricsRegistry] = None):
        self.model = model
        self.params = params
        self.momentum = momentum
        self.guard = guard
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ring = SnapshotRing(guard.ring)
        self.step_no = 0
        self.events: List[dict] = []
        self._cooldown = 0
        self._losses: collections.deque = collections.deque(maxlen=16)

    # -- one guarded step -------------------------------------------------
    def step(self, xb, yb) -> dict:
        g = self.guard
        if self.step_no % g.snapshot_every == 0:
            self.ring.push(self.step_no, self.params, self.momentum)
        model = self.model
        if getattr(model, "fault_plan", None) is not None:
            out, taps = model.train_step_faults_metrics(
                self.params, xb, yb, self.step_no, self.momentum)
        else:
            out, taps = model.train_step_metrics(
                self.params, xb, yb, self.momentum)
        if self.momentum is None:
            new_params, loss = out
            new_mom = None
        else:
            new_params, new_mom, loss = out
        loss = float(loss)
        taps = host_taps(taps)
        self.registry.merge_numerics_taps(taps,
                                          lanes=_inner(model).lanes())
        alerts = []
        action = None
        if self._cooldown > 0:
            self._cooldown -= 1
        else:
            alerts = detect(taps, loss, g, recent_losses=self._losses,
                            step=self.step_no)
        if alerts:
            self.registry.counter_inc("guard.alerts", len(alerts))
            layer_alerts = [a for a in alerts if a.layer is not None]
            if g.widen and layer_alerts:
                widened = self._widen(layer_alerts[0].layer)
                if widened:
                    action = "widen"
            if g.rollback and len(self.ring):
                snap_step, (p, m, _rng) = self.ring.latest()
                new_params, new_mom = p, m
                self.registry.counter_inc("guard.rollbacks")
                action = f"{action}+rollback" if action else "rollback"
                self.events.append(dict(
                    step=self.step_no, action="rollback",
                    to_step=snap_step,
                    alerts=[dataclasses.asdict(a) for a in alerts]))
            if action:
                self._cooldown = g.cooldown
        else:
            self._losses.append(loss)
        self.params, self.momentum = new_params, new_mom
        self.step_no += 1
        return dict(step=self.step_no - 1, loss=loss, alerts=alerts,
                    action=action)

    # -- recovery: per-layer format widening ------------------------------
    def _widen(self, layer: str) -> bool:
        """Rebuild the model with ``layer`` widened to
        ``guard.widen_fmt`` on the same device, and convert that layer's
        codes exactly.  Returns False (no-op) when the layer is already at
        least that wide."""
        from ..core.formats import FORMATS
        from ..paper.mlp import PARAM_LAYER, make_mlp
        inner = _inner(self.model)
        old_fmt = inner.fmts[layer]
        new_fmt = FORMATS[self.guard.widen_fmt]
        if old_fmt.qi + old_fmt.qf >= new_fmt.qi + new_fmt.qf:
            return False
        old_plan = inner.plan
        new_plan = old_plan.with_rule(layer, fmt=self.guard.widen_fmt)
        cfg = dataclasses.replace(self.model.cfg, spec=new_plan)
        self.model = make_mlp("lns", cfg, inner.device)
        for k, l in PARAM_LAYER.items():
            if l != layer:
                continue
            self.params = dict(self.params)
            self.params[k] = convert_format(self.params[k], old_fmt,
                                            new_fmt)
            if self.momentum is not None:
                self.momentum = dict(self.momentum)
                self.momentum[k] = convert_format(self.momentum[k],
                                                  old_fmt, new_fmt)
        self.registry.counter_inc("guard.widened", layer=layer)
        self.events.append(dict(
            step=self.step_no, action="widen", layer=layer,
            plan_before=str(old_plan), plan_after=str(new_plan)))
        return True

    # -- convenience ------------------------------------------------------
    def run(self, batches) -> List[dict]:
        return [self.step(xb, yb) for xb, yb in batches]


# -- recovery of lost segment partials ------------------------------------
def recover_segment_partials(inner, params, xb, yb, partials, *,
                             grad_segments: int, lost,
                             reduce_schedule: str = "sequential"):
    """Recompute lost segment partials and recombine canonically.

    ``partials`` is a per-parameter stack of per-segment gradient codes
    (leading segment axis, as ``per_segment_grads`` emits) in which the
    slots named by ``lost`` are unavailable — a dropped rank, a lost
    gather message (their contents are ignored).  The canonical
    segmentation makes slot ``s`` a function of segment ``s``'s batch
    rows alone, so each lost slot is recomputed from those rows
    (``per_segment_grads(rows_s, 1)``), spliced in, and the whole stack
    combined on the fixed schedule: the combined gradients are
    **bit-identical** to the undamaged combine's.

    Returns ``{param: combined grad}`` (pass to ``apply_updates``).
    """
    from ..distributed.lns_reduce import combine_partials_many
    b = xb.shape[0]
    if b % grad_segments:
        raise ValueError(
            f"batch {b} not divisible into {grad_segments} segments")
    seg = b // grad_segments
    lost = sorted(set(int(s) for s in lost))
    for s in lost:
        if not (0 <= s < grad_segments):
            raise ValueError(
                f"lost segment {s} out of range [0, {grad_segments})")
    x, y = inner._inputs(xb, yb)
    repaired = dict(partials)
    for s in lost:
        sl = slice(s * seg, (s + 1) * seg)
        g1, _ = inner.per_segment_grads(params, x[sl], y[sl], 1)
        for k, g in repaired.items():
            code, sign = g.code.clone(), g.sign.clone()
            code[s] = g1[k].code[0]
            sign[s] = g1[k].sign[0]
            repaired[k] = type(g)(code, sign)
    return combine_partials_many(repaired, inner.param_engines,
                                 schedule=reduce_schedule)


def shrink(model, surviving: int):
    """Rebuild a data-parallel model on ``surviving`` ranks (after a rank
    is lost), on the same device.

    The canonical segmentation is fixed by the plan's
    ``reduce.grad_segments``, so the shrunk model trains bit-identically
    to the model before the loss (``surviving`` must divide
    ``grad_segments``).
    """
    from ..distributed.lns_dp import LNSDataParallelMLP
    if not isinstance(model, LNSDataParallelMLP):
        raise TypeError("shrink() applies to LNSDataParallelMLP models")
    dp = dataclasses.replace(model.dp, num_devices=surviving)
    return LNSDataParallelMLP(model.cfg, dp, model.inner.device)
