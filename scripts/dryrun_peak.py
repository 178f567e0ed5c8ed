#!/usr/bin/env python3
"""List what is live at the peak of one dry-run cell, storage by storage.

    PYTHONPATH=src python3 scripts/dryrun_peak.py --arch zamba2-7b \
        --cell decode_32k [--multi-pod] [--top 12]

Runs the cell as ``repro_torch.launch.dryrun.run_cell`` does, as rank 0 of
the fake (16, 16) world (``--multi-pod``: (2, 16, 16)) on ``meta``
tensors, with no device, and prints its temporary bytes (the peak of live
bytes less the arguments) and the ``--top`` largest storages made during
the call that are live at that peak: bytes, the ``aten`` op that made
each, its shape and dtype.  ``peak_split`` in the dry run's record says
only how the peak divides by role; this says which tensors hold it.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.nn.config import SHAPE_CELLS


class _Tracing(D._Tracker):
    """The dry run's storage tracker, remembering the op and the tensor
    that made each storage's record (by the record, which the peak's
    list keeps alive)."""

    last = None

    def __init__(self, device):
        super().__init__(device)
        self._op = None
        self.made: dict = {}
        _Tracing.last = self

    def _see(self, t, label):
        fresh = id(t.untyped_storage()) not in self._recs
        rec = super()._see(t, label)
        if fresh:
            self.made[id(rec)] = (self._op, tuple(t.shape), t.dtype)
        return rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True, choices=sorted(SHAPE_CELLS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    D._Tracker = _Tracing
    with D.production_world(args.multi_pod) as mesh:
        rec = D.run_cell(get_config(args.arch), SHAPE_CELLS[args.cell], mesh)
    tr = _Tracing.last
    rows = sorted(((r[0], r[1], tr.made.get(id(r)))
                   for r in tr._at_peak
                   if r[1] not in ("parameters", "optimizer state",
                                   "caches", "inputs")),
                  key=lambda row: -row[0])
    print(f"{args.arch} {args.cell}: temporaries "
          f"{rec['temp_bytes'] / 2**30:.3f} GiB; peak split "
          f"{rec['peak_split']}")
    for nb, label, made in rows[:args.top]:
        op, shape, dtype = made or ("?", "?", "?")
        print(f"  {nb / 2**20:10.1f} MiB  {label:12s} {op} {shape} {dtype}")


if __name__ == "__main__":
    main()
