"""Multi-pod dry run: every (arch × shape) cell's step run by one rank of a
fake world of 256 or 512 ranks, on ``meta`` tensors.

The JAX package lowers and compiles each cell against abstract inputs and
reads XLA's memory and cost analyses and the collectives in the HLO.
PyTorch has no compile step to read, so this module **runs** the step, at
one rank's local shapes, with no data:

1. :func:`fake_world` opens a ``fake`` process group (``FakeStore``; its
   collectives return at once and move nothing) of ``prod(shape)`` ranks
   and a ``DeviceMesh`` over it: (16, 16) single-pod or (2, 16, 16)
   multi-pod, as ``make_production_mesh`` names them;
2. :func:`build_cell` builds the cell's step (AdamW train step, bf16
   prefill, paged or dense decode) and this rank's local shards of its
   inputs: ``shard_tree`` of trees on the ``meta`` device;
3. :func:`run_cell` calls the step once under three counters: a dispatch
   mode that follows every storage the step holds (the peak of live
   bytes, and what was live at it), ``FlopCounterMode``, and
   :func:`~repro_torch.distributed.spmd.count_collectives` (bytes on the
   wire per kind, on the ring cost model of :func:`collective_bytes`);
4. :func:`roofline_terms` runs 1-, 2- and 3-layer variants and combines
   them affinely into full-depth terms, as the JAX package does.  Eager
   execution counts every layer, so the combination can be checked
   against the full-depth count.

Why ``meta`` and not ``FakeTensorMode`` on ``cuda``: the port's trees
already come on ``meta`` (``init_params(..., device="meta")``,
``input_specs``), and a meta tensor is not a CUDA tensor, so a ⊞-MAC lane
(``kernels/_common.py: lane``) raises instead of trying to launch a kernel
on storage that does not exist.  Every arch's own numerics is bf16, so no
⊞-MAC is reached; the dry run runs the ops that the card runs, and
allocates nothing.

Ranks do not all do the same work: rank 0 is recorded.  Where the
frontend prefix of a vlm stream covers a rank's whole block of the
sequence, ``chunked_ce_loss`` finds no label there and adds zero terms
instead of its head product; a batch that does not divide the data axes is
replicated over them (:func:`_effective_data_axes`).  Shapes and so bytes
are otherwise the same on every rank.

Results go to ``src/repro_torch/benchmarks/results/dryrun_<tag>.json``,
keyed ``<arch>/<cell>``, with the JAX package's record keys.  Run it with
``python -m repro_torch.launch.dryrun [--arch A] [--cell C] [--multi-pod]
[--roofline] [--out PATH]``; it needs no card and no process group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..distributed.sharding import (axis_size, batch_specs, cache_specs,
                                    map_with_path, param_specs, shard_tree)
from ..distributed.spmd import count_collectives, wire_bytes
from ..nn import (PAGED_FAMILIES, Runtime, decode_step, decode_step_paged,
                  init_decode_caches, init_paged_caches, init_params)
from ..nn.config import SHAPE_CELLS, HybridConfig, ModelConfig, ShapeCell
from ..nn.model import prefill
from ..optim.optimizers import AdamWConfig
from ..train.step import (TrainConfig, init_train_state, make_train_step,
                          train_state_specs)
from .input_specs import batch_struct, decode_struct
from .mesh import data_axes

RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "results")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"= ([^=]*?) (all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")
_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|s64|s32|u32|s16|u16|s8|u8|pred)"
                       r"\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_EXPL_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes on the wire per collective kind of an HLO text (the
    JAX package's dry-run records), on :func:`wire_bytes`' ring model: the
    twin of the port's own counter, so that one reader takes both."""
    out = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shapes, kind = m.group(1), m.group(2)
        size = 0
        for dt, dims in _SHAPE_RE.findall(shapes):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            size += n * _DTYPE_BYTES[dt]
        g = None
        gm = _GROUPS_RE.search(line)
        if gm:
            g = int(gm.group(2))
        else:
            gm = _GROUPS_EXPL_RE.search(line)
            if gm:
                g = len(gm.group(1).split(","))
        if not g or g <= 1:
            continue
        out[kind] = out.get(kind, 0.0) + wire_bytes(kind, size, g)
    return out


# ------------------------------------------------------------ world ------
@contextlib.contextmanager
def fake_world(shape, axes, rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` named ``axes``, seen from ``rank``, on
    a ``fake`` process group of ``prod(shape)`` ranks in this one process.
    Its collectives move nothing and return at once (on ``meta`` tensors
    they only give shapes).  Refuses to start inside an existing default
    group; always destroys its own on exit.  Not ``launch/mesh.py:
    make_mesh``, whose checks (NCCL on ``cuda``, a card a rank) hold for
    real meshes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no default "
                           "process group; one is initialized")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), world_size=n,
                            rank=rank)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def production_world(multi_pod: bool = False, rank: int = 0):
    """:func:`fake_world` at ``make_production_mesh``'s shape and axes."""
    if multi_pod:
        return fake_world((2, 16, 16), ("pod", "data", "model"), rank)
    return fake_world((16, 16), ("data", "model"), rank)


# ------------------------------------------------------------ cells ------
def valid_cells(cfg: ModelConfig):
    cells = [SHAPE_CELLS["train_4k"], SHAPE_CELLS["prefill_32k"],
             SHAPE_CELLS["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPE_CELLS["long_500k"])
    return cells


def _effective_data_axes(mesh, b):
    """Largest data-axis set that divides the (small) decode batch."""
    axes = data_axes(mesh)
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    if b % n == 0:
        return axes
    if "data" in axes and b % axis_size(mesh, "data") == 0:
        return ("data",)
    return ()


def _local(tree, specs, mesh):
    return tree if mesh is None else shard_tree(tree, specs, mesh)


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh, *,
               microbatches: int | None = None, device="meta"):
    """``(fn, args, roles)`` of one cell: the step, this rank's local
    shards of its inputs on ``device`` (``meta``: shapes only; ``cpu``
    with ``mesh=None``: real tensors, for checking the shape-only route),
    and what each argument is (``state``, ``parameters``, ``caches``,
    ``inputs``).  The JAX package's ``build_cell`` (``donate`` aside: the
    port's steps return new trees and keep their inputs)."""
    abstract = str(device) == "meta"
    daxes = () if mesh is None else _effective_data_axes(
        mesh, cell.global_batch)
    rt = Runtime() if mesh is None else Runtime(mesh=mesh, data_axes=daxes)

    def batch_of(c):
        b = batch_struct(c, cell, abstract=abstract, device=device)
        return _local(b, batch_specs(b, daxes), mesh)

    if cell.kind == "train":
        opt = AdamWConfig()
        # ≥20B-param models need gradient accumulation to fit activations
        # at (256 × 4k) global batch, as in the JAX package.
        mb = (4 if cfg.param_count() > 2e10 else 1) \
            if microbatches is None else microbatches
        tc = TrainConfig(grad_clip=1.0, microbatches=mb)
        state = init_train_state(init_params(0, cfg, device=device), opt, tc)
        state = _local(state, train_state_specs(state), mesh)
        step = make_train_step(cfg, opt, rt, tc)
        return step, (state, batch_of(cfg)), ("state", "inputs")
    scfg = cfg.with_(param_dtype="bfloat16")
    params = init_params(0, scfg, device=device)
    params = _local(params, param_specs(params), mesh)
    if cell.kind == "prefill":
        def fn(p, b):
            return prefill(p, b, scfg, rt)
        return fn, (params, batch_of(scfg)), ("parameters", "inputs")
    # decode
    b = cell.global_batch
    x = decode_struct(scfg, cell, abstract=abstract, device=device)
    if cell.name == "decode_32k" and scfg.family in PAGED_FAMILIES:
        # The serving data plane, as the engine drives it: a shared pool
        # of 128-line blocks at full occupancy plus the null block, the
        # slots' block tables and an active mask.  long_500k keeps the
        # dense path: an SSM state is O(1) a slot, nothing to page.
        blk = 128
        w = -(-cell.seq_len // blk)
        caches = init_paged_caches(scfg, 1 + b * w, blk, torch.bfloat16,
                                   device=device)
        caches = _local(caches, cache_specs(caches, daxes, paged=True),
                        mesh)
        x["bt"] = 1 + torch.arange(b * w, dtype=torch.int32,
                                   device=device).reshape(b, w)
        x["active"] = torch.ones((b,), dtype=torch.bool, device=device)
        x = _local(x, batch_specs(x, daxes), mesh)

        def pfn(p, tok, c, bt, pos, active):
            with torch.no_grad():
                return decode_step_paged(p, tok, c, bt, pos, active, scfg,
                                         rt)
        return (pfn, (params, x["tok"], caches, x["bt"], x["pos"],
                      x["active"]),
                ("parameters", "inputs", "caches", "inputs", "inputs",
                 "inputs"))
    enc_len = cell.seq_len if scfg.family in ("encdec", "audio") else None
    caches = init_decode_caches(scfg, b, cell.seq_len, torch.bfloat16,
                                enc_len=enc_len, device=device)
    caches = _local(caches, cache_specs(caches, daxes), mesh)
    x = _local(x, batch_specs(x, daxes), mesh)

    def fn(p, tok, c, pos):
        with torch.no_grad():
            return decode_step(p, tok, c, pos, scfg, rt)
    return (fn, (params, x["tok"], caches, x["pos"]),
            ("parameters", "inputs", "caches", "inputs"))


# ---------------------------------------------------------- counting -----
def _tensors(tree) -> list:
    """The tensors of a tree, namedtuple caches descended into."""
    out: list = []
    map_with_path(lambda _p, t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storages(tree) -> dict:
    """{id(storage): bytes} of the distinct storages of a tree."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(tree)}


class _Tracker(TorchDispatchMode):
    """Follows every storage of ``device``'s type that the call holds:
    the ones registered before (:meth:`hold`) and each output of an op.  A
    storage counts its bytes from its first sight until it is freed, as
    the card's allocator would (which also rounds a block up to 512 bytes
    and keeps cuBLAS's workspace; not modelled).  Keeps the peak of live
    bytes, the storages live at it (labelled; see :meth:`split`), and the
    input and output bytes of every ``aten`` op that is not a view (eager
    execution's traffic)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self._recs: dict = {}        # id(storage) → [bytes, label, ref]
        self.live = self.peak = self.accessed = 0
        self._at_peak: list = []
        self._phase = "activations"

    def _free(self, key):
        rec = self._recs.pop(key, None)
        if rec is not None:
            self.live -= rec[0]

    def _see(self, t, label):
        st = t.untyped_storage()
        key = id(st)
        rec = self._recs.get(key)
        if rec is None:
            rec = [st.nbytes(), label,
                   weakref.ref(st, lambda _r, k=key: self._free(k))]
            self._recs[key] = rec
            self.live += rec[0]
        return rec

    def hold(self, tree, label):
        """Register ``tree``'s storages (or relabel the ones seen) as
        ``label``."""
        for t in _tensors(tree):
            self._see(t, label)[1] = label
        self._mark()

    def _mark(self):
        if self.live > self.peak:
            self.peak = self.live
            self._at_peak = list(self._recs.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._current_graph_task_id() != -1:
            self._phase = "backward"
        elif self._phase == "backward":       # a backward just ended:
            for rec in self._recs.values():   # what it left are gradients
                if rec[1] == "backward":
                    rec[1] = "gradients"
            self._phase = "after backward"
        outs = _tensors(out)
        if func.namespace == "aten" and not func.is_view:
            self.accessed += sum(_nbytes(t) for t in
                                 _tensors((args, kwargs)) + outs)
        for t in outs:
            if t.device.type == self.device.type:
                self._see(t, self._phase)
        self._mark()
        return out

    def split(self) -> dict:
        """Bytes live at the peak by label: the arguments' ``parameters``,
        ``optimizer state``, ``caches`` and ``inputs``; ``activations``
        (made before any backward), ``gradients`` (made by a backward and
        alive after it), ``temporaries`` (made by a backward and freed in
        it), ``after backward`` (made after a backward and not returned:
        the clip's scaled gradients, the optimizer's intermediates, a
        later microbatch's forward); and the returned ``new parameters``,
        ``new optimizer state``, ``new caches`` and ``outputs``."""
        out: dict = {}
        for nb, label, _ in self._at_peak:
            label = "temporaries" if label == "backward" else label
            out[label] = out.get(label, 0) + nb
        return out


def _state_roles(state, new: str):
    return [(state["params"], new + "parameters"),
            ({k: v for k, v in state.items() if k != "params"},
             new + "optimizer state")]


def _arg_roles(args, roles):
    """(tree, label) of each argument of a cell's call."""
    out = []
    for a, r in zip(args, roles):
        out += _state_roles(a, "") if r == "state" else [(a, r)]
    return out


def _out_roles(kind: str, out):
    """(tree, label) of each output of a cell's call."""
    if kind == "train":
        new_state, metrics = out
        return _state_roles(new_state, "new ") + [(metrics, "outputs")]
    logits, caches = out
    return [(logits, "outputs"), (caches, "new caches")]


def run_cell(cfg: ModelConfig, cell: ShapeCell, mesh, *,
             microbatches: int | None = None, device="meta"):
    """Run one cell's step once on this rank's local inputs and count it.

    The record has the JAX package's keys: ``arg_bytes`` (the local bytes
    of the arguments), ``out_bytes``, ``temp_bytes`` (the peak of live
    bytes during the call less ``arg_bytes``), ``alias_bytes`` (output
    bytes that share storage with an argument), ``flops``
    (``FlopCounterMode``), ``bytes_accessed`` (the input and output bytes
    of every ``aten`` op that is not a view: eager execution's traffic,
    not a fused program's), ``collectives`` (bytes on the wire per kind,
    this rank's share), with ``trace_s`` (the call's wall seconds) where
    the JAX package has ``lower_s`` / ``compile_s`` (null here), ``world``
    and ``rank``; and ``peak_split``, the live bytes at the peak by what
    they hold (:meth:`_Tracker.split`)."""
    fn, args, roles = build_cell(cfg, cell, mesh,
                                 microbatches=microbatches, device=device)
    tracker = _Tracker(device)
    for tree, label in _arg_roles(args, roles):
        tracker.hold(tree, label)
    arg_st = _storages(args)
    arg_bytes = sum(arg_st.values())
    # Frees happen as references drop, as on the card; the cyclic
    # collector, whose timing varies, stays off during the call.
    gc.collect()
    gc.disable()
    t0 = time.time()
    try:
        with count_collectives() as coll, \
                FlopCounterMode(display=False) as fc, tracker:
            out = fn(*args)
    finally:
        gc.enable()
    trace_s = time.time() - t0
    for tree, label in _out_roles(cell.kind, out):
        for t in _tensors(tree):
            if id(t.untyped_storage()) not in arg_st:
                tracker.hold(t, label)
    out_st = _storages(out)
    world = 1 if mesh is None else dist.get_world_size()
    return {
        "ok": True,
        "lower_s": None,
        "compile_s": None,
        "trace_s": round(trace_s, 2),
        "arg_bytes": arg_bytes,
        "out_bytes": sum(out_st.values()),
        "temp_bytes": tracker.peak - arg_bytes,
        "alias_bytes": sum(v for k, v in out_st.items() if k in arg_st),
        "flops": float(fc.get_total_flops()),
        "bytes_accessed": float(tracker.accessed),
        "collectives": dict(coll),
        "peak_split": tracker.split(),
        "world": world,
        "rank": 0 if mesh is None else dist.get_rank(),
    }


# ------------------------------------------------ roofline small runs --
def analysis_plan(cfg: ModelConfig):
    """(tag, small cfg) runs + per-arch ``combine()`` → full-depth terms.

    Every small is unrolled (``scan_layers=False``, ``remat="none"``), as
    the JAX package's; dims other than depth stay at full scale.
    """
    base = dict(scan_layers=False, remat="none")
    fam = cfg.family
    if fam in ("dense", "vlm", "ssm"):
        smalls = [("L1", cfg.with_(layer_override=1, **base)),
                  ("L2", cfg.with_(layer_override=2, **base))]

        def combine(c):
            per = {k: c["L2"][k] - c["L1"][k] for k in c["L1"]}
            return {k: c["L1"][k] + (cfg.n_layers - 1) * per[k]
                    for k in per}
    elif fam == "moe":
        smalls = [("L2", cfg.with_(layer_override=2, **base)),
                  ("L3", cfg.with_(layer_override=3, **base))]

        def combine(c):
            per = {k: c["L3"][k] - c["L2"][k] for k in c["L2"]}
            return {k: c["L2"][k] + (cfg.n_layers - 2) * per[k]
                    for k in per}
    elif fam == "hybrid":
        smalls = [
            ("A", cfg.with_(layer_override=1,
                            hybrid=HybridConfig(attn_every=1), **base)),
            ("B", cfg.with_(layer_override=2,
                            hybrid=HybridConfig(attn_every=1), **base)),
            ("C", cfg.with_(layer_override=2,
                            hybrid=HybridConfig(attn_every=2), **base)),
        ]

        def combine(c):
            mamba = {k: c["C"][k] - c["A"][k] for k in c["A"]}
            attn = {k: c["B"][k] - c["A"][k] - mamba[k] for k in c["A"]}
            n_attn = cfg.n_layers // cfg.hybrid.attn_every
            return {k: c["A"][k] - mamba[k] - attn[k]
                    + cfg.n_layers * mamba[k] + n_attn * attn[k]
                    for k in c["A"]}
    elif fam in ("encdec", "audio"):
        e = cfg.encdec
        mk = lambda ne, nd: cfg.with_(
            encdec=dataclasses.replace(e, n_enc_layers=ne, n_dec_layers=nd),
            **base)
        smalls = [("E1D1", mk(1, 1)), ("E2D1", mk(2, 1)), ("E1D2", mk(1, 2))]

        def combine(c):
            enc = {k: c["E2D1"][k] - c["E1D1"][k] for k in c["E1D1"]}
            dec = {k: c["E1D2"][k] - c["E1D1"][k] for k in c["E1D1"]}
            return {k: c["E1D1"][k]
                    + (e.n_enc_layers - 1) * enc[k]
                    + (e.n_dec_layers - 1) * dec[k] for k in c["E1D1"]}
    else:
        raise ValueError(fam)
    return smalls, combine


def roofline_terms(cfg: ModelConfig, cell: ShapeCell, mesh):
    """Full-depth per-rank {flops, bytes, coll_*} via the affine smalls."""
    smalls, combine = analysis_plan(cfg)
    per = {}
    for tag, small in smalls:
        # microbatches=1, as the JAX package's (whose cost analysis counts
        # a scan body once)
        rec = run_cell(small, cell, mesh, microbatches=1)
        terms = {"flops": rec["flops"] or 0.0,
                 "bytes": rec["bytes_accessed"] or 0.0}
        for k, v in rec.get("collectives", {}).items():
            terms[f"coll_{k}"] = v
        per[tag] = terms
    keys = set()
    for t in per.values():
        keys.update(t)
    for t in per.values():
        for k in keys:
            t.setdefault(k, 0.0)
    return combine(per), per


# --------------------------------------------------------------- main ----
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="also run the unrolled smalls for roofline terms")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    tag = "multipod" if args.multi_pod else "pod"
    path = args.out or os.path.join(RESULTS_DIR, f"dryrun_{tag}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    with production_world(args.multi_pod) as mesh:
        for name in archs:
            cfg = get_config(name)
            for cell in valid_cells(cfg):
                if args.cell != "all" and cell.name != args.cell:
                    continue
                key = f"{name}/{cell.name}"
                if results.get(key, {}).get("ok") and not args.roofline:
                    print(f"[skip] {key}")
                    continue
                print(f"[dryrun:{tag}] {key} ...", flush=True)
                try:
                    rec = results.get(key) or {}
                    if not rec.get("ok"):
                        rec = run_cell(cfg, cell, mesh)
                        print(f"  trace {rec['trace_s']}s  "
                              f"temp/dev {rec['temp_bytes']/2**30:.2f} GiB  "
                              f"args/dev {rec['arg_bytes']/2**30:.2f} GiB")
                    if args.roofline and "roofline" not in rec:
                        full, per = roofline_terms(cfg, cell, mesh)
                        rec["roofline"] = full
                        rec["roofline_smalls"] = per
                        print(f"  roofline flops/dev {full['flops']:.3e}")
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"  FAILED {rec['error']}")
                results[key] = rec
                with open(path, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"[done] {n_ok}/{len(results)} cells ok → {path}")
    return results


if __name__ == "__main__":
    main()
