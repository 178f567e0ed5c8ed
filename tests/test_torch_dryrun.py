"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's helpers, and what it counts on fake worlds of ranks.

* ``valid_cells``, ``analysis_plan``'s small configs and ``combine``,
  ``collective_bytes`` and ``_effective_data_axes`` equal the reference's
  (``repro.launch.dryrun``, imported only after JAX has initialized: its
  first line would otherwise give this process 512 host devices; its
  ``XLA_FLAGS`` is restored after).
* On a fake (2, 2) world, one cell of each kind runs and its
  ``arg_bytes`` equals the local shards' bytes counted from the specs;
  the ranks' records agree; ``roofline_terms``' combined flops equal the
  full-depth count.
* On one rank with no mesh, ``meta`` tensors and real CPU tensors give
  the same peak, flops and bytes accessed: the shape-only route drops no
  allocation.
* olmo-1b's ``train_4k`` runs on the (16, 16) world; the CLI resumes and
  records a failing cell; no process group outlives a fake world.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.configs import reduced
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              map_with_path, param_specs)
from repro_torch.launch import dryrun as D
from repro_torch.launch.input_specs import batch_struct, decode_struct
from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import (init_decode_caches, init_paged_caches,
                            init_params)
from repro_torch.nn.config import ShapeCell
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import init_train_state, train_state_specs

torch.set_num_threads(1)

ARCHS = sorted(tconfigs.ARCHS)

# The JAX package's dry-run test sample (tests/test_dryrun_helpers.py),
# copied: importing that file imports repro.launch.dryrun.
HLO_SAMPLE = """
  %ag = bf16[16,1024]{1,0} all-gather(%p0), replica_groups=[32,16]<=[512], dimensions={1}
  %ar = f32[8,256]{1,0} all-reduce(%dot), channel_id=1, replica_groups=[16,32]<=[512], to_apply=%add
  %rs = f32[4,64]{1,0} reduce-scatter(%x), replica_groups=[32,16]<=[512], dimensions={0}
  %aa = bf16[16,128,64]{2,1,0} all-to-all(%y), replica_groups=[32,16]<=[512]
  %cp = bf16[32,32]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %dot = f32[8,8]{1,0} dot(%a, %b)
"""

# Small cells of each kind (batch 4 splits over data = 2).
TRAIN = ShapeCell("train_t", 32, 4, "train")
PREFILL = ShapeCell("prefill_t", 32, 4, "prefill")
DECODE = ShapeCell("decode_t", 32, 4, "decode")
PAGED = ShapeCell("decode_32k", 32, 4, "decode")     # the paged cell name
FAMILY_ARCH = {"dense": "olmo-1b", "moe": "deepseek-v2-lite-16b",
               "ssm": "mamba2-370m", "hybrid": "zamba2-7b",
               "encdec": "seamless-m4t-medium"}
KIND_CASES = [(a, TRAIN) for a in FAMILY_ARCH.values()] + [
    ("olmo-1b", PREFILL), ("olmo-1b", DECODE), ("olmo-1b", PAGED),
    ("deepseek-v2-lite-16b", PAGED)]


@pytest.fixture(scope="module")
def ref():
    jax.devices()                     # the device count is fixed from here
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


def _small(arch, **kw):
    return reduced(tconfigs.get_config(arch)).with_(**kw)


# --------------------------------------------------- the pure helpers ---
def test_valid_cells_equal_reference(ref):
    got = {a: [c.name for c in D.valid_cells(tconfigs.get_config(a))]
           for a in ARCHS}
    want = {a: [c.name for c in ref.valid_cells(jconfigs.get_config(a))]
            for a in ARCHS}
    assert got == want
    assert sum(len(v) for v in got.values()) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_plan_equals_reference(ref, arch):
    smalls, combine = D.analysis_plan(tconfigs.get_config(arch))
    jsmalls, jcombine = ref.analysis_plan(jconfigs.get_config(arch))
    assert [t for t, _ in smalls] == [t for t, _ in jsmalls]
    for (_, c), (_, jc) in zip(smalls, jsmalls):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)

    # The reference test's affine cost model, and random per-tag terms.
    def fake_cost(c):
        if c.family in ("dense", "vlm", "ssm"):
            return 10.0 + 3.0 * c.layers
        if c.family == "moe":
            fd = c.moe.first_dense_layers
            return 10.0 + 5.0 * fd + 3.0 * (c.layers - fd)
        if c.family == "hybrid":
            return 10.0 + 3.0 * c.layers + 7.0 * (
                c.layers // c.hybrid.attn_every)
        e = c.encdec
        return 10.0 + 2.0 * e.n_enc_layers + 4.0 * e.n_dec_layers
    per = {t: {"flops": fake_cost(c)} for t, c in smalls}
    assert combine(per) == jcombine(per)
    assert combine(per)["flops"] == pytest.approx(
        fake_cost(tconfigs.get_config(arch)))
    rng = np.random.default_rng(len(arch))
    keys = ("flops", "bytes", "coll_all-gather", "coll_reduce-scatter")
    per = {t: {k: float(rng.uniform(0, 1e12)) for k in keys}
           for t, _ in smalls}
    assert combine(per) == jcombine(per)


def test_collective_bytes_equals_reference(ref):
    got = D.collective_bytes(HLO_SAMPLE)
    assert got == ref.collective_bytes(HLO_SAMPLE)
    assert set(got) == {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all"}
    permute = ("  %cq = bf16[8,8]{1,0} collective-permute(%z), "
               "replica_groups=[256,2]<=[512]\n")
    assert D.collective_bytes(permute) == ref.collective_bytes(permute) \
        == {"collective-permute": 128.0}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_effective_data_axes_equal_reference(ref, multi_pod):
    with D.production_world(multi_pod) as mesh:
        names = tuple(mesh.mesh_dim_names)
        jmesh = types.SimpleNamespace(
            axis_names=names,
            shape={a: mesh.size(i) for i, a in enumerate(names)})
        for b in (128, 32, 1):
            assert D._effective_data_axes(mesh, b) == \
                ref._effective_data_axes(jmesh, b), b


# ------------------------------------------------------ fake worlds -----
def _local_bytes(tree, specs, sizes) -> int:
    """numel × itemsize of each leaf's local block, from its spec and the
    mesh's axis sizes alone."""
    total = []

    def one(_p, t, spec):
        n = t.numel()
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes.get(a, 1)
        total.append(n * t.element_size())
    map_with_path(one, tree, specs)
    return sum(total)


def _expected_arg_bytes(cfg, cell, sizes, daxes) -> int:
    """The local argument bytes of a cell, from full ``meta`` trees."""
    def batch(c):
        b = batch_struct(c, cell)
        return _local_bytes(b, batch_specs(b, daxes), sizes)
    if cell.kind == "train":
        st = init_train_state(init_params(0, cfg, device="meta"),
                              AdamWConfig())
        return _local_bytes(st, train_state_specs(st), sizes) + batch(cfg)
    scfg = cfg.with_(param_dtype="bfloat16")
    p = init_params(0, scfg, device="meta")
    n = _local_bytes(p, param_specs(p), sizes)
    if cell.kind == "prefill":
        return n + batch(scfg)
    d = decode_struct(scfg, cell)
    n += _local_bytes(d, batch_specs(d, daxes), sizes)
    b = cell.global_batch
    if cell.name == "decode_32k":
        w = -(-cell.seq_len // 128)
        c = init_paged_caches(scfg, 1 + b * w, 128, device="meta")
        c_specs = cache_specs(c, daxes, paged=True)
        bt = {"bt": torch.empty((b, w), dtype=torch.int32, device="meta"),
              "active": torch.empty((b,), dtype=torch.bool, device="meta")}
        n += _local_bytes(bt, batch_specs(bt, daxes), sizes)
    else:
        c = init_decode_caches(scfg, b, cell.seq_len, device="meta",
                               enc_len=cell.seq_len)
        c_specs = cache_specs(c, daxes)
    return n + _local_bytes(c, c_specs, sizes)


@pytest.mark.parametrize("arch,cell", KIND_CASES,
                         ids=[f"{a}-{c.name}" for a, c in KIND_CASES])
def test_cell_runs_on_fake_world(arch, cell):
    cfg = _small(arch)
    with D.fake_world((2, 2), ("data", "model")) as mesh:
        rec = D.run_cell(cfg, cell, mesh)
        daxes = D._effective_data_axes(mesh, cell.global_batch)
    assert not dist.is_initialized()
    assert rec["ok"] and rec["world"] == 4 and rec["rank"] == 0
    assert rec["arg_bytes"] == _expected_arg_bytes(
        cfg, cell, {"data": 2, "model": 2}, daxes)
    assert rec["temp_bytes"] > 0 and rec["flops"] > 0
    assert rec["bytes_accessed"] > rec["arg_bytes"]
    assert rec["collectives"].get("all-gather", 0) > 0
    assert sum(rec["peak_split"].values()) == rec["arg_bytes"] + \
        rec["temp_bytes"]
    if cell.kind == "train":
        # a new state beside the old one: nothing donated
        assert rec["alias_bytes"] == 0
        assert rec["collectives"]["reduce-scatter"] > 0


@pytest.mark.parametrize("arch", ["olmo-1b", "internvl2-76b"])
def test_ranks_agree(arch):
    """Every rank of a (2, 2) world holds and moves the same bytes.  The
    work agrees too but where labels are missing: internvl2's frontend
    prefix (8 of 32 positions at this size) is half of model rank 0's
    block of 16, so its head runs 8 fewer positions of each of its 2
    sequences than model rank 1's, forward, dX and dW."""
    cfg = _small(arch)
    recs = []
    for rank in range(4):
        with D.fake_world((2, 2), ("data", "model"), rank=rank) as mesh:
            recs.append(D.run_cell(cfg, TRAIN, mesh))
    keys = ("arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
            "collectives", "peak_split")
    for r in recs[1:]:
        assert {k: r[k] for k in keys} == {k: recs[0][k] for k in keys}
    flops = [r["flops"] for r in recs]           # rank = 2 · data + model
    assert flops[0] == flops[2] and flops[1] == flops[3]
    head = 3 * 2 * (2 * 8) * cfg.d_model * cfg.padded_vocab
    assert flops[1] - flops[0] == (head if cfg.frontend else 0)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_roofline_combine_equals_full_depth(family):
    arch = FAMILY_ARCH[family]
    deeper = {"dense": dict(n_layers=4), "moe": dict(n_layers=5),
              "ssm": dict(n_layers=4), "hybrid": {}, "encdec": {}}
    cfg = _small(arch, **deeper[family])
    if family == "encdec":
        cfg = cfg.with_(encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=3, n_dec_layers=3))
    with D.fake_world((2, 2), ("data", "model")) as mesh:
        full, per = D.roofline_terms(cfg, TRAIN, mesh)
        direct = D.run_cell(cfg.with_(remat="none", scan_layers=False),
                            TRAIN, mesh, microbatches=1)
    assert len(per) >= 2
    assert full["flops"] == direct["flops"]


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_meta_equals_cpu(family):
    """One rank, no mesh: the same peak, flops and bytes accessed from
    meta tensors as from real CPU tensors.  The moe family's
    ``one_hot`` checks its indices' range on a device with data (a min and
    a max, 0.1% of the bytes), which meta skips."""
    cfg = _small(FAMILY_ARCH[family])
    cells = [TRAIN, DECODE] + ([PAGED] if family in ("dense", "moe")
                               else [])
    for cell in cells:
        m = D.run_cell(cfg, cell, None, device="meta")
        c = D.run_cell(cfg, cell, None, device="cpu")
        for k in ("arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
                  "flops", "peak_split"):
            assert m[k] == c[k], (cell.name, k)
        if family == "moe":
            assert m["bytes_accessed"] <= c["bytes_accessed"] <= \
                m["bytes_accessed"] * 1.001
        else:
            assert m["bytes_accessed"] == c["bytes_accessed"], cell.name


def test_full_size_cell_on_256_ranks():
    cfg = tconfigs.get_config("olmo-1b")
    cell = D.SHAPE_CELLS["train_4k"]
    with D.production_world() as mesh:
        rec = D.run_cell(cfg, cell, mesh)
    assert rec["ok"] and rec["world"] == 256
    assert rec["arg_bytes"] == _expected_arg_bytes(
        cfg, cell, {"data": 16, "model": 16}, ("data",))
    assert rec["temp_bytes"] > rec["arg_bytes"]
    assert not dist.is_initialized()


def test_fake_world_refuses_inside_a_group_and_cleans_up():
    with D.fake_world((2,), ("data",)):
        with pytest.raises(RuntimeError, match="no default process group"):
            with D.fake_world((2,), ("data",)):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with D.fake_world((1, 1), ("data", "model")):
            1 / 0
    assert not dist.is_initialized()


def test_make_mesh_still_refuses_cuda_without_nccl(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with D.fake_world((1,), ("data",)):
        with pytest.raises(RuntimeError, match="runs NCCL"):
            make_mesh((1,), ("data",), "cuda")


def test_cli_resumes_and_records_failures(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dry.json"
    argv = ["--arch", "olmo-1b", "--cell", "decode_32k", "--out", str(out)]
    D.main(argv)
    rec = json.loads(out.read_text())["olmo-1b/decode_32k"]
    assert rec["ok"] and rec["world"] == 256
    assert rec["lower_s"] is None and rec["trace_s"] >= 0
    assert capsys.readouterr().out.rstrip().endswith(
        f"[done] 1/1 cells ok → {out}")
    D.main(argv)
    assert "[skip] olmo-1b/decode_32k" in capsys.readouterr().out

    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(D, "run_cell", boom)
    D.main(["--arch", "olmo-1b", "--cell", "prefill_32k", "--out",
            str(out)])
    res = json.loads(out.read_text())
    assert res["olmo-1b/prefill_32k"]["ok"] is False
    assert "planted" in res["olmo-1b/prefill_32k"]["error"]
    assert capsys.readouterr().out.rstrip().endswith(
        f"[done] 1/2 cells ok → {out}")
    assert not dist.is_initialized()
