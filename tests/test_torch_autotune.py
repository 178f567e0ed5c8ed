"""The launch-geometry autotuner (``repro_torch.kernels.autotune``): the
candidates per op and form, the cache discipline the JAX package's tuner
has, the ``blocks`` axis routed to the tiled ⊞-MAC's rows per block, and
the invariant that no choice changes a result.

On the CPU the wrappers run the plain versions, which read no launch
parameter, so the routing tests make the ⊞-MAC wrappers' lane answer
"cuda" with the plain version as the launcher and record the
``block_rows`` each launch is given.
"""
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import DELTA_DEFAULT as J_DELTA, LNS16 as J_LNS16
from repro.core.delta import DeltaEngine as JDeltaEngine
from repro.distributed.lns_reduce import dp_combine_blocks as j_dp_blocks
import repro_torch.core as T
from repro_torch.core import (DELTA_DEFAULT, LNS16, NumericsPlan,
                              NumericsSpec, encode)
from repro_torch.distributed.lns_reduce import dp_combine_blocks
from repro_torch.kernels import autotune
from repro_torch.kernels.lns_matmul.lns_matmul import check_launch_limits
from repro_torch.paper import MLPConfig, make_mlp, datasets

torch.set_num_threads(1)

TILED = [(4, 32, 32), (8, 32, 32), (2, 32, 32), (1, 32, 32)]
KW = dict(fmt=LNS16, spec=DELTA_DEFAULT)


@pytest.fixture
def tuner_dir(tmp_path, monkeypatch):
    """Isolated persistent-cache dir + clean in-memory caches."""
    monkeypatch.setenv("LNS_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.delenv("LNS_AUTOTUNE_DISABLE", raising=False)
    autotune.clear_caches()
    yield str(tmp_path)
    autotune.clear_caches()


@pytest.fixture
def launches(monkeypatch):
    """The ⊞-MAC launches as (contracted axes, R, C, CT, block_rows), the
    plain version standing in for the kernel."""
    K = sys.modules["repro_torch.kernels.lns_matmul.lns_matmul"]
    seen = []

    def launch(a_code, a_sign, b_code, b_sign, *, a_contract_axis,
               b_contract_axis, block_rows=4, **kw):
        seen.append(((a_contract_axis, b_contract_axis),
                     a_code.shape[1 - a_contract_axis],
                     b_code.shape[1 - b_contract_axis],
                     a_code.shape[a_contract_axis], block_rows))
        return K.mac_plain(a_code, a_sign, b_code, b_sign,
                           a_contract_axis=a_contract_axis,
                           b_contract_axis=b_contract_axis,
                           block_rows=block_rows, **kw)
    monkeypatch.setattr(K, "lane", lambda t, kernel="": "cuda")
    monkeypatch.setattr(K, "mac_cuda", launch)
    return seen


# ----------------------------------------------------------- candidates

CASES = [  # op, (R, C, CT), candidates
    ("fwd", (5, 100, 784), TILED),
    ("fwd", (500, 10, 100), TILED),
    ("fwd", (5, 100, 13), TILED),
    ("fwd", (5, 100, 12), [(1, 128, 12)]),
    ("dx", (5, 100, 10), [(1, 128, 10)]),
    ("dx", (256, 2048, 8192), TILED),
    ("dw", (784, 100, 5), [(1, 128, 5)]),
    ("dw", (784, 100, 500), TILED),
    ("dw_partials", (784, 100, 1), [(1, 128, 1)]),
    ("dw_partials", (784, 100, 100), TILED),
    ("boxsum", (78400, 1, 5), [(128, 1, 5)]),
    ("boxsum", (10, 1, 5), [(32, 1, 5)]),
    ("boxsum", (100, 1, 300), [(128, 1, 300)]),
]


@pytest.mark.parametrize("op,shape,want", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_candidates_and_heuristic_per_op_and_form(op, shape, want):
    assert autotune.candidate_blocks(op, shape) == want
    assert autotune.heuristic_blocks(op, shape) == want[0]
    assert autotune.tiled(op, shape) == (want == TILED)
    if want == TILED:
        assert autotune.heuristic_blocks(op, shape) == (4, 32, 32)
        assert autotune.candidate_blocks(op, shape, max_candidates=2) \
            == TILED[:2]
    for b in want:
        assert autotune.smem_bytes(op, b) <= autotune.DEFAULT_SMEM_BUDGET


def test_smem_budget_and_unknown_op():
    # The 8-row tile holds 29 224 bytes of static shared memory.
    assert autotune.smem_bytes("fwd", (8, 32, 32)) == 29224
    assert autotune.candidate_blocks("fwd", (5, 100, 784),
                                     smem_budget=27000) \
        == [(2, 32, 32), (1, 32, 32)]
    assert autotune.candidate_blocks("fwd", (5, 100, 784),
                                     smem_budget=1000) == [(4, 32, 32)]
    with pytest.raises(ValueError, match="unknown autotune op"):
        autotune.candidate_blocks("gemm", (8, 8, 8))
    with pytest.raises(ValueError, match="unknown autotune op"):
        autotune.lookup("gemm", (8, 8, 8), **KW)


@pytest.mark.parametrize("m,rows", [(1, 1), (2, 2), (3, 2), (4, 4), (7, 4),
                                    (8, 8), (16, 8), (128, 8)])
def test_explicit_blocks_map_to_rows(m, rows):
    assert autotune.rows_for(m) == rows
    be = NumericsSpec.parse(f"lns16-train-pallas,blocks={m}x8x32") \
        .runtime().matmul
    assert be.blocks == f"{m}x8x32" and be.block_m == m
    assert be._op_blocks("fwd", 5, 100, 784) == (rows, 32, 32)
    assert be._op_blocks("dw", 784, 100, 5) == (1, 128, 5)   # short form
    default = NumericsSpec.parse("lns16-train-pallas").runtime().matmul
    assert default._op_blocks("fwd", 5, 100, 784) == (4, 32, 32)


def test_check_launch_limits_counts_row_tiles_by_block_rows():
    check_launch_limits(2**31 - 1, 32, 13, 1, (13, 32), 12, block_rows=1)
    with pytest.raises(ValueError, match="tiles"):
        check_launch_limits(2**31, 32, 13, 1, (13, 32), 12, block_rows=1)
    check_launch_limits(8 * (2**31 - 1), 32, 13, 1, (13, 32), 12,
                        block_rows=8)
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match="block_rows"):
            check_launch_limits(5, 5, 13, 1, (13, 5), 12, block_rows=bad)


# ------------------------------------------------------ cache discipline

def test_lookup_measures_once_and_persists(tuner_dir):
    calls = []

    def stub(op, shape, blocks):
        calls.append(blocks)
        return 1.0 if blocks == (2, 32, 32) else 2.0

    shape = (5, 100, 784)
    best = autotune.lookup("fwd", shape, **KW, measure=True,
                           measure_fn=stub)
    assert best == (2, 32, 32) and calls == TILED
    assert autotune.lookup("fwd", shape, **KW, measure=True,
                           measure_fn=stub) == best
    autotune.clear_caches()
    assert autotune.lookup("fwd", shape, **KW, measure=True,
                           measure_fn=stub) == best
    assert len(calls) == 4


def test_shallow_entry_does_not_satisfy_deeper_lookup(tuner_dir):
    calls = []

    def stub(op, shape, blocks):
        calls.append(blocks)
        return float(blocks[0])        # fewest rows wins

    shape = (5, 100, 784)
    shallow = autotune.lookup("fwd", shape, **KW, measure=True,
                              measure_fn=stub, max_candidates=2, reps=1)
    assert shallow == (4, 32, 32) and len(calls) == 2
    deep = autotune.lookup("fwd", shape, **KW, measure=True,
                           measure_fn=stub, max_candidates=8, reps=2)
    assert deep == (1, 32, 32) and len(calls) == 6
    autotune.clear_caches()
    assert autotune.lookup("fwd", shape, **KW, measure=True,
                           measure_fn=stub, max_candidates=2,
                           reps=1) == deep
    assert len(calls) == 6
    autotune.clear_caches()
    assert autotune.lookup("fwd", shape, **KW, measure=False,
                           max_candidates=16) == deep


def test_cache_file_stamped_with_env_and_commit(tuner_dir):
    autotune.lookup("fwd", (8, 8, 40), **KW, measure=True,
                    measure_fn=lambda *a: 1.0)
    with open(autotune.cache_path()) as f:
        data = json.load(f)
    assert data["env"] == autotune.env_stamp()
    assert data["env"]["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert data["env"]["device"] == "cpu"
    (entry,) = data["entries"].values()
    assert set(entry) >= {"blocks", "ms", "commit", "time", "search"}
    assert entry["search"]["max_candidates"] == 8


def test_mismatched_env_cache_ignored(tuner_dir):
    autotune.lookup("fwd", (8, 8, 40), **KW, measure=True,
                    measure_fn=lambda *a: 1.0)
    path = autotune.cache_path()
    with open(path) as f:
        data = json.load(f)
    data["env"]["torch"] = "0.0.0-other"
    with open(path, "w") as f:
        json.dump(data, f)
    autotune.clear_caches()
    calls = []
    autotune.lookup("fwd", (8, 8, 40), **KW, measure=True,
                    measure_fn=lambda *a: calls.append(a) or 1.0)
    assert calls, "stale-env entries were trusted"


@pytest.mark.parametrize("junk", ['{"env": ', "[1, 2]"])
def test_corrupt_cache_quarantined_once(tuner_dir, junk):
    path = autotune.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    autotune._WARNED_CORRUPT.discard(path)
    with open(path, "w") as f:
        f.write(junk)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        got = autotune.lookup("fwd", (8, 8, 40), **KW, measure=True,
                              measure_fn=lambda *a: 1.0)
    assert got == (4, 32, 32)
    assert os.path.exists(path + ".corrupt")
    with open(path) as f:
        assert json.load(f)["entries"]   # re-tuned into a fresh file
    with open(path, "w") as f:
        f.write(junk)
    autotune.clear_caches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # one warning per file
        autotune.lookup("fwd", (8, 8, 40), **KW, measure=True,
                        measure_fn=lambda *a: 1.0)


def test_nonmeasurable_miss_falls_back_to_heuristic(tuner_dir):
    assert autotune.lookup("fwd", (16, 8, 40), **KW, measure=False) \
        == (4, 32, 32)
    assert not os.path.exists(autotune.cache_path())


def test_cpu_lane_measures_nothing(tuner_dir):
    """The plain versions read no launch parameter: a CPU-lane lookup
    (``interpret=True``) resolves to the heuristic and persists
    nothing."""
    assert autotune.lookup("fwd", (16, 8, 40), **KW, interpret=True) \
        == (4, 32, 32)
    assert not os.path.exists(autotune.cache_path())


def test_disable_env_var_blocks_measurement(tuner_dir, monkeypatch):
    monkeypatch.setenv("LNS_AUTOTUNE_DISABLE", "1")
    monkeypatch.setattr(autotune, "_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not autotune._can_measure(False)
    monkeypatch.delenv("LNS_AUTOTUNE_DISABLE")
    assert autotune._can_measure(False)


def test_graph_capture_refuses_to_measure(monkeypatch):
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert not autotune._can_measure(False)
    with pytest.raises(RuntimeError, match="graph capture"):
        autotune._measure_ms(lambda: torch.zeros(1))


@pytest.mark.parametrize("op,shape", [c[:2] for c in CASES
                                      if c[2] != TILED])
def test_fixed_geometry_ops_write_no_entry(tuner_dir, op, shape):
    calls = []
    got = autotune.lookup(op, shape, **KW, measure=True,
                          measure_fn=lambda *a: calls.append(a) or 1.0)
    assert got == autotune.fixed_geometry(op, shape)
    assert calls == []
    assert not os.path.exists(autotune.cache_path())
    # tune still times the one geometry (what _bench_launcher is for)
    best, results = autotune.tune(op, shape, **KW, measure_fn=lambda *a: 3.0)
    assert best == got and results == {got: 3.0}


def test_real_measurement_on_the_cpu_lane(tuner_dir):
    """A genuine timed tune of the plain versions at small shapes: every
    candidate gets a positive time, and the outputs are those of the
    default launch."""
    best, results = autotune.tune("fwd", (4, 33, 40), **KW, interpret=True,
                                  reps=1)
    assert set(results) == set(TILED) and best in results
    assert all(ms > 0 for ms in results.values())
    for op, shape in (("dw", (40, 33, 5)), ("dw_partials", (9, 7, 20)),
                      ("boxsum", (37, 1, 5)), ("dx", (3, 9, 14))):
        best, results = autotune.tune(op, shape, **KW, interpret=True,
                                      reps=1)
        assert all(ms > 0 for ms in results.values())
        outs = {b: autotune._bench_launcher(op, shape, b, LNS16,
                                            DELTA_DEFAULT, True)()
                for b in autotune.candidate_blocks(op, shape)}
        first = next(iter(outs.values()))
        assert all(torch.equal(o, first) for o in outs.values())
    assert autotune._measure_ms(lambda: torch.zeros(3), reps=2) > 0


def test_prime_matmul_fills_all_three_ops(tuner_dir):
    seen = []

    def stub(op, shape, blocks):
        seen.append(op)
        return float(blocks[0])

    out = autotune.prime_matmul(500, 784, 100, **KW, measure=True,
                                measure_fn=stub)
    assert out == {"fwd": (1, 32, 32), "dx": (1, 32, 32),
                   "dw": (1, 32, 32)}
    assert set(seen) == {"fwd", "dx", "dw"}
    assert out["fwd"] == autotune.lookup("fwd", (500, 100, 784), **KW)
    # at batch 5 the dW (5 steps) takes the short form
    seen.clear()
    out = autotune.prime_matmul(5, 784, 100, **KW, measure=True,
                                measure_fn=stub)
    assert out == {"fwd": (1, 32, 32), "dx": (1, 32, 32),
                   "dw": (1, 128, 5)}
    assert set(seen) == {"fwd", "dx"}


def test_cache_key_partitioned_by_lane(tuner_dir):
    shape = (64, 100, 784)
    got = autotune.lookup("fwd", shape, **KW, interpret=False,
                          measure=True,
                          measure_fn=lambda op, s, b: float(b[0]))
    assert got == (1, 32, 32)
    assert autotune.lookup("fwd", shape, **KW, interpret=True,
                           measure=False) == (4, 32, 32)
    k_i = autotune.entry_key("fwd", shape, LNS16, DELTA_DEFAULT, True)
    k_c = autotune.entry_key("fwd", shape, LNS16, DELTA_DEFAULT, False)
    assert k_i != k_c
    assert "interpret=True" in k_i and "interpret=False" in k_c


# --------------------------------------------------- routing and results

MODES = {"default": ("lns16-train-pallas", 4),
         "explicit_1": ("lns16-train-pallas,blocks=1x32x32", 1),
         "explicit_3": ("lns16-train-pallas,blocks=3x1x1", 2),
         "explicit_8": ("lns16-train-pallas,blocks=8x32x32", 8),
         "auto": ("lns16-train-pallas,blocks=auto", 2)}


def _tuned_to_two_rows(monkeypatch):
    """blocks=auto on the CPU lane with a tuner that measured 2 rows."""
    monkeypatch.setattr(autotune, "_can_measure", lambda interpret: True)
    monkeypatch.setattr(autotune, "tune", lambda op, shape, **kw: (
        (2, 32, 32), {(2, 32, 32): 1.0}))


def test_mlp_step_routes_rows_and_keeps_codes(tuner_dir, launches,
                                              monkeypatch):
    _tuned_to_two_rows(monkeypatch)
    x, y, _, _, _ = datasets.load("mnist", os.path.join(tuner_dir, "d"), 0)
    codes = {}
    for name, (spec, rows) in MODES.items():
        launches.clear()
        m = make_mlp("lns", MLPConfig(spec=spec), "cpu")
        p = m.init(torch.Generator().manual_seed(0))
        for i in range(2):
            p, _ = m.train_step(p, x[5 * i:5 * i + 5], y[5 * i:5 * i + 5])
        m.predict(p, x[:20])
        codes[name] = {k: (v.code, v.sign) for k, v in p.items()}
        for axes, r, c, ct, br in launches:
            assert br == (rows if ct > autotune.SHORT_STEPS else 4), \
                (name, axes, r, c, ct, br)
        assert any(ct > autotune.SHORT_STEPS for _, _, _, ct, _ in launches)
    for name in MODES:
        for k, (c, s) in codes["default"].items():
            assert torch.equal(codes[name][k][0], c), (name, k)
            assert torch.equal(codes[name][k][1], s), (name, k)


def test_per_layer_blocks_rule_reaches_the_tuner(tuner_dir, launches,
                                                 monkeypatch):
    _tuned_to_two_rows(monkeypatch)
    seen = []
    real = autotune.lookup
    monkeypatch.setattr(autotune, "lookup",
                        lambda op, shape, **kw: seen.append((op, shape))
                        or real(op, shape, **kw))
    m = make_mlp("lns", MLPConfig(
        spec="lns16-train-pallas;hidden=blocks:auto;out=blocks:8x1x1"),
        "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    m.predict(p, torch.rand(20, 784, generator=gen))
    assert seen == [("fwd", (20, 100, 784))]
    assert [br for *_, br in launches] == [2, 8]


@pytest.mark.parametrize("mode", MODES)
def test_runtime_linear_equal_across_blocks(tuner_dir, launches,
                                            monkeypatch, mode):
    _tuned_to_two_rows(monkeypatch)
    spec, rows = MODES[mode]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 40, generator=gen)
    w = torch.randn(40, 16, generator=gen)
    outs = {}
    for name in ("default", mode):
        launches.clear()
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        rt = NumericsSpec.parse(MODES[name][0]).runtime()
        z = rt.linear(xx, ww)
        z.sum().backward()
        outs[name] = (z.detach(), xx.grad, ww.grad)
        assert {br for *_, ct, br in launches if ct > 12} == {MODES[name][1]}
    for a, b in zip(outs["default"], outs[mode]):
        assert torch.equal(a, b)


def test_trainable_takes_the_spec_blocks(tuner_dir, launches):
    from repro_torch.kernels.lns_matmul import lns_matmul_trainable
    x = torch.randn(6, 40, generator=torch.Generator().manual_seed(2))
    w = torch.randn(40, 16, generator=torch.Generator().manual_seed(3))
    za = lns_matmul_trainable(x, w,
                              numerics="lns16-train-pallas,blocks=1x8x8")
    zd = lns_matmul_trainable(x, w, numerics="lns16-train-pallas")
    assert torch.equal(za, zd)
    assert [br for *_, br in launches] == [1, 4]


def test_blocks_axis_parses_as_reference():
    from repro.core import NumericsSpec as JSpec, parse_blocks as j_parse
    for text in ("lns16-train-pallas,blocks=auto",
                 "lns16-train-pallas,blocks=256x128x64"):
        assert str(NumericsSpec.parse(text)) == str(JSpec.parse(text))
    assert T.parse_blocks("256x128x64") == j_parse("256x128x64")
    for bad in ("16x16", "0x8x8", "axbxc"):
        with pytest.raises(ValueError, match="blocks"):
            NumericsSpec.parse(f"lns16-train-pallas,blocks={bad}")
    plan = NumericsPlan.parse("lns16-train-pallas;hidden=blocks:16x8x32;"
                              "out=blocks:auto")
    assert plan.resolve("hidden").runtime().matmul.blocks == "16x8x32"
    assert plan.resolve("out").runtime().matmul.blocks == "auto"


@pytest.mark.parametrize("blocks", ["default", "16x1x4", "512x1x9",
                                    "1x1x1"])
@pytest.mark.parametrize("n,segs", [(78400, 5), (100, 5), (10, 2),
                                    (1000, 8)])
def test_dp_combine_blocks_equal_reference(blocks, n, segs):
    jeng = JDeltaEngine(J_DELTA, J_LNS16)
    assert dp_combine_blocks(n, segs, T.cached_engine(DELTA_DEFAULT, LNS16),
                             blocks=blocks) \
        == j_dp_blocks(n, segs, jeng, blocks=blocks)


def test_dp_combine_blocks_auto_is_the_fixed_geometry(tuner_dir):
    eng = T.cached_engine(DELTA_DEFAULT, LNS16)
    assert dp_combine_blocks(78400, 5, eng, blocks="auto") == (128, 5)
    assert dp_combine_blocks(10, 5, eng, blocks="auto") == (32, 5)
    assert not os.path.exists(autotune.cache_path())


def test_combine_takes_the_reference_arguments():
    from repro_torch.distributed.lns_reduce import combine_partials
    eng = T.cached_engine(DELTA_DEFAULT, LNS16)
    parts = encode(torch.randn(5, 7, 3,
                               generator=torch.Generator().manual_seed(4)),
                   LNS16)
    base = combine_partials(parts, eng)
    for kw in (dict(blocks="auto"), dict(blocks="4x1x5", interpret=False)):
        got = combine_partials(parts, eng, **kw)
        assert torch.equal(got.code, base.code)
        assert torch.equal(got.sign, base.sign)
    with pytest.raises(ValueError, match="blocks"):
        combine_partials(parts, eng, blocks="4x1")
    np.testing.assert_array_equal(base.code.shape, (7, 3))
