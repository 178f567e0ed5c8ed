"""The port's plan autosearch (``repro_torch.search``) against the JAX
package's (``repro.search``) on the same deterministic stub evaluator and
probe: equal journals byte for byte, equal frontiers, winners, reports and
validation errors, and the same resume, torn-tail, header-mismatch and
budget behaviour.  The search logic is exactly what the CLI runs; only the
evaluation is a stub (``tests/test_torch_search_real.py`` runs the real
one).
"""
import json

import pytest
import torch

from repro import search as jsearch
from repro.core import NumericsPlan as JPlan
from repro.search import report as jreport
from repro_torch import search as tsearch
from repro_torch.core.plan import NumericsPlan
from repro_torch.search import report as treport

torch.set_num_threads(1)

#: name → (search package, its NumericsPlan, its report module)
PKGS = {"ref": (jsearch, JPlan, jreport),
        "port": (tsearch, NumericsPlan, treport)}


def fake_eval_for(plan_cls):
    """Synthetic accuracy (the JAX package's test stub): narrowing
    ``hidden`` is nearly free, narrowing ``out`` is expensive, bit-shift
    Δ costs a little."""
    def fake_eval(plan_str):
        plan = plan_cls.parse(plan_str)
        h, o = plan.resolve("hidden")._flat(), plan.resolve("out")._flat()
        acc = 0.9
        if h["fmt"] == "lns12":
            acc -= 0.005
        if o["fmt"] == "lns12":
            acc -= 0.05
        if o["delta"] == "bitshift":
            acc -= 0.03
        if h["delta"] == "bitshift":
            acc -= 0.001
        if h["interpret"] == "off":
            acc -= 0.0005
        return {"acc": acc}
    return fake_eval


def fake_probe():
    return {"hidden": {"sat": 0, "zero": 5, "elems": 1000,
                       "upper_dhist": 0},
            "out": {"sat": 40, "zero": 0, "elems": 200,
                    "upper_dhist": 9}}


SPACES = {
    "fmts": {},
    "deltas": {"deltas": ("lut20", "bitshift")},
    "interprets": {"interprets": ("auto", "off")},
    "three_fmts": {"fmts": ("lns21", "lns16", "lns12"),
                   "deltas": ("lut20", "exact")},
    "hidden_only": {"layers": ("hidden",)},
}
CONFIGS = {
    "default": {},
    "tight": {"max_acc_drop": 0.001, "refine_generations": 3,
              "refine_population": 2, "seed": 3},
}


def make_space(pkg, **kw):
    kw.setdefault("deltas", ())
    return PKGS[pkg][0].SearchSpace.for_paper_mlp("lns16-train-emulate",
                                                 **kw)


def run_search(pkg, path, space_kw=None, config_kw=None, max_evals=None,
               evaluate_fn=None):
    mod, plan_cls, _ = PKGS[pkg]
    space = make_space(pkg, **(space_kw or {}))
    config = mod.SearchConfig(**(config_kw or {}))
    s = mod.PlanSearch(space, config, journal=str(path),
                       evaluate_fn=evaluate_fn or fake_eval_for(plan_cls),
                       probe_fn=fake_probe)
    try:
        return s.run(max_evals=max_evals), space, config
    finally:
        s.close()


def assert_results_equal(rt, rj):
    assert rt.evals == rj.evals
    assert rt.frontier == rj.frontier
    assert rt.winner == rj.winner
    assert rt.order == rj.order
    assert rt.evidence == rj.evidence
    assert rt.anchor == rj.anchor
    assert rt.complete == rj.complete


# ------------------------------------------------------------- pareto ----

PARETO_ROWS = [
    [{"plan": "p1", "acc_delta": 0.0, "time_cost": 10.0},
     {"plan": "p2", "acc_delta": -0.01, "time_cost": 5.0},
     {"plan": "p3", "acc_delta": -0.5, "time_cost": 9.0},
     {"plan": "p1", "acc_delta": -9.9, "time_cost": 99.0}],
    [{"plan": "cheap", "acc_delta": -0.05, "time_cost": 1.0},
     {"plan": "mid", "acc_delta": -0.01, "time_cost": 2.0},
     {"plan": "anchor", "acc_delta": 0.0, "time_cost": 3.0}],
    [{"plan": "a", "acc_delta": 0.0, "time_cost": 1.0},
     {"plan": "b", "acc_delta": 0.0, "time_cost": 1.0},
     {"plan": "c", "acc_delta": 0.1, "time_cost": 2.0}],
    [],
]


@pytest.mark.parametrize("rows", PARETO_ROWS, ids=range(len(PARETO_ROWS)))
def test_pareto_equals_reference(rows):
    for a in rows:
        for b in rows:
            assert tsearch.dominates(a, b) == jsearch.dominates(a, b)
    assert tsearch.pareto_frontier(rows) == jsearch.pareto_frontier(rows)
    for drop in (0.001, 0.02, 0.1):
        assert tsearch.select_winner(rows, max_acc_drop=drop) \
            == jsearch.select_winner(rows, max_acc_drop=drop)


def test_pareto_semantics():
    front = tsearch.pareto_frontier(PARETO_ROWS[0])
    assert [r["plan"] for r in front] == ["p2", "p1"]
    rows = PARETO_ROWS[1]
    assert tsearch.select_winner(rows, max_acc_drop=0.02)["plan"] == "mid"
    assert tsearch.select_winner(rows, max_acc_drop=0.1)["plan"] == "cheap"
    assert tsearch.select_winner([], max_acc_drop=0.02) is None


# --------------------------------------------------------- validation ----

BAD_SPACES = {
    "typo_layer": {"layers": ("hiden",)},
    "bad_fmt": {"fmts": ("lns16", "nosuchfmt")},
    "bad_delta": {"deltas": ("nosuchdelta",)},
    "bad_interpret": {"interprets": ("sometimes",)},
    "no_layers": {"layers": ()},
    "no_fmts": {"fmts": ()},
}


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("name", BAD_SPACES)
def test_validate_errors_equal_reference(name):
    kw = dict(BAD_SPACES[name])
    if name == "no_layers":
        # for_paper_mlp fills empty layers with every path: build directly
        errs = {pkg: _error(lambda pkg=pkg: PKGS[pkg][0].SearchSpace(
                    base="lns16-train-emulate", layers=(),
                    known_paths=("hidden", "out")).validate())
                for pkg in PKGS}
    else:
        errs = {pkg: _error(lambda pkg=pkg: make_space(pkg, **kw)
                            .validate()) for pkg in PKGS}
    assert errs["port"] == errs["ref"]
    if name == "typo_layer":
        assert "hiden" in errs["port"] and "hidden" in errs["port"] \
            and "out" in errs["port"]


def test_validation_runs_before_any_measurement():
    calls = []
    space = tsearch.SearchSpace.for_paper_mlp(layers=("hiden",))
    with pytest.raises(ValueError):
        tsearch.PlanSearch(
            space, tsearch.SearchConfig(),
            evaluate_fn=lambda p: calls.append(p) or {"acc": 1.0},
            probe_fn=lambda: calls.append("probe") or {})
    assert calls == []


def test_build_rejects_non_sweepable_axis_as_reference():
    errs = {pkg: _error(lambda pkg=pkg: make_space(pkg).build(
        {"hidden": {"quantize": "off"}})) for pkg in PKGS}
    assert errs["port"] == errs["ref"] and "non-sweepable" in errs["port"]


def test_space_pieces_equal_reference():
    for kw in SPACES.values():
        t, j = make_space("port", **kw), make_space("ref", **kw)
        assert t.descriptor() == j.descriptor()
        assert t.mutations({}) == j.mutations({})
        for assign in ({}, {"hidden": {"fmt": "lns12"}}):
            plan = t.build(assign)
            assert str(plan) == str(j.build(assign))
            assert t.cost(plan) == j.cost(str(plan))
            for pat in t.layers:
                assert t.current(assign, pat, "fmt") \
                    == j.current(assign, pat, "fmt")
        assert t.narrower_fmts("lns16") == j.narrower_fmts("lns16")


# ---------------------------------------------------- journals and runs --

@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("space", SPACES)
def test_journal_and_report_equal_reference(tmp_path, space, config):
    rt, t_space, t_cfg = run_search("port", tmp_path / "t.jsonl",
                                    SPACES[space], CONFIGS[config])
    rj, j_space, j_cfg = run_search("ref", tmp_path / "j.jsonl",
                                    SPACES[space], CONFIGS[config])
    assert (tmp_path / "t.jsonl").read_bytes() \
        == (tmp_path / "j.jsonl").read_bytes()
    assert_results_equal(rt, rj)
    assert treport.render_report(rt, t_space, t_cfg) \
        == jreport.render_report(rj, j_space, j_cfg)
    assert treport.frontier_table(rt.frontier, rt.winner) \
        == jreport.frontier_table(rj.frontier, rj.winner)
    # deterministic: a second fresh run writes the same journal
    run_search("port", tmp_path / "t2.jsonl", SPACES[space],
               CONFIGS[config])
    assert (tmp_path / "t2.jsonl").read_bytes() \
        == (tmp_path / "t.jsonl").read_bytes()


def test_greedy_narrowing_and_winner(tmp_path):
    r, space, cfg = run_search("port", tmp_path / "j.jsonl")
    win = NumericsPlan.parse(r.winner["plan"])
    assert win.resolve("hidden")._flat()["fmt"] == "lns12"
    assert win.resolve("out")._flat()["fmt"] == "lns16"
    assert r.winner["acc_delta"] >= -cfg.max_acc_drop
    assert r.order == ["hidden", "out"]
    for row in r.frontier + [r.winner]:
        assert str(NumericsPlan.parse(row["plan"])) == row["plan"]
    for row in r.evals:
        assert set(row) >= {"plan", "acc", "cost", "acc_delta",
                            "time_cost"}
    rep = treport.render_report(r, space, cfg)
    assert f"--numerics '{r.winner['plan']}'" in rep
    assert "numerics diff (anchor vs winner)" in rep


def _truncate(src, dst, n_evals):
    lines = src.read_text().splitlines()
    kept, n = [lines[0]], 0
    for ln in lines[1:]:
        if json.loads(ln).get("kind") == "eval":
            if n >= n_evals:
                break
            n += 1
        kept.append(ln)
    dst.write_text("\n".join(kept) + "\n")


@pytest.mark.parametrize("space", ["fmts", "deltas"])
def test_resume_from_truncated_journal_equals_reference(tmp_path, space):
    out = {}
    for pkg in PKGS:
        full, _, _ = run_search(pkg, tmp_path / f"{pkg}_full.jsonl",
                                SPACES[space])
        _truncate(tmp_path / f"{pkg}_full.jsonl",
                  tmp_path / f"{pkg}_cut.jsonl", 2)
        fresh = []
        ev = fake_eval_for(PKGS[pkg][1])
        r, _, _ = run_search(pkg, tmp_path / f"{pkg}_cut.jsonl",
                             SPACES[space],
                             evaluate_fn=lambda p, ev=ev: fresh.append(p)
                             or ev(p))
        assert [e["plan"] for e in r.evals] \
            == [e["plan"] for e in full.evals]
        assert r.frontier == full.frontier and r.winner == full.winner
        assert len(fresh) == len(full.evals) - 2
        out[pkg] = (r, fresh)
    assert_results_equal(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1]
    assert (tmp_path / "port_cut.jsonl").read_bytes() \
        == (tmp_path / "ref_cut.jsonl").read_bytes()


def test_reference_journal_resumes_in_the_port(tmp_path):
    """The headers are byte-equal, so a journal the JAX package wrote
    resumes in the port: its rows are served from the journal, and the
    port evaluates only what the cut run never reached."""
    full, _, _ = run_search("ref", tmp_path / "j.jsonl", SPACES["deltas"])
    _truncate(tmp_path / "j.jsonl", tmp_path / "cut.jsonl", 2)
    fresh = []
    ev = fake_eval_for(NumericsPlan)
    rt, _, _ = run_search("port", tmp_path / "cut.jsonl", SPACES["deltas"],
                          evaluate_fn=lambda p: fresh.append(p) or ev(p))
    assert len(fresh) == len(full.evals) - 2
    assert_results_equal(rt, full)


def test_resume_tolerates_torn_tail_line(tmp_path):
    res = {}
    for pkg in PKGS:
        full, _, _ = run_search(pkg, tmp_path / f"{pkg}.jsonl")
        text = (tmp_path / f"{pkg}.jsonl").read_text()
        (tmp_path / f"{pkg}_torn.jsonl").write_text(
            text + '{"kind": "eval", "pl')
        r, _, _ = run_search(pkg, tmp_path / f"{pkg}_torn.jsonl")
        assert r.winner == full.winner
        res[pkg] = r
    assert_results_equal(res["port"], res["ref"])


def test_journal_header_mismatch_rejected_as_reference(tmp_path):
    errs = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.jsonl"
        run_search(pkg, path)
        mod, plan_cls, _ = PKGS[pkg]
        with pytest.raises(ValueError, match="journal") as ei:
            mod.PlanSearch(make_space(pkg, fmts=("lns16",)),
                           mod.SearchConfig(), journal=str(path),
                           evaluate_fn=fake_eval_for(plan_cls),
                           probe_fn=fake_probe)
        errs[pkg] = str(ei.value).replace(str(path), "<journal>")
    assert errs["port"] == errs["ref"]


def test_budget_exhaustion_and_resume_equal_reference(tmp_path):
    res = {}
    for pkg in PKGS:
        r1, space, cfg = run_search(pkg, tmp_path / f"{pkg}.jsonl",
                                    max_evals=2)
        assert not r1.complete and r1.winner is None
        assert len(r1.evals) == 2
        rep = PKGS[pkg][2].render_report(r1, space, cfg)
        full, _, _ = run_search(pkg, tmp_path / f"{pkg}_full.jsonl")
        r2, _, _ = run_search(pkg, tmp_path / f"{pkg}.jsonl")
        assert r2.complete and r2.winner == full.winner
        assert r2.frontier == full.frontier
        res[pkg] = (r1, rep, r2)
    assert_results_equal(res["port"][0], res["ref"][0])
    assert res["port"][1] == res["ref"][1]
    assert "BUDGET EXHAUSTED" in res["port"][1]
    assert_results_equal(res["port"][2], res["ref"][2])
    assert (tmp_path / "port.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()


def test_budget_zero_returns_empty_as_reference(tmp_path):
    res = {pkg: run_search(pkg, tmp_path / f"{pkg}.jsonl", max_evals=0)[0]
           for pkg in PKGS}
    r = res["port"]
    assert not r.complete and r.evals == [] and r.winner is None
    assert_results_equal(r, res["ref"])
    assert (tmp_path / "port.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()
