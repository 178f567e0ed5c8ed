"""The plan autosearch with its real evaluator: the port's search over the
paper MLP on the CPU lane against the JAX package's, and the port's CLI.

The JAX package's smoke configuration (2 steps an evaluation, 2
evaluations) runs through both packages with the port's ``LNSMLP.init``
giving the JAX package's ``init(PRNGKey(0))`` weights for each candidate's
formats; the journals must be equal: the probe's evidence and every
evaluation row's ``acc``, ``test_acc`` and ``cost``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.paper.mlp import MLPConfig as JConfig, make_mlp as jmake
from repro.search import (PlanSearch as JPlanSearch,
                          SearchConfig as JSearchConfig,
                          SearchSpace as JSearchSpace)
from repro_torch.paper.mlp import LNSMLP, params_from_numpy
from repro_torch.search import PlanSearch, SearchConfig, SearchSpace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _reference_init(self, gen):
    """The JAX package's initial weights for this model's config."""
    cfg = JConfig(n_in=self.cfg.n_in, n_hidden=self.cfg.n_hidden,
                  n_out=self.cfg.n_out, spec=str(self.cfg.plan()))
    p = jmake("lns", cfg).init(jax.random.PRNGKey(0))
    return params_from_numpy(
        {k: (np.asarray(v.code), np.asarray(v.sign)) for k, v in p.items()},
        self.device)


def _journal(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def test_real_search_journal_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(LNSMLP, "init", _reference_init)
    kw = dict(epochs=1, steps_per_epoch=2, batch_size=5,
              refine_generations=0, refine_population=0,
              data_dir=str(tmp_path / "data"))
    runs = {}
    for name, (space_cls, cfg_cls, search_cls, extra) in {
            "ref": (JSearchSpace, JSearchConfig, JPlanSearch, {}),
            "port": (SearchSpace, SearchConfig, PlanSearch,
                     {"device": "cpu"})}.items():
        journal = tmp_path / f"{name}.jsonl"
        s = search_cls(space_cls.for_paper_mlp("lns16-train-emulate"),
                       cfg_cls(**kw), journal=str(journal), **extra)
        try:
            runs[name] = s.run(max_evals=2)
        finally:
            s.close()
    t, j = runs["port"], runs["ref"]
    assert len(t.evals) == 2
    assert set(t.evidence) == {"hidden", "out"}
    for ev in t.evidence.values():
        assert {"sat", "zero", "elems", "upper_dhist"} <= set(ev)
    assert t.evidence == j.evidence
    assert _journal(tmp_path / "port.jsonl") \
        == _journal(tmp_path / "ref.jsonl")
    for e in t.evals:
        assert 0.0 <= e["acc"] <= 1.0 and set(e) >= {"acc", "test_acc",
                                                     "cost"}


def test_cli_smoke_selfcheck_resume_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.search", "--smoke",
         "--selfcheck-resume", "--device", "cpu",
         "--data-dir", str(tmp_path / "data")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "selfcheck-resume OK" in proc.stdout
    out = json.loads((tmp_path / "BENCH_plan_search.json").read_text())
    assert out["complete"] and out["rows"]
    assert all("ms_per_step" not in r for r in out["rows"])
    assert (tmp_path / "plan_search_report.md").exists()
