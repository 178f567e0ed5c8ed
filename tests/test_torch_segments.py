"""The data-parallel side of the port's faults against the JAX package:
the segment-partial faults (``drop_seg`` / ``dup_seg``) in the helper and
in the segmented step on 1 and 2 gloo ranks, the recovery of lost
segment partials, and a corrupted Δ table under the segmented step.

At the drill's shape (8 × 12–9–4, batch 8, 4 segments), from the JAX
package's initial weights carried as numpy.  The port runs its CPU lane;
the reference its ``emulate`` lane, except for the ``lut`` case, which
holds the port against the reference's ``pallas`` lane (interpret mode):
the port's combine kernel, like the reference's Pallas kernel, builds its
tables from the format and Δ spec (ROADMAP queue 3 item 5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.paper.mlp import MLPConfig as JConfig, PARAM_LAYER, make_mlp as jmake
from repro.resil import FaultPlan as JPlan
from repro.resil import inject as jinj
import repro_torch.core as T
from repro_torch.distributed import combine_partials_many
from repro_torch.distributed.lns_dp import _train_on_ranks
from repro_torch.paper import (MLPConfig, make_mlp, params_from_numpy,
                               params_to_numpy)
from repro_torch.resil import (FaultPlan, fault_plan, inject_segment_partials,
                               injecting, recover_segment_partials)

torch.set_num_threads(1)

SEG_PLAN = "seed=5,start=1;hidden=flip_w:0.05,drop_seg:1;out=dup_seg:2"


def _np(tree):
    return {k: (np.asarray(v.code), np.asarray(v.sign))
            for k, v in tree.items()}


def _same(got, want, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        for plane, g, w in zip(("code", "sign"), got[k], want[k]):
            assert g.dtype == w.dtype, (msg, k, plane)
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {k} {plane}")


SMALL = dict(n_in=12, n_hidden=9, n_out=4, lr=0.01, momentum=0.9)


def _small_batch():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, size=(8, 12)).astype(np.float32),
            rng.integers(0, 4, size=(8,)))


def test_segment_inject_equals_reference():
    """drop_seg zeroes a global slot, dup_seg copies slot s into s + 1
    only where both are on the rank; as the reference's helper does at the
    same global slots."""
    from repro.core import LNS16 as JLNS16, encode as jencode
    rng = np.random.default_rng(0)
    shapes = {"w1": (4, 12, 9), "b1": (4, 9), "w2": (4, 9, 4), "b2": (4, 4)}
    raw = {k: rng.normal(size=s).astype(np.float32)
           for k, s in shapes.items()}
    parts = {k: jencode(v, JLNS16) for k, v in raw.items()}
    tparts = {k: T.encode(torch.from_numpy(v), T.LNS16)
              for k, v in raw.items()}
    fmts = {k: T.LNS16 for k in parts}
    plan = "seed=0;hidden=drop_seg:1;out=dup_seg:2"
    with jinj.injecting(JPlan.parse(plan)):
        want = jinj.inject_segment_partials(
            parts, param_fmts={k: JLNS16 for k in parts},
            param_layer=PARAM_LAYER, segs_local=4)
    got = inject_segment_partials(tparts, param_fmts=fmts,
                                  param_layer=PARAM_LAYER, segs_local=4,
                                  plan=FaultPlan.parse(plan))
    _same({k: (v.code.numpy(), v.sign.numpy()) for k, v in got.items()},
          _np(want))
    # The second of two ranks holds global slots 2 and 3: dup 2 → 3 acts
    # there, the drop of slot 1 does not.
    half = {k: v[2:] for k, v in tparts.items()}
    got = inject_segment_partials(half, param_fmts=fmts,
                                  param_layer=PARAM_LAYER, segs_local=2,
                                  rank=1, plan=FaultPlan.parse(plan))
    assert torch.equal(got["w1"].code, half["w1"].code)
    assert torch.equal(got["w2"].code[1], half["w2"].code[0])


def test_lut_fault_data_parallel_equals_reference_pallas_lane():
    """A corrupted Δ table under the segmented step: the port's combine
    kernel reads the clean tables of its format and Δ spec, as the
    reference's Pallas combine does, so the port equals the reference's
    ``pallas`` lane (see ROADMAP queue 3 for its ``emulate`` lane)."""
    xb, yb = _small_batch()
    plan = "seed=3;hidden=lut:3;out=lut:3"
    jm = jmake("lns", JConfig(spec="lns16-train-pallas,reduce.grad_segments"
                              "=4", faults=plan, matmul_block=8, **SMALL))
    tm = make_mlp("lns", MLPConfig(
        spec="lns16-train-pallas,reduce.grad_segments=4", faults=plan,
        **SMALL), "cpu")
    jp = jm.init(jax.random.PRNGKey(1))
    jmom = jm.init_momentum(jp)
    tp = params_from_numpy(_np(jp), "cpu")
    tmom = tm.init_momentum(tp)
    for i in range(2):
        jp, jmom, _ = jm.train_step_faults(jp, xb, yb, jnp.int32(i), jmom)
        tp, tmom, _ = tm.train_step_faults(tp, xb, yb, i, tmom)
        _same(params_to_numpy(tp), _np(jp), f"step {i}")
        _same(params_to_numpy(tmom), _np(jmom), f"momentum step {i}")


def test_segment_faults_on_ranks_equal_reference():
    """The segmented step under drop_seg / dup_seg (and weight flips)
    trained 3 steps on 1 and 2 gloo ranks equals the reference's at one
    device: slots are global (rank × local segments on), and both faulted
    pairs stay on one rank at either count."""
    xb, yb = _small_batch()
    spec = "lns16-train-emulate,reduce.grad_segments=4"
    jm = jmake("lns", JConfig(spec=spec, faults=SEG_PLAN, matmul_block=8,
                              **SMALL))
    jp = jm.init(jax.random.PRNGKey(1))
    init = _np(jp)
    jmom = jm.init_momentum(jp)
    for i in range(3):
        jp, jmom, _ = jm.train_step_faults(jp, xb, yb, jnp.int32(i), jmom)
    tspec = "lns16-train-pallas,reduce.grad_segments=4"
    cfg = MLPConfig(spec=tspec, faults=SEG_PLAN, **SMALL)
    for world in (1, 2):
        outs = _train_on_ranks(world, cfg, tspec, init, xb, yb, steps=3,
                              device="cpu", timeout=120)
        for params, mom, _ in outs:
            _same(params, _np(jp), f"{world} ranks")
            _same(mom, _np(jmom), f"{world} ranks, momentum")


def test_recover_segment_partials_bit_identical():
    """Lost slots recomputed from their own rows and recombined equal the
    undamaged combine, bit for bit; the partials equal the reference's."""
    xb, yb = _small_batch()
    spec = "lns16-train-emulate,reduce.grad_segments=4"
    jinner = jmake("lns", JConfig(spec=spec, matmul_block=8,
                                  **SMALL)).inner
    jp = jinner.init(jax.random.PRNGKey(1))
    tinner = make_mlp("lns", MLPConfig(
        spec="lns16-train-pallas,reduce.grad_segments=4", **SMALL),
        "cpu").inner
    tp = params_from_numpy(_np(jp), "cpu")
    parts, _ = tinner.per_segment_grads(tp, *tinner._inputs(xb, yb), 4)
    with injecting(fault_plan({"*": "drop_seg:2"}, seed=0)):
        bad = inject_segment_partials(parts, param_fmts=tinner.param_fmts,
                                      param_layer=PARAM_LAYER, segs_local=4)
    assert not torch.equal(bad["w1"].code, parts["w1"].code)
    got = recover_segment_partials(tinner, tp, xb, yb, bad,
                                   grad_segments=4, lost=[2])
    want = combine_partials_many(parts, tinner.param_engines)
    jparts, _ = jax.jit(lambda p, x, y: jinner.per_segment_grads(
        p, x, y, 4))(jp, xb, yb)
    _same(params_to_numpy(got), params_to_numpy(want))
    _same(params_to_numpy(parts), _np(jparts))
    with pytest.raises(ValueError, match="not divisible"):
        recover_segment_partials(tinner, tp, xb[:6], yb[:6], parts,
                                 grad_segments=4, lost=[0])
    with pytest.raises(ValueError, match="out of range"):
        recover_segment_partials(tinner, tp, xb, yb, parts,
                                 grad_segments=4, lost=[4])
