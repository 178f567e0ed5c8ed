"""The port's ⊞-reduce kernel (``repro_torch.kernels.lns_boxsum``) and the
fixed-schedule combine of segment partials, against the JAX package on the
CPU lane.

What runs here is the wrapper's plain PyTorch version, which the CUDA
kernel is held to on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  It is held bit for bit against the reference's oracle
(a sequential ``boxsum`` over axis 1) over the Δ kinds, the formats and
reduce lengths, against the Pallas kernel in interpret mode at a tiny
shape, and through the strided reads the data-parallel combine uses; the
grouped entry point (``lns_boxsum_many``) and the grouped combine
(``combine_partials_many``) per row set and per parameter.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.distributed.lns_reduce import combine_partials as jcombine
from repro.kernels.lns_boxsum import lns_boxsum_kernel as jboxsum_kernel
from repro.kernels.lns_boxsum import lns_boxsum_ref as jboxsum_ref
from repro.kernels.lns_boxsum.lns_boxsum import lns_boxsum_pallas
import repro_torch.core as T
import repro_torch.kernels as TKS
from repro_torch.distributed import combine_partials, combine_partials_many
from repro_torch.kernels.lns_boxsum import (boxsum_plain, lns_boxsum,
                                            lns_boxsum_kernel,
                                            lns_boxsum_many, lns_boxsum_ref)
from repro_torch.paper.mlp import LNSMLP, MLPConfig

# The plain ⊞ versions are long chains of small tensor ops.  Under xdist
# several port test files run at once, and OpenMP pools of 8 spinning
# threads in each process oversubscribe the cores many times over: one
# intra-op thread a process keeps each file near its serial time.
torch.set_num_threads(1)

DELTA = {"lut": (J.DELTA_DEFAULT, T.DELTA_DEFAULT),
         "bitshift": (J.DELTA_BITSHIFT, T.DELTA_BITSHIFT),
         "exact": (J.DELTA_EXACT, T.DELTA_EXACT)}


def _planes(seed, shape, fmt, *, zero_frac=0.2, cancel=False):
    """(numpy code, numpy sign) of a random LNS operand; with ``cancel``
    every other row holds a value and its negation next to each other
    (the exact-cancellation branch of Δ⁻ at d = 0)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape).astype(np.float32)
    v[rng.random(size=shape) < zero_frac] = 0.0
    if cancel and shape[1] > 1:
        v[::2, 1] = -v[::2, 0]
    a = J.encode(v, J.FORMATS[fmt])
    return np.array(a.code), np.array(a.sign)


def _eq(got, want, msg=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      np.asarray(w).astype(np.int32),
                                      err_msg=f"{msg} plane {i}")


@partial(jax.jit, static_argnames=("fmt", "spec"))
def _jax_ref(c, s, *, fmt, spec):
    return jboxsum_ref(c, s, fmt=fmt, spec=spec)


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
@pytest.mark.parametrize("k", [1, 5, 37, 128])
def test_boxsum_plain_vs_reference(kind, fmt, k):
    js, ts = DELTA[kind]
    c, s = _planes(40 + k, (45, k), fmt, cancel=True)
    want = _jax_ref(c, s, fmt=J.FORMATS[fmt], spec=js)
    got = lns_boxsum(torch.as_tensor(c), torch.as_tensor(s),
                     fmt=T.FORMATS[fmt], spec=ts)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int8
    _eq(got, want, "plain")
    r = lns_boxsum_ref(T.LNSArray(torch.as_tensor(c), torch.as_tensor(s)),
                       fmt=T.FORMATS[fmt], spec=ts)
    _eq([r.code, r.sign], want, "ref")


def test_boxsum_exact_cancellation_is_zero():
    """x ⊞ (−x) is the zero code with sign 0, for every Δ kind."""
    c, s = _planes(41, (16, 2), "lns16", zero_frac=0.0, cancel=True)
    for kind, (js, ts) in DELTA.items():
        got = lns_boxsum(torch.as_tensor(c), torch.as_tensor(s),
                         fmt=T.LNS16, spec=ts)
        assert (got[0][::2] == T.LNS16.zero_code).all(), kind
        assert (got[1][::2] == 0).all(), kind
        _eq(got, _jax_ref(c, s, fmt=J.LNS16, spec=js), kind)


def test_boxsum_vs_pallas_interpret():
    c, s = _planes(42, (20, 13), "lns12")
    want = lns_boxsum_pallas(c, s.astype(np.int32), fmt=J.LNS12,
                             spec=J.DELTA_DEFAULT, block_m=8, block_k=8,
                             interpret=True)
    _eq(lns_boxsum(torch.as_tensor(c), torch.as_tensor(s), fmt=T.LNS12,
                   spec=T.DELTA_DEFAULT), want)


def test_boxsum_entry_point_vs_reference_entry_point():
    c, s = _planes(43, (11, 6), "lns16")
    want = jboxsum_kernel(J.LNSArray(c, s), fmt=J.LNS16,
                          spec=J.DELTA_BITSHIFT, block_m=8, block_k=8,
                          interpret=True)
    got = lns_boxsum_kernel(T.LNSArray(torch.as_tensor(c),
                                       torch.as_tensor(s)),
                            fmt=T.LNS16, spec=T.DELTA_BITSHIFT)
    _eq([got.code, got.sign], [want.code, want.sign])


def test_boxsum_reads_strided_views():
    """(S, E) partials read in place as the (E, S) view equal the same
    rows made contiguous: strides move reads, never the order."""
    c, s = _planes(44, (5, 60), "lns16")
    tc, ts = torch.as_tensor(c), torch.as_tensor(s)
    view = lns_boxsum(tc.T, ts.T, fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    dense = lns_boxsum(tc.T.contiguous(), ts.T.contiguous(), fmt=T.LNS16,
                       spec=T.DELTA_DEFAULT)
    _eq(view, [dense[0].numpy(), dense[1].numpy()])
    _eq(view, _jax_ref(c.T, s.T, fmt=J.LNS16, spec=J.DELTA_DEFAULT))


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("schedule", ["sequential", "tree"])
def test_combine_and_boxsum_partials_vs_reference(kind, schedule):
    """The combine of (S, K, N) partials and ``boxsum_partials`` on both
    schedules equal the reference's."""
    js, ts = DELTA[kind]
    c, s = _planes(45, (6, 9 * 4), "lns16")
    c, s = c.reshape(6, 9, 4), s.reshape(6, 9, 4)
    jeng = J.DeltaEngine(js, J.LNS16)
    teng = T.cached_engine(ts, T.LNS16)
    tparts = T.LNSArray(torch.as_tensor(c), torch.as_tensor(s))
    want = jcombine(J.LNSArray(c, s), jeng, schedule=schedule,
                    use_kernel=False)
    got = combine_partials(tparts, teng, schedule=schedule)
    assert tuple(got.shape) == (9, 4)
    _eq([got.code, got.sign], [want.code, want.sign], "combine")
    bp = T.boxsum_partials(tparts, teng, schedule=schedule)
    jbp = J.boxsum_partials(J.LNSArray(c, s), jeng, schedule=schedule)
    _eq([bp.code, bp.sign], [jbp.code, jbp.sign], "boxsum_partials")


def test_boxsum_partials_schedule_checked():
    parts = T.zeros((3, 2), T.LNS16)
    with pytest.raises(ValueError, match="schedule"):
        T.boxsum_partials(parts, T.cached_engine(T.DELTA_DEFAULT, T.LNS16),
                          schedule="ring")


def test_boxsum_cpu_lane_and_bad_inputs():
    TKS.reset_launch_counts()
    c = torch.full((4, 3), T.LNS16.zero_code, dtype=torch.int32)
    s = torch.zeros((4, 3), dtype=torch.int8)
    out = lns_boxsum(c, s, fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    assert (out[0] == T.LNS16.zero_code).all() and (out[1] == 0).all()
    assert TKS.launch_counts()["lns_boxsum"] == 0
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        boxsum_plain(c[0], s[0], fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    with pytest.raises(ValueError, match="int8"):
        boxsum_plain(c, s.to(torch.int32), fmt=T.LNS16,
                     spec=T.DELTA_DEFAULT)
    meta = torch.empty((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ⊞-reduce lane"):
        lns_boxsum(meta, meta.to(torch.int8), fmt=T.LNS16,
                   spec=T.DELTA_DEFAULT)


#: (rows, steps, transposed (S, E) view) of the row sets of a grouped
#: ⊞-reduce: row and step counts differ from set to set, and the views are
#: read in place through their strides.
MANY_SETS = ((37, 5, True), (10, 1, False), (1, 13, False), (45, 2, True),
             (100, 5, True), (4, 37, False), (64, 12, True), (3, 128, True),
             (9, 5, False))


def _set_planes(seed, rows, steps, view, fmt):
    """A row set as the wrapper takes it: the (rows, steps) planes, dense
    or as the transposed view of (steps, rows) partials; step 1 cancels
    step 0 exactly on every other row."""
    c, s = _planes(seed, (rows, steps), fmt, cancel=True)
    if view:
        return np.ascontiguousarray(c.T).T, np.ascontiguousarray(s.T).T
    return c, s


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("n_sets", [1, 2, 4, 8, 9])
def test_boxsum_many_vs_reference(kind, n_sets):
    """``lns_boxsum_many`` over sets of other row counts, step counts and
    strides equals ``lns_boxsum`` and the reference's oracle per set."""
    js, ts = DELTA[kind]
    fmt = "lns12" if n_sets % 2 else "lns16"
    sets = [_set_planes(50 + j, *MANY_SETS[j], fmt) for j in range(n_sets)]
    tsets = [(torch.as_tensor(c), torch.as_tensor(s)) for c, s in sets]
    assert [tc.stride() for tc, _ in tsets] == [
        (1, r) if v else (st, 1) for r, st, v in MANY_SETS[:n_sets]]
    kw = dict(fmt=T.FORMATS[fmt], spec=ts)
    got = lns_boxsum_many(tsets, **kw)
    assert len(got) == n_sets
    for j, ((c, s), (tc, tsg), g) in enumerate(zip(sets, tsets, got)):
        assert tuple(g[0].shape) == (c.shape[0],)
        one = lns_boxsum(tc, tsg, **kw)
        _eq(g, [one[0].numpy(), one[1].numpy()], f"set {j} vs lns_boxsum")
        _eq(g, _jax_ref(np.ascontiguousarray(c), np.ascontiguousarray(s),
                        fmt=J.FORMATS[fmt], spec=js), f"set {j} vs oracle")


def test_boxsum_many_vs_pallas_interpret():
    """Three sets, one of them a transposed view, against the Pallas
    kernel in interpret mode per set."""
    sets = [_set_planes(60 + j, *MANY_SETS[j], "lns16") for j in range(3)]
    got = lns_boxsum_many([(torch.as_tensor(c), torch.as_tensor(s))
                           for c, s in sets], fmt=T.LNS16,
                          spec=T.DELTA_DEFAULT)
    for j, ((c, s), g) in enumerate(zip(sets, got)):
        want = lns_boxsum_pallas(np.ascontiguousarray(c),
                                 np.ascontiguousarray(s).astype(np.int32),
                                 fmt=J.LNS16, spec=J.DELTA_DEFAULT,
                                 block_m=8, block_k=8, interpret=True)
        _eq(g, want, f"set {j}")


def test_boxsum_many_cpu_lane_and_bad_inputs():
    """On CPU tensors nothing is launched or counted; no sets give no
    results; sets on two devices, or an unchecked plane, raise."""
    TKS.reset_launch_counts()
    c = torch.full((4, 3), T.LNS16.zero_code, dtype=torch.int32)
    s = torch.zeros((4, 3), dtype=torch.int8)
    kw = dict(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    out = lns_boxsum_many([(c, s)] * 9, **kw)
    assert len(out) == 9
    assert all((o[0] == T.LNS16.zero_code).all() and (o[1] == 0).all()
               for o in out)
    assert lns_boxsum_many([], **kw) == []
    assert TKS.launch_counts()["lns_boxsum"] == 0
    meta = torch.empty((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no ⊞-reduce lane"):
        lns_boxsum_many([(c, s), (meta, meta.to(torch.int8))], **kw)
    with pytest.raises(ValueError, match="int8"):
        lns_boxsum_many([(c, s), (c, s.to(torch.int32))], **kw)


#: (plan rules, the layer arithmetic of each parameter group).
COMBINE_PLANS = {"default": ("", [["w1", "b1", "w2", "b2"]]),
                 "mixed": (";hidden=fmt:lns12", [["w1", "b1"], ["w2", "b2"]])}


@pytest.mark.parametrize("plan", list(COMBINE_PLANS))
@pytest.mark.parametrize("schedule", ["sequential", "tree"])
def test_combine_partials_many_vs_reference(plan, schedule):
    """The grouped combine of a small MLP's (S, ...) partials equals the
    reference's ``combine_partials`` through its Pallas ⊞-reduce kernel
    (interpret mode) per parameter, each in its own layer's arithmetic,
    and the port's one-tensor ``combine_partials``."""
    rules = COMBINE_PLANS[plan][0]
    inner = LNSMLP(MLPConfig(spec="lns16-train-pallas" + rules, n_in=12,
                             n_hidden=9, n_out=4), "cpu")
    shapes = dict(w1=(12, 9), b1=(9,), w2=(9, 4), b2=(4,))
    parts, jparts = {}, {}
    for j, (k, tail) in enumerate(shapes.items()):
        fmt = inner.param_engines[k].fmt.name
        c, s = _planes(70 + j, (5, int(np.prod(tail))), fmt)
        c, s = c.reshape((5,) + tail), s.reshape((5,) + tail)
        parts[k] = T.LNSArray(torch.as_tensor(c), torch.as_tensor(s))
        jparts[k] = J.LNSArray(c, s)
    got = combine_partials_many(parts, inner.param_engines,
                                schedule=schedule)
    assert list(got) == list(shapes)
    for k, eng in inner.param_engines.items():
        jeng = J.DeltaEngine(DELTA[eng.spec.kind][0], J.FORMATS[eng.fmt.name])
        want = jcombine(jparts[k], jeng, schedule=schedule, use_kernel=True,
                        interpret=True)
        assert tuple(got[k].shape) == shapes[k]
        _eq([got[k].code, got[k].sign], [want.code, want.sign], k)
        one = combine_partials(parts[k], eng, schedule=schedule)
        _eq([got[k].code, got[k].sign], [one.code.numpy(), one.sign.numpy()],
            f"{k} vs combine_partials")
