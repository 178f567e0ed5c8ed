"""The port's ⊞-reduce kernel (``repro_torch.kernels.lns_boxsum``) and the
fixed-schedule combine of segment partials, against the JAX package on the
CPU lane.

What runs here is the wrapper's plain PyTorch version, which the CUDA
kernel is held to on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  It is held bit for bit against the reference's oracle
(a sequential ``boxsum`` over axis 1) over the Δ kinds, the formats and
reduce lengths, against the Pallas kernel in interpret mode at a tiny
shape, and through the strided reads the data-parallel combine uses.
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
from repro_torch.distributed import combine_partials
from repro_torch.kernels.lns_boxsum import (boxsum_plain, lns_boxsum,
                                            lns_boxsum_kernel, lns_boxsum_ref)

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
