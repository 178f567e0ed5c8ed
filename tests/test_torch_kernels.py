"""The port's ⊞-MAC and ⊞-SGD kernels (``repro_torch.kernels.lns_matmul``)
against the JAX package, on the CPU lane: the fused forward, dX, dW-update
and elementwise update of the fused step, and the plain forward, plain dW
and segment-partial dW of the unfused and segmented steps.

The CUDA kernels cannot run here; what runs is each wrapper's plain
PyTorch version, the arithmetic the kernels are held to on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  It is held bit for bit
against the JAX oracles (``repro.kernels.lns_matmul.ref``) over the Δ
kinds, the formats and every epilogue flag, and once per kernel against
the Pallas kernel itself in interpret mode.
"""
import shutil
from functools import partial

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels.lns_matmul as JK
import repro_torch.core as T
import repro_torch.kernels as TKS
import repro_torch.kernels.lns_matmul as TK
from repro.kernels.lns_matmul.lns_matmul import (lns_matmul_dw_update_pallas,
                                                 lns_matmul_dx_pallas,
                                                 lns_matmul_fused_pallas)
from repro.kernels.lns_matmul.update import lns_fused_update_pallas

# The plain ⊞ versions are long chains of small tensor ops.  Under xdist
# several port test files run at once, and OpenMP pools of 8 spinning
# threads in each process oversubscribe the cores many times over: one
# intra-op thread a process keeps each file near its serial time.
torch.set_num_threads(1)

DELTA = {"lut": (J.DELTA_DEFAULT, T.DELTA_DEFAULT),
         "bitshift": (J.DELTA_BITSHIFT, T.DELTA_BITSHIFT),
         "exact": (J.DELTA_EXACT, T.DELTA_EXACT)}
OTHER = {"lns16": "lns12", "lns12": "lns16"}
SGD = {"plain": dict(lr=0.01), "decay": dict(lr=0.01, weight_decay=0.01),
       "momentum": dict(lr=0.01, momentum=0.9),
       "momentum+decay": dict(lr=0.01, weight_decay=0.01, momentum=0.9)}


def _operand(rng, shape, fmt, *, scale=1.0, zero_frac=0.2):
    """(numpy code, numpy sign) of a random LNS operand."""
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    v[rng.random(size=shape) < zero_frac] = 0.0
    a = J.encode(v, J.FORMATS[fmt])
    return np.asarray(a.code), np.asarray(a.sign)


def _t(pair):
    return tuple(torch.as_tensor(np.array(x)) for x in pair)


def _eq(got, want, msg=""):
    """Port planes (torch) equal to reference planes (jax / numpy)."""
    assert len(got) == len(want), msg
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype in (torch.int32, torch.int8), g.dtype
        np.testing.assert_array_equal(g.numpy().astype(np.int32),
                                      w.astype(np.int32),
                                      err_msg=f"{msg} plane {i}")


def _fwd_eps(name, fmt):
    """(jax FwdEpilogue, port FwdEpilogue) for an epilogue case."""
    beta = J.beta_code(0.01, J.FORMATS[fmt])
    kw = {"none": {}, "bias": dict(bias=True),
          "llrelu": dict(llrelu_beta=beta),
          "zsign": dict(bias=True, emit_z_sign=True),
          "hidden": dict(bias=True, llrelu_beta=beta, emit_z_sign=True),
          "dst": dict(dst_fmt=OTHER[fmt]),
          "all": dict(bias=True, llrelu_beta=beta, dst_fmt=OTHER[fmt],
                      emit_z_sign=True)}[name]
    jkw = {k: (J.FORMATS[v] if k == "dst_fmt" else v) for k, v in kw.items()}
    tkw = {k: (T.FORMATS[v] if k == "dst_fmt" else v) for k, v in kw.items()}
    return JK.FwdEpilogue(**jkw), TK.FwdEpilogue(**tkw)


@partial(jax.jit, static_argnames=("fmt", "spec", "epilogue"))
def _jax_fused_ref(xc, xs, wc, ws, bc, bs, *, fmt, spec, epilogue):
    return JK.lns_matmul_fused_ref(xc, xs, wc, ws, fmt=fmt, spec=spec,
                                   epilogue=epilogue, bias_code=bc,
                                   bias_sign=bs)


@partial(jax.jit, static_argnames=("fmt", "spec"))
def _jax_dx_ref(dc, ds, wc, ws, *, fmt, spec):
    return JK.lns_matmul_dx_ref(dc, ds, wc, ws, fmt=fmt, spec=spec)


@partial(jax.jit, static_argnames=("fmt", "spec", "epilogue"))
def _jax_dw_update_ref(xc, xs, dc, ds, w, m, *, fmt, spec, epilogue):
    return JK.lns_matmul_dw_update_ref(xc, xs, dc, ds, w=w, m=m,
                                       epilogue=epilogue, fmt=fmt, spec=spec)


# ------------------------------------------------------- fused forward --

FWD_CASES = [(k, f, "all") for k in DELTA for f in ("lns16", "lns12")]
FWD_CASES += [("lut", "lns16", e) for e in
              ("none", "bias", "llrelu", "zsign", "hidden", "dst")]


def _fwd_operands(seed, m, k, n, fmt):
    rng = np.random.default_rng(seed)
    x = _operand(rng, (m, k), fmt, zero_frac=0.5)
    w = _operand(rng, (k, n), fmt, scale=0.05, zero_frac=0.02)
    b = _operand(rng, (n,), fmt, scale=0.1)
    return x, w, b


def _check_fused(kind, fmt, ep_name, m, k, n, seed):
    js, ts = DELTA[kind]
    jep, tep = _fwd_eps(ep_name, fmt)
    x, w, b = _fwd_operands(seed, m, k, n, fmt)
    jb = b if jep.bias else (None, None)
    rc, rs, rzs = _jax_fused_ref(*x, *w, *jb, fmt=J.FORMATS[fmt], spec=js,
                                 epilogue=jep)
    want = [rc, rs] + ([rzs] if jep.emit_z_sign else [])
    tb = _t(b) if tep.bias else (None, None)
    got = TK.lns_matmul_fused(*_t(x), *_t(w), fmt=T.FORMATS[fmt], spec=ts,
                              epilogue=tep, bias_code=tb[0], bias_sign=tb[1])
    _eq(got, want, f"plain {kind}/{fmt}/{ep_name}")
    # The port's own oracle (unfused composition of core ops).
    z, zs = TK.lns_matmul_fused_ref(
        T.LNSArray(*_t(x)), T.LNSArray(*_t(w)), fmt=T.FORMATS[fmt], spec=ts,
        epilogue=tep, bias=T.LNSArray(*tb) if tep.bias else None)
    _eq([z.code, z.sign] + ([zs] if tep.emit_z_sign else []), want,
        f"ref {kind}/{fmt}/{ep_name}")


@pytest.mark.parametrize("kind,fmt,ep", FWD_CASES)
def test_fused_fwd_plain_vs_reference(kind, fmt, ep):
    _check_fused(kind, fmt, ep, 5, 96, 24, seed=11)


@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
def test_fused_fwd_full_width(fmt):
    """The train step's hidden-layer shape, (5,784)·(784,100)."""
    _check_fused("lut", fmt, "all", 5, 784, 100, seed=12)


# ------------------------------------------------------------------ dX --

@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
@pytest.mark.parametrize("shape", [(5, 24, 40), (5, 10, 100)],
                         ids=["ragged", "full-width"])
def test_dx_plain_vs_reference(kind, fmt, shape):
    m, n, k = shape
    js, ts = DELTA[kind]
    rng = np.random.default_rng(13)
    dy = _operand(rng, (m, n), fmt, scale=0.1)
    w = _operand(rng, (k, n), fmt, scale=0.05, zero_frac=0.02)
    want = _jax_dx_ref(*dy, *w, fmt=J.FORMATS[fmt], spec=js)
    _eq(TK.lns_matmul_dx(*_t(dy), *_t(w), fmt=T.FORMATS[fmt], spec=ts),
        want, "plain")
    r = TK.lns_matmul_dx_ref(T.LNSArray(*_t(dy)), T.LNSArray(*_t(w)),
                             fmt=T.FORMATS[fmt], spec=ts)
    _eq([r.code, r.sign], want, "ref")


# ------------------------------------------------------- dW + ⊞-SGD --

# (kind, fmt, sgd, batch M, columns N) at K = 40: the step's batch of 5,
# then the edges of the card's short form: one step, 33 steps, and one
# output column.
DW_CASES = [pytest.param(k, f, "momentum+decay", 5, 24,
                         id=f"{k}-{f}-momentum+decay")
            for k in DELTA for f in ("lns16", "lns12")]
DW_CASES += [pytest.param("lut", "lns16", s, 5, 24, id=f"lut-lns16-{s}")
             for s in ("plain", "decay", "momentum")]
DW_CASES += [pytest.param(k, f, "momentum", m, n,
                          id=f"{k}-{f}-momentum-batch{m}-n{n}")
             for k, f in (("lut", "lns16"), ("exact", "lns12"))
             for m, n in ((1, 24), (33, 24), (5, 1))]


def _check_dw_update(kind, fmt, sgd, m, k, n, seed):
    js, ts = DELTA[kind]
    jf, tf = J.FORMATS[fmt], T.FORMATS[fmt]
    jep = J.UpdateEpilogue.from_sgd(J.LogSGDConfig(**SGD[sgd]), jf)
    tep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**SGD[sgd]), tf)
    rng = np.random.default_rng(seed)
    x = _operand(rng, (m, k), fmt, zero_frac=0.5)
    dy = _operand(rng, (m, n), fmt, scale=0.1)
    w = _operand(rng, (k, n), fmt, scale=0.05, zero_frac=0.02)
    mom = _operand(rng, (k, n), fmt, scale=0.01, zero_frac=0.3)
    jm = J.LNSArray(*mom) if jep.has_momentum else None
    jw2, jm2 = _jax_dw_update_ref(*x, *dy, J.LNSArray(*w), jm, fmt=jf,
                                  spec=js, epilogue=jep)
    want = [jw2.code, jw2.sign] + ([jm2.code, jm2.sign]
                                   if jep.has_momentum else [])
    tm = _t(mom) if tep.has_momentum else (None, None)
    got = TK.lns_matmul_dw_update(*_t(x), *_t(dy), w_code=_t(w)[0],
                                  w_sign=_t(w)[1], epilogue=tep, fmt=tf,
                                  spec=ts, m_code=tm[0], m_sign=tm[1])
    _eq(got, want, f"plain {kind}/{fmt}/{sgd}")
    w2, m2 = TK.lns_matmul_dw_update_ref(
        T.LNSArray(*_t(x)), T.LNSArray(*_t(dy)), w=T.LNSArray(*_t(w)),
        m=T.LNSArray(*tm) if tep.has_momentum else None, epilogue=tep,
        fmt=tf, spec=ts)
    _eq([w2.code, w2.sign] + ([m2.code, m2.sign] if m2 is not None else []),
        want, "ref")


@pytest.mark.parametrize("kind,fmt,sgd,batch,n", DW_CASES)
def test_dw_update_plain_vs_reference(kind, fmt, sgd, batch, n):
    _check_dw_update(kind, fmt, sgd, batch, 40, n, seed=14)


def test_dw_update_full_width():
    """The train step's w1 shape: (5,784)ᵀ·(5,100) → (784,100)."""
    _check_dw_update("lut", "lns16", "momentum+decay", 5, 784, 100, seed=15)


# ------------------------------------------------ elementwise ⊞-SGD --

@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
@pytest.mark.parametrize("sgd,n", [pytest.param(s, 100, id=s) for s in SGD]
                         + [pytest.param(s, 257, id=f"{s}-n257")
                            for s in ("decay", "momentum+decay")])
def test_fused_update_plain_vs_reference(kind, fmt, sgd, n):
    """The bias sizes (100) and 257, which the card's update takes as 64
    whole vectors of 4 and one element."""
    js, ts = DELTA[kind]
    jf, tf = J.FORMATS[fmt], T.FORMATS[fmt]
    jep = J.UpdateEpilogue.from_sgd(J.LogSGDConfig(**SGD[sgd]), jf)
    tep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**SGD[sgd]), tf)
    rng = np.random.default_rng(16)
    w, g = (_operand(rng, (n,), fmt, scale=0.1) for _ in range(2))
    mom = _operand(rng, (n,), fmt, scale=0.01, zero_frac=0.3)
    jm = J.LNSArray(*mom) if jep.has_momentum else None
    jw2, jm2 = J.apply_update_codes(J.LNSArray(*w), J.LNSArray(*g), jm, jep,
                                    J.DeltaEngine(js, jf))
    want = [jw2.code, jw2.sign] + ([jm2.code, jm2.sign]
                                   if jep.has_momentum else [])
    tm = _t(mom) if tep.has_momentum else (None, None)
    got = TK.lns_fused_update(*_t(w), *_t(g), epilogue=tep, fmt=tf, spec=ts,
                              m_code=tm[0], m_sign=tm[1])
    _eq(got, want, "plain")


# ------------------------------------- against the Pallas kernels (interp) --

def test_fused_fwd_vs_pallas_interpret():
    jep, tep = _fwd_eps("all", "lns16")
    x, w, b = _fwd_operands(17, 8, 24, 16, "lns16")
    want = lns_matmul_fused_pallas(
        x[0], x[1].astype(np.int32), w[0], w[1].astype(np.int32),
        fmt=J.LNS16, spec=J.DELTA_DEFAULT, epilogue=jep, bias_code=b[0],
        bias_sign=b[1].astype(np.int32), block_m=8, block_n=8, block_k=8,
        interpret=True)
    got = TK.lns_matmul_fused(*_t(x), *_t(w), fmt=T.LNS16,
                              spec=T.DELTA_DEFAULT, epilogue=tep,
                              bias_code=_t(b)[0], bias_sign=_t(b)[1])
    _eq(got, want)


def test_dx_vs_pallas_interpret():
    rng = np.random.default_rng(18)
    dy = _operand(rng, (8, 16), "lns16", scale=0.1)
    w = _operand(rng, (24, 16), "lns16", scale=0.05)
    want = lns_matmul_dx_pallas(
        dy[0], dy[1].astype(np.int32), w[0], w[1].astype(np.int32),
        fmt=J.LNS16, spec=J.DELTA_BITSHIFT, block_m=8, block_k=8, block_n=8,
        interpret=True)
    _eq(TK.lns_matmul_dx(*_t(dy), *_t(w), fmt=T.LNS16,
                         spec=T.DELTA_BITSHIFT), want)


def test_dw_update_vs_pallas_interpret():
    rng = np.random.default_rng(19)
    x = _operand(rng, (8, 24), "lns12", zero_frac=0.5)
    dy = _operand(rng, (8, 16), "lns12", scale=0.1)
    w = _operand(rng, (24, 16), "lns12", scale=0.05)
    mom = _operand(rng, (24, 16), "lns12", scale=0.01, zero_frac=0.3)
    cfg = SGD["momentum+decay"]
    jep = J.UpdateEpilogue.from_sgd(J.LogSGDConfig(**cfg), J.LNS12)
    tep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**cfg), T.LNS12)
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    want = lns_matmul_dw_update_pallas(
        x[0], i32(x[1]), dy[0], i32(dy[1]), w_code=w[0], w_sign=i32(w[1]),
        m_code=mom[0], m_sign=i32(mom[1]), epilogue=jep, fmt=J.LNS12,
        spec=J.DELTA_DEFAULT, block_k=8, block_n=8, block_m=8,
        interpret=True)
    got = TK.lns_matmul_dw_update(*_t(x), *_t(dy), w_code=_t(w)[0],
                                  w_sign=_t(w)[1], m_code=_t(mom)[0],
                                  m_sign=_t(mom)[1], epilogue=tep,
                                  fmt=T.LNS12, spec=T.DELTA_DEFAULT)
    _eq(got, want)


def test_fused_update_vs_pallas_interpret():
    rng = np.random.default_rng(20)
    w, g, mom = (_operand(rng, (100,), "lns16", scale=0.1) for _ in range(3))
    cfg = SGD["momentum+decay"]
    jep = J.UpdateEpilogue.from_sgd(J.LogSGDConfig(**cfg), J.LNS16)
    tep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**cfg), T.LNS16)
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    want = lns_fused_update_pallas(
        w[0], i32(w[1]), g[0], i32(g[1]), m_code=mom[0], m_sign=i32(mom[1]),
        epilogue=jep, fmt=J.LNS16, spec=J.DELTA_EXACT, block=32,
        interpret=True)
    got = TK.lns_fused_update(*_t(w), *_t(g), m_code=_t(mom)[0],
                              m_sign=_t(mom)[1], epilogue=tep, fmt=T.LNS16,
                              spec=T.DELTA_EXACT)
    _eq(got, want)


# ------------------------------------------------ dispatcher and lanes --

def test_dispatcher_matches_oracles_on_cpu():
    """``LNSMatmulBackend`` (the CPU lane of each product) equals the
    port's unfused oracles."""
    rng = np.random.default_rng(21)
    x, w, b = (T.LNSArray(*_t(p)) for p in _fwd_operands(21, 5, 30, 12,
                                                        "lns16"))
    dy = T.LNSArray(*_t(_operand(rng, (5, 12), "lns16", scale=0.1)))
    mom = T.LNSArray(*_t(_operand(rng, (30, 12), "lns16", scale=0.01)))
    be = T.LNSMatmulBackend(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    beta = T.beta_code(0.01, T.LNS16)
    a, zs = be.matmul_fused(x, w, bias=b, llrelu_beta=beta, out_fmt=T.LNS12,
                            emit_z_sign=True)
    ra, rzs = TK.lns_matmul_fused_ref(
        x, w, fmt=T.LNS16, spec=T.DELTA_DEFAULT, bias=b,
        epilogue=TK.FwdEpilogue(bias=True, llrelu_beta=beta,
                                dst_fmt=T.LNS12, emit_z_sign=True))
    assert torch.equal(a.code, ra.code) and torch.equal(a.sign, ra.sign)
    assert torch.equal(zs, rzs)
    # out_fmt equal to the layer format is no conversion.
    z = be.matmul_fused(x, w, out_fmt=T.LNS16)
    rz, _ = TK.lns_matmul_fused_ref(x, w, fmt=T.LNS16, spec=T.DELTA_DEFAULT,
                                    epilogue=TK.FwdEpilogue())
    assert torch.equal(z.code, rz.code) and torch.equal(z.sign, rz.sign)
    dx = be.matmul_dx(dy, w)
    rdx = TK.lns_matmul_dx_ref(dy, w, fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    assert torch.equal(dx.code, rdx.code) and torch.equal(dx.sign, rdx.sign)
    ep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**SGD["momentum+decay"]),
                                   T.LNS16)
    w2, m2 = be.matmul_dw_update(x, dy, w, mom, ep)
    rw2, rm2 = TK.lns_matmul_dw_update_ref(x, dy, w=w, m=mom, epilogue=ep,
                                           fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    for p, q in ((w2, rw2), (m2, rm2)):
        assert torch.equal(p.code, q.code) and torch.equal(p.sign, q.sign)
    b2, mb2 = be.fused_update(b, b, None, T.UpdateEpilogue.from_sgd(
        T.LogSGDConfig(), T.LNS16))
    rb2, _ = T.apply_update_codes(
        b, b, None, T.UpdateEpilogue.from_sgd(T.LogSGDConfig(), T.LNS16),
        T.cached_engine(T.DELTA_DEFAULT, T.LNS16))
    assert mb2 is None
    assert torch.equal(b2.code, rb2.code) and torch.equal(b2.sign, rb2.sign)


def test_cpu_lane_launches_nothing():
    TKS.reset_launch_counts()
    x, w, b = (T.LNSArray(*_t(p)) for p in _fwd_operands(22, 4, 8, 4,
                                                        "lns16"))
    be = T.LNSMatmulBackend(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    be.matmul_fused(x, w)
    be.affine(x, w, b)
    be.matmul_dw(x, x)
    be.matmul_dw_partials(x, x, 2)
    assert TKS.launch_counts() == dict.fromkeys(TKS.KERNEL_WRAPPERS, 0)
    assert set(TKS.KERNEL_WRAPPERS) == {
        "lns_matmul_fused", "lns_matmul_dx", "lns_matmul_dw_update",
        "lns_fused_update", "lns_matmul", "lns_matmul_dw",
        "lns_matmul_dw_partials", "lns_boxsum"}


def test_unported_products_and_bad_inputs_raise():
    be = T.LNSMatmulBackend(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    x = T.zeros((6, 3), T.LNS16)
    for s in (4, 0, 7):
        with pytest.raises(ValueError, match="not divisible"):
            be.matmul_dw_partials(x, x, s)
    with pytest.raises(ValueError, match="epilogue"):
        TK.mac_plain(x.code, x.sign, x.code, x.sign, a_contract_axis=0,
                     b_contract_axis=0, fmt=T.LNS16, spec=T.DELTA_DEFAULT,
                     segments=2, fwd_epilogue=TK.FwdEpilogue())
    # The reference kernels' interpret / blocks switches parse and print,
    # and route nothing: the operands' device picks the lane.
    for text in ("lns16-train-pallas,interpret=on",
                 "lns16-train-pallas,blocks=auto"):
        assert str(T.NumericsSpec.parse(text)) == text
    ep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(momentum=0.9), T.LNS16)
    with pytest.raises(ValueError, match="momentum"):
        be.fused_update(x, x, None, ep)
    with pytest.raises(ValueError, match="bias"):
        TK.lns_matmul_fused_kernel(x, x.T, epilogue=TK.FwdEpilogue(bias=True),
                                   fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    meta = T.LNSArray(torch.empty((2, 3), dtype=torch.int32, device="meta"),
                      torch.empty((2, 3), dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="no ⊞-MAC lane"):
        be.matmul_dx(meta, meta)


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    """No fallback hides a missing toolkit: the build raises."""
    from repro_torch.kernels import build
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here; the failing build is not "
                    "reachable")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()


# ------------------------------- plain forward, plain dW, segment partials --

@partial(jax.jit, static_argnames=("fmt", "spec"))
def _jax_fwd_ref(xc, xs, wc, ws, *, fmt, spec):
    return JK.lns_matmul_ref(xc, xs, wc, ws, fmt=fmt, spec=spec)


@partial(jax.jit, static_argnames=("fmt", "spec"))
def _jax_dw_ref(xc, xs, dc, ds, *, fmt, spec):
    return JK.lns_matmul_dw_ref(xc, xs, dc, ds, fmt=fmt, spec=spec)


@partial(jax.jit, static_argnames=("fmt", "spec", "num_segments"))
def _jax_dw_partials_ref(xc, xs, dc, ds, *, fmt, spec, num_segments):
    return JK.lns_matmul_dw_partials_ref(xc, xs, dc, ds, fmt=fmt, spec=spec,
                                         num_segments=num_segments)


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
@pytest.mark.parametrize("shape", [(7, 53, 45), (5, 100, 10)],
                         ids=["ragged", "step-out"])
def test_matmul_plain_vs_reference(kind, fmt, shape):
    m, k, n = shape
    js, ts = DELTA[kind]
    x, w, _ = _fwd_operands(23, m, k, n, fmt)
    want = _jax_fwd_ref(*x, *w, fmt=J.FORMATS[fmt], spec=js)
    _eq(TK.lns_matmul(*_t(x), *_t(w), fmt=T.FORMATS[fmt], spec=ts), want,
        "plain")
    r = TK.lns_matmul_ref(T.LNSArray(*_t(x)), T.LNSArray(*_t(w)),
                          fmt=T.FORMATS[fmt], spec=ts)
    _eq([r.code, r.sign], want, "ref")


@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
def test_matmul_full_width(fmt):
    """The unfused step's hidden-layer product, (5,784)·(784,100)."""
    x, w, _ = _fwd_operands(24, 5, 784, 100, fmt)
    want = _jax_fwd_ref(*x, *w, fmt=J.FORMATS[fmt], spec=J.DELTA_DEFAULT)
    _eq(TK.lns_matmul(*_t(x), *_t(w), fmt=T.FORMATS[fmt],
                      spec=T.DELTA_DEFAULT), want)


def _dw_operands(seed, m, k, n, fmt):
    rng = np.random.default_rng(seed)
    return (_operand(rng, (m, k), fmt, zero_frac=0.5),
            _operand(rng, (m, n), fmt, scale=0.1))


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
@pytest.mark.parametrize("shape", [(37, 40, 24), (5, 784, 100), (5, 40, 1)],
                         ids=["ragged", "step-w1", "c1"])
def test_dw_plain_vs_reference(kind, fmt, shape):
    m, k, n = shape
    js, ts = DELTA[kind]
    x, dy = _dw_operands(25, m, k, n, fmt)
    want = _jax_dw_ref(*x, *dy, fmt=J.FORMATS[fmt], spec=js)
    _eq(TK.lns_matmul_dw(*_t(x), *_t(dy), fmt=T.FORMATS[fmt], spec=ts),
        want, "plain")
    r = TK.lns_matmul_dw_ref(T.LNSArray(*_t(x)), T.LNSArray(*_t(dy)),
                             fmt=T.FORMATS[fmt], spec=ts)
    _eq([r.code, r.sign], want, "ref")


DW_PARTIALS_CASES = [(k, f, 8, s) for k in DELTA for f in ("lns16", "lns12")
                     for s in (1, 2, 4, 8)]
DW_PARTIALS_CASES += [("lut", "lns16", 5, 5), ("bitshift", "lns12", 5, 5)]


@pytest.mark.parametrize("kind,fmt,batch,segments", DW_PARTIALS_CASES)
def test_dw_partials_plain_vs_reference(kind, fmt, batch, segments):
    js, ts = DELTA[kind]
    x, dy = _dw_operands(26, batch, 13, 9, fmt)
    want = _jax_dw_partials_ref(*x, *dy, fmt=J.FORMATS[fmt], spec=js,
                                num_segments=segments)
    got = TK.lns_matmul_dw_partials(*_t(x), *_t(dy), num_segments=segments,
                                    fmt=T.FORMATS[fmt], spec=ts)
    assert tuple(got[0].shape) == (segments, 13, 9)
    _eq(got, want, "plain")
    r = TK.lns_matmul_dw_partials_ref(
        T.LNSArray(*_t(x)), T.LNSArray(*_t(dy)), num_segments=segments,
        fmt=T.FORMATS[fmt], spec=ts)
    _eq([r.code, r.sign], want, "ref")


def test_dw_partials_full_width():
    """The segmented step's w1 partials: batch 5 in 5 segments."""
    x, dy = _dw_operands(27, 5, 784, 100, "lns16")
    want = _jax_dw_partials_ref(*x, *dy, fmt=J.LNS16, spec=J.DELTA_DEFAULT,
                                num_segments=5)
    _eq(TK.lns_matmul_dw_partials(*_t(x), *_t(dy), num_segments=5,
                                  fmt=T.LNS16, spec=T.DELTA_DEFAULT), want)


def test_dw_partials_one_segment_is_dw_and_rows_fold_to_dw():
    """S = 1 is the plain dW bit for bit; with one-row segments each slot
    is that sample's outer product and the sequential combine of the
    slots is the plain dW again."""
    x, dy = (T.LNSArray(*_t(p)) for p in _dw_operands(28, 6, 9, 4, "lns16"))
    kw = dict(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    dw = TK.lns_matmul_dw_kernel(x, dy, **kw)
    one = TK.lns_matmul_dw_partials_kernel(x, dy, num_segments=1, **kw)
    assert torch.equal(one.code[0], dw.code)
    assert torch.equal(one.sign[0], dw.sign)
    rows = TK.lns_matmul_dw_partials_kernel(x, dy, num_segments=6, **kw)
    for s in range(6):
        outer = T.boxdot(x[s][:, None], dy[s][None, :], T.LNS16)
        assert torch.equal(rows.code[s], outer.code)
        assert torch.equal(rows.sign[s], outer.sign)
    eng = T.cached_engine(T.DELTA_DEFAULT, T.LNS16)
    folded = T.boxsum_partials(rows, eng, schedule="sequential")
    assert torch.equal(folded.code, dw.code)
    assert torch.equal(folded.sign, dw.sign)


def test_entry_points_vs_pallas_interpret():
    """The LNSArray entry points against the reference's Pallas kernels
    in interpret mode, at tiny shapes with ragged blocks."""
    x, w, _ = _fwd_operands(29, 8, 20, 12, "lns16")
    jx, jw = J.LNSArray(*x), J.LNSArray(*w)
    tx, tw = T.LNSArray(*_t(x)), T.LNSArray(*_t(w))
    blk = dict(block_m=8, block_n=8, block_k=8, interpret=True)
    z = TK.lns_matmul_kernel(tx, tw, fmt=T.LNS16, spec=T.DELTA_BITSHIFT)
    jz = JK.lns_matmul_kernel(jx, jw, fmt=J.LNS16, spec=J.DELTA_BITSHIFT,
                              **blk)
    _eq([z.code, z.sign], [jz.code, jz.sign], "fwd")
    dy = _operand(np.random.default_rng(30), (8, 12), "lns16", scale=0.1)
    jd, td = J.LNSArray(*dy), T.LNSArray(*_t(dy))
    g = TK.lns_matmul_dw_kernel(tx, td, fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    jg = JK.lns_matmul_dw_kernel(jx, jd, fmt=J.LNS16, spec=J.DELTA_DEFAULT,
                                 block_k=8, block_n=8, block_m=8,
                                 interpret=True)
    _eq([g.code, g.sign], [jg.code, jg.sign], "dw")
    p = TK.lns_matmul_dw_partials_kernel(tx, td, num_segments=4,
                                         fmt=T.LNS16, spec=T.DELTA_EXACT)
    jp = JK.lns_matmul_dw_partials_kernel(jx, jd, num_segments=4,
                                          fmt=J.LNS16, spec=J.DELTA_EXACT,
                                          block_k=8, block_n=8,
                                          interpret=True)
    _eq([p.code, p.sign], [jp.code, jp.sign], "dw_partials")


@pytest.mark.parametrize("kind", list(DELTA))
def test_dispatcher_products_match_reference_emulate(kind):
    """``LNSMatmulBackend.matmul`` / ``affine`` / ``matmul_dw`` /
    ``matmul_dw_partials`` equal the reference dispatcher's emulate
    lane."""
    js, ts = DELTA[kind]
    x, w, b = _fwd_operands(31, 6, 14, 5, "lns12")
    dy = _operand(np.random.default_rng(32), (6, 5), "lns12", scale=0.1)
    jbe = J.LNSMatmulBackend(fmt=J.LNS12, spec=js, backend="emulate")
    tbe = T.LNSMatmulBackend(fmt=T.LNS12, spec=ts)
    jx, jw, jb, jd = (J.LNSArray(*p) for p in (x, w, b, dy))
    tx, tw, tb, td = (T.LNSArray(*_t(p)) for p in (x, w, b, dy))
    for name, got, want in (
            ("matmul", tbe.matmul(tx, tw), jbe.matmul(jx, jw)),
            ("affine", tbe.affine(tx, tw, tb), jbe.affine(jx, jw, jb)),
            ("matmul_dw", tbe.matmul_dw(tx, td), jbe.matmul_dw(jx, jd)),
            ("matmul_dw_partials", tbe.matmul_dw_partials(tx, td, 3),
             jbe.matmul_dw_partials(jx, jd, 3))):
        _eq([got.code, got.sign], [want.code, want.sign], name)


# ------------------------------------------- LUT steps and the Δ index --

LUT_STEPS = {"r0.375": (9.0, 0.375), "lut640": (10.0, 1.0 / 64.0)}


def _index_edge_operands(fmt, spec, swap):
    """A (R, 2) and B (2, 2) whose second ⊞ step meets chosen differences
    d with equal (column 0) and opposite (column 1) signs: d = 0, d in
    [1, r_code/2), around every index boundary of the first entries and
    the table's end, past the end, and the format's widest d."""
    f = J.FORMATS[fmt]
    r = int(round(spec[1] * f.scale))
    n = int(round(spec[0] / spec[1]))
    lo, hi = f.min_nonzero_code, f.code_max
    ds = {0, 1, max(r // 2 - 1, 0), r // 2, r // 2 + 1, r, r + r // 2,
          n * r - r // 2 - 1, n * r - r // 2, n * r - r // 2 + 1, n * r,
          n * r + 7, hi - lo}
    ds = sorted(d for d in ds if 0 <= d <= hi - lo)
    a_c = np.array([[lo + d, lo] for d in ds], np.int32)
    a_s = np.zeros_like(a_c, dtype=np.int8)
    b_c = np.zeros((2, 2), np.int32)
    b_s = np.array([[0, 1], [0, 0]], np.int8)
    if swap:
        a_c, a_s, b_c, b_s = a_c[:, ::-1], a_s[:, ::-1], b_c[::-1], b_s[::-1]
    return ((np.ascontiguousarray(a_c), np.ascontiguousarray(a_s)),
            (np.ascontiguousarray(b_c), np.ascontiguousarray(b_s)))


@pytest.mark.parametrize("step", list(LUT_STEPS))
@pytest.mark.parametrize("fmt", ["lns16", "lns12"])
def test_lut_steps_plain_vs_reference(step, fmt):
    """mac_plain against the JAX emulate oracle for a LUT step that is not
    a power of two (r = 0.375: r_code 384 in lns16, 24 in lns12) and for
    lut640: products past the table's end and into [1, r_code/2), in both
    orders and sign relations, then a random product with zeros."""
    d_max, r = LUT_STEPS[step]
    js = J.DeltaSpec(kind="lut", d_max=d_max, r=r)
    ts = T.DeltaSpec(kind="lut", d_max=d_max, r=r)
    cases = [_index_edge_operands(fmt, (d_max, r), swap)
             for swap in (False, True)]
    rng = np.random.default_rng(31)
    cases.append((_operand(rng, (6, 29), fmt, scale=2.0, zero_frac=0.3),
                  _operand(rng, (29, 7), fmt, scale=0.5, zero_frac=0.1)))
    for x, w in cases:
        want = _jax_fwd_ref(*x, *w, fmt=J.FORMATS[fmt], spec=js)
        _eq(TK.lns_matmul(*_t(x), *_t(w), fmt=T.FORMATS[fmt], spec=ts), want,
            f"{step}/{fmt}")


@pytest.mark.parametrize("fmt", ["lns16", "lns12", "lns21"])
@pytest.mark.parametrize("d_max,r", [(10.0, 0.5), (10.0, 1.0 / 64.0),
                                     (9.0, 0.375), (16.0, 1.0 / 64.0),
                                     (3.0, 0.75), (5.0, 5.0 / 64.0)])
def test_lut_index_args_equal_the_divide(fmt, d_max, r):
    """The kernels' Δ index, min(d + half, lim) then a shift or a
    multiply-high, equals the reference's (d + r_code // 2) // r_code
    clamped to n_tab for every difference of the format and beyond; the
    kernels' table is the engine's (Δ+, Δ−) pairs and a zero pair."""
    from repro_torch.kernels import _common
    f = T.FORMATS[fmt]
    spec = T.DeltaSpec(kind="lut", d_max=d_max, r=r)
    eng = T.cached_engine(spec, f)
    n = spec.table_size
    half, lim, mul, shift = _common.lut_index_args(eng.r_code, n)
    d = np.arange(0, 2 * (f.code_max - f.min_nonzero_code) + 3,
                  dtype=np.uint64)
    x = np.minimum(d + np.uint64(half), np.uint64(lim))
    if mul:
        assert 0 < mul < 1 << 32
        idx = (x * np.uint64(mul)) >> np.uint64(32 + shift)
    else:
        assert eng.r_code == 1 << shift
        idx = x >> np.uint64(shift)
    want = np.minimum((d + np.uint64(eng.r_code // 2))
                      // np.uint64(eng.r_code), np.uint64(n))
    np.testing.assert_array_equal(idx, want)
    pairs = _common.lut_pairs(spec, f, torch.device("cpu"))
    tp, tm = eng.tables("cpu")
    assert pairs.shape == (n + 1, 2) and pairs.dtype == torch.int32
    assert torch.equal(pairs[:n, 0], tp) and torch.equal(pairs[:n, 1], tm)
    assert pairs[n].tolist() == [0, 0] and int(tm[0]) == eng.underflow
