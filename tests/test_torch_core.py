"""The port's numerics core (``repro_torch.core``) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; integer
results must be equal code for code and sign for sign.  Float readouts
carry the tolerance stated at each assert.
"""
import math

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

# The plain ⊞ versions are long chains of small tensor ops.  Under xdist
# several port test files run at once, and OpenMP pools of 8 spinning
# threads in each process oversubscribe the cores many times over: one
# intra-op thread a process keeps each file near its serial time.
torch.set_num_threads(1)

FMTS = ("lns16", "lns12")
DELTAS = {"lut": (J.DELTA_DEFAULT, T.DELTA_DEFAULT),
          "lut640": (J.DELTA_SOFTMAX, T.DELTA_SOFTMAX),
          "bitshift": (J.DELTA_BITSHIFT, T.DELTA_BITSHIFT),
          "exact": (J.DELTA_EXACT, T.DELTA_EXACT)}


def _fmts(name):
    return J.FORMATS[name], T.FORMATS[name]


def _np(a):
    return np.asarray(a.code), np.asarray(a.sign)


def _eq(j, t, msg=""):
    jc, js = _np(j)
    np.testing.assert_array_equal(t.code.numpy(), jc, err_msg=f"{msg} code")
    np.testing.assert_array_equal(t.sign.numpy(), js, err_msg=f"{msg} sign")
    assert t.code.dtype == torch.int32 and t.sign.dtype == torch.int8


def _lns_pair(rng, shape, fmt_name, *, scale=1.0, zero_frac=0.2):
    """The same random LNS operand in both packages."""
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    v[rng.random(size=shape) < zero_frac] = 0.0
    jf, _ = _fmts(fmt_name)
    j = J.encode(v, jf)
    c, s = _np(j)
    return j, T.LNSArray(torch.as_tensor(c.copy()), torch.as_tensor(s.copy()))


# ----------------------------------------------------------- formats, Δ --

@pytest.mark.parametrize("name", ["lns16", "lns12", "lns21"])
def test_formats_match(name):
    jf, tf = J.FORMATS[name], T.FORMATS[name]
    for attr in ("qi", "qf", "name", "total_bits", "scale", "code_max",
                 "code_min", "zero_code", "min_nonzero_code"):
        assert getattr(tf, attr) == getattr(jf, attr), attr


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("kind", ["lut", "lut640"])
def test_delta_tables_byte_equal(fmt, kind):
    jf, tf = _fmts(fmt)
    js, ts = DELTAS[kind]
    je, te = J.DeltaEngine(js, jf), T.DeltaEngine(ts, tf)
    assert te._tab_plus.dtype == np.int32
    assert te._tab_plus.tobytes() == np.asarray(je._tab_plus).tobytes()
    assert te._tab_minus.tobytes() == np.asarray(je._tab_minus).tobytes()
    assert te.r_code == je.r_code and te.underflow == int(je.underflow)
    assert te.underflow == -(1 << (tf.qi + tf.qf + 2))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("kind", ["lut", "lut640", "bitshift", "exact"])
def test_delta_every_d_code(fmt, kind):
    """Δ+ and Δ- over every difference code two format codes can have."""
    jf, tf = _fmts(fmt)
    js, ts = DELTAS[kind]
    je, te = J.DeltaEngine(js, jf), T.DeltaEngine(ts, tf)
    d = np.arange(0, tf.code_max - tf.code_min + 1, dtype=np.int32)
    dt = torch.as_tensor(d)
    np.testing.assert_array_equal(te.plus(dt).numpy(), np.asarray(je.plus(d)))
    np.testing.assert_array_equal(te.minus(dt).numpy(),
                                  np.asarray(je.minus(d)))


@pytest.mark.parametrize("fmt", ["lns16", "lns12", "lns21"])
def test_scalar_codes(fmt):
    jf, tf = J.FORMATS[fmt], T.FORMATS[fmt]
    for v in (0.01, 0.9, 1e-4, 0.01 * 0.01, 0.01 * 0.3, math.log2(math.e),
              -0.5, 0.0, 1e-12, 1e12, 1.0):
        j, t = J.scalar(v, jf), T.scalar(v, tf)
        assert int(t.code) == int(j.code) and int(t.sign) == int(j.sign), v


# -------------------------------------------------------------- codecs --

@pytest.mark.parametrize("fmt", FMTS)
def test_encode_all_pixels(fmt):
    """Every 8-bit pixel value k/255, the only floats the train step
    encodes, gives equal codes."""
    jf, tf = _fmts(fmt)
    pix = (np.arange(256) / 255.0).astype(np.float32)
    _eq(J.encode(pix, jf), T.encode(torch.as_tensor(pix), tf), "pixels")


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_arbitrary_floats(fmt):
    """On arbitrary floats XLA's float32 log and the port's (float64,
    rounded once) differ by an ulp now and then, which moves a code by one
    where log2|v|·2^qf lies at a half-integer (ROADMAP queue 3 records the
    count).  Everything else — zeros, saturation, underflow, signs — must
    agree exactly."""
    jf, tf = _fmts(fmt)
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(
        -8, 8, size=4096), [0.0, -0.0, 1e30, -1e30, 1e-30]]).astype(
        np.float32)
    j, t = J.encode(v, jf), T.encode(torch.as_tensor(v), tf)
    jc, js = _np(j)
    np.testing.assert_array_equal(t.sign.numpy(), js)
    diff = t.code.numpy().astype(np.int64) - jc
    off = np.nonzero(diff)[0]
    assert np.abs(diff).max() <= 1
    x = np.log2(np.abs(v[off]).astype(np.float64)) * tf.scale
    np.testing.assert_array_less(np.abs(x - np.floor(x) - 0.5), 2e-3)


@pytest.mark.parametrize("fmt", FMTS)
def test_decode(fmt):
    jf, tf = _fmts(fmt)
    j, t = _lns_pair(np.random.default_rng(2), (512,), fmt)
    # Float readout: exp2 of the same float32 argument; torch and XLA may
    # round it an ulp apart.
    np.testing.assert_allclose(T.decode(t, tf).numpy(),
                               np.asarray(J.decode(j, jf)), rtol=1e-6)


@pytest.mark.parametrize("fmt", FMTS)
def test_lns_value_to_code_every_code(fmt):
    """Every code of the format, both signs: the softmax's log→linear
    conversion."""
    jf, tf = _fmts(fmt)
    from repro.core.conversions import lns_value_to_code as jv
    codes = np.arange(tf.zero_code, tf.code_max + 1, dtype=np.int32)
    for s in (0, 1):
        sign = np.full(codes.shape, s, np.int8)
        want = np.asarray(jv(J.LNSArray(codes, sign), jf))
        got = T.lns_value_to_code(
            T.LNSArray(torch.as_tensor(codes), torch.as_tensor(sign)), tf)
        np.testing.assert_array_equal(got.numpy(), want)


def test_f32_functions_do_not_depend_on_position():
    """torch's float32 exp2 rounds differently in its vectorized and
    scalar loops; ``core.f32`` gives each value from its input alone."""
    x = torch.arange(0, 32768, dtype=torch.int32).float() / -1024
    full = T.f32.exp2(x)
    single = torch.stack([T.f32.exp2(x[i:i + 1])[0]
                          for i in range(0, 32768, 97)])
    assert torch.equal(full[::97], single)
    y = torch.linspace(1e-3, 40.0, 32768)
    assert torch.equal(T.f32.log2(y)[::97],
                       torch.stack([T.f32.log2(y[i:i + 1])[0]
                                    for i in range(0, 32768, 97)]))


@pytest.mark.parametrize("src,dst", [("lns16", "lns12"), ("lns12", "lns16"),
                                     ("lns16", "lns21")])
def test_convert_format_every_code(src, dst):
    (js, ts), (jd, td) = _fmts(src), _fmts(dst)
    codes = np.arange(ts.zero_code, ts.code_max + 1, dtype=np.int32)
    sign = (codes % 2).astype(np.int8)
    _eq(J.convert_format(J.LNSArray(codes, sign), js, jd),
        T.convert_format(T.LNSArray(torch.as_tensor(codes),
                                    torch.as_tensor(sign)), ts, td))


# ---------------------------------------------------------- ⊞ arithmetic --

@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("kind", ["lut", "bitshift", "exact"])
def test_boxplus_boxminus_boxdot(fmt, kind):
    jf, tf = _fmts(fmt)
    js, ts = DELTAS[kind]
    je, te = J.DeltaEngine(js, jf), T.DeltaEngine(ts, tf)
    rng = np.random.default_rng(3)
    ja, ta = _lns_pair(rng, (64, 33), fmt)
    jb, tb = _lns_pair(rng, (64, 33), fmt)
    # Equal magnitudes, both signs: the exact-cancel path.
    c, s = _np(ja)
    jc = J.LNSArray(c, (1 - s).astype(np.int8))
    tc = T.LNSArray(torch.as_tensor(c.copy()),
                    torch.as_tensor((1 - s).astype(np.int8)))
    _eq(J.boxplus(ja, jb, je), T.boxplus(ta, tb, te), "plus")
    _eq(J.boxminus(ja, jb, je), T.boxminus(ta, tb, te), "minus")
    _eq(J.boxplus(ja, jc, je), T.boxplus(ta, tc, te), "cancel")
    _eq(J.boxdot(ja, jb, jf), T.boxdot(ta, tb, tf), "dot")
    _eq(J.bias_add(ja, jb[0], je), T.bias_add(ta, tb[0], te), "bias_add")
    _eq(J.boxabs_max(ja, axis=1), T.boxabs_max(ta, axis=1), "absmax")


@pytest.mark.parametrize("order", ["pairwise", "sequential"])
@pytest.mark.parametrize("n", [1, 5, 8, 13])
def test_boxsum_both_orders(order, n):
    jf, tf = _fmts("lns16")
    je, te = J.DeltaEngine(J.DELTA_DEFAULT, jf), T.DeltaEngine(
        T.DELTA_DEFAULT, tf)
    ja, ta = _lns_pair(np.random.default_rng(4), (n, 7, 3), "lns16")
    jsum = jax.jit(J.boxsum, static_argnums=(1, 2, 3))
    for axis in (0, 1, 2):
        _eq(jsum(ja, axis, je, order), T.boxsum(ta, axis, te, order=order),
            f"axis {axis}")


def test_boxsum_rejects_unknown_order():
    ta = T.zeros((4,), T.LNS16)
    with pytest.raises(ValueError, match="pairwise"):
        T.boxsum(ta, 0, T.cached_engine(T.DELTA_DEFAULT, T.LNS16),
                 order="tree")


@pytest.mark.parametrize("kind", ["lut", "bitshift"])
def test_lns_matmul_sequential(kind):
    jf, tf = _fmts("lns16")
    js, ts = DELTAS[kind]
    rng = np.random.default_rng(5)
    jx, tx = _lns_pair(rng, (6, 40), "lns16", zero_frac=0.5)
    jw, tw = _lns_pair(rng, (40, 9), "lns16", scale=0.1)
    _eq(J.lns_matmul(jx, jw, J.DeltaEngine(js, jf), order="sequential"),
        T.lns_matmul(tx, tw, T.DeltaEngine(ts, tf), order="sequential"))


# ------------------------------------------------- activations, softmax --

@pytest.mark.parametrize("fmt", FMTS)
def test_llrelu_and_grad(fmt):
    jf, tf = _fmts(fmt)
    beta = T.beta_code(0.01, tf)
    assert beta == J.beta_code(0.01, jf)
    j, t = _lns_pair(np.random.default_rng(6), (300,), fmt, scale=1e-3)
    _eq(J.llrelu(j, beta, jf), T.llrelu(t, beta, tf))
    _eq(J.llrelu_grad_from_sign(j.sign, beta),
        T.llrelu_grad_from_sign(t.sign, beta))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("kind", ["lut640", "exact"])
def test_softmax_ce(fmt, kind):
    jf, tf = _fmts(fmt)
    js, ts = DELTAS[kind]
    je, te = J.DeltaEngine(js, jf), T.DeltaEngine(ts, tf)
    rng = np.random.default_rng(7)
    j, t = _lns_pair(rng, (64, 10), fmt, scale=3.0, zero_frac=0.05)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    jp = jax.jit(J.log_softmax_lns, static_argnums=1)(j, je)
    tp = T.log_softmax_lns(t, te)
    _eq(jp, tp, "p")
    tl = torch.as_tensor(labels).long()
    _eq(J.ce_grad_init(jp, labels, jf, je), T.ce_grad_init(tp, tl, tf, te),
        "delta")
    # Float readout: a mean over the batch, summed in another order.
    np.testing.assert_allclose(float(T.ce_loss_readout(tp, tl, tf)),
                               float(J.ce_loss_readout(jp, labels, jf)),
                               rtol=1e-6)


# ------------------------------------------------------------------ SGD --

SGD = {"plain": dict(lr=0.01), "decay": dict(lr=0.01, weight_decay=0.3),
       "momentum": dict(lr=0.01, momentum=0.9),
       "momentum+decay": dict(lr=0.01, weight_decay=0.01, momentum=0.9)}


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", list(SGD))
def test_apply_update_codes(fmt, case):
    jf, tf = _fmts(fmt)
    jep = J.UpdateEpilogue.from_sgd(J.LogSGDConfig(**SGD[case]), jf)
    tep = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**SGD[case]), tf)
    assert dataclass_tuple(tep) == dataclass_tuple(jep)
    rng = np.random.default_rng(8)
    jw, tw = _lns_pair(rng, (50, 7), fmt, scale=0.1)
    jg, tg = _lns_pair(rng, (50, 7), fmt, scale=0.1)
    jm, tm = _lns_pair(rng, (50, 7), fmt, scale=0.01, zero_frac=0.4)
    if not tep.has_momentum:
        jm = tm = None
    je = J.DeltaEngine(J.DELTA_DEFAULT, jf)
    te = T.DeltaEngine(T.DELTA_DEFAULT, tf)
    jw2, jm2 = J.apply_update_codes(jw, jg, jm, jep, je)
    tw2, tm2 = T.apply_update_codes(tw, tg, tm, tep, te)
    _eq(jw2, tw2, "w")
    if tep.has_momentum:
        _eq(jm2, tm2, "m")
    else:
        assert tm2 is None


def dataclass_tuple(ep):
    return (ep.lr_code, ep.momentum_code, ep.weight_decay_code)


def test_update_epilogue_rejects_bad_sgd():
    with pytest.raises(ValueError):
        T.UpdateEpilogue.from_sgd(T.LogSGDConfig(lr=0.0), T.LNS16)
    with pytest.raises(ValueError):
        T.UpdateEpilogue.from_sgd(T.LogSGDConfig(momentum=-1.0), T.LNS16)


# --------------------------------------------------------- initializers --

def test_log_density_normal_matches_reference():
    from repro.core.initializers import log_density_normal as jd
    y = np.linspace(-20, 3, 1001)
    np.testing.assert_array_equal(T.log_density_normal(y, 0.05), jd(y, 0.05))
    assert T.he_sigma(784) == J.he_sigma(784)


@pytest.mark.parametrize("fmt", FMTS)
def test_log_normal_init_in_law(fmt):
    """Threefry cannot be matched in torch: the port's init is held in
    law.  Y = code / 2^qf must follow f_W of eq. (12) (KS test against
    the CDF integrated from ``log_density_normal``), and the sign must be
    a fair coin."""
    tf = T.FORMATS[fmt]
    sigma = T.he_sigma(784)
    w = T.log_normal_init(torch.Generator().manual_seed(0), (784, 100),
                          sigma, tf)
    n = w.code.numel()
    codes, counts = np.unique(w.code.numpy(), return_counts=True)
    y = codes / tf.scale
    grid = np.linspace(y[0] - 30, y[-1] + 1, 400001)
    f = T.log_density_normal(grid, sigma)
    cdf = np.concatenate([[0.0], np.cumsum((f[1:] + f[:-1]) / 2
                                           * np.diff(grid))])
    # P(code <= c) = P(Y < c + half a step): codes are Y rounded.
    model = np.interp(y + 0.5 / tf.scale, grid, cdf)
    emp = np.cumsum(counts) / n
    d = np.max(np.abs(emp - model))
    assert d < 1.63 / math.sqrt(n), d     # KS at the 1% level
    frac_neg = float(w.sign.float().mean())
    assert abs(frac_neg - 0.5) < 4 * 0.5 / math.sqrt(n)
    assert w.code.dtype == torch.int32 and w.sign.dtype == torch.int8
