"""The port's CUDA kernels on the card.  Marked ``gpu``: they skip on a
host without a CUDA card and run on the H100 with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Imports no JAX: the card's machine has none.  Each kernel is held bit for
bit against its plain PyTorch version on the card, and the fused, unfused
and segmented train steps on the card against the CPU lane.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.kernels as TKS
import repro_torch.kernels.lns_matmul as TK
from repro_torch.kernels.lns_boxsum import (boxsum_plain, lns_boxsum,
                                            lns_boxsum_many)
from repro_torch.paper import MLPConfig, make_mlp, params_to_numpy
from repro_torch.paper import datasets

pytestmark = pytest.mark.gpu

DELTA = {"lut": T.DELTA_DEFAULT, "bitshift": T.DELTA_BITSHIFT,
         "exact": T.DELTA_EXACT}
OTHER = {"lns16": T.LNS12, "lns12": T.LNS16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operand(gen, shape, fmt, device, *, scale=1.0, zero_frac=0.2):
    v = torch.randn(shape, generator=gen) * scale
    v[torch.rand(shape, generator=gen) < zero_frac] = 0.0
    return T.encode(v, fmt).to(device)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_kernels_equal_plain_on_card(cuda, kind, fmt_name):
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(0)
    m, k, n = 13, 71, 37
    x = _operand(gen, (m, k), fmt, cuda, zero_frac=0.5)
    w = _operand(gen, (k, n), fmt, cuda, scale=0.05)
    b = _operand(gen, (n,), fmt, cuda, scale=0.1)
    dy = _operand(gen, (m, n), fmt, cuda, scale=0.1)
    mom = _operand(gen, (k, n), fmt, cuda, scale=0.01, zero_frac=0.3)
    ep = TK.FwdEpilogue(bias=True, llrelu_beta=T.beta_code(0.01, fmt),
                        dst_fmt=OTHER[fmt_name], emit_z_sign=True)
    kw = dict(fmt=fmt, spec=spec)
    _same(TK.lns_matmul_fused(x.code, x.sign, w.code, w.sign, epilogue=ep,
                              bias_code=b.code, bias_sign=b.sign, **kw),
          TK.mac_plain(x.code, x.sign, w.code, w.sign, a_contract_axis=1,
                       b_contract_axis=0, fwd_epilogue=ep, bias_code=b.code,
                       bias_sign=b.sign, **kw))
    _same(TK.lns_matmul_dx(dy.code, dy.sign, w.code, w.sign, **kw),
          TK.mac_plain(dy.code, dy.sign, w.code, w.sign, a_contract_axis=1,
                       b_contract_axis=1, **kw))
    up = T.UpdateEpilogue.from_sgd(
        T.LogSGDConfig(lr=0.01, weight_decay=0.01, momentum=0.9), fmt)
    uk = dict(w_code=w.code, w_sign=w.sign, m_code=mom.code,
              m_sign=mom.sign, **kw)
    _same(TK.lns_matmul_dw_update(x.code, x.sign, dy.code, dy.sign,
                                  epilogue=up, **uk),
          TK.mac_plain(x.code, x.sign, dy.code, dy.sign, a_contract_axis=0,
                       b_contract_axis=0, update_epilogue=up, **uk))
    g = _operand(gen, (k, n), fmt, cuda, scale=0.1)
    fk = dict(epilogue=up, m_code=mom.code, m_sign=mom.sign, **kw)
    _same(TK.lns_fused_update(w.code, w.sign, g.code, g.sign, **fk),
          TK.update_plain(w.code, w.sign, g.code, g.sign, **fk))
    torch.cuda.synchronize()


def test_encode_and_conversion_card_equals_cpu(cuda):
    pix = torch.arange(256, dtype=torch.float32) / 255.0
    for fmt in (T.LNS16, T.LNS12):
        a, b = T.encode(pix, fmt), T.encode(pix.to(cuda), fmt)
        assert torch.equal(a.code, b.code.cpu())
        codes = torch.arange(fmt.zero_code, fmt.code_max + 1,
                             dtype=torch.int32)
        x = T.LNSArray(codes, torch.ones_like(codes, dtype=torch.int8))
        assert torch.equal(T.lns_value_to_code(x, fmt),
                           T.lns_value_to_code(x.to(cuda), fmt).cpu())


CASES = {
    "lut-lns16": ("lns16-train-pallas", {}),
    "bitshift-lns16": ("lns16-train-pallas,delta=bitshift", {}),
    "lut-lns12": ("lns16-train-pallas,fmt=lns12", {"weight_decay": 0.3}),
    "hidden-lns12": ("lns16-train-pallas;hidden=fmt:lns12", {}),
    "momentum+decay": ("lns16-train-pallas",
                       {"momentum": 0.9, "weight_decay": 0.01}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_card_equal_cpu(cuda, case):
    """20 fused steps of batch 5 at full width on the card equal the CPU
    lane after every step, with 7 kernel launches per step."""
    spec, kw = CASES[case]
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    models = {d: make_mlp("lns", MLPConfig(spec=spec, **kw), device=d)
              for d in ("cuda", "cpu")}
    params = {d: m.init(torch.Generator().manual_seed(1))
              for d, m in models.items()}
    moms = {d: m.init_momentum(params[d]) for d, m in models.items()}
    TKS.reset_launch_counts()
    for step in range(20):
        sl = slice(step * 5, (step + 1) * 5)
        for d, m in models.items():
            if moms[d] is None:
                params[d], _ = m.train_step(params[d], x[sl], y[sl])
            else:
                params[d], moms[d], _ = m.train_step(params[d], x[sl], y[sl],
                                                     moms[d])
        got, want = params_to_numpy(params["cuda"]), params_to_numpy(
            params["cpu"])
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w, err_msg=f"{k} @{step}")
    assert TKS.launch_counts() == dict(
        dict.fromkeys(TKS.KERNEL_WRAPPERS, 0), lns_matmul_fused=40,
        lns_matmul_dx=20, lns_matmul_dw_update=40, lns_fused_update=40)
    np.testing.assert_array_equal(
        models["cuda"].predict(params["cuda"], x[:500]).cpu().numpy(),
        models["cpu"].predict(params["cpu"], x[:500]).numpy())


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_plain_and_segment_kernels_equal_plain_on_card(cuda, kind, fmt_name):
    """The plain forward, plain dW and segment-partial dW at a ragged
    shape; S = 1 is the plain dW."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(2)
    m, k, n = 40, 71, 37
    x = _operand(gen, (m, k), fmt, cuda, zero_frac=0.5)
    w = _operand(gen, (k, n), fmt, cuda, scale=0.05)
    dy = _operand(gen, (m, n), fmt, cuda, scale=0.1)
    kw = dict(fmt=fmt, spec=spec)
    _same(TK.lns_matmul(x.code, x.sign, w.code, w.sign, **kw),
          TK.mac_plain(x.code, x.sign, w.code, w.sign, a_contract_axis=1,
                       b_contract_axis=0, **kw))
    dw = TK.lns_matmul_dw(x.code, x.sign, dy.code, dy.sign, **kw)
    _same(dw, TK.mac_plain(x.code, x.sign, dy.code, dy.sign,
                           a_contract_axis=0, b_contract_axis=0, **kw))
    for s in (1, 2, 4, 5, 8):
        got = TK.lns_matmul_dw_partials(x.code, x.sign, dy.code, dy.sign,
                                        num_segments=s, **kw)
        _same(got, TK.mac_plain(x.code, x.sign, dy.code, dy.sign,
                                a_contract_axis=0, b_contract_axis=0,
                                segments=s, **kw))
        if s == 1:
            _same((got[0][0], got[1][0]), dw)
    with pytest.raises(ValueError, match="not divisible"):
        TK.lns_matmul_dw_partials(x.code, x.sign, dy.code, dy.sign,
                                  num_segments=3, **kw)
    torch.cuda.synchronize()


def _short_steps():
    """The steps a segment up to which the library runs the short form."""
    from repro_torch.kernels import build
    return build.load_library().lns_short_steps()


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_short_and_tiled_forms_equal_plain_on_card(cuda, kind, fmt_name):
    """Both forms of the ⊞-MAC, on each side of the threshold T (CT ∈
    {1, T, T + 1}), for C ∈ {1, 10, 33, 100} at a ragged R: the forward
    with each epilogue, the dX and the dW-update with and without
    momentum; then the segment partials at S ∈ {1, 5} for batches 5 and
    40."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(5)
    kw = dict(fmt=fmt, spec=spec)
    beta = T.beta_code(0.01, fmt)
    eps = [TK.FwdEpilogue(bias=True),
           TK.FwdEpilogue(bias=True, llrelu_beta=beta, emit_z_sign=True),
           TK.FwdEpilogue(bias=True, llrelu_beta=beta,
                          dst_fmt=OTHER[fmt_name], emit_z_sign=True)]
    ups = [T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**c), fmt) for c in (
        dict(lr=0.01, weight_decay=0.01),
        dict(lr=0.01, weight_decay=0.01, momentum=0.9))]
    r = 13
    for ct in (1, _short_steps(), _short_steps() + 1):
        for c in (1, 10, 33, 100):
            x = _operand(gen, (r, ct), fmt, cuda, zero_frac=0.4)
            w = _operand(gen, (ct, c), fmt, cuda, scale=0.05)
            b = _operand(gen, (c,), fmt, cuda, scale=0.1)
            fwd = dict(a_contract_axis=1, b_contract_axis=0, **kw)
            _same(TK.lns_matmul(x.code, x.sign, w.code, w.sign, **kw),
                  TK.mac_plain(x.code, x.sign, w.code, w.sign, **fwd))
            for ep in eps:
                _same(TK.lns_matmul_fused(x.code, x.sign, w.code, w.sign,
                                          epilogue=ep, bias_code=b.code,
                                          bias_sign=b.sign, **kw),
                      TK.mac_plain(x.code, x.sign, w.code, w.sign,
                                   fwd_epilogue=ep, bias_code=b.code,
                                   bias_sign=b.sign, **fwd))
            dy = _operand(gen, (r, ct), fmt, cuda, scale=0.1)
            wt = _operand(gen, (c, ct), fmt, cuda, scale=0.05)
            _same(TK.lns_matmul_dx(dy.code, dy.sign, wt.code, wt.sign, **kw),
                  TK.mac_plain(dy.code, dy.sign, wt.code, wt.sign,
                               a_contract_axis=1, b_contract_axis=1, **kw))
            xb = _operand(gen, (ct, r), fmt, cuda, zero_frac=0.5)
            db = _operand(gen, (ct, c), fmt, cuda, scale=0.1)
            wr = _operand(gen, (r, c), fmt, cuda, scale=0.05)
            mr = _operand(gen, (r, c), fmt, cuda, scale=0.01, zero_frac=0.3)
            for up in ups:
                mk = (dict(m_code=mr.code, m_sign=mr.sign)
                      if up.has_momentum else {})
                _same(TK.lns_matmul_dw_update(
                          xb.code, xb.sign, db.code, db.sign, epilogue=up,
                          w_code=wr.code, w_sign=wr.sign, **mk, **kw),
                      TK.mac_plain(xb.code, xb.sign, db.code, db.sign,
                                   a_contract_axis=0, b_contract_axis=0,
                                   update_epilogue=up, w_code=wr.code,
                                   w_sign=wr.sign, **mk, **kw))
    for batch in (5, 40):
        for c in (1, 33, 100):
            x = _operand(gen, (batch, r), fmt, cuda, zero_frac=0.5)
            dy = _operand(gen, (batch, c), fmt, cuda, scale=0.1)
            for s in (1, 5):
                _same(TK.lns_matmul_dw_partials(x.code, x.sign, dy.code,
                                                dy.sign, num_segments=s,
                                                **kw),
                      TK.mac_plain(x.code, x.sign, dy.code, dy.sign,
                                   a_contract_axis=0, b_contract_axis=0,
                                   segments=s, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_fused_update_sizes_on_card(cuda, kind, fmt_name):
    """The ⊞-SGD at n ∈ {1, 10, 100, 257, 1000, 78400}, with and without
    momentum, and on planes one element off the vector alignment."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(6)
    for cfg in (dict(lr=0.01, weight_decay=0.01),
                dict(lr=0.01, weight_decay=0.01, momentum=0.9)):
        up = T.UpdateEpilogue.from_sgd(T.LogSGDConfig(**cfg), fmt)
        for n in (1, 10, 100, 257, 1000, 78400):
            w, g = (_operand(gen, (n + 1,), fmt, cuda, scale=0.1)
                    for _ in range(2))
            m = _operand(gen, (n + 1,), fmt, cuda, scale=0.01, zero_frac=0.3)
            for lo in (0, 1):
                sl = slice(lo, lo + n)
                mk = (dict(m_code=m.code[sl], m_sign=m.sign[sl])
                      if up.has_momentum else {})
                uk = dict(epilogue=up, fmt=fmt, spec=spec, **mk)
                _same(TK.lns_fused_update(w.code[sl], w.sign[sl], g.code[sl],
                                          g.sign[sl], **uk),
                      TK.update_plain(w.code[sl], w.sign[sl], g.code[sl],
                                      g.sign[sl], **uk))
    torch.cuda.synchronize()


SWEEP_SPECS = {"lut20": T.DELTA_DEFAULT, "lut640": T.DELTA_SOFTMAX,
               "r0.375": T.DeltaSpec(kind="lut", d_max=9.0, r=0.375),
               "lut1024": T.DeltaSpec(kind="lut", d_max=16.0, r=1.0 / 64.0)}


def _sweep_operands(fmt, swap, device):
    """A (R, 2) and B (2, C) whose second ⊞ step meets every difference d
    from 0 to code_max − min_nz, with equal signs (columns c < W) and
    opposite signs (c ≥ W); ``swap`` folds the two products in the other
    order."""
    lo, hi, w = fmt.min_nonzero_code, fmt.code_max, 256
    rows = (hi - lo) // w + 1
    a_c = torch.full((rows, 2), lo, dtype=torch.int32)
    a_c[:, 0] = torch.clamp(lo + torch.arange(rows) * w, max=hi)
    b_c = torch.zeros((2, 2 * w), dtype=torch.int32)
    b_c[0] = torch.arange(2 * w) % w
    a_s = torch.zeros((rows, 2), dtype=torch.int8)
    b_s = torch.zeros((2, 2 * w), dtype=torch.int8)
    b_s[0, w:] = 1
    if swap:
        a_c, a_s, b_c, b_s = a_c.flip(1), a_s.flip(1), b_c.flip(0), b_s.flip(0)
    return [t.contiguous().to(device) for t in (a_c, a_s, b_c, b_s)]


@pytest.mark.parametrize("spec_name", list(SWEEP_SPECS))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_delta_index_sweep_on_card(cuda, spec_name, fmt_name):
    """The kernel's Δ index (a shift, or a multiply-high where the LUT
    step is not a power of two) over every difference of the format,
    through both forms: the two-step sweep takes the short form, and the
    same sweep after T + 1 zero-code steps (a zero accumulator takes the
    first product, so the codes do not change) the tiled form."""
    fmt, spec = T.FORMATS[fmt_name], SWEEP_SPECS[spec_name]
    kw = dict(fmt=fmt, spec=spec)
    for swap in (False, True):
        a_c, a_s, b_c, b_s = _sweep_operands(fmt, swap, cuda)
        short = TK.lns_matmul(a_c, a_s, b_c, b_s, **kw)
        _same(short, TK.mac_plain(a_c, a_s, b_c, b_s, a_contract_axis=1,
                                  b_contract_axis=0, **kw))
        pad = _short_steps() + 1
        a_c = torch.cat([torch.full((a_c.shape[0], pad), fmt.zero_code,
                                    dtype=torch.int32, device=cuda), a_c], 1)
        a_s = torch.cat([a_s.new_zeros((a_s.shape[0], pad)), a_s], 1)
        b_c = torch.cat([b_c.new_zeros((pad, b_c.shape[1])), b_c])
        b_s = torch.cat([b_s.new_zeros((pad, b_s.shape[1])), b_s])
        tiled = TK.lns_matmul(a_c, a_s, b_c, b_s, **kw)
        _same(tiled, TK.mac_plain(a_c, a_s, b_c, b_s, a_contract_axis=1,
                                  b_contract_axis=0, **kw))
        _same(tiled, short)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_boxsum_kernel_equals_plain_on_card(cuda, kind, fmt_name):
    """The ⊞-reduce over K ∈ {1, 5, 37, 128}, dense and through the
    transposed view the combine reads, with exact cancellations."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(3)
    for k in (1, 5, 37, 128):
        a = _operand(gen, (k, 301), fmt, cuda)
        if k > 1:
            a.code[1, ::2] = a.code[0, ::2]
            a.sign[1, ::2] = a.sign[0, ::2] ^ 1
        kw = dict(fmt=fmt, spec=spec)
        for code, sign in ((a.code.T, a.sign.T),
                           (a.code.T.contiguous(), a.sign.T.contiguous())):
            _same(lns_boxsum(code, sign, **kw), boxsum_plain(code, sign,
                                                             **kw))
    torch.cuda.synchronize()


#: (steps, rows) of the row sets of a grouped ⊞-reduce launch: the
#: rows of 2, 4 and 8 sets end inside a block of the kernel.
MANY_SETS = ((5, 301), (1, 37), (13, 100), (128, 9), (2, 1000), (12, 3),
             (37, 64), (5, 10))


def _zero_and_cancel(a, fmt):
    """Row 1 all zero codes; step 1 cancels step 0 exactly on every other
    row from row 2."""
    a.code[:, 1] = fmt.zero_code
    a.sign[:, 1] = 0
    if a.code.shape[0] > 1:
        a.code[1, 2::2] = a.code[0, 2::2]
        a.sign[1, 2::2] = a.sign[0, 2::2] ^ 1
    return a


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_boxsum_many_kernel_equals_plain_on_card(cuda, kind, fmt_name):
    """The grouped ⊞-reduce over 1, 2, 4 and 8 row sets of steps 1, 2, 5,
    12, 13, 37 and 128, read as the combine reads (S, E) partials and
    dense, with an all-zero row and exact cancellations in every set, in
    one launch each; 9 sets take two launches."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(7)
    parts = [_zero_and_cancel(_operand(gen, shape, fmt, cuda), fmt)
             for shape in MANY_SETS]
    kw = dict(fmt=fmt, spec=spec)
    for n in (1, 2, 4, 8):
        for dense in (False, True):
            sets = [(a.code.T, a.sign.T) for a in parts[:n]]
            if dense:
                sets = [(c.contiguous(), sg.contiguous()) for c, sg in sets]
            TKS.reset_launch_counts()
            got = lns_boxsum_many(sets, **kw)
            assert TKS.launch_counts()["lns_boxsum"] == 1
            for g, (c, sg) in zip(got, sets):
                _same(g, boxsum_plain(c, sg, **kw))
    sets = [(a.code.T, a.sign.T) for a in parts] + [(parts[0].code.T,
                                                     parts[0].sign.T)]
    TKS.reset_launch_counts()
    got = lns_boxsum_many(sets, **kw)
    assert TKS.launch_counts()["lns_boxsum"] == 2
    for g, (c, sg) in zip(got, sets):
        _same(g, boxsum_plain(c, sg, **kw))
    torch.cuda.synchronize()


BOXSUM_SWEEP_SPECS = dict(SWEEP_SPECS, bitshift=T.DELTA_BITSHIFT,
                          exact=T.DELTA_EXACT)


@pytest.mark.parametrize("spec_name", list(BOXSUM_SWEEP_SPECS))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_boxsum_delta_index_sweep_on_card(cuda, spec_name, fmt_name):
    """The ⊞-reduce's Δ index over every difference of the format: rows
    of two steps (min_nz + d, min_nz) with equal and with opposite signs,
    in both orders, then the same rows after 13 zero-code steps (past the
    kernel's first chunk of loads)."""
    fmt, spec = T.FORMATS[fmt_name], BOXSUM_SWEEP_SPECS[spec_name]
    lo, hi = fmt.min_nonzero_code, fmt.code_max
    d = torch.arange(0, hi - lo + 1, dtype=torch.int32)
    code = torch.stack([lo + d, torch.full_like(d, lo)], 1).repeat(2, 1)
    sign = torch.zeros_like(code, dtype=torch.int8)
    sign[len(d):, 1] = 1
    kw = dict(fmt=fmt, spec=spec)
    for swap in (False, True):
        c, sg = (code.flip(1), sign.flip(1)) if swap else (code, sign)
        c, sg = c.contiguous().to(cuda), sg.contiguous().to(cuda)
        _same(lns_boxsum(c, sg, **kw), boxsum_plain(c, sg, **kw))
        c = torch.cat([torch.full((c.shape[0], 13), fmt.zero_code,
                                  dtype=torch.int32, device=cuda), c], 1)
        sg = torch.cat([sg.new_zeros((sg.shape[0], 13)), sg], 1)
        _same(lns_boxsum(c, sg, **kw), boxsum_plain(c, sg, **kw))
    torch.cuda.synchronize()


def test_boxsum_launcher_rejects_set_counts(cuda):
    """The launcher takes 1 to 8 row sets and refuses 0 and 9 with
    cudaErrorInvalidValue; the wrapper refuses them before it."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels._common import lns_args
    from repro_torch.kernels.lns_boxsum import boxsum_many_cuda
    lib = build.load_library()
    assert lib.lns_boxsum_max_sets() == build.BOXSUM_MAX_SETS == 8
    a = _operand(torch.Generator().manual_seed(8), (5, 10), T.LNS16, cuda)
    kw = dict(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    for n in (0, 9):
        p = build.BoxsumParams(lns=lns_args(T.LNS16, T.DELTA_DEFAULT, cuda),
                               n_sets=n)
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.lns_boxsum_launch(ctypes.byref(p),
                                     ctypes.c_void_p(stream)) == 1
        with pytest.raises(ValueError, match="1 to 8 row sets"):
            boxsum_many_cuda([(a.code.T, a.sign.T)] * n, **kw)
    torch.cuda.synchronize()


SEGMENTED_LAUNCHES = dict(lns_matmul_fused=40, lns_matmul_dx=20,
                          lns_matmul_dw_partials=40, lns_fused_update=80)
PATHS = {
    "unfused": (dict(spec="lns16-train-pallas", fused=False),
                dict(lns_matmul=40, lns_matmul_dx=20, lns_matmul_dw=40)),
    # One grouped ⊞-reduce a step combines w1, b1, w2 and b2 ...
    "segmented": (dict(spec="lns16-train-pallas,reduce.grad_segments=5"),
                  dict(SEGMENTED_LAUNCHES, lns_boxsum=20)),
    # ... and one per layer where the layers' formats differ.
    "segmented-mixed-plan": (
        dict(spec="lns16-train-pallas,reduce.grad_segments=5;"
                  "hidden=fmt:lns12"),
        dict(SEGMENTED_LAUNCHES, lns_boxsum=40)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_unfused_and_segmented_steps_card_equal_cpu(cuda, path):
    """20 full-width steps of the unfused and the segmented step on the
    card equal the CPU lane, with the kernel launches each path makes."""
    kw, launches = PATHS[path]
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    models = {d: make_mlp("lns", MLPConfig(momentum=0.9, weight_decay=0.01,
                                           **kw), device=d)
              for d in ("cuda", "cpu")}
    params = {d: m.init(torch.Generator().manual_seed(4))
              for d, m in models.items()}
    moms = {d: m.init_momentum(params[d]) for d, m in models.items()}
    TKS.reset_launch_counts()
    for step in range(20):
        sl = slice(step * 5, (step + 1) * 5)
        for d, m in models.items():
            params[d], moms[d], _ = m.train_step(params[d], x[sl], y[sl],
                                                 moms[d])
        for k, (g, w) in enumerate(zip(
                params_to_numpy(params["cuda"]).values(),
                params_to_numpy(params["cpu"]).values())):
            np.testing.assert_array_equal(g[0], w[0], err_msg=f"{k}@{step}")
            np.testing.assert_array_equal(g[1], w[1], err_msg=f"{k}@{step}")
    assert TKS.launch_counts() == dict(
        dict.fromkeys(TKS.KERNEL_WRAPPERS, 0), **launches)


def test_invariance_check_on_card(cuda):
    """The invariance check's default lane: one NCCL rank per card, in a
    process of its own, holds its weight and momentum codes to
    ``reference_train_step`` on the card."""
    from repro_torch.distributed import run_device_count_invariance_check
    ok, runs = run_device_count_invariance_check(
        (1,), momentum=0.9, timeout=300)
    assert ok and runs[1]["matches_reference"] and runs[1]["replicas_agree"]


# ------------------------------------------------- the Table 1 baselines --

def test_tf32_is_off(cuda):
    """The float baseline is float32 on the card: no TF32 in its products."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("sr", [False, True], ids=["nearest", "sr"])
@pytest.mark.parametrize("bits", [16, 12])
def test_fxp_steps_card_equal_cpu(cuda, bits, sr):
    """20 full-width fixed-point steps of batch 5 on the card, the decay
    after step 16: int32 codes equal to the CPU lane after every step, the
    rounding bits drawn from the same CPU generator."""
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    cfg = MLPConfig(bits=bits, stochastic_round=sr, weight_decay=0.3)
    models = {d: make_mlp("fxp", cfg, device=d) for d in ("cuda", "cpu")}
    params = {d: m.init(torch.Generator().manual_seed(4))
              for d, m in models.items()}
    for step in range(20):
        sl = slice(step * 5, (step + 1) * 5)
        for d, m in models.items():
            gen = torch.Generator().manual_seed(step) if sr else None
            params[d], _ = m.train_step(params[d], x[sl], y[sl], gen)
            if (step + 1) % 16 == 0:
                params[d] = m.apply_decay(params[d], 16)
        got, want = (params_to_numpy(params[d]) for d in ("cuda", "cpu"))
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k}@{step}")
    xv = x[1000:1500]
    assert torch.equal(models["cuda"].predict(params["cuda"], xv).cpu(),
                       models["cpu"].predict(params["cpu"], xv))


def test_float_steps_card_match_cpu(cuda):
    """20 full-width float32 steps on the card within rtol 1e-5, atol 1e-6
    of the CPU lane (float sums in another order)."""
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    cfg = MLPConfig(weight_decay=0.01)
    models = {d: make_mlp("float", cfg, device=d) for d in ("cuda", "cpu")}
    params = {d: m.init(torch.Generator().manual_seed(4))
              for d, m in models.items()}
    for step in range(20):
        sl = slice(step * 5, (step + 1) * 5)
        for d, m in models.items():
            params[d], _ = m.train_step(params[d], x[sl], y[sl])
    got, want = (params_to_numpy(params[d]) for d in ("cuda", "cpu"))
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------ telemetry, faults and guardrails --

FAULTS = ("seed=3,start=2,stop=4;hidden=flip_w:0.01,flip_act:0.01,"
          "sat_lanes:2;out=lut:3")
OBS_PATHS = {
    "fused": dict(spec="lns16-train-pallas"),
    "unfused": dict(spec="lns16-train-pallas", fused=False),
    "segmented": dict(spec="lns16-train-pallas,reduce.grad_segments=5"),
    "fused-full": dict(spec="lns16-train-pallas;hidden=fmt:lns12,"
                            "metrics:full"),
}


def _pair(kw, faults=None):
    """The model of ``kw`` on the card and on the CPU, from the same
    weights."""
    models = {d: make_mlp("lns", MLPConfig(momentum=0.9, weight_decay=0.01,
                                           faults=faults, **kw), device=d)
              for d in ("cuda", "cpu")}
    init = params_to_numpy(models["cpu"].init(
        torch.Generator().manual_seed(4)))
    from repro_torch.paper import params_from_numpy
    params = {d: params_from_numpy(init, d) for d in models}
    moms = {d: m.init_momentum(params[d]) for d, m in models.items()}
    return models, params, moms


def _codes_equal(a, b, msg):
    for k, (g, w) in zip(a, zip(params_to_numpy(a).values(),
                                params_to_numpy(b).values())):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"{k} {msg}")
        np.testing.assert_array_equal(g[1], w[1], err_msg=f"{k} {msg}")


@pytest.mark.parametrize("path", list(OBS_PATHS))
def test_metrics_steps_card_equal_cpu(cuda, path):
    """``train_step_metrics`` on the card: the card's ``train_step`` codes,
    the CPU lane's codes and taps, the kernels of the path launched."""
    from repro_torch.obs import host_taps
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    models, params, moms = _pair(OBS_PATHS[path])
    plain, plain_m = params["cuda"], moms["cuda"]
    for step in range(3):
        sl = slice(step * 5, (step + 1) * 5)
        taps = {}
        for d, m in models.items():
            TKS.reset_launch_counts()
            (params[d], moms[d], _), t = m.train_step_metrics(
                params[d], x[sl], y[sl], moms[d])
            taps[d] = host_taps(t)
            if d == "cuda":
                assert TKS.launch_counts()["lns_matmul_dx"] == 1
        plain, plain_m, _ = models["cuda"].train_step(plain, x[sl], y[sl],
                                                      plain_m)
        _codes_equal(params["cuda"], plain, f"vs train_step @{step}")
        _codes_equal(params["cuda"], params["cpu"], f"vs cpu @{step}")
        _codes_equal(moms["cuda"], moms["cpu"], f"momentum @{step}")
        assert sorted(taps["cuda"]) == sorted(taps["cpu"])
        for k, v in taps["cpu"].items():
            np.testing.assert_array_equal(taps["cuda"][k], v, err_msg=k)


@pytest.mark.parametrize("path", ["fused", "unfused", "segmented"])
def test_faulted_steps_card_equal_cpu(cuda, path):
    """``train_step_faults`` on the card draws the CPU lane's faults: the
    codes are equal after every step, the step an int or a card tensor."""
    faults = FAULTS + (";hidden=drop_seg:1;out=dup_seg:2"
                       if path == "segmented" else "")
    x, y, _, _, _ = datasets.load("mnist", "data", 0)
    models, params, moms = _pair(OBS_PATHS[path], faults)
    for step in range(6):
        sl = slice(step * 5, (step + 1) * 5)
        for d, m in models.items():
            s = torch.tensor(step, device=d) if step % 2 else step
            params[d], moms[d], _ = m.train_step_faults(
                params[d], x[sl], y[sl], s, moms[d])
        _codes_equal(params["cuda"], params["cpu"], f"@{step}")
        _codes_equal(moms["cuda"], moms["cpu"], f"momentum @{step}")


def test_threefry_on_card_equals_cpu(cuda):
    from repro_torch.resil import prng
    for seed in (0, 3, 42):
        key = {d: prng.fold_in(prng.prng_key(seed),
                               torch.tensor(7, dtype=torch.int32, device=d))
               for d in ("cuda", "cpu")}
        for shape in ((784, 100), (5, 100), (7, 13, 3)):
            u = {d: prng.uniform(k, shape) for d, k in key.items()}
            assert u["cuda"].is_cuda
            assert torch.equal(u["cuda"].cpu(), u["cpu"])
            for span in (1, 7, 16):
                r = {d: prng.randint(k, shape, 0, span)
                     for d, k in key.items()}
                assert torch.equal(r["cuda"].cpu(), r["cpu"])


def test_drills_card_equal_cpu(cuda):
    """The three drills on the card give the CPU lane's rows but for
    ``lane``, launching the kernels of their steps."""
    from repro_torch.launch.drill import run_scenarios
    TKS.reset_launch_counts()
    card = run_scenarios(device="cuda")
    counts = TKS.launch_counts()
    cpu = run_scenarios(device="cpu")
    for c, h in zip(card, cpu):
        assert (c.pop("lane"), h.pop("lane")) == ("cuda", "cpu")
        assert c == h
    assert counts["lns_matmul_dw_update"] and counts["lns_boxsum"]


def test_lut_fault_tables_on_card(cuda):
    """A corrupted engine's tables on the card are its own; the shared
    engine's stay clean."""
    from repro_torch.core.delta import cached_engine
    m = make_mlp("lns", MLPConfig(faults="seed=3;hidden=lut:3"), "cuda")
    shared = cached_engine(T.DELTA_DEFAULT, T.LNS16)
    got = m.engs["hidden"].tables("cuda")[0].cpu()
    assert torch.equal(got, torch.from_numpy(m.engs["hidden"]._tab_plus))
    assert torch.equal(shared.tables("cuda")[0].cpu(),
                       torch.from_numpy(shared._tab_plus))
    assert not torch.equal(got, shared.tables("cuda")[0].cpu())


# ------------------------------------------------ the LM training path --
# (row, a shape, b shape, a / b contracted axis, format): rows 5, 2 and 6
# at LM shapes (chip_smoke.py phase 9a).
LM_CASES = {
    "fwd-64x2048x200": ("lns_matmul", (64, 2048), (2048, 200), 1, 0,
                        "lns16"),
    "dx-over-8192": ("lns_matmul_dx", (16, 8192), (96, 8192), 1, 1,
                     "lns16"),
    "dx-over-50432": ("lns_matmul_dx", (4, 50432), (8, 50432), 1, 1,
                      "lns16"),
    "dw-256-tokens-2048x160": ("lns_matmul_dw", (256, 2048), (256, 160), 0,
                               0, "lns16"),
    "ragged-fwd": ("lns_matmul", (37, 203), (203, 45), 1, 0, "lns16"),
    "ragged-dx": ("lns_matmul_dx", (37, 45), (203, 45), 1, 1, "lns12"),
    "ragged-dw": ("lns_matmul_dw", (61, 203), (61, 45), 0, 0, "lns12"),
}
# Every distinct product of phase 9c's full-width olmo-1b step (256
# tokens; d_model 2048, d_ff 8192, vocab 50 432) as (row, R, C, CT): the
# forward (R, C) = (tokens, N) over K, dX (tokens, K) over N, dW (K, N)
# over the tokens.
for _row, _r, _c, _ct in (
        ("lns_matmul", 256, 2048, 2048), ("lns_matmul_dx", 256, 2048, 2048),
        ("lns_matmul_dw", 2048, 2048, 256), ("lns_matmul", 256, 8192, 2048),
        ("lns_matmul_dx", 256, 2048, 8192), ("lns_matmul_dw", 2048, 8192, 256),
        ("lns_matmul", 256, 2048, 8192), ("lns_matmul_dx", 256, 8192, 2048),
        ("lns_matmul_dw", 8192, 2048, 256), ("lns_matmul", 256, 50432, 2048),
        ("lns_matmul_dx", 256, 2048, 50432),
        ("lns_matmul_dw", 2048, 50432, 256)):
    _dw, _dx = _row == "lns_matmul_dw", _row == "lns_matmul_dx"
    LM_CASES[f"9c-{_row}-{_r}x{_c}-over-{_ct}"] = (
        _row, (_ct, _r) if _dw else (_r, _ct), (_c, _ct) if _dx else (_ct, _c),
        0 if _dw else 1, 1 if _dx else 0, "lns16")


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_shapes_equal_plain_on_card(cuda, case):
    row, ashape, bshape, aa, ba, fmt_name = LM_CASES[case]
    fmt = T.FORMATS[fmt_name]
    gen = torch.Generator().manual_seed(len(case))
    a = _operand(gen, ashape, fmt, cuda)
    b = _operand(gen, bshape, fmt, cuda, scale=0.05, zero_frac=0.05)
    kw = dict(fmt=fmt, spec=T.DELTA_DEFAULT)
    _same(getattr(TK, row)(a.code, a.sign, b.code, b.sign, **kw),
          TK.mac_plain(a.code, a.sign, b.code, b.sign, a_contract_axis=aa,
                       b_contract_axis=ba, **kw))


@pytest.mark.parametrize("c", [8, 40])
@pytest.mark.parametrize("row", ["lns_matmul", "lns_matmul_dx"])
def test_tiled_mac_past_65535_row_tiles_on_card(cuda, row, c):
    """The tiled ⊞-MAC over 262 149 output rows, past the 65535 row tiles
    of 4 that grid y once held: one launch, bit for bit against the plain
    version, for the forward and the dX (W through strides), over one
    column tile and over two (grid x's row and column tiles are the block
    index's quotient and remainder)."""
    r, ct = 262149, 40
    gen = torch.Generator().manual_seed(262149)
    a = _operand(gen, (r, ct), T.LNS16, cuda)
    b = _operand(gen, (c, ct) if row == "lns_matmul_dx" else (ct, c),
                 T.LNS16, cuda, scale=0.05, zero_frac=0.05)
    kw = dict(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    TKS.reset_launch_counts()
    got = getattr(TK, row)(a.code, a.sign, b.code, b.sign, **kw)
    assert TKS.launch_counts()[row] == 1
    _same(got, TK.mac_plain(a.code, a.sign, b.code, b.sign,
                            a_contract_axis=1,
                            b_contract_axis=int(row == "lns_matmul_dx"),
                            **kw))


@pytest.mark.parametrize("tied", [False, True])
def test_trainable_on_card_equals_cpu(cuda, tied):
    """``lns_matmul_trainable``'s forward and both gradients on the card
    equal the CPU lane's (codes and signs; the decoded floats within one
    ulp), one launch of rows 5, 2 and 6 each; a tied head's transposed
    view as the weight."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 9, 40, generator=gen)
    w = torch.randn(50, 40, generator=gen) * 0.1
    g = torch.randn(2, 9, 50, generator=gen) * 0.01
    out = {}
    for dev in ("cpu", cuda):
        xt = x.to(dev).detach().requires_grad_()
        wt = w.to(dev).detach().requires_grad_()
        TKS.reset_launch_counts()
        z = TK.lns_matmul_trainable(xt, wt.T if tied else wt.T.contiguous(),
                                    numerics="lns16-train-pallas")
        z.backward(g.to(dev))
        out[str(dev)] = (z.detach().cpu(), xt.grad.cpu(), wt.grad.cpu(),
                         TKS.launch_counts())
    card, cpu = out[str(cuda)], out["cpu"]
    for c, h in zip(card[:3], cpu[:3]):
        np.testing.assert_array_max_ulp(c.numpy(), h.numpy(), maxulp=1)
        assert torch.equal(T.encode(c, T.LNS16).code,
                           T.encode(h, T.LNS16).code)
    assert {k: v for k, v in card[3].items() if v} == dict(
        lns_matmul=1, lns_matmul_dx=1, lns_matmul_dw=1)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-1.7b"])
def test_lm_train_steps_on_card_equal_cpu(cuda, arch):
    """Three AdamW steps of a ``reduced()`` dense config under
    ``lns16-train-pallas``: each row launched once per LNS linear and CE
    chunk a step (remat off).  Teacher-forced: each card step starts from
    the CPU lane's state before it (float ops on the two devices round
    differently, so free-running lanes part after the first update);
    the first step's loss within rtol 1e-3 of the CPU lane's, every
    step's within 1e-2 (a later step's gap reads up to 1.26e-3, ROADMAP
    queue 3 item 7), its parameter update within a relative L2 distance
    of 0.5 over the tree (``chip_smoke.py`` phase 9b)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.nn import init_params
    from repro_torch.nn.config import ShapeCell
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    cfg = reduced(get_config(arch)).with_(numerics="lns16-train-pallas",
                                          remat="none")
    ds = SyntheticLMDataset(cfg, ShapeCell("t", 32, 2, "train"),
                            DataConfig())
    from repro_torch.pytree import tree_leaves, tree_map
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, opt, tc=TrainConfig(grad_clip=1.0))
    states = [init_train_state(init_params(0, cfg, device="cpu"), opt)]
    cpu = []
    for i in range(3):
        state, m = step(states[-1], ds.batch_on(i, "cpu"))
        states.append(state)
        cpu.append(float(m["loss"]))
    TKS.reset_launch_counts()
    for i in range(3):
        card, m = step(tree_map(lambda t: t.to(cuda), states[i]),
                       ds.batch_on(i, cuda))
        loss = float(m["loss"])
        rtol = 1e-3 if i == 0 else 1e-2
        assert abs(loss - cpu[i]) <= rtol * abs(cpu[i]), (i, loss, cpu[i])
        num = den = 0.0
        for p0, p1, q1 in zip(tree_leaves(states[i]["params"]),
                              tree_leaves(states[i + 1]["params"]),
                              tree_leaves(card["params"])):
            u = p1.double() - p0.double()
            num += float(((q1.cpu().double() - p0.double() - u) ** 2).sum())
            den += float((u ** 2).sum())
        assert (num / den) ** 0.5 <= 0.5, i
    counts = {k: v for k, v in TKS.launch_counts().items() if v}
    assert counts == dict.fromkeys(
        ("lns_matmul", "lns_matmul_dx", "lns_matmul_dw"), 3 * 15)


def test_train_cli_on_card(cuda, tmp_path):
    """The train CLI on the card resumes from its checkpoint."""
    from repro_torch.launch import train as train_cli
    common = ["--arch", "qwen3-1.7b", "--ckpt-every", "2", "--numerics",
              "lns16-train-pallas", "--batch", "2", "--seq", "16",
              "--log-every", "100", "--ckpt-dir", str(tmp_path)]
    assert len(train_cli.main(["--steps", "2"] + common)) == 2
    assert len(train_cli.main(["--steps", "3"] + common)) == 1


def test_remat_block_on_card_changes_nothing(cuda):
    """Under ``remat="block"`` the forward runs twice: the deterministic
    kernels give the loss and gradients of ``remat="none"`` bit for bit,
    with one more forward launch per LNS linear."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.nn import init_params, loss_fn
    from repro_torch.nn.config import ShapeCell
    from repro_torch.pytree import tree_flatten, tree_unflatten
    cfg = reduced(get_config("qwen3-1.7b")).with_(
        numerics="lns16-train-pallas")
    params = init_params(3, cfg, device=cuda)
    b = SyntheticLMDataset(cfg, ShapeCell("t", 32, 2, "train"),
                           DataConfig()).batch_on(0, cuda)
    out = {}
    for remat in ("none", "block"):
        leaves, treedef = tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        TKS.reset_launch_counts()
        loss = loss_fn(tree_unflatten(treedef, live), b,
                       cfg.with_(remat=remat))
        grads = torch.autograd.grad(loss, live)
        out[remat] = (loss.detach(), grads, TKS.launch_counts())
    assert torch.equal(out["none"][0], out["block"][0])
    for a, c in zip(out["none"][1], out["block"][1]):
        assert torch.equal(a, c)
    # 2 layers × 7 linears are recomputed; the head is outside the blocks.
    assert out["block"][2]["lns_matmul"] == out["none"][2]["lns_matmul"] + 14
    assert out["block"][2]["lns_matmul_dx"] == out["none"][2]["lns_matmul_dx"]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_moe_mla_train_steps_on_card_equal_cpu(cuda, arch):
    """Three AdamW steps of a ``reduced()`` moe config under fp32, card
    against the CPU lane from the same parameters: every step's loss
    within rtol 1e-5; then one lns16-train step teacher-forced, its loss
    within 1e-3, rows 5, 2 and 6 launched once per LNS linear (the
    attention's, the dense MLP's, the shared experts') and CE chunk."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.nn import init_params
    from repro_torch.nn.config import ShapeCell
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.pytree import tree_map
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    opt = AdamWConfig(lr=1e-3)
    for numerics, steps, rtol in (("fp32", 3, 1e-5),
                                  ("lns16-train-pallas", 1, 1e-3)):
        cfg = reduced(get_config(arch)).with_(numerics=numerics,
                                              remat="none")
        ds = SyntheticLMDataset(cfg, ShapeCell("t", 32, 2, "train"),
                                DataConfig())
        step = make_train_step(cfg, opt, tc=TrainConfig(grad_clip=1.0))
        cpu = init_train_state(init_params(0, cfg, device="cpu"), opt)
        card = tree_map(lambda t: t.to(cuda), cpu)
        TKS.reset_launch_counts()
        for i in range(steps):
            cpu, mh = step(cpu, ds.batch_on(i, "cpu"))
            card, mc = step(card, ds.batch_on(i, cuda))
            h, c = float(mh["loss"]), float(mc["loss"])
            assert abs(c - h) <= rtol * abs(h), (numerics, i, c, h)
        counts = {k: v for k, v in TKS.launch_counts().items() if v}
        per = 1 + 7 * (cfg.moe.first_dense_layers + cfg.layers
                       - cfg.moe.first_dense_layers)
        assert counts == ({} if numerics == "fp32" else dict.fromkeys(
            ("lns_matmul", "lns_matmul_dx", "lns_matmul_dw"), per))


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_serving_engine_on_card_equals_reference_generate(cuda, arch):
    """The engine on the card under lns16-train-pallas (paged GQA; paged
    MLA + MoE): greedy outputs equal to the port's ``reference_generate``
    on the card, the same on a repeat, row 1 launched once per serving
    linear per decode step and prefill chunk."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.nn import init_params
    from repro_torch.serve import (ServeConfig, ServingEngine,
                                   reference_generate)
    cfg = reduced(get_config(arch)).with_(numerics="lns16-train-pallas",
                                          remat="none")
    params = init_params(1, cfg, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=n) for n in (3, 9, 17)]
    sc = ServeConfig(max_batch=2, max_len=32, block_size=4, prefill_chunk=5)
    outs = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, sc)
        TKS.reset_launch_counts()
        outs.append(eng.run(prompts, max_new=6))
        counts = {k: v for k, v in TKS.launch_counts().items() if v}
        eng.bm.check_conserved()
        st = eng.stats
        assert set(counts) == {"lns_matmul_fused"}
        assert counts["lns_matmul_fused"] % (st["decode_steps"]
                                             + st["prefill_chunks"]) == 0
    assert outs[0] == outs[1]
    assert outs[0] == [reference_generate(cfg, params, p, 6, max_len=32)
                       for p in prompts]


ROWS_SHAPES = ([(ct, r, c) for ct in (13, 45) for r in (1, 4, 5, 16, 37)
                for c in (1, 33, 100)]
               + [(784, r, c) for r in (1, 16, 37) for c in (1, 100)])


@pytest.mark.parametrize("kind", list(DELTA))
@pytest.mark.parametrize("fmt_name", ["lns16", "lns12"])
def test_tiled_rows_per_block_equal_plain_on_card(cuda, kind, fmt_name):
    """The tiled ⊞-MAC at 1, 2 and 8 rows a block (4 is held above) bit for
    bit against the plain version: the forward with and without the fused
    epilogue, the dX and the dW-update at CT ∈ {13, 45} for R ∈ {1, 4, 5,
    16, 37} and C ∈ {1, 33, 100}, and at CT = 784 for R ∈ {1, 16, 37} and
    C ∈ {1, 100}; the segment partials at CT = 20; a row count the
    launcher does not take is refused."""
    fmt, spec = T.FORMATS[fmt_name], DELTA[kind]
    gen = torch.Generator().manual_seed(7)
    kw = dict(fmt=fmt, spec=spec)
    ep = TK.FwdEpilogue(bias=True, llrelu_beta=T.beta_code(0.01, fmt),
                        dst_fmt=OTHER[fmt_name], emit_z_sign=True)
    up = T.UpdateEpilogue.from_sgd(
        T.LogSGDConfig(lr=0.01, weight_decay=0.01, momentum=0.9), fmt)
    for ct, r, c in ROWS_SHAPES:
        x = _operand(gen, (r, ct), fmt, cuda, zero_frac=0.4)
        w = _operand(gen, (ct, c), fmt, cuda, scale=0.05)
        b = _operand(gen, (c,), fmt, cuda, scale=0.1)
        wt = _operand(gen, (c, ct), fmt, cuda, scale=0.05)
        xb = _operand(gen, (ct, r), fmt, cuda, zero_frac=0.5)
        db = _operand(gen, (ct, c), fmt, cuda, scale=0.1)
        wr = _operand(gen, (r, c), fmt, cuda, scale=0.05)
        mr = _operand(gen, (r, c), fmt, cuda, scale=0.01)
        uk = dict(w_code=wr.code, w_sign=wr.sign, m_code=mr.code,
                  m_sign=mr.sign)
        fwd = dict(a_contract_axis=1, b_contract_axis=0, **kw)
        launches = {
            "fwd": (lambda br: TK.lns_matmul(x.code, x.sign, w.code, w.sign,
                                             block_rows=br, **kw),
                    TK.mac_plain(x.code, x.sign, w.code, w.sign, **fwd)),
            "fused": (lambda br: TK.lns_matmul_fused(
                          x.code, x.sign, w.code, w.sign, epilogue=ep,
                          bias_code=b.code, bias_sign=b.sign, block_rows=br,
                          **kw),
                      TK.mac_plain(x.code, x.sign, w.code, w.sign,
                                   fwd_epilogue=ep, bias_code=b.code,
                                   bias_sign=b.sign, **fwd)),
            "dx": (lambda br: TK.lns_matmul_dx(x.code, x.sign, wt.code,
                                               wt.sign, block_rows=br, **kw),
                   TK.mac_plain(x.code, x.sign, wt.code, wt.sign,
                                a_contract_axis=1, b_contract_axis=1, **kw)),
            "dw_update": (lambda br: TK.lns_matmul_dw_update(
                              xb.code, xb.sign, db.code, db.sign,
                              epilogue=up, block_rows=br, **uk, **kw),
                          TK.mac_plain(xb.code, xb.sign, db.code, db.sign,
                                       a_contract_axis=0, b_contract_axis=0,
                                       update_epilogue=up, **uk, **kw)),
        }
        for name, (kernel, want) in launches.items():
            for rows in (1, 2, 8):
                _same(kernel(rows), want)
    x = _operand(gen, (40, 37), fmt, cuda, zero_frac=0.5)
    dy = _operand(gen, (40, 33), fmt, cuda, scale=0.1)
    want = TK.mac_plain(x.code, x.sign, dy.code, dy.sign, a_contract_axis=0,
                        b_contract_axis=0, segments=2, **kw)
    for rows in (1, 2, 8):
        _same(TK.lns_matmul_dw_partials(x.code, x.sign, dy.code, dy.sign,
                                        num_segments=2, block_rows=rows,
                                        **kw), want)
    with pytest.raises(ValueError, match="block_rows"):
        TK.lns_matmul(x.code, x.sign, x.code.T.contiguous(),
                      x.sign.T.contiguous(), block_rows=3, **kw)
    torch.cuda.synchronize()


def test_tiled_launcher_refuses_other_rows(cuda):
    """The library refuses a rows-per-block value it has no kernel for
    (the wrapper's own check bypassed), and reads none in the short
    form."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels._common import lns_args, ptr
    lib = build.load_library()
    gen = torch.Generator().manual_seed(3)
    a = _operand(gen, (5, 40), T.LNS16, cuda)
    b = _operand(gen, (40, 7), T.LNS16, cuda)
    out_c = torch.empty((5, 7), dtype=torch.int32, device=cuda)
    out_s = torch.empty((5, 7), dtype=torch.int8, device=cuda)
    for ct, rows, ok in ((40, 3, False), (40, 16, False), (40, 0, False),
                         (40, 8, True), (12, 0, True)):
        p = build.MacParams(
            lns=lns_args(T.LNS16, T.DELTA_DEFAULT, cuda),
            a_code=ptr(a.code), a_sign=ptr(a.sign), a_sr=40, a_st=1,
            b_code=ptr(b.code), b_sign=ptr(b.sign), b_st=7, b_sc=1,
            R=5, C=7, CT=ct, S=1, rows=rows, epilogue=0,
            out_code=ptr(out_c), out_sign=ptr(out_s))
        rc = lib.lns_mac_launch(
            ctypes.byref(p),
            ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream))
        assert (rc == 0) == ok, (ct, rows, rc)
    torch.cuda.synchronize()


def test_autotune_lookup_on_card(cuda, tmp_path, monkeypatch):
    """A card lookup times all four rows per block of a tiled forward by
    CUDA events, persists the fastest, serves the second lookup from the
    cache, and measures nothing for a short-form op; its copies of the
    library's constants agree."""
    from repro_torch.kernels import autotune, build
    lib = build.load_library()
    assert lib.lns_short_steps() == autotune.SHORT_STEPS
    assert lib.lns_max_table() == autotune.MAX_TABLE
    monkeypatch.setenv("LNS_AUTOTUNE_DIR", str(tmp_path))
    monkeypatch.delenv("LNS_AUTOTUNE_DISABLE", raising=False)
    autotune.clear_caches()
    kw = dict(fmt=T.LNS16, spec=T.DELTA_DEFAULT)
    shape = (5, 100, 784)
    best, results = autotune.tune("fwd", shape, **kw, reps=2)
    assert set(results) == {(w, 32, 32) for w in (1, 2, 4, 8)}
    assert all(ms > 0 for ms in results.values())
    got = autotune.lookup("fwd", shape, **kw)
    assert got in results
    entry, = autotune._load_disk().values()
    assert entry["blocks"] == list(got) and entry["ms"] > 0
    real = autotune.tune
    monkeypatch.setattr(autotune, "tune", lambda *a, **k: pytest.fail(
        "measured again"))
    assert autotune.lookup("fwd", shape, **kw) == got
    autotune.clear_caches()
    assert autotune.lookup("fwd", shape, **kw) == got
    assert autotune.lookup("dw", (784, 100, 5), **kw) == (1, 128, 5)
    monkeypatch.setattr(autotune, "tune", real)
    assert len(autotune._load_disk()) == 1
    autotune.clear_caches()


def test_mesh_of_two_ranks_on_one_card_raises(cuda):
    """A mesh never puts two ranks on one card (nor falls back to gloo)."""
    import subprocess
    import sys
    if torch.cuda.device_count() >= 2:
        pytest.skip("the host has two cards")
    code = ("from repro_torch.launch.mesh import make_mesh\n"
            "make_mesh((2,), ('data',), 'cuda')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "never puts two ranks on one card" in proc.stderr


def test_one_rank_mesh_steps_equal_no_mesh_on_card(cuda):
    """Phase 13b at the reduced width: 3 AdamW steps of olmo-1b under
    lns16-train-pallas through a (1, 1) NCCL mesh give the no-mesh steps'
    losses and parameters bit for bit."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.distributed.sharding import batch_specs, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import Runtime, init_params
    from repro_torch.nn.config import ShapeCell
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.pytree import tree_leaves
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_specs)
    cfg = reduced(get_config("olmo-1b")).with_(
        numerics="lns16-train-pallas", remat="none")
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0)
    ds = SyntheticLMDataset(cfg, ShapeCell("s", 32, 2, "train"),
                            DataConfig(seed=0))
    started = not dist.is_initialized()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    try:
        out = []
        for m in (None, mesh):
            state = init_train_state(init_params(0, cfg, device=cuda), opt,
                                     tc)
            if m is not None:
                state = shard_tree(state, train_state_specs(state), m)
            step = make_train_step(cfg, opt, Runtime(mesh=m), tc)
            losses = []
            for i in range(3):
                b = ds.batch_on(i, cuda)
                if m is not None:
                    b = shard_tree(b, batch_specs(b), m)
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
            out.append((losses, tree_leaves(state["params"])))
        assert out[0][0] == out[1][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    finally:
        if started:
            dist.destroy_process_group()
