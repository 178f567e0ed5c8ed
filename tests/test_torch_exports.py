"""Public functions of the JAX package's ``core`` and ``distributed``
exports that the port also exports: ``from_parts``, ``quantization_bound``,
``llrelu_grad`` and ``make_data_mesh``, each held against the reference
on the CPU, from inputs made with numpy from a seed."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

import repro.core as jcore
import repro.distributed as jdist
import repro_torch.core as tcore
import repro_torch.distributed as tdist

torch.set_num_threads(1)


def _planes(seed, shape=(7, 5)):
    rng = np.random.default_rng(seed)
    code = rng.integers(-40000, 30000, size=shape).astype(np.int32)
    sign = rng.integers(0, 2, size=shape).astype(np.int8)
    return code, sign


def test_exported_like_the_reference():
    for name in ("from_parts", "quantization_bound", "llrelu_grad"):
        assert name in jcore.__all__ and callable(getattr(tcore, name))
    assert "make_data_mesh" in jdist.__all__
    assert "make_data_mesh" in tdist.__all__


@pytest.mark.parametrize("as_tensor", [False, True])
def test_from_parts_equals_reference(as_tensor):
    code, sign = _planes(0)
    want = jcore.from_parts(code, sign)
    args = (torch.from_numpy(code.astype(np.int64)),
            torch.from_numpy(sign.astype(np.int32))) if as_tensor \
        else (code.tolist(), sign.tolist())
    got = tcore.from_parts(*args)
    assert got.code.dtype == torch.int32 and got.sign.dtype == torch.int8
    assert np.array_equal(got.code.numpy(), np.asarray(want.code))
    assert np.array_equal(got.sign.numpy(), np.asarray(want.sign))


@pytest.mark.parametrize("fmt", ["lns12", "lns16", "lns21"])
def test_quantization_bound_equals_reference(fmt):
    want = jcore.quantization_bound(jcore.FORMATS[fmt])
    got = tcore.quantization_bound(tcore.FORMATS[fmt])
    assert isinstance(got, float) and got == want
    # It bounds the port's own encode/decode round trip.
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.uniform(0.01, 4.0, 4096).astype(np.float32))
    f = tcore.FORMATS[fmt]
    err = ((tcore.decode(tcore.encode(v, f), f) - v).abs() / v).max()
    assert err.item() <= got * (1 + 1e-5)


@pytest.mark.parametrize("alpha", [0.01, 0.25])
def test_llrelu_grad_equals_reference(alpha):
    code, sign = _planes(2)
    jf, tf = jcore.LNS16, tcore.LNS16
    beta = jcore.beta_code(alpha, jf)
    assert tcore.beta_code(alpha, tf) == beta
    want = jcore.llrelu_grad(jcore.from_parts(code, sign), beta, jf)
    got = tcore.llrelu_grad(tcore.from_parts(code, sign), beta, tf)
    assert np.array_equal(got.code.numpy(), np.asarray(want.code))
    assert np.array_equal(got.sign.numpy(), np.asarray(want.sign))
    assert got.code.dtype == torch.int32 and got.sign.dtype == torch.int8


def test_make_data_mesh_raises_when_too_few_devices():
    """Both raise a ValueError naming the request when more devices are
    asked for than are attached (here: JAX's host devices, and the port's
    CPU ranks, one without a process group)."""
    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"data_parallel={n + 1}"):
        jdist.make_data_mesh(n + 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="data_parallel=2 .*only 1"):
        tdist.make_data_mesh(2, device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("axis", ["data", "dp"])
def test_make_data_mesh_one_axis_like_reference(axis):
    want = jdist.make_data_mesh(1, axis)
    assert not dist.is_initialized()
    try:
        got = tdist.make_data_mesh(1, axis, device="cpu")
        assert tuple(got.mesh_dim_names) == tuple(want.axis_names) == (axis,)
        assert got.size() == want.size == 1
        assert got.device_type == "cpu"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
