"""The MLP twins of ``examples/`` on the CPU lane: ``quickstart`` (its
ten sections; the training runs cut to 10 steps on a smaller synthetic
``mnist``, the plan search to 2 steps an evaluation) and
``train_data_parallel`` (gloo ranks), each through ``main(argv)`` and the
lines it prints.  The quickstart's bit-exact sections (LNS arithmetic,
the ⊞-MAC matmul and its kernel, the backward dX) print the JAX
package's numbers from the same arguments; ``--device cuda`` raises where
the cards are too few."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as jcore
from repro.kernels import lns_matmul_kernel as j_kernel
from repro_torch.examples import quickstart, train_data_parallel
from repro_torch.paper import datasets

torch.set_num_threads(1)


def _reference_lines():
    """§1-§3's numbers from the JAX package, formatted as the twin
    prints them."""
    fmt, eng = jcore.LNS16, jcore.DeltaEngine(jcore.DELTA_DEFAULT,
                                              jcore.LNS16)
    x = jcore.encode(np.float32(3.25), fmt)
    y = jcore.encode(np.float32(-1.5), fmt)
    dot = float(jcore.decode(jcore.boxdot(x, y, fmt), fmt))
    add = float(jcore.decode(jcore.boxplus(x, y, eng), fmt))
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 64)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    ab = a @ b
    z = np.asarray(jcore.decode(jcore.lns_matmul(
        jcore.encode(a, fmt), jcore.encode(b, fmt), eng), fmt))
    zk = np.asarray(jcore.decode(j_kernel(
        jcore.encode(a, fmt), jcore.encode(b, fmt), fmt=fmt,
        spec=jcore.DELTA_DEFAULT, block_m=8, block_n=8, block_k=16), fmt))
    spec = jcore.NumericsSpec.parse("lns16-train-pallas")
    dx = spec.with_(backend="emulate").runtime(8, 8, 16).matmul.matmul_dx(
        jcore.encode(jnp.ones((4, 3), jnp.float32), fmt),
        jcore.encode(b, fmt))
    rel = np.median(np.abs(z - ab) / np.abs(ab))
    relk = np.median(np.abs(zk - ab) / np.abs(ab))
    return [
        f"3.25    → code={int(x.code)} sign={int(x.sign)}",
        f"3.25 ⊡ -1.5 = {dot:.4f}  (exact: -4.875)",
        f"3.25 ⊞ -1.5 = {add:.4f}  (exact: 1.75)",
        f"emulated ⊞-MAC matmul median rel err vs float: {rel:.3f}",
        f"⊞-MAC kernel's plain version (sequential order) matches "
        f"emulation structurally; median rel err: {relk:.3f}",
        f"spec: {spec}",
        f"backward dX on emulate: first code = {int(dx.code[0, 0])}",
        f"backward dX on pallas : first code = {int(dx.code[0, 0])}",
    ]


def test_quickstart(monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "STEPS", 10)
    monkeypatch.setattr(quickstart, "SEARCH_STEPS", 2)
    monkeypatch.setitem(datasets.PRESETS, "mnist", dataclasses.replace(
        datasets.PRESETS["mnist"], n_train=600, n_test=100))
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    heads = [line for line in out if line.startswith("=== ")]
    assert [h.split(".")[0] for h in heads] == [f"=== {i}"
                                               for i in range(1, 11)]
    for line in _reference_lines():
        assert line in out, line
    text = "\n".join(out)
    for want in (
            "torch.autograd through the ⊞-MAC: gA.shape = (4, 64)",
            "LNS-16 LUT MLP, 10 steps: val acc ",
            "DP ⊞-allreduce schedule == single-device sequential "
            "baseline: True",
            "  hidden resolves to fmt=lns12, out to fmt=lns16",
            # the CPU lane's tuner answers the default, 4 rows a block
            "autotuned hidden-layer blocks: {'fwd': (4, ",
            "weight codes bit-identical: True",
            "blocks free again",
            "metrics-on == metrics-off weight codes: True",
            "winning plan — paste into python -m repro_torch.launch.train:",
            "recovery events: ['widen', 'rollback']"):
        assert want in text, want
    assert sum(": DONE prompt=" in line for line in out) == 3


def test_train_data_parallel(capsys):
    ok, ok_m, acc = train_data_parallel.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert ok and ok_m and 0.0 <= acc <= 1.0
    assert out[0] == "=== 1. Rank-count invariance (cpu ranks: gloo) ==="
    for line in (
            "boxplus reduce: 1/2/4-rank weight codes bit-identical to the "
            "sequential baseline: True",
            "mixed lns12/lns16 plan: 1/2/4-rank weight codes "
            "bit-identical: True"):
        assert line in out
    assert any(line.startswith("float-psum weights drift from the ⊞ "
                               "schedule by ≤ ") for line in out)
    assert out[-1].startswith(
        "run_experiment(..., data_parallel=2, numerics='lns16-train-"
        f"emulate,reduce.grad_segments=4'): val acc {acc:.3f} in ")


def test_too_few_cards_raise(monkeypatch):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        quickstart.main(["--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 NCCL ranks need as many "
                                           "cards; 1 present"):
        train_data_parallel.main(["--device", "cuda"])
