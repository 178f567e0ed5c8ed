"""Buffer donation in the port, against the port's own functional forms
(the JAX package's ``donate_argnums`` changes no result, so the reference
here is ``donate=False``, which the parity tests hold to the JAX package).

* ``make_train_step(..., donate=True)`` writes the new state into the
  tensors of the state it is given and returns them; two steps of it equal
  two functional steps bit for bit, in parameters, optimizer state,
  ``step``, ``residual`` and metrics, for every option of the step.  The
  in-place update runs a slice of a leaf at a time (``optimizers.CHUNK``);
  the reduced leaves are smaller than a slice, so the tests cut it to 96
  elements, and the slices' edges fall inside leaves.
* ``sgd_update_`` / ``adamw_update_`` equal ``sgd_update`` /
  ``adamw_update``, with and without the guard's ``keep``.
* A state with two leaves on one storage is refused.
* ``decode_step`` and ``decode_step_paged`` with ``donate=True`` equal the
  functional steps in logits and caches and return the input caches.
* A non-blocking checkpoint save, then a donated step: the checkpoint
  holds the saved step's values.
* The first remat step of a fresh process frees its gradients when it
  returns, with the cyclic collector off (``torch._dynamo`` is imported
  off the step's stack).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager, load_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.distributed.sharding import map_with_path
from repro_torch.nn import (decode_step, decode_step_paged,
                            init_decode_caches, init_paged_caches,
                            init_params)
from repro_torch.nn.config import ShapeCell
from repro_torch.optim import optimizers as O
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train import TrainConfig, init_train_state, make_train_step

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CELL = ShapeCell("t", seq_len=16, global_batch=2, kind="train")
STEPS = 2
SMALL_CHUNK = 96

STEP_CASES = {
    "sgd": ("olmo-1b", O.SGDConfig(lr=0.1, weight_decay=0.01),
            TrainConfig(), {}),
    "sgd-momentum": ("olmo-1b", O.SGDConfig(lr=0.1, momentum=0.9),
                     TrainConfig(grad_clip=1.0), {}),
    "adamw": ("olmo-1b", O.AdamWConfig(lr=1e-2), TrainConfig(grad_clip=1.0),
              {}),
    "adamw-bf16-moments": ("olmo-1b",
                           O.AdamWConfig(lr=1e-2, moment_dtype="bfloat16"),
                           TrainConfig(), {}),
    "bf16-params": ("olmo-1b", O.AdamWConfig(lr=1e-2),
                    TrainConfig(grad_clip=1.0),
                    {"param_dtype": "bfloat16"}),
    "nan-guard": ("internvl2-76b", O.AdamWConfig(lr=1e-2),
                  TrainConfig(grad_clip=1.0, nan_guard=True), {}),
    "compress-grads": ("olmo-1b", O.AdamWConfig(lr=1e-2),
                       TrainConfig(compress_grads=True, nan_guard=True), {}),
    "microbatches": ("deepseek-v2-lite-16b", O.AdamWConfig(lr=1e-2),
                     TrainConfig(microbatches=2, grad_clip=1.0), {}),
    "remat-block": ("zamba2-7b", O.AdamWConfig(lr=1e-2),
                    TrainConfig(grad_clip=1.0), {"remat": "block"}),
}


def _cfg(arch, **kw):
    return reduced(get_config(arch)).with_(numerics="fp32",
                                           remat="none").with_(**kw)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _bits_equal(a, b) -> bool:
    """Same dtype and bits (a NaN equals itself)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.element_size() == 2 else
        a.view(torch.int32) if a.element_size() == 4 else a,
        b.view(torch.int16) if b.element_size() == 2 else
        b.view(torch.int32) if b.element_size() == 4 else b)


@pytest.fixture
def small_chunk(monkeypatch):
    monkeypatch.setattr(O, "CHUNK", SMALL_CHUNK)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_donated_step_equals_functional(case, small_chunk):
    arch, opt, tc, kw = STEP_CASES[case]
    cfg = _cfg(arch, **kw)
    ds = SyntheticLMDataset(cfg, CELL, DataConfig(seed=0))
    fun = init_train_state(init_params(0, cfg, device="cpu"), opt, tc)
    don = _clone(fun)
    given = tree_leaves(don)
    f_step = make_train_step(cfg, opt, tc=tc)
    d_step = make_train_step(cfg, opt, tc=tc, donate=True)
    skipped = []
    for i in range(STEPS):
        batch = ds.batch_on(i, "cpu")
        if case == "nan-guard" and i == 1:        # a non-finite batch
            batch["frontend_embeds"][0, 0, 0] = float("nan")
        before = [t.data_ptr() for t in tree_leaves(don)]
        fun, fm = f_step(fun, batch)
        don, dm = d_step(don, batch)
        assert [t.data_ptr() for t in tree_leaves(don)] == before
        assert list(fm) == list(dm)
        assert all(_bits_equal(fm[k], dm[k]) for k in fm)
        assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(fun),
                                                     tree_leaves(don)))
        skipped.append(int(dm.get("update_skipped", 0)))
    assert all(a is b for a, b in zip(tree_leaves(don), given))
    assert int(don["step"]) == STEPS
    assert skipped == ([0, 1] if case == "nan-guard" else [0] * STEPS)


@pytest.mark.parametrize("kind,kw", [
    ("sgd", {"lr": 0.1, "weight_decay": 0.01}),
    ("sgd", {"lr": 0.1, "momentum": 0.9}),
    ("adamw", {"lr": 1e-2}),
    ("adamw", {"lr": 1e-2, "moment_dtype": "bfloat16"}),
], ids=["sgd", "sgd-momentum", "adamw", "adamw-bf16-moments"])
@pytest.mark.parametrize("guard", [False, True], ids=["", "keep"])
def test_inplace_updates_equal_functional(kind, kw, guard, small_chunk):
    cfg = (O.SGDConfig if kind == "sgd" else O.AdamWConfig)(**kw)
    init, update = O.make_optimizer(cfg)
    _, update_ = O.make_optimizer(cfg, inplace=True)
    rng = np.random.default_rng(3)

    def tree(dtype):
        return {"a": torch.from_numpy(rng.normal(size=(13, 17)).astype(
                    np.float32)).to(dtype),
                "b": [torch.from_numpy(rng.normal(size=(300,)).astype(
                    np.float32)).to(dtype)]}
    for dtype in (torch.float32, torch.bfloat16):
        params = tree(dtype)
        fp, fs = params, init(params)
        dp, ds = _clone(fp), _clone(fs)
        given = tree_leaves((dp, ds))
        for t in range(3):
            grads = tree(dtype)
            finite = torch.tensor(t != 1)
            fp2, fs2 = update(fp, grads, fs, torch.tensor(t))
            if guard:
                fp2, fs2 = (tree_map(lambda n, o: torch.where(finite, n, o),
                                     new, old)
                            for new, old in ((fp2, fp), (fs2, fs)))
            fp, fs = fp2, fs2
            keep = (lambda n, o: torch.where(finite, n, o)) if guard \
                else None
            dp, ds = update_(dp, grads, ds, torch.tensor(t), keep=keep)
            assert all(_bits_equal(a, b) for a, b in zip(
                tree_leaves((fp, fs)), tree_leaves((dp, ds))))
        assert all(a is b for a, b in zip(tree_leaves((dp, ds)), given))


def test_donation_refuses_shared_storage():
    cfg = _cfg("olmo-1b")
    opt = O.AdamWConfig()
    state = init_train_state(init_params(0, cfg, device="cpu"), opt)
    leaves = state["opt"]["mu"]
    key = sorted(leaves)[0]
    leaves[key] = state["opt"]["nu"][key]          # one storage, twice
    batch = SyntheticLMDataset(cfg, CELL, DataConfig(seed=0)).batch_on(
        0, "cpu")
    with pytest.raises(ValueError, match="share one storage"):
        make_train_step(cfg, opt, donate=True)(state, batch)


def _cache_leaves(caches):
    out = []
    map_with_path(lambda _p, t: out.append(t), caches)
    return out


@pytest.mark.parametrize("arch,paged", [
    ("olmo-1b", False), ("olmo-1b", True), ("deepseek-v2-lite-16b", False),
    ("deepseek-v2-lite-16b", True), ("zamba2-7b", False),
    ("mamba2-370m", False), ("seamless-m4t-medium", False)],
    ids=lambda v: v if isinstance(v, str) else ("paged" if v else "dense"))
def test_donated_decode_equals_functional(arch, paged):
    """Three steps from empty caches (every slot active, so no two lines
    share a place in the pool): logits and caches bit-equal each step."""
    cfg = _cfg(arch)
    params = init_params(0, cfg, device="cpu")
    b, max_len, blk = 2, 8, 4
    w = max_len // blk

    def caches():
        if paged:
            return init_paged_caches(cfg, 1 + b * w, blk, torch.float32,
                                     device="cpu")
        return init_decode_caches(cfg, b, max_len, torch.float32,
                                  enc_len=max_len, device="cpu")
    fun, don = caches(), caches()
    given = _cache_leaves(don)
    rng = np.random.default_rng(5)
    bt = 1 + torch.arange(b * w, dtype=torch.int32).reshape(b, w)
    active = torch.ones((b,), dtype=torch.bool)
    for i in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(
            b, 1)).astype(np.int32))
        pos = torch.full((b,), i, dtype=torch.int32)
        with torch.no_grad():
            if paged:
                fl, fun = decode_step_paged(params, tok, fun, bt, pos,
                                            active, cfg)
                dl, don = decode_step_paged(params, tok, don, bt, pos,
                                            active, cfg, donate=True)
            else:
                fl, fun = decode_step(params, tok, fun, pos, cfg)
                dl, don = decode_step(params, tok, don, pos, cfg,
                                      donate=True)
        assert _bits_equal(fl, dl)
        assert all(_bits_equal(a, c) for a, c in zip(_cache_leaves(fun),
                                                     _cache_leaves(don)))
    assert all(a is c for a, c in zip(_cache_leaves(don), given))


def test_async_checkpoint_then_donated_step(tmp_path):
    cfg = _cfg("olmo-1b")
    opt = O.AdamWConfig(lr=1e-2)
    state = init_train_state(init_params(0, cfg, device="cpu"), opt)
    step = make_train_step(cfg, opt, donate=True)
    ds = SyntheticLMDataset(cfg, CELL, DataConfig(seed=0))
    state, _ = step(state, ds.batch_on(0, "cpu"))
    saved = _clone(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    state, _ = step(state, ds.batch_on(1, "cpu"))
    mgr.wait()
    got = load_checkpoint(str(tmp_path), 1, saved)
    assert int(state["step"]) == 2 and int(got["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(saved)))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(saved["params"])))


FIRST_REMAT_STEP = """
import gc, json, sys, weakref
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.nn import init_params
from repro_torch.nn.config import ShapeCell
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step
cfg = reduced(get_config("olmo-1b")).with_(numerics="fp32", remat="block")
opt, tc = AdamWConfig(), TrainConfig(grad_clip=1.0)
state = init_train_state(init_params(0, cfg, device="cpu"), opt, tc)
step = make_train_step(cfg, opt, tc=tc)
batch = SyntheticLMDataset(cfg, ShapeCell("t", 16, 2, "train"),
                           DataConfig(seed=0)).batch_on(0, "cpu")
refs, grad = [], torch.autograd.grad

def watched(*a, **k):
    out = grad(*a, **k)
    refs.extend(weakref.ref(g) for g in out if g is not None)
    return out
torch.autograd.grad = watched
imported = "torch._dynamo" in sys.modules
gc.collect()
gc.disable()
state, m = step(state, batch)
print(json.dumps({"imported_before": imported, "grads": len(refs),
                  "alive": sum(r() is not None for r in refs)}))
"""


def test_first_remat_step_frees_its_gradients():
    out = subprocess.run(
        [sys.executable, "-c", FIRST_REMAT_STEP], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert not rec["imported_before"]
    assert rec["grads"] > 0 and rec["alive"] == 0, rec
