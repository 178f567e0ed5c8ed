"""``chip_smoke.py``'s launch counting (``lm_linears``, ``lm_products``,
``lm_expected``, ``serve_products``) against the launches one train step
and one ``decode_step`` of each LM family really make, on the CPU lane.

On CPU tensors the ⊞-MAC wrappers run the plain version and count
nothing, so here the wrappers' lane rule answers "cuda" and the launcher
is the plain version that records each launch's (row, R, C, CT), read
from its contracted axes: forward (1, 0), dX (1, 1), dW (0, 0).  The
counters then count exactly where a card would launch.  The step is
``chip_smoke.lm_train``'s: AdamW, ``reduced()``, lns16-train-pallas,
batch 2 × seq 32 (the enc-dec families over 32 frames).
"""
import collections
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import (launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.nn import (decode_step, init_decode_caches,  # noqa: E402
                            init_params)
from repro_torch.nn.config import ShapeCell  # noqa: E402
from repro_torch.optim.optimizers import AdamWConfig  # noqa: E402
from repro_torch.train import (TrainConfig, init_train_state,  # noqa: E402
                               make_train_step)

torch.set_num_threads(1)

ROWS = {(1, 0): "lns_matmul", (1, 1): "lns_matmul_dx",
        (0, 0): "lns_matmul_dw"}
ARCHS = ["olmo-1b", "deepseek-v2-lite-16b", "mamba2-370m", "zamba2-7b",
         "seamless-m4t-medium"]


@pytest.fixture
def recorded(monkeypatch):
    """The launches of the ⊞-MAC wrappers, as a list of (row, R, C, CT),
    with the counters counting."""
    K = sys.modules["repro_torch.kernels.lns_matmul.lns_matmul"]
    seen = []

    def launch(a_code, a_sign, b_code, b_sign, *, a_contract_axis,
               b_contract_axis, **kw):
        seen.append((ROWS[a_contract_axis, b_contract_axis],
                     a_code.shape[1 - a_contract_axis],
                     b_code.shape[1 - b_contract_axis],
                     a_code.shape[a_contract_axis]))
        return K.mac_plain(a_code, a_sign, b_code, b_sign,
                           a_contract_axis=a_contract_axis,
                           b_contract_axis=b_contract_axis, **kw)
    monkeypatch.setattr(K, "lane", lambda t, kernel="": "cuda")
    monkeypatch.setattr(K, "mac_cuda", launch)
    reset_launch_counts()
    yield seen
    reset_launch_counts()


def _expand(products):
    return collections.Counter({p[:4]: p[4] for p in products})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launches_as_counted(arch, recorded):
    cfg = reduced(get_config(arch)).with_(numerics="lns16-train-pallas",
                                          remat="none")
    opt, tc = AdamWConfig(lr=1e-3), TrainConfig(grad_clip=1.0)
    state = init_train_state(init_params(0, cfg, device="cpu"), opt, tc)
    ds = SyntheticLMDataset(cfg, ShapeCell("lm", 32, 2, "train"),
                            DataConfig(seed=0))
    make_train_step(cfg, opt, tc=tc)(state, ds.batch_on(0, "cpu"))
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == chip_smoke.lm_expected(cfg, 32)
    assert collections.Counter(recorded) == _expand(
        chip_smoke.lm_products(cfg, 2, 32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_launches_as_counted(arch, recorded):
    """One ``decode_step`` of 2 sequences (the enc-dec memory of 6
    frames): row 5 once per serving linear and once for the head."""
    cfg = reduced(get_config(arch)).with_(numerics="lns16-train-pallas",
                                          remat="none")
    params = init_params(0, cfg, device="cpu")
    caches = init_decode_caches(cfg, 2, 8, torch.float32, enc_len=6,
                                device="cpu")
    with torch.no_grad():
        decode_step(params, torch.full((2, 1), 5, dtype=torch.int32),
                    caches, torch.zeros(2, dtype=torch.int32), cfg)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"lns_matmul": len(chip_smoke.lm_linears(cfg, True))
                      + 1}
    assert collections.Counter(recorded) == _expand(
        chip_smoke.serve_products(cfg, 2, 2, 12, row="lns_matmul"))
