"""The LM twins of ``examples/`` on the CPU lane, at sizes a test affords:
``train_lm`` (its resume drill), ``lns_modes_comparison`` and
``serve_batched`` (whose engine outputs equal ``reference_generate``
request by request under an LNS spec), each through ``main(argv)`` and
the lines it prints; ``--device cuda`` raises on a host with no card."""
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.examples import lns_modes_comparison, serve_batched, \
    train_lm
from repro_torch.nn import init_params
from repro_torch.serve import reference_generate

torch.set_num_threads(1)


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_train_lm_trains_and_resumes(tmp_path, capsys):
    argv = ["--steps", "10", "--seq", "64", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    state = train_lm.main(argv)
    out = _lines(capsys)
    assert out[0].startswith("[example] lm-25m: ") and \
        out[0].endswith("M params, numerics=bf16")
    assert out[1].startswith("step   10  loss ")
    first, last = (float(v) for v in
                   out[-1].split("loss ")[1].split(" over")[0].split(" → "))
    assert last < first and out[-1].endswith("over 10 steps")
    assert int(state["step"]) == 10
    train_lm.main(argv)
    out = _lines(capsys)
    assert out[1:] == ["[example] resumed from step 10",
                       "[example] nothing to do: the checkpoint is at "
                       "step 10"]


def test_lns_modes_comparison(monkeypatch, capsys):
    monkeypatch.setattr(lns_modes_comparison, "STEPS", 3)
    rows = lns_modes_comparison.main(["--device", "cpu"])
    out = _lines(capsys)
    assert list(rows) == ["fp32", "bf16", "lns16-qat", "lns12-qat"]
    for line, (mode, losses) in zip(out, rows.items()):
        assert line.startswith(f"{mode:10s} loss {losses[0]:.4f} → "
                               f"{losses[-1]:.4f} (")
        assert line.endswith("s for 3 steps)")
        assert losses[-1] < losses[0]
    gap = rows["lns16-qat"][-1] - rows["bf16"][-1]
    assert out[-1].startswith(f"LNS-16 QAT final-loss gap vs bf16: "
                              f"{gap:+.4f} ")


def test_serve_batched_equals_the_oracle(capsys):
    """Under lns16-exact-pallas (the fused ⊞-MAC's plain version) every
    request's tokens equal ``reference_generate``'s, sampled at the
    twin's temperature with the request's id."""
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "4",
            "--numerics", "lns16-exact-pallas"]
    outs = serve_batched.main(argv)
    out = _lines(capsys)
    cfg = reduced(get_config("yi-6b")).with_(
        numerics="lns16-exact-pallas", param_dtype="float32", remat="none")
    params = init_params(0, cfg, device="cpu")
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=rng.integers(4, 12))
               for _ in range(3)]
    for i, (p, o) in enumerate(zip(prompts, outs)):
        want = reference_generate(cfg, params, p, 4, max_len=40,
                                  temperature=0.8, rid=i)
        assert o == want, i
        assert out[i] == f"req {i}: {len(p)} prompt toks → {o}"
    n = sum(len(o) for o in outs)
    assert out[3].startswith(f"[serve] 3 requests, {n} new tokens, ")
    assert out[4].startswith("[serve] occupancy ")
    assert out[5] == "[serve] numerics spec: lns16-exact-pallas"
    assert out[6].startswith("[serve] batch served by: ") and \
        out[6].endswith(" on cpu")


def test_serve_batched_default_flags(capsys):
    outs = serve_batched.main(["--device", "cpu"])
    out = _lines(capsys)
    assert len(outs) == 6 and all(len(o) <= 12 for o in outs)
    assert out[8] == "[serve] numerics spec: fp32"


@pytest.mark.parametrize("mod", [train_lm, lns_modes_comparison,
                                 serve_batched])
def test_no_card_raises(mod):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        mod.main(["--device", "cuda"])
