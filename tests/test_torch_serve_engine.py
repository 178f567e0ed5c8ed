"""The port's serving engine (``repro_torch.serve``): chunked prefill,
the paged KV cache, continuous batching, admission control and the
engine's faults.

The engine is held to the port's own ``reference_generate`` (the dense
token-by-token oracle) on the CPU lane, for every chunk size, block size,
slot count and arrival order tested, and to itself on a repeat: the
serving model functions take their float reductions in an order-free
form, so a token's logits do not depend on the batch or chunk it is
computed in.  The port's ``reference_generate`` is held to the JAX
package's (greedy tokens, fp32), its queue and allocator to the
reference's.  The port's engine is not held to the reference's engine:
that one's outputs vary from run to run here (ROADMAP, reference reds).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro import serve as jserve
from repro.nn import init_params as jinit
from repro.nn.config import MoEConfig as JMoE
from repro.nn.config import ModelConfig as JConfig
from repro_torch.nn import params_from_numpy
from repro_torch.nn.config import MoEConfig, ModelConfig
from repro_torch.serve import (DONE, REJECT_CODES, REJECTED, TERMINAL,
                               BlockManager, RequestQueue, ServeConfig,
                               ServingEngine, reference_generate)

from lm_parity import cfgs, to_numpy

torch.set_num_threads(1)

TINY = dict(name="tiny-serve", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64, d_head=16,
            vocab_pad_to=64, numerics="fp32", param_dtype="float32",
            remat="none", q_chunk=8)
TINY_MOE = dict(TINY, name="tiny-serve-moe", family="moe", n_layers=3)
MOE = dict(n_experts=4, top_k=2, n_shared=1, d_expert=32,
           first_dense_layers=1)


@functools.lru_cache(maxsize=None)
def _model(which):
    """(the reference's config and params, the port's), the port's
    params carried across from the reference's."""
    if which == "dense":
        jcfg, tcfg = JConfig(**TINY), ModelConfig(**TINY)
    else:
        jcfg = JConfig(**TINY_MOE, moe=JMoE(**MOE))
        tcfg = ModelConfig(**TINY_MOE, moe=MoEConfig(**MOE))
    jp = jinit(jax.random.PRNGKey(0 if which == "dense" else 1), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(to_numpy(jp), "cpu")


def _prompts(n, seed=0, lo=1, hi=7, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(lo, hi)))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _ref(which, prompt, max_new, max_len):
    _, _, cfg, params = _model(which)
    return reference_generate(cfg, params, np.asarray(prompt, np.int32),
                              max_new, max_len=max_len)


# ------------------------------------------------ reference_generate -----
@pytest.mark.parametrize("which", ["dense", "moe"])
def test_reference_generate_equals_the_reference(which):
    """The port's dense oracle gives the JAX package's greedy tokens from
    the same weights (fp32)."""
    jcfg, jp, tcfg, tp = _model(which)
    for p in _prompts(3, seed=11, lo=2, hi=8):
        want = jserve.reference_generate(jcfg, jp, p, 6, max_len=20)
        assert reference_generate(tcfg, tp, p, 6, max_len=20) == want


# ------------------------------------------- chunked prefill parity ------
@pytest.mark.parametrize("bs", [2, 8])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_engine_equals_reference_generate(chunk, bs):
    """Greedy outputs equal the dense token-by-token oracle for every
    (chunk, block) geometry, and again on a repeat; the pool is
    conserved."""
    _, _, cfg, params = _model("dense")
    prompts = _prompts(3, seed=2, lo=1, hi=8)
    refs = [_ref("dense", tuple(p), 5, 24) for p in prompts]
    for _ in range(2):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=2, max_len=24, block_size=bs, prefill_chunk=chunk))
        assert eng.run(prompts, max_new=5) == refs
        eng.bm.check_conserved()
        assert eng.bm.outstanding == 0


@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_arrival_order_and_slot_count_invariance(max_batch):
    """Any submission order and slot count → each prompt's oracle
    output."""
    _, _, cfg, params = _model("dense")
    prompts = _prompts(4, seed=3)
    sc = ServeConfig(max_batch=max_batch, max_len=20, block_size=4,
                     prefill_chunk=4)
    for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
        eng = ServingEngine(cfg, params, sc)
        outs = eng.run([prompts[i] for i in order], max_new=4)
        for i, o in zip(order, outs):
            assert o == _ref("dense", tuple(prompts[i]), 4, 20), (order, i)


def test_moe_engine_equals_reference_generate():
    _, _, cfg, params = _model("moe")
    prompts = _prompts(3, seed=8)
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=2, max_len=16, block_size=4, prefill_chunk=3))
    assert eng.run(prompts, max_new=4) == [_ref("moe", tuple(p), 4, 16)
                                           for p in prompts]
    eng.bm.check_conserved()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "olmo-1b"])
def test_lns_engine_equals_reference_generate(arch):
    """Under lns16-train (every matmul a ⊞-MAC: the engine's through
    ``linear_infer``, kernel row 1; the oracle's through ``linear``, row
    5): paged MLA + MoE and paged GQA, two geometries, the oracle's
    tokens."""
    cfg = cfgs(arch, "lns16-train-pallas")[1]
    from repro_torch.nn import init_params
    params = init_params(5, cfg, device="cpu")
    prompts = _prompts(3, seed=4, lo=2, hi=9, vocab=cfg.vocab_size)
    refs = [reference_generate(cfg, params, p, 3, max_len=16)
            for p in prompts]
    for chunk, bs in ((3, 4), (8, 2)):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=2, max_len=16, block_size=bs, prefill_chunk=chunk))
        assert eng.run(prompts, max_new=3) == refs, (chunk, bs)
        eng.bm.check_conserved()


# ------------------------------------------------- sampling isolation ----
def test_sampled_continuation_independent_of_slot_and_refill_order():
    """A request's sampled tokens depend on (seed, rid, token index) only:
    the same in every geometry and equal to the oracle's stream."""
    _, _, cfg, params = _model("dense")
    prompts = _prompts(4, seed=5)
    outs = []
    for max_batch, bs, chunk in ((1, 4, 8), (3, 2, 2), (4, 8, 4)):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=max_batch, max_len=20, block_size=bs,
            prefill_chunk=chunk, temperature=0.8, seed=7))
        outs.append(eng.run(prompts, max_new=5))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == [reference_generate(cfg, params, p, 5, max_len=20,
                                          temperature=0.8, seed=7, rid=i)
                       for i, p in enumerate(prompts)]


def test_sampled_reference_generate_equals_the_reference():
    """The sampled oracle draws the JAX package's tokens (threefry keys,
    Gumbel noise and argmax as ``jax.random.categorical``)."""
    jcfg, jp, tcfg, tp = _model("dense")
    for i, p in enumerate(_prompts(3, seed=9, lo=2, hi=6)):
        kw = dict(max_len=20, temperature=0.8, seed=3, rid=i)
        assert reference_generate(tcfg, tp, p, 5, **kw) == \
            jserve.reference_generate(jcfg, jp, p, 5, **kw)


# -------------------------------------------------- admission control ----
def test_reject_codes_are_the_reference_vocabulary():
    assert REJECT_CODES == jserve.REJECT_CODES
    assert (DONE, REJECTED, TERMINAL) == (jserve.DONE, jserve.REJECTED,
                                          jserve.TERMINAL)


def test_rejections_equal_the_reference():
    """Queue-full, prompt-over-budget, reservation-over-pool and
    deadline rejections: the same states, reasons and per-code counters
    as the reference engine's (not its tokens, which vary from run to run
    here)."""
    jcfg, jp, tcfg, tp = _model("dense")

    def scenario(cfg, params, mod):
        rows = []
        eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
            max_batch=1, max_len=16, block_size=4, max_queue=1))
        a = eng.submit(np.array([5, 6]), max_new=2)
        b = eng.submit(np.array([7, 8]), max_new=2)
        while eng.poll(a).state not in mod.TERMINAL:
            eng.step()
        rows.append([(eng.poll(r).state, eng.poll(r).reason,
                      eng.poll(r).reason_code) for r in (a, b)])
        rows.append(dict(eng.queue.rejections))
        eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
            max_batch=1, max_len=8, block_size=4))
        r = eng.poll(eng.submit(np.arange(3, 11), max_new=4))
        rows.append((r.state, r.reason, r.reason_code, eng.queue.depth))
        eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
            max_batch=1, max_len=16, block_size=2, num_blocks=3))
        r = eng.poll(eng.submit(np.array([3, 4, 5]), max_new=8))
        rows.append((r.state, r.reason, r.reason_code))
        eng.bm.check_conserved()
        eng = mod.ServingEngine(cfg, params, mod.ServeConfig(
            max_batch=1, max_len=16, block_size=4))
        slow = eng.submit(np.array([5, 6]), max_new=8)
        eng.step()
        urgent = eng.submit(np.array([7, 8]), max_new=2, deadline_steps=2)
        while eng.poll(slow).state not in mod.TERMINAL:
            eng.step()
        rows.append([(eng.poll(x).state, eng.poll(x).reason,
                      eng.poll(x).reason_code) for x in (slow, urgent)])
        rows.append(dict(eng.queue.rejections))
        eng.bm.check_conserved()
        return rows

    import repro_torch.serve as tserve
    assert scenario(tcfg, tp, tserve) == scenario(jcfg, jp, jserve)


def test_request_queue_equals_the_reference():
    """Submission past the depth cap, expiry, requeue at the front and the
    counters, step for step."""
    def drive(q):
        out = [q.submit([1, 2], 4, None, 0).state,
               q.submit([3], 4, 1, 0).state,
               q.submit([4], 4, None, 1).state]
        out.append([r.rid for r in q.expire(3)])
        req = q.pop()
        q.requeue(req)
        out += [q.peek().rid, q.depth, dict(q.rejections)]
        with pytest.raises(ValueError, match="unknown rejection code"):
            q.reject(req, "x", 4, "nope")
        return out
    assert drive(RequestQueue(max_depth=2)) == drive(
        jserve.RequestQueue(max_depth=2))


def test_block_manager_equals_the_reference():
    """Alloc / free order, all-or-nothing grants, budget math and the
    conservation check, against the reference's allocator."""
    def drive(bm):
        out = [bm.capacity, bm.blocks_for(0), bm.blocks_for(9),
               bm.fits_ever(28), bm.fits_ever(29)]
        a = bm.alloc(3)
        b = bm.alloc(2)
        out += [a, b, bm.alloc(3), bm.available]
        bm.free(a)
        out += [bm.alloc(4), bm.outstanding]
        bm.check_conserved()
        with pytest.raises(ValueError, match="double free"):
            bm.free(a[:1] + a[:1])
        return out
    assert drive(BlockManager(8, 4)) == drive(jserve.BlockManager(8, 4))
    bm = BlockManager(5, 2)
    bm._free.append(bm._free[0])
    with pytest.raises(AssertionError, match="duplicate"):
        bm.check_conserved()
    with pytest.raises(ValueError):
        BlockManager(1, 4)


def test_engine_refuses_unpaged_family():
    _, _, cfg, params = _model("dense")
    with pytest.raises(ValueError, match="reference_generate"):
        ServingEngine(cfg.with_(family="ssm", attn_kind="none"), params,
                      ServeConfig())


# ------------------------------------------------------------ faults -----
def test_hang_step_fires_the_watchdog_and_retries():
    """An injected hung step aborts the batch through the watchdog, the
    retry budget re-admits it, every request finishes with its oracle
    output, and the pool is conserved."""
    _, _, cfg, params = _model("dense")
    prompts = _prompts(3, seed=12, lo=4, hi=7)
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=2, max_len=24, block_size=4, prefill_chunk=4,
        retry_budget=1), faults="seed=0;serve=hang_step:3")
    outs = eng.run(prompts, max_new=5)
    names = [r["name"] for r in eng.registry.rows()]
    assert "serve.watchdog_fired" in names and "serve.retries" in names
    assert sum(eng.poll(r).retries for r in range(3)) > 0
    assert outs == [_ref("dense", tuple(p), 5, 24) for p in prompts]
    eng.bm.check_conserved()


def test_slow_req_leaves_outputs_unchanged():
    """The slow-request fault skips every other decode step of rid % 2 ==
    0 slots: more decode steps, the same outputs."""
    _, _, cfg, params = _model("dense")
    prompts = _prompts(4, seed=13)
    sc = ServeConfig(max_batch=2, max_len=20, block_size=4, prefill_chunk=4)
    clean = ServingEngine(cfg, params, sc)
    slow = ServingEngine(cfg, params, sc, faults="seed=0;serve=slow_req:2")
    assert slow.run(prompts, max_new=6) == clean.run(prompts, max_new=6)
    assert slow.stats["decode_steps"] > clean.stats["decode_steps"]


def test_serve_drill_row_equals_the_reference():
    """The serve drill from the reference's tiny weights gives the
    reference drill's row but for ``lane`` and ``acc_delta_post``: the
    port's faulted outputs equal its fault-free ones (0.0).  The
    reference's own row reads 0.0 in a fresh process and 1.0 once other
    reference engines have run in it (its engine's outputs vary from run
    to run here: ROADMAP, reference reds), so that field is held to the
    port's invariant instead."""
    from repro.launch import drill as jdrill
    from repro_torch.launch import drill as tdrill
    want = jdrill.drill_serve(10, 0)
    jp = jinit(jax.random.PRNGKey(0), JConfig(**dict(TINY,
                                                     name="tiny-drill")))
    got = tdrill.drill_serve(10, 0, device="cpu", params=to_numpy(jp))
    assert got.pop("lane") == "cpu"
    assert got.pop("acc_delta_post") == 0.0
    want.pop("acc_delta_post")
    assert got == want


def test_serve_cli_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu --arch qwen3-1.7b
    --requests 3`` serves three requests and prints the reference's
    lines."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-1.7b", "--requests", "3"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        f"[serve] req {i}" for i in range(3)]
    assert "tok/s batched" in lines[3]
    assert "prefill chunks" in lines[4] and "blocks free" in lines[4]
    assert lines[5] == "[serve] matmul path: float XLA matmul (float32) " \
                       "on cpu"
