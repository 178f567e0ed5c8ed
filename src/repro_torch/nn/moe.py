"""Mixture-of-Experts FFN: shared + fine-grained routed experts (DeepSeek).

The dropless reference of the JAX package (``repro.nn.moe``): every token
runs through every routed expert as a masked einsum, and the top-k
weights select the outputs.  The router runs in float32, its top-k
weights are renormalized (the DeepSeek convention), and a Switch-style
load-balance aux term comes back beside the output.

The routed experts are float einsums of the STE-quantized operands
(``pol.q_act`` / ``pol.q_param``): they reach no ⊞-MAC kernel.  Only the
shared experts run through ``pol.linear``, and so through the ⊞-MAC under
the ``lns*-train`` modes.

Only the single-device reference is ported: ``moe_ep`` and
``moe_ep_replicated`` are ``shard_map`` code over a mesh, and a
:class:`MoERuntime` with a mesh raises (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.numerics import NumericsPolicy
from .config import ModelConfig
from .layers import FLOAT32, FloatOps, _normal, float_ops


def _unported_ep(what: str):
    return NotImplementedError(
        f"{what}: expert parallelism over a mesh is not ported (ROADMAP "
        f"queue 1 item 13)")


@dataclasses.dataclass(frozen=True)
class MoERuntime:
    """How to execute the MoE block: ``mesh=None``, the reference, is the
    only mode ported; a mesh raises (ROADMAP queue 1 item 13)."""
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise _unported_ep("MoERuntime(mesh=...)")


def init_moe(gen, cfg: ModelConfig, dtype):
    """The MoE block's parameters: a float32 router (d, E), the routed
    experts stacked (E, d, d_e) / (E, d_e, d), and the shared experts as
    one FFN of width ``n_shared · d_e``."""
    m = cfg.moe
    d, de = cfg.d_model, m.d_expert
    s_in, s_out = d ** -0.5, de ** -0.5
    p = {"router": _normal(gen, (d, m.n_experts), torch.float32, d ** -0.5),
         "w_gate": _normal(gen, (m.n_experts, d, de), dtype, s_in),
         "w_up": _normal(gen, (m.n_experts, d, de), dtype, s_in),
         "w_down": _normal(gen, (m.n_experts, de, d), dtype, s_out)}
    if m.n_shared:
        sh = m.n_shared * de
        p["shared_gate"] = _normal(gen, (d, sh), dtype, s_in)
        p["shared_up"] = _normal(gen, (d, sh), dtype, s_in)
        p["shared_down"] = _normal(gen, (sh, d), dtype, sh ** -0.5)
    return p


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values lower index first (a stable sort; the
    order of ``torch.topk`` among ties is unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, xf, m, fl: FloatOps = FLOAT32):
    """(top-k weights renormalized, expert ids, aux), the logits, softmax
    and renormalizing sum taken by ``fl``."""
    probs = fl.softmax(fl.matmul(xf.to(torch.float32), p["router"]))
    w, ids = top_k(probs, m.top_k)
    w = w / torch.clamp(fl.sum(w), min=1e-9)
    # load-balance aux loss (Switch-style)
    frac = torch.mean(torch.nn.functional.one_hot(
        ids[..., 0], m.n_experts).to(torch.float32), dim=0)
    aux = m.n_experts * torch.sum(frac * torch.mean(probs, dim=0))
    return w, ids, aux


def _shared_ffn(p, x, cfg, pol):
    h = torch.nn.functional.silu(pol.linear(x, p["shared_gate"])) \
        * pol.linear(x, p["shared_up"])
    return pol.linear(h, p["shared_down"])


def moe_reference(p, x, cfg: ModelConfig, pol: NumericsPolicy):
    """Dropless masked computation over all experts: (out (B, S, d), aux).

    The router and the routed experts' einsums are float reductions
    (``layers.float_ops(pol)``): order-free in float64 on the serving
    paths, so that a token's output does not depend on how many tokens
    share its call."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    fl = float_ops(pol)
    w, ids, aux = _router(p, xf, m, fl)
    comb = torch.zeros((xf.shape[0], m.n_experts), dtype=x.dtype,
                       device=x.device).scatter(1, ids, w.to(x.dtype))
    xq = pol.q_act(xf)
    h = torch.nn.functional.silu(fl.einsum("nd,edf->enf", xq,
                                           pol.q_param(p["w_gate"])))
    h = h * fl.einsum("nd,edf->enf", xq, pol.q_param(p["w_up"]))
    y = fl.einsum("enf,efd->end", pol.q_act(h), pol.q_param(p["w_down"]))
    out = fl.einsum("end,ne->nd", y, comb)
    if m.n_shared:
        out = out + _shared_ffn(p, xf, cfg, pol)
    return out.reshape(b, s, d), aux


def moe_ep(p, x, cfg: ModelConfig, pol: NumericsPolicy, rt: MoERuntime):
    """The JAX package's expert-parallel MoE (``shard_map`` + all-to-all):
    not ported."""
    raise _unported_ep("moe_ep")


def moe_ep_replicated(p, x, cfg: ModelConfig, pol: NumericsPolicy,
                      rt: MoERuntime):
    """The JAX package's replicated-token expert parallelism: not
    ported."""
    raise _unported_ep("moe_ep_replicated")


def moe_block(p, x, cfg: ModelConfig, pol: NumericsPolicy,
              rt: Optional[MoERuntime] = None):
    if rt is None or rt.mesh is None:
        return moe_reference(p, x, cfg, pol)
    raise _unported_ep("moe_block with a mesh")
