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

Under a mesh the JAX package's two expert-parallel forms run as explicit
per-rank code (:mod:`repro_torch.distributed.spmd`), experts split E/tp
over the model axis: ``moe_ep`` routes the rank's own tokens (its block of
the sequence) through a capacity-bounded all-to-all over ``model`` and
back; ``moe_ep_replicated`` (tokens replicated over ``model``: decode)
keeps the assignments to the rank's experts and sums the routed outputs
over ``model``.  Both drop the assignments over capacity, and their
``aux`` is averaged over every axis, as the JAX package's are: under a
mesh the MoE computes something else than the dropless reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..core.numerics import NumericsPolicy
from .config import ModelConfig
from ..distributed.spmd import all_to_all, all_to_all_raw
from .layers import FLOAT32, FloatOps, _normal, float_ops


@dataclasses.dataclass(frozen=True)
class MoERuntime:
    """How to execute the MoE block (None mesh → reference impl).  With a
    mesh, :func:`moe_block` takes the tokens replicated over the model
    axis (each rank its data block, the whole sequence)."""
    mesh: Optional[object] = None
    data_axes: tuple = ("data",)   # batch axes (may include 'pod')
    model_axis: str = "model"

    def __post_init__(self):
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(f"MoERuntime(mesh=...) takes a torch."
                                f"distributed.device_mesh.DeviceMesh, not "
                                f"{type(self.mesh).__name__}")
        object.__setattr__(self, "data_axes", tuple(self.data_axes))

    def layout(self, seq: bool = False):
        from ..distributed.spmd import Sharded
        return Sharded(self.mesh, tuple(self.data_axes), self.model_axis,
                       seq)


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


def _expert_ffn(w_gate, w_up, w_down, xe, pol, fl):
    """xe: (E, C, d) → (E, C, d) batched over experts."""
    xq = pol.q_act(xe)
    g = torch.nn.functional.silu(fl.einsum("ecd,edf->ecf", xq,
                                           pol.q_param(w_gate)))
    u = fl.einsum("ecd,edf->ecf", xq, pol.q_param(w_up))
    return fl.einsum("ecf,efd->ecd", pol.q_act(g * u), pol.q_param(w_down))


def _bucket_positions(keys, n_buckets: int):
    """Stable-sort ``keys`` and return (order, key_sorted, pos_in_bucket)."""
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    kc = torch.clamp(ks, 0, n_buckets - 1)
    oh = torch.nn.functional.one_hot(kc, n_buckets)
    pos = torch.gather(torch.cumsum(oh, dim=0), 1, kc[:, None])[:, 0] - 1
    return order, ks, pos


_DROPS = None


@contextlib.contextmanager
def collect_drops():
    """Within the block, each EP call appends (the assignments this rank
    routed, how many of them were dropped; ints or device tensors, no host
    read) to the list yielded."""
    global _DROPS
    _DROPS, out = [], []
    try:
        yield out
    finally:
        out.extend(_DROPS)
        _DROPS = None


def _note_drops(n, dropped):
    if _DROPS is not None:
        _DROPS.append((n, dropped.detach()))


def _layout(rt, seq: bool):
    return rt.layout(seq) if isinstance(rt, MoERuntime) else rt


def _put(rows: int, d: int, slot, vals):
    """``zeros(rows, d).at[slot].set(vals)``: ``slot`` holds distinct rows
    but for the overflow row, which the callers drop."""
    out = torch.zeros((rows, d), dtype=vals.dtype, device=vals.device)
    return out.index_put((slot,), vals)


def moe_ep(p, x, cfg: ModelConfig, pol: NumericsPolicy, rt):
    """Expert-parallel MoE: the rank's tokens (its batch block, its block
    of the sequence over the model axis) routed to the ranks that hold
    their experts by an all-to-all over ``model``, and back.

    ``p``: the router and shared experts whole, the routed experts' local
    block of E/tp (``w_gate``/``w_up``/``w_down``).  ``rt``: a
    :class:`MoERuntime` or the model's stream layout.
    """
    sh = _layout(rt, True)
    m = cfg.moe
    tp = sh.tp
    assert m.n_experts % tp == 0, (m.n_experts, tp)
    e_loc = m.n_experts // tp
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    fl = float_ops(pol)
    w, ids, aux = _router(p, xf, m, fl)
    aux = sh.mean_all(aux)
    nk = n * m.top_k
    cap_send = int(-(-nk // tp) * m.capacity_factor)
    flat_ids = ids.reshape(-1)
    tok = torch.arange(n, device=x.device).repeat_interleave(m.top_k)
    wgt = w.reshape(-1)
    dest = torch.div(flat_ids, e_loc, rounding_mode="floor")
    order, _, pos = _bucket_positions(dest, tp)
    keep = pos < cap_send
    slot = torch.where(keep, dest[order] * cap_send + pos, tp * cap_send)
    # scatter into send buffers (+1 overflow row, dropped)
    send_x = _put(tp * cap_send + 1, d, slot, xf[tok[order]])
    send_e = torch.full((tp * cap_send + 1,), -1, dtype=flat_ids.dtype,
                        device=x.device).index_put((slot,), flat_ids[order])
    grp = sh.model_group
    recv_x = all_to_all(send_x[:-1].reshape(tp, cap_send, d), 0, 0, grp)
    recv_e = all_to_all_raw(send_e[:-1].reshape(tp, cap_send), 0, 0, grp)
    recv_x = recv_x.reshape(tp * cap_send, d)
    recv_e = recv_e.reshape(-1)
    el = torch.where(recv_e >= 0, recv_e - sh.model_rank * e_loc, e_loc)
    # local per-expert bucketing (invalid rows bucket to e_loc, dropped)
    cap_e = int(-(-tp * cap_send // e_loc) * m.capacity_factor)
    order2, el_s, pos2 = _bucket_positions(el, e_loc + 1)
    ok2 = (el_s < e_loc) & (pos2 < cap_e)
    slot2 = torch.where(ok2, el_s * cap_e + pos2, e_loc * cap_e)
    xe = _put(e_loc * cap_e + 1, d, slot2, recv_x[order2])
    # dropped by the sender's capacity, and by the receiver's (of the
    # rows it was sent)
    _note_drops(nk, (~keep).sum() + ((el_s < e_loc) & ~ok2).sum())
    ye = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                     xe[:-1].reshape(e_loc, cap_e, d), pol, fl)
    ye = ye.reshape(-1, d)
    # back to recv order → reverse all-to-all → weighted combine
    got2 = torch.where(ok2[:, None],
                       ye[torch.clamp(slot2, 0, e_loc * cap_e - 1)], 0.0)
    y_recv = _put(tp * cap_send, d, order2, got2)
    y_back = all_to_all(y_recv.reshape(tp, cap_send, d), 0, 0, grp)
    y_flat = y_back.reshape(tp * cap_send, d)
    got = torch.where(keep[:, None],
                      y_flat[torch.clamp(slot, 0, tp * cap_send - 1)], 0.0)
    out = torch.zeros_like(xf).index_add(
        0, tok[order], got * wgt[order][:, None].to(x.dtype))
    if m.n_shared:
        out = out + _shared_ffn(p, xf, cfg, pol)
    return out.reshape(b, s, d), aux


def moe_ep_replicated(p, x, cfg: ModelConfig, pol: NumericsPolicy, rt):
    """EP without all-to-all, for token counts too small to split over the
    sequence (decode: seq 1).  Tokens are replicated over the model axis;
    each rank keeps the assignments to its local experts, and the routed
    outputs are summed over ``model``.  Shared experts are computed on
    every rank and added outside the sum."""
    sh = _layout(rt, False)
    m = cfg.moe
    tp = sh.tp
    e_loc = m.n_experts // tp
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    fl = float_ops(pol)
    w, ids, aux = _router(p, xf, m, fl)
    aux = sh.mean_all(aux)
    el = ids - sh.model_rank * e_loc                   # (n, k) local ids
    mine = (el >= 0) & (el < e_loc)
    flat_el = torch.where(mine, el, e_loc).reshape(-1)
    tok = torch.arange(n, device=x.device).repeat_interleave(m.top_k)
    wgt = (w * mine).reshape(-1)
    cap = int(-(-n * m.top_k // tp) * m.capacity_factor)
    order, el_s, pos = _bucket_positions(flat_el, e_loc + 1)
    ok = (el_s < e_loc) & (pos < cap)
    _note_drops(mine.sum(), ((el_s < e_loc) & ~ok).sum())
    slot = torch.where(ok, el_s * cap + pos, e_loc * cap)
    xe = _put(e_loc * cap + 1, d, slot, xf[tok[order]])
    ye = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                     xe[:-1].reshape(e_loc, cap, d), pol, fl).reshape(-1, d)
    got = torch.where(ok[:, None],
                      ye[torch.clamp(slot, 0, e_loc * cap - 1)], 0.0)
    out = torch.zeros_like(xf).index_add(
        0, tok[order], got * wgt[order][:, None].to(x.dtype))
    out = sh.psum_model(out)
    if m.n_shared:
        out = out + _shared_ffn(p, xf, cfg, pol)
    return out.reshape(b, s, d), aux


def moe_block(p, x, cfg: ModelConfig, pol: NumericsPolicy, rt=None):
    """The reference without a mesh; with one (a :class:`MoERuntime`, or
    the model's stream layout), ``moe_ep`` when the stream's sequence is
    split over the model axis or its length divides that axis (the rank
    then takes its block and gathers the outputs back), else
    ``moe_ep_replicated``."""
    if rt is None or rt.mesh is None:
        return moe_reference(p, x, cfg, pol)
    sh = _layout(rt, False)
    if sh.seq:
        return moe_ep(p, x, cfg, pol, sh)
    if x.shape[1] % sh.tp != 0:     # decode / tiny sequences
        return moe_ep_replicated(p, x, cfg, pol, sh)
    y, aux = moe_ep(p, sh.with_seq(True).own_seq(x), cfg, pol,
                    sh.with_seq(True))
    return sh.with_seq(True).gather_seq(y), aux
