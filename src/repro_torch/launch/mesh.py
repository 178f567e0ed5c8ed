"""Meshes of ranks (``torch.distributed.device_mesh.DeviceMesh``).

``make_production_mesh`` keeps the JAX package's shapes and axis names:
single-pod ``(data=16, model=16)`` = 256 ranks; multi-pod ``(pod=2,
data=16, model=16)`` = 512 ranks, the ``pod`` axis pure data parallel.  It
needs a process group of exactly that many ranks (``torchrun`` or
``init_process_group``) and never shrinks the mesh.

A mesh on ``cuda`` runs NCCL with one card per rank (rank ``r`` on card
``r`` modulo the cards of its host); a mesh with more ranks on one host
than it has cards raises.  Gloo is used only when the caller asks for the
CPU.  Without an initialized process group a one-rank mesh starts its own
(``tcp://localhost`` on a free port).
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from ..devices import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_single_rank(device="cuda"):
    """A one-rank default process group over ``device`` (NCCL on a card,
    gloo on the CPU), unless one is initialized already."""
    device = resolve_device(device)
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        _backend(device), init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=600))


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group, which must hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if device.type == "cuda" and n > torch.cuda.device_count():
            raise RuntimeError(
                f"a mesh of {n} ranks on a host with "
                f"{torch.cuda.device_count()} CUDA card(s): a mesh never "
                f"puts two ranks on one card")
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs an initialized process group "
                f"of {n} ranks (torchrun, or init_process_group with its "
                f"address, world size and rank)")
        _init_single_rank(device)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh {dict(zip(axes, shape))} needs {n} "
                         f"ranks; the process group has {world}")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"{local} ranks on a host with {cards} CUDA card(s): a "
                f"mesh never puts two ranks on one card")
        config = getattr(dist, "get_backend_config", dist.get_backend)()
        if "nccl" not in str(config):
            raise RuntimeError("a mesh on cuda runs NCCL; the process group "
                               f"is {dist.get_backend()!r}")
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % cards)))
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def data_axes(mesh) -> tuple:
    """Axes carrying the global batch."""
    return tuple(a for a in (mesh.mesh_dim_names or ())
                 if a in ("pod", "data"))


def make_host_mesh(device="cuda"):
    """The one-rank ``("data",)`` mesh of this host's card (or of the CPU
    when the caller asks)."""
    return make_mesh((1,), ("data",), device)
