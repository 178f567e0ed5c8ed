"""The sharding rules, meshes and input specs against the JAX package's,
with no ranks: for all 10 archs at their published widths, the port's
``param_specs``, ``cache_specs`` and ``cache_specs(paged=True)`` equal the
reference's leaf by leaf and path by path (the port's trees on the
``meta`` device, the reference's from ``jax.eval_shape``: nothing is
allocated); ``batch_specs`` and the three input-structure functions give
the same shapes and dtypes for every arch × valid cell (32 cells:
``train_4k``, ``prefill_32k`` and ``decode_32k`` for every arch, and
``long_500k`` for the sub-quadratic ones); ``data_axes``,
``make_host_mesh(device="cpu")`` and the round trip of ``shard_tree`` /
``gather_tree`` on it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import input_specs as jin
from repro.nn import model as jmodel
from repro.nn.config import SHAPE_CELLS as JCELLS
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import input_specs as tin
from repro_torch.launch import mesh as tmesh
from repro_torch.nn import model as tmodel
from repro_torch.nn.config import SHAPE_CELLS

ARCHS = list(tconfigs.ARCHS)
DECODE_B, DECODE_LEN, PAGE = 128, 32768, 128


def _cells(cfg):
    """The valid cells of an arch (``repro.launch.dryrun.valid_cells``'s
    rule; that module forces 512 host devices at import)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


CELLS = [(a, c) for a in ARCHS
         for c in _cells(tconfigs.get_config(a))]


def _ref_specs(tree):
    return {jsh._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_specs(tree):
    out = {}
    tsh.map_with_path(lambda p, s: out.__setitem__(p, tuple(s)), tree)
    return out


def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def test_the_cells_are_32():
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tp = tmodel.init_params(0, tcfg, device="meta")
    got, want = _port_specs(tsh.param_specs(tp)), _ref_specs(
        jsh.param_specs(jp))
    shapes = {}
    tsh.map_with_path(lambda p, t: shapes.__setitem__(p, tuple(t.shape)),
                      tp)
    jshapes = {jsh._path_str(p): tuple(x.shape) for p, x in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert shapes == jshapes
    assert got == want
    assert any(s for s in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    enc = DECODE_LEN if tcfg.family in ("encdec", "audio") else None
    jc = jax.eval_shape(lambda: jmodel.init_decode_caches(
        jcfg, DECODE_B, DECODE_LEN, jnp.bfloat16, enc_len=enc))
    tc = tmodel.init_decode_caches(tcfg, DECODE_B, DECODE_LEN,
                                   torch.bfloat16, enc_len=enc,
                                   device="meta")
    assert _port_specs(tsh.cache_specs(tc)) == _ref_specs(
        jsh.cache_specs(jc))
    assert _port_specs(tsh.cache_specs(tc, ("pod", "data"))) == \
        _ref_specs(jsh.cache_specs(jc, ("pod", "data")))
    if tcfg.family not in tmodel.PAGED_FAMILIES:
        return
    nb = 1 + DECODE_B * (DECODE_LEN // PAGE)
    jpc = jax.eval_shape(lambda: jmodel.init_paged_caches(
        jcfg, nb, PAGE, jnp.bfloat16))
    tpc = tmodel.init_paged_caches(tcfg, nb, PAGE, torch.bfloat16,
                                   device="meta")
    assert _port_specs(tsh.cache_specs(tpc, paged=True)) == _ref_specs(
        jsh.cache_specs(jpc, paged=True))


def _struct(tree):
    out = {}
    tsh.map_with_path(lambda p, t: out.__setitem__(
        p, (tuple(t.shape), str(t.dtype).removeprefix("torch."))), tree)
    return out


def _jstruct(tree):
    return {jsh._path_str(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,cell", CELLS)
def test_input_specs_equal_reference(arch, cell):
    jcfg, tcfg = _cfgs(arch)
    jcell, tcell = JCELLS[cell], SHAPE_CELLS[cell]
    got, want = tin.input_specs(tcfg, tcell), jin.input_specs(jcfg, jcell)
    assert all(t.device.type == "meta" for t in got.values())
    assert _struct(got) == _jstruct(want)
    assert _struct(tin.batch_struct(tcfg, tcell)) == _jstruct(
        jin.batch_struct(jcfg, jcell))
    assert _struct(tin.decode_struct(tcfg, tcell)) == _jstruct(
        jin.decode_struct(jcfg, jcell))
    for axes in (("data",), ("pod", "data"), ()):
        assert _port_specs(tsh.batch_specs(got, axes)) == _ref_specs(
            jsh.batch_specs(want, axes))


def test_concrete_structs_are_zeros_and_ones():
    from repro.nn.config import ShapeCell as JCell
    from repro_torch.nn.config import ShapeCell
    for arch in ("seamless-m4t-medium", "internvl2-76b", "olmo-1b"):
        jcfg = jconfigs.reduced(jconfigs.get_config(arch))
        tcfg = tconfigs.reduced(tconfigs.get_config(arch))
        for kind in ("train", "decode"):
            jcell, tcell = JCell("s", 8, 2, kind), ShapeCell("s", 8, 2, kind)
            fn = "decode_struct" if kind == "decode" else "batch_struct"
            got = getattr(tin, fn)(tcfg, tcell, abstract=False,
                                   device="cpu")
            want = getattr(jin, fn)(jcfg, jcell, abstract=False)
            assert sorted(got) == sorted(want)
            for k in got:
                assert np.array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32)), k


def test_partition_spec_normalizes_like_jax():
    P, JP = tsh.PartitionSpec, jax.sharding.PartitionSpec
    for parts in [(("data",), None), (("pod", "data"), "model"), (),
                  (None, "data", "model"), ((), None)]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts


def test_host_mesh_and_shard_round_trip():
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_host_mesh(device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data",)
        assert tmesh.data_axes(mesh) == ("data",)
        assert tsh.axis_size(mesh, "model") == 1
        cfg = tconfigs.reduced(tconfigs.get_config("deepseek-v2-lite-16b"))
        p = tmodel.init_params(0, cfg, device="cpu")
        specs = tsh.param_specs(p)
        back = tsh.gather_tree(tsh.shard_tree(p, specs, mesh), specs, mesh)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(p),
                                                      _leaves(back)))
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            tmodel.Runtime(mesh=(1, 1))
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="needs an initialized process"):
        tmesh.make_production_mesh(device="cpu")
    assert tmesh.data_axes(type("M", (), {"mesh_dim_names": (
        "pod", "data", "model")})()) == ("pod", "data")


def _leaves(tree):
    from repro_torch.pytree import tree_leaves
    return tree_leaves(tree)
