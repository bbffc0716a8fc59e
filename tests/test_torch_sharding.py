"""PyTorch port, the sharding rules (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``), entry by
entry: every leaf's partition spec of the twelve full configs' abstract
parameters, decode caches and batches, on the reference's logical
meshes (16x16, 2x16x16 with "pod", 32x8), the reference's on
``jax.sharding.AbstractMesh`` (no devices), the port's on
``launch.mesh.LogicalMesh``. Then ``tests/test_sharding.py``'s random
shapes (hypothesis) as parity with the reference's ``spec_for_param``
and ``spec_for_input``, and the shard arithmetic the dry-run reckons
bytes with against the reference's ``NamedSharding.shard_shape``.
"""
import functools

import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh

from repro.configs import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M

torch.set_num_threads(1)

ARCHS = list_archs()
MESHES = {"16x16": dict(), "2x16x16": dict(multi_pod=True),
          "32x8": dict(shape=(32, 8))}
DECODE = [n for n, s in INPUT_SHAPES.items() if s.kind == "decode"]


def _meshes(name):
    """(the reference's AbstractMesh, the port's LogicalMesh)."""
    port = make_production_mesh(**MESHES[name])
    ref = AbstractMesh(tuple(port.shape.values()), port.axis_names)
    return ref, port


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _ref_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {tuple(_key(k) for k in path): tuple(s.spec)
            for path, s in leaves}


def _port_specs(tree):
    out = {}
    SH.tree_map_with_path(lambda p, s: out.__setitem__(p, tuple(s.spec)),
                          tree)
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(the reference's eval_shape tree, the port's meta tree)."""
    return (JM.abstract_params(jget_config(arch)),
            M.abstract_params(get_config(arch)))


@functools.lru_cache(maxsize=None)
def _caches(arch, shape):
    return (JM.abstract_cache(jget_config(arch), J_INPUT_SHAPES[shape]),
            M.abstract_cache(get_config(arch), INPUT_SHAPES[shape]))


@pytest.mark.parametrize("fsdp,ep", [(True, False), (False, False),
                                     (True, True), (False, True)])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_shardings_match_reference(arch, mesh, fsdp, ep):
    jm, pm = _meshes(mesh)
    jp, pp = _params(arch)
    want = _ref_specs(JS.params_shardings(jp, jm, fsdp=fsdp, ep_experts=ep))
    got = _port_specs(SH.params_shardings(pp, pm, fsdp=fsdp, ep_experts=ep))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, shape, mesh):
    jm, pm = _meshes(mesh)
    jc, pc = _caches(arch, shape)
    for kw in ({}, dict(seq_over_dp=True), dict(heads_model=True)):
        want = _ref_specs(JS.cache_shardings(jc, jm, **kw))
        got = _port_specs(SH.cache_shardings(pc, pm, **kw))
        assert got == want, kw


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_match_reference(arch, shape):
    jb = JM.input_specs(jget_config(arch), J_INPUT_SHAPES[shape])
    pb = M.input_specs(get_config(arch), INPUT_SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in pb.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
    for mesh in MESHES:
        jm, pm = _meshes(mesh)
        for rep in (False, True):
            want = _ref_specs(JS.batch_shardings(jb, jm, replicate=rep))
            got = _port_specs(SH.batch_shardings(pb, pm, replicate=rep))
            assert got == want, (mesh, rep)


dims = st.lists(st.sampled_from([1, 2, 3, 8, 16, 32, 128, 256, 4096,
                                 5120, 14336, 151936]),
                min_size=1, max_size=5).map(tuple)


@given(dims, st.sampled_from(list(MESHES)), st.booleans())
@settings(max_examples=120, deadline=None)
def test_spec_rules_match_reference_on_random_shapes(shape, mesh, skip0):
    jm, pm = _meshes(mesh)
    assert tuple(SH.spec_for_param(shape, pm, skip_axis0=skip0)) == \
        tuple(JS.spec_for_param(shape, jm, skip_axis0=skip0))
    assert tuple(SH.spec_for_input(shape, pm)) == \
        tuple(JS.spec_for_input(shape, jm))


@given(dims, st.sampled_from(list(MESHES)))
@settings(max_examples=80, deadline=None)
def test_shard_shape_matches_reference(shape, mesh):
    jm, pm = _meshes(mesh)
    spec = SH.spec_for_param(shape, pm)
    want = jax.sharding.NamedSharding(jm, JS.spec_for_param(shape, jm)) \
        .shard_shape(shape)
    assert SH.shard_shape(shape, SH.NamedSharding(pm, spec)) == tuple(want)


def test_shard_nbytes_hand_reckoned():
    """mixtral-8x7b's embedding (32000, 4096) bf16 on 16x16 shards as
    ('model', 'data'): (2000, 256) a rank, 1,024,000 bytes."""
    _, pm = _meshes("16x16")
    _, pp = _params("mixtral-8x7b")
    sh = SH.params_shardings(pp, pm)
    assert tuple(sh["embed"].spec) == ("model", "data")
    assert SH.shard_nbytes({"e": pp["embed"]}, {"e": sh["embed"]}) == \
        2000 * 256 * 2


def test_activation_constraint_changes_nothing():
    _, pm = _meshes("16x16")
    h = torch.randn(32, 64, 8)
    SH.set_activation_mesh(pm)
    try:
        assert SH.constrain_activations(h) is h
    finally:
        SH.set_activation_mesh(None)
