"""The port's copied sharding rules, logical-axis context and mesh
descriptors held equal to the JAX package's, on the CPU, without ranks.

The JAX rules read only a mesh's ``axis_names`` and ``shape``, so both
packages are called on the same duck-typed meshes: (16, 16), (2, 16, 16),
(2, 2), (4, 2) and (1, 2).  Where the JAX functions wrap a spec in a
``NamedSharding`` (which needs real devices) the test swaps that
constructor for one that returns the spec.  Every config in ``configs/``
at full size: the port's meta ``abstract_params`` / ``abstract_train_state``
against the JAX package's ``eval_shape`` (names, shapes, dtypes), then
``tree_param_specs`` (FSDP and not), ``train_state_shardings``,
``batch_shardings``, ``cache_shardings``, the ZeRO-1 state specs and
``_scatter_dim`` of ``training/manual_dp.py``; ``logical_to_spec`` under
``DEFAULT_RULES`` and ``MANUAL_RULES``; a property case mirroring
``tests/test_substrate.py::test_param_specs_always_valid``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config, list_configs
from repro.models import model as JM
from repro.sharding import ctx as jctx, rules as jrules
from repro.training import manual_dp as jmdp, train_step as JTS
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.sharding import ctx as tctx, rules as trules
from repro_torch.training import manual_dp as tmdp, train_step as TTS
from repro_torch.tree import flatten

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 2), ("data", "model"))]
ARCHS = list_configs()
TORCH_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int32: "int32"}


@dataclasses.dataclass(frozen=True)
class DuckMesh:
    axis_names: tuple
    shape: dict


def _meshes():
    return [DuckMesh(tuple(names), dict(zip(names, sizes))) for sizes, names in MESHES]


def _ids(m):
    return "x".join(str(m.shape[a]) for a in m.axis_names)


@pytest.fixture(autouse=True)
def _specs_not_shardings(monkeypatch):
    """The JAX rules' ``NamedSharding`` wants real devices; the specs are
    what is compared."""
    monkeypatch.setattr(jrules, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jmdp, "NamedSharding", lambda mesh, spec: spec)


def _spec(p):
    """A JAX spec as the port writes one: a plain tuple."""
    return tuple(p)


def _specs(tree):
    """A JAX spec tree as the port writes it: the same dicts and tuples,
    each spec a plain tuple."""
    return jax.tree.map(_spec, tree, is_leaf=lambda x: isinstance(x, P))


_ABSTRACT = {}


def _abstract(arch):
    """(JAX eval_shape params, the port's meta params) of the full config."""
    if arch not in _ABSTRACT:
        _ABSTRACT[arch] = (JM.abstract_params(jget_config(arch)),
                           TM.abstract_params(tget_config(arch)))
    return _ABSTRACT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_state_equal_jax(arch):
    """Names, shapes and dtypes of ``abstract_params`` and
    ``abstract_train_state`` at full size; nothing is allocated."""
    jp, tp = _abstract(arch)
    jf = flatten(jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp,
                              is_leaf=lambda a: hasattr(a, "shape")))
    tf = {k: (tuple(t.shape), TORCH_DTYPES[t.dtype]) for k, t in flatten(tp).items()}
    assert tf == jf
    assert all(t.device.type == "meta" for t in flatten(tp).values())
    js = JTS.abstract_train_state(jget_config(arch))
    ts = TTS.abstract_train_state(tget_config(arch))
    for part in ("master", "m", "v"):
        want = flatten(jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                                    js.opt_state[part], is_leaf=lambda a: hasattr(a, "shape")))
        got = {k: (tuple(t.shape), TORCH_DTYPES[t.dtype])
               for k, t in flatten(ts.opt_state[part]).items()}
        assert got == want, part
    assert ts.step == 0 and (js.step.shape, str(js.step.dtype)) == ((), "int32")


@pytest.mark.parametrize("mesh", _meshes(), ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_jax(arch, mesh):
    jp, tp = _abstract(arch)
    hybrid = jget_config(arch).family == "hybrid"
    for fsdp in (True, False):
        want = flatten(jax.tree.map(_spec, jrules.tree_param_specs(jp, mesh, hybrid=hybrid,
                                                                   fsdp=fsdp),
                                    is_leaf=lambda x: isinstance(x, P)))
        got = flatten(trules.tree_param_specs(tp, mesh, hybrid=hybrid, fsdp=fsdp))
        assert got == want, fsdp
    js = jrules.train_state_shardings(JTS.abstract_train_state(jget_config(arch)), mesh,
                                      hybrid=hybrid)
    ts = trules.train_state_shardings(TTS.abstract_train_state(tget_config(arch)), mesh,
                                      hybrid=hybrid)
    assert _spec(js.step) == ts.step == ()
    for part in ("master", "m", "v"):
        assert flatten(ts.opt_state[part]) == flatten(jax.tree.map(
            _spec, js.opt_state[part], is_leaf=lambda x: isinstance(x, P)))
    assert flatten(ts.params) == flatten(jax.tree.map(_spec, js.params,
                                                      is_leaf=lambda x: isinstance(x, P)))


@pytest.mark.parametrize("mesh", _meshes(), ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_equal_jax(arch, mesh):
    """``training/manual_dp.py``'s state placement: parameters model-only,
    master / m / v also over the data axes at ``_scatter_dim``."""
    _, jsh = jmdp.make_manual_dp_train_step(jget_config(arch), mesh)
    ts, _ = tmdp.state_specs(tget_config(arch), mesh)
    conv = lambda tree: flatten(jax.tree.map(_spec, tree, is_leaf=lambda x: isinstance(x, P)))
    assert flatten(ts.params) == conv(jsh.params)
    for part in ("master", "m", "v"):
        assert flatten(ts.opt_state[part]) == conv(jsh.opt_state[part])


@pytest.mark.parametrize("mesh", _meshes(), ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for b in (1, 3, 8, 32, 512):
        jb = {"tokens": jax.ShapeDtypeStruct((b, 128), np.int32),
              "step": jax.ShapeDtypeStruct((), np.int32)}
        tb = {"tokens": torch.empty((b, 128), dtype=torch.int32, device="meta"),
              "step": torch.empty((), dtype=torch.int32, device="meta")}
        assert trules.batch_shardings(tb, mesh) == jax.tree.map(
            _spec, jrules.batch_shardings(jb, mesh), is_leaf=lambda x: isinstance(x, P))
    for b, length in ((4, 128), (32, 1024)):
        jc = jax.eval_shape(lambda: JM.init_cache(jcfg, b, length))
        tc = TM.init_cache(tcfg, b, length, device=torch.device("meta"))
        assert trules.cache_shardings(tc, mesh) == _specs(jrules.cache_shardings(jc, mesh)), \
            (b, length)


LOGICAL = [(("batch", "seq", "model"), (8, 128, 1024)),
           (("batch", "seq_model", "none"), (3, 512, 64)),
           (("batch", "heads", None, "none"), (32, 16, 128, 64)),
           (("expert", "data_only", "model"), (128, 48, 768)),
           (("batch", "seq"), (2, 7)), (("batch",), (64,)),
           (("heads", "model", "expert"), (12, 2, 3))]


@pytest.mark.parametrize("mesh", _meshes(), ids=_ids)
@pytest.mark.parametrize("which", ["DEFAULT_RULES", "MANUAL_RULES"])
def test_logical_to_spec_equal_jax(mesh, which):
    jr = getattr(jctx, which) if which == "DEFAULT_RULES" else jmdp.MANUAL_RULES
    tr = getattr(tctx, which) if which == "DEFAULT_RULES" else tmdp.MANUAL_RULES
    assert tr == jr
    with jctx.use_mesh(mesh, jr), tctx.use_mesh(mesh, tr):
        for axes, shape in LOGICAL:
            assert tctx.logical_to_spec(axes, shape) == \
                _spec(jctx.logical_to_spec(axes, shape)), (axes, shape)
            for a, s in zip(axes, shape):
                assert tctx._resolve(a, mesh, s) == jctx._resolve(a, mesh, s)
        for a in mesh.axis_names:
            assert tctx.axis_size(a) == jctx.axis_size(a) == mesh.shape[a]
        assert tctx.get_mesh() is mesh and tctx.get_rules() == jctx.get_rules()
    assert tctx.get_mesh() is None and tctx.axis_size("model") == 1
    x = torch.ones(2, 3)
    assert tctx.constrain(x, "batch", "model") is x


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 16, 32])
def test_scatter_dim_equal_jax(dp):
    shapes = [s for arch in ARCHS for s in
              (tuple(t.shape) for t in flatten(_abstract(arch)[1]).values())]
    shapes += [(3, 5), (5,), (), (7, 32, 2)]
    for shape in shapes:
        assert tmdp._scatter_dim(shape, dp) == jmdp._scatter_dim(shape, dp), shape


def test_production_and_local_mesh_descriptors():
    """``make_production_mesh`` is the JAX mesh's shape alone; the
    rules read a ``Mesh`` as they read JAX's; one rank's local mesh is
    (1, 1) with its groups."""
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, dict(single.shape), single.size) == \
        (("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, dict(multi.shape), multi.size) == \
        (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512)
    jp, tp = _abstract("granite_8b")
    assert flatten(trules.tree_param_specs(tp, multi)) == flatten(jax.tree.map(
        _spec, jrules.tree_param_specs(jp, DuckMesh(multi.axis_names, dict(multi.shape))),
        is_leaf=lambda x: isinstance(x, P)))
    assert not hasattr(tmesh, "PEAK_FLOPS_BF16") and not hasattr(tmesh, "HBM_BW")


@given(st.sampled_from([1024, 2048, 4608, 6144]),
       st.sampled_from([768, 1408, 10752, 18432, 151936]))
@settings(max_examples=20, deadline=None)
def test_param_specs_always_valid(d1, d2):
    """The port's ``param_spec`` on the production mesh divides every dim
    it shards, and equals the JAX package's."""
    mesh = tmesh.make_production_mesh()
    spec = trules.param_spec("blocks/mlp/wi", (48, d1, d2), mesh, stacked_prefix=1)
    for dim, ax in zip((48, d1, d2), spec):
        axes = trules.entry_axes(ax)
        assert dim % int(np.prod([mesh.shape[a] for a in axes] or [1])) == 0
    assert spec == _spec(jrules.param_spec("blocks/mlp/wi", (48, d1, d2), DuckMesh(
        mesh.axis_names, dict(mesh.shape)), stacked_prefix=1))


def test_tp_rules_moved_into_sharding_rules():
    """One copy of the Megatron placement: ``core/tp_rules`` re-exports
    ``sharding/rules``' and ``stage_block_specs`` equals the JAX one."""
    from repro_torch.core import tp_rules
    assert tp_rules.tp_body_dim is trules.tp_body_dim
    assert tp_rules.tp_local_slice is trules.tp_local_slice
    jp, tp = _abstract("granite_8b")
    blocks_j = jax.tree.map(lambda a: jax.ShapeDtypeStruct((2, *a.shape), a.dtype),
                            jp["blocks"])
    blocks_t = {k: v for k, v in tp["blocks"].items()}
    blocks_t = jax.tree.map(lambda t: torch.empty((2, *t.shape), device="meta"), blocks_t)
    for tp_axis in ("tp", None):
        want = flatten(jax.tree.map(_spec, jrules.stage_block_specs(blocks_j, tp_axis=tp_axis),
                                    is_leaf=lambda x: isinstance(x, P)))
        assert flatten(trules.stage_block_specs(blocks_t, tp_axis=tp_axis)) == want
