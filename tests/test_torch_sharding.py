"""The port's sharding rule table (``repro_torch/distributed/sharding.py``)
against the reference's (``src/repro/distributed/sharding.py``).

The counterparts of ``tests/test_distributed.py``'s four spec tests, on the
port's trees (``models.weights.param_shapes``, ``init_caches`` on the meta
device: nothing allocated), under the reference's ``_FakeMesh`` (``data``
16, ``model`` 16); then every arch's parameter and cache specs equal to the
reference's leaf for leaf (``PartitionSpec`` read as a tuple), the batch
specs and ``explain``'s bytes per device too, and ``shardings`` refusing
with the ROADMAP item that ports it.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro import configs as ref_configs
from repro.distributed import sharding as ref_shd
from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import init_lm as ref_init_lm
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models.transformer import init_caches
from repro_torch.models.weights import param_dtypes, param_shapes


class _FakeMesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def _flat(tree, prefix=()) -> dict:
    """The port's nested dicts -> {"/"-joined path: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-name tuple as the name (PartitionSpec's
    own reading)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in tuple(spec))


def _ref_flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = ref_configs.get(arch)
    return jax.eval_shape(lambda k: ref_init_lm(k, cfg),
                          jax.random.PRNGKey(0))


def _ref_cache_shapes(arch, batch, max_len):
    cfg = ref_configs.get(arch)
    return jax.eval_shape(lambda: ref_init_caches(cfg, batch, max_len))


# ---------------------------------------------------------- spec rules -----
def test_param_specs_cover_all_archs():
    """Every parameter of every full arch gets a spec whose sharded dims
    divide evenly — the divisibility contract of the rule table."""
    mesh = _FakeMesh()
    for arch in configs.ARCHS:
        shapes = param_shapes(configs.get(arch))
        specs = shd.param_specs(shapes, mesh)
        flat_specs = _flat(specs)
        for path, shape in _flat(shapes).items():
            spec = flat_specs[path]
            assert len(spec) <= len(shape), (arch, path, shape, spec)
            for dim, ax in zip(shape, spec):
                if ax is None:
                    continue
                size = (np.prod([mesh.shape[a] for a in ax])
                        if isinstance(ax, tuple) else mesh.shape[ax])
                assert dim % size == 0, (arch, path, shape, spec)


def test_param_specs_shard_big_weights():
    specs = _flat(shd.param_specs(param_shapes(configs.get("qwen2-72b")),
                                  _FakeMesh()))
    # all attention + mlp weights must be 2-way sharded
    wq = [v for k, v in specs.items() if k.endswith("attn/wq")]
    assert wq and all(s == (None, "data", "model") for s in wq)
    wo = [v for k, v in specs.items() if k.endswith("mlp/wo")]
    assert wo and all(s == (None, "model", "data") for s in wo)


def test_cache_specs_sequence_sharded():
    caches = init_caches(configs.get("qwen2-72b"), 128, 1024, device="meta")
    k_spec = shd.cache_specs(caches, _FakeMesh())["stage_0"]["k"]
    assert k_spec[1] == "data"                  # batch over dp
    assert k_spec[2] == "model"                 # sequence over model


def test_cache_specs_b1_shards_seq_over_all():
    caches = init_caches(configs.get("zamba2-2.7b"), 1, 4096, device="meta")
    assert shd.cache_specs(caches, _FakeMesh())["shared"]["k"][2] == \
        ("data", "model")


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_specs_equal_the_reference_leaf_for_leaf(arch):
    mesh = _FakeMesh()
    ref = _ref_flat(ref_shd.param_specs(_ref_param_shapes(arch), mesh))
    got = _flat(shd.param_specs(param_shapes(configs.get(arch)), mesh))
    assert got.keys() == ref.keys()
    assert {p: _norm(s) for p, s in ref.items()} == got
    for batch, max_len in ((128, 1024), (1, 4096), (3, 50)):
        ref = _ref_flat(ref_shd.cache_specs(
            _ref_cache_shapes(arch, batch, max_len), mesh))
        got = _flat(shd.cache_specs(init_caches(
            configs.get(arch), batch, max_len, device="meta"), mesh))
        assert {p: _norm(s) for p, s in ref.items()} == got, \
            (arch, batch, max_len)


def test_batch_specs_equal_the_reference():
    mesh = _FakeMesh()
    for kind in ("train", "prefill", "decode"):
        ref = ref_shd.batch_specs(kind, mesh)
        assert shd.batch_specs(kind, mesh) == \
            {k: _norm(v) for k, v in ref.items()}
    with pytest.raises(ValueError):
        shd.batch_specs("sample", mesh)


def test_explain_bytes_per_device_equal_the_reference():
    mesh = _FakeMesh()
    arch = "deepseek-v3-671b"
    ref_shapes = _ref_param_shapes(arch)
    ref = ref_shd.explain(ref_shapes, ref_shd.param_specs(ref_shapes, mesh),
                          mesh)
    cfg = configs.get(arch)
    shapes = param_shapes(cfg)
    got = shd.explain(shapes, shd.param_specs(shapes, mesh), mesh,
                      param_dtypes(cfg))
    assert sorted((p, tuple(s), b) for p, s, _, b in ref) == \
        sorted((p, s, b) for p, s, _, b in got)
    # a tree of tensors carries its own dtypes
    caches = init_caches(cfg, 16, 64, device="meta")
    rows = shd.explain(caches, shd.cache_specs(caches, mesh), mesh)
    assert rows and all(b > 0 for *_, b in rows)


def test_rules_read_only_axis_sizes():
    """A ``launch.mesh.Mesh`` serves as well as any object with a
    ``shape`` mapping: on a one-entry mesh every dim divides, so the
    model-sharded dims keep their axis."""
    mesh = make_data_mesh(["cpu"])
    spec = shd.param_spec("stage_0/attn/wq", (2, 64, 128), mesh,
                          fsdp=("data",), model="data")
    assert spec == (None, "data", "data")


def test_shardings_wait_for_item_6():
    """``shardings`` binds specs to a mesh bound to torch.distributed
    (item 6b: ``tests/test_torch_distributed.py``); a mesh of axis sizes
    alone is refused."""
    specs = shd.param_specs(param_shapes(configs.get("qwen3-0.6b")),
                            _FakeMesh())
    with pytest.raises(ValueError, match="bound"):
        shd.shardings(specs, _FakeMesh())
