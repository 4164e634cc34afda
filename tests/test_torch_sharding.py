"""The port's grid layouts (``utils/sharding.py``, ``launch/mesh.py``,
``launch/sharding_plan.py``, ``training/optimizer.py`` ``opt_state_specs``)
against the JAX package's, on the CPU.

The spec functions need only a grid's names and shape, so they are held to
JAX's on ``Grid.abstract`` against ``jax.sharding.AbstractMesh`` of the same
shape, (4, 2), (2, 2, 2) and (16, 16), with one CPU device: every leaf's spec
equal to JAX's ``PartitionSpec`` as a tuple, by path.  The parameter trees
are the port's own SMOKE init (every arch) against JAX's ``eval_shape`` of
its init; the decode caches are JAX's ``empty_caches`` shapes.  The blocks
(``cut``, ``gather``) run in one gloo world of 8 ranks
(``tests/torch_mesh_worlds.py``): each rank's block is its slice of the
array (the ``comm.shard_len`` layout where a dim does not divide), the
gather returns the array on every rank, and its ``all_gather`` calls and
bytes are counted.
"""
from __future__ import annotations

import functools
import os

import jax
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread a test process)
from jax.sharding import AbstractMesh

from repro.launch import sharding_plan as jax_plan
from repro.models.model import build_model as jax_build_model
from repro.models.model import get_config as jax_get_config
from repro.training.optimizer import opt_state_specs as jax_opt_state_specs
from repro.utils import sharding as jax_sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding_plan
from repro_torch.launch.world import run_world
from repro_torch.models.model import ARCHS, build_model, get_config
from repro_torch.training.optimizer import opt_state_specs
from repro_torch.utils import sharding
from repro_torch.utils.sharding import Grid

HERE = os.path.dirname(__file__)
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


def _flat(tree, path=(), seqs=False):
    """``{"/"-joined path: leaf}`` of nested dicts (and, with ``seqs``, lists
    and tuples: a cache's ``rec`` state; spec tuples are leaves otherwise)."""
    if isinstance(tree, dict) or (seqs and isinstance(tree, (list, tuple))):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, path + (str(k),), seqs))
        return out
    return {"/".join(path): tree}


def _spec(x):
    """A JAX ``NamedSharding``/``PartitionSpec`` or a port ``Placement``/tuple,
    as a tuple of entries."""
    if hasattr(x, "spec"):
        x = x.spec
    return tuple(x)


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    m = jax_build_model(jax_get_config(arch, smoke=True))
    return jax.eval_shape(lambda k: m.init(k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return build_model(get_config(arch, smoke=True)).init(0, device="cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_jax(arch):
    want = _flat(jax_sharding.param_specs(_jax_shapes(arch)))
    got = _flat(sharding.param_specs(_port_params(arch)))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-moe-16b", "minicpm3-4b",
                                  "xlstm-350m", "whisper-small"])
def test_param_shardings_match_jax(arch, mesh):
    shape, names = MESHES[mesh]
    want = _flat(jax_sharding.param_shardings(AbstractMesh(shape, names), _jax_shapes(arch)))
    got = _flat(sharding.param_shardings(Grid.abstract(shape, names), _port_params(arch)))
    assert sorted(got) == sorted(want)
    for path, sh in want.items():
        assert _spec(got[path]) == _spec(sh), path
        assert got[path].shape == tuple(_flat(_jax_shapes(arch))[path].shape)


def test_spec_for_path_pads_and_cuts():
    """JAX's padding of a layer stack and cutting to a lower rank, and no rule."""
    for path, ndim in [("stack/sub0/moe/experts/w_up", 4), ("embed", 1),
                       ("stack/sub0/attn/wq_b", 2), ("final_norm/scale", 1),
                       ("stack/sub0/mixer/conv_w", 3), ("router/w", 3)]:
        assert sharding.spec_for_path(path, ndim) == tuple(
            jax_sharding.spec_for_path(path, ndim)), path


_BATCHES = {"b8": {"tokens": np.zeros((8, 32), np.int32),
                   "loss_mask": np.zeros((8, 32), np.float32)},
            "b1": {"tokens": np.zeros((1, 64), np.int32)},
            "b6_img": {"tokens": np.zeros((6, 16), np.int32),
                       "img_embed": np.zeros((6, 4, 32), np.float32)},
            "b256": {"tokens": np.zeros((256, 8), np.int32), "scalar": np.zeros((), np.int32)}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", list(_BATCHES))
def test_batch_specs_match_jax(batch, mesh):
    shape, names = MESHES[mesh]
    b = _BATCHES[batch]
    want = jax_plan.batch_specs(AbstractMesh(shape, names), b)
    got = sharding_plan.batch_specs(Grid.abstract(shape, names),
                                    {k: torch.from_numpy(v) for k, v in b.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert _spec(got[k]) == _spec(want[k]), k


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta_tree(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


@functools.lru_cache(maxsize=None)
def _jax_caches(arch, batch):
    m = jax_build_model(jax_get_config(arch, smoke=True))
    return jax.eval_shape(lambda: m.empty_caches(batch, 16))


@pytest.mark.parametrize("seq", [False, True], ids=["batch", "seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-1.2b", "minicpm3-4b", "xlstm-350m"])
def test_cache_specs_match_jax(arch, mesh, seq):
    shape, names = MESHES[mesh]
    caches = _jax_caches(arch, 1 if seq else 4)
    want = _flat(jax_plan.cache_specs(AbstractMesh(shape, names), caches, seq_sharded=seq),
                 seqs=True)
    got = _flat(sharding_plan.cache_specs(Grid.abstract(shape, names), _meta_tree(caches),
                                          seq_sharded=seq), seqs=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _spec(got[k]) == _spec(want[k]), k


def test_port_caches_take_jax_paths():
    """The port's own decode caches (non-hybrid) have JAX's paths and shapes, so
    the cache rules see the same trees."""
    for arch in ("llama3-8b", "minicpm3-4b", "xlstm-350m"):
        m = build_model(get_config(arch, smoke=True))
        got = _flat(m.empty_caches(4, 16, device="meta"), seqs=True)
        want = _flat(_jax_caches(arch, 4), seqs=True)
        assert sorted(got) == sorted(want), arch
        assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want), arch


@pytest.mark.parametrize("zero", [None, "data"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b", "zamba2-1.2b"])
def test_opt_state_specs_match_jax(arch, zero):
    want = jax_opt_state_specs(jax_sharding.param_specs(_jax_shapes(arch)), zero_axis=zero)
    got = opt_state_specs(sharding.param_specs(_port_params(arch)), zero_axis=zero)
    assert tuple(want["step"]) == got["step"] == ()
    for part in ("mu", "nu"):
        w, g = _flat(want[part]), _flat(got[part])
        assert sorted(w) == sorted(g)
        assert all(g[k] == tuple(w[k]) for k in w), part


def test_opt_state_specs_take_placements():
    """Placements in, placements out: the moments' ZeRO spec on the same grid
    and shape, the step a replicated scalar."""
    grid = Grid.abstract((4, 2), ("data", "model"))
    places = sharding.param_shardings(grid, _port_params("qwen3-4b"))
    got = opt_state_specs(places, zero_axis="data")
    want = opt_state_specs(sharding.param_specs(_port_params("qwen3-4b")), zero_axis="data")
    for k, pl in _flat(got["mu"]).items():
        assert pl.spec == _flat(want["mu"])[k] and pl.grid is grid
        assert pl.shape == _flat(places)[k].shape
    assert got["step"].spec == () and got["step"].shape == ()


def test_mesh_factories_and_their_refusals():
    """JAX's shapes and names; outside a world only a grid of one rank builds."""
    assert mesh_lib.DEBUG[False] == ((4, 2), ("data", "model"))
    assert mesh_lib.DEBUG[True] == ((2, 2, 2), ("pod", "data", "model"))
    assert mesh_lib.PRODUCTION[False] == ((16, 16), ("data", "model"))
    assert mesh_lib.PRODUCTION[True] == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="needs 8 ranks, the world has 1"):
        mesh_lib.make_debug_mesh()
    with pytest.raises(ValueError, match="needs 256 ranks"):
        mesh_lib.make_production_mesh()
    one = Grid((1, 1), ("data", "model"))
    assert one.coord == {"data": 0, "model": 0} and one.group("model") is None
    with pytest.raises(ValueError, match="distinct axis names"):
        Grid.abstract((2, 2), ("data", "data"))
    with pytest.raises(ValueError, match="no process groups"):
        Grid.abstract((4, 2), ("data", "model")).group("data")
    x = torch.arange(6.0)
    assert sharding.constrain(x, "dp", None) is x
    with sharding.use_mesh(one):
        assert sharding.current_mesh() is one
    assert sharding.current_mesh() is None


def _rng(seed):
    return np.random.default_rng(seed)


BLOCKS = {
    "even_2d": (_rng(1).standard_normal((8, 6)).astype(np.float32), (4, 2),
                ("data", "model"), ("data", "model")),
    "uneven_2d": (_rng(2).standard_normal((7, 5)).astype(np.float32), (4, 2),
                  ("data", "model"), ("data", "model")),
    "short_rows": (_rng(3).standard_normal((3, 4)).astype(np.float32), (4, 2),
                   ("data", "model"), ("data",)),
    "model_cols": (_rng(4).integers(-9, 9, (2, 9)).astype(np.int32), (4, 2),
                   ("data", "model"), (None, "model")),
    "pod_data": (_rng(5).standard_normal((10, 3)).astype(np.float32), (2, 2, 2),
                 ("pod", "data", "model"), (("pod", "data"), None)),
    "three_axes": (_rng(6).standard_normal((16, 4)).astype(np.float32), (2, 2, 2),
                   ("pod", "data", "model"), (("pod", "data"), "model")),
    "stacked_experts": (_rng(7).standard_normal((2, 8, 3, 5)).astype(np.float32), (4, 2),
                        ("data", "model"), (None, "model", None, None)),
    "replicated": (_rng(8).standard_normal((3, 3)).astype(np.float32), (4, 2),
                   ("data", "model"), ()),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blocks")
    return run_world("torch_mesh_worlds:small_world", 8, dict(blocks=BLOCKS),
                     workdir=tmp / "world8", timeout=240, pythonpath=[HERE])


def _coord_index(coord, axes, shape):
    idx = 0
    for a in axes:
        idx = idx * shape[a] + coord[a]
    return idx


@pytest.mark.parametrize("name", list(BLOCKS))
def test_cut_then_gather_is_the_identity(world, name):
    arr, shape, names, spec = BLOCKS[name]
    sizes = dict(zip(names, shape))
    spec = tuple(spec) + (None,) * (arr.ndim - len(spec))
    covered = np.zeros(arr.shape, np.int32)
    for r in world:
        b = r["blocks"][name]
        np.testing.assert_array_equal(b["whole"], arr)
        sl = tuple(slice(lo, hi) for lo, hi in b["slices"])
        np.testing.assert_array_equal(b["block"], arr[sl])
        for (lo, hi), n, entry in zip(b["slices"], arr.shape, spec):
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            parts = int(np.prod([sizes[a] for a in axes])) if axes else 1
            L = -(-n // parts)                                   # comm.shard_len
            j = _coord_index(b["coord"], axes, sizes)
            assert (lo, hi) == (min(j * L, n), min((j + 1) * L, n))
        covered[sl] += 1
    # every element is held by as many ranks as the axes that do not split it
    split = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
    copies = int(np.prod([s for a, s in sizes.items() if a not in split]))
    assert (covered == copies).all()
    calls = world[0]["blocks"][name]["counts"]["calls"]
    want = sum(1 for e in spec if e is not None
               for a in ((e,) if isinstance(e, str) else e) if sizes[a] > 1)
    assert calls == {"all_gather": want, "all_to_all": 0, "all_reduce": 0}
