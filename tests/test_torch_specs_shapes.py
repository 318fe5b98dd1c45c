"""The port's input shapes (``repro_torch.configs.shapes``) and state
stand-ins (``repro_torch.launch.specs``: ``meta`` tensors where the
reference builds ``ShapeDtypeStruct`` s) against the reference's
(``repro.configs.shapes``, ``repro.launch.specs``, run in a child
process), for every arch at full size and every shape.

The reference stacks each pattern position's parameters and decode
caches over the pattern's R repeats (``blocks/{p}/...``); the port keeps
one a layer (``layers/{i}/...``, the prologue's ``pre_{i}`` first): a
port layer's leaf is the stacked leaf without its leading dim, and each
stacked leaf stands for R port layers."""

import dataclasses

import pytest
import torch

import _jax_reference as R
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, shapes
from repro_torch.configs import cell_is_runnable, get_config
from repro_torch.launch import partitioning as pt
from repro_torch.launch import specs
from repro_torch.optim import adamw

MESHES = {"16x16": {"data": 16, "model": 16}}


@pytest.fixture(scope="module")
def table():
    return R.run("shapes_table")


@pytest.fixture(scope="module")
def ref():
    return R.run("sharding_rules", archs=list(ARCH_IDS), meshes=MESHES)


def test_shapes_table_matches_reference(table):
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        table["shapes"]
    assert all(isinstance(v, InputShape) for v in SHAPES.values())
    assert sorted(shapes.LONG_CONTEXT_ARCHS) == table["long_context"]
    assert shapes.SKIP_REASONS == table["skip_reasons"]


def test_runnable_cells_match_reference(table):
    got = {(a, s): cell_is_runnable(a, s) for a in ARCH_IDS for s in SHAPES}
    assert got == table["runnable"]
    assert shapes.all_cells() == [tuple(c) for c in table["all_cells"]]


def _sd(t) -> tuple:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _leaves(tree) -> dict:
    got = {}
    pt.with_paths(lambda path, leaf: got.__setitem__(path, _sd(leaf)), tree)
    return got


def _ref_path(cfg, path: str) -> tuple:
    """The reference's leaf of a port path (layers under ``mu``/``nu``
    too) and whether it is stacked."""
    parts = path.split("/")
    i = parts.index("layers") if "layers" in parts else -1
    if i < 0:
        return path, False
    n, head, rest = int(parts[i + 1]), parts[:i], parts[i + 2:]
    if n < cfg.first_k_dense:
        return "/".join(head + [f"pre_{n}"] + rest), False
    p = (n - cfg.first_k_dense) % len(cfg.block_pattern)
    return "/".join(head + ["blocks", str(p)] + rest), True


def _same_leaves(cfg, got: dict, want: dict) -> None:
    """Every port leaf is its reference leaf (unstacked), and each
    stacked reference leaf stands for its R port layers."""
    stacked_count: dict = {}
    for path, (shape, dtype) in got.items():
        rp, stacked = _ref_path(cfg, path)
        wshape, wdtype = want[rp]
        assert dtype == wdtype, (path, dtype, wdtype)
        if stacked:
            assert shape == wshape[1:], (path, shape, wshape)
            stacked_count[rp] = stacked_count.get(rp, 0) + 1
        else:
            assert shape == wshape, (path, shape, wshape)
    for rp, n in stacked_count.items():
        assert n == want[rp][0][0], (rp, n, want[rp][0])
    assert {_ref_path(cfg, p)[0] for p in got} == set(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_reference(ref, arch):
    cfg = get_config(arch)
    r = ref[arch]
    p_shapes = specs.params_specs(cfg)
    assert all(t.device.type == "meta"
               for t in _meta_leaves(p_shapes))
    _same_leaves(cfg, _leaves(p_shapes), r["params"])
    opt_cfg = adamw.AdamWConfig(moment_dtype=specs.moment_dtype_for(cfg))
    _same_leaves(cfg, _leaves(specs.opt_specs(opt_cfg, p_shapes)), r["opt"])
    for name, cell in r["cells"].items():
        shape = SHAPES[name]
        assert _leaves(specs.input_specs(cfg, shape)) == {
            k: tuple(v) for k, v in cell["batch"].items()}
        if shape.mode == "decode":
            _same_leaves(cfg, _leaves(specs.cache_specs(cfg, shape)),
                         cell["cache"])
        assert specs.tokens_per_step(cfg, shape) == (
            shape.global_batch if shape.mode == "decode"
            else shape.global_batch * shape.seq_len)
    assert specs.pos_spec().shape == () and \
        specs.pos_spec().dtype == torch.int32


def _meta_leaves(tree) -> list:
    out = []
    pt.with_paths(lambda path, leaf: out.append(leaf), tree)
    return out


def test_params_specs_draw_nothing():
    """``params_specs`` makes ``meta`` tensors without a generator: the
    CPU generator's state is the same before and after."""
    before = torch.random.get_rng_state()
    p = specs.params_specs(get_config("arctic-480b"))
    assert torch.equal(before, torch.random.get_rng_state())
    assert {t.device.type for t in _meta_leaves(p)} == {"meta"}
