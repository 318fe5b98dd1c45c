"""The port's sharding rules (``repro_torch.launch.partitioning``) against
the reference's ``repro.launch.partitioning`` (run in a child process),
and the reference's own rule cases (``tests/test_partitioning.py``).

For all 10 archs at full size on both production meshes, (16, 16) and
(2, 16, 16): every parameter's spec, each runnable cell's input and
decode-cache specs, and the dry-run's analytic state bytes a device.
The reference stacks each pattern position's parameters and caches over
the pattern's R repeats (``blocks/{p}/...``, a leading dim no rule
shards); the port keeps a dict a layer (``layers/{i}/...``, the
prologue's ``pre_{i}`` first), so a port layer's spec is the stacked
one's without its leading entry.  The rules are pure functions of the
mesh's axis sizes and the shapes, so both sides take duck-typed meshes
(the reference an abstract one)."""

import pytest

import _jax_reference as R
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import partitioning as pt
from repro_torch.launch import specs


class FakeMesh:
    """Duck-typed mesh: the rules only read axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MESH = FakeMesh(MESHES["16x16"])
MESH_MP = FakeMesh(MESHES["2x16x16"])


@pytest.fixture(scope="module")
def ref():
    return R.run("sharding_rules", archs=list(ARCH_IDS), meshes=MESHES)


@pytest.fixture(scope="module")
def port():
    """Each arch's parameter stand-ins on ``meta`` and its config."""
    return {a: (get_config(a), specs.params_specs(get_config(a)))
            for a in ARCH_IDS}


def norm(spec) -> tuple:
    """A spec with one-axis tuples as the axis (``P(("data",))`` prints
    as ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def ref_path(cfg, path: str) -> tuple:
    """The reference's leaf of a port path, and whether it is stacked."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    i, rest = int(parts[1]), "/".join(parts[2:])
    if i < cfg.first_k_dense:
        return f"pre_{i}/{rest}", False
    p = (i - cfg.first_k_dense) % len(cfg.block_pattern)
    return f"blocks/{p}/{rest}", True


def leaves(tree) -> dict:
    got = {}
    pt.with_paths(lambda path, leaf: got.__setitem__(path, leaf), tree)
    return got


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(ref, port, arch, mesh_name):
    cfg, p_shapes = port[arch]
    want = ref[arch]["param_specs"][mesh_name]
    got = leaves(pt.params_shardings(FakeMesh(MESHES[mesh_name]), p_shapes,
                                     cfg))
    seen = set()
    for path, sh in got.items():
        spec = sh.spec
        rp, stacked = ref_path(cfg, path)
        w = want[rp]
        if stacked:
            assert w[0] is None, (path, w)
            w = w[1:]
        assert spec == w, (path, spec, w)
        seen.add(rp)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_specs_and_state_bytes_match_reference(ref, port, arch,
                                                           mesh_name):
    cfg, p_shapes = port[arch]
    mesh = FakeMesh(MESHES[mesh_name])
    cells = ref[arch]["cells"]
    assert set(cells) == {s for s in SHAPES
                          if dryrun.cell_is_runnable(arch, s)[0]}
    for name, cell in cells.items():
        shape = SHAPES[name]
        got = leaves(pt.batch_spec(mesh, specs.input_specs(cfg, shape)))
        assert {k: norm(v.spec) for k, v in got.items()} == {
            k: norm(v) for k, v in cell["batch_specs"][mesh_name].items()}
        if shape.mode == "decode":
            c_shapes = specs.cache_specs(cfg, shape)
            want = cell["cache_specs"][mesh_name]
            for path, sh in leaves(pt.cache_spec(mesh, c_shapes,
                                                 shape.global_batch)).items():
                rp, stacked = ref_path(cfg, path)
                w = want[rp][1:] if stacked else want[rp]
                assert norm(sh.spec) == norm(w), (name, path, sh.spec, w)
        state = dryrun.cell_state_bytes(cfg, shape, mesh)
        assert state == pytest.approx(cell["state_bytes"][mesh_name],
                                      rel=1e-12, abs=0), name


# The reference's own rule cases (tests/test_partitioning.py), with the
# stacked leading dim of its ``blocks/0/...`` leaves dropped.


def _spec(path, shape, dtype="bfloat16", mesh=MESH, repeats=1):
    import torch

    leaf = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    return pt.param_spec(mesh, path, leaf, repeats)


@pytest.mark.parametrize("path, shape, dtype, repeats, check", [
    # vocab on model; d picks up the FSDP data shard (272 MB tensor)
    ("embed/table", (151936, 896), "bfloat16", 1,
     lambda s: s == ("model", "data")),
    ("unembed/w", (896, 151936), "bfloat16", 1,
     lambda s: s == ("data", "model")),
    ("embed/table", (2048, 896), "bfloat16", 1,
     lambda s: s == ("model", None)),
    # 32 heads % 16 == 0 -> heads on model (R = 32 repeats stacked)
    ("layers/0/mixer/w_q", (4096, 32, 128), "bfloat16", 32,
     lambda s: s[1] == "model"),
    # 14 heads % 16 != 0 -> not on model
    ("layers/0/mixer/w_q", (896, 14, 64), "bfloat16", 24,
     lambda s: s[1] != "model"),
    ("layers/0/ffn/w_up", (128, 7168, 4864), "bfloat16", 35,
     lambda s: s[0] == "model"),
    # experts: FSDP on the contraction dim (d for w_up, f for w_down)
    ("layers/0/ffn/w_up", (128, 7168, 4864), "bfloat16", 35,
     lambda s: s[1] == "data"),
    ("layers/0/ffn/w_down", (128, 4864, 7168), "bfloat16", 35,
     lambda s: s[1] == "data"),
    ("layers/0/ffn/router", (7168, 128), "float32", 35,
     lambda s: all(x is None for x in s)),
    ("layers/0/norm1/scale", (4096,), "float32", 32,
     lambda s: all(x is None for x in s)),
    ("layers/0/mixer/w_k", (896, 2, 64), "bfloat16", 24,
     lambda s: "data" not in s),
], ids=["embed_vocab_sharded", "unembed_vocab_sharded", "small_embed_no_fsdp",
        "attention_heads_sharded_when_divisible",
        "attention_heads_fallback_when_indivisible", "expert_dim_sharded",
        "expert_fsdp_on_contraction_dim_up",
        "expert_fsdp_on_contraction_dim_down", "router_replicated",
        "norms_replicated", "small_tensors_no_fsdp"])
def test_param_rules(path, shape, dtype, repeats, check):
    assert check(_spec(path, shape, dtype, repeats=repeats))


def test_explain_lists_every_leaf():
    cfg = get_config("qwen2-0.5b")
    p_shapes = specs.params_specs(cfg)
    lines = pt.explain(MESH, p_shapes, cfg)
    assert len(lines) == len(leaves(p_shapes))
    assert any(line.startswith("embed/table") and "'model'" in line
               for line in lines)


def test_fsdp_reads_the_stacked_bytes():
    """A layer of 8 MiB is 32 repeats = 256 MiB in the reference's
    stacked leaf, above the FSDP threshold: the second dim goes to
    "data" only when the repeats count."""
    shape = (4096, 8, 128)           # 8 MiB in bf16
    assert "data" not in _spec("layers/0/mixer/w_k", shape)
    assert "data" in _spec("layers/0/mixer/w_k", shape, repeats=32)


@pytest.mark.parametrize("mesh, want", [(MESH, ("data",)),
                                        (MESH_MP, ("pod", "data"))],
                         ids=["single_pod", "multi_pod"])
def test_batch_axes(mesh, want):
    assert pt.batch_axes(mesh) == want


def test_state_bytes_match_hand_calc():
    import torch

    leaf = torch.empty((16, 1024, 1024), dtype=torch.bfloat16,
                       device="meta")
    sh = pt.Sharding(MESH, (None, "model", "data"))
    got = dryrun._analytic_state_bytes([sh], [leaf], 256)
    assert got == pytest.approx(16 * 1024 * 1024 * 2 / (16 * 16))
