"""The port's activation sharding (``repro_torch.models.sharding``), its
kernel routes under a mesh and on ``meta``, and the per-device count of
a DTensor program (``hlo_cost.analyze_program``), in a fake world of 8
ranks (or 256, for the count of the issue's case), this process rank 0.

Without a mesh ``constrain`` returns its argument itself, so
``seq_parallel`` computes exactly what the plain forward computes; the
seq-parallel forward is also held to the reference's (run in a child
process) on the reduced float32 configs of ``LM_ANCHORS``, as the
anchors are held: their rows and vocabulary slice within 2e-5."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import _jax_reference as R
from repro_torch.configs import get_reduced_config
from repro_torch.core.hlo_cost import analyze_program
from repro_torch.kernels import flash_attention as E
from repro_torch.kernels import rmsnorm as D
from repro_torch.launch.mesh import fake_world, make_debug_mesh, make_mesh
from repro_torch.models import anchors as A
from repro_torch.models import flash
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T

SP_ARCHS = tuple(A.LM_ANCHORS)
F32 = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def world():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with fake_world(8):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh2():
    return make_debug_mesh(2, 4)


@pytest.fixture(scope="module")
def mesh3():
    return make_mesh((2, 2, 2))


def _meta(mesh, shape, placements, dtype=torch.bfloat16):
    """A DTensor of global ``shape`` whose local block is ``meta``."""
    local = list(shape)
    for p, n in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            local[p.dim] //= n
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_constrain_without_a_mesh_is_the_argument():
    x = torch.randn(2, 3, 4)
    assert S.constrain(x, S.BATCH, None, None) is x
    assert S.resolve(S.BATCH) is None and S.axis_size(S.MODEL) == 1


def test_constrain_leaves_a_plain_tensor_under_a_mesh(mesh2):
    x = torch.randn(2, 3, 4)
    with S.use_mesh(mesh2):
        assert S.constrain(x, S.BATCH, S.MODEL, None) is x


@pytest.mark.parametrize("spec, want2, want3", [
    ((S.BATCH, None, None), (Shard(0), Replicate()),
     (Shard(0), Shard(0), Replicate())),
    ((S.BATCH, S.MODEL, None), (Shard(0), Shard(1)),
     (Shard(0), Shard(0), Shard(1))),
    ((None, S.MODEL, None), (Replicate(), Shard(1)),
     (Replicate(), Replicate(), Shard(1))),
    ((S.MODEL, S.BATCH, None), (Shard(1), Shard(0)),
     (Shard(1), Shard(1), Shard(0))),
    ((S.MODEL, None, "data"), (Shard(2), Shard(0)),
     (Replicate(), Shard(2), Shard(0))),
    ((None, None, None), (Replicate(), Replicate()),
     (Replicate(),) * 3),
], ids=["batch", "batch_seq", "seq", "moe_buffer", "partial_sum", "none"])
def test_placements_of_logical_specs(mesh2, mesh3, spec, want2, want3):
    """Each logical spec's placements after ``constrain`` on the (2, 4)
    ("data", "model") and (2, 2, 2) ("pod", "data", "model") meshes; a
    batch over ("pod", "data") is ``Shard(0)`` on both, in mesh order."""
    for mesh, want in ((mesh2, want2), (mesh3, want3)):
        x = _meta(mesh, (8, 16, 8), (Replicate(),) * mesh.ndim)
        with S.use_mesh(mesh):
            got = S.constrain(x, *spec)
        assert tuple(got.placements) == want, (mesh, spec)
    with S.use_mesh(mesh3):
        assert S.resolve(S.BATCH) == ("pod", "data")
        assert S.axis_size(S.BATCH) == 4 and S.axis_size(S.MODEL) == 2


def test_constrain_keeps_an_undivided_dim_whole(mesh2):
    """A dim its axes do not divide stays whole (replicated), where the
    reference's compiler pads it: DTensor's views cannot split an uneven
    shard."""
    x = _meta(mesh2, (3, 16, 8), (Replicate(), Replicate()))
    with S.use_mesh(mesh2):
        got = S.constrain(x, S.BATCH, S.MODEL, None)
    assert tuple(got.placements) == (Replicate(), Shard(1))


def test_to_placements_wants_mesh_order(mesh3):
    with pytest.raises(ValueError, match="mesh's order"):
        S.to_placements(mesh3, (("data", "pod"), None))
    assert S.to_placements(mesh3, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))


def test_use_mesh_restores_implicit_replication(mesh2):
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    with S.use_mesh(mesh2):
        with S.use_mesh(mesh2):
            assert dispatcher._allow_implicit_replication
        assert S.current_mesh() is mesh2
    assert S.current_mesh() is None
    assert dispatcher._allow_implicit_replication == before


def test_wrappers_refuse_a_dtensor(mesh2):
    x = _meta(mesh2, (8, 16), (Shard(0), Replicate()))
    scale = torch.zeros(16)
    with pytest.raises(TypeError, match="DTensor"):
        D.rmsnorm_fused(x, scale)
    q = _meta(mesh2, (2, 64, 4, 16), (Shard(0), Shard(2)))
    with pytest.raises(TypeError, match="DTensor"):
        E.flash_attention_fwd(q, q, q)


def test_meta_routes_credit_their_launch():
    """On ``meta`` the wrappers return empty results of the right shape
    and dtype, launch nothing, and a count credits their plain twins'
    work."""
    x = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    scale = torch.empty(32, device="meta")
    q = torch.empty(2, 128, 4, 16, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 128, 2, 16, dtype=torch.bfloat16, device="meta")
    d0, e0 = D.rmsnorm_fused.launches, E.flash_attention_fwd.launches
    cost = analyze_program(lambda: (D.rmsnorm_fused(x, scale),
                                    E.flash_attention_fwd(q, k, k)))
    out = D.rmsnorm_fused(x, scale)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert (D.rmsnorm_fused.launches, E.flash_attention_fwd.launches) == \
        (d0, e0)
    twin = analyze_program(lambda: (D.rmsnorm_ref(x, scale),
                                    flash.blockwise_fwd(q, k, k)))
    assert cost.flops_by_op == twin.flops_by_op


def test_kernel_routes_run_on_local_shards(mesh2):
    """Under a mesh kernels D and E run on each shard: D on the local
    (B, S, d) block (batch and sequence split), E on local batch and q
    heads with the sequence whole, its kv heads (2, fewer than the
    "model" axis's 4) taken by the local q heads; credited at the local
    shapes."""
    x = _meta(mesh2, (8, 64, 32), (Shard(0), Shard(1)))
    scale = _meta(mesh2, (32,), (Replicate(), Replicate()), torch.float32)
    q = _meta(mesh2, (8, 64, 4, 16), (Shard(0), Shard(2)))
    kv = _meta(mesh2, (8, 64, 2, 16), (Shard(0), Replicate()))
    seen = []
    from repro_torch.kernels import _credit
    _credit._SINKS.append(lambda name, twin, a, kw, i, o:
                          seen.append((name, tuple(i[0].shape),
                                       tuple(i[1].shape))))
    try:
        with S.use_mesh(mesh2):
            y = D.rmsnorm(x, scale)
            o = flash.flash_attention(q, kv, kv, causal=True)
    finally:
        _credit._SINKS.pop()
    assert tuple(y.placements) == (Shard(0), Shard(1)) and y.shape == x.shape
    assert tuple(o.placements) == (Shard(0), Shard(2)) and o.shape == q.shape
    assert seen == [("rmsnorm", (4 * 16, 32), (32,)),
                    ("flash_attention", (4, 64, 1, 16), (4, 64, 1, 16))]


def test_analyze_program_counts_per_device():
    """The count of a DTensor program is rank 0's: ``x @ w`` with x (256,
    128, 4096) bf16 on (Shard(0), Replicate()) and w (4096, 4096) on
    (Shard(0), Shard(1)) over a (16, 16) mesh is 2·16·128·4096·256 dot
    flops a device and one all-gather of w over the 16 "data" ranks,
    its payload the gathered local block (4096 x 256 bf16)."""
    from torch.distributed import destroy_process_group

    destroy_process_group()     # this test's own 256-rank world
    try:
        with fake_world(256):
            from repro_torch.launch.mesh import make_production_mesh

            mesh = make_production_mesh()
            x = _meta(mesh, (256, 128, 4096), (Shard(0), Replicate()))
            w = _meta(mesh, (4096, 4096), (Shard(0), Shard(1)))
            cost = analyze_program(lambda a, b: a @ b, x, w)
    finally:
        from torch.distributed import init_process_group
        from torch.testing._internal.distributed.fake_pg import FakeStore
        init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    assert cost.flops == 2 * 16 * 128 * 4096 * 256
    assert dict(cost.flops_by_op) == {"dot": 2 * 16 * 128 * 4096 * 256}
    ops = [(o.opcode, o.payload_bytes, o.group_size)
           for o in cost.collectives.ops]
    assert ops == [("all-gather", 4096 * 256 * 2, 16)]


def test_partial_gradient_of_a_replicated_scale(mesh2):
    """The norm's scale is replicated, its gradient a partial sum over
    the mesh dims that shard the input."""
    x = _meta(mesh2, (8, 64, 32), (Shard(0), Replicate()), torch.float32)
    x = x.detach().requires_grad_(True)
    scale = _meta(mesh2, (32,), (Replicate(), Replicate()),
                  torch.float32).detach().requires_grad_(True)
    with S.use_mesh(mesh2):
        y = D.rmsnorm(x, scale)
        (g,) = torch.autograd.grad(y.sum(), [scale])
    assert isinstance(g, DTensor)
    assert tuple(g.placements) in ((Partial(), Replicate()),
                                   (Replicate(), Replicate()))


@pytest.fixture(scope="module")
def ref_sp():
    return R.run("seq_parallel_forward", archs=list(SP_ARCHS))


def _port_inputs(cfg):
    if cfg.frontend_stub:
        embeds, positions = A.anchor_embeds(cfg)
        return T.Batch(embeds=torch.as_tensor(embeds),
                       positions=None if positions is None
                       else torch.as_tensor(positions))
    return T.Batch(tokens=torch.as_tensor(A.anchor_tokens(cfg)[0]))


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_seq_parallel_forward(ref_sp, arch):
    """Without a mesh ``seq_parallel`` is the plain forward bit for bit,
    and the reference's seq-parallel forward within the anchors' 2e-5."""
    cfg = get_reduced_config(arch, dtype="float32")
    params = T.params_from_jax(cfg, A.jax_layout_params(cfg))
    batch = _port_inputs(cfg)
    with torch.no_grad():
        plain = T.forward(cfg, params, batch)
        sp = T.forward(dataclasses.replace(cfg, seq_parallel=True), params,
                       batch)
    assert torch.equal(plain, sp)
    # the anchors' rows and vocabulary slice, at their tolerance
    rows = np.stack([sp[b, s].numpy() for b, s in A.ANCHOR_ROWS])
    np.testing.assert_allclose(rows[:, :A.ANCHOR_VOCAB],
                               ref_sp[arch][:, :A.ANCHOR_VOCAB], **F32)
