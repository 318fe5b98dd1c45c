"""The VMEM credit of the port's program count
(``repro_torch.core.hlo_cost.analyze_program(..., vmem_credit=True)``)
against the reference's ``analyze(text, vmem_credit_depth=2)``.

The reference charges the operations of a ``while`` body at depth >= 2
(inside the layer stack's scan) their flops in full and, as bytes, only
their block loads and stores and collectives (``vmem-block-io``).  The
port marks the loops whose bodies those are
(``repro_torch.core.loop_marks.fused_loop``): the blockwise attention's
pairs, the Mamba scan, the mLSTM block pairs and the sLSTM recurrence.
Held here: the six reduced archs (d_model 64, vocab 256) prefilling 64
tokens as rank 0 of the (2, 4) debug mesh, each with flops equal with
and without the credit and ``vmem-block-io`` for exactly the archs whose
reference program, compiled unsharded in a child, has it (at 64 tokens
the attention's one block pair is no loop: XLA inlines a ``while`` of
one trip); the same archs prefilling 1024 tokens unsharded (the
attention's three block pairs a loop), their block I/O against the
reference's within PAIRS_RATIO; a hand-built loop whose credited bytes
are its slices' and stores' by hand count; kernel E's launch charged its
twin's block I/O; and the ``--vmem-credit`` dry-run row.
"""

import json

import pytest
import torch

import _jax_reference as R
from repro_torch.configs import InputShape, get_reduced_config
from repro_torch.core import hlo_cost, loop_marks
from repro_torch.kernels import flash_attention as E
from repro_torch.launch import dryrun, specs, steps
from repro_torch.models import flash as TF

ARCHS = ("qwen2-0.5b", "arctic-480b", "jamba-v0.1-52b", "deepseek-v2-236b",
         "gemma2-2b", "xlstm-350m")
REDUCED = dict(d_model=64, vocab_size=256)
SHAPE = InputShape("prefill_small", 64, 8, "prefill")
MESH = "2x4"
IO = "vmem-block-io"
#: 1024 tokens: three causal block pairs of 512 (gemma2's local layers,
#: window 4096 at full size, reduced to fewer), each marked loop more
#: than one trip.
PAIRS = InputShape("prefill_pairs", 1024, 1, "prefill")
#: The port's block I/O over the reference's loads and stores (its
#: ``vmem-block-io`` less the whole buffers its dynamic-update-slices
#: output, ``block_io_parts``' ``updated_buffers``: a scan's stacked
#: output charged whole at each step, which the port does not count):
#: at most the reference's, since XLA's fusions each slice again a block
#: they share and the port charges a block once; at least half of it
#: (0.59-0.99 measured over the six archs).
PAIRS_RATIO = (0.5, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's thread a core makes each wait on the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return R.run("vmem_credit", archs=list(ARCHS), reduced=REDUCED,
                 shapes=[[s.name, s.seq_len, s.global_batch, s.mode]
                         for s in (SHAPE, PAIRS)])


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_credit_matches_reference(ref, arch):
    cfg = get_reduced_config(arch, **REDUCED)
    # the first count of a cell in a process sees one more elementwise
    # flop (arctic's: a constant its MoE makes once), so both counts
    # compared are second ones
    counts = [dryrun.lower_cell(arch, SHAPE, False, mesh_shape=MESH,
                                cfg=cfg, vmem_credit=credit)
              for credit in (False, True, False)]
    credited, ctx = counts[1]
    plain = counts[2][0]
    assert ctx["vmem_credit"]
    assert dict(credited.flops_by_op) == dict(plain.flops_by_op)
    assert credited.collectives.by_opcode() == plain.collectives.by_opcode()
    assert IO not in plain.bytes_by_op
    want = ref[arch, SHAPE.name]
    assert want[True]["flops_by_op"] == want[False]["flops_by_op"]
    has = want[True]["bytes_by_op"].get(IO, 0) > 0
    assert (credited.bytes_by_op.get(IO, 0) > 0) == has, (arch, has)
    if has:
        assert credited.bytes < plain.bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_block_io_over_block_pairs_matches_reference(ref, arch):
    """Unsharded, at 1024 tokens, on ``meta`` (kernel E's launches
    charged their twins' block I/O): the block I/O within PAIRS_RATIO of
    the reference's loads and stores."""
    cfg = get_reduced_config(arch, **REDUCED)
    credited = hlo_cost.analyze_program(
        steps.make_prefill_step(cfg), specs.params_specs(cfg),
        specs.input_specs(cfg, PAIRS), vmem_credit=True)
    parts = ref[arch, PAIRS.name]["block_io_parts"]
    want = ref[arch, PAIRS.name][True]["bytes_by_op"][IO]
    assert want == pytest.approx(sum(parts.values()), rel=1e-9)
    ratio = credited.bytes_by_op[IO] / (parts["loads"] + parts["stores"])
    assert PAIRS_RATIO[0] <= ratio <= PAIRS_RATIO[1], (arch, ratio, parts)


def test_hand_built_loop_charges_its_slices_and_stores():
    """Inside a mark: each step loads ``x[i]`` and ``y[i]`` and stores
    ``out[i]`` (``out[i] = ...`` makes the view ``out[i]`` only to write
    it) and ``acc[i] += ...`` (a load and a store); the products and
    sums are charged nothing but flops."""
    n, d = 6, 40
    x, y = torch.randn(n, d), torch.randn(n, d, dtype=torch.float64)
    out, acc = torch.zeros(n, d), torch.zeros(n, d)

    def prog():
        with loop_marks.fused_loop(n):
            for i in range(n):
                out[i] = x[i] * 2 + y[i].float()
                acc[i] += torch.exp(x[i])

    credited = hlo_cost.analyze_program(prog, vmem_credit=True)
    plain = hlo_cost.analyze_program(prog)
    row32, row64 = d * 4, d * 8
    per_step = (row32 + row64 + row32      # x[i], y[i], out[i] stored
                + row32 + row32 + row32)   # x[i], acc[i] loaded, stored
    assert dict(credited.bytes_by_op) == {IO: n * per_step}
    assert dict(credited.flops_by_op) == dict(plain.flops_by_op)
    assert IO not in plain.bytes_by_op and plain.bytes > credited.bytes


def test_intermediates_of_the_loop_move_no_bytes():
    """Slices of, and stores into, a tensor made inside the marked loop
    (the fused body's intermediates, in VMEM) are charged nothing; a
    slice of a tensor made before the loop is a block load."""
    n, d = 5, 24
    x = torch.randn(n, d)
    out = torch.zeros(n, d)

    def prog():
        with loop_marks.fused_loop(n):
            for i in range(n):
                g = torch.exp(x[i]).view(2, d // 2)   # x[i]: a load
                t = torch.zeros(2, d // 2)
                t[0] = g[0] + g[1]                      # inside: free
                out[i] = t.reshape(d)                   # a store

    got = hlo_cost.analyze_program(prog, vmem_credit=True)
    assert dict(got.bytes_by_op) == {IO: n * 2 * d * 4}


def test_marks_cost_nothing_outside_a_credited_count():
    """Outside a count with the credit, and for a loop of one trip, a
    mark is the one shared no-op context; it counts depth only while a
    credited count runs."""
    assert loop_marks.fused_loop(100) is loop_marks.fused_loop(5)
    seen = []

    def prog():
        with loop_marks.fused_loop(1):
            seen.append(loop_marks.depth)
        with loop_marks.fused_loop(2):
            seen.append(loop_marks.depth)

    hlo_cost.analyze_program(prog)
    hlo_cost.analyze_program(prog, vmem_credit=True)
    assert seen == [0, 0, 0, 1] and loop_marks.depth == 0
    assert loop_marks.credit_counts == 0


@pytest.mark.parametrize("p_bf16", [False, True])
def test_kernel_launch_is_charged_its_twins_block_io(p_bf16):
    """Kernel E on ``meta`` at 10 block pairs: under the credit its
    bytes are its blockwise twin's block loads and stores (the twin's
    loop is marked), extrapolated from two and three pairs; without,
    its own inputs and outputs; flops the twin's either way."""
    q = torch.empty((1, 256, 4, 32), device="meta")
    k = torch.empty((1, 256, 2, 32), device="meta")
    kw = dict(causal=True, blocks=(64, 64), p_bf16=p_bf16)
    got = hlo_cost.analyze_program(lambda: E.flash_attention_fwd(q, k, k,
                                                                 **kw),
                                   vmem_credit=True)
    own = hlo_cost.analyze_program(lambda: E.flash_attention_fwd(q, k, k,
                                                                 **kw))
    qc, kc = (torch.zeros(t.shape) for t in (q, k))
    twin = hlo_cost.analyze_program(TF.blockwise_fwd, qc, kc, kc,
                                    vmem_credit=True, **kw)
    assert TF.blockwise_fwd.pair_count(qc, kc, kc, **kw) == 10
    assert dict(got.bytes_by_op) == {IO: twin.bytes_by_op[IO]}
    assert IO not in own.bytes_by_op and "kernel flash_attention" in \
        own.bytes_by_op
    assert dict(got.flops_by_op) == dict(own.flops_by_op) \
        == dict(twin.flops_by_op)


def test_dryrun_vmem_credit_row_is_ok(tmp_path):
    out = tmp_path / "rows.json"
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                      "--mesh-shape", "2x4", "--out", str(out),
                      "--vmem-credit"])
    rows = json.loads(out.read_text())
    assert rc == 0 and [r["status"] for r in rows] == ["ok"]
    assert rows[0]["cost_analysis"]["bytes_top"][IO] > 0
