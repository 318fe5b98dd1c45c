"""The port's program analysis (``repro_torch.core.hlo_analysis`` and
``hlo_cost``) against the reference's.

* The text functions are the reference's own copy: on ``SAMPLE_HLO``
  (``tests/test_hlo_analysis.py``) and on the texts of the five programs
  of ``tests/test_hlo_cost.py`` compiled by the reference in the child,
  the port's ``analyze`` (plain and VMEM-credited), ``parse_collectives``,
  ``count_op`` and ``top_bytes_breakdown`` equal the reference's field
  for field.
* ``analyze_program`` counts the same five programs written in torch (a
  scan as a Python loop) within the reference's own 1-2 %, the
  collectives of ``SAMPLE_HLO`` issued under the ``fake`` process-group
  backend (groups of 4, 32, 8 and 2) to the reference's payloads and
  wire bytes, a reduced float32 LM forward's dot and convolution flops
  within 2 % of the reference's count of its compiled forward, and a
  kernel's launch as its plain twin's work.

One JAX child for the file (``tests/_jax_reference.py``,
``task_hlo_cost``).
"""

import pytest
import torch
import torch.distributed as dist

from _jax_reference import (collective_fields, hlo_cost_fields, run,
                            sample_hlo)
from repro_torch.configs import get_reduced_config
from repro_torch.core import hlo_analysis as H
from repro_torch.core import hlo_cost
from repro_torch.kernels import _credit
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.models import flash
from repro_torch.models import transformer as T

LM = dict(arch="gemma2-2b", layers=2, batch=1, seq=1024)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return run("hlo_cost", **LM)


def test_sample_hlo_text_functions_equal_the_reference(ref):
    text = sample_hlo()
    want = ref["sample"]
    assert collective_fields(H.parse_collectives(text)) == \
        want["collectives"]
    assert {op: H.count_op(text, op) for op in want["count_op"]} == \
        want["count_op"]
    assert hlo_cost_fields(hlo_cost.analyze(text)) == want["analyze"]
    assert hlo_cost_fields(hlo_cost.analyze("")) == ref["empty"]


@pytest.mark.parametrize("name", ["matmul", "scan", "nested", "conv",
                                  "elementwise"])
def test_analyze_equals_the_reference_on_its_compiled_texts(ref, name):
    prog = ref["programs"][name]
    for depth, want in prog["analyze"].items():
        got = hlo_cost.analyze(prog["text"], vmem_credit_depth=depth)
        assert hlo_cost_fields(got) == want, depth
    assert hlo_cost.top_bytes_breakdown(
        hlo_cost.analyze(prog["text"]), 3) == prog["top"]


def _programs():
    """The reference test's five programs in torch, float32: a scan as a
    loop over the stacked operand."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g)

    def scan(a, bs):
        for b in bs:
            a = a @ b
        return a

    def nested(a, bs):
        for b in bs:
            for _ in range(5):
                a = a @ b
        return a

    return {
        "matmul": (lambda a, b: a @ b, (rnd(128, 512), rnd(512, 256))),
        "scan": (scan, (rnd(128, 128), rnd(8, 128, 128))),
        "nested": (nested, (rnd(64, 64), rnd(3, 64, 64))),
        # NWC (1, 64, 32) and WIO (4, 1, 32) as NCW and OIW, 32 groups
        "conv": (lambda x, w: torch.nn.functional.conv1d(x, w, groups=32),
                 (rnd(1, 32, 64), rnd(32, 1, 4))),
        "elementwise": (lambda a: torch.tanh(a) * 2 + 1, (rnd(128, 128),)),
    }


#: The reference test's tolerance for each program (its nested scans
#: take 5 %; the port is held to 2 % there too).
PROGRAM_RTOL = {"matmul": 0.01, "scan": 0.02, "nested": 0.02, "conv": 0.01,
                "elementwise": 0.01}


@pytest.mark.parametrize("name", list(PROGRAM_RTOL))
def test_analyze_program_flops_match_the_reference(ref, name):
    fn, args = _programs()[name]
    got = hlo_cost.analyze_program(fn, *args)
    want = ref["programs"][name]["analyze"][None]
    assert got.flops == pytest.approx(want["flops"], rel=PROGRAM_RTOL[name])
    for key in ("dot", "convolution"):
        assert got.flops_by_op.get(key, 0.0) == pytest.approx(
            want["flops_by_op"].get(key, 0.0), rel=PROGRAM_RTOL[name])
    # an eager loop counts every trip; nothing is left to repair
    assert got.unrolled_whiles == got.unknown_trip_whiles == 0
    assert not got.collectives.ops


def test_analyze_program_bytes_are_op_io():
    a, b = torch.ones(128, 512), torch.ones(512, 256)
    got = hlo_cost.analyze_program(lambda: (a @ b).reshape(-1).sum())
    mm = 4 * (128 * 512 + 512 * 256 + 128 * 256)
    assert got.bytes_by_op["mm"] == mm
    assert got.bytes_by_op["sum"] == 4 * (128 * 256 + 1)
    assert "view" not in got.bytes_by_op            # a view moves nothing
    assert got.bytes == mm + 4 * (128 * 256 + 1)
    # a dtype change is a convert; a same-dtype copy is none
    conv = hlo_cost.analyze_program(lambda: (a.double(), a.clone()))
    assert conv.flops_by_op["elementwise"] == a.numel()


@pytest.fixture
def fake_world():
    """A 32-rank world on the ``fake`` backend (this process is rank
    0), torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=32)
    try:
        yield {n: dist.new_group(list(range(n))) for n in (4, 8, 2)}
    finally:
        dist.destroy_process_group()


def _sample_collectives(groups):
    """``SAMPLE_HLO``'s five collectives through ``torch.distributed``."""
    ar = torch.zeros(256, 4096, dtype=torch.bfloat16)
    dist.all_reduce(ar, group=groups[4])
    ag = torch.empty(1024, 128)
    dist.all_gather_into_tensor(ag, torch.ones(32, 128))
    rs = torch.empty(64, 128)
    dist.reduce_scatter_tensor(rs, torch.ones(512, 128), group=groups[8])
    a2a = torch.empty(8, 64, dtype=torch.bfloat16)
    dist.all_to_all_single(a2a, torch.ones(8, 64, dtype=torch.bfloat16),
                           group=groups[2])
    dist.send(torch.zeros(1024, dtype=torch.uint8), 1)


@pytest.mark.filterwarnings("ignore::FutureWarning")
def test_collectives_under_the_fake_backend_equal_the_parse(ref,
                                                            fake_world):
    got = hlo_cost.analyze_program(_sample_collectives, fake_world)
    want = ref["sample"]["collectives"]
    assert got.collectives.by_opcode() == want["by_opcode"]
    assert got.collectives.by_group_size() == want["by_group_size"]
    assert got.collectives.total_payload_bytes == \
        want["total_payload_bytes"]
    assert sorted(collective_fields(got.collectives)["ops"]) == \
        sorted(want["ops"])


@pytest.mark.filterwarnings("ignore::FutureWarning")
def test_functional_collectives_are_counted(ref, fake_world):
    import torch.distributed._functional_collectives as fc

    def prog():
        return (fc.all_reduce(torch.zeros(256, 4096, dtype=torch.bfloat16),
                              "sum", fake_world[4]) + 0,
                fc.all_gather_tensor(torch.ones(32, 128), 0,
                                     dist.group.WORLD) + 0,
                fc.reduce_scatter_tensor(torch.ones(512, 128), "sum", 0,
                                         fake_world[8]) + 0,
                fc.all_to_all_single(
                    torch.ones(8, 64, dtype=torch.bfloat16), None, None,
                    fake_world[2]) + 0)

    got = hlo_cost.analyze_program(prog).collectives.by_opcode()
    want = dict(ref["sample"]["collectives"]["by_opcode"])
    want.pop("collective-permute")
    assert got == want


def test_reduced_lm_forward_dot_and_conv_flops(ref):
    """The reduced float32 gemma2-2b (two layers, d 128) forward on the
    plain path (CPU: the blockwise attention over the static block
    pairs) against the reference's count of its compiled forward (the
    layer scan and the flash scan multiplied by their trip counts)."""
    cfg = get_reduced_config(LM["arch"], num_layers=LM["layers"],
                             dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((LM["batch"], LM["seq"]), dtype=torch.long)
    with torch.no_grad():
        got = hlo_cost.analyze_program(T.forward, cfg, params,
                                       T.Batch(tokens=tokens))
    assert got.flops_by_op["dot"] == pytest.approx(ref["lm"]["dot"],
                                                   rel=0.02)
    assert got.flops_by_op.get("convolution", 0.0) == pytest.approx(
        ref["lm"]["convolution"], rel=0.02, abs=0.0)


def _launch(name, twin, args, kw, out):
    """A stand-in kernel launch: the output computed out of the count's
    sight (as a ctypes launch is), then reported as the wrappers do."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        res = twin(*args, **kw)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    _credit.credit(name, twin, args, kw, tuple(tensors),
                   res if isinstance(res, tuple) else (res,))
    return res


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention"])
def test_a_credited_launch_counts_its_plain_twin(kernel):
    """A launch reported to ``_credit`` while a program is counted adds
    the flops its plain twin counts when run, and its own I/O bytes;
    with no count active the report does nothing."""
    g = torch.Generator().manual_seed(0)
    if kernel == "rmsnorm":
        twin, args, kw = rmsnorm_ref, (torch.randn(64, 96, generator=g),
                                       torch.randn(96, generator=g),
                                       1e-6), {}
        io = 4 * (2 * 64 * 96 + 96)
    else:
        q = torch.randn(1, 1024, 4, 32, generator=g)
        k, v = torch.randn(2, 1, 1024, 2, 32, generator=g)
        twin, args = flash.blockwise_fwd, (q, k, v)
        kw = dict(causal=True, window=300, logit_softcap=50.0, scale=None,
                  return_stats=False, blocks=(512, 512))
        io = 4 * (q.numel() * 2 + k.numel() * 2)
    plain = hlo_cost.analyze_program(twin, *args, **kw)
    launched = hlo_cost.analyze_program(_launch, kernel, twin, args, kw,
                                        None)
    assert dict(launched.flops_by_op) == dict(plain.flops_by_op)
    assert launched.bytes == launched.bytes_by_op[f"kernel {kernel}"] == io
    assert not _credit.active()
    _launch(kernel, twin, args, kw, None)               # no count: no-op
