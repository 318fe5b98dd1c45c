"""The port's sharded execution (the counterpart of the reference's
``tests/test_dryrun_small.py::TestShardedExecution``): eight CPU
processes in a ``gloo`` world (``tests/_sharded_worker.py``, one
intra-op thread each) on the (2, 4) ("data", "model") debug mesh run the
reference's six archs, reduced to d_model 64 and vocab 256, with their
parameters placed by the rules and a (4, 32) batch, and compute the loss
sharded and unsharded; arctic-480b also with ``moe_partial_sum``, and
qwen2-0.5b with ``seq_parallel``.

Limits: in float32 the sharded loss within 1e-5 relative of the port's
unsharded one (sums in another order across shards; measured below
1e-7).  In bf16 the port's sharded loss within the reference test's own
2e-2 relative of the reference's sharded loss on the same weights and
tokens (the reference's program on 8 host devices, in a child).  Each
sharded program issues collectives (counted by ``analyze_program``)."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import concurrent.futures

import pytest

import _jax_reference as R
from _sharded_worker import ARCHS, CASES, REDUCED, tokens

WORKER = pathlib.Path(__file__).resolve().parent / "_sharded_worker.py"
WORLD = 8
F32_REL = 1e-5
BF16_REL = 2e-2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_run(tmp: pathlib.Path) -> dict:
    out = tmp / "results.json"
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), port, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's eight ranks and the reference's child, side by side."""
    tmp = tmp_path_factory.mktemp("sharded")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(R.run, "sharded_loss", host_devices=WORLD,
                          archs=list(ARCHS), dtype="bfloat16",
                          reduced=REDUCED, tokens=tokens().tolist())
        port = _port_run(tmp)
        return port, ref.result()


def test_all_cases_ran(results):
    port, ref = results
    assert set(port) == {c[0] for c in CASES}
    assert set(ref) == set(ARCHS)


@pytest.mark.parametrize("case", [c[0] for c in CASES
                                  if c[2] == "float32"])
def test_sharded_loss_matches_unsharded(results, case):
    r = results[0][case]
    assert abs(r["sharded"] - r["unsharded"]) <= \
        F32_REL * abs(r["unsharded"]), r


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_sharded_loss_matches_reference(results, arch):
    port, ref = results
    got, want = port[f"{arch} bfloat16"]["sharded"], ref[arch]["sharded"]
    assert abs(got - want) < BF16_REL * abs(want), (got, ref[arch])


def test_programs_are_actually_distributed(results):
    assert all(r["collectives"] for r in results[0].values())
