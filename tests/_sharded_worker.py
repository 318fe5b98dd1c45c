"""One rank of ``tests/test_torch_sharded_execution.py``'s gloo world:

    python tests/_sharded_worker.py RANK WORLD PORT OUT_JSON

Joins a ``gloo`` process group of WORLD CPU processes at
``tcp://127.0.0.1:PORT`` and, on the (2, 4) debug mesh, runs each case
of ``CASES``: the reduced arch (d_model 64, vocab 256) on the anchors'
numpy weights (``jax_layout_params``) in the case's dtype, its loss on
the same (4, 32) tokens unsharded and sharded by the rules (parameters
by ``params_shardings``, the batch by ``batch_spec``), and the count of
the sharded loss (``analyze_program``: its collectives).  Rank 0 writes
the results as JSON."""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("qwen2-0.5b", "arctic-480b", "jamba-v0.1-52b", "deepseek-v2-236b",
         "gemma2-2b", "xlstm-350m")
#: (name, arch, dtype, config overrides)
CASES = ([(f"{a} float32", a, "float32", {}) for a in ARCHS]
         + [(f"{a} bfloat16", a, "bfloat16", {}) for a in ARCHS]
         + [("arctic-480b float32 moe_partial_sum", "arctic-480b", "float32",
             {"moe_partial_sum": True}),
            ("qwen2-0.5b float32 seq_parallel", "qwen2-0.5b", "float32",
             {"seq_parallel": True})])
REDUCED = dict(d_model=64, vocab_size=256)
BATCH, SEQ, TOKEN_SEED = 4, 32, 1


def tokens() -> np.ndarray:
    return np.random.default_rng(TOKEN_SEED).integers(
        0, REDUCED["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def port_params(cfg):
    """The anchors' weights in the port's layout, each leaf in the dtype
    the port's (and the reference's) init gives it."""
    from repro_torch.launch import partitioning as pt
    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    params = T.params_from_jax(cfg, A.jax_layout_params(cfg))
    dtypes = {}
    pt.with_paths(lambda path, t: dtypes.__setitem__(path, t.dtype),
                  T.init_params(cfg, device="meta"))
    return pt.with_paths(lambda path, t: t.to(dtypes[path]), params)


def run_case(mesh, arch, dtype, overrides) -> dict:
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.hlo_cost import analyze_program
    from repro_torch.launch import dryrun
    from repro_torch.launch import partitioning as pt
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(
        get_reduced_config(arch, dtype=dtype, **REDUCED), **overrides)
    params = port_params(cfg)
    toks = torch.as_tensor(tokens())
    batch = T.Batch(tokens=toks, labels=toks)
    with torch.no_grad():
        ref = float(T.loss_fn(cfg, params, batch))
        p_s = dryrun.place_tree(params, pt.params_shardings(mesh, params,
                                                            cfg))
        b_s = dryrun.place_tree(batch, pt.batch_spec(mesh, batch))
        with sharding.use_mesh(mesh):
            got = float(T.loss_fn(cfg, p_s, b_s).full_tensor())
            cost = analyze_program(lambda: T.loss_fn(cfg, p_s, b_s))
    return {"unsharded": ref, "sharded": got,
            "collectives": cost.collectives.by_opcode()}


def main(argv) -> None:
    rank, world, port, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh

        mesh = make_debug_mesh(2, 4)
        results = {name: run_case(mesh, arch, dtype, overrides)
                   for name, arch, dtype, overrides in CASES}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
