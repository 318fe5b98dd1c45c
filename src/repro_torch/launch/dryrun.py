"""Multi-pod dry-run: count every (arch x shape x mesh) cell as one
device of its mesh (the reference's ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 512 faked host
devices and reads the compiled, SPMD-partitioned program.  The port
runs the step itself, once, as rank 0 of a fake world of the mesh's
size (:func:`repro_torch.launch.mesh.fake_world`): parameters,
optimizer state, cache and batch are DTensors placed by the rules of
:mod:`.partitioning`, their local shards ``meta`` tensors (no memory, no
values), and :func:`repro_torch.core.hlo_cost.analyze_program` counts
what rank 0 runs: its local operations, the kernels it launches on its
shards (credited at the local shapes) and the collectives DTensor
issues.  For each cell it records:

  1. the per-device count (``cost_analysis``: flops, op bytes, the
     top byte movers; the reference's ``xla_reported_*`` fields are
     ``None``, no compiler reports here);
  2. ``memory_analysis``: on ``meta`` there is no device
     (``{"error": "no device: meta"}``); with ``--device cuda`` rank 0's
     shard runs on the card instead (the shards made there from a
     seeded generator, never the global tensors): one warm step, timed,
     its local state bytes and peak allocated bytes;
  3. the analytic per-device state bytes (the reference's, exactly), the
     collectives, and the three-term roofline and energy on the chosen
     chip's spec (``--chip v5e``, the reference's default, or ``h100``).

Usage:
    python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b \\
        --shape prefill_32k --chip h100 [--seq-parallel] [--device cuda]
        [--attn-p-bf16] [--vmem-credit]
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out rows.json]

``--attn-p-bf16`` runs the LM's attention on the bf16-probability route
(kernel E's ``p_bf16`` route on the card, credited on ``meta`` with its
twin's work).  ``--vmem-credit`` is the reference's VMEM fusion credit:
the count is taken with ``analyze_program(..., vmem_credit=True)``,
which charges the operations inside the port's marked loops (the
bodies the reference's compiled program runs at ``while`` depth >= 2,
:func:`repro_torch.core.loop_marks.fused_loop`) their flops in full and
only their block loads and stores as bytes, under
``bytes_by_op["vmem-block-io"]``.  The exit code is 1 if any row is an
error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape,
                                 cell_is_runnable, get_config)
from repro_torch.core import hlo_cost, roofline, tpu_energy
from repro_torch.core.constants import H100_SXM, TPU_V5E
from repro_torch.launch import partitioning as pt
from repro_torch.launch import specs, steps
from repro_torch.launch.mesh import (axis_sizes, fake_world,
                                     intra_pod_chips, make_mesh, mesh_chips)
from repro_torch.models import sharding
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_OUT = "build/dryrun_results.json"
CHIPS = {"v5e": TPU_V5E, "h100": H100_SXM}
#: Seed of rank 0's shards on a device.
SHARD_SEED = 0


def _analytic_state_bytes(shard_tree, shape_tree, chips: int) -> float:
    """Per-device bytes for a sharded state tree (analytic, from specs)."""
    total = 0.0
    for sh, leaf in zip(tree_leaves(shard_tree), tree_leaves(shape_tree)):
        n = leaf.numel() * leaf.element_size()
        spec = sh.spec
        div = 1
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            for a in axes:
                div *= axis_sizes(sh.mesh)[a]
        total += n / div
    return total


def _input_shape(shape) -> InputShape:
    """A shape name of ``SHAPES``, or an ``InputShape`` itself."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_state_bytes(cfg, shape: InputShape, mesh) -> float:
    """A cell's analytic state bytes a device, summed as the reference's
    ``lower_cell`` sums them: the parameters; in training also two
    moments (AdamW's, in the moment dtype) sharded as the parameters;
    in decode also the cache."""
    chips = mesh_chips(mesh)
    p_shapes = specs.params_specs(cfg)
    p_shard = pt.params_shardings(mesh, p_shapes, cfg)
    total = _analytic_state_bytes(p_shard, p_shapes, chips)
    if shape.mode == "train":
        opt_cfg = adamw.AdamWConfig(moment_dtype=specs.moment_dtype_for(cfg))
        o_shapes = specs.opt_specs(opt_cfg, p_shapes)
        total += 2 * _analytic_state_bytes(p_shard, o_shapes.mu, chips)
    elif shape.mode == "decode":
        c_shapes = specs.cache_specs(cfg, shape)
        c_shard = pt.cache_spec(mesh, c_shapes, shape.global_batch)
        total += _analytic_state_bytes(c_shard, c_shapes, chips)
    return total


def _mesh_dims(multi_pod: bool, mesh_shape: str | None) -> tuple:
    if mesh_shape:
        return tuple(int(x) for x in mesh_shape.split("x"))
    return (2, 16, 16) if multi_pod else (16, 16)


def local_shape(shape, sharding: pt.Sharding) -> tuple:
    """The shape of this rank's block of a tensor of ``shape``."""
    out = list(shape)
    for p, n in zip(sharding.placements, sharding.mesh.shape):
        if p.is_shard():
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide into {n} shards")
            out[p.dim] //= n
    return tuple(out)


def _from_local(local: torch.Tensor, shape, sharding: pt.Sharding):
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def place(t: torch.Tensor, sharding: pt.Sharding):
    """The DTensor of the whole tensor ``t`` (every rank holds it) on
    ``sharding``: this rank's block of it, sliced by the rank's mesh
    coordinate."""
    local = t
    coord = sharding.mesh.get_coordinate()
    for p, n, c in zip(sharding.placements, sharding.mesh.shape, coord):
        if p.is_shard():
            local = local.chunk(n, dim=p.dim)[c]
    return _from_local(local.contiguous(), t.shape, sharding)


def place_tree(tree, shardings):
    return tree_map(place, tree, shardings)


def _filler(device, generator: torch.Generator, vocab: int):
    """Rank 0's block of a stand-in ``leaf`` on ``device``: empty on
    ``meta``; on the card drawn from ``generator``, token ids below
    ``vocab``, vectors (norm scales, biases) zeros, other floats
    N(0, 0.02²)."""
    def fill(leaf, sharding):
        shape = local_shape(leaf.shape, sharding)
        if device.type == "meta":
            local = torch.empty(shape, dtype=leaf.dtype, device=device)
        elif not leaf.dtype.is_floating_point:
            local = torch.randint(0, vocab, shape, generator=generator,
                                  device=device, dtype=leaf.dtype)
        elif leaf.dim() <= 1:
            local = torch.zeros(shape, dtype=leaf.dtype, device=device)
        else:
            local = (torch.randn(shape, generator=generator, device=device)
                     .mul_(0.02).to(leaf.dtype))
        return _from_local(local, leaf.shape, sharding)
    return fill


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tree_leaves(tree))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               mla_absorb: bool = False, donate: bool = True,
               mesh_shape: str | None = None,
               cfg_overrides: dict | None = None, device: str = "meta",
               cfg=None, vmem_credit: bool = False):
    """Run one cell's step as rank 0 of a fake world of the mesh's size
    and count it (with the VMEM credit where ``vmem_credit``); returns
    (cost, context dict).  ``cfg`` stands in for ``arch``'s config (a
    reduced one, say).  ``donate`` has no counterpart (an eager step
    holds its inputs); it is accepted."""
    del donate
    cfg = cfg or get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = _input_shape(shape_name)
    dims = _mesh_dims(multi_pod, mesh_shape)
    chips = math.prod(dims)
    dev = torch.device(device)
    with fake_world(chips):
        mesh = make_mesh(dims, "cuda" if dev.type == "cuda" else "cpu")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = (torch.Generator(device=dev).manual_seed(SHARD_SEED)
               if dev.type != "meta" else None)
        fill = _filler(dev, gen, cfg.vocab_size)

        def zeros(t, sh):
            return _from_local(torch.zeros(local_shape(t.shape, sh),
                                           dtype=t.dtype, device=dev),
                               t.shape, sh)

        p_shapes = specs.params_specs(cfg)
        p_shard = pt.params_shardings(mesh, p_shapes, cfg)
        batch_shapes = specs.input_specs(cfg, shape)
        b_shard = pt.batch_spec(mesh, batch_shapes)
        params = tree_map(fill, p_shapes, p_shard)
        batch = tree_map(fill, batch_shapes, b_shard)
        if shape.mode == "train":
            opt_cfg = adamw.AdamWConfig(
                moment_dtype=specs.moment_dtype_for(cfg))
            o_shapes = specs.opt_specs(opt_cfg, p_shapes)
            o_shard = adamw.AdamWState(step=pt.replicated(mesh),
                                       mu=p_shard, nu=p_shard)
            opt = tree_map(zeros, o_shapes, o_shard)
            fn = steps.make_train_step(cfg, opt_cfg)
            args = (steps.trainable(params), opt, batch)
            state = [params, opt.mu, opt.nu]
        elif shape.mode == "prefill":
            fn = steps.make_prefill_step(cfg)
            args = (params, batch)
            state = [params]
        else:  # decode
            c_shapes = specs.cache_specs(cfg, shape)
            c_shard = pt.cache_spec(mesh, c_shapes, shape.global_batch)
            cache = tree_map(zeros, c_shapes, c_shard)
            fn = steps.make_serve_step(cfg, mla_absorb=mla_absorb)
            args = (params, cache, batch, shape.seq_len - 1)
            state = [params, cache]

        def step():
            with sharding.use_mesh(mesh):
                fn(*args)

        ctx = dict(cfg=cfg, shape=shape, mesh=mesh, chips=chips,
                   intra_pod_chips=intra_pod_chips(mesh),
                   state_bytes_per_device=cell_state_bytes(cfg, shape,
                                                           mesh),
                   vmem_credit=vmem_credit)
        if dev.type == "meta":
            cost = hlo_cost.analyze_program(step, vmem_credit=vmem_credit)
            ctx["memory_analysis"] = {"error": "no device: meta"}
        else:
            cost, ctx["memory_analysis"] = _run_shard(step, state, dev,
                                                      vmem_credit)
    return cost, ctx


def _run_shard(step, state, dev, vmem_credit: bool = False) -> tuple:
    """Rank 0's step on ``dev``: counted once (which warms it), then
    timed once; its local state bytes and, on the card, the peak
    allocated bytes and the card's memory."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cost = hlo_cost.analyze_program(step, vmem_credit=vmem_credit)
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step()
    if cuda:
        torch.cuda.synchronize(dev)
    mem = {"device": str(dev),
           "local_state_bytes": sum(_local_bytes(t) for t in state),
           "steps_run": 2, "step_s": time.perf_counter() - t0}
    if cuda:
        mem.update(device=torch.cuda.get_device_name(dev),
                   peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                   device_total_bytes=torch.cuda.get_device_properties(
                       dev).total_memory)
    return cost, mem


def analyse_cell(arch: str, shape_name: str, multi_pod: bool, cost, ctx,
                 vmem_credit: bool = False, chip: str = "v5e") -> dict:
    """The row of a counted cell.  The credit is applied as the step is
    counted (:func:`lower_cell`), so ``vmem_credit`` must be how it
    was."""
    if vmem_credit != ctx.get("vmem_credit", False):
        raise ValueError(f"the cell was counted with vmem_credit="
                         f"{ctx.get('vmem_credit', False)}, not "
                         f"{vmem_credit}")
    cfg, shape = ctx["cfg"], ctx["shape"]
    shape_name = shape.name
    chips = ctx["chips"]
    spec = CHIPS[chip]
    colls = cost.collectives
    tokens = specs.tokens_per_step(cfg, shape)
    mf = cfg.model_flops(tokens, decode=shape.mode != "train")
    mesh_name = "2x16x16" if multi_pod else "16x16"
    terms = roofline.build_terms(
        arch, shape_name, mesh_name, chips,
        {"flops": cost.flops, "bytes accessed": cost.bytes}, colls, mf,
        chip=spec)
    energy = tpu_energy.step_energy(terms, colls, ctx["intra_pod_chips"],
                                    chip=spec)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_name,
        "mode": shape.mode, "chips": chips,
        "status": "ok",
        "cost_analysis": {
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes,
            "flops_by_op": dict(cost.flops_by_op),
            "bytes_top": hlo_cost.top_bytes_breakdown(cost),
            "xla_reported_flops": None,
            "xla_reported_bytes": None,
            "unknown_trip_whiles": cost.unknown_trip_whiles,
        },
        "memory_analysis": ctx["memory_analysis"],
        "state_bytes_per_device": ctx["state_bytes_per_device"],
        "collectives": colls.by_opcode(),
        "collective_wire_bytes": colls.total_wire_bytes,
        "roofline": terms.to_dict(),
        "energy_per_step_j": energy.breakdown() | {"total": energy.total},
        "est_system_power_w": tpu_energy.system_power_w(energy, chips),
        "chip": spec.name,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mla_absorb: bool = False, mesh_shape: str | None = None,
             cfg_overrides: dict | None = None, tag: str = "baseline",
             vmem_credit: bool = False, chip: str = "v5e",
             device: str = "meta", cfg=None) -> dict:
    shape = _input_shape(shape_name)
    shape_name = shape.name
    runnable, reason = cell_is_runnable(arch, shape_name)
    mesh_name = mesh_shape or ("2x16x16" if multi_pod else "16x16")
    if not runnable:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "tag": tag, "status": "skipped", "reason": reason}
    t0 = time.time()
    try:
        cost, ctx = lower_cell(
            arch, shape, multi_pod, mla_absorb=mla_absorb,
            mesh_shape=mesh_shape, cfg_overrides=cfg_overrides,
            device=device, cfg=cfg, vmem_credit=vmem_credit)
        row = analyse_cell(arch, shape_name, multi_pod, cost, ctx,
                           vmem_credit=vmem_credit, chip=chip)
        row["mesh"] = mesh_name
        row["tag"] = tag
        row["compile_seconds"] = round(time.time() - t0, 1)
        return row
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "tag": tag,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
                "compile_seconds": round(time.time() - t0, 1)}


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="override, e.g. 32x8 or 2x32x8")
    ap.add_argument("--moe-partial-sum", action="store_true")
    ap.add_argument("--attn-p-bf16", action="store_true")
    ap.add_argument("--fsdp-threshold-mb", type=float, default=None,
                    help="params above this get a second data-axis shard; "
                    "use a huge value to disable FSDP")
    ap.add_argument("--vmem-credit", action="store_true",
                    help="price the marked inner-loop bodies as VMEM-fused "
                    "kernels (flops in full, block I/O only as bytes)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron-style sequence parallelism")
    ap.add_argument("--chip", choices=tuple(CHIPS), default="v5e",
                    help="the spec the roofline and energy use")
    ap.add_argument("--device", choices=("meta", "cuda"), default="meta",
                    help="meta: count rank 0 with no device; cuda: run "
                    "rank 0's shard on the card")
    ap.add_argument("--tag", default="baseline",
                    help="label for this variant in the results file")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    overrides = {}
    if args.moe_partial_sum:
        overrides["moe_partial_sum"] = True
    if args.attn_p_bf16:
        overrides["attn_p_bf16"] = True
    if args.seq_parallel:
        overrides["seq_parallel"] = True
    if args.fsdp_threshold_mb is not None:
        pt.FSDP_THRESHOLD_BYTES = int(args.fsdp_threshold_mb * 2**20)

    cells: list[tuple[str, str, bool]] = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                for m in meshes:
                    cells.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", "baseline"))
            for r in results if r.get("status") == "ok"}

    errors = 0
    for arch, shape_name, mp in cells:
        mesh_name = args.mesh_shape or ("2x16x16" if mp else "16x16")
        if (arch, shape_name, mesh_name, args.tag) in done:
            print(f"[skip-cached] {arch} x {shape_name} x {mesh_name} "
                  f"[{args.tag}]")
            continue
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} "
              f"[{args.tag}] ...", flush=True)
        row = run_cell(arch, shape_name, mp, mla_absorb=args.mla_absorb,
                       mesh_shape=args.mesh_shape, cfg_overrides=overrides,
                       tag=args.tag, vmem_credit=args.vmem_credit,
                       chip=args.chip, device=args.device)
        errors += row["status"] == "error"
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == shape_name
                           and r["mesh"] == mesh_name
                           and r.get("tag", "baseline") == args.tag)]
        results.append(row)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if row["status"] == "ok":
            rf = row["roofline"]
            print(f"  ok in {row['compile_seconds']}s: "
                  f"dominant={rf['dominant']} "
                  f"t_bound={rf['t_bound']*1e3:.2f}ms "
                  f"roofline={rf['roofline_fraction']*100:.1f}% "
                  f"state/dev={row['state_bytes_per_device']/2**30:.2f}GiB",
                  flush=True)
            print(f"  memory_analysis: {row['memory_analysis']}")
            print(f"  cost_analysis: {row['cost_analysis']}")
        else:
            print(f"  {row['status']}: "
                  f"{row.get('reason') or row.get('error')}", flush=True)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_err = sum(1 for r in results if r["status"] == "error")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_err} errors -> {args.out}")
    return 0 if n_err == 0 and errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
