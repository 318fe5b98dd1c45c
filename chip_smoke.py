#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--phases roofline,lm,...]

Every phase runs on card 0; on a machine with several cards phase 4d
also streams across all of them.  ``--phases`` runs only the phases it
names (``PHASES``: kernels, dense, dense_engine, stream,
stream_resilience, scenario, optimize, stream_devices, service, rbe,
pipeline, rmsnorm, flash, train, lm, roofline, stub, ssm, moe, mla),
each with all of its gates; without it every phase runs.  An unknown
name exits with status 2 before any work.  The build (phase 1) and the
last line always run; a row of the ``kernels`` line needs the phases it
is measured in (``ROW_NEEDS``), a launch field of a row its phase
(``FIELD_PHASE``), and what a run could not fill the line names under
``left_out``.

Phases, each of which ends the run with a non-zero exit on any failure:

1. Build: compile every kernel library of the port
   (``repro_torch.kernels._build.all_libraries``: the sweep grid, the RBE
   int8 matmul, RMSNorm and flash attention, each from its ``csrc/``)
   with nvcc (sm_90a), one nvcc each, started together, and print the
   card and its power limit.
2. Kernel vs plain on the card: kernel A (the fused chunk step) against
   its plain PyTorch version for chunks of 997, 4096 and 131072 lanes,
   d = 1, 2, 3, constraints and a maximized objective; kernel B (dense
   evaluation) against its plain version on the 10,880-config reference
   grid, at 10^6 strided indices of the 100,096,000-config grid, and on
   a grid of 2,202,112,000 configurations (past 2^31: the 64-bit decode)
   at 4096 strided indices and its last 300,000.
   Floats must agree to 1e-12 relative (bitwise is expected: both sides
   round every operation the same way), integers, booleans and NaN
   patterns exactly.
3. Dense: ``evaluate_grid`` of the reference grid on the card equals the
   port's CPU run, field for field, with the same argmin, top-k and
   Pareto front.  Then the dense engine at its largest size,
   ``evaluate_grid`` over the 1,000,960-config grid, with the launch
   counts read around exactly that call (one of kernel B, none of A):
   every field bitwise equal to the plain path on the card, argmin,
   top-4, finite count and front equal to ``ANCHOR_1M`` (frozen from the
   JAX reference); kernel B there bitwise equal to its plain version;
   B's device time, its plain version's, and ``evaluate_grid``'s wall
   time split into the kernel, the eleven host copies and the rest
   (``dense_engine`` line).
4. Stream (the first path): ``stream_grid`` over the 100,096,000-config
   grid at its defaults (scan fusion K = 8: eight chunk steps, kernel A
   and the fold's ops, as one captured CUDA graph replayed a dispatch;
   prefetch 2), its step built beforehand and the launch counts read
   around exactly this run (kernel A: K a replay); then synchronous (K =
   1, prefetch 0): bitwise the same deliverables; then with
   ``backend="torch"`` on the card: the same argmin, top-k, counts and
   front.  Then the 10,009,600-config grid at the defaults against the
   anchors frozen from the JAX reference.  Then ``stream_resilience`` on
   the 10M grid, each bitwise equal to its uninterrupted run: a
   checkpointed run with an injected transient fault and a lost device,
   a child SIGKILLed mid-run and resumed here, ``flat_range`` halves
   folded by ``merge_results``, and a ``should_stop`` prefix against the
   ``flat_range`` run of that prefix.
4b. Scenario (the fourth path): ``stream_grid(scenarios="all",
   objectives=("time_to_empty_s", "peak_case_temp_c"), maximize=
   ("time_to_empty_s",))`` over the reference scenario benchmark's
   1,018,368 (config x trace) pairs (20 session steps each), counts read
   around it: no kernel of A-E is launched (a scenario sweep runs the
   plain ``"torch"`` backend on the card, the reference's ``xla``
   counterpart; its chunk step, session loop included, is one captured
   CUDA graph), cold and warm bitwise equal, held to
   ``ANCHOR_SCENARIO_1M`` frozen from the JAX reference (best
   time-to-empty and least peak temperature within 1e-12 relative, their
   indices and traces, the top-4, the valid count and the front exactly);
   the same pairs through the dense ``evaluate_grid`` on the card give
   the same argmin, top-4 and front, values bitwise.  The reference
   scenario grid densely on the card equals the port's CPU run within
   1e-12 (NaN patterns and index sets exactly); ``simulate_session``
   with the throttle engaged equals the batched evaluation on the card
   bitwise; ``optimal_partition(scenarios="all")`` on the card picks the
   CPU's winner.  Prints the ``scenario`` line (wall, pairs/s, steps/s,
   replays, host merge and fallback seconds, device busy share, backend,
   largest relative error, card).
4c. Optimize (the fifth path): the knob optimizer at the reference's own
   search (``examples/partition_study.py``: weighted power + 10 x
   latency over DetNet 5-30 fps and camera 20-60 fps at cut 18 on a 16nm
   sensor).  ``gradient`` at the default knobs (float64 autograd) on the
   card equals the CPU's and ``ANCHOR_OPTIMIZE`` (frozen from the JAX
   reference) within 1e-12 relative; ``optimize_knobs`` (200 steps)
   holds knobs, objective and trajectory to the anchor within 1e-6 (the
   CPU tests' tolerance: float32 Adam state); ``grid_argmin`` over the
   41 x 41 grid, counts read around exactly that call: one launch of
   kernel B, none of A; knobs exact, value within 1e-12.  Prints the
   ``optimize`` line (wall, steps/s, the host CPU's wall beside it).
4d. Stream devices (the sixth path): ``stream_grid(devices=...)`` on the
   10,009,600-config grid with ``backend="torch"``: one shard, and two
   shards of one card (``("cuda:0", "cuda:0")``: one chunk step, graph
   and stream each), bitwise equal deliverables, both on ``ANCHOR_10M``;
   two shards losing shard 1 mid-run with checkpoints: one elastic
   replan, chunks re-issued, bitwise the uninterrupted run;
   ``backend="cuda"`` refuses two explicit devices; ``devices=None``
   gives one shard on the default ``"cuda"`` backend and every visible
   card on ``"torch"``; with several cards, every card as a shard,
   bitwise the same.  No kernel of A-E runs in the sharded streams.
   Prints the ``stream_devices`` line (each run's wall and split).
4e. Service (the seventh path): the serving stack at the reference
   service benchmark's workload (``benchmarks/service_bench.py``): the
   10,009,600-config grid with ``track="all"``.  (a) ``SweepService``
   on card 0 serves it, counts read around the request: bitwise the solo
   ``stream_grid`` (itself on ``ANCHOR_10M``) with the same launches of
   A and B; a resubmit hits the plan and step caches (no new capture);
   the request on two services at once and a fused batch of three,
   bitwise; a deadline lapsing mid-run (one chunk a dispatch, a 1 s
   straggle injected) returns the prefix, bitwise its ``flat_range``
   run.  (b) 8 tenants from 8 threads, each ``_grid_for(10**5)`` at
   a private KeyNet rate, each bitwise its solo run; ticket p50/p95.
   (c) Pools of 1 and 2 worker processes (``WorkerPool``: one CUDA
   context each), warmed on the reference grid, then the 10M request:
   bitwise the solo run, configs/s, parts, reissued leases, the tenants
   again; with 2, a worker SIGKILLed mid-lease: its lease reissued, the
   fold bitwise.  (d) ``python -m repro_torch.service --listen`` as a
   child behind an auth token, driven by ``SweepClient``: the 10M
   request watched, bitwise; a wrong token refused at the handshake;
   the server SIGKILLed mid-request (the 100M grid at chunk 65,536, a
   checkpoint a dispatch) and restarted over the same spool and port:
   the client reconnects and dedupes, the resumed result bitwise its
   solo run.  Prints the ``service`` line.
5. Kernel C vs plain on the card: ``rbe_matmul_raw`` against its plain
   version at KeyNet's three int8 shapes (1, 4 and 256 ROIs), the
   reference test's shapes, ragged shapes, the tensor-core route's edges
   (K not a multiple of 32, K over one shared-memory stage, N not a
   multiple of 8, M = 1, the 64 x 64 tile with ragged M, N and K) and
   saturated (+-127) inputs, and K = 131,071 (the largest the kernel
   takes) with every operand -128: bitwise equal; K = 131,072 is refused.
   ``quantize_rowwise`` on the card equals its CPU run bitwise.
6. Hand-tracking pipeline (the second path): DetNet -> ROI -> KeyNet
   float and int8 on 4 frames (one per camera) through
   ``repro_torch.handtracking_pipeline``, with the launch count read
   around exactly that run (kernel C: 3 a forward), against the port's
   CPU run on the same frames and weights: the same ROI origins, DetNet
   and KeyNet float within rtol 1e-4 / atol 1e-5 (float32 sums in
   another order, TF32 off), the three int8 products bitwise equal to
   the CPU's on the same inputs, the int8 keypoints within relative L2
   5e-3 (an ulp of an activation can flip an int8 rounding at a tie,
   and one flip moves them by 1.45e-3); the pricing equals the anchors
   frozen from the JAX reference.
7. Kernel D vs plain on the card: ``rmsnorm_fused`` against
   ``rmsnorm_ref`` at gemma2-2b's forward (8192 x 2304 bf16) and decode
   (4 x 2304) norms, the kernel_bench shape (4096 x 1024 f32), arctic's
   width 7168 (several warps a row), a misaligned x and a ragged 997 x
   130 in both dtypes (the strided route) and qwen2-0.5b's training norm
   (1024 x 896 bf16), arctic-480b's forward norm (4096 x 7168 bf16) and
   jamba's and xlstm-350m's (4096 x 4096 and 4096 x 1024 bf16) and
   deepseek-v2-236b's q_norm and kv_norm (4096 x 1536 and 4096 x 512
   bf16): float32 within 16 ulp, bf16 within one bf16 ulp.
   Each case's gradient through kernel D's autograd Function (forward
   on the card, backward torch ops) against autograd through
   ``rmsnorm_ref``: float32 within 1e-5 relative + 1e-5 of the largest
   magnitude, bf16 dx within one bf16 ulp + the same.
8. Kernel E vs plain on the card: ``flash_attention_fwd`` against the
   full softmax ``flash_attention_ref`` at gemma2-2b's local and global
   layers (B 1, S 8192, 8/4 heads, d 256, softcap 50, window 4096 / 0,
   bf16), the kernel_bench shape (512 tokens, 4/2 heads, d 128, f32),
   qwen2's head dim 64 at 14/2 heads, non-causal, Sq 512 against Skv
   2048 with a window, the reduced configs' d 32, and the bf16
   tensor-core route's edges (d 32 and 128, a ragged Sq·g and Skv, Sq <
   Skv with a window, non-causal), qwen2-0.5b's training shape (B 8,
   S 128, 14/2 heads, d 64, both dtypes), arctic-480b's forward (B 1,
   S 4096, 56/8 heads, d 128, causal, bf16) and jamba's (32/8 heads),
   and MLA's head dims apart (q·k, v): deepseek-v2-236b's forward (B 1,
   S 4096, 128 heads, (192, 128), causal, bf16 and f32; its plain
   version a kv head at a time), the reduced config's (48, 32) in both
   dtypes, a ragged (192, 128) and one at S 512:
   bf16 within one bf16 ulp (+1e-6), float32 within 1e-5 absolute +
   1e-5 relative.  Every case also with its softmax stats: the output
   bitwise the same, m and l within 1e-5 + 1e-5 relative of the plain
   ``_fwd_pass``'s.  At the gemma2-2b layers, qwen2's training shape
   and the f32 cases and MLA's S 512 and reduced ones, (dq, dk, dv)
   through kernel E's autograd Function
   (kernel E with stats, then the recompute backward) against autograd
   through
   ``flash_attention_ref``: float32 within 1e-5 + 1e-5 relative, bf16
   within 1 % of the largest magnitude (the backward's delta comes from
   the bf16 output, as in the reference).  Kernel E's SASS must hold
   tensor-core (HMMA) and cp.async (LDGSTS) instructions.
9. LM (the third path): gemma2-2b at full width (26 layers, d 2304,
   256,000 vocab, bf16, weights from a seeded generator on the card).
   (a) ``transformer.forward`` on an 8192-token prompt, counts read
   around exactly that run (105 launches of D, 26 of E), held against
   the same forward on the plain versions of D and E on the card:
   logits within 0.25 absolute (softcapped at 30; bf16 flips of one ulp
   in norms and attention propagate through 26 layers) and at least 98 %
   of the argmaxes equal.  (b) ``token_serve.main`` at the reference's CLI
   defaults (batch 4, prompt 32, gen 16, greedy), counts read around it
   (105 launches of D a step, none of E), then teacher-forced on its own
   tokens through both paths: the kernel path reproduces the served
   tokens, and the plain path's logits stay within the same bounds.
   (c) The reduced float32 gemma2-2b and qwen2-0.5b (weights from the
   numpy seed of ``repro_torch.models.anchors``) against the logits and
   greedy tokens frozen from the JAX reference: within 2e-5 absolute +
   1e-5 relative, tokens equal.
10. Training (the eighth path): (a) ``train.main`` at the reference
   CLI's defaults (qwen2-0.5b at full width, bf16, 8 x 128 tokens, 100
   steps, lr 3e-4, warmup 20, no remat), counts read around it (49
   launches of D and 24 of E a step, none of A-C), its loss decreasing;
   one step counted alone, TRAIN_TIMED_STEPS timed (median), one
   profiled (busy share, top kernels).  (b) One step's loss and
   gradients through kernels D and E against the same step on their
   plain versions (``plain_kernels()``: autograd through the plain D and
   E): loss within 1e-2, every leaf's cosine >= 0.99, the global norm
   within 1 %.  (c) The reduced float32 qwen2-0.5b and gemma2-2b trained
   five steps against ``TRAIN_ANCHORS`` (frozen from the JAX reference)
   at the CPU tests' tolerances.  (d) Six steps with a checkpoint every
   three, against a resume from step 3: losses and the final checkpoint
   bitwise.  Prints the ``train`` line (step ms, tokens/s, busy share,
   share of the matmul bound, peak memory).
9h. Roofline (``roofline``), after phase 9: the program count
   (``repro_torch.core.hlo_cost.analyze_program``) and the H100 spec
   (``core.constants.H100_SXM``).  (a) gemma2-2b's 8192-token forward at
   phase 9's shapes, counted on the kernel path (105 launches of D, 26
   of E, each launch credited with its plain twin's flops) and on the
   plain blockwise path (``rmsnorm_ref``, ``flash.blockwise_fwd``): the
   flops equal exactly; the dot flops within 5 % of ``lm_bounds``' bf16
   operations and equal to them with the attention taken over whole
   block pairs instead of causal pairs; ``roofline.build_terms`` under
   the H100 spec beside the forward's device time.  (b) One qwen2-0.5b
   training step at ``TRAIN_ARGV``'s shapes counted (49 launches of D,
   24 of E): its flops at least ``train_step_flops``'; the useful-flops
   ratio.  (c) ``nvidia-smi`` ``power.draw`` at idle, over a ~5 s loop
   of the forward, and over a device copy and a bf16 matmul loop (the
   H100 spec's HBM and flop energies derived from them), beside
   ``tpu_energy.step_energy``'s average power at the forward's measured
   time (a reading, not a gate).  (d) ``dosc.advise`` under the H100
   spec for qwen2-0.5b's gradient over 2 pods of 8.  Prints the
   ``roofline`` line; ~30 s.
9g. Modality stubs (the twelfth path), after phase 9 and before 9e (its
   8 GB are freed before jamba's 52 GB): qwen2-vl-2b (28 layers, d 1536,
   12/2 heads of 128, d_ff 8960, vocab 151,936, tied, qkv biases, M-RoPE
   sections 16/24/24) and musicgen-large (48 layers, d 2048, 32/32 heads
   of 64, GELU d_ff 8192, vocab 2048, sinusoidal positions), both at
   full width and depth, bf16, weights from a seeded generator on the
   card, fed precomputed embeddings (``Batch.embeds``; the vision tower
   and EnCodec are stubs in both packages).  (a) qwen2-vl's
   ``transformer.forward`` on one 4096-token prompt: 16 text tokens
   (rows of its own table), one 48 x 48 image of merged patches (seeded
   normals at the table's scale), 1776 text tokens, at Qwen2-VL's t/h/w
   positions; counts read around exactly it (57 launches of D, 28 of E),
   against the plain D and E within 0.25 and 93 % of the argmaxes, and
   in float32 (D's and E's float32 routes against the plain path in
   float32) within 0.01 and 99 % (STUB_LIMITS, placed by the float32
   plain path's witness); M-RoPE with t = h = w
   equals RoPE within 1e-6 in float32 at its shapes, and the image's
   positions move the logits past the first text run by more than 0.25
   where t = h = w leaves the text run as it was; device and wall time,
   busy share, the operation bound.  (b) Serving at batch 4: the
   prompts' cache from one forward (the reference's decode rule, t = h =
   w = the cache index, as a decode-step prefill writes it; the first 32
   positions also decoded a step at a time, within 0.25), then 15 greedy
   ``decode_step(Batch(tokens=...))`` steps, counts read around them
   (57 of D a step, none of E); the plain D and E stay within the
   limits, and in float32 reproduce the tokens served on the kernels'
   float32 routes; ms a step, tok/s, the byte bound.
   (c) One ``loss_fn`` backward on 1 x 1024 embeddings holding a 24 x 24
   image (E with stats, the M-RoPE backward; 57 of D, 28 of E), then
   ``optim.compression.compress_with_feedback`` over its ~1.54 B
   gradient elements, int8 twice and bf16 once: every leaf within its
   reconstruction bound, its new error feedback bitwise target - recon,
   the bytes on the wire the elements x 1 (x 2), three leaves bitwise
   their CPU run; each step's ms.  (d) musicgen's forward on 1536 frame
   embeddings (30.72 s at 50 Hz: 1500 do not tile the prompt
   attention's 512 blocks, in either package; 97 of D, 48 of E) as (a);
   16 decode steps at batch 4, each fed the next frame (teacher-forced),
   after the 1536 frames' cache from one forward: counts (97 of D a
   step, none of E), the steps' logits against the forward's at the
   same positions in bf16 (its limits) and in float32 (E's float32
   route, within 1e-3, the reference test's bound); ms a step, the
   bound.  (e) The reduced
   float32 qwen2-vl-2b and musicgen-large against ``LM_ANCHORS`` (their
   forwards on ``anchor_embeds``).  Prints the ``stub`` line.
9e. SSM (the tenth path), after phase 9 (its 52 GB are freed before
   9d): xlstm-350m at full width and depth (24 mLSTM and sLSTM blocks,
   d 1024, 4 heads, vocab 50,304, tied embeddings, bf16) and
   jamba-v0.1-52b at full width (d 4096, 32/8 heads, Mamba N 16 and
   d_inner 8192, 16 experts top-2 of d_ff 14,336 on every second layer,
   sinusoidal positions, vocab 65,536, bf16) cut to 16 of its 32 layers
   (52.1 GB), weights from a seeded generator on the card.  Each: (a)
   ``transformer.forward`` on one prompt (jamba 4096 tokens, xlstm
   2048: its sLSTM loops are host-bound), counts read around exactly it
   (xlstm 25 launches of D, none of E; jamba 33 of D and 2 of E; none of
   A-C), against the same forward on the plain D and E and beside the
   plain path in float32 (the witness: each limit lies between the two
   readings): in bf16 the first 16 positions' logits and argmaxes, the
   argmaxes over all and jamba's routes a MoE layer (a bf16 ulp grows
   through these recurrences with random weights until later logits are
   unrelated, the witness's from the first tokens on); in float32 on the
   kernels' float32 routes, every position; jamba's drops at capacity;
   the forward's wall and device time (a profiled run's summed kernels),
   busy share, the Mamba, sLSTM and mLSTM scans' share of the device
   time, its bound (jamba: the MoE's static buffer and the routed one),
   transient memory and peak.  (b) Serving at the reference CLI's
   defaults (batch 4, prompt 32, gen 16; xlstm through
   ``token_serve.main``, jamba ``token_serve.generate``), counts read
   around it (25 and 33 launches of D a step, none of E), teacher-forced
   on both paths: the kernel path reproduces the served tokens, the plain
   path within the limits; decode ms a step, tok/s, its bound.  (c)
   The reduced float32 xlstm-350m and jamba against ``LM_ANCHORS``
   (logits within 2e-5 + 1e-5 relative, tokens, jamba's routes).  Prints
   the ``ssm`` line.
9d. MoE (the ninth path), after every other phase (its weights fill
   the card): arctic-480b at full width (d 7168, 56/8 heads, 128 experts
   top-2 of d_ff 4864 at capacity factor 1.25 beside a dense residual
   FFN, vocab 32,000, bf16, weights from a seeded generator on the card)
   cut to 2 of its 35 layers (55.4 GB).  (a) ``transformer.forward`` on
   a 4096-token prompt (the reference's ``prefill_32k`` cut so that the
   plain comparison fits), counts read around exactly it (5 launches of
   D, 2 of E, none of A-C), against the same forward on the plain D and
   E (attention a kv head at a time): at least 97.5 % of each MoE layer's
   (token, choice) routes equal, the logits within 0.25 at the tokens
   whose routes agree in every layer and at least 95 % of the argmaxes
   equal there and over all tokens (a bf16 ulp can flip a router's near
   tie); each layer's share of picks dropped at capacity; the forward's
   transient memory below one expert weight (no weight copied); its
   device and wall time, busy share and byte/operation bound.  (b)
   ``token_serve.generate`` at the reference CLI's defaults (batch 4,
   prompt 32, gen 16, greedy), counts read around it (5 launches of D a
   step, none of E), again timed (decode ms a step, tok/s, the static
   buffer's 16.4 ms bound and the routed one), teacher-forced on both
   paths as (a); one decode step's device time and busy share.  (c) The
   reduced float32 arctic-480b against ``LM_ANCHORS`` (logits, greedy
   tokens, the forward's routes by digest).  Prints the ``moe`` line.
9f. MLA (the eleventh path), last, after arctic's weights are freed:
   deepseek-v2-236b at full width (d 5120, 128 heads, q LoRA 1536, kv
   LoRA 512, q·k 128 + 64, v 128, 160 experts top-6 of d_ff 1536 at
   capacity factor 1.25 beside 2 shared experts, the first layer dense,
   vocab 102,400, bf16, weights from a seeded generator on the card) cut
   to 7 of its 60 layers (50.1 GB).  (a) ``transformer.forward`` on a
   4096-token prompt, counts read around exactly it (29 launches of D:
   norm1, norm2, q_norm and kv_norm a layer and the final norm; 7 of E,
   q·k 192 beside v 128; none of A-C), against the plain D and E on two
   prompts and beside the float32 witness (routes, logits where routes
   agree, argmaxes; MLA_LIMITS), and in float32 on D's and E's float32
   routes against the plain path in float32; drops; device and wall
   time, busy share, peak, the bound with every slot of the MoE buffer
   and with the routed picks.  (b) One decode step at position
   4095 of a 4096-token cache (batch 4, the cache seeded), naive and
   absorbed (``decode_step(mla_absorb=...)``, 29 launches of D each,
   none of E): their logits within 1e-4 of the largest in float32, and
   in bf16 within 1.25 times the witness (the naive step in float32
   against it in bf16); each step's device time and bound.  (c) ``token_serve.generate`` at batch 4,
   prompt 32, gen 16 (naive decode, 29 launches of D a step, none of
   E), teacher-forced on both paths; decode ms a step, tok/s, the
   static buffer's bound and the routed one.  (d) The reduced float32
   deepseek-v2 against ``LM_ANCHORS`` (E's f32 route at (48, 32);
   logits, greedy tokens, routes).  Prints the ``mla`` line.
11. Report: a ``kernels`` JSON line (launches, error, kernel and plain
   time at the main paths' shapes, the card's bound for the same work,
   the library call's time where there is one; A's, B's and C's launch
   plans and ptxas registers and spills, which must be none, and B's
   stack frames, which must be empty; B's row holds its probe reading
   and, under ``dense``, its 1,000,960-config one, and its launches in
   ``grid_argmin``, and A's and B's their launches in the served request
   (``launches_service``), D's and E's in the training run and in one
   step (``launches_train``, ``launches_train_step``), in the SSM
   models' forwards and decode steps (``launches_ssm``), in arctic's
   forward and decode step (``launches_moe``), in deepseek-v2's
   (``launches_mla``), in qwen2-vl-2b's and musicgen-large's forwards
   and decode steps (``launches_stub``; their time there, ``stub_shape``)
   and their time at arctic's shapes (``moe_shape``:
   E's library call there is SDPA), at jamba's and xlstm's
   (``ssm_shape``) and at deepseek-v2's (``mla_shape``: SDPA with q·k
   and v apart, and the kernels its backend launched); A's
   its graph replays and K), ``stream`` (the default path's wall,
   dispatch, wait, merge and busy share, the synchronous path's beside
   it, the plain backend's), ``stream_resilience``, ``rbe_shapes`` (each
   layer at 4 and 256 ROIs with its tile), ``handtracking``,
   ``rmsnorm_shapes``/``flash_shapes`` (each case's route; E's registers
   and spills from ptxas and its share of the bound), ``lm``, ``train``,
   ``stub``, ``ssm``, ``moe``, ``mla`` and ``roofline`` JSON lines, the
   card's name and power limit, and last the ``ok`` line.  Kernel C's SASS must hold int8 tensor-core (IMMA) and
   cp.async (LDGSTS) instructions.

Imports nothing of JAX or of the JAX reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL = 1e-12

# H100 SXM HBM3 peak (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12

# Float64 instructions an SM issues per clock on an H100 (4 partitions x
# 16 FP64 units).  The data sheet's 34 TFLOP/s is this at the boost clock
# with a DFMA counted as two; built with --fmad=false the kernels issue
# DADD and DMUL, one operation each, so the rate that bounds them is
# SMs x 64 x clock (fp64_rate).
FP64_PER_SM_CLOCK = 64

# Opcodes of the float64 pipe counted as operations in the SASS
# (MUFU.RCP64H seeds each IEEE divide's sequence).
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def query_gpu(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    return query_gpu("name,power.limit")


def fp64_rate() -> float:
    """Float64 operations a second at the card's top SM clock."""
    import torch

    mhz = float(query_gpu("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP64_PER_SM_CLOCK * mhz * 1e6


def sass(lib: pathlib.Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    from repro_torch.kernels._build import nvcc

    tool = pathlib.Path(nvcc()).parent / "cuobjdump"
    check(tool.exists(), f"{tool} not found: cannot read the SASS")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_fp64(lib: pathlib.Path) -> dict:
    """Float64 instructions in each kernel of the built library, from
    ``cuobjdump -sass``: ``{kernel: {"fp64": n, "divides": k}}``.  Only
    the kernel's own body counts, up to its last ``EXIT`` before the
    first ``RET``: the subroutines after it (the IEEE divide's slow path
    for operands near the range's ends) do not run on this model's
    values.  The body of ``eval_kernel`` has no loop around its float64
    work, so its count is what one configuration of Eq. 1-11 issues."""
    text = sass(lib)
    kernels: dict = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernels[name] = []
        elif name is not None and (m := _SASS_LINE.search(line)):
            kernels[name].append(m.group(2))
    out = {}
    for name, ops in kernels.items():
        ret = next((i for i, op in enumerate(ops) if op.startswith("RET")),
                   len(ops))
        exits = [i for i, op in enumerate(ops[:ret]) if op == "EXIT"]
        body = ops[:exits[-1] + 1] if exits and ret < len(ops) else ops
        key = "chunk_kernel" if "chunk_kernel" in name else name
        out[key] = {
            "fp64": sum(op.split(".")[0] in FP64_OPCODES
                        or op.startswith("MUFU.RCP64H") for op in body),
            "divides": sum(op.startswith("MUFU.RCP64H") for op in body)}
    return eval_per_config(out, str(lib))


def eval_per_config(out: dict, what: str) -> dict:
    """``out`` with kernel B's instances (each ``eval_kernel`` template
    instance, by its name) summed up as ``"eval_kernel"``: the count of
    the instance that issues the fewest float64 instructions, the one
    that evaluates one configuration a thread, so it is what one
    configuration of Eq. 1-11 issues; each instance's own count stays
    under ``"eval_instances"``."""
    evals = {k: v for k, v in out.items() if "eval_kernel" in k}
    check("chunk_kernel" in out and evals,
          f"kernels missing from the SASS of {what}: {sorted(out)}")
    rest = {k: v for k, v in out.items() if k not in evals}
    return {**rest, "eval_kernel": min(evals.values(), key=lambda v: v["fp64"]),
            "eval_instances": {k: v["fp64"] for k, v in evals.items()}}


def max_err(got: dict, want: dict, what: str) -> float:
    """Compare two dicts of tensors key by key; returns the largest
    absolute float difference (NaN positions excluded)."""
    import torch

    check(got.keys() == want.keys(), f"{what}: keys differ")
    worst = 0.0
    for k in want:
        g, w = got[k], want[k]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}[{k}]: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not w.dtype.is_floating_point:
            check(torch.equal(g, w), f"{what}[{k}]: values differ")
            continue
        gn, wn = torch.isnan(g), torch.isnan(w)
        check(torch.equal(gn, wn), f"{what}[{k}]: NaN patterns differ")
        g, w = g[~gn], w[~wn]
        check(torch.equal(torch.isinf(g), torch.isinf(w))
              and torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]),
              f"{what}[{k}]: infinities differ")
        fin = torch.isfinite(w)
        if fin.any():
            d = (g[fin] - w[fin]).abs()
            rel = (d / w[fin].abs().clamp_min(1e-300)).max().item()
            check(rel <= RTOL, f"{what}[{k}]: relative error {rel:.3e}")
            worst = max(worst, d.max().item())
    return worst


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, reps: int) -> float:
    """Wall time per call, synchronised: what one call costs its caller
    (host-side wrapper and launch overhead included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


@functools.lru_cache(maxsize=1)
def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10**8)
    end.record()
    end.synchronize()
    return 1e8 / start.elapsed_time(end)


def device_ms(fn, reps: int, what: str, expect: dict | None = None
              ) -> tuple:
    """Device time per call and how it was taken.  ``"events"``: CUDA
    events around ``reps`` calls that wait on the stream behind a sleep
    kernel, held until the host has issued them all, so that they run
    back to back on the card and the host's launch overhead is not in the
    reading.  A reading whose calls were not all issued before the sleep
    ended is taken again with a longer sleep.  A call that waits on the
    stream itself (cuDNN's convolutions do), or that queues more kernels
    than the launch queue holds, never gets ahead of the sleep: after
    three tries it is timed from a torch.profiler trace (``"trace"``,
    :func:`trace_ms`, which checks the trace against ``expect`` and says
    how it timed the calls if no trace held every record)."""
    import torch

    t0 = time.perf_counter()
    fn()                                  # warm-up; its issue time sizes the hold
    hold_ms = 2.0 + 2e3 * (time.perf_counter() - t0) * reps
    torch.cuda.synchronize()
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(hold_ms * sleep_cycles_per_ms()))
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ev[2].record()
        issued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].synchronize()
        if issued_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps, "events"
        hold_ms = 2.0 + 2.0 * issued_ms
    print(f"device_ms {what}: a call waits on the stream; timed from a "
          f"profiler trace")
    return trace_ms(fn, reps, what, expect)


def methods(rows: list, keys: tuple) -> dict:
    """``key + "_method"`` for a sum of ``rows``' ``key`` readings: the
    methods they were taken by, joined by "+" where they differ."""
    return {k + "_method": "+".join(sorted({r[k + "_method"] for r in rows
                                            if k + "_method" in r}))
            for k in keys}


def timed(out: dict, key: str, fn, reps: int, what: str,
          expect: dict | None = None) -> float:
    """``out[key]``: :func:`device_ms` of ``fn``; ``out[key + "_method"]``:
    how it was taken."""
    out[key], out[key + "_method"] = device_ms(fn, reps, what, expect)
    return out[key]


def trace_ms(fn, reps: int, what: str, expect: dict | None = None
             ) -> tuple:
    """Device time per call: the summed duration of the device-side
    activities of ``reps`` calls in a torch.profiler trace.  Such traces
    lost kernels' records on some machines (one of 3 or of 20 launches,
    the first few of one gemma2 forward, once all of them), so a trace
    counts only if it holds every record: a multiple of ``reps`` of each
    name, and ``expect[s] * reps`` records whose name holds ``s``, for
    each ``s`` of ``expect``.  After three traces that do not, the calls
    are timed by CUDA events around them as they run (``"events_unheld"``:
    the device's idle gaps between kernels are in it, so it can read high
    but never drops work)."""
    check(reps >= 2, f"{what}: a trace of one call cannot be checked")

    def run():
        for _ in range(reps):
            fn()

    for _ in range(3):
        events = trace_events(run)
        missing = [f"{n} records of {name[:150]}"
                   for name, (_, n) in events.items() if n % reps]
        for sub, per_call in (expect or {}).items():
            n = sum(c for name, (_, c) in events.items() if sub in name)
            if n != per_call * reps:
                missing.append(f"{n} records of {sub}, {per_call} a call "
                               f"expected")
        if not missing:
            return sum(t for t, _ in events.values()) * 1e3 / reps, "trace"
        print(f"trace_ms {what}: the trace of {reps} calls holds "
              f"{len(missing)} names short, e.g. {'; '.join(missing[:3])}")
    print(f"trace_ms {what}: three traces missed records; timed by CUDA "
          f"events around the calls as they run")
    return unheld_ms(fn, reps), "events_unheld"


def unheld_ms(fn, reps: int) -> float:
    """Milliseconds per call between CUDA events recorded before and
    after ``reps`` calls, the stream not held."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


#: Idle milliseconds between the start of a trace's recorded step and
#: ``run()``'s first kernel.
TRACE_SPACER_MS = 5.0


def trace_events(run) -> dict:
    """Device time (seconds) and number of records of ``run()`` by kernel
    name, from the device-side events of a torch.profiler trace (CUPTI).
    The kernel records nearest the start of a trace were lost on some
    chip machines (the first of ``run()``'s, or the first few of a long
    forward), so the trace opens with a warm-up step whose records are
    dropped, and its recorded step with a sleep kernel (left out of the
    result) that the host waits out before ``run()``.  Fails when the
    trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(int(TRACE_SPACER_MS * sleep_cycles_per_ms()))
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        prof.step()
    out: dict = {}
    for ev in traced:
        # the step's own range is mirrored on the device's timeline
        if ev.device_type == DeviceType.CUDA and "spin_kernel" not in ev.name \
                and not ev.name.startswith("ProfilerStep"):
            t, n = out.get(ev.name, (0.0, 0))
            out[ev.name] = (t + ev.time_range.elapsed_us() / 1e6, n + 1)
    check(out, "profiler trace holds no device events")
    return out


def device_busy(run) -> dict:
    """Device time of ``run()`` by kernel name (seconds)."""
    return {k: t for k, (t, _) in trace_events(run).items()}


def make_aux(spec, cons, front_sg, dev) -> dict:
    """The chunk step's runtime inputs: constraint bounds and the
    dominance filter built from ``front_sg`` (signed objective rows)."""
    import torch

    from repro_torch.core import pareto as P

    filt = P.build_dominance_filter(front_sg, spec.d, spec.filter_rows,
                                    spec.filter_bins)
    aux = {"filter": {k: torch.as_tensor(v, device=dev)
                      for k, v in filt.items()}}
    if cons:
        aux["cons"] = torch.tensor([v for _, _, v in cons],
                                   dtype=torch.float64, device=dev)
    return aux


def sample_front(T, shape, axvals, objectives, sign, dev) -> np.ndarray:
    """Signed front of 4096 strided grid points (the probe's seed)."""
    import torch

    from repro_torch.core import pareto as P
    from repro_torch.kernels import sweep_grid as K

    n = int(np.prod(shape))
    flat = torch.as_tensor(
        np.unique(np.linspace(0, n - 1, 4096).astype(np.int64)), device=dev)
    out = K.sweep_grid_eval_ref(T, shape, objectives, axvals, flat)
    V = np.stack([out[o].cpu().numpy() for o in objectives], axis=1) * sign
    V = V[np.isfinite(V).all(axis=1)]
    return V[P.non_dominated_mask(V)]


def phase_kernels(dev, grid_big, grid_ref) -> dict:
    """Kernels A and B against their plain versions; returns the largest
    absolute difference seen per kernel."""
    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST
    from repro_torch.core import sweep as SW
    from repro_torch.kernels import sweep_grid as K

    S, axis_arrays, _ = SW.build_axes(**grid_big)
    shape = tuple(a.size for a in axis_arrays)
    n = int(np.prod(shape))
    T = B.device_tables(S, dev)
    axvals = SW.axes_to_device(axis_arrays, dev)
    cases = [
        dict(chunk=997, objectives=("avg_power",), track=("latency",),
             start=n - 500),
        dict(chunk=4096, objectives=("avg_power", "latency"),
             constraints={"latency": 0.03, "mipi_bytes_per_s": (">=", 2e5)},
             hist_bins=16, start=4096 * 7),
        dict(chunk=131072, objectives=("avg_power", "latency",
                                       "mipi_bytes_per_s"),
             track=("sensor_memory",), start=131072 * 300),
        dict(chunk=131072, objectives=("avg_power", "latency",
                                       "sensor_macs_per_s"),
             maximize=("sensor_macs_per_s",),
             constraints={"avg_power": 0.02}, start=n - 100000),
    ]
    err = {"A": 0.0, "B": 0.0}
    for c in cases:
        start, chunk = c.pop("start"), c.pop("chunk")
        plan = ST.plan_stream(**grid_big, **c, chunk_size=chunk, device=dev)
        spec, cons = plan.spec, plan.cons
        front = sample_front(T, shape, axvals, spec.fields[:spec.d],
                             np.asarray(spec.sign), dev)
        aux = make_aux(spec, cons, front, dev)
        got = K.sweep_grid_chunk(spec, T, axvals, aux, start)
        want = K.chunk_partials_ref(spec, T, axvals, aux, start)
        sync(dev)
        e = max_err(got, want, f"kernel A chunk={spec.chunk} d={spec.d}")
        # the graph-replayed step's form: the start split into a device
        # base (read by the kernel) and a fixed offset
        base = torch.tensor(start - spec.chunk, dtype=torch.int64,
                            device=dev)
        got = K.sweep_grid_chunk(spec, T, axvals, aux, spec.chunk, base)
        sync(dev)
        e = max(e, max_err(got, want, f"kernel A chunk={spec.chunk} "
                                      f"d={spec.d}, device base"))
        err["A"] = max(err["A"], e)
        print(f"kernel A chunk={spec.chunk} d={spec.d} "
              f"cons={len(cons)} sign={spec.sign}: max_abs_err={e!r}")

    # Kernel B: all of the reference grid, 10^6 strided indices of the
    # big one, and on a grid past 2^31 configurations (its 64-bit decode)
    # 4096 strided indices with the last 300,000 (two a thread along the
    # last axis).
    huge = dict(grid_big, camera_fps=tuple(np.linspace(20.0, 60.0, 2024)))
    n_huge = n // len(grid_big["camera_fps"]) * 2024
    check(n_huge > 2**31, f"the 64-bit case has only {n_huge} configs")
    for g, flat_np in ((grid_ref, None),
                       (grid_big, np.unique(np.linspace(0, n - 1, 10**6)
                                            .astype(np.int64))),
                       (huge, np.concatenate([
                           np.linspace(0, n_huge - 300_001, 4096)
                           .astype(np.int64),
                           np.arange(n_huge - 300_000, n_huge)]))):
        Sg, ax_g, _ = SW.build_axes(**g)
        shp = tuple(a.size for a in ax_g)
        Tg = B.device_tables(Sg, dev)
        axg = SW.axes_to_device(ax_g, dev)
        flat = (torch.arange(int(np.prod(shp)), dtype=torch.int64,
                             device=dev) if flat_np is None
                else torch.as_tensor(flat_np, device=dev))
        got = K.sweep_grid_eval(Tg, shp, SW.FIELDS, axg, flat)
        want = K.sweep_grid_eval_ref(Tg, shp, SW.FIELDS, axg, flat)
        sync(dev)
        e = max_err(got, want, f"kernel B n={flat.numel()}")
        check_bitwise(got, want, f"kernel B n={flat.numel()}")
        err["B"] = max(err["B"], e)
        print(f"kernel B n={flat.numel()}: max_abs_err={e!r}")
    return err


def same_deliverables(a, b, what: str, exact_values: bool) -> None:
    """argmin, counts, top-k and the front index set of two stream (or
    dense-derived) results."""
    check(a.min_idx == b.min_idx, f"{what}: argmin indices differ")
    check(a.finite_counts == b.finite_counts, f"{what}: counts differ")
    check(np.array_equal(a.topk_idx, b.topk_idx), f"{what}: top-k differ")
    fa, fb = a.pareto_front(), b.pareto_front()
    check(np.array_equal(fa.indices, fb.indices),
          f"{what}: front index sets differ ({fa.size} vs {fb.size})")
    if exact_values:
        check(a.min_val == b.min_val, f"{what}: argmin values differ")
        check(np.array_equal(fa.values, fb.values),
              f"{what}: front values differ")
    else:
        for f in a.min_val:
            check(abs(a.min_val[f] - b.min_val[f])
                  <= RTOL * abs(b.min_val[f]), f"{what}: {f} min differs")


def phase_dense(grid_ref, dev) -> None:
    from repro_torch.core import pareto as P
    from repro_torch.core import sweep as SW

    gpu = SW.evaluate_grid(**grid_ref, device=dev)
    cpu = SW.evaluate_grid(**grid_ref, device="cpu")
    for f in SW.FIELDS:
        a, b = gpu.data[f], cpu.data[f]
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"dense {f}: NaN")
        ok = ~np.isnan(b)
        rel = np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]),
                                                        1e-300))
        check(rel <= RTOL, f"dense {f}: relative error {rel:.3e}")
        check(gpu.argmin(f) == cpu.argmin(f), f"dense {f}: argmin")
        check(gpu.top_k(f, 4) == cpu.top_k(f, 4), f"dense {f}: top-k")
    fg, fc = P.pareto_front(gpu), P.pareto_front(cpu)
    check(np.array_equal(fg.indices, fc.indices), "dense: front differs")
    print(f"dense {gpu.n_configs} configs: card == cpu "
          f"(front {fg.size} points, argmin {gpu.argmin()['avg_power']!r})")


def bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Same shape, the same NaN positions and every other entry equal to
    the bit."""
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(a[~na].view(np.int64), b[~nb].view(np.int64)))


def check_bitwise(got: dict, want: dict, what: str) -> None:
    """Every tensor of ``got`` bitwise equal to ``want``'s (NaN pattern
    included)."""
    for k in want:
        check(bitwise_equal(got[k].cpu().numpy(), want[k].cpu().numpy()),
              f"{what}[{k}]: not bitwise equal to the plain version")


#: The dense engine's grid: ``stream_grid_axes(10**6)``, 1,000,960
#: configurations, just under ``partition.STREAM_THRESHOLD``.
DENSE_N = 10**6


def dense_inputs(grid, dev) -> tuple:
    """What ``evaluate_grid`` hands kernel B for ``grid``: tables, shape,
    axis tensors and the flat indices ``arange(n)``."""
    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import sweep as SW

    S, axis_arrays, _ = SW.build_axes(**grid)
    shape = tuple(a.size for a in axis_arrays)
    flat = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=dev)
    return (B.device_tables(S, dev), shape,
            SW.axes_to_device(axis_arrays, dev), flat)


def staging(plan, n: int, smem_bytes: int):
    """Kernel B's ``plan`` for ``n`` indices with ``smem_bytes`` of
    tables and axes staged (0: read where they lie, a block a tile)."""
    tiles = -(-n // (plan.threads * plan.configs))
    return dataclasses.replace(plan, smem_bytes=smem_bytes,
                               blocks=plan.blocks if smem_bytes else tiles)


def eval_bytes(T, axvals, n: int, nf: int) -> int:
    """Bytes kernel B must move for ``n`` indices of ``nf`` channels: the
    tables and axis values read once, each 8-byte index read and each
    8-byte channel value written."""
    return (T.buf.numel() * 8 + sum(v.numel() * 8 for v in axvals)
            + n * 8 * (1 + nf))


def phase_dense_engine(dev, anchor) -> dict:
    """The dense engine at its largest size: ``evaluate_grid`` over the
    1,000,960-config grid, launches read around exactly that call (one of
    kernel B, none of A); every field bitwise equal to the plain path on
    the card (``backend="torch"``), NaN pattern included; argmin, top-4,
    finite count and front equal to ``anchor`` (frozen from the JAX
    reference).  Then B's device time there, its plain version's, and
    ``evaluate_grid``'s wall time split into the kernel, the eleven
    device-to-host copies and the rest."""
    from repro_torch.core import pareto as P
    from repro_torch.core import sweep as SW
    from repro_torch.core.grids import dense_summary, stream_grid_axes
    from repro_torch.kernels import sweep_grid as K

    grid = stream_grid_axes(DENSE_N)
    sync(dev)
    reset_counts()
    res = SW.evaluate_grid(**grid, device=dev)
    launches = read_counts()
    check(launches["B"] == 1 and launches["A"] == 0,
          f"evaluate_grid: launches {launches}, expected one of B, none "
          f"of A")
    plain = SW.evaluate_grid(**grid, backend="torch", device=dev)
    for f in SW.FIELDS:
        check(bitwise_equal(res.data[f], plain.data[f]),
              f"dense {res.n_configs} {f}: kernel B differs from the "
              f"plain path on the card")
    got = dense_summary(res.data, P.pareto_front(res).indices)
    for key, want in anchor.items():
        check(got[key] == want, f"dense {res.n_configs}: {key} {got[key]} "
              f"differs from the JAX anchor {want}")
    print(f"dense {res.n_configs} configs: one launch of B, bitwise equal "
          f"to the plain path, matches the JAX anchors (best "
          f"{got['best_avg_power']!r} W, front {got['front_size']})")

    T, shape, axvals, flat = dense_inputs(grid, dev)
    run = lambda: K.sweep_grid_eval(T, shape, SW.FIELDS, axvals, flat)  # noqa
    plain_b = lambda: K.sweep_grid_eval_ref(T, shape, SW.FIELDS,  # noqa
                                            axvals, flat)
    e = max_err(run(), plain_b(), f"kernel B n={flat.numel()}")
    check_bitwise(run(), plain_b(), f"kernel B n={flat.numel()}")
    out: dict = {"n": flat.numel(), "fields": len(SW.FIELDS),
                 "launches": launches["B"], "max_abs_err": e}
    timed(out, "ms", run, 20, "kernel B, dense")
    timed(out, "plain_ms", plain_b, 5, "kernel B, dense, plain")
    # the same launch with the tables read where they lie
    plan = K.kernel.eval_plan(flat.numel(), len(SW.FIELDS), flat.numel(),
                              K.kernel.stage_bytes(T, shape))
    unstaged = staging(plan, flat.numel(), 0)
    run_u = lambda: K.sweep_grid_eval(T, shape, SW.FIELDS,  # noqa
                                      axvals, flat, unstaged)
    check_bitwise(run_u(), plain_b(), f"kernel B n={flat.numel()} unstaged")
    out["plan"] = dataclasses.asdict(plan)
    timed(out, "unstaged_ms", run_u, 20, "kernel B, dense, unstaged")
    dev_out = run()
    out["copies_ms"] = host_ms(lambda: [v.cpu() for v in dev_out.values()],
                               5)
    out["wall_ms"] = host_ms(lambda: SW.evaluate_grid(**grid, device=dev), 5)
    out["rest_ms"] = out["wall_ms"] - out["ms"] - out["copies_ms"]
    out["bytes"] = eval_bytes(T, axvals, flat.numel(), len(SW.FIELDS))
    print(json.dumps({"dense_engine": out}))
    return out


def stream_split(res) -> dict:
    """A stream run's wall and its dispatch, wait and merge seconds."""
    return {k: res.stats[k] for k in (
        "n_configs", "n_chunks", "scan_chunks", "prefetch", "graph_replays",
        "total_s", "configs_per_s", "first_chunk_s", "dispatch_s",
        "device_wait_s", "host_merge_s", "fallback_chunks", "fallback_s")}


def prepared_plan(dev, **kw):
    """A stream plan and its chunk step, built (on the card: warmed up
    and its graph captured) ahead of the run that uses it, so that run
    launches kernel A only from graph replays.  Returns the plan and the
    seconds the step took to build."""
    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST

    plan = ST.plan_stream(**kw, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    step = B.cached_step(plan.spec, plan.backend, plan.scan, dev)
    step.busy = False
    sync(dev)
    return plan, time.perf_counter() - t0


def check_anchor_10m(res, anchor, what: str) -> float:
    """``res`` (a stream of the 10,009,600-config grid at the default
    objectives) against ``ANCHOR_10M``; returns the best power."""
    from repro_torch.core.grids import index_hash

    check(res.n_configs == anchor["n_configs"], f"{what}: grid size")
    check(res.min_idx["avg_power"] == anchor["argmin_idx"],
          f"{what}: argmin index differs from the JAX reference")
    best = res.min_val["avg_power"]
    check(abs(best - anchor["best_avg_power"])
          <= RTOL * anchor["best_avg_power"], f"{what}: best power differs")
    check(np.array_equal(res.topk_idx, np.asarray(anchor["topk_idx"])),
          f"{what}: top-k differs from the JAX reference")
    check(res.finite_counts["avg_power"] == anchor["finite"],
          f"{what}: valid count differs")
    check(res.front_indices.size == anchor["front_size"]
          and index_hash(res.front_indices) == anchor["front_hash"],
          f"{what}: front differs from the JAX reference")
    return best


def phase_stream(grid_big, grid_10m, anchor, dev) -> tuple:
    """The 100M stream at its defaults (auto scan fusion: K chunk steps a
    captured CUDA graph; prefetch 2), counts read around exactly that
    run: kernel A launched K times a replay.  Then the synchronous run
    (K = 1, prefetch 0), the plain backend at the defaults and the 10M
    JAX anchors: the same deliverables, bitwise where the kernels run."""
    from repro_torch.core import stream as ST

    plan, capture_s = prepared_plan(dev, **grid_big)
    check(plan.scan == 8, f"auto scan fusion gave K = {plan.scan}, not 8")
    reset_counts()
    res = ST.stream_grid(plan=plan)
    launches = read_counts()
    replays = int(res.stats["graph_replays"])
    check(replays == res.stats["n_chunks"] > 0,
          f"stream: {replays} graph replays for {res.stats['n_chunks']} "
          f"dispatches")
    check(launches["A"] == plan.scan * replays and launches["B"] > 0,
          f"main path: launches {launches}, expected A = {plan.scan} x "
          f"{replays} replays")
    print(f"stream {res.n_configs} configs via kernels (K {plan.scan}, "
          f"prefetch {res.stats['prefetch']:.0f}): "
          f"{res.stats['total_s']:.3f} s, {replays} replays, launches "
          f"{launches}, front {res.front_indices.size}; step built in "
          f"{capture_s:.3f} s")

    plan1, capture1_s = prepared_plan(dev, **grid_big, scan_chunks=1)
    sync1 = ST.stream_grid(plan=plan1, prefetch=0)
    same_deliverables(res, sync1, "stream default vs synchronous",
                      exact_values=True)
    check(np.array_equal(res.topk_val, sync1.topk_val)
          and res.channel_min == sync1.channel_min
          and res.channel_max == sync1.channel_max,
          "stream default vs synchronous: top-k values or bounds differ")
    print(f"stream {sync1.n_configs} configs synchronous (K 1, prefetch "
          f"0): {sync1.stats['total_s']:.3f} s, bitwise equal")

    plain = ST.stream_grid(**grid_big, backend="torch", device=dev)
    same_deliverables(res, plain, "stream cuda vs torch", exact_values=False)
    bitwise = (res.min_val == plain.min_val and np.array_equal(
        res.front_values, plain.front_values))
    print(f"stream {plain.n_configs} configs via plain torch on the card "
          f"(K {plain.stats['scan_chunks']:.0f}): "
          f"{plain.stats['total_s']:.3f} s, same deliverables "
          f"({'bitwise' if bitwise else 'within 1e-12'})")

    r10 = ST.stream_grid(**grid_10m, device=dev)
    best = check_anchor_10m(r10, anchor, "anchor")
    print(f"stream {r10.n_configs} configs matches the JAX anchors "
          f"(best {best!r} W, front {r10.front_indices.size}, K "
          f"{r10.stats['scan_chunks']:.0f})")
    paths = {"default": dict(stream_split(res), step_build_s=capture_s),
             "synchronous": dict(stream_split(sync1),
                                 step_build_s=capture1_s),
             "plain": stream_split(plain), "bitwise_plain": bitwise}
    return res, launches, paths, (plan, plan1)


def rel_err(got, want) -> float:
    """Largest relative difference of the entries that are finite in
    ``want`` (after checking the NaN patterns are the same); 0 when the
    infinities and everything else are equal."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(np.array_equal(np.isnan(got), np.isnan(want)), "NaN patterns")
    fin = np.isfinite(want)
    check(np.array_equal(got[~fin & ~np.isnan(want)],
                         want[~fin & ~np.isnan(want)]), "infinities")
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(got[fin] - want[fin])
                        / np.maximum(np.abs(want[fin]), 1e-300)))


def session_winners(data, axes) -> dict:
    """Dense session channels' deliverables: the argmin of peak
    temperature, the top-4 of each scenario objective (time-to-empty
    maximized; ties by flat index) and the front's flat indices, as
    ``SweepResult`` and ``pareto_front`` read them."""
    from repro_torch.core import pareto as P
    from repro_torch.core import sweep as SW
    from repro_torch.core.grids import SCENARIO_OBJECTIVES, top_k_flat

    tte, peak = (np.asarray(data[f]) for f in SCENARIO_OBJECTIVES)
    front = P.pareto_front(SW.SweepResult(axes=axes, data=data),
                           objectives=SCENARIO_OBJECTIVES,
                           maximize=SCENARIO_OBJECTIVES[:1])
    return {"argmin_peak": int(np.nanargmin(peak)),
            "top": {"time_to_empty_s": list(top_k_flat(-tte)),
                    "peak_case_temp_c": list(top_k_flat(peak))},
            "front": sorted(int(i) for i in front.indices)}


def phase_scenario(dev, smi: str, big_grid=None, anchor=None) -> dict:
    """The scenario engine on the card (the fourth path).

    (a) ``stream_grid(scenarios="all")`` over the 1,018,368-pair grid of
    the reference's scenario benchmark (20 session steps a pair), counts
    read around it (no kernel of A-E: scenario sweeps run the plain
    ``"torch"`` backend, its chunk step one captured CUDA graph), once
    cold (the step built and captured in the run) and once warm (timed),
    held to ``ANCHOR_SCENARIO_1M`` (frozen from the JAX reference), and
    the same pairs through the dense ``evaluate_grid`` on the card: the
    same argmin, top-4 and front.  (b) The reference grid densely on the
    card against the port's CPU run.  (c) ``simulate_session`` with the
    throttle engaged on the card, bitwise equal to the batched
    evaluation on the card.  (d) ``optimal_partition(scenarios="all")``
    on the card against the CPU.  Prints the ``scenario`` line."""
    from repro_torch.core import partition as PT
    from repro_torch.core import scenario as SC
    from repro_torch.core import stream as ST
    from repro_torch.core import sweep as SW
    from repro_torch.core.grids import (ANCHOR_SCENARIO_1M,
                                        SCENARIO_BIG_GRID,
                                        SCENARIO_OBJECTIVES,
                                        SCENARIO_REF_GRID, scenario_summary)

    big_grid = SCENARIO_BIG_GRID if big_grid is None else big_grid
    anchor = ANCHOR_SCENARIO_1M if anchor is None else anchor
    obj = SCENARIO_OBJECTIVES
    kw = dict(scenarios="all", objectives=obj, maximize=obj[:1],
              **big_grid)
    errs = []

    # (a) the acceptance-scale stream: cold, then warm on the same plan
    plan = ST.plan_stream(**kw, device=dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    cold = ST.stream_grid(plan=plan)
    sync(dev)
    cold_s = time.perf_counter() - t0
    launches = read_counts()
    check(not any(launches.values()),
          f"scenario stream launched kernels {launches}: it runs the "
          f"torch backend")
    check(cold.backend == plan.backend == "torch",
          f"scenario stream ran backend {cold.backend!r}, not 'torch'")
    res = ST.stream_grid(plan=plan)
    check(deliverables(res) == deliverables(cold),
          "scenario stream: warm run differs from the cold one")
    got = scenario_summary(res)
    for key in ("n_pairs", "best_tte_idx", "best_tte_trace", "min_peak_idx",
                "min_peak_trace", "topk_idx", "finite", "front_idx"):
        check(got[key] == anchor[key],
              f"scenario anchor {key}: {got[key]!r} != {anchor[key]!r}")
    for key in ("best_tte", "min_peak"):
        errs.append(rel_err(got[key], anchor[key]))
        check(errs[-1] <= RTOL, f"scenario anchor {key}: {got[key]!r} "
              f"vs {anchor[key]!r}")
    replays = int(res.stats["graph_replays"])
    check(replays == res.stats["n_chunks"] > 0 or dev.type != "cuda",
          f"scenario stream: {replays} graph replays for "
          f"{res.stats['n_chunks']} dispatches")
    # The busy share from one profiled run of the same plan: its device
    # time over its own wall time (a lower bound, as phase_stream's).
    profiled = []
    busy = device_busy(lambda: profiled.append(ST.stream_grid(plan=plan)))
    wall = res.stats["total_s"]
    n_steps = plan.S.step_tables[0].shape[1]
    print(f"scenario stream {res.n_configs} pairs x {n_steps} steps: "
          f"cold {cold_s:.3f} s, warm {wall:.3f} s "
          f"({res.n_configs / wall:.0f} pairs/s), matches the JAX anchor "
          f"(best tte {got['best_tte']!r} s on {got['best_tte_trace']})")

    sync(dev)
    t0 = time.perf_counter()
    dense = SW.evaluate_grid(**big_grid, scenarios="all", device=dev)
    dense_s = time.perf_counter() - t0
    check(tuple(dense.data) == SW.FIELDS + SW.SCENARIO_FIELDS,
          "scenario dense: channels")
    win = session_winners(dense.data, dense.axes)
    check(win["argmin_peak"] == res.min_idx["peak_case_temp_c"],
          "scenario dense vs stream: argmin")
    check([win["top"][o] for o in obj] == res.topk_idx.tolist(),
          "scenario dense vs stream: top-4")
    check(win["front"] == sorted(res.front_indices.tolist()),
          "scenario dense vs stream: front")
    flat = {f: dense.data[f].ravel() for f in obj}
    check(all(flat[f][res.min_idx[f]] == res.min_val[f] for f in obj),
          "scenario dense vs stream: values not bitwise")

    # (b) the reference grid: card against the CPU
    gpu = SW.evaluate_grid(**SCENARIO_REF_GRID, scenarios="all",
                           device=dev)
    cpu = SW.evaluate_grid(**SCENARIO_REF_GRID, scenarios="all",
                           device="cpu")
    for f in gpu.data:
        errs.append(rel_err(gpu.data[f], cpu.data[f]))
        check(errs[-1] <= RTOL, f"scenario ref grid {f}: {errs[-1]:.3e}")
    check(session_winners(gpu.data, gpu.axes)
          == session_winners(cpu.data, cpu.axes),
          "scenario ref grid: argmin, top-4 or front differ card vs cpu")

    # (c) the throttle engaged: loop twin vs batched, both on the card
    # gaming with the onset just above ambient, as the reference's
    # throttle parity test runs it
    sset = SC.ScenarioSet(traces=(SC.PROFILES["gaming"],),
                          thermal=dataclasses.replace(
                              SC.DEFAULT_THERMAL, throttle_onset_c=25.05,
                              throttle_gain_per_c=2.0))
    sim = SC.simulate_session(scenarios=sset, cut=11, detnet_fps=30.0,
                              device=dev)
    one = SW.evaluate_grid(cuts=(11,), detnet_fps=(30.0,), scenarios=sset,
                           device=dev)
    check(sim["throttle_fraction"] > 0.0, "throttle never engaged")
    for f in SW.SCENARIO_FIELDS:
        check(sim[f] == float(one.data[f].ravel()[0]),
              f"simulate_session vs batched on the card: {f} not bitwise")

    # (d) the partition search: card against the CPU
    pkw = dict(objective="time_to_empty_s", scenarios="all",
               constraints={"peak_case_temp_c": ("<=", 40.0)},
               sensor_node=("7nm", "16nm"), detnet_fps=(5.0, 15.0, 30.0))
    pg = PT.optimal_partition(**pkw, device=dev)
    pc = PT.optimal_partition(**pkw, device="cpu")
    check((pg.cut, pg.trace, pg.avg_power) == (pc.cut, pc.trace,
                                               pc.avg_power),
          f"optimal_partition: card {(pg.cut, pg.trace)} vs cpu "
          f"{(pc.cut, pc.trace)}")
    for f in SW.SCENARIO_FIELDS:
        errs.append(rel_err(pg.session[f], pc.session[f]))
        check(errs[-1] <= RTOL, f"optimal_partition session {f}")
    print(f"scenario: ref grid card == cpu within {max(errs):.3e}, "
          f"throttled session bitwise (throttled "
          f"{sim['throttle_fraction']:.4f}), partition winner cut "
          f"{pg.cut} on {pg.trace}")

    total = sum(busy.values())
    out = {"n_pairs": res.n_configs, "n_steps": n_steps, "wall_s": wall,
           "cold_wall_s": cold_s,
           "pairs_per_s": res.n_configs / wall,
           "evals_per_s": res.n_configs * n_steps / wall,
           "scan_chunks": res.stats["scan_chunks"],
           "graph_replays": res.stats["graph_replays"],
           "n_chunks": res.stats["n_chunks"],
           # the strided probe (eager: ~7,900 ops on 4,096 lanes) and the
           # first dispatch's survivors
           "first_chunk_s": res.stats["first_chunk_s"],
           "host_merge_s": res.stats["host_merge_s"],
           "fallback_s": res.stats["fallback_s"],
           "dispatch_s": res.stats["dispatch_s"],
           "device_wait_s": res.stats["device_wait_s"],
           "profiled_total_s": profiled[0].stats["total_s"],
           "device_busy_s": total,
           "device_busy_share": total / profiled[0].stats["total_s"],
           "dense_wall_s": dense_s, "backend": res.backend,
           "launches": launches, "max_rel_err": max(errs),
           "best_tte_s": got["best_tte"], "min_peak_c": got["min_peak"],
           "front_size": len(got["front_idx"]), "card": smi}
    print(json.dumps({"scenario": out}))
    return out


def deliverables(res) -> tuple:
    """Everything a stream result reduces, floats by their bits."""
    def bits(a):
        return np.asarray(a, np.float64).tobytes()
    return (tuple(sorted(res.min_idx.items())),
            bits([res.min_val[f] for f in res.min_val]),
            tuple(sorted(res.finite_counts.items())),
            bits([res.channel_min[f] for f in res.channel_min]),
            bits([res.channel_max[f] for f in res.channel_max]),
            res.topk_idx.tobytes(), bits(res.topk_val),
            res.front_indices.tobytes(), bits(res.front_values))


#: A child that streams the 10M grid on the card with a checkpoint a
#: dispatch and SIGKILLs itself at a chunk ordinal (argv: the checkpoint
#: directory, the ordinal).
_KILL_CHILD = """
import sys
from repro_torch.core import stream
from repro_torch.core.grids import stream_grid_axes
from repro_torch.runtime import FaultInjector, FaultPlan
stream.stream_grid(**stream_grid_axes(10_000_000), device="cuda",
                   checkpoint_dir=sys.argv[1], checkpoint_every_steps=1,
                   fault_injector=FaultInjector(FaultPlan(
                       kill_at=int(sys.argv[2]))))
print("UNREACHABLE")
"""


def phase_stream_resilience(dev) -> dict:
    """The 10M stream at its defaults, interrupted every way the executor
    recovers from, each bitwise equal to the uninterrupted run: a
    checkpointed run with injected transient faults and a lost device;
    a SIGKILLed child, resumed here; ``flat_range`` halves folded by
    ``merge_results``; a ``should_stop`` prefix against the
    ``flat_range`` run of the same prefix."""
    import shutil

    from repro_torch.core import stream as ST
    from repro_torch.core.grids import stream_grid_axes
    from repro_torch.runtime import FaultInjector, FaultPlan, RetryPolicy

    grid = stream_grid_axes(10_000_000)
    root = ROOT / "build" / "stream_resilience"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    whole = ST.stream_grid(**grid, device=dev)
    want = deliverables(whole)
    plan = ST.plan_stream(**grid, device=dev)
    per_step = plan.chunk * plan.scan
    n_disp = int(whole.stats["n_chunks"])
    out = {"n_configs": whole.n_configs, "scan_chunks": plan.scan,
           "dispatches": n_disp}

    inj = FaultInjector(FaultPlan(fail_chunks=(plan.scan * 3,),
                                  lose_device=(plan.scan * 11, 0)))
    res = ST.stream_grid(**grid, device=dev, fault_injector=inj,
                         checkpoint_dir=str(root / "faults"),
                         checkpoint_every_steps=2,
                         retry_policy=RetryPolicy(backoff_s=0.0))
    check(deliverables(res) == want, "resilience: faults run differs")
    check(res.stats["retries"] == 1.0 and res.stats["restarts"] == 1.0,
          f"resilience: retries {res.stats['retries']}, restarts "
          f"{res.stats['restarts']}")
    out["faults"] = {k: res.stats[k] for k in (
        "retries", "restarts", "chunks_reissued", "checkpoints_written",
        "checkpoint_write_s", "total_s")}

    ckpt = root / "killed"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, str(ckpt),
         str(plan.scan * (n_disp // 2) + 1)],
        env=env, capture_output=True, text=True, timeout=300)
    check(child.returncode == -9 and "UNREACHABLE" not in child.stdout,
          f"resilience: the child was not killed (rc {child.returncode}): "
          f"{child.stderr[-1500:]}")
    res = ST.stream_grid(**grid, device=dev, checkpoint_dir=str(ckpt),
                         checkpoint_every_steps=1)
    check(deliverables(res) == want, "resilience: resumed run differs")
    check(res.stats["resumed_from_step"] > 0, "resilience: no resume")
    out["sigkill"] = {"resumed_from_step": res.stats["resumed_from_step"],
                      "total_s": res.stats["total_s"]}

    cut = per_step * (n_disp // 2)
    parts = [ST.stream_grid(**grid, device=dev, flat_range=r)
             for r in ((cut, whole.n_configs), (0, cut))]
    merged = ST.merge_results(parts)
    check(deliverables(merged) == want, "resilience: merged halves differ")
    out["flat_range"] = {"cut": cut, "merge_s": merged.stats["merge_s"]}

    calls = []
    stop = 5
    part = ST.stream_grid(**grid, device=dev, should_stop=lambda: (
        calls.append(1) or len(calls) > stop))
    ranged = ST.stream_grid(**grid, device=dev,
                            flat_range=(0, stop * per_step))
    check(part.partial and deliverables(part) == deliverables(ranged),
          "resilience: the stopped prefix differs from its flat_range run")
    out["should_stop"] = {"fraction_complete":
                          part.stats["fraction_complete"]}
    shutil.rmtree(root, ignore_errors=True)
    print(f"stream_resilience {whole.n_configs} configs (K {plan.scan}): "
          f"faults, SIGKILL + resume, flat_range + merge_results, "
          f"should_stop: all bitwise equal to the uninterrupted run")
    return out


def phase_optimize(dev, smi: str) -> dict:
    """The knob optimizer on the card (the fifth path), at the reference's
    own search (``examples/partition_study.py``: ``OPTIMIZE_SEARCH``).
    ``gradient`` at the default knobs (float64 autograd through the
    plain Eq. 1-11) equals the port's CPU result and ``ANCHOR_OPTIMIZE``
    (frozen from the JAX reference) within 1e-12 relative;
    ``optimize_knobs`` (200 projected-Adam steps) holds its knobs,
    objective and trajectory to the anchor within the CPU tests' 1e-6
    (float32 Adam state); ``grid_argmin`` over the 41 x 41 grid, counts
    read around exactly that call (one launch of kernel B, none of A),
    gives the anchor's knobs exactly and its value within 1e-12.  Prints
    the ``optimize`` line (wall times, steps/s, card)."""
    from repro_torch.core import optimize as O
    from repro_torch.core.grids import ANCHOR_OPTIMIZE, OPTIMIZE_SEARCH

    s, a = OPTIMIZE_SEARCH, ANCHOR_OPTIMIZE
    errs = []
    v_card, g_card = O.gradient(s["objective"], device=dev, **s["config"])
    v_cpu, g_cpu = O.gradient(s["objective"], device="cpu", **s["config"])
    for what, got, cpu, want in [("value", v_card, v_cpu,
                                  a["gradient_value"])] + [
            (k, g_card[k], g_cpu[k], a["gradient"][k]) for k in O.KNOBS]:
        errs += [rel_err(got, cpu), rel_err(got, want)]
        check(max(errs[-2:]) <= RTOL, f"optimize gradient {what}: card "
              f"{got!r}, cpu {cpu!r}, JAX anchor {want!r}")

    def search():
        sync(dev)
        t0 = time.perf_counter()
        res = O.optimize_knobs(s["bounds"], s["objective"],
                               steps=s["steps"], device=dev, **s["config"])
        sync(dev)
        return res, time.perf_counter() - t0

    cold, cold_s = search()
    res, wall = search()
    traj_err = rel_err(res.trajectory, a["trajectory"])
    check(traj_err <= 1e-6 and np.array_equal(cold.trajectory,
                                              res.trajectory),
          f"optimize_knobs trajectory: {traj_err:.3e} from the JAX anchor")
    for k, v in res.knobs.items():
        check(rel_err(v, a["knobs"][k]) <= 1e-6,
              f"optimize_knobs {k}: {v!r} vs the anchor {a['knobs'][k]!r}")
    check(rel_err(res.objective, a["objective"]) <= 1e-6,
          "optimize_knobs objective differs from the anchor")
    t0 = time.perf_counter()
    O.optimize_knobs(s["bounds"], s["objective"], steps=s["steps"],
                     device="cpu", **s["config"])
    cpu_s = time.perf_counter() - t0

    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    knobs, value = O.grid_argmin(s["bounds"], s["objective"], n=s["n"],
                                 device=dev, **s["config"])
    grid_s = time.perf_counter() - t0
    launches = read_counts()
    check(launches == dict(A=0, B=1, C=0, D=0, E=0),
          f"grid_argmin: launches {launches}, expected one of B only")
    check(knobs == a["grid_knobs"], f"grid_argmin knobs {knobs}")
    errs.append(rel_err(value, a["grid_value"]))
    check(errs[-1] <= RTOL, f"grid_argmin value {value!r}")
    out = {"steps": s["steps"], "wall_s": wall, "cold_wall_s": cold_s,
           "steps_per_s": s["steps"] / wall, "host_cpu_wall_s": cpu_s,
           "knobs": res.knobs, "objective": res.objective,
           "trajectory_max_rel_err": traj_err,
           "grid_n": s["n"] ** len(s["bounds"]), "grid_argmin_wall_s": grid_s,
           "grid_knobs": knobs, "grid_value": value, "launches": launches,
           "max_rel_err": max(errs), "card": smi}
    print(f"optimize: gradient card == cpu == JAX anchor, {s['steps']} "
          f"steps in {wall:.3f} s ({s['steps'] / wall:.1f} steps/s), "
          f"knobs {res.knobs}, grid_argmin one launch of B")
    print(json.dumps({"optimize": out}))
    return out


def phase_stream_devices(dev, smi: str, grid=None, anchor=None,
                         **kw) -> dict:
    """``stream_grid(devices=...)`` on the card: the 10,009,600-config
    grid with ``backend="torch"`` (the reference's ``xla`` counterpart;
    the ``"cuda"`` kernels take one card, as its Pallas backend does), on
    one shard and on two shards of one card (each its own step, graph
    and stream), bitwise equal and both held to ``ANCHOR_10M``; two
    shards losing shard 1 mid-run (checkpointed): one elastic replan,
    chunks re-issued, bitwise the uninterrupted run; ``backend="cuda"``
    with two explicit devices refused; ``devices=None`` one shard on the
    default backend and every visible card on ``"torch"``.  With more
    than one card, every card as a shard, bitwise the same.  No kernel
    of A-E runs in the sharded streams.  Prints the ``stream_devices``
    line.  ``grid`` and ``anchor`` (``check_anchor_10m``'s keys) replace
    the 10M grid and ``ANCHOR_10M``, and ``kw`` (e.g. ``chunk_size``)
    goes to every stream, for a rehearsal on the CPU."""
    import shutil

    import torch

    from repro_torch.core import stream as ST
    from repro_torch.core.grids import ANCHOR_10M, stream_grid_axes
    from repro_torch.runtime import FaultInjector, FaultPlan

    grid = stream_grid_axes(10_000_000) if grid is None else grid
    anchor = ANCHOR_10M if anchor is None else anchor
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    card0 = f"cuda:{dev.index or 0}" if on_card else str(dev)
    root = ROOT / "build" / "stream_devices"
    shutil.rmtree(root, ignore_errors=True)
    out: dict = {"n_configs": None, "card": smi}

    def timed_run(devices):
        ST.stream_grid(**grid, **kw, backend="torch", devices=devices)
        sync(dev)
        reset_counts()
        res = ST.stream_grid(**grid, **kw, backend="torch", devices=devices)
        launches = read_counts()
        check(not any(launches.values()),
              f"stream_devices {devices}: kernels launched {launches}")
        return res

    one = timed_run((card0,))
    two = timed_run((card0, card0))
    want = deliverables(one)
    check(deliverables(two) == want,
          "stream_devices: two shards differ from one shard")
    for res, what in ((one, "one shard"), (two, "two shards")):
        check_anchor_10m(res, anchor, f"stream_devices {what}")
    check(two.n_devices == 2 and one.n_devices == 1, "n_devices")
    out.update(n_configs=one.n_configs,
               one_shard=stream_split(one), two_shards=stream_split(two))

    per_step = two.chunk_size * int(two.stats["scan_chunks"]) * 2
    lose_at = int(two.stats["n_chunks"]) // 2 * per_step // two.chunk_size
    inj = FaultInjector(FaultPlan(lose_device=(lose_at, 1)))
    lost = ST.stream_grid(**grid, **kw, backend="torch",
                          devices=(card0, card0),
                          fault_injector=inj, checkpoint_dir=str(root),
                          checkpoint_every_steps=4)
    check(lost.stats["elastic_replans"] == 1.0
          and lost.stats["chunks_reissued"] > 0
          and lost.stats["restarts"] == 0.0,
          f"stream_devices lost shard: {lost.stats}")
    check(deliverables(lost) == want,
          "stream_devices: the replanned run differs")
    out["lost_shard"] = {k: lost.stats[k] for k in (
        "elastic_replans", "chunks_reissued", "checkpoints_written",
        "total_s")}
    out["lost_shard"]["lost_at_chunk"] = lose_at
    shutil.rmtree(root, ignore_errors=True)

    try:
        ST.stream_grid(**grid, **kw, backend="cuda", devices=(card0, card0))
    except ValueError as e:
        check("multi-device" in str(e), f"unexpected refusal: {e}")
    else:
        raise SmokeFailure("backend='cuda' took two explicit devices")
    default = ST.stream_grid(**grid, **kw, device=dev)
    check(default.n_devices == 1
          and default.backend == ("cuda" if on_card else "torch"),
          f"devices=None on the default backend: {default.n_devices} "
          f"shards of {default.backend}")
    check_anchor_10m(default, anchor, "stream_devices default")
    cards = torch.cuda.device_count() if on_card else 1
    auto = ST.stream_grid(**grid, **kw, backend="torch", device=dev.type)
    check(auto.n_devices == cards,
          f"devices=None on torch: {auto.n_devices} shards, {cards} cards")
    check(deliverables(auto) == want, "stream_devices: every card differs")
    out["cards"] = cards
    if cards > 1:
        every = timed_run(tuple(f"cuda:{i}" for i in range(cards)))
        check(deliverables(every) == want,
              "stream_devices: the shards over every card differ")
        out["every_card"] = stream_split(every)
    print(f"stream_devices {one.n_configs} configs: 1 shard "
          f"{one.stats['total_s']:.3f} s, 2 shards on one card "
          f"{two.stats['total_s']:.3f} s, bitwise equal and on the JAX "
          f"anchors; lost shard replanned bitwise; {cards} card(s)")
    print(json.dumps({"stream_devices": out}))
    return out


#: The service phase's workload: the reference service benchmark's own
#: (``benchmarks/service_bench.py``): the 10,009,600-config grid with
#: ``track="all"``, 8 tenants each streaming ``_grid_for(10**5)`` (97,920
#: configs) at a private KeyNet rate, pools of 1 and 2 worker processes
#: warmed on the 10,880-config reference grid first.
SERVICE_TENANTS = 8
SERVICE_WORKERS = (1, 2)
#: The pools' lease heartbeat TTL: a SIGKILLed worker's lease is
#: reissued this long after its last heartbeat.
SERVICE_TTL_S = 3.0
#: The request the networked phase SIGKILLs its server under: long
#: enough (191 dispatches, each checkpointed) that the kill at its first
#: progress snapshot (0.5 s in) lands mid-run.
SERVICE_KILL_N = 100_000_000
SERVICE_KILL_KW = dict(chunk_size=65536)


def service_workload() -> dict:
    """The service phase's grids: the big request's (with its anchor),
    the tenants' base, the pools' warm-up grid, and the networked kill's
    grid and arguments."""
    from repro_torch.core.grids import (ANCHOR_10M, REFERENCE_GRID,
                                        stream_grid_axes)

    return {"grid": stream_grid_axes(10**7), "anchor": ANCHOR_10M,
            "tenant_base": stream_grid_axes(10**5),
            "warm_grid": REFERENCE_GRID,
            "kill_grid": stream_grid_axes(SERVICE_KILL_N),
            "kill_kw": SERVICE_KILL_KW}


def tenant_grids(base: dict) -> list:
    """The service benchmark's tenant jobs over ``base``: one private
    KeyNet rate each, so no two fuse and none dedupes."""
    return [dict(base, keynet_fps=(15.0 + i, 30.0))
            for i in range(SERVICE_TENANTS)]


def same_result(got, want, what: str) -> None:
    check(deliverables(got) == deliverables(want),
          f"{what}: differs from the solo stream_grid run")


def tenant_burst(svc, grids: list, solos: list) -> dict:
    """Each tenant's job from its own thread, all at once; every result
    bitwise its solo run.  Returns the submit-to-result percentiles."""
    import threading

    from repro_torch.core.service import SweepRequest

    n = len(grids)
    lat, res, errs = [0.0] * n, [None] * n, []

    def one(i):
        t0 = time.perf_counter()
        try:
            res[i] = svc.submit(SweepRequest(
                grid=grids[i], tenant=f"tenant-{i}")).result(timeout=900)
        except BaseException as e:      # re-raised below
            errs.append(e)
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=1200)
    check(not any(th.is_alive() for th in threads), "tenants: hung")
    if errs:
        raise errs[0]
    for i in range(n):
        same_result(res[i], solos[i], f"tenant {i}")
    return {"ticket_p50_s": float(np.percentile(lat, 50)),
            "ticket_p95_s": float(np.percentile(lat, 95)),
            "tickets_s": lat}


def _leased(spool: pathlib.Path, signature: str) -> list:
    """The leases of one job that are leased right now."""
    try:
        board = json.loads((spool / "jobs" / signature[:24]
                            / "board.json").read_text())
    except (OSError, ValueError):
        return []
    return [ls for ls in board["leases"] if ls["state"] == "leased"]


def kill_worker(svc, spool: pathlib.Path, req, want) -> dict:
    """Submit ``req`` to the pooled ``svc`` and SIGKILL a worker while it
    holds one of the job's leases (again, should the lease have finished
    in the race): the lease is reissued and the fold is still bitwise
    ``want``."""
    import signal

    before = svc.counters["leases_reissued"]
    t = svc.submit(req)
    killed, confirmed = [], False
    deadline = time.monotonic() + 300
    while not confirmed and not t.done() and time.monotonic() < deadline:
        if t.signature is not None and len(killed) < 4:
            pids = svc._pool.pids()
            for ls in _leased(spool, t.signature):
                if ls["owner"] in pids and ls["owner"] not in killed:
                    os.kill(ls["owner"], signal.SIGKILL)
                    killed.append(ls["owner"])
                    time.sleep(0.05)
                    # Dead mid-lease iff its lease is still leased to it.
                    confirmed = any(
                        x["i"] == ls["i"] and x["owner"] == ls["owner"]
                        for x in _leased(spool, t.signature))
                    break
        time.sleep(0.01)
    res = t.result(timeout=900)
    check(confirmed, f"pooled kill: no worker was killed mid-lease "
                     f"(killed {killed})")
    same_result(res, want, "pooled run with a SIGKILLed worker")
    reissued = svc.counters["leases_reissued"] - before
    check(reissued >= 1, f"pooled kill: {reissued} leases reissued")
    return {"workers_killed": len(killed), "leases_reissued": reissued,
            "n_parts": int(res.stats["n_parts"])}


def pooled(dev, n_workers: int, grid: dict, warm_grid: dict, want,
           tenants: list, solos: list, root: pathlib.Path,
           kill=None) -> dict:
    """``SweepService(workers=n)`` over its own spool: warmed on
    ``warm_grid``, then the big request timed (bitwise ``want``), the
    tenant burst, and with ``kill=(request, solo)`` a worker SIGKILLed
    mid-lease."""
    from repro_torch.core.service import SweepRequest, SweepService

    spool = root / f"pool{n_workers}"
    svc = SweepService(device=dev, workers=n_workers, capacity=64,
                       snapshot_every_s=0.0, worker_ttl_s=SERVICE_TTL_S,
                       spool_dir=str(spool))
    try:
        t0 = time.perf_counter()
        svc.submit(SweepRequest(grid=warm_grid,
                                track="all")).result(timeout=900)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = svc.submit(SweepRequest(grid=grid,
                                      track="all")).result(timeout=900)
        wall = time.perf_counter() - t0
        same_result(res, want, f"pooled, {n_workers} worker(s)")
        # The parts' own stream times (the slowest part's wall; the
        # rest summed over the parts) beside the job's wall.
        out = {"warm_s": warm_s, "wall_s": wall,
               "configs_per_s": res.n_configs / wall,
               "n_parts": int(res.stats["n_parts"]),
               "leases_reissued": int(svc.counters["leases_reissued"]),
               "parts": {k: res.stats[k] for k in (
                   "total_s", "dispatch_s", "device_wait_s",
                   "host_merge_s", "fallback_s", "merge_s")}}
        check(svc.counters["pooled_executions"] == 2,
              f"pooled: {svc.counters}")
        out.update(tenant_burst(svc, tenants, solos))
        if kill is not None:
            out["kill"] = kill_worker(svc, spool, *kill)
    finally:
        svc.close()
    return out


def _server(argv: list, log: pathlib.Path):
    """``python -m repro_torch.service`` as a child; returns it and the
    address of its ready line."""
    import select

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(log, "ab") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.service", *argv],
            env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=err, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait(30)
        raise SmokeFailure(f"service child not ready: "
                           f"{log.read_text()[-2000:]}")
    return proc, json.loads(line)["listening"]


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def networked(dev, grid: dict, want, kill_req, kill_want,
              root: pathlib.Path) -> dict:
    """The service as ``python -m repro_torch.service --listen`` child on
    the card behind a token, driven by ``SweepClient``: the big request
    (watched, bitwise ``want``); a wrong token refused at the handshake;
    the server SIGKILLed mid-``kill_req`` and restarted over the same
    spool and port: the client reconnects, dedupes onto the recovered
    ticket, and the resumed result is bitwise ``kill_want``."""
    import secrets
    import threading

    from repro_torch.core.client import AuthenticationError, SweepClient
    from repro_torch.core.service import SweepRequest

    token = secrets.token_hex(16)
    spool = root / "net"
    log = root / "net_server.log"
    argv = ["--auth-token", token, "--spool", str(spool),
            "--checkpoint-every-steps", "1", "--device", str(dev)]
    out: dict = {}
    t0 = time.perf_counter()
    proc, addr = _server(["--listen", "127.0.0.1:0", *argv], log)
    out["server_start_s"] = time.perf_counter() - t0
    try:
        with SweepClient(addr, auth=token) as cli:
            snaps: list = []
            t0 = time.perf_counter()
            res = cli.submit(SweepRequest(grid=grid, track="all")).result(
                timeout=900, on_progress=snaps.append)
            out.update(wall_s=time.perf_counter() - t0,
                       snapshots=len(snaps),
                       watch_wire_bytes=res.stats.get("watch_wire_bytes"))
            same_result(res, want, "networked")
        with SweepClient(addr, auth="wrong", reconnect_timeout_s=5.0) as bad:
            try:
                bad.ping()
            except AuthenticationError as e:
                check("rejected" in str(e), f"wrong token: {e}")
            else:
                raise SmokeFailure("networked: a wrong token was served")
        with SweepClient(addr, auth=token) as cli:
            tr = cli.health()["transport"]
        check(tr["auth_failures"] >= 1, f"auth failures: {tr}")
        out["auth_failures"] = tr["auth_failures"]

        cli = SweepClient(addr, auth=token, reconnect_timeout_s=240.0,
                          heartbeat_grace_s=8.0)
        ticket = cli.submit(kill_req, client_id="chaos-1")
        first_id, seen, box = ticket.id, {"frac": 0.0, "n": 0}, {}

        def progress(snap):
            seen.update(frac=snap["fraction_complete"], n=seen["n"] + 1)

        def wait_result():
            try:
                box["res"] = ticket.result(timeout=900,
                                           on_progress=progress)
            except BaseException as e:      # checked below
                box["err"] = e

        th = threading.Thread(target=wait_result)
        th.start()
        deadline = time.monotonic() + 300
        while seen["frac"] == 0.0 and th.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        check(seen["frac"] > 0.0, f"networked: no progress before the "
                                  f"kill ({box.get('err')!r})")
        proc.kill()
        proc.wait(30)
        out["killed_at_fraction"] = seen["frac"]
        journal = [json.loads(p.read_text())
                   for p in (spool / "requests").glob("*.json")]
        check(any(j["client_id"] == "chaos-1" and j["state"] == "running"
                  for j in journal), "networked: the kill missed the run")
        t0 = time.perf_counter()
        proc, _ = _server(["--listen", addr, *argv], log)
        out["restart_s"] = time.perf_counter() - t0
        th.join(900)
        check(not th.is_alive(), "networked: the client hung")
        check("err" not in box, f"networked resume: {box.get('err')!r}")
        res = box["res"]
        check(ticket.id == first_id, "networked: resubmit not deduped")
        check(res.stats["resumed_from_step"] > 0,
              f"networked: not resumed ({res.stats})")
        same_result(res, kill_want, "networked after a server SIGKILL")
        tr = cli.health()["transport"]
        out.update(resumed_from_step=res.stats["resumed_from_step"],
                   reconnects=cli.counters["reconnects"],
                   kill_snapshots=seen["n"],
                   restarted_watch_bytes={k: tr[k] for k in (
                       "watch_snapshot_bytes", "watch_delta_bytes")})
        check(cli.counters["reconnects"] >= 2, f"{cli.counters}")
        cli.close()
    finally:
        _stop(proc)
    return out


def phase_service(dev, smi: str, **workload) -> dict:
    """The serving stack on the card (card 0 by index) through kernels A
    and B, at the reference service benchmark's workload:

    (a) ``SweepService(device=dev)`` serves the 10M request, counts read
        around it: bitwise the solo ``stream_grid`` (and on
        ``ANCHOR_10M``), the same launches of A and B as the solo run; a
        resubmit hits the plan and step caches (no new capture); the same
        request on two services at once, and a fused batch of three,
        bitwise; a deadline lapsing mid-run returns the prefix, bitwise
        its ``flat_range`` run.
    (b) The 8 tenants from 8 threads, each bitwise its solo run.
    (c) Pools of 1 and 2 worker processes (one CUDA context each),
        warmed, then the 10M request timed: bitwise the solo run; with 2,
        a worker SIGKILLed mid-lease, its lease reissued.
    (d) The networked service (:func:`networked`).

    ``workload`` (:func:`service_workload`'s keys; ``anchor=None`` skips
    the anchor check) replaces the workload for a rehearsal on the CPU.
    Prints the ``service`` line."""
    import shutil
    import threading

    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST
    from repro_torch.core.service import SweepRequest, SweepService
    from repro_torch.runtime import FaultInjector, FaultPlan

    on_card = torch.device(dev).type == "cuda"
    w = workload or service_workload()
    grid, anchor, tenant_base = w["grid"], w["anchor"], w["tenant_base"]
    warm_grid, kill_grid, kill_kw = (w["warm_grid"], w["kill_grid"],
                                     w["kill_kw"])
    t_phase = time.perf_counter()
    root = ROOT / "build" / "service"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    req = SweepRequest(grid=grid, track="all")
    out: dict = {"card": smi}

    def solo_run(g, **kw):
        sync(dev)
        t0 = time.perf_counter()
        res = ST.stream_grid(**g, **kw, device=dev)
        sync(dev)
        return res, time.perf_counter() - t0

    # (a) In process.  The solo run twice (the first warms the caching
    # allocator); each plans anew and captures its step, as the
    # service's first request does.
    solo_run(grid, track="all")
    reset_counts()
    solo, solo_s = solo_run(grid, track="all")
    solo_launches = read_counts()
    if anchor is not None:
        check_anchor_10m(solo, anchor, "service solo")
    with SweepService(device=dev, capacity=64,
                      snapshot_every_s=0.0) as svc:
        reset_counts()
        t0 = time.perf_counter()
        served = svc.submit(req).result(timeout=900)
        served_s = time.perf_counter() - t0
        launches = read_counts()
        same_result(served, solo, "served in process")
        check(launches == solo_launches
              and (not on_card or launches["A"] > 0 and launches["B"] > 0),
              f"service launches {launches}, solo {solo_launches}")
        steps = B.step_cache_stats()
        t0 = time.perf_counter()
        again = svc.submit(req).result(timeout=900)
        again_s = time.perf_counter() - t0
        same_result(again, solo, "resubmitted")
        h, steps2 = svc.health(), B.step_cache_stats()
        check(h["plan_cache"]["hits"] == 1
              and h["plan_cache"]["misses"] == 1
              and steps2["hits"] > steps["hits"]
              and steps2["misses"] == steps["misses"],
              f"resubmit missed a cache: {h['plan_cache']}, steps "
              f"{steps} -> {steps2}")

        # The same request on a second service at once: each its own
        # plan, step and graph.
        with SweepService(device=dev, capacity=64,
                          snapshot_every_s=0.0) as svc2:
            box: dict = {}
            th = threading.Thread(target=lambda: box.__setitem__(
                "r", svc2.submit(req).result(timeout=900)))
            th.start()
            mine = svc.submit(req).result(timeout=900)
            th.join(900)
            check("r" in box, "second service: no result")
            same_result(box["r"], solo, "second service")
            same_result(mine, solo, "first service beside the second")

        svc.pause()
        head = svc.submit(req)
        rest = [svc.submit(SweepRequest(grid=grid, track="all", top_k=2)),
                svc.submit(SweepRequest(grid=grid, track=None,
                                        objectives=("avg_power",),
                                        need_front=False))]
        execs = svc.counters["executions"]
        svc.resume()
        fused = [t.result(timeout=900) for t in [head, *rest]]
        check(svc.counters["executions"] == execs + 1
              and fused[0].stats["fused_members"] == 3.0,
              f"fusion: {svc.counters}")
        same_result(fused[0], solo, "fused head")
        check(np.array_equal(fused[1].topk_idx, solo.topk_idx[:, :2])
              and fused[2].min_idx == {"avg_power":
                                       solo.min_idx["avg_power"]}
              and fused[2].front_indices.size == 0,
              "fused members differ from their slices of the solo run")

        # (b) Tenants.
        tenants = tenant_grids(tenant_base)
        solos = [solo_run(g)[0] for g in tenants]
        burst = tenant_burst(svc, tenants, solos)

    # A deadline that lapses mid-run (a 1 s straggle injected before the
    # second dispatch, one chunk a dispatch): the partial result is the
    # flat_range run of the prefix it folded.
    dkw = dict(track="all", chunk_size=4096, scan_chunks=1)
    with SweepService(device=dev, fault_injector=FaultInjector(
            FaultPlan(straggle={1: 1.0}))) as svc:
        part = svc.submit(SweepRequest(grid=grid, deadline_s=0.5, **dkw)
                          ).result(timeout=900)
        expired = svc.counters["deadline_expired"]
    frac = part.stats["fraction_complete"]
    check(part.partial and 0.0 < frac < 1.0 and expired == 1,
          f"deadline: partial {part.partial}, fraction {frac}")
    base = round(frac * part.n_configs)
    same_result(part, solo_run(grid, flat_range=(0, base), **dkw)[0],
                "deadline prefix vs its flat_range run")
    plan = ST.plan_stream(**grid, track="all", device=dev)
    ST.stream_grid(plan=plan)
    _, solo_warm_s = solo_run({}, plan=plan)
    out["in_process"] = {
        "n_configs": solo.n_configs, "served_s": served_s,
        "solo_s": solo_s, "overhead_s": served_s - solo_s,
        "resubmit_s": again_s, "solo_warm_s": solo_warm_s,
        "warm_overhead_s": again_s - solo_warm_s, "launches": launches,
        "plan_cache": h["plan_cache"],
        "step_cache_hits": steps2["hits"] - steps["hits"]}
    out["tenants"] = burst
    out["deadline"] = {"fraction_complete": frac, "prefix_configs": base}

    # (c) Pooled.
    kill_req = SweepRequest(grid=grid, track="all", top_k=5)
    kill_want, _ = solo_run(grid, track="all", top_k=5)
    out["pooled"] = {}
    for n in SERVICE_WORKERS:
        out["pooled"][str(n)] = pooled(
            dev, n, grid, warm_grid, solo, tenants, solos, root,
            kill=((kill_req, kill_want) if n == max(SERVICE_WORKERS)
                  else None))

    # (d) Networked.
    net_kill = SweepRequest(grid=kill_grid, track="all", **kill_kw)
    net_want, _ = solo_run(kill_grid, track="all", **kill_kw)
    out["networked"] = networked(dev, grid, solo, net_kill, net_want, root)
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase

    ip, pw = out["in_process"], out["pooled"]
    print(f"service {solo.n_configs} configs on {smi}: served "
          f"{served_s:.3f} s (solo {solo_s:.3f} s, overhead "
          f"{served_s - solo_s:+.3f} s), resubmit {again_s:.3f} s (solo "
          f"{solo_warm_s:.3f} s); tenants p50 {burst['ticket_p50_s']:.3f} "
          f"s p95 {burst['ticket_p95_s']:.3f} s; pooled "
          + ", ".join(f"{n} worker(s) {p['configs_per_s']:.4g} configs/s"
                      for n, p in pw.items())
          + f"; networked {out['networked']['wall_s']:.3f} s; all bitwise "
          f"equal to the solo runs; launches {ip['launches']}")
    print(json.dumps({"service": out, "card": smi}))
    return out


def kernel_report(res, launches, err, grid_big, dense, dev) -> list:
    """Time both kernels and their plain versions at the main path's
    shapes: kernel A on a full chunk of the 100M plan with the final
    front's filter, kernel B on the stream probe's 4096 indices and, from
    ``dense`` (:func:`phase_dense_engine`), on the dense engine's
    1,000,960.  Kernel B's instances must report no stack frame and no
    spills."""
    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST
    from repro_torch.core import sweep as SW
    from repro_torch.kernels import sweep_grid as K
    from repro_torch.kernels.sweep_grid.kernel import LIBRARY

    plan = ST.plan_stream(**grid_big, device=dev)
    spec = plan.spec
    T = B.device_tables(plan.S, dev)
    axvals = SW.axes_to_device(plan.axis_vals, dev)
    sign = np.asarray(plan.sign)
    aux = make_aux(spec, (), res.front_values * sign, dev)
    nf, d, CP, Bn = len(spec.fields), spec.d, spec.padded, spec.n_blocks
    run_a = lambda: K.sweep_grid_chunk(spec, T, axvals, aux, 0)  # noqa
    plain_a = lambda: K.chunk_partials_ref(spec, T, axvals, aux, 0)  # noqa
    times: dict = {}
    timed(times, "A", run_a, 50, "kernel A")
    timed(times, "A_plain", plain_a, 5, "kernel A, plain")
    host = {"A": host_ms(run_a, 50), "A_plain": host_ms(plain_a, 5)}
    filt_bytes = sum(v.numel() * 8 for v in aux["filter"].values())
    bytes_a = (T.buf.numel() * 8 + sum(v.numel() * 8 for v in axvals)
               + filt_bytes
               + CP * d * (8 + 8 + 1) + CP            # Fd, Fsg, valid, keep
               + Bn * nf * (8 + 8 + 4 + 8) + Bn * d * 8)
    # Float64 operations of the chunk: a lane's Eq. 1-11 as the built
    # eval_kernel issues it, then (from the source) the signs and the block
    # reductions (about one combine a lane: two compares and a max per
    # tracked field, a min per objective); the filter's work is what this
    # chunk's data needs (a lane stops at the first row that dominates it
    # and only then reaches the table): two compares per row scanned and
    # objective, the edge searches and the table compare.
    sass = sass_fp64(LIBRARY.path())
    eq_ops = sass["eval_kernel"]["fp64"]
    scanned, to_table = filter_work(aux["filter"], plain_a()["Fsg"])
    bins = spec.filter_bins + 1
    ops_a = (spec.chunk * (eq_ops + d + 3 * nf + d) + 2 * d * scanned
             + to_table * ((d - 1) * int(np.ceil(np.log2(bins))) + 1))
    usage = ptxas_usage(LIBRARY.info.get("ptxas", ""))
    usage_a = next((u for name, u in usage.items() if "chunk_kernel" in name),
                   dict.fromkeys(PTXAS_KEYS))
    plan_a = K.kernel.chunk_plan(spec)
    if usage_a["registers"] is not None:
        no_spills("kernel A", usage_a)
        check(usage_a["registers"] <= plan_a.registers,
              f"kernel A uses {usage_a['registers']} registers, its plan "
              f"{plan_a.registers}")

    n = plan.n_total
    m = int(min(ST._PROBE, max(256, n // 128), n))
    flat = torch.as_tensor(np.unique(np.linspace(0, n - 1, m)
                                     .astype(np.int64)), device=dev)
    nb = flat.numel()
    run_b = lambda: K.sweep_grid_eval(T, plan.shape, SW.FIELDS,  # noqa
                                      axvals, flat)
    plain_b = lambda: K.sweep_grid_eval_ref(T, plan.shape,  # noqa
                                            SW.FIELDS, axvals, flat)
    check_bitwise(run_b(), plain_b(), f"kernel B n={nb}")
    # the probe's launch with the tables staged (its plan reads them where
    # they lie)
    plan_b = K.kernel.eval_plan(nb, len(SW.FIELDS), n,
                                K.kernel.stage_bytes(T, plan.shape))
    staged_b = staging(plan_b, nb, K.kernel.stage_bytes(T, plan.shape))
    run_bs = lambda: K.sweep_grid_eval(T, plan.shape, SW.FIELDS,  # noqa
                                       axvals, flat, staged_b)
    check_bitwise(run_bs(), plain_b(), f"kernel B n={nb} staged")
    timed(times, "B", run_b, 50, "kernel B")
    timed(times, "B_plain", plain_b, 5, "kernel B, plain")
    timed(times, "B_staged", run_bs, 50, "kernel B, staged")
    host.update(B=host_ms(run_b, 50), B_plain=host_ms(plain_b, 5))
    bytes_b = eval_bytes(T, axvals, nb, len(SW.FIELDS))
    ops_b = nb * eq_ops
    rate = fp64_rate()
    print(json.dumps({"sass_fp64": sass, "fp64_ops_per_s": rate}))

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / rate * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    rows = []
    for name, fn, src, rep, key, nbytes, ops in (
            ("sweep_grid_chunk", "chunk_kernel",
             "src/repro_torch/kernels/sweep_grid/csrc/sweep_grid.cu",
             "src/repro/kernels/sweep_grid/kernel.py:98", "A", bytes_a,
             ops_a),
            ("sweep_grid_eval", "eval_kernel",
             "src/repro_torch/kernels/sweep_grid/csrc/sweep_grid.cu",
             "src/repro/kernels/sweep_grid/kernel.py:227", "B", bytes_b,
             ops_b)):
        b_ms, b_by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[key],
                     "max_abs_err": err[key], "ms": times[key],
                     "plain_ms": times[key + "_plain"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None,
                     "ms_method": times[key + "_method"],
                     "plain_ms_method": times[key + "_plain_method"]})
    rows[0].update(plan=dataclasses.asdict(plan_a), ptxas=usage_a,
                   filter_rows_scanned=scanned, filter_table_lanes=to_table,
                   graph_replays=int(res.stats["graph_replays"]),
                   scan_chunks=int(res.stats["scan_chunks"]))
    usage_b = eval_kernel_usage(usage)
    d_ms, d_by = bound(dense["bytes"], dense["n"] * eq_ops)
    rows[1].update(
        plan=dataclasses.asdict(plan_b), staged_ms=times["B_staged"],
        staged_ms_method=times["B_staged_method"],
        staged_smem_bytes=staged_b.smem_bytes,
        dense={**dense, "bound_ms": d_ms, "bound_by": d_by},
        ptxas=usage_b)
    print(json.dumps({"kernel_B": rows[1]}))
    for name, u in usage_b.items():
        no_spills(f"kernel B {name}", u)
        check(not u["stack_frame"], f"kernel B {name}: ptxas reports a "
              f"{u['stack_frame']}-byte stack frame")
    return rows, host


def eval_kernel_usage(usage: dict) -> dict:
    """The ``ptxas_usage`` entries of kernel B's instances (every kernel
    whose name holds ``eval_kernel``), by name; empty where this process
    did not build the library (no report)."""
    return {name: u for name, u in usage.items() if "eval_kernel" in name}


def filter_work(filt: dict, Fsg) -> tuple:
    """What kernel A's dominance filter does on a chunk whose signed
    objectives are ``Fsg`` (d, lanes): the rows it scans (a lane whose
    objectives are all finite scans rows in order until one dominates it,
    or all of them) and the lanes that then reach the prefix-min table
    (those no row dominates, where the filter has one)."""
    import torch

    q = Fsg[:, torch.isfinite(Fsg).all(dim=0)].T[:, None, :]   # (n, 1, d)
    rows = filt["rows"][None]                                  # (1, R, d)
    dom = (rows <= q).all(dim=2) & (rows < q).any(dim=2)      # (n, R)
    hit = dom.any(dim=1)
    scanned = torch.where(hit, dom.int().argmax(dim=1) + 1, dom.shape[1])
    return (int(scanned.sum()),
            int((~hit).sum()) if "table" in filt else 0)


# ---------------------------------------------------------------------------
# Kernel C and the hand-tracking pipeline
# ---------------------------------------------------------------------------

#: Int8 operations an H100 SXM's tensor cores do a second (data sheet,
#: dense, at the 700 W limit).
PEAK_INT8_OPS_PER_S = 1979e12

#: ROIs (one a camera) of the pipeline's batch, and the batch of the
#: reading at which kernel C fills the card.
PIPELINE_BATCH = 4
BIG_ROIS = 256

#: Relative L2 within which the card's int8 keypoints match the CPU's:
#: a few int8 rounding flips at ties (see phase_pipeline).
INT8_REL_L2 = 5e-3

# Kernel C's cases against its plain version: (m, k, n, seed, saturate).
RBE_FIXED_CASES = (
    (128, 128, 128, 1, False), (256, 512, 384, 2, False),
    (512, 256, 128, 3, False),                     # reference test shapes
    (997, 130, 200, 4, False), (1, 7, 3, 5, False),    # ragged M, K, N
    (576, 128, 128, 6, True), (333, 4096, 65, 7, True),  # saturated
    # the tensor-core route's edges: K a multiple of 16 but not of 32; K
    # over one 256-byte stage and not a multiple of 16; N not a multiple
    # of 8; M = 1; the 64 x 64 tile with ragged M, N and K
    (144, 80, 256, 8, False), (100, 520, 72, 9, False),
    (37, 64, 30, 10, False), (1, 256, 256, 11, False),
    (5000, 200, 300, 12, True))


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import flash_attention as E
    from repro_torch.kernels import rbe_matmul as R
    from repro_torch.kernels import rmsnorm as D
    from repro_torch.kernels import sweep_grid as K

    K.sweep_grid_chunk.launches = 0
    K.sweep_grid_eval.launches = 0
    R.rbe_matmul_raw.launches = 0
    D.rmsnorm_fused.launches = 0
    E.flash_attention_fwd.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as E
    from repro_torch.kernels import rbe_matmul as R
    from repro_torch.kernels import rmsnorm as D
    from repro_torch.kernels import sweep_grid as K

    return {"A": K.sweep_grid_chunk.launches,
            "B": K.sweep_grid_eval.launches,
            "C": R.rbe_matmul_raw.launches,
            "D": D.rmsnorm_fused.launches,
            "E": E.flash_attention_fwd.launches}


def keynet_int8_shapes(batch: int) -> list:
    """(name, M, K, N) of each KeyNet layer the int8 path runs on kernel
    C, for ``batch`` ROIs."""
    from repro_torch.core.handtracking import build_keynet
    from repro_torch.models.cnn import rbe_routed

    return [(s.name, batch * s.in_act_bytes // s.cin, s.cin, s.cout)
            for s in build_keynet().layers if rbe_routed(s)]


def rbe_operands(m, k, n, seed, saturate, dev) -> tuple:
    """int8 operands and positive float32 scales, from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    if saturate:
        xq = rng.choice(np.asarray([-127, 127], np.int8), (m, k))
        wq = rng.choice(np.asarray([-127, 127], np.int8), (k, n))
    else:
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
        wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
    sw = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (xq, wq, sx, sw))


def int8_work(m: int, k: int, n: int) -> tuple:
    """Bytes and int8 operations one (m, k, n) product with its dequant
    needs: each operand, scale and output byte moved once; 2mnk."""
    return m * k + k * n + 4 * m + 4 * n + 4 * m * n, 2 * m * n * k


def int8_bound(nbytes: int, ops: int) -> tuple:
    """Least time (ms) the card needs for that work, and which of bytes
    and operations bounds it."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_INT8_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def phase_rbe(dev) -> float:
    """Kernel C against its plain version, bitwise, and quantize_rowwise
    on ``dev`` against the CPU; returns the largest absolute difference
    seen (0.0 when every case is bitwise equal)."""
    import torch

    from repro_torch.kernels import rbe_matmul as R

    cases = [(m, k, n, 10 + b, False) for b in (1, PIPELINE_BATCH, BIG_ROIS)
             for _, m, k, n in keynet_int8_shapes(b)]
    worst = 0.0
    for m, k, n, seed, sat in cases + list(RBE_FIXED_CASES):
        args = rbe_operands(m, k, n, seed, sat, dev)
        got = R.rbe_matmul_raw(*args)
        want = R.rbe_matmul_ref(*args)
        sync(dev)
        e = (got - want).abs().max().item()
        worst = max(worst, e)
        check(torch.equal(got, want),
              f"kernel C {m}x{k}x{n}{' saturated' if sat else ''}: "
              f"differs from its plain version (max_abs_err {e!r})")
        print(f"kernel C {m}x{k}x{n}{' saturated' if sat else ''}: "
              f"max_abs_err={e!r}")
    # The largest exact sum: K = MAX_K (131,071), every operand -128, each
    # output 128² K = 2,147,467,264, just inside int32; one more K is
    # refused on the card.
    k = R.kernel.MAX_K
    args = (torch.full((4, k), -128, dtype=torch.int8, device=dev),
            torch.full((k, 8), -128, dtype=torch.int8, device=dev),
            torch.ones(4, device=dev), torch.ones(8, device=dev))
    got, want = R.rbe_matmul_raw(*args), R.rbe_matmul_ref(*args)
    sync(dev)
    check(torch.equal(got, want) and bool((want == 128 * 128 * k).all()),
          f"kernel C 4x{k}x8 at -128: differs from its plain version or "
          f"from 128² K")
    print(f"kernel C 4x{k}x8 at -128 (sums 128² K = {128 * 128 * k}): "
          f"bitwise equal")
    if dev.type == "cuda":
        try:
            R.rbe_matmul_raw(args[0].new_zeros((4, k + 1)),
                             args[1].new_zeros((k + 1, 8)), *args[2:])
        except ValueError as e:
            check("overflow" in str(e), f"kernel C at K = {k + 1}: {e}")
        else:
            raise SmokeFailure(f"kernel C took K = {k + 1} on the card")
    rng = np.random.default_rng(20)
    for shape, axis in (((576, 128), -1), ((128, 256), 0),
                        ((36864, 128), -1)):
        x = rng.standard_normal(shape) * np.exp(
            rng.uniform(-3, 3, (shape[0], 1)))
        x = torch.as_tensor(x.astype(np.float32))
        qc, sc = R.quantize_rowwise(x, axis=axis)
        qd, sd = R.quantize_rowwise(x.to(dev), axis=axis)
        check(torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc),
              f"quantize_rowwise {shape} axis={axis}: the card differs "
              f"from the CPU")
    print("quantize_rowwise: card == cpu, bitwise (int8 values and scales)")
    return worst


@contextlib.contextmanager
def recorded_int8_layers():
    """Record ``(input, weight, output)`` of every ``rbe_matmul`` call a
    ``HandCNN`` forward makes inside the ``with``."""
    from repro_torch.models import cnn

    calls, real = [], cnn.rbe_matmul

    def recording(x, w):
        out = real(x, w)
        calls.append((x, w, out))
        return out

    cnn.rbe_matmul = recording
    try:
        yield calls
    finally:
        cnn.rbe_matmul = real


def pipeline_models(dev) -> tuple:
    """DetNet and KeyNet with the weights of fixed generator seeds, made
    on the CPU and moved to ``dev``, so every device gets the same."""
    import torch

    from repro_torch.models.cnn import HandCNN

    det = HandCNN.detnet(torch.Generator().manual_seed(0), "cpu")
    key = HandCNN.keynet(torch.Generator().manual_seed(1), "cpu")
    return det.to(dev), key.to(dev)


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def phase_pipeline(dev, smi: str) -> tuple:
    """The hand-tracking pipeline on ``dev`` against the port's CPU run;
    returns its launch counts and the ``handtracking`` report."""
    import torch

    from repro_torch import handtracking_pipeline as HP
    from repro_torch.core.grids import PRICING_ANCHOR
    from repro_torch.kernels.rbe_matmul import rbe_matmul

    frames_np = np.random.default_rng(7).random(
        (PIPELINE_BATCH, *HP.FRAME_HW, 1), dtype=np.float32)
    det_c, key_c = pipeline_models("cpu")
    want = HP.pipeline_forward(torch.as_tensor(frames_np), det_c, key_c)
    det, key = pipeline_models(dev)
    frames = torch.as_tensor(frames_np, device=dev)
    HP.pipeline_forward(frames, det, key)        # warm-up (cuDNN plans)

    sync(dev)
    reset_counts()
    got = HP.pipeline_forward(frames, det, key)
    sync(dev)
    launches = read_counts()
    check(launches == {"A": 0, "B": 0, "C": 3, "D": 0, "E": 0},
          f"pipeline: expected 3 launches of kernel C (one int8 KeyNet "
          f"forward) and none of the others, got {launches}")
    price = HP.pricing()
    check(price == PRICING_ANCHOR,
          f"pricing differs from the JAX anchors: {price}")

    check(got["origins"] == want["origins"],
          f"ROI origins differ: {got['origins']} vs {want['origins']}")
    for k in ("det_out", "kp_f32"):
        g = got[k].cpu()
        check(torch.allclose(g, want[k], rtol=1e-4, atol=1e-5),
              f"pipeline {k}: card vs cpu max abs diff "
              f"{(g - want[k]).abs().max().item()!r}")
    # The int8 layers, exactly: each of the three int8 products of the
    # card's forward equals the port's CPU rbe_matmul on the same float
    # input and weight, bit for bit.
    with recorded_int8_layers() as calls:
        key(got["rois"], use_rbe_int8=True)
    sync(dev)
    check(len(calls) == 3, f"int8 KeyNet made {len(calls)} int8 products")
    for pix, w, out in calls:
        check(torch.equal(rbe_matmul(pix.cpu(), w.cpu()), out.cpu()),
              f"int8 layer {tuple(pix.shape)}x{tuple(w.shape)}: the card "
              f"differs from the CPU on the same input")
    # End to end: the float layers before each int8 one differ by ulps
    # between the card and the CPU, and an ulp at a rounding tie flips an
    # int8 value.  One such flip moves these keypoints by 1.45e-3
    # relative L2 (reproduced on the CPU alone by scaling the ROIs by
    # 1 + 1e-7 noise: tests/test_torch_cnn.py); a fault in quantization,
    # routing or the epilogue moves them by the int8 path's own error,
    # ~2e-2.
    int8_l2 = rel_l2(got["kp_int8"].cpu(), want["kp_int8"])
    check(int8_l2 <= INT8_REL_L2, f"pipeline kp_int8: card vs cpu "
          f"relative L2 {int8_l2!r} > {INT8_REL_L2}")
    print(f"pipeline {PIPELINE_BATCH} frames: card == cpu (ROIs "
          f"{got['origins']}, int8 layers bitwise, int8 keypoints rel L2 "
          f"{int8_l2!r}), launches {launches}, pricing == JAX anchors")

    rois = got["rois"]
    stages = {"detnet": lambda: det(frames),
              "keynet_f32": lambda: key(rois),
              "keynet_int8": lambda: key(rois, use_rbe_int8=True)}
    report = {"batch": PIPELINE_BATCH,
              "origins": got["origins"],
              "int8_rel_err": got["rel_err"],
              "card_vs_cpu": {
                  "det_max_abs": (got["det_out"].cpu()
                                  - want["det_out"]).abs().max().item(),
                  "kp_f32_max_abs": (got["kp_f32"].cpu()
                                     - want["kp_f32"]).abs().max().item(),
                  "kp_int8_rel_l2": int8_l2}}
    expect = {"keynet_int8": {"::rbe_matmul_kernel": 3}}
    for name, fn in stages.items():
        report[name] = {"wall_ms": host_ms(fn, 20)}
        timed(report[name], "device_ms", fn, 20, name, expect.get(name))
    report["card"] = smi
    return launches, report


def rbe_kernel_usage(usage: dict, tile: str) -> dict:
    """The ``ptxas_usage`` entry of kernel C's kernel for ``tile``:
    ``rbe_matmul_kernel<MT, 2, WN>`` (two warps down, WN across; each
    warp MT x 16 rows by 32 columns), by its mangled name; None for each
    where this process did not build the library (no report)."""
    from repro_torch.kernels.rbe_matmul.kernel import TILES

    if not usage:
        return dict.fromkeys(PTXAS_KEYS)
    bm, bn, _, _ = TILES[tile]
    want = f"17rbe_matmul_kernelILi{bm // 32}ELi2ELi{bn // 32}E"
    hits = [u for name, u in usage.items() if want in name]
    check(len(hits) == 1, f"ptxas report: {len(hits)} kernels match {want}")
    return hits[0]


def no_spills(what: str, usage: dict) -> None:
    check(not usage["spill_stores"],
          f"{what}: ptxas reports {usage['spill_stores']} bytes of spill "
          f"stores")


def rbe_report(launches: dict, err: float, dev, smi: str) -> tuple:
    """Kernel C's row of the ``kernels`` line at the pipeline's shapes
    (the three launches of one int8 KeyNet forward at 4 ROIs, summed),
    and the per-shape readings at 4 and 256 ROIs, each with its plan and
    ptxas's registers and spills for its tile."""
    import dataclasses

    import torch

    from repro_torch.kernels import rbe_matmul as R
    from repro_torch.kernels.rbe_matmul.kernel import LIBRARY, TILES

    usage = ptxas_usage(LIBRARY.info.get("ptxas", ""))
    tiles = {t: rbe_kernel_usage(usage, t) for t in TILES}
    for t, u in tiles.items():
        if u["registers"] is not None:
            no_spills(f"kernel C, {t} tile", u)
    # the products run on the int8 tensor cores (IMMA), the operands
    # staged by cp.async (LDGSTS)
    sass = sass_opcodes(LIBRARY.path(), ("IMMA", "LDGSTS", "LDSM", "PRMT"))
    check(sass["IMMA"] > 0 and sass["LDGSTS"] > 0,
          f"kernel C's SASS lacks int8 tensor-core or cp.async "
          f"instructions: {sass}")

    def library(row, args):
        # torch._int_mm: the int8 product alone (no dequant epilogue).
        row["library_ms"] = None
        try:
            fn = lambda: torch._int_mm(args[0], args[1])  # noqa: E731
            fn()
        except RuntimeError:
            return
        timed(row, "library_ms", fn, 50, "torch._int_mm")

    shapes = []
    for rois, reps in ((PIPELINE_BATCH, 50), (BIG_ROIS, 20)):
        for name, m, k, n in keynet_int8_shapes(rois):
            args = rbe_operands(m, k, n, 30, False, dev)
            nbytes, ops = int8_work(m, k, n)
            b_ms, b_by = int8_bound(nbytes, ops)
            plan = R.kernel.plan(m, k, n)
            row = {"layer": name, "rois": rois, "m": m, "k": k, "n": n,
                   "bytes": nbytes, "ops": ops,
                   "wall_ms": host_ms(lambda: R.rbe_matmul_raw(*args), reps),
                   "bound_ms": b_ms, "bound_by": b_by,
                   **dataclasses.asdict(plan), **tiles[plan.tile]}
            timed(row, "ms", lambda: R.rbe_matmul_raw(*args), reps,
                  f"kernel C {name}")
            timed(row, "plain_ms", lambda: R.rbe_matmul_ref(*args), reps,
                  f"kernel C {name}, plain")
            library(row, args)
            row["bound_share"] = b_ms / row["ms"]
            shapes.append(row)
    main = [r for r in shapes if r["rois"] == PIPELINE_BATCH]
    lib = [r["library_ms"] for r in main]
    b_ms, b_by = int8_bound(sum(r["bytes"] for r in main),
                            sum(r["ops"] for r in main))
    row = {"name": "rbe_matmul_raw", "route": "cuda",
           "source": "src/repro_torch/kernels/rbe_matmul/csrc/rbe_matmul.cu",
           "replaces": "src/repro/kernels/rbe_matmul/kernel.py:27",
           "launches": launches["C"], "max_abs_err": err,
           "ms": sum(r["ms"] for r in main),
           "plain_ms": sum(r["plain_ms"] for r in main),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if None in lib else sum(lib),
           "ptxas": tiles}
    row.update(methods(main, ("ms", "plain_ms", "library_ms")))
    return row, {"rbe_shapes": shapes, "rbe_sass": sass, "card": smi}


# ---------------------------------------------------------------------------
# Kernels D and E and the LM serving path
# ---------------------------------------------------------------------------

#: Float32 operations an H100 SXM's CUDA cores do a second outside the
#: tensor cores (data sheet, 67 TFLOP/s at the 700 W limit, an FMA as
#: two).
PEAK_F32_OPS_PER_S = 67e12
#: bf16 operations an H100 SXM's tensor cores do a second, accumulating
#: in float32 (data sheet, dense, 989 TFLOP/s at the 700 W limit).
PEAK_BF16_OPS_PER_S = 989e12

#: Kernel D's tolerances against its plain version: float32 within 16
#: ulp (the sum of x^2 runs in another order and rsqrtf is within 2 ulp
#: of 1/sqrt; a few ulp are expected), bf16 within one bf16 ulp (both
#: round the same float32 function once).
RMSNORM_F32_ULPS, BF16_ULPS = 16, 1
#: Kernel E's float32 tolerance against the full softmax: the scores, the
#: softmax sums and p@v are float32 sums in another order (one online
#: pass against a max-subtracted softmax), ~1e-7 relative.  In bf16 both
#: round float32 results that differ by that much, so they are within
#: one bf16 ulp, except where the output is within ~1e-7 of zero: there
#: the two float32 values may straddle 0, so 1e-6 absolute is allowed on
#: top of the ulp.
FLASH_F32_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_BF16_ATOL = 1e-6
#: Outputs above this size are reported by their ulp distance (below it
#: the float32 error alone is several bf16 ulp).
ULP_FLOOR = 1e-4
#: The reduced float32 models on the card against the JAX anchors:
#: float32 matmuls and reductions in another order (TF32 off), as the CPU
#: tests hold the port to the reference.
ANCHOR_TOL = dict(atol=2e-5, rtol=1e-5)
#: Gradients through kernel D's and E's autograd Functions against
#: autograd through their plain versions on the card.  float32: within
#: 1e-5 absolute + 1e-5 relative of each element, the forward's bound for
#: E (float32 sums in another order); as an absolute term 1e-5 of the
#: tensor's largest magnitude for D's, whose dscale sums 8192 rows.  bf16
#: (the LM's dtype): D's dx within one bf16 ulp plus 1e-5 of the largest
#: magnitude (both round float32 values a few float32 ulps apart).  E's
#: bf16 gradients within 1 % of the tensor's largest magnitude: the
#: Function's backward takes delta = sum(dout * out) from the bf16 output
#: (the reference's _bwd_pass does the same), where autograd through the
#: plain version takes it from the float32 probabilities; that alone moves
#: dq and dk by several bf16 ulps (0.46 % of the largest magnitude
#: measured on the CPU at qwen2's training shape).
GRAD_F32_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_SCALE_ATOL = 1e-5
FLASH_BF16_GRAD_SHARE = 1e-2

#: gemma2-2b's prompt forward: one sequence of 8192 tokens; the serve run
#: at the reference's CLI defaults.
LM_ARCH, LM_SEQ = "gemma2-2b", 8192
SERVE_ARGV = ["--arch", LM_ARCH]

# Kernel D's cases: (rows, d, dtype, what).  "misaligned" starts x one
# element into its buffer (the strided route, as d 130 is); arctic's
# 7168 takes several warps a row.
RMSNORM_CASES = ((LM_SEQ, 2304, "bfloat16", "gemma2 forward"),
                 (4, 2304, "bfloat16", "gemma2 decode"),
                 (4096, 1024, "float32", "kernel_bench"),
                 (2048, 7168, "bfloat16", "arctic width"),
                 (997, 2304, "bfloat16", "misaligned"),
                 (997, 130, "float32", "ragged"),
                 (997, 130, "bfloat16", "ragged"),
                 (1024, 896, "bfloat16", "qwen2 train"),
                 (4096, 7168, "bfloat16", "arctic forward"),
                 (4096, 4096, "bfloat16", "jamba forward"),
                 (4096, 1024, "bfloat16", "xlstm forward"),
                 (4096, 1536, "bfloat16", "deepseek q_norm"),
                 (4096, 512, "bfloat16", "deepseek kv_norm"),
                 (4096, 1536, "bfloat16", "qwen2-vl forward"),
                 (1536, 2048, "bfloat16", "musicgen forward"))

# Kernel E's cases: (name, b, sq, skv, h, kv, d, causal, window, softcap,
# dtype); d is q's and k's head dim and v's, or a pair (q·k, v) where
# they differ (MLA).
FLASH_CASES = (
    ("gemma2 local", 1, LM_SEQ, LM_SEQ, 8, 4, 256, True, 4096, 50.0,
     "bfloat16"),
    ("gemma2 global", 1, LM_SEQ, LM_SEQ, 8, 4, 256, True, 0, 50.0,
     "bfloat16"),
    ("kernel_bench", 1, 512, 512, 4, 2, 128, True, 0, 0.0, "float32"),
    ("qwen2 d64", 1, 4096, 4096, 14, 2, 64, True, 0, 0.0, "bfloat16"),
    ("non-causal", 2, 1024, 1024, 8, 2, 128, False, 0, 0.0, "float32"),
    ("sq<skv", 1, 512, 2048, 8, 4, 256, True, 1000, 0.0, "float32"),
    ("reduced d32", 2, 256, 256, 4, 2, 32, True, 64, 50.0, "float32"),
    # the bf16 tensor-core route's edges: each head dim (32 and 128 here),
    # Sq·g not a multiple of 64 rows and Skv not of the key tile, Sq <
    # Skv with a window, non-causal
    ("bf16 d32", 2, 256, 256, 4, 2, 32, True, 64, 50.0, "bfloat16"),
    ("bf16 d128", 1, 2048, 2048, 8, 2, 128, True, 0, 0.0, "bfloat16"),
    ("bf16 ragged", 1, 1000, 1000, 6, 2, 128, True, 0, 50.0, "bfloat16"),
    ("bf16 sq<skv", 1, 512, 2048, 8, 4, 256, True, 1000, 0.0, "bfloat16"),
    ("bf16 non-causal", 2, 1024, 1024, 8, 2, 64, False, 0, 0.0,
     "bfloat16"),
    # qwen2-0.5b's training step: global batch 8 of 128 tokens
    ("qwen2 train", 8, 128, 128, 14, 2, 64, True, 0, 0.0, "bfloat16"),
    ("qwen2 train f32", 8, 128, 128, 14, 2, 64, True, 0, 0.0, "float32"),
    # arctic-480b's prompt forward (phase 9d): 7 query heads a kv head
    ("arctic", 1, 4096, 4096, 56, 8, 128, True, 0, 0.0, "bfloat16"),
    # jamba-v0.1-52b's prompt forward (phase 9e): 4 query heads a kv head
    ("jamba", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0, "bfloat16"),
    # deepseek-v2-236b's MLA prompt forward (phase 9f): q·k over 128 + 64,
    # v over 128, every head its own k (the shared rope key broadcast)
    ("deepseek mla", 1, 4096, 4096, 128, 128, (192, 128), True, 0, 0.0,
     "bfloat16"),
    ("deepseek mla f32", 1, 4096, 4096, 128, 128, (192, 128), True, 0, 0.0,
     "float32"),
    # the reduced deepseek-v2 (its LM_ANCHORS run on the f32 route), a
    # ragged (192, 128) (Sq·g = 3000 rows, not a multiple of 64) and a
    # training-sized one whose stats and gradient are held
    ("reduced mla", 2, 256, 256, 4, 4, (48, 32), True, 0, 0.0, "float32"),
    ("reduced mla bf16", 2, 256, 256, 4, 4, (48, 32), True, 0, 0.0,
     "bfloat16"),
    ("mla ragged", 1, 1000, 1000, 6, 2, (192, 128), True, 0, 0.0,
     "bfloat16"),
    ("mla s512", 1, 512, 512, 16, 16, (192, 128), True, 0, 0.0,
     "bfloat16"),
    # the modality-stub prompts (phase 9g): qwen2-vl-2b's 4096 tokens, 6
    # query heads a kv head; musicgen-large's 1536 frames, MHA at d 64
    ("qwen2-vl", 1, 4096, 4096, 12, 2, 128, True, 0, 0.0, "bfloat16"),
    ("musicgen", 1, 1536, 1536, 32, 32, 64, True, 0, 0.0, "bfloat16"),
)
#: The cases whose gradient through kernel E's autograd Function is held
#: against autograd through its plain version (phase 8).
FLASH_GRAD_CASES = ("qwen2 train", "qwen2 train f32", "gemma2 local",
                    "gemma2 global", "reduced d32", "kernel_bench",
                    "mla s512", "reduced mla")


def ulps(got, want) -> int:
    """Largest distance between ``got`` and ``want`` in units in the last
    place of their dtype (float32 or bfloat16), counted through zero when
    the signs differ."""
    import torch

    ib, mask = ((torch.int16, 0x7FFF) if got.dtype == torch.bfloat16
                else (torch.int32, 0x7FFFFFFF))
    g = got.contiguous().view(ib).long()
    w = want.contiguous().view(ib).long()
    gm, wm = g & mask, w & mask
    d = torch.where((g < 0) == (w < 0), (gm - wm).abs(), gm + wm)
    return int(d.max().item()) if d.numel() else 0


def bf16_within_one_ulp(got, want, atol: float) -> tuple:
    """Whether every element of ``got`` is within one bf16 ulp of
    ``want`` (the spacing of bf16 values at |want|) plus ``atol``, and the
    largest ulp distance among the elements with |want| > ULP_FLOOR."""
    import torch

    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    spacing = torch.where(w == 0, torch.zeros_like(w),
                          torch.ldexp(torch.ones_like(w), e - 8))
    close = bool(((g - w).abs() <= spacing + atol).all().item())
    big = w.abs() > ULP_FLOOR
    return close, (ulps(got[big], want[big]) if bool(big.any()) else 0)


def rmsnorm_inputs(rows, d, dtype, seed, dev, what="") -> tuple:
    """x (rows, d) and scale (d,) on ``dev`` from a numpy seed; for the
    "misaligned" case x starts one element into its buffer."""
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((rows, d)).astype(np.float32))
    scale = torch.as_tensor((rng.standard_normal(d) * 0.1)
                            .astype(np.float32))
    x = x.to(getattr(torch, dtype)).to(dev)
    if what == "misaligned":
        buf = torch.empty(rows * d + 1, dtype=x.dtype, device=dev)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(rows, d)
    return x, scale.to(dev)


def phase_rmsnorm(dev) -> float:
    """Kernel D against its plain version on the card at gemma2-2b's
    forward and decode shapes, the kernel_bench shape and a ragged one;
    returns the largest absolute difference."""
    from repro_torch.kernels import rmsnorm as D

    worst = 0.0
    for i, (rows, d, dtype, what) in enumerate(RMSNORM_CASES):
        x, scale = rmsnorm_inputs(rows, d, dtype, 40 + i, dev, what)
        got = D.rmsnorm_fused(x, scale)
        want = D.rmsnorm_ref(x, scale)
        sync(dev)
        u = ulps(got, want)
        e = (got.float() - want.float()).abs().max().item()
        worst = max(worst, e)
        limit = BF16_ULPS if dtype == "bfloat16" else RMSNORM_F32_ULPS
        check(u <= limit, f"kernel D {rows}x{d} {dtype}: {u} ulp from its "
              f"plain version (limit {limit})")
        route = D.plan(rows, d, x.element_size(), x.data_ptr(),
                       scale.data_ptr(), got.data_ptr()).route
        gerr = rmsnorm_grad_check(x, scale, 60 + i, f"kernel D {what}")
        print(f"kernel D {rows}x{d} {dtype} ({what}, {route}): "
              f"max_abs_err={e!r}, {u} ulp; backward {gerr}")
    return worst


def grad_close(got, want, what: str, scale_atol: bool = False,
               bf16_share: float | None = None) -> float:
    """Check a gradient against its plain autograd twin and return the
    largest difference over the largest magnitude.  float32: within
    GRAD_F32_TOL of each element, the absolute term GRAD_SCALE_ATOL of
    the largest magnitude with ``scale_atol``; bf16: within one bf16 ulp
    plus GRAD_SCALE_ATOL of the largest magnitude, or within
    ``bf16_share`` of the largest magnitude where given."""
    import torch

    g, w = got.float(), want.float()
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(g).all()), f"{what}: dtype, shape or "
          f"non-finite values")
    top = w.abs().max().item()
    diff = (g - w).abs().max().item()
    if got.dtype == torch.float32:
        atol = GRAD_SCALE_ATOL * top if scale_atol else GRAD_F32_TOL["atol"]
        close = bool(((g - w).abs() <= atol
                      + GRAD_F32_TOL["rtol"] * w.abs()).all())
    elif bf16_share is not None:
        close = diff <= bf16_share * top
    else:
        close, _ = bf16_within_one_ulp(got, want, GRAD_SCALE_ATOL * top)
    check(close, f"{what}: differs from autograd through the plain "
          f"version by {diff!r} (largest magnitude {top!r})")
    return diff / max(top, 1e-30)


def rmsnorm_grad_check(x, scale, seed: int, what: str) -> dict:
    """Kernel D's autograd Function, as the LM's ``layers.rmsnorm`` runs
    it (forward on the card, backward torch ops), against autograd
    through ``rmsnorm_ref`` at the same inputs and a seeded cotangent:
    dx and dscale; the output carries a grad_fn."""
    import torch

    from repro_torch.kernels import rmsnorm as D
    from repro_torch.models import layers

    rng = np.random.default_rng(seed)
    gy = torch.as_tensor(rng.standard_normal(tuple(x.shape))
                         .astype(np.float32)).to(x.dtype).to(x.device)
    xs, ss = x.detach().contiguous(), scale.detach()
    out = {}
    for name, fn in (("kernel", lambda a, s: layers.rmsnorm({"scale": s}, a)),
                     ("plain", D.rmsnorm_ref)):
        xa, sa = xs.clone().requires_grad_(), ss.clone().requires_grad_()
        y = fn(xa, sa)
        check(y.grad_fn is not None, f"{what}: {name} output has no grad_fn")
        out[name] = torch.autograd.grad(y, (xa, sa), gy)
    return {"dx": grad_close(out["kernel"][0], out["plain"][0], what + " dx",
                             scale_atol=True),
            "dscale": grad_close(out["kernel"][1], out["plain"][1],
                                 what + " dscale", scale_atol=True)}


def head_dims(d) -> tuple:
    """A case's (q·k, v) head dims: ``d`` itself where it is a pair."""
    return tuple(d) if isinstance(d, (tuple, list)) else (d, d)


def flash_inputs(b, sq, skv, h, kv, d, dtype, seed, dev,
                 dv: int | None = None) -> tuple:
    """q, k, v on ``dev``: normals made on the CPU from a numpy seed; v's
    head dim ``dv`` (``d`` by default)."""
    import torch

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    dv = d if dv is None else dv
    return tuple(
        torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        .to(dt).to(dev)
        for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, dv)))


def visible_pairs(sq, skv, causal, window) -> int:
    """(query, key) pairs the mask leaves visible, one head."""
    qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b, sq, skv, h, kv, d, causal, window, itemsize,
               dv: int | None = None) -> tuple:
    """Bytes (q, k, v read once, out written once) and the operations of
    q.k (over d) and of p@v (over v's ``dv``, ``d`` by default) over the
    visible pairs (an FMA as two)."""
    dv = d if dv is None else dv
    nbytes = itemsize * (d + dv) * (b * sq * h + b * skv * kv)
    pairs = h * b * visible_pairs(sq, skv, causal, window)
    return nbytes, 2 * d * pairs, 2 * dv * pairs


def flash_bound(nbytes, qk_ops, pv_ops, bf16: bool) -> tuple:
    """The least time of kernel E's work: its bytes over the memory rate
    or its operations over the rates of their types, whichever is longer.
    On bf16 inputs q.k multiplies bf16 values, whose products are exact
    in float32, so one pass of the bf16 tensor cores (float32
    accumulation) computes it; p stays float32 (as the reference's
    p_bf16=False keeps it), and its three bf16 pieces (hi, mid, lo; their
    sum is p exactly) make p@v three such passes, the least the card
    needs for float32 p times bf16 v computed exactly.  On float32 inputs
    both run at the float32 rate."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    if bf16:
        to = (qk_ops + 3 * pv_ops) / PEAK_BF16_OPS_PER_S * 1e3
    else:
        to = (qk_ops + pv_ops) / PEAK_F32_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


#: What ``ptxas_usage`` reads of each kernel (None each where this
#: process did not build the library: no report).
PTXAS_KEYS = ("registers", "stack_frame", "spill_stores", "spill_loads")
_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\w+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(text: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` report: ``{mangled name: {"registers", "stack_frame",
    "spill_stores", "spill_loads"}}``."""
    out: dict = {}
    name = props = None
    for line in text.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            name = m.group(1)
            out[name] = {"registers": None, "stack_frame": 0,
                         "spill_stores": 0, "spill_loads": 0}
        elif m := _PTXAS_PROPS.search(line):
            props = m.group(1)
        elif props == name and name is not None \
                and (m := _PTXAS_SPILL.search(line)):
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
            if st := _PTXAS_STACK.search(line):
                out[name]["stack_frame"] = int(st.group(1))
        elif name is not None and (m := _PTXAS_REGS.search(line)):
            out[name]["registers"] = int(m.group(1))
    return out


def flash_kernel_usage(usage: dict, route: str, d: int,
                       dv: int | None = None) -> dict:
    """The ``ptxas_usage`` entry of kernel E's kernel for ``route`` at
    head dims (``d``, ``dv``; ``dv`` = ``d`` by default):
    ``mma::flash_fwd_kernel<DK, DV>`` (bf16) or ``flash_fwd_kernel<float,
    DK, DV>`` (f32), by their mangled names; None for each where this
    process did not build the library (no report)."""
    if not usage:
        return dict.fromkeys(PTXAS_KEYS)
    dv = d if dv is None else dv
    args = f"Li{d}ELi{dv}EE"
    want = (f"3mma16flash_fwd_kernelI{args}" if route == "mma"
            else f"16flash_fwd_kernelIf{args}")
    hits = [u for name, u in usage.items() if want in name]
    check(len(hits) == 1, f"ptxas report: {len(hits)} kernels match "
          f"{want}")
    return hits[0]


def sass_opcodes(lib: pathlib.Path, prefixes: tuple) -> dict:
    """How many instructions of the built library's SASS start with each
    of ``prefixes``."""
    ops = [m.group(2) for line in sass(lib).splitlines()
           if (m := _SASS_LINE.search(line))]
    return {p: sum(op.startswith(p) for op in ops) for p in prefixes}


def phase_flash(dev) -> float:
    """Kernel E against its plain version (the full softmax) on the card;
    returns the largest absolute difference."""
    from repro_torch.kernels import flash_attention as E

    worst = 0.0
    for i, (name, b, sq, skv, h, kv, dims, causal, window, cap,
            dtype) in enumerate(FLASH_CASES):
        d, dv = head_dims(dims)
        q, k, v = flash_inputs(b, sq, skv, h, kv, d, dtype, 50 + i, dev, dv)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        got = E.flash_attention_fwd(q, k, v, **kw)
        check(tuple(got.shape) == (b, sq, h, dv),
              f"kernel E {name}: output {tuple(got.shape)}")
        # a kv head at a time where the whole score tensor is large (at
        # deepseek's 128 heads 8.6 GB of float32 a copy): the same function
        plain = (flash_ref_by_kv_head if h * sq * skv >= 2**31
                 else E.flash_attention_ref)
        want = plain(q, k, v, **kw)
        sync(dev)
        e = (got.float() - want.float()).abs().max().item()
        worst = max(worst, e)
        if dtype == "bfloat16":
            close, u = bf16_within_one_ulp(got, want, FLASH_BF16_ATOL)
            err = f"{u} ulp where |out| > {ULP_FLOOR}"
        else:
            close = bool(((got - want).abs() <= FLASH_F32_TOL["atol"]
                          + FLASH_F32_TOL["rtol"] * want.abs()).all())
            err = f"tolerance {FLASH_F32_TOL}"
        print(f"kernel E {name} ({b},{sq},{skv},{h}/{kv},{dims}) {dtype} "
              f"causal={causal} window={window} softcap={cap}: "
              f"max_abs_err={e!r} ({err})")
        check(close, f"kernel E {name}: differs from its plain version")
        check(bool(got.isfinite().all()), f"kernel E {name}: non-finite")
        del want
        stats = flash_stats_check(q, k, v, got, kw, f"kernel E {name}")
        if name in FLASH_GRAD_CASES:
            stats["grad"] = flash_grad_check(q, k, v, kw, 70 + i,
                                             f"kernel E {name}")
        print(f"kernel E {name}: stats and gradient {stats}")
        del q, k, v, got
    return worst


def stats_blocks(n: int) -> int:
    """The largest power of two up to 512 (the LM's block) that divides
    ``n``: the plain ``_fwd_pass``'s block for a sequence of ``n``."""
    blk = 512
    while n % blk:
        blk //= 2
    return blk


def flash_stats_check(q, k, v, out, kw, what: str) -> dict:
    """Kernel E with ``return_stats``: its output bitwise the output
    without them, and its per-row float32 (m, l), (B, Sq, KV, g), within
    FLASH_F32_TOL of the plain ``_fwd_pass``'s (the LM's blockwise
    online softmax) on the same inputs."""
    import torch

    from repro_torch.kernels import flash_attention as E
    from repro_torch.models import attention, flash

    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    got, m, l = E.flash_attention_fwd(q, k, v, **kw, return_stats=True)
    check(torch.equal(got, out), f"{what}: output with stats differs from "
          f"the output without")
    qb, kb = stats_blocks(sq), stats_blocks(skv)
    pairs = attention._block_pairs(sq // qb, skv // kb, qb, kb, skv - sq,
                                   kw["causal"], kw["window"])
    with torch.no_grad():
        _, pm, pl = flash._fwd_pass(q, k, v, pairs, q_block=qb, kv_block=kb,
                                    scale=d ** -0.5, **kw)
    res = {}
    for name, a, w in (("m", m, pm), ("l", l, pl)):
        check(a.shape == (b, sq, kvh, h // kvh) and a.dtype == torch.float32,
              f"{what}: stats {name} {tuple(a.shape)} {a.dtype}")
        close = bool(((a - w).abs() <= FLASH_F32_TOL["atol"]
                      + FLASH_F32_TOL["rtol"] * w.abs()).all())
        res[name] = (a - w).abs().max().item()
        check(close, f"{what}: stats {name} differ from _fwd_pass's by "
              f"{res[name]!r}")
    return res


def flash_grad_check(q, k, v, kw, seed: int, what: str) -> dict:
    """(dq, dk, dv) through kernel E's autograd Function (the LM's
    ``flash_attention`` where autograd records: kernel E with its stats,
    then the recompute backward) against autograd through the plain
    ``flash_attention_ref`` on the card, at a seeded cotangent."""
    import torch

    from repro_torch.kernels import flash_attention as E
    from repro_torch.models import flash

    rng = np.random.default_rng(seed)
    do = torch.as_tensor(rng.standard_normal((*q.shape[:3], v.shape[3]))
                         .astype(np.float32)).to(q.dtype).to(q.device)
    before = E.flash_attention_fwd.launches
    out = {}
    for name, fn in (("kernel", flash.flash_attention),
                     ("plain", E.flash_attention_ref)):
        args = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        y = fn(*args, **kw)
        check(y.grad_fn is not None, f"{what}: {name} output has no grad_fn")
        out[name] = torch.autograd.grad(y, args, do)
        del y, args
    check(q.device.type != "cuda"
          or E.flash_attention_fwd.launches == before + 1,
          f"{what}: the Function did not launch kernel E once")
    share = FLASH_BF16_GRAD_SHARE if q.dtype == torch.bfloat16 else None
    return {n: grad_close(a, b, f"{what} {n}", bf16_share=share)
            for n, a, b in zip(("dq", "dk", "dv"), out["kernel"],
                               out["plain"])}


def flash_ref_by_kv_head(q, k, v, blocks=None, **kw):
    """``flash_attention_ref`` one kv head (and its g query heads) at a
    time (``blocks`` unused: the full softmax has none), the plain
    forward of :func:`plain_kernels`: each head's
    softmax is its own, so the same function, with a kv head's full
    scores alive at once instead of all of them (arctic-480b's
    4096-token prompt: 0.47 GB of float32 scores, not 3.76 GB, beside
    55 GB of weights)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref

    kvh = k.shape[2]
    g = q.shape[2] // kvh
    return torch.cat([flash_attention_ref(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
        **kw) for j in range(kvh)], dim=2)


@contextlib.contextmanager
def plain_kernels():
    """Inside the ``with``, the LM's norms and prompt attention run the
    plain versions of kernels D and E (on any device), so the same
    forward, or training step, can be held against itself on the card:
    with autograd the plain path is autograd through ``rmsnorm_ref`` and
    ``flash_attention_ref``, not kernel D's and E's autograd Functions.
    The forward's plain attention runs a kv head at a time
    (:func:`flash_ref_by_kv_head`).  The launch counts are set to 0
    on entry, and the block fails if D or E was launched inside it (the
    swap missed a route to the kernels)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models import flash, layers

    check(hasattr(layers, "rmsnorm_op")
          and hasattr(flash, "flash_attention_fwd")
          and hasattr(flash, "flash_attention_vjp"),
          "plain_kernels: the LM no longer reaches D and E by the names "
          "it swaps")

    def plain_vjp(q, k, v, *, causal, window, logit_softcap, scale,
                  **blocks):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_softcap=logit_softcap, scale=scale)

    saved = (layers.rmsnorm_op, flash.flash_attention_fwd,
             flash.flash_attention_vjp)
    layers.rmsnorm_op = lambda x, scale, eps=1e-6: rmsnorm_ref(x, scale, eps)
    flash.flash_attention_fwd = flash_ref_by_kv_head
    flash.flash_attention_vjp = plain_vjp
    reset_counts()
    try:
        yield
        counts = read_counts()
        check(counts["D"] == counts["E"] == 0,
              f"the plain path launched kernels: {counts}")
    finally:
        (layers.rmsnorm_op, flash.flash_attention_fwd,
         flash.flash_attention_vjp) = saved


def compare_logits(got, want, chunk: int = 512) -> dict:
    """Largest absolute difference of two (B, S, V) logits tensors, their
    largest magnitude, and the share of positions whose argmax agrees,
    a chunk of positions at a time (the float32 temporaries of a whole
    gemma2 prompt would take 8 GB each)."""
    g2 = got.reshape(-1, got.shape[-1])
    w2 = want.reshape(-1, want.shape[-1])
    diff, mag, agree = 0.0, 0.0, 0
    for i in range(0, g2.shape[0], chunk):
        g, w = g2[i:i + chunk].float(), w2[i:i + chunk].float()
        diff = max(diff, (g - w).abs().max().item())
        mag = max(mag, w.abs().max().item())
        agree += int((g.argmax(-1) == w.argmax(-1)).sum().item())
        check(bool(g.isfinite().all()), "logits are not finite")
    return {"max_abs_diff": diff, "max_abs": mag,
            "argmax_agree": agree / g2.shape[0]}


#: The card's bf16 LM against the same LM on the plain versions of D and
#: E: every norm and attention output may differ by a bf16 ulp, and those
#: flips propagate through 26 layers (the logits are softcapped at 30,
#: |logit| <= 10.3 here).  Readings on the H100: 0.113 and 0.094 apart,
#: 99.78 % and 100 % of the argmaxes equal (forward, serve); the limits
#: leave about twice that.
LM_BF16_MAX_DIFF = 0.25
LM_BF16_ARGMAX = 0.98


def phase_lm(dev, cfg, seq: int, serve_argv: list, smi: str) -> tuple:
    """gemma2-2b at full width on ``dev``: (a) the prompt forward through
    kernels D and E against the same forward on their plain versions,
    (b) ``token_serve.main(serve_argv)`` (the reference's CLI defaults;
    the argv must serve ``cfg``, whose weights are rebuilt from main's
    seed), teacher-forced again on both paths, (c) the reduced float32
    gemma2-2b and qwen2-0.5b against the frozen JAX anchors.  Returns the
    forward's launch counts and the ``lm`` report."""
    import torch

    from repro_torch.launch import token_serve
    from repro_torch.models import transformer as T

    report: dict = {"arch": cfg.name, "layers": cfg.num_layers,
                    "d_model": cfg.d_model, "dtype": cfg.dtype}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        params = T.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                               device=dev)
        batch = T.Batch(tokens=tokens)
        report["params"] = T.param_count(params)

        # (a) the prompt forward
        sync(dev)
        reset_counts()
        logits = T.forward(cfg, params, batch)
        sync(dev)
        fwd_launches = read_counts()
        expect = lm_launches(cfg, params)
        n_norms = expect["D"]
        check(fwd_launches == expect,
              f"forward: expected {n_norms} launches of D and "
              f"{expect['E']} of E, got {fwd_launches}")
        check(tuple(logits.shape) == (1, seq, cfg.vocab_size),
              f"forward logits {tuple(logits.shape)}")
        with plain_kernels():
            plain = T.forward(cfg, params, batch)
        vs = compare_logits(logits, plain)
        del logits, plain
        check(vs["max_abs_diff"] <= LM_BF16_MAX_DIFF
              and vs["argmax_agree"] >= LM_BF16_ARGMAX,
              f"forward: kernels vs plain {vs}")
        print(f"lm forward {cfg.name} B=1 S={seq}: launches {fwd_launches}, "
              f"kernels vs plain {vs}")
        fwd = lambda: T.forward(cfg, params, batch)  # noqa: E731
        report["forward"] = {
            "batch": 1, "seq": seq, "launches": fwd_launches,
            "vs_plain": vs, "wall_ms": host_ms(fwd, 2)}
        # The forward's calls have not got ahead of device_ms's hold on
        # the card, so it may be timed from a trace: that trace must hold
        # every launch of D and E (and none on the plain path).
        mine = {"::rmsnorm_kernel<": n_norms,
                "::flash_fwd_kernel<": expect["E"]}
        timed(report["forward"], "device_ms", fwd, 2, "lm forward", mine)
        with plain_kernels():
            timed(report["forward"], "plain_device_ms", fwd, 2,
                  "lm forward, plain", dict.fromkeys(mine, 0))
        busy, wall = busy_share(fwd)
        report["forward"]["busy_share"] = busy
        report["forward"]["device_s_by_kernel"] = dict(sorted(
            wall.items(), key=lambda kv: -kv[1])[:8])
        del params, batch, tokens

    # (b) token serving at the reference's CLI defaults
    sync(dev)
    reset_counts()
    out = token_serve.main(serve_argv + ["--device", str(dev)])
    sync(dev)
    serve_launches = read_counts()
    bsz, gen_n = out["tokens"].shape
    plen = out["prompts"].shape[1]
    steps = plen + gen_n - 1
    check(serve_launches["D"] == n_norms * steps
          and serve_launches["E"] == 0,
          f"serve: expected {n_norms * steps} launches of D and none of E, "
          f"got {serve_launches}")
    with torch.no_grad():
        # main's weights: init_params on a generator seeded with --seed 0
        sparams = T.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dev)
        seq_toks = torch.as_tensor(np.concatenate(
            [out["prompts"], out["tokens"][:, :-1]], axis=1), device=dev)
        k_logits = teacher_forced(cfg, sparams, seq_toks, dev)
        with plain_kernels():
            p_logits = teacher_forced(cfg, sparams, seq_toks, dev)
    got = torch.stack(k_logits[plen - 1:], 1)
    check(np.array_equal(got.argmax(-1).cpu().numpy(), out["tokens"]),
          "serve: the teacher-forced kernel path does not reproduce the "
          "served tokens")
    svs = compare_logits(got, torch.stack(p_logits[plen - 1:], 1))
    check(svs["max_abs_diff"] <= LM_BF16_MAX_DIFF
          and svs["argmax_agree"] >= LM_BF16_ARGMAX,
          f"serve: kernels vs plain {svs}")
    prompts = torch.as_tensor(out["prompts"], device=dev)
    busy, _ = busy_share(lambda: token_serve.generate(cfg, sparams,
                                                      prompts, gen_n))
    report["serve"] = {"batch": bsz, "prompt": plen, "gen": gen_n,
                       "launches": serve_launches, "vs_plain": svs,
                       "prefill_s": out["prefill_s"],
                       "decode_tok_per_s": out["decode_tok_per_s"],
                       "busy_share": busy}
    print(f"lm serve {cfg.name} batch={bsz} prompt={plen} gen={gen_n}: "
          f"launches {serve_launches}, kernels vs plain {svs}")
    del sparams
    if dev.type == "cuda":
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()

    # (c) the reduced float32 models against the JAX anchors
    report["anchors"] = {arch: phase_anchor(arch, dev)
                         for arch in ("gemma2-2b", "qwen2-0.5b")}
    report["card"] = smi
    return fwd_launches, report


def teacher_forced(cfg, params, seq_toks, dev) -> list:
    """Logits (B, V) of each decode step over ``seq_toks`` (B, T)."""
    from repro_torch.models import transformer as T

    b, n = seq_toks.shape
    cache = T.init_cache(cfg, b, n + 1, device=dev)
    out = []
    for t in range(n):
        lg, cache = T.decode_step(cfg, params, cache,
                                  T.Batch(tokens=seq_toks[:, t:t + 1]), t)
        out.append(lg[:, -1])
    return out


def phase_anchor(arch: str, dev) -> dict:
    """The reduced float32 ``arch`` on ``dev`` (weights from the numpy
    seed of ``repro_torch.models.anchors``) against the logits and greedy
    tokens frozen from the JAX reference (and an MoE arch's routes), at
    ANCHOR_TOL; a modality-stub arch's forward on ``anchor_embeds``."""
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import token_serve
    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    cfg = get_reduced_config(arch, dtype="float32")
    a = A.LM_ANCHORS[arch]
    params = T.to_device(T.params_from_jax(cfg, A.jax_layout_params(cfg)),
                         dev)
    fwd_np, prompt_np = A.anchor_tokens(cfg)
    batch = T.Batch(tokens=torch.as_tensor(fwd_np, device=dev))
    if cfg.frontend_stub:
        emb, pos = A.anchor_embeds(cfg)
        batch = T.Batch(embeds=torch.as_tensor(emb, device=dev),
                        positions=None if pos is None
                        else torch.as_tensor(pos, device=dev))
    with torch.no_grad():
        with A.record_routes() as routes:
            logits = T.forward(cfg, params, batch).cpu().numpy()
        toks = token_serve.generate(
            cfg, params, torch.as_tensor(prompt_np, device=dev),
            A.GREEDY_STEPS)["tokens"].cpu().numpy()
    worst = 0.0
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        got = logits[b, s, :A.ANCHOR_VOCAB].astype(np.float64)
        want = np.asarray(row)
        worst = max(worst, float(np.abs(got - want).max()))
        check(np.all(np.abs(got - want) <= ANCHOR_TOL["atol"]
                     + ANCHOR_TOL["rtol"] * np.abs(want)),
              f"{arch}: logits at {(b, s)} differ from the JAX anchors")
        check(abs(logits[b, s].astype(np.float64).sum() - total) <= 1e-3,
              f"{arch}: row sum at {(b, s)} differs from the JAX anchors")
    check(np.array_equal(toks, np.asarray(a["greedy"])),
          f"{arch}: greedy tokens {toks.tolist()} differ from the JAX "
          f"anchors {a['greedy']}")
    out = {"max_abs_err": worst, "greedy_equal": True}
    if "routes" in a:
        got = A.routes_digest([r.top_e for r in routes],
                              [r.keep for r in routes])
        check(got == a["routes"], f"{arch}: forward routes {got} differ "
              f"from the JAX anchors {a['routes']}")
        out["routes_equal"], out["dropped"] = True, got["dropped"]
    print(f"lm anchors {arch} (reduced, float32) on {dev}: logits within "
          f"{worst!r} of JAX, greedy tokens equal"
          + (", routes equal" if "routes" in a else ""))
    return out


# ---------------------------------------------------------------------------
# Modality-stub serving (the twelfth path)
# ---------------------------------------------------------------------------

#: The modality-stub path's models, both at full width and depth (they
#: fit one card whole): qwen2-vl-2b (28 layers, d 1536, 12/2 heads of
#: 128, d_ff 8960, vocab 151,936, tied, qkv biases, M-RoPE sections 16 /
#: 24 / 24; 3.1 GB of bf16) and musicgen-large (48 layers, d 2048, 32/32
#: heads of 64, GELU d_ff 8192, vocab 2048, sinusoidal positions; 4.85
#: GB).  Their frontends (the vision tower, EnCodec) are stubs in both
#: packages: the model takes precomputed (B, S, d) embeddings.
STUB_VL, STUB_AUDIO = "qwen2-vl-2b", "musicgen-large"
#: qwen2-vl's prompt (cell 14): STUB_IMAGE's text tokens, one image of
#: rows x columns merged patches (a 1344 x 1344 image at Qwen2-VL's 14-px
#: patches, 2 x 2 merged: 48 x 48), text tokens: 4096 in all, at
#: Qwen2-VL's t/h/w positions (``anchors.image_positions``).
STUB_IMAGE = (16, 48, 48, 1776)
#: musicgen's prompt (cell 15): 1536 frames, 30.72 s of audio at
#: EnCodec's 50 Hz (MusicGen's longest generation is 30 s, 1500 frames).
#: The prompt attention tiles a sequence longer than FLASH_BLOCK by
#: blocks of FLASH_BLOCK (``models.flash.flash_attention``, as the
#: reference's): 1500 frames raise in both packages, 1536 is the nearest
#: length that tiles.
STUB_FRAMES = 1536
#: ``gqa_forward``'s q and kv blocks.
FLASH_BLOCK = 512
#: Serving: batch and decode steps after the prefill (qwen2-vl greedy on
#: tokens, its first from the prefill's logits; musicgen teacher-forced
#: on the next seeded frame embeddings).
STUB_SERVE = (4, 16)
#: The compression gate's backward: one qwen2-vl sequence of 1024
#: embeddings holding one 24 x 24 image.
STUB_GRAD_IMAGE = (16, 24, 24, 432)
#: Positions of qwen2-vl's prompt decoded one at a time from 0 (the
#: reference's cache-exact prefill) against the forward's cache.
STUB_PREFILL_CHECK = 32
#: musicgen's teacher-forced decode against its forward at the same
#: positions (the reference's ``test_decode_matches_forward`` at full
#: width): in float32 (on E's float32 route) within the reference test's
#: 1e-3; in bf16 within the model's STUB_LIMITS, the two paths rounding
#: apart (kernel E against the plain decode attention, both over float32
#: accumulators).
STUB_DECODE_F32_MAX_DIFF = 1e-3
#: Kernels vs plain, by model: the largest logit difference and the
#: share of equal argmaxes in bf16, and in float32 (D's and E's float32
#: routes against the plain path in float32).  With random weights the
#: argmaxes are near ties (qwen2-vl's 151,936-way tied head; musicgen's
#: logits set mostly by its sinusoidal positions), so a bf16 ulp of a
#: norm or attention output flips 3-5 % of them and the ``lm`` phase's 98
#: % does not hold.  Readings on the H100, kernels vs plain [the float32
#: witness, the plain path in float32 against the plain path]: qwen2-vl's
#: forward 0.119 apart, 95.9 % of the argmaxes equal [0.108, 95.0 %], its
#: served logits 0.094, 96.9 %; musicgen's forward 0.070, 95.0 % [0.069,
#: 94.7 %], its decode against its forward 0.063, 93.8 %.  The bf16
#: limits (0.25, and 2-3 points below the witness's argmaxes) hold a
#: kernel to a sound change of rounding, no more: they cannot tell a
#: fault of that size from one.  The float32 run can: 2.6e-5 (qwen2-vl)
#: and 6.2e-6 (musicgen) apart, every argmax equal and the served tokens
#: reproduced, against the witness's 0.07-0.11 and 95 %.
STUB_LIMITS = {
    "qwen2-vl-2b": {"max_diff": LM_BF16_MAX_DIFF, "argmax": 0.93,
                    "float32": {"max_diff": 0.01, "argmax": 0.99}},
    "musicgen-large": {"max_diff": LM_BF16_MAX_DIFF, "argmax": 0.92,
                       "float32": {"max_diff": 0.01, "argmax": 0.99}},
}
#: The M-RoPE gates: in float32 at qwen2-vl's shapes, M-RoPE with t = h =
#: w against RoPE; and the image's positions must move the prompt's
#: logits by more than a kernels-vs-plain difference (LM_BF16_MAX_DIFF)
#: past the first text run.
STUB_MROPE_F32 = 1e-6
#: int8 reconstruction: |target - recon| <= scale * (1/2 + 2^-16): half a
#: step, plus the roundings of target / scale (a value below 128: half
#: an ulp is 2^-18 of the step) and of q * scale (2^-17 of it at most).
INT8_ERR_STEPS = 0.5 + 2.0 ** -16
#: bf16 reconstruction: half a bf16 ulp, at most 2^-8 of |target| (8
#: significant bits), and half the smallest bf16 step below its normals.
BF16_REL_ERR, BF16_ABS_ERR = 2.0 ** -8, 2.0 ** -134


def stub_embeds(cfg, params, image: tuple | None, n: int, bsz: int,
                gen) -> tuple:
    """(B, S, d) frontend embeddings in the compute dtype and, with
    ``image`` (text, rows, columns, text), (3, B, S) positions: text as
    rows of the model's own table for tokens drawn from ``gen``, the
    image (or, without one, every one of the ``n`` frames) as seeded
    normals at the table's scale d^-0.5."""
    import torch

    from repro_torch.models import anchors as A

    table = params["embed"]["table"]
    dev, d = table.device, cfg.d_model
    if image is None:
        x = torch.randn((bsz, n, d), generator=gen, device=dev)
        return (x * d ** -0.5).to(table.dtype), None
    before, rows, cols, after = image
    tok = torch.randint(0, cfg.vocab_size, (bsz, before + after),
                        generator=gen, device=dev)
    img = torch.randn((bsz, rows * cols, d), generator=gen, device=dev)
    img = (img * d ** -0.5).to(table.dtype)
    text = table[tok]
    x = torch.cat([text[:, :before], img, text[:, before:]], dim=1)
    pos = torch.as_tensor(A.image_positions(*image), device=dev)
    return x, pos[:, None].expand(3, bsz, -1).contiguous()


def forward_prefill(cfg, params, batch, cache, upto: int):
    """The cache a cache-exact prefill writes (the reference's, a decode
    step a position, rotating q and k at t = h = w = the cache index),
    from one forward: ``transformer.hidden_states`` on ``batch`` (its
    default (B, S) positions, the decode rule), each layer's k and v
    recorded as ``attention._qkv`` returns them and written into
    ``cache`` at positions < ``upto``.  Returns the hidden states."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T

    check(batch.positions is None, "forward_prefill: the decode rule's "
          "positions are the default ones")
    kv, qkv = [], attn._qkv

    def recording(*args, **kw):
        q, k, v = qkv(*args, **kw)
        kv.append((k, v))
        return q, k, v

    attn._qkv = recording
    try:
        h, _ = T.hidden_states(cfg, params, batch)
    finally:
        attn._qkv = qkv
    check(len(kv) == len(cache["layers"]),
          f"forward_prefill: {len(kv)} attention layers recorded, "
          f"{len(cache['layers'])} cached")
    for c, (k, v) in zip(cache["layers"], kv):
        c.k[:, :upto] = k[:, :upto].to(c.k.dtype)
        c.v[:, :upto] = v[:, :upto].to(c.v.dtype)
    return h


def stub_forward(cfg, params, params32, batch, limits: dict) -> tuple:
    """One (1, S) prompt through ``transformer.forward`` on kernels D and
    E, counts read around exactly it (:func:`lm_launches`); again on
    their plain versions and, in float32 on ``params32``, on the plain
    versions (the witness: a sound change of rounding) and on D's and
    E's float32 routes.  Kernels vs plain, by position bins, held to
    ``limits`` (``max_diff``, ``argmax``) in bf16 and to
    ``limits["float32"]`` in float32 (against the plain path in
    float32); the witness printed beside them.  Returns the kernel
    path's logits and the report."""
    import torch

    from repro_torch.models import transformer as T

    dev = params["embed"]["table"].device
    seq = batch.embeds.shape[1]
    expect = lm_launches(cfg, params)
    sync(dev)
    reset_counts()
    logits = T.forward(cfg, params, batch)
    sync(dev)
    launches = read_counts()
    check(launches == expect,
          f"{cfg.name} forward: expected {expect['D']} launches of D and "
          f"{expect['E']} of E, got {launches}")
    check(tuple(logits.shape) == (1, seq, cfg.vocab_size),
          f"{cfg.name} forward logits {tuple(logits.shape)}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch32 = batch._replace(embeds=batch.embeds.float())
    with plain_kernels():
        plain = T.forward(cfg, params, batch)
    with plain_kernels():
        wide = T.forward(cfg32, params32, batch32)
    narrow = T.forward(cfg32, params32, batch32)
    rep = {"batch": 1, "seq": seq, "launches": launches,
           "vs_plain": compare_logits(logits, plain),
           "vs_plain_by_position": by_position(logits, plain),
           "float32_witness": {
               "vs_plain": compare_logits(wide, plain),
               "vs_plain_by_position": by_position(wide, plain)},
           "float32": {"vs_plain": compare_logits(narrow, wide)}}
    del plain, wide, narrow
    vs, f32 = rep["vs_plain"], rep["float32"]["vs_plain"]
    print(f"{cfg.name} forward ({cfg.num_layers} layers) B=1 S={seq}: "
          f"launches {launches}, kernels vs plain {vs}, by position "
          f"{rep['vs_plain_by_position']}; plain float32 vs plain "
          f"{rep['float32_witness']}; in float32 {f32}")
    check(within_limits(vs, limits),
          f"{cfg.name} forward: kernels vs plain {vs}, limits {limits}")
    check(within_limits(f32, limits["float32"]),
          f"{cfg.name} forward in float32: kernels vs plain {f32}, limits "
          f"{limits['float32']}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return logits, rep


def within_limits(vs: dict, limits: dict) -> bool:
    """A :func:`compare_logits` reading held to ``limits``."""
    return (vs["max_abs_diff"] <= limits["max_diff"]
            and vs["argmax_agree"] >= limits["argmax"])


def stub_timing(cfg, params, batch, rep: dict, what: str) -> None:
    """The forward's wall and device time (a checked trace), busy share,
    top kernels and share of its bound, into ``rep`` (on the card)."""
    from repro_torch.models import transformer as T

    fwd = lambda: T.forward(cfg, params, batch)  # noqa: E731
    rep["bound"] = lm_bounds(cfg, params, rep["seq"])
    if params["embed"]["table"].device.type != "cuda":
        return
    rep["wall_ms"] = host_ms(fwd, 2)
    timed(rep, "device_ms", fwd, 2, f"{what} forward",
          {"::rmsnorm_kernel<": rep["launches"]["D"],
           "::flash_fwd_kernel<": rep["launches"]["E"]})
    rep["bound_share"] = rep["bound"]["bound_ms"] / rep["device_ms"]
    busy, by_kernel = busy_share(fwd)
    rep["busy_share"] = busy
    rep["device_s_by_kernel"] = dict(sorted(
        by_kernel.items(), key=lambda kv: -kv[1])[:8])


def mrope_checks(cfg, params, batch, logits, before: int) -> dict:
    """M-RoPE at qwen2-vl's shapes: in float32, ``apply_mrope`` with t =
    h = w against ``apply_rope`` (within STUB_MROPE_F32); the prompt's
    forward at t = h = w (its (B, S) default positions) against its
    ``logits`` at the image's positions: equal over the first ``before``
    text tokens (the same positions), apart by more than LM_BF16_MAX_DIFF
    after them."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    dev, seq = logits.device, logits.shape[1]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, seq, cfg.num_heads, cfg.resolved_head_dim),
                    generator=gen, device=dev)
    pos = torch.arange(seq, device=dev)[None]
    rope = layers.apply_rope(x, pos, cfg.rope_theta)
    mrope = layers.apply_mrope(x, pos[None].expand(3, 1, seq),
                               cfg.rope_theta, cfg.mrope_sections)
    f32 = (rope - mrope).abs().max().item()
    del x, rope, mrope
    text = T.forward(cfg, params, batch._replace(positions=None))
    rep = {"rope_vs_mrope_f32": f32,
           "text_run": compare_logits(text[:, :before], logits[:, :before]),
           "after_text_run": compare_logits(text[:, before:],
                                            logits[:, before:])}
    del text
    print(f"{cfg.name} M-RoPE: float32 vs RoPE at t = h = w {f32!r}; "
          f"t = h = w vs the image's positions {rep}")
    check(f32 <= STUB_MROPE_F32,
          f"{cfg.name}: M-RoPE at t = h = w is {f32!r} from RoPE")
    check(rep["text_run"]["max_abs_diff"] <= LM_BF16_MAX_DIFF
          and rep["after_text_run"]["max_abs_diff"] > LM_BF16_MAX_DIFF,
          f"{cfg.name}: the image's positions do not move the logits as "
          f"M-RoPE's sections should: {rep}")
    return rep


def stub_decode_bound(cfg, params, rep: dict, bsz: int, first: int,
                      steps: int) -> None:
    """The decode steps' bound (positions ``first`` .. ``first`` +
    ``steps`` - 1, averaged) and, on the card, its share of the measured
    step."""
    bounds = [lm_bounds(cfg, params, bsz, ctx=t + 1)
              for t in range(first, first + steps)]
    rep["bound_ms"] = float(np.mean([b["bound_ms"] for b in bounds]))
    rep["bound_by"] = bounds[0]["bound_by"]
    if "decode_ms_per_step" in rep and \
            params["embed"]["table"].device.type == "cuda":
        rep["bound_share"] = rep["bound_ms"] / rep["decode_ms_per_step"]


def step_readings(cfg, params, cache, batch, pos: int, rep: dict,
                  what: str) -> None:
    """One decode step's device time (checked trace) and busy share, on
    the card."""
    from repro_torch.models import transformer as T

    if params["embed"]["table"].device.type != "cuda":
        return
    step = lambda: T.decode_step(cfg, params, cache, batch, pos)  # noqa
    timed(rep, "step_device_ms", step, 3, f"{what} decode step",
          {"::rmsnorm_kernel<": lm_launches(cfg, params)["D"]})
    busy, by_kernel = busy_share(step)
    rep["step_busy_share"] = busy
    rep["step_device_s_by_kernel"] = dict(sorted(
        by_kernel.items(), key=lambda kv: -kv[1])[:8])


def vl_serve(cfg, params, params32, embeds, gen_n: int,
             limits: dict) -> tuple:
    """qwen2-vl served at batch B: the prompts' cache from one forward
    (:func:`forward_prefill`), the first token from its last position,
    then ``gen_n`` - 1 greedy ``decode_step(Batch(tokens=...))`` steps,
    counts read around them (2L + 1 of D a step, none of E), timed;
    the served tokens teacher-forced through the plain D and E, their
    logits held to ``limits``.  Served again in float32 on ``params32``
    (D's and E's float32 routes), where the plain path teacher-forced
    reproduces the served tokens (every argmax equal) and its logits
    hold ``limits["float32"]``.  The first STUB_PREFILL_CHECK positions
    of the first prompt decoded one at a time (the reference's prefill)
    against the forward: the last position's logits within ``limits``.
    Returns the launches a step and the report."""
    import torch

    from repro_torch.models import transformer as T

    dev = embeds.device
    bsz, plen = embeds.shape[:2]
    n_norms = lm_launches(cfg, params)["D"]
    steps = gen_n - 1

    def run(c, p, x, served=None, count=False):
        """Prefill, then the decode steps (fed ``served``'s tokens when
        given, else greedy); with ``count``, the steps' launch counts
        read around them."""
        cache = T.init_cache(c, bsz, plen + gen_n, device=dev)
        h = forward_prefill(c, p, T.Batch(embeds=x), cache, plen)
        logits = [T._logits(c, p, h[:, -1:])[:, -1]]
        del h
        tok = logits[0].argmax(-1, keepdim=True)
        toks = [tok]
        sync(dev)
        if count:
            reset_counts()
        t0 = time.perf_counter()
        for i in range(steps):
            if served is not None:
                tok = served[:, i:i + 1]
            lg, cache = T.decode_step(c, p, cache, T.Batch(tokens=tok),
                                      plen + i)
            logits.append(lg[:, -1])
            tok = lg[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
        sync(dev)
        counts = read_counts() if count else None
        return (torch.cat(toks, 1), torch.stack(logits, 1), counts,
                time.perf_counter() - t0, cache)

    tokens, k_logits, launches, decode_s, cache = run(cfg, params, embeds,
                                                      count=True)
    check(launches == dict(lm_launches(cfg, params), D=n_norms * steps,
                           E=0),
          f"{cfg.name} serve: expected {n_norms * steps} launches of D and "
          f"none of E, got {launches}")
    with plain_kernels():
        _, p_logits, _, _, _ = run(cfg, params, embeds, tokens)
    rep: dict = {"batch": bsz, "prompt": plen, "gen": gen_n,
                 "launches_per_step": {k: v // steps
                                       for k, v in launches.items()},
                 "vs_plain": compare_logits(k_logits, p_logits),
                 "decode_ms_per_step": decode_s / steps * 1e3,
                 "tok_per_s": bsz * steps / decode_s}
    del k_logits, p_logits
    # float32: the plain path reproduces the tokens served on the kernels'
    # float32 routes
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens32, k32, _, _, _ = run(cfg32, params32, embeds.float())
    with plain_kernels():
        _, p32, _, _, _ = run(cfg32, params32, embeds.float(), tokens32)
    rep["float32"] = dict(compare_logits(k32, p32),
                          tokens_reproduced=bool(torch.equal(
                              p32.argmax(-1), tokens32)))
    del k32, p32
    # the reference's prefill, a decode step a position, over the first
    # positions of the first prompt, against the forward
    n = min(STUB_PREFILL_CHECK, plen)
    seq_cache = T.init_cache(cfg, 1, n, device=dev)
    for t in range(n):
        lg, seq_cache = T.decode_step(cfg, params, seq_cache, T.Batch(
            embeds=embeds[:1, t:t + 1]), t)
    fwd = T.forward(cfg, params, T.Batch(embeds=embeds[:1, :n]))
    rep["prefill_check"] = dict(compare_logits(lg, fwd[:, -1:]),
                                positions=n)
    del fwd, seq_cache
    vs, f32, pc = rep["vs_plain"], rep["float32"], rep["prefill_check"]
    stub_decode_bound(cfg, params, rep, bsz, plen, steps)
    step_readings(cfg, params, cache, T.Batch(tokens=tokens[:, -1:]),
                  plen + steps, rep, cfg.name)
    print(f"{cfg.name} serve batch={bsz} prompt={plen} gen={gen_n}: "
          f"launches {launches}, kernels vs plain {vs}, in float32 {f32}, "
          f"prefill check {pc}, {rep['tok_per_s']:.1f} tok/s, "
          f"{rep['decode_ms_per_step']:.2f} ms a step (bound "
          f"{rep['bound_ms']:.3f})")
    check(within_limits(vs, limits),
          f"{cfg.name} serve: kernels vs plain {vs}, limits {limits}")
    check(f32["tokens_reproduced"],
          f"{cfg.name} serve in float32: the plain path does not reproduce "
          f"the served tokens: {f32}")
    check(within_limits(f32, limits["float32"]),
          f"{cfg.name} serve in float32: kernels vs plain {f32}, limits "
          f"{limits['float32']}")
    check(pc["max_abs_diff"] <= limits["max_diff"],
          f"{cfg.name}: a decode-step prefill of {n} positions against the "
          f"forward: {pc}")
    return rep["launches_per_step"], rep


def audio_serve(cfg, params, params32, frames, plen: int, steps: int,
                limits: dict) -> tuple:
    """musicgen at batch B over ``frames`` (B, S, d), S tiled by
    FLASH_BLOCK and at least ``plen`` + ``steps``: the first ``plen``
    frames' cache from one forward over all S (:func:`forward_prefill`,
    which also gives the forward's logits at the later positions), then
    ``steps`` ``decode_step(Batch(embeds=...))`` steps each fed the next
    frame, counts read around them (2L + 1 of D a step, none of E),
    timed; the steps' logits against the forward's at the same positions
    (the reference's ``test_decode_matches_forward``): in bf16 within
    ``limits``, and in float32 on ``params32`` (E's float32 route) within
    STUB_DECODE_F32_MAX_DIFF.  Returns the launches a step and the
    report."""
    import torch

    from repro_torch.models import transformer as T

    dev = frames.device
    bsz = frames.shape[0]
    total = plen + steps
    n_norms = lm_launches(cfg, params)["D"]

    def run(c, p, x, count: bool):
        cache = T.init_cache(c, bsz, total, device=dev)
        h = forward_prefill(c, p, T.Batch(embeds=x), cache, plen)
        want = T._logits(c, p, h[:, plen:total])
        del h
        sync(dev)
        if count:
            reset_counts()
        t0 = time.perf_counter()
        got = [T.decode_step(c, p, cache, T.Batch(embeds=x[:, t:t + 1]),
                             t)[0][:, -1] for t in range(plen, total)]
        sync(dev)
        return (torch.stack(got, 1), want,
                read_counts() if count else None,
                time.perf_counter() - t0, cache)

    got, want, launches, decode_s, cache = run(cfg, params, frames, True)
    check(launches == dict(lm_launches(cfg, params), D=n_norms * steps,
                           E=0),
          f"{cfg.name} serve: expected {n_norms * steps} launches of D and "
          f"none of E, got {launches}")
    rep: dict = {"batch": bsz, "prompt": plen, "gen": steps,
                 "launches_per_step": {k: v // steps
                                       for k, v in launches.items()},
                 "vs_forward": compare_logits(got, want),
                 "decode_ms_per_step": decode_s / steps * 1e3,
                 "tok_per_s": bsz * steps / decode_s}
    del got, want
    got, want, _, _, _ = run(dataclasses.replace(cfg, dtype="float32"),
                             params32, frames.float(), False)
    rep["float32_vs_forward"] = compare_logits(got, want)
    del got, want
    vs, f32 = rep["vs_forward"], rep["float32_vs_forward"]
    print(f"{cfg.name} decode batch={bsz} from {plen} frames, {steps} "
          f"teacher-forced steps: launches {launches}, decode vs forward "
          f"{vs}, in float32 {f32}")
    check(within_limits(vs, limits),
          f"{cfg.name}: decode vs forward {vs}, limits {limits}")
    check(f32["max_abs_diff"] <= STUB_DECODE_F32_MAX_DIFF,
          f"{cfg.name}: decode vs forward in float32 {f32}")
    stub_decode_bound(cfg, params, rep, bsz, plen, steps)
    step_readings(cfg, params, cache, T.Batch(
        embeds=frames[:, total - 1:total]), total - 1, rep, cfg.name)
    print(f"{cfg.name} serve: {rep['tok_per_s']:.1f} frames/s, "
          f"{rep['decode_ms_per_step']:.2f} ms a step (bound "
          f"{rep['bound_ms']:.3f})")
    return rep["launches_per_step"], rep


def compression_check(cfg, params, image: tuple, gen) -> dict:
    """Gradient compression (``optim.compression``) on a full gradient:
    one ``loss_fn`` backward of ``cfg`` on a (1, S) prompt of ``image``'s
    layout (kernel E with its stats, kernel D, the M-RoPE backward),
    counts read around it; then two ``compress_with_feedback`` steps in
    int8 and one in bf16 over every leaf, each timed, each leaf held to
    its reconstruction bound (INT8_ERR_STEPS of its scale; BF16_REL_ERR
    of |target| plus BF16_ABS_ERR) and its new error feedback bitwise ``target - recon``,
    the bytes on the wire = the elements x 1 (x 2), and three leaves run
    again on the CPU, bitwise."""
    import torch

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as C

    dev = params["embed"]["table"].device
    embeds, pos = stub_embeds(cfg, params, image, 0, 1, gen)
    seq = embeds.shape[1]
    labels = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device=dev)
    batch = T.Batch(embeds=embeds, positions=pos, labels=labels)
    with torch.enable_grad():
        train = S.trainable(params)
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        loss, grads = S.value_and_grad(cfg, train, batch)
        sync(dev)
        backward_s = time.perf_counter() - t0
        launches = read_counts()
    del train
    check(launches == lm_launches(cfg, params),
          f"{cfg.name} loss_fn backward: expected {lm_launches(cfg, params)}"
          f" launches, got {launches}")
    check(bool(torch.isfinite(loss)), f"{cfg.name}: loss {loss}")
    named = dict(_flatten(grads))
    numel = sum(g.numel() for g in named.values())
    rep: dict = {"seq": seq, "image": list(image), "loss": float(loss),
                 "launches": launches, "backward_s": backward_s,
                 "leaves": len(named), "elements": numel, "steps": []}
    ef = C.init_error_feedback(grads)
    for kind in ("int8", "int8", "bf16"):
        ccfg = C.CompressionConfig(kind)
        sync(dev)
        t0 = time.perf_counter()
        comp, new_ef = C.compress_with_feedback(grads, ef, ccfg)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        wire = C.compressed_bytes(grads, ccfg)
        check(wire == numel * ccfg.bytes_per_element,
              f"compression: {wire} bytes on the wire for {numel} "
              f"elements of {kind}")
        worst = 0.0
        # the compressed leaves in the order of _flatten's paths
        flat_c = dict(zip(named, C._leaves(comp)))
        flat_e = dict(_flatten(new_ef))
        flat_prev = dict(_flatten(ef))
        for path, e_prev in flat_prev.items():
            g, c, e_new = named[path], flat_c[path], flat_e[path]
            target = g.float() + e_prev
            recon = C.decompress_leaf(c)
            err = (target - recon).abs()
            if kind == "int8":
                share = (err.max() / (c.scale * INT8_ERR_STEPS)).item()
            else:
                share = (err / (target.abs() * BF16_REL_ERR
                                + BF16_ABS_ERR)).max().item()
            check(share <= 1.0, f"compression {kind} {path}: |target - "
                  f"recon| reaches {share!r} of its bound")
            worst = max(worst, share)
            del err
            check(torch.equal((target - recon).view(torch.int32),
                              e_new.view(torch.int32)),
                  f"compression {kind} {path}: the new error feedback is "
                  f"not target - recon")
            del target, recon
        bits = torch.int8 if kind == "int8" else torch.int16
        # a sample run again on the CPU: a norm scale, the first layer's
        # q bias, the last layer's k projection
        for path in ("final_norm/scale", "layers/0/mixer/b_q",
                     f"layers/{cfg.num_layers - 1}/mixer/w_k"):
            cpu_c, cpu_e = C.compress_with_feedback(
                {"x": named[path].cpu()}, {"x": flat_prev[path].cpu()},
                ccfg)
            c, want = flat_c[path], cpu_c["x"]
            check(torch.equal(c.payload.cpu().view(bits),
                              want.payload.view(bits))
                  and (c.scale is None) == (want.scale is None)
                  and (c.scale is None or torch.equal(
                      c.scale.cpu().view(torch.int32),
                      want.scale.view(torch.int32)))
                  and torch.equal(flat_e[path].cpu().view(torch.int32),
                                  cpu_e["x"].view(torch.int32)),
                  f"compression {kind} {path}: card and CPU differ")
        rep["steps"].append({"kind": kind, "ms": ms, "wire_bytes": wire,
                             "worst_share_of_bound": worst,
                             "cpu_leaves_bitwise": True})
        print(f"{cfg.name} compression {kind}: {ms:.1f} ms over "
              f"{len(named)} leaves, {numel} elements, {wire:.0f} bytes "
              f"on the wire, the worst leaf at {worst!r} of its bound")
        ef = new_ef
        del comp, flat_c, flat_e, flat_prev
    del grads, named, ef, new_ef
    return rep


def phase_stub(dev, smi: str, vl=None, audio=None, image: tuple = STUB_IMAGE,
               frames: int = STUB_FRAMES, serve: tuple = STUB_SERVE,
               grad_image: tuple = STUB_GRAD_IMAGE) -> tuple:
    """The modality-stub models at full width and depth on ``dev``
    (``vl``, ``audio``: other configs).  qwen2-vl-2b: (a) the forward on
    one prompt of ``image``'s layout at its t/h/w positions
    (:func:`stub_forward`: counts, kernels vs plain, the float32
    witness), its timing and bound; the M-RoPE gates
    (:func:`mrope_checks`); (b) serving at ``serve`` (batch, tokens) from
    the same layout's prompts (:func:`vl_serve`); (c) the compression
    gate on a ``grad_image`` backward (:func:`compression_check`).
    musicgen-large: (a) the forward on ``frames`` frame embeddings;
    (b) teacher-forced decode after them, against the forward
    (:func:`audio_serve`).  (c) The reduced float32 models against
    ``LM_ANCHORS``.  Returns each model's forward and decode-step launch
    counts and the ``stub`` report."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    bsz, gen_n = serve
    report: dict = {}
    launches: dict = {}
    for cfg in (vl or get_config(STUB_VL), audio or get_config(STUB_AUDIO)):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        rep: dict = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                     "heads": [cfg.num_heads, cfg.num_kv_heads],
                     "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
                     "ffn": cfg.ffn_kind, "vocab": cfg.vocab_size,
                     "tied": cfg.tie_embeddings,
                     "mrope_sections": list(cfg.mrope_sections),
                     "rope": cfg.use_rope, "dtype": cfg.dtype}
        gen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            t0 = time.perf_counter()
            params = T.init_params(cfg, gen, dev)
            sync(dev)
            rep.update(init_s=time.perf_counter() - t0,
                       params=T.param_count(params),
                       param_gb=T.param_bytes(params) / 1e9)
            params32 = float32_copy(params)
            vl_arch = bool(cfg.mrope_sections)
            if vl_arch:
                # the prompts; served by tokens after them
                embeds, pos = stub_embeds(cfg, params, image, 0, bsz, gen)
                n = embeds.shape[1]
                batch = T.Batch(embeds=embeds[:1], positions=pos[:, :1])
                rep["image"] = dict(zip(("before", "rows", "cols", "after"),
                                        image))
            else:
                # the prompts' frames and the gen_n fed after them, to a
                # length the prompt attention tiles
                span = frames + gen_n
                if span > FLASH_BLOCK:
                    span = -(-span // FLASH_BLOCK) * FLASH_BLOCK
                embeds, pos = stub_embeds(cfg, params, None, span, bsz, gen)
                n = frames
                batch = T.Batch(embeds=embeds[:1, :n])
            limits = STUB_LIMITS[cfg.name]
            logits, fwd = stub_forward(cfg, params, params32, batch,
                                       limits)
            if vl_arch:
                fwd["mrope"] = mrope_checks(cfg, params, batch, logits,
                                            image[0])
            del logits
            stub_timing(cfg, params, batch, fwd, cfg.name)
            rep["forward"] = fwd
            if vl_arch:
                step, rep["serve"] = vl_serve(cfg, params, params32, embeds,
                                              gen_n, limits)
            else:
                step, rep["serve"] = audio_serve(cfg, params, params32,
                                                 embeds, n, gen_n, limits)
            del params32, embeds, batch, pos
            if cuda:
                torch.cuda.empty_cache()
        if vl_arch:
            rep["compression"] = compression_check(cfg, params, grad_image,
                                                   gen)
        del params
        if cuda:
            rep["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.empty_cache()
        launches[cfg.name] = {"forward": fwd["launches"],
                              "decode_step": step}
        report[cfg.name] = rep

    # (c) the reduced float32 models against the JAX anchors
    report["anchors"] = {arch: phase_anchor(arch, dev)
                         for arch in (STUB_VL, STUB_AUDIO)}
    report["wall_s"] = time.perf_counter() - t_phase
    report["card"] = smi
    print(f"stub phase: {report['wall_s']:.1f} s; card {smi}")
    return launches, report


# ---------------------------------------------------------------------------
# MoE serving (the ninth path)
# ---------------------------------------------------------------------------

#: arctic-480b at full width (d 7168, 56/8 heads of 128, 128 experts
#: top-2 of d_ff 4864 at capacity factor 1.25 beside a dense residual FFN,
#: vocab 32,000, bf16), cut to MOE_LAYERS of its 35 layers: 27.2 GB of
#: weights a layer, so two and the embeddings (55.4 GB) fill one card.
#: One MOE_SEQ-token prompt: the reference's prefill_32k cut so that the
#: same forward on the plain versions of D and E fits beside the weights.
MOE_ARCH, MOE_LAYERS, MOE_SEQ = "arctic-480b", 2, 4096
#: Serving at the reference CLI's defaults: batch, prompt, generated.
MOE_SERVE = (4, 32, 16)
#: Kernels vs plain.  A bf16 ulp of a norm or attention output can flip
#: a router's near tie, and the token then takes another expert (and the
#: picks ranked after it in that expert may move past the capacity), so
#: each MoE layer's (token, choice) routes are held to MOE_ROUTES_AGREE
#: equal, the logits to LM_BF16_MAX_DIFF at the tokens whose routes agree
#: in every layer (in decode, at that step and every earlier one: its
#: cache holds them), and the argmaxes to MOE_ARGMAX over those tokens
#: and over all.  With seeded random weights the routes are near ties
#: often: the residual stream is mostly a direction every token shares
#: (37-49 % of the prompt's picks are dropped at capacity), and arctic's
#: logits (no softcap, vocab 32,000) have closer top-2 gaps than
#: gemma2's.  Readings on the H100 (forward, prompts of seed 0 and 1):
#: 99.74 / 99.63 % of layer 0's routes equal and 98.39 / 98.29 % of layer
#: 1's, 0.078 / 0.063 apart where they agree (3.3 elsewhere), 98.05 /
#: 97.90 % of the argmaxes equal there and 96.70 / 96.51 % over all
#: tokens.  The witness, the plain path in float32 against the plain
#: path (a sound change of rounding, larger than one ulp here and
#: there), reads 98.61 / 98.40 % and 96.11 / 95.95 % of the routes and
#: 93.48 / 92.94 % of the argmaxes: each limit lies between the two.
MOE_ROUTES_AGREE = 0.975
MOE_ARGMAX = 0.95
#: The generator seed of the second prompt held to those limits (the
#: first is drawn after the weights, from their generator).
MOE_SECOND_PROMPT_SEED = 1
#: The unit the report's byte and operation bounds divide by: HBM bytes
#: a second and bf16 tensor-core operations a second (PEAK_BYTES_PER_S,
#: NVIDIA's H100 SXM data sheet).
BF16_PEAK_OPS = 989e12


def moe_config(layers: int = MOE_LAYERS):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), num_layers=layers)


def route_agreement(k_routes: list, p_routes: list) -> tuple:
    """Two runs' routes, call for call: the share of (token, choice)
    routes equal in each call, and each call's (tokens,) mask of the
    tokens whose routes and keep flags are all equal."""
    check(len(k_routes) == len(p_routes),
          f"{len(k_routes)} routed calls against {len(p_routes)}")
    shares, same = [], []
    for a, b in zip(k_routes, p_routes):
        eq = a.top_e == b.top_e
        shares.append(eq.float().mean().item())
        same.append((eq & (a.keep == b.keep)).reshape(-1, eq.shape[-1])
                    .all(-1))
    return shares, same


def lm_bounds(cfg, params, tokens: int, kept: int = 0, used: int = 0,
              ctx: int = 0, absorb: bool = False) -> dict:
    """The least time the card could take for one pass of ``tokens``
    tokens (a prompt of one sequence; with ``ctx``, one decode token of
    each of ``tokens`` sequences over a cache of ``ctx`` positions)
    through ``cfg``'s ``params``, counted from the code's own shapes: the
    larger of the bytes it must move over PEAK_BYTES_PER_S (every weight
    read once, of the experts only the ``used`` (layer, expert) pairs',
    of the embedding the gathered rows (or frontend embeddings, as many
    bytes) unless the head is tied to it and reads it whole; the token ids, each attention
    layer's k and v cache and, in decode, each SSM layer's state read
    once, the new states and the logits written once) and its operations:
    the bf16 ones (2 a weight and token of each product, the experts' for
    ``kept`` picks or slots summed over the MoE layers; q·k and p@v over
    the visible pairs, causal for a prompt, ``ctx`` keys a decode token)
    over BF16_PEAK_OPS plus the float32 ones over PEAK_F32_OPS_PER_S
    (Mamba's dt projection, conv and scan, the mLSTM gates, its parallel
    form's q·k and weighted sum over the visible pairs or its decode's
    memory update, the sLSTM cell).  An MLA layer reads its compressed
    cache (``c_kv`` and ``k_pe``) once; its products are its weights'
    a token in a prompt (q·k over nope + rope, p@v over v, bf16), and in
    decode the formulation's own (``absorb``): naive expands ``k_nope``
    and v over the cache (bf16) and scores and sums in float32; absorbed
    folds ``w_uk`` into q and ``w_uv`` after the latent context (bf16),
    scoring and summing in the latent space in float32."""
    from repro_torch.models import transformer as T

    m, d, V = cfg.moe, cfg.d_model, cfg.vocab_size
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    table = params["embed"]["table"]
    item = table.element_size()
    flags = T.layer_moe_flags(cfg)
    unused = 0 if m is None else \
        (sum(flags) * m.num_experts - used) * 3 * d * m.d_ff_expert * item
    # a tied head reads the whole table; else only the gathered rows
    gathered = 0 if cfg.tie_embeddings else table.numel() * item
    nbytes = (T.param_bytes(params) - gathered - unused
              + tokens * (d * item + 8) + tokens * V * item)
    pairs = tokens * ctx if ctx else tokens * (tokens + 1) // 2
    bf16, f32 = 2 * tokens * d * V, 0
    if m is not None:
        bf16 += 6 * kept * d * m.d_ff_expert
    for i, (layer, use_moe) in enumerate(zip(params["layers"], flags)):
        kind = cfg.layer_kind(i)
        if kind.startswith("attn") and cfg.attention_kind == "mla":
            b16, b32, cache = mla_work(cfg, tokens, pairs, ctx, absorb)
            bf16, f32 = bf16 + b16, f32 + b32
            nbytes += cache * item
        elif kind.startswith("attn"):
            bf16 += (tokens * 2 * (2 * d * h * hd + 2 * d * kv * hd)
                     + 4 * hd * h * pairs)
            nbytes += 2 * tokens * ctx * kv * hd * item
        elif kind == "mamba":
            di, n = cfg.ssm_expand * d, cfg.ssm_state_dim
            w, r = cfg.ssm_conv_width, max(1, d // 16)
            bf16 += tokens * 2 * (2 * d * di + di * (2 * n + r) + di * d)
            # dt projection, conv taps, and a step's exp(dt·A), dt·x·B,
            # da·h + dbx and C·h
            f32 += tokens * (2 * r * di + 2 * w * di + 7 * di * n)
            if ctx:
                nbytes += 2 * tokens * ((w - 1) * di * item + di * n * 4)
        elif kind == "mlstm":
            di, hdm = 2 * d, 2 * d // h
            bf16 += tokens * 2 * (2 * d * di + 3 * di * di + di * d)
            f32 += tokens * 4 * di * h
            if ctx:
                f32 += tokens * 6 * h * hdm * hdm
                nbytes += 2 * tokens * h * (hdm * hdm + hdm + 1) * 4
            else:
                f32 += 4 * di * pairs
        elif kind == "slstm":
            bf16 += tokens * 2 * (4 * d * d + 4 * d * (d // h) + d * d)
            f32 += tokens * 15 * d
            if ctx:
                nbytes += 2 * tokens * 4 * d * 4
        ffn = layer.get("ffn")
        if ffn is None:
            continue
        dense = 3 if cfg.ffn_kind == "swiglu" else 2
        if not use_moe:
            bf16 += tokens * 2 * dense * d * cfg.d_ff
            continue
        bf16 += tokens * 2 * d * m.num_experts
        if m.num_shared_experts:
            bf16 += tokens * 2 * 3 * d * m.d_ff_expert * m.num_shared_experts
        if m.dense_residual:
            bf16 += tokens * 2 * dense * d * cfg.d_ff
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (bf16 / BF16_PEAK_OPS + f32 / PEAK_F32_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "ops": bf16 + f32, "f32_ops": f32,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def mla_work(cfg, tokens: int, pairs: int, ctx: int = 0,
             absorb: bool = False) -> tuple:
    """One MLA layer's bf16 and float32 operations and the cache elements
    it reads, for ``tokens`` tokens over ``pairs`` visible (query, key)
    pairs: a prompt (``ctx`` 0) or one decode token of each of ``tokens``
    sequences over ``ctx`` cached positions, naive or ``absorb``ed (see
    :func:`lm_bounds`)."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    vd, ql = cfg.v_head_dim, cfg.q_lora_rank
    qk = nope + rope
    w_q = d * ql + ql * h * qk if ql else d * h * qk
    # the weights every token goes through: q, the latent, the rope key,
    # the output
    own = w_q + d * r + d * rope + h * vd * d
    if not ctx:
        return (tokens * 2 * (own + r * h * (nope + vd))
                + 2 * h * (qk + vd) * pairs, 0, 0)
    cache = tokens * ctx * (r + rope)
    if absorb:
        return (tokens * 2 * (own + h * nope * r + h * r * vd),
                2 * h * (r + rope + r) * pairs, cache)
    return (tokens * 2 * own + 2 * pairs * r * h * (nope + vd),
            2 * h * (qk + vd) * pairs, cache)


def routed_work(routes: list) -> tuple:
    """Kept picks and (layer, expert) pairs with a kept pick, summed over
    ``routes`` (one call a layer)."""
    kept = sum(int(r.keep.sum()) for r in routes)
    used = sum(int(r.top_e[r.keep].unique().numel()) for r in routes)
    return kept, used


#: Position bins of :func:`by_position`: the first token, then the
#: ranges a perturbation has had more steps to grow over.
POSITION_EDGES = (0, 1, 16, 256, 1024)


def by_position(got, want) -> list:
    """:func:`compare_logits` of (1, S, V) logits over the position bins
    of POSITION_EDGES (the last bin runs to S)."""
    s = got.shape[1]
    edges = [e for e in POSITION_EDGES if e < s] + [s]
    return [dict(compare_logits(got[:, a:b], want[:, a:b]), positions=[a, b])
            for a, b in zip(edges, edges[1:])]


def masked_vs(got, want, ok) -> dict:
    """:func:`compare_logits` of the rows of (..., V) logits where the
    bool mask ``ok`` (their leading shape) holds."""
    ok = ok.to(got.device)
    return dict(compare_logits(got[ok], want[ok]),
                rows=int(ok.sum()), of_rows=ok.numel())


def float32_copy(params: dict) -> dict:
    """``params`` with every floating leaf cast to float32 except the
    MoE blocks' expert weights (``w_gate``, ``w_up``, ``w_down`` beside
    a ``router``), which stay as they are: :func:`float32_experts` casts
    them a slice at a time (at arctic-480b's width the rest is 3.6 GB of
    float32, the experts would be 107 GB)."""
    def walk(node, experts=False):
        if isinstance(node, dict):
            moe = "router" in node
            return {k: walk(v, moe and k in ("w_gate", "w_up", "w_down"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node if experts or not node.is_floating_point() \
            else node.float()
    return walk(params)


#: Experts :func:`float32_experts` casts at once (at arctic-480b's width
#: 2.2 GB of float32 a weight).
F32_EXPERT_SLICE = 16


@contextlib.contextmanager
def float32_experts(n: int = F32_EXPERT_SLICE):
    """Inside the ``with``, ``torch.bmm`` of a float32 batch by a batch
    of another dtype (the MoE block's expert products on the weights
    :func:`float32_copy` kept as they are) casts the second to float32
    ``n`` matrices at a time: with :func:`float32_copy`, the forward in
    float32 on the same weights."""
    import torch

    bmm = torch.bmm

    def wide_bmm(a, b):
        if a.dtype == b.dtype:
            return bmm(a, b)
        check(a.dtype == torch.float32,
              f"float32_experts: a {a.dtype} batch by a {b.dtype} one")
        return torch.cat([bmm(a[i:i + n], b[i:i + n].float())
                          for i in range(0, b.shape[0], n)])

    torch.bmm = wide_bmm
    try:
        yield
    finally:
        torch.bmm = bmm


def lm_launches(cfg, params) -> dict:
    """The launches of each kernel one forward of ``cfg`` makes: kernel D
    once a norm (``norm1``, ``norm2``, the post norms a layer has, MLA's
    ``q_norm`` and ``kv_norm``, and the final norm), kernel E once an
    attention layer, A-C none.  A decode step makes as many of D and none
    of E."""
    n_norms = 1 + sum(k in layer for layer in params["layers"]
                      for k in ("norm1", "norm2", "post_norm1",
                                "post_norm2")) \
        + sum(k in layer["mixer"] for layer in params["layers"]
              for k in ("q_norm", "kv_norm"))
    n_attn = sum(cfg.layer_kind(i).startswith("attn")
                 for i in range(len(params["layers"])))
    return {"A": 0, "B": 0, "C": 0, "D": n_norms, "E": n_attn}


#: The kernels-vs-plain limits of an MoE prompt (phase 9d): each MoE
#: layer's routes, the logits where the routes agree in every layer, the
#: argmaxes there and over all tokens.
MOE_LIMITS = {"routes": MOE_ROUTES_AGREE, "max_diff": LM_BF16_MAX_DIFF,
              "argmax": MOE_ARGMAX}


def moe_prompt(cfg, params, params32, tokens, limits: dict = MOE_LIMITS,
               f32_slice: int = F32_EXPERT_SLICE) -> tuple:
    """One (1, S) prompt through ``transformer.forward`` on kernels D
    and E, counts read around exactly it (:func:`lm_launches`: for
    arctic 2L + 1 of D and L of E, none of A-C) and, on the card, its
    transient memory and peak (with MoE, the transient below one expert
    weight: the expert products copy no weight); again
    on the plain D and E; and on the plain path in float32
    (``params32``, the same weights; :func:`float32_experts` with
    ``f32_slice``), the witness of how far a sound change of rounding
    moves the routes and logits.  Kernels vs plain: each MoE layer's
    routes, the logits where the routes agree in every layer (every
    token in a model without MoE), the argmaxes there and over all
    tokens, by position bins and, with ``limits["prefix"]``, over the
    first positions, printed and then held to ``limits``
    (:func:`within`); the float32 plain path vs the plain path: the same
    readings, printed beside them.  With ``limits["float32"]`` the
    forward also runs in float32 on the kernels (their float32 routes),
    held against the plain path in float32 over every position.  Returns
    the kernel path's routes and the report."""
    import torch

    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    dev, seq = tokens.device, tokens.shape[1]
    cuda = dev.type == "cuda"
    expect = lm_launches(cfg, params)
    batch = T.Batch(tokens=tokens)
    if cuda:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    reset_counts()
    with A.record_routes() as k_routes:
        logits = T.forward(cfg, params, batch)
    sync(dev)
    launches = read_counts()
    check(launches == expect,
          f"{cfg.name} forward: expected {expect['D']} launches of D and "
          f"{expect['E']} of E, got {launches}")
    check(tuple(logits.shape) == (1, seq, cfg.vocab_size),
          f"{cfg.name} forward logits {tuple(logits.shape)}")
    rep: dict = {"batch": 1, "seq": seq, "launches": launches}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        rep["peak_mem_gb"] = peak / 1e9
        rep["transient_gb"] = (peak - base) / 1e9
        if cfg.moe:
            w_up = next(p["ffn"]["w_up"] for p in params["layers"]
                        if "router" in p.get("ffn", {}))
            check(peak - base < w_up.numel() * w_up.element_size(),
                  f"{cfg.name} forward: {rep['transient_gb']:.2f} GB "
                  f"transient, more than one expert weight: a weight was "
                  f"copied")
    with plain_kernels(), A.record_routes() as p_routes:
        plain = T.forward(cfg, params, batch)
    with plain_kernels(), float32_experts(f32_slice), \
            A.record_routes() as w_routes:
        wide = T.forward(dataclasses.replace(cfg, dtype="float32"),
                         params32, batch)
    shares, same = route_agreement(k_routes, p_routes)
    w_shares, w_same = route_agreement(w_routes, p_routes)
    everyone = torch.ones(seq, dtype=torch.bool, device=dev)
    ok = torch.stack(same).all(0) if same else everyone
    w_ok = torch.stack(w_same).all(0) if w_same else everyone
    rep.update(routes_agree=shares,
               tokens_routes_equal=ok.float().mean().item(),
               dropped_share=[(~r.keep).float().mean().item()
                              for r in k_routes],
               vs_plain=masked_vs(logits[0], plain[0], ok),
               vs_plain_all_tokens=compare_logits(logits, plain),
               vs_plain_by_position=by_position(logits, plain),
               float32_witness={
                   "routes_agree": w_shares,
                   "tokens_routes_equal": w_ok.float().mean().item(),
                   "vs_plain": masked_vs(wide[0], plain[0], w_ok),
                   "vs_plain_all_tokens": compare_logits(wide, plain),
                   "vs_plain_by_position": by_position(wide, plain)})
    if "prefix" in limits:
        n = limits["prefix"]
        rep["vs_plain_prefix"] = dict(
            compare_logits(logits[:, :n], plain[:, :n]), positions=n)
        rep["float32_witness"]["vs_plain_prefix"] = dict(
            compare_logits(wide[:, :n], plain[:, :n]), positions=n)
    if "float32" in limits:
        # the kernel path in float32 against the plain path in float32
        # (the witness's forward): D's and E's float32 routes
        with float32_experts(f32_slice), A.record_routes() as f_routes:
            narrow = T.forward(dataclasses.replace(cfg, dtype="float32"),
                               params32, batch)
        f_shares, f_same = route_agreement(f_routes, w_routes)
        f_ok = torch.stack(f_same).all(0) if f_same else everyone
        rep["float32"] = {
            "routes_agree": f_shares,
            "vs_plain": masked_vs(narrow[0], wide[0], f_ok),
            "vs_plain_all_tokens": compare_logits(narrow, wide),
            "vs_plain_by_position": by_position(narrow, wide)}
        del narrow
    del logits, plain, wide
    print(f"{cfg.name} forward ({cfg.num_layers} layers) B=1 "
          f"S={seq}: launches {launches}, routes equal {shares}, "
          f"dropped {rep['dropped_share']}, kernels vs plain where "
          f"routes agree {rep['vs_plain']}, over all tokens "
          f"{rep['vs_plain_all_tokens']}, first positions "
          f"{rep.get('vs_plain_prefix')}, by position "
          f"{rep['vs_plain_by_position']}; plain float32 vs plain "
          f"{rep['float32_witness']}; in float32 {rep.get('float32')}")
    check(len(shares) == sum(T.layer_moe_flags(cfg))
          and within(shares, rep, limits),
          f"{cfg.name} forward: kernels vs plain {rep}, limits {limits}")
    if "float32" in limits:
        f32 = rep["float32"]
        check(within(f32["routes_agree"], f32, limits["float32"]),
              f"{cfg.name} forward in float32: kernels vs plain {f32}, "
              f"limits {limits['float32']}")
    return k_routes, rep


def within(shares: list, rep: dict, limits: dict) -> bool:
    """Whether a kernels-vs-plain reading holds its ``limits``: each MoE
    layer's routes; the logits where the routes agree, the argmaxes there
    and over all tokens; or, with ``prefix``, the logits and argmaxes of
    the first ``prefix`` positions and the argmaxes over all
    (``argmax_all``)."""
    if min(shares, default=1.0) < limits["routes"]:
        return False
    if "prefix" in limits:
        head = rep["vs_plain_prefix"]
        return (head["max_abs_diff"] <= limits["max_diff"]
                and head["argmax_agree"] >= limits["argmax"]
                and rep["vs_plain_all_tokens"]["argmax_agree"]
                >= limits["argmax_all"])
    return (rep["vs_plain"]["max_abs_diff"] <= limits["max_diff"]
            and min(rep["vs_plain"]["argmax_agree"],
                    rep["vs_plain_all_tokens"]["argmax_agree"])
            >= limits["argmax"])


def serve_vs_plain(cfg, params, prompts, gen_n: int,
                   limits: dict = MOE_LIMITS, argv: list | None = None
                   ) -> tuple:
    """Serving ``cfg`` on ``params``: ``token_serve.generate`` of
    ``prompts`` (B, P) for ``gen_n`` tokens, or, with ``argv``,
    ``token_serve.main(argv)`` (which must rebuild these weights and
    draw these prompts), counts read around it (the norms' launches of
    D a decode step, none of E or A-C); served again (the same tokens;
    its host times are read); the served tokens teacher-forced through
    kernels D and E (which reproduce them) and through their plain
    versions: each MoE layer's routes, the logits where a sequence's
    routes agreed in every layer at that step and every earlier one
    (its state holds them; every step without MoE), the argmaxes there
    and over all, printed and then held to ``limits``.  The bounds of the
    generated steps, averaged: the static buffer's (every expert's
    weights, as the reference computes it) and, with MoE, the routed
    one (the experts a step's kept picks use); on the card one decode
    step's device time, busy share and top kernels.  Returns the launch
    counts a step and the report."""
    import torch

    from repro_torch.launch import token_serve
    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    dev, m = prompts.device, cfg.moe
    bsz, plen = prompts.shape
    steps = plen + gen_n - 1
    n_norms = lm_launches(cfg, params)["D"]
    sync(dev)
    reset_counts()
    if argv is None:
        tokens = token_serve.generate(cfg, params, prompts, gen_n)["tokens"]
    else:
        out = token_serve.main(argv + ["--device", str(dev)])
        check(np.array_equal(out["prompts"], prompts.cpu().numpy()),
              f"{cfg.name} serve: main drew other prompts")
        tokens = torch.as_tensor(out["tokens"], device=dev)
    sync(dev)
    served = read_counts()
    check(served == {"A": 0, "B": 0, "C": 0, "D": n_norms * steps,
                     "E": 0},
          f"{cfg.name} serve: expected {n_norms * steps} launches of D and "
          f"none of E, got {served}")
    again = token_serve.generate(cfg, params, prompts, gen_n)
    check(torch.equal(again["tokens"], tokens),
          f"{cfg.name} serve: two runs served different tokens")
    seq_toks = torch.cat([prompts, tokens[:, :-1]], dim=1)
    with A.record_routes() as k_routes:
        k_logits = teacher_forced(cfg, params, seq_toks, dev)
    with plain_kernels(), A.record_routes() as p_routes:
        p_logits = teacher_forced(cfg, params, seq_toks, dev)
    got = torch.stack(k_logits[plen - 1:], 1)
    want = torch.stack(p_logits[plen - 1:], 1)
    del k_logits, p_logits
    check(torch.equal(got.argmax(-1), tokens),
          f"{cfg.name} serve: the teacher-forced kernel path does not "
          f"reproduce the served tokens")
    shares, same = route_agreement(k_routes, p_routes)
    n_moe = len(k_routes) // steps
    check(n_moe * steps == len(k_routes)
          and n_moe == sum(T.layer_moe_flags(cfg)),
          f"{cfg.name} serve: {len(k_routes)} routed calls in {steps} steps")
    ok = torch.ones((bsz, gen_n), dtype=torch.bool, device=dev)
    layer_shares = np.ones(0)
    if n_moe:
        # a sequence agrees at a step if its routes agreed in every layer
        # at that step and every earlier one (its cache holds them)
        ok = torch.stack(same).reshape(steps, n_moe, bsz).all(1) \
            .int().cumprod(0).bool()[plen - 1:].T
        layer_shares = np.asarray(shares).reshape(steps, n_moe).mean(0)
    srep: dict = {
        "batch": bsz, "prompt": plen, "gen": gen_n,
        "launches": served,
        "launches_per_step": {k: v // steps for k, v in served.items()},
        "routes_agree": layer_shares.tolist(),
        "dropped_share": [
            float(np.mean([(~r.keep).float().mean().item()
                           for r in k_routes[i::n_moe]]))
            for i in range(n_moe)],
        "vs_plain": masked_vs(got, want, ok),
        "vs_plain_all_tokens": compare_logits(got, want),
        "prefill_s": again["prefill_s"], "decode_s": again["decode_s"],
        "decode_ms_per_step": again["decode_s"] / (gen_n - 1) * 1e3,
        "tok_per_s": bsz * (gen_n - 1) / again["decode_s"]}
    del got, want
    # bounds of the generated decode steps, averaged: the static
    # buffer's (every expert's weights, as the reference computes it)
    # and the routed one (the experts a step's kept picks use)
    static, routed = [], []
    for t in range(plen, steps):
        kept, used = routed_work(k_routes[t * n_moe:(t + 1) * n_moe])
        every = n_moe * m.num_experts if m else 0
        static.append(lm_bounds(cfg, params, bsz, kept, every, ctx=t + 1))
        routed.append(lm_bounds(cfg, params, bsz, kept, used, ctx=t + 1))
    srep["bound_ms"] = float(np.mean([b["bound_ms"] for b in static]))
    srep["bound_by"] = static[0]["bound_by"]
    if n_moe:
        srep["routed_bound_ms"] = float(np.mean([b["bound_ms"]
                                                 for b in routed]))
    if dev.type == "cuda":
        srep["bound_share"] = srep["bound_ms"] / srep["decode_ms_per_step"]
        if n_moe:
            srep["routed_bound_share"] = srep["routed_bound_ms"] / srep[
                "decode_ms_per_step"]
        cache = T.init_cache(cfg, bsz, plen + gen_n, device=dev)
        tok = tokens[:, :1]
        step = lambda: T.decode_step(  # noqa: E731
            cfg, params, cache, T.Batch(tokens=tok), plen)
        timed(srep, "step_device_ms", step, 3, f"{cfg.name} decode step",
              {"::rmsnorm_kernel<": n_norms})
        busy, by_kernel = busy_share(step)
        srep["step_busy_share"] = busy
        srep["step_device_s_by_kernel"] = dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:8])
        del cache
    print(f"{cfg.name} serve batch={bsz} prompt={plen} gen={gen_n}: "
          f"launches {served}, routes equal {srep['routes_agree']}, "
          f"kernels vs plain {srep['vs_plain']}, over all "
          f"{srep['vs_plain_all_tokens']}, {srep['tok_per_s']:.1f} tok/s, "
          f"{srep['decode_ms_per_step']:.2f} ms a step (bound "
          f"{srep['bound_ms']:.3f}, routed {srep.get('routed_bound_ms')})")
    check(within(srep["routes_agree"], srep, limits),
          f"{cfg.name} serve: kernels vs plain {srep}, limits {limits}")
    return srep["launches_per_step"], srep


def phase_moe(dev, smi: str, cfg=None, seq: int = MOE_SEQ,
              serve: tuple = MOE_SERVE) -> tuple:
    """arctic-480b at full width, MOE_LAYERS of its 35 layers, on
    ``dev`` (``cfg``: another MoE config): (a) ``transformer.forward``
    on a ``seq``-token prompt and on a second one (:func:`moe_prompt`:
    counts, transient memory, routes and logits against the plain D and
    E, and the plain path in float32 as a witness); each layer's share
    of picks dropped at capacity; the first prompt's device and wall
    time, busy share and bound.  (b) ``token_serve.generate`` at the reference CLI's defaults
    (``serve``: batch, prompt, generated), counts read around it (2L + 1
    of D a decode step, none of E), again timed; the served tokens
    teacher-forced through both paths (the kernel path reproduces them,
    the plain path stays within (a)'s bounds); one decode step's device
    time, busy share and bounds.  (c) The reduced float32 arctic-480b
    against ``LM_ANCHORS`` (logits, greedy tokens, routes).  Returns the
    forward's and one decode step's launch counts and the ``moe``
    report."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = cfg or moe_config()
    m, cuda = cfg.moe, dev.type == "cuda"
    report: dict = {
        "arch": cfg.name, "layers": cfg.num_layers,
        "of_layers": get_config(cfg.name).num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "capacity_factor": m.capacity_factor,
        "dense_residual": m.dense_residual, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype,
        "note": "depth cut: the host's and the idle shares are larger "
                "than in a deployment of every layer"}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        report["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        t0 = time.perf_counter()
        params = T.init_params(cfg, gen, dev)
        sync(dev)
        report["init_s"] = time.perf_counter() - t0
        report["params"] = T.param_count(params)
        report["param_gb"] = T.param_bytes(params) / 1e9
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                               device=dev)
        batch = T.Batch(tokens=tokens)
        fwd = lambda: T.forward(cfg, params, batch)  # noqa: E731

        # (a) the prompt forward, on a second prompt again, each against
        # the plain path and the plain path in float32
        params32 = float32_copy(params)
        second = torch.randint(
            0, cfg.vocab_size, (1, seq), device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                MOE_SECOND_PROMPT_SEED))
        k_routes, rep = moe_prompt(cfg, params, params32, tokens)
        _, rep["second_prompt"] = moe_prompt(cfg, params, params32, second)
        rep["second_prompt"]["seed"] = MOE_SECOND_PROMPT_SEED
        launches = rep["launches"]
        del params32, second
        kept, used = routed_work(k_routes)
        rep.update(kept_picks=kept, experts_used=used,
                   bound=lm_bounds(cfg, params, seq, kept, used))
        if cuda:
            rep["wall_ms"] = host_ms(fwd, 2)
            timed(rep, "device_ms", fwd, 2, "moe forward",
                  {"::rmsnorm_kernel<": launches["D"],
                   "::flash_fwd_kernel<": launches["E"]})
            rep["bound_share"] = rep["bound"]["bound_ms"] / rep["device_ms"]
            busy, by_kernel = busy_share(fwd)
            rep["busy_share"] = busy
            rep["device_s_by_kernel"] = dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8])
        report["forward"] = rep
        del batch, tokens

        # (b) serving at the reference CLI's defaults
        bsz, plen, gen_n = serve
        prompts = torch.randint(0, cfg.vocab_size, (bsz, plen),
                                generator=gen, device=dev)
        per_step, report["serve"] = serve_vs_plain(cfg, params, prompts,
                                                   gen_n)
        del params, prompts
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()

    # (c) the reduced float32 arctic-480b against the JAX anchors
    report["anchors"] = phase_anchor(MOE_ARCH, dev)
    report["wall_s"] = time.perf_counter() - t_phase
    report["card"] = smi
    print(f"moe phase: {report['wall_s']:.1f} s; card {smi}")
    return launches, per_step, report


# ---------------------------------------------------------------------------
# MLA serving (the eleventh path)
# ---------------------------------------------------------------------------

#: deepseek-v2-236b at full width (d 5120, 128 heads, q LoRA 1536, kv LoRA
#: 512, q·k 128 + 64, v 128, 160 experts top-6 of d_ff 1536 at capacity
#: factor 1.25 beside 2 shared experts, the first layer dense, vocab
#: 102,400, bf16) cut to MLA_LAYERS of its 60 layers: an MoE layer is 7.95
#: GB of weights, so the dense prologue and six MoE layers (50.1 GB) and
#: the float32 witness's ~9.5 GB fill one card.  One MLA_SEQ-token prompt
#: (the reference's prefill_32k cut, as arctic's); serving at the
#: reference CLI's defaults (MOE_SERVE, naive decode, the reference's
#: default); the absorbed step against the naive one at an MLA_CTX-token
#: cache.
MLA_ARCH, MLA_LAYERS, MLA_SEQ, MLA_CTX = "deepseek-v2-236b", 7, 4096, 4096
#: Kernels vs plain (the forward on two prompts, the served tokens
#: teacher-forced), as arctic's (MOE_LIMITS): each MoE layer's routes, the
#: logits where the routes agree in every layer, the argmaxes there and
#: over all.  With 160 experts top-6 and random weights a bf16 ulp of a
#: norm or attention output flips a router's near tie far more often than
#: in arctic, and a flip in one layer moves the picks of every later one:
#: the routes' agreement falls layer by layer.  Readings on the H100
#: (prompts of seed 0 and 1), kernels vs plain [the float32 witness]:
#: routes 96.2 falling to 76.9 % and 95.6 to 75.2 % a layer [93.0 to
#: 71.0 %, 93.3 to 71.2 %]; logits where routes agree 0.094 and 0.111
#: apart [0.112, 0.140]; argmaxes over all 88.3 and 86.2 % [84.2, 83.8
#: %], where routes agree 96.7 and 95.4 % [96.7, 96.0 %].  The routes
#: and argmax limits lie between the two readings; the logits' 0.125
#: lies between them on the second prompt, and above the witness's 0.112
#: on the first: there the logits alone do not tell a kernel fault from a
#: change of rounding, and the float32 run does.  ``float32``: the same
#: forward in float32 on D's and E's float32 routes against the plain
#: path in float32: routes >= 99.955 %, 6.4e-4 and 4.5e-5 apart where
#: they agree, every argmax equal [the witness: 71.0 %, 0.112, 83.8 %].
MLA_LIMITS = {"routes": 0.73, "max_diff": 0.125, "argmax": 0.85,
              "float32": {"routes": 0.99, "max_diff": 0.01, "argmax": 0.98}}
#: The absorbed step against the naive one at MLA_CTX.  In float32 the
#: same function: within 1e-4 of the largest logit (the reference test's
#: 1e-4; read 2.6e-5 of 4.72).  In bf16 the two round apart (the
#: absorbed step casts its latent context to bf16 before w_uv, the naive
#: one keeps p@v in float32) and a router's near tie can flip: their
#: logits no farther apart than MLA_ABSORB_WITNESS_RATIO times the
#: witness measured in the same run, the naive step in float32 against
#: it in bf16 (read 0.109 apart against the witness's 0.116).
MLA_ABSORB_F32_REL = 1e-4
MLA_ABSORB_WITNESS_RATIO = 1.25
#: Seed of the absorbed step's cache and tokens.
MLA_CACHE_SEED = 2


def mla_config(layers: int = MLA_LAYERS):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MLA_ARCH), num_layers=layers)


def fill_mla_cache(cache: dict, upto: int, seed: int) -> None:
    """Positions 0..``upto``-1 of every MLA layer's cache, in place, in
    the cache's dtype: ``c_kv`` standard normals (unit RMS, as
    ``kv_norm`` leaves it) and ``k_pe`` standard normals (the scale of
    ``x @ w_kr`` for a unit-RMS x and fan-in weights; RoPE keeps it),
    drawn in float32 from a generator seeded ``seed`` + the layer."""
    import torch

    for i, c in enumerate(cache["layers"]):
        gen = torch.Generator(device=c.c_kv.device).manual_seed(seed + i)
        for t in (c.c_kv, c.k_pe):
            t[:, :upto] = torch.randn(t[:, :upto].shape, generator=gen,
                                      device=t.device).to(t.dtype)


def absorbed_vs_naive(cfg, params, params32, ctx: int, bsz: int) -> dict:
    """One decode step of ``bsz`` tokens at position ``ctx`` - 1 of a
    ``ctx``-token cache (its other positions :func:`fill_mla_cache`'s),
    naive and absorbed (``decode_step(mla_absorb=...)``), each on its
    own copy of the cache, counts read around each (the norms' launches
    of D, none of E); their logits against each other in bf16 and, on
    ``params32`` (:func:`float32_experts`), in float32, beside the
    witness (the naive step in float32 against it in bf16), held to
    MLA_ABSORB_F32_REL and MLA_ABSORB_WITNESS_RATIO; each step's device
    time and bound on the card."""
    import torch

    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(MLA_CACHE_SEED)
    tok = torch.randint(0, cfg.vocab_size, (bsz, 1), generator=gen,
                        device=dev)
    pos = ctx - 1
    n_norms = lm_launches(cfg, params)["D"]
    base = T.init_cache(cfg, bsz, ctx, device=dev)
    fill_mla_cache(base, pos, MLA_CACHE_SEED)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def copy(cache, dtype=None):
        return {"layers": [type(c)(*(t.to(dtype or t.dtype, copy=True)
                                      for t in c))
                           for c in cache["layers"]]}

    rep: dict = {"batch": bsz, "ctx": ctx}
    logits, wide, steps = {}, {}, {}
    for absorb in (False, True):
        name = "absorbed" if absorb else "naive"
        cache = copy(base)
        steps[name] = (lambda c=cache, a=absorb: T.decode_step(
            cfg, params, c, T.Batch(tokens=tok), pos, mla_absorb=a)[0])
        sync(dev)
        reset_counts()
        with A.record_routes() as routes:
            logits[name] = steps[name]()
        sync(dev)
        launches = read_counts()
        check(launches == {"A": 0, "B": 0, "C": 0, "D": n_norms, "E": 0},
              f"{cfg.name} {name} step: expected {n_norms} launches of D "
              f"and none of E, got {launches}")
        rep[f"launches_{name}"] = launches
        with float32_experts():
            wide[name] = T.decode_step(cfg32, params32, copy(base,
                                                             torch.float32),
                                       T.Batch(tokens=tok), pos,
                                       mla_absorb=absorb)[0]
        every = sum(T.layer_moe_flags(cfg)) * cfg.moe.num_experts
        rep[f"{name}_bound"] = lm_bounds(cfg, params, bsz,
                                         static_slots(routes, cfg.moe),
                                         every, ctx=ctx, absorb=absorb)
    rep["absorbed_vs_naive"] = compare_logits(logits["absorbed"],
                                              logits["naive"])
    rep["float32"] = compare_logits(wide["absorbed"], wide["naive"])
    rep["float32_witness"] = compare_logits(wide["naive"], logits["naive"])
    del wide, logits
    if dev.type == "cuda":
        for name, step in steps.items():
            timed(rep, f"{name}_ms", step, 3, f"{cfg.name} {name} step",
                  {"::rmsnorm_kernel<": n_norms})
            rep[f"{name}_bound_share"] = rep[f"{name}_bound"]["bound_ms"] \
                / rep[f"{name}_ms"]
    print(f"{cfg.name} decode step at position {pos}, batch {bsz}: "
          f"absorbed vs naive {rep['absorbed_vs_naive']}, in float32 "
          f"{rep['float32']}; float32 naive vs bf16 naive (witness) "
          f"{rep['float32_witness']}; naive {rep.get('naive_ms')} ms, "
          f"absorbed {rep.get('absorbed_ms')} ms")
    f32 = rep["float32"]
    check(f32["max_abs_diff"] <= MLA_ABSORB_F32_REL * f32["max_abs"],
          f"{cfg.name}: absorbed and naive steps in float32 differ by "
          f"{f32['max_abs_diff']!r}")
    limit = MLA_ABSORB_WITNESS_RATIO \
        * rep["float32_witness"]["max_abs_diff"]
    check(rep["absorbed_vs_naive"]["max_abs_diff"] <= limit,
          f"{cfg.name}: absorbed and naive steps in bf16 differ by "
          f"{rep['absorbed_vs_naive']}, limit {limit!r} (the witness "
          f"{rep['float32_witness']})")
    return rep


def phase_mla(dev, smi: str, cfg=None, seq: int = MLA_SEQ,
              serve: tuple = MOE_SERVE, ctx: int = MLA_CTX) -> tuple:
    """deepseek-v2-236b at full width, MLA_LAYERS of its 60 layers, on
    ``dev`` (``cfg``: another MLA config): (a) ``transformer.forward`` on
    a ``seq``-token prompt and on a second one (:func:`moe_prompt`:
    counts, transient memory, routes and logits against the plain D and
    E, beside the plain path in float32), each MoE layer's share of picks
    dropped; the first prompt's device and wall time, busy share and
    bounds (the MoE buffer's every slot, and the routed picks).  (b)
    :func:`absorbed_vs_naive` at a ``ctx``-token cache.  (c)
    ``token_serve.generate`` at ``serve`` (batch, prompt, generated),
    naive decode (:func:`serve_vs_plain`).  (d) The reduced float32
    deepseek-v2 against ``LM_ANCHORS``.  Returns the forward's and one
    decode step's launch counts and the ``mla`` report."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = cfg or mla_config()
    m, cuda = cfg.moe, dev.type == "cuda"
    full = get_config(cfg.name)
    report: dict = {
        "arch": cfg.name, "layers": cfg.num_layers,
        "of_layers": full.num_layers, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "q_lora_rank": cfg.q_lora_rank,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_dims": [cfg.qk_nope_dim, cfg.qk_rope_dim],
        "v_head_dim": cfg.v_head_dim, "experts": m.num_experts,
        "top_k": m.top_k, "d_ff_expert": m.d_ff_expert,
        "shared_experts": m.num_shared_experts,
        "capacity_factor": m.capacity_factor,
        "first_k_dense": cfg.first_k_dense, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype}
    if cfg.num_layers < full.num_layers:
        report["note"] = ("depth cut: the host's and the idle shares are "
                          "larger than in a deployment of every layer")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        report["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        t0 = time.perf_counter()
        params = T.init_params(cfg, gen, dev)
        sync(dev)
        report["init_s"] = time.perf_counter() - t0
        report["params"] = T.param_count(params)
        report["param_gb"] = T.param_bytes(params) / 1e9
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                               device=dev)
        batch = T.Batch(tokens=tokens)
        fwd = lambda: T.forward(cfg, params, batch)  # noqa: E731

        # (a) the prompt forward, on a second prompt again, each against
        # the plain path and the plain path in float32
        params32 = float32_copy(params)
        second = torch.randint(
            0, cfg.vocab_size, (1, seq), device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                MOE_SECOND_PROMPT_SEED))
        k_routes, rep = moe_prompt(cfg, params, params32, tokens, MLA_LIMITS)
        _, rep["second_prompt"] = moe_prompt(cfg, params, params32, second,
                                             MLA_LIMITS)
        rep["second_prompt"]["seed"] = MOE_SECOND_PROMPT_SEED
        launches = rep["launches"]
        kept, used = routed_work(k_routes)
        every = sum(T.layer_moe_flags(cfg)) * m.num_experts
        rep.update(kept_picks=kept, experts_used=used,
                   slots=static_slots(k_routes, m),
                   routed_bound=lm_bounds(cfg, params, seq, kept, used))
        rep["bound"] = lm_bounds(cfg, params, seq, rep["slots"], every)
        del second, k_routes
        if cuda:
            rep["wall_ms"] = host_ms(fwd, 2)
            timed(rep, "device_ms", fwd, 2, "mla forward",
                  {"::rmsnorm_kernel<": launches["D"],
                   "::flash_fwd_kernel<": launches["E"]})
            rep["bound_share"] = rep["bound"]["bound_ms"] / rep["device_ms"]
            busy, by_kernel = busy_share(fwd)
            rep["busy_share"] = busy
            rep["device_s_by_kernel"] = dict(sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8])
        report["forward"] = rep
        del batch, tokens

        # (b) the absorbed step against the naive one at a long cache
        report["absorb"] = absorbed_vs_naive(cfg, params, params32, ctx,
                                             serve[0])
        del params32

        # (c) serving at the reference CLI's defaults (naive decode)
        bsz, plen, gen_n = serve
        prompts = torch.randint(0, cfg.vocab_size, (bsz, plen),
                                generator=gen, device=dev)
        per_step, report["serve"] = serve_vs_plain(cfg, params, prompts,
                                                   gen_n, MLA_LIMITS)
        del params, prompts
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()

    # (d) the reduced float32 deepseek-v2 against the JAX anchors
    report["anchors"] = phase_anchor(MLA_ARCH, dev)
    report["wall_s"] = time.perf_counter() - t_phase
    report["card"] = smi
    print(f"mla phase: {report['wall_s']:.1f} s; card {smi}")
    return launches, per_step, report


# ---------------------------------------------------------------------------
# SSM serving (the tenth path)
# ---------------------------------------------------------------------------

#: The SSM path's models: xlstm-350m at full width and depth (24 mLSTM
#: and sLSTM blocks, d 1024, 4 heads, vocab 50,304, tied embeddings) and
#: jamba-v0.1-52b at full width (d 4096, 32/8 heads, Mamba N 16 and
#: d_inner 8192, 16 experts top-2 of d_ff 14,336 on every second layer,
#: vocab 65,536) cut to SSM_JAMBA_LAYERS of its 32 layers (two
#: super-blocks, 52.1 GB): with its float32 witness (the experts stay
#: bf16) the card holds ~70 GB.  jamba's prompt has SSM_SEQ tokens (the
#: reference's prefill_32k cut, as arctic's), xlstm's SSM_XLSTM_SEQ;
#: serving at the reference CLI's defaults (MOE_SERVE), xlstm-350m
#: through ``token_serve.main``.
SSM_XLSTM, SSM_JAMBA = "xlstm-350m", "jamba-v0.1-52b"
SSM_JAMBA_LAYERS, SSM_SEQ = 16, 4096
SSM_SERVE_ARGV = ["--arch", SSM_XLSTM]
#: The generator seed of the forward's prompt (the weights and the served
#: prompts come from seed 0's generator, as ``token_serve.main`` draws
#: them).
SSM_PROMPT_SEED = 1
#: Experts :func:`float32_experts` casts at once for jamba's witness (a
#: float32 expert weight is 235 MB at its width).
SSM_F32_EXPERT_SLICE = 4
#: The xlstm-350m forward's prompt: its sLSTM loops are host-bound
#: (~0.98 M launches a 4096-token forward, 10.9 s on the card), and the
#: phase runs the forward six times (counted, plain, the float32 witness,
#: float32 on the kernels, timed, profiled, the profile's ~4 M records
#: read): 168 s for xlstm alone at 4096 tokens (measured on one H100), over
#: the phase's 150 s.  Cut to 2048.
SSM_XLSTM_SEQ = 2048
#: Kernels vs plain.  In bf16 a flip of one ulp grows through these
#: recurrences with random weights until the logits are unrelated (the
#: mLSTM normalizer divides by a sum of signed terms; in jamba a flipped
#: route reaches every later token through the Mamba state), and the
#: witness, the plain path in float32 against the plain path, diverges
#: from the first tokens.  So the bf16 forward is held over its first
#: ``prefix`` positions (logits within ``max_diff``, argmaxes at least
#: ``argmax``), over all of them by the share of equal argmaxes
#: (``argmax_all``) and by each MoE layer's routes; the same forward in
#: float32 on the kernels' float32 routes against the plain path in
#: float32 is held over every position (``float32``: routes, the logits
#: where they agree, argmaxes there and over all); the served tokens'
#: teacher-forced logits by ``serve``.  Readings measured on one H100,
#: kernels vs plain [witness]: xlstm bf16 at 2048 tokens,
#: positions 0-15 0.0 apart, 100 % of the argmaxes [4.57, 19 %], over
#: all 16.9 % [2.3 %]; float32 0.478 apart, 98.5 % [6.81, 2.3 %]; served
#: 0.146, 100 %.  jamba bf16 routes 99.9 % falling to 88.9 % a layer
#: [98.2 % to 67.8 %], positions 0-15 0.29 apart, 100 % [2.44, 62 %],
#: over all 83.7 % [55.2 %]; float32 routes >= 99.98 % [67.8 %], 0.106
#: apart where they agree [1.79], argmaxes 99.95 % [55.2 %]; served:
#: routes 100 % falling to 92.6 %, 0.031 apart where they agree, 84.4 %
#: of the argmaxes.  Each limit lies between the two readings.
SSM_LIMITS = {
    SSM_XLSTM: {"routes": 1.0, "prefix": 16, "max_diff": 0.5,
                "argmax": 0.98, "argmax_all": 0.05,
                "float32": {"routes": 1.0, "max_diff": 2.0, "argmax": 0.95},
                "serve": {"routes": 1.0, "max_diff": LM_BF16_MAX_DIFF,
                          "argmax": 0.98}},
    SSM_JAMBA: {"routes": 0.8, "prefix": 16, "max_diff": 0.5,
                "argmax": 0.98, "argmax_all": 0.7,
                "float32": {"routes": 0.99, "max_diff": 0.5,
                            "argmax": 0.98},
                "serve": {"routes": 0.85, "max_diff": LM_BF16_MAX_DIFF,
                          "argmax": 0.8}},
}
#: Prefix of the profiler's ranges around the SSM scans.
SCAN_TAG = "ssm_scan:"
#: The scans :func:`scan_ranges` wraps: Mamba's selective scan, the
#: sLSTM recurrence and the mLSTM parallel form.
SCANS = ("_mamba_scan", "_slstm_scan", "mlstm_parallel")


def ssm_jamba_config(layers: int = SSM_JAMBA_LAYERS):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SSM_JAMBA), num_layers=layers)


@contextlib.contextmanager
def scan_ranges():
    """Inside the ``with``, each call of the SSM module's scans (SCANS)
    runs inside a ``torch.profiler.record_function`` range named
    SCAN_TAG + its name, so a trace can tell the kernels it launches."""
    from torch.profiler import record_function

    from repro_torch.models import ssm

    saved = {name: getattr(ssm, name) for name in SCANS}

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(SCAN_TAG + name):
                return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(ssm, name, ranged(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def device_split(run) -> dict:
    """One ``run()`` under torch.profiler (CPU and CUDA activity) with
    :func:`scan_ranges`, read by :func:`split_trace` from the trace's raw
    records (a forward of a million kernels: no FunctionEvent is
    built), with the run's wall seconds and the read's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, scan_ranges():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = split_trace(prof.profiler.kineto_results.events())
    out.update(profiled_wall_s=wall, parse_s=time.perf_counter() - t0)
    return out


def split_trace(events) -> dict:
    """The summed device time of a trace's kernels (and copies and
    fills; not the device's mirror of the scan or step ranges), of those
    launched inside each :func:`scan_ranges` range (a kernel counts where
    the CUDA runtime or driver call that launched it, matched by
    correlation id, starts inside a range), the top kernels, and the
    share of kernels matched to a launch.  ``events``: the profiler's raw
    records (``_KinetoEvent``s), read by name, device, correlation id
    and times only (the methods every torch 2.x has)."""
    import bisect

    from torch.autograd import DeviceType

    ranges, launch, kernels = [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SCAN_TAG):
                ranges.append((ev.start_ns(),
                               ev.start_ns() + ev.duration_ns(),
                               name[len(SCAN_TAG):]))
            elif name.startswith(("cuda", "cu")):   # runtime, driver calls
                launch[ev.correlation_id()] = ev.start_ns()
        elif ev.device_type() == DeviceType.CUDA \
                and not name.startswith((SCAN_TAG, "ProfilerStep")):
            kernels.append((ev.correlation_id(), ev.duration_ns(), name))
    check(kernels, "profiler trace holds no device events")
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_scan, by_kernel, matched, total = {}, {}, 0, 0
    for corr, dur, name in kernels:
        total += dur
        by_kernel[name] = by_kernel.get(name, 0) + dur
        t = launch.get(corr)
        if t is None:
            continue
        matched += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            by_scan[ranges[i][2]] = by_scan.get(ranges[i][2], 0) + dur
    return {"device_s": total / 1e9, "kernels": len(kernels),
            "launches_matched": matched / len(kernels),
            "scan_device_s": {k: v / 1e9 for k, v in by_scan.items()},
            "scan_calls": {n: sum(r[2] == n for r in ranges) for n in SCANS},
            "device_s_by_kernel": {k: v / 1e9 for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:8]}}


def forward_timing(run, rep: dict) -> None:
    """``rep`` gains ``wall_ms`` (one unprofiled ``run()``, synchronised),
    ``span_ms`` (CUDA events around it: the device's first kernel to its
    last, idle gaps included) and, from one profiled run
    (:func:`device_split`), ``device_ms`` (its kernels' summed time),
    ``busy_share`` (device_ms over wall_ms), each scan's share of
    device_ms (``scan_share``) and the trace's readings (``profile``).
    A forward queues more kernels than the launch queue holds, so
    :func:`device_ms`'s held events do not apply."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    run()
    ev[1].record()
    torch.cuda.synchronize()
    rep["wall_ms"] = (time.perf_counter() - t0) * 1e3
    rep["span_ms"] = ev[0].elapsed_time(ev[1])
    split = device_split(run)
    rep["device_ms"] = split["device_s"] * 1e3
    rep["device_ms_method"] = "trace_sum"
    rep["busy_share"] = rep["device_ms"] / rep["wall_ms"]
    rep["scan_share"] = {k: v / split["device_s"]
                         for k, v in split["scan_device_s"].items()}
    rep["profile"] = split


def static_slots(routes: list, m) -> int:
    """Slots of the MoE buffers of ``routes`` (one call a layer): G
    groups x the capacity of a group x the experts, summed; the expert
    products run on every slot, kept or not."""
    from repro_torch.models.moe import _capacity

    return sum(r.top_e.shape[0] * _capacity(r.top_e.shape[1], m)
               * m.num_experts for r in routes)


def ssm_model(cfg, dev, seq: int, serve: tuple, argv: list | None,
              limits: dict, f32_slice: int) -> tuple:
    """One SSM model of phase 9e at ``cfg`` on ``dev``: weights and the
    served prompts from seed 0's generator (as ``token_serve.main``
    draws them), the ``seq``-token prompt from SSM_PROMPT_SEED's.  (a)
    :func:`moe_prompt` (counts: :func:`lm_launches`; against the plain
    D and E and beside the float32 witness, held to ``limits``), the
    bounds (with MoE: the static buffer's and the routed one), and on the
    card :func:`forward_timing`.  (b) :func:`serve_vs_plain` at
    ``serve`` (batch, prompt, generated), through ``token_serve.main(
    argv)`` where given.  Returns the forward's and a decode step's
    launch counts and the model's report."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cuda = dev.type == "cuda"
    full = get_config(cfg.name)
    report: dict = {
        "arch": cfg.name, "layers": cfg.num_layers,
        "of_layers": full.num_layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.num_kv_heads],
        "block_pattern": list(cfg.block_pattern), "vocab": cfg.vocab_size,
        "dtype": cfg.dtype}
    if cfg.moe:
        report.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                      d_ff_expert=cfg.moe.d_ff_expert)
    if cfg.num_layers < full.num_layers:
        report["note"] = ("depth cut: the host's and the idle shares are "
                          "larger than in a deployment of every layer")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        report["mem_before_gb"] = torch.cuda.memory_allocated() / 1e9
    bsz, plen, gen_n = serve
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        t0 = time.perf_counter()
        params = T.init_params(cfg, gen, dev)
        sync(dev)
        report["init_s"] = time.perf_counter() - t0
        report["params"] = T.param_count(params)
        report["param_gb"] = T.param_bytes(params) / 1e9
        prompts = torch.randint(0, cfg.vocab_size, (bsz, plen),
                                generator=gen, device=dev)
        tokens = torch.randint(
            0, cfg.vocab_size, (1, seq), device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                SSM_PROMPT_SEED))

        # (a) the prompt forward against the plain path and beside the
        # plain path in float32
        params32 = float32_copy(params)
        k_routes, rep = moe_prompt(cfg, params, params32, tokens, limits,
                                   f32_slice)
        del params32
        if cfg.moe:
            kept, used = routed_work(k_routes)
            every = sum(T.layer_moe_flags(cfg)) * cfg.moe.num_experts
            rep.update(kept_picks=kept, experts_used=used,
                       slots=static_slots(k_routes, cfg.moe),
                       routed_bound=lm_bounds(cfg, params, seq, kept, used))
            rep["bound"] = lm_bounds(cfg, params, seq, rep["slots"], every)
        else:
            rep["bound"] = lm_bounds(cfg, params, seq)
        if cuda:
            batch = T.Batch(tokens=tokens)
            forward_timing(lambda: T.forward(cfg, params, batch), rep)
            rep["bound_share"] = rep["bound"]["bound_ms"] / rep["device_ms"]
        report["forward"] = rep
        del tokens

        # (b) serving at the reference CLI's defaults
        per_step, report["serve"] = serve_vs_plain(
            cfg, params, prompts, gen_n, limits["serve"], argv)
        del params, prompts
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    return rep["launches"], per_step, report


def phase_ssm(dev, smi: str, xlstm=None, jamba=None,
              seqs: tuple = (SSM_XLSTM_SEQ, SSM_SEQ),
              serve: tuple = MOE_SERVE,
              argv: list = SSM_SERVE_ARGV) -> tuple:
    """The SSM path: xlstm-350m at full width and depth and jamba at
    full width, SSM_JAMBA_LAYERS of its 32 layers (``xlstm``, ``jamba``:
    other configs of the two; ``seqs``: their prompts' lengths), each
    through :func:`ssm_model` (xlstm served by ``token_serve.main(
    argv)``, jamba by ``token_serve.generate``); then the reduced
    float32 models against ``LM_ANCHORS``.  Returns each model's
    forward and decode-step launch counts and the ``ssm`` report."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    launches, report = {}, {}
    for cfg, seq, run_argv, f32_slice in (
            (xlstm or get_config(SSM_XLSTM), seqs[0], argv,
             F32_EXPERT_SLICE),
            (jamba or ssm_jamba_config(), seqs[1], None,
             SSM_F32_EXPERT_SLICE)):
        t0 = time.perf_counter()
        fwd, step, report[cfg.name] = ssm_model(
            cfg, dev, seq, serve, run_argv, SSM_LIMITS[cfg.name], f32_slice)
        report[cfg.name]["wall_s"] = time.perf_counter() - t0
        launches[cfg.name] = {"forward": fwd, "decode_step": step}
    report["anchors"] = {arch: phase_anchor(arch, dev)
                         for arch in (SSM_XLSTM, SSM_JAMBA)}
    report["wall_s"] = time.perf_counter() - t_phase
    report["card"] = smi
    print(f"ssm phase: {report['wall_s']:.1f} s; card {smi}")
    return launches, report


# ---------------------------------------------------------------------------
# LM training (the eighth path)
# ---------------------------------------------------------------------------

#: The training path: ``train.main`` at the reference CLI's defaults
#: (qwen2-0.5b at full width, bf16, 128 tokens, global batch 8, 100
#: steps, lr 3e-4, warmup 20, no remat).
TRAIN_ARGV = ["--arch", "qwen2-0.5b"]
#: Steps timed one by one after the counted step (the median is read).
TRAIN_TIMED_STEPS = 20
#: One step through kernels D and E against the same step on their
#: plain versions (autograd through rmsnorm_ref and flash_attention_ref),
#: bf16 at full width: bf16 roundings of one ulp in norms and attention
#: move through 24 layers and their backward.  The loss within 1e-2
#: absolute, each gradient leaf's cosine at least 0.99, the global
#: gradient norm within 1 % (the readings are reported beside them).
TRAIN_LOSS_ATOL, TRAIN_LEAF_COS, TRAIN_GNORM_RTOL = 1e-2, 0.99, 1e-2
#: The reduced float32 models against ``TRAIN_ANCHORS``, the CPU tests'
#: tolerances (tests/test_torch_train.py): the first loss as ANCHOR_TOL,
#: the first step's leaf gradient norms within 1e-5 relative, then over
#: five AdamW steps at lr 1e-2 losses within 1e-4 and global gradient
#: norms within 1e-3 relative (the runs drift apart by the ulps an update
#: divides by sqrt(v)).
TRAIN_LEAF_RTOL, TRAJ_LOSS_RTOL, TRAJ_GNORM_RTOL = 1e-5, 1e-4, 1e-3
#: The resume run: steps, and the checkpoint it resumes from.
RESUME_STEPS, RESUME_AT = 6, 3


def train_launches(cfg) -> dict:
    """Kernel launches of one training step of a dense ``cfg`` (no
    remat): kernel D at every norm of the forward (two a layer, four
    with post-block norms, and the final one), kernel E at every layer's
    attention; the backward launches neither."""
    norms = (4 if cfg.post_block_norm else 2) * cfg.num_layers + 1
    return {"D": norms, "E": cfg.num_layers}


def train_step_flops(cfg, batch: int, seq: int) -> dict:
    """Matmul operations of one training step: 6 a weight a token
    (forward 2, backward 4) for every matmul weight (the q, k, v and o
    projections, the FFN's, the unembedding, tied or not), plus
    attention's q·k and p@v over the visible (query, key) pairs, 2·Dh
    operations each a pair and head, three times over (the forward's
    two products, the backward's four).  Norm scales, biases and the
    embedding gather are no matmuls."""
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    ffn = (3 if cfg.ffn_kind == "swiglu" else 2) * d * cfg.d_ff
    weights = (cfg.num_layers * (2 * d * h * hd + 2 * d * kvh * hd + ffn)
               + cfg.vocab_size * d)
    tokens = batch * seq
    attn = 0
    for i in range(cfg.num_layers):
        window = cfg.sliding_window if cfg.layer_kind(i) == "attn_local" \
            else 0
        attn += 3 * 2 * (2 * hd * h) * batch * visible_pairs(seq, seq, True,
                                                              window)
    ops = 6 * weights * tokens + attn
    return {"weights": weights, "tokens": tokens, "ops": ops,
            "bound_ms": ops / PEAK_BF16_OPS_PER_S * 1e3}


def leaf_paths(tree) -> dict:
    """``{path: tensor}`` of a parameter tree (the checkpoint's paths)."""
    from repro_torch.checkpoint.manager import _flatten

    return dict(_flatten(tree))


def compare_grads(loss_a, grads_a, loss_b, grads_b) -> dict:
    """Loss difference, the smallest cosine over the gradient leaves (and
    its leaf), the global norms' relative difference."""
    import torch

    a, b = leaf_paths(grads_a), leaf_paths(grads_b)
    check(sorted(a) == sorted(b), "gradient trees differ")
    cos = {}
    for k in a:
        x, y = a[k].double().flatten(), b[k].double().flatten()
        cos[k] = float(torch.dot(x, y) / (x.norm() * y.norm()).clamp_min(
            1e-300))
    na = float(torch.sqrt(sum(t.double().square().sum() for t in a.values())))
    nb = float(torch.sqrt(sum(t.double().square().sum() for t in b.values())))
    worst = min(cos, key=cos.get)
    return {"loss_diff": abs(float(loss_a) - float(loss_b)),
            "min_leaf_cos": cos[worst], "min_cos_leaf": worst,
            "grad_norm": na, "grad_norm_plain": nb,
            "grad_norm_rel_diff": abs(na - nb) / nb}


def phase_train_anchor(arch: str, dev) -> dict:
    """The reduced float32 ``arch`` trained on ``dev`` against
    ``TRAIN_ANCHORS``, frozen from the JAX reference."""
    import torch

    from repro_torch.models import anchors as A

    got, want = A.train_run(arch, dev), A.TRAIN_ANCHORS[arch]
    del got["params"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    g0, w0 = got["losses"][0], want["losses"][0]
    check(abs(g0 - w0) <= ANCHOR_TOL["atol"] + ANCHOR_TOL["rtol"] * abs(w0),
          f"{arch}: first loss {g0!r} vs the JAX anchor {w0!r}")
    rel = {}
    for key, tol in (("losses", TRAJ_LOSS_RTOL),
                     ("grad_norms", TRAJ_GNORM_RTOL)):
        rel[key] = max(abs(g - w) / abs(w)
                       for g, w in zip(got[key], want[key]))
        check(len(got[key]) == len(want[key]) and rel[key] <= tol,
              f"{arch}: {key} {got[key]} vs the JAX anchors {want[key]}")
    check(sorted(got["leaf_grad_norms"]) == sorted(want["leaf_grad_norms"]),
          f"{arch}: gradient leaves differ from the anchors'")
    leaf = {k: abs(got["leaf_grad_norms"][k] - w) / max(w, 1e-30)
            for k, w in want["leaf_grad_norms"].items()}
    rel["leaf_grad_norms"] = max(leaf.values())
    check(rel["leaf_grad_norms"] <= TRAIN_LEAF_RTOL,
          f"{arch}: leaf gradient norm {max(leaf, key=leaf.get)} off by "
          f"{rel['leaf_grad_norms']!r}")
    print(f"train anchors {arch} (reduced, float32) on {dev}: losses "
          f"{got['losses']}, largest relative errors {rel}")
    return {"losses": got["losses"], "max_rel_err": rel}


def resume_check(argv: list, dev, root: pathlib.Path) -> dict:
    """``train.main`` for RESUME_STEPS steps with a checkpoint every
    RESUME_AT (``root/whole``), then again from that run's step-RESUME_AT
    checkpoint (``root/part``): the resumed losses and the final
    checkpoint (parameters and AdamW state) against the uninterrupted
    run's, bitwise.  The directories are removed afterwards."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    shutil.rmtree(root, ignore_errors=True)
    whole, part = root / "whole", root / "part"
    args = argv + ["--device", str(dev), "--steps", str(RESUME_STEPS),
                   "--ckpt-every", str(RESUME_AT)]
    try:
        t0 = time.perf_counter()
        a = train.main(args + ["--ckpt-dir", str(whole)])
        part.mkdir(parents=True)
        shutil.copytree(whole / f"step_{RESUME_AT:09d}",
                        part / f"step_{RESUME_AT:09d}")
        b = train.main(args + ["--ckpt-dir", str(part), "--resume"])
        wall = time.perf_counter() - t0
        check(b["steps"] == RESUME_STEPS - RESUME_AT,
              f"resume ran {b['steps']} steps")
        got = CheckpointManager(str(part)).restore_items(RESUME_STEPS)
        want = CheckpointManager(str(whole)).restore_items(RESUME_STEPS)
        check(list(got) == list(want), "resumed checkpoint's leaves differ")
        differing = [k for k in want if got[k].dtype != want[k].dtype
                     or leaf_bytes(got[k]) != leaf_bytes(want[k])]
        loss_gap = max(abs(x - y) for x, y in zip(b["losses"],
                                                  a["losses"][RESUME_AT:]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"steps": RESUME_STEPS, "resumed_at": RESUME_AT,
           "losses": a["losses"], "resumed_losses": b["losses"],
           "loss_gap": loss_gap, "leaves": len(want),
           "leaves_differing": differing[:8], "wall_s": wall}
    check(loss_gap == 0 and not differing,
          f"resume is not bitwise the uninterrupted run: {out}")
    return out


def leaf_bytes(a) -> bytes:
    """The raw bytes of a restored leaf (bf16 comes back as a tensor)."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def phase_train(dev, smi: str, argv: list = TRAIN_ARGV,
                work: pathlib.Path = ROOT / "build" / "train_resume"
                ) -> tuple:
    """LM training on ``dev``: (a) ``train.main(argv)`` (the reference
    CLI's defaults: qwen2-0.5b at full width), its launch counts read
    around it (D and E ``train_launches`` a step, A-C none) and its loss
    decreasing, then one step counted alone and TRAIN_TIMED_STEPS timed;
    (b) one step through kernels D and E against the same step on their
    plain versions; (c) the reduced float32 qwen2-0.5b and gemma2-2b
    against ``TRAIN_ANCHORS``; (d) a checkpointed run resumed bitwise
    (its checkpoints under ``work``).  Returns main's and one step's
    launch counts and the ``train`` report."""
    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    args = train.build_argparser().parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    per_step = train_launches(cfg)
    flops = train_step_flops(cfg, args.global_batch, args.seq_len)
    report: dict = {"arch": cfg.name, "layers": cfg.num_layers,
                    "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                    "dtype": cfg.dtype, "global_batch": args.global_batch,
                    "seq": args.seq_len, "steps": args.steps,
                    "remat": args.remat, "matmul_bound": flops}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # (a) the training CLI at its defaults
    sync(dev)
    reset_counts()
    res = train.main(argv + ["--device", str(dev)])
    sync(dev)
    launches = read_counts()
    want = {"A": 0, "B": 0, "C": 0, "D": per_step["D"] * res["steps"],
            "E": per_step["E"] * res["steps"]}
    check(launches == want, f"train.main: expected launches {want}, got "
          f"{launches}")
    check(res["steps"] == args.steps and res["loss_decreased"]
          and all(np.isfinite(res["losses"])),
          f"train.main: {res['steps']} steps, loss {res['first_loss']} -> "
          f"{res['last_loss']}")
    report["main"] = {k: res[k] for k in ("first_loss", "last_loss",
                                          "loss_decreased", "steps",
                                          "mean_step_s", "wall_s")}
    report["main"]["launches"] = launches
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    params = S.trainable(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)
    opt = adamw.init(opt_cfg, params)
    ds = SyntheticLM(cfg, DataConfig(seq_len=args.seq_len,
                                     global_batch=args.global_batch,
                                     seed=args.seed))
    step = S.make_train_step(cfg, opt_cfg, remat=args.remat)
    batch = train.device_batch(ds.batch_at(0), dev)

    # (b) one step's gradients through the kernels and on the plain path
    loss_k, g_k = S.value_and_grad(cfg, params, batch, args.remat)
    with plain_kernels():
        loss_p, g_p = S.value_and_grad(cfg, params, batch, args.remat)
    vs = compare_grads(loss_k, g_k, loss_p, g_p)
    del g_k, g_p
    check(vs["loss_diff"] <= TRAIN_LOSS_ATOL
          and vs["min_leaf_cos"] >= TRAIN_LEAF_COS
          and vs["grad_norm_rel_diff"] <= TRAIN_GNORM_RTOL,
          f"train step: kernels vs plain {vs}")
    report["vs_plain"] = vs
    print(f"train step {cfg.name}: kernels vs plain {vs}")

    # one step counted alone, then steps timed one by one
    sync(dev)
    reset_counts()
    params, opt, met = step(params, opt, batch)
    float(met["loss"])
    one = read_counts()
    check(one == dict(want, D=per_step["D"], E=per_step["E"]),
          f"one train step: expected {per_step} launches of D and E, got "
          f"{one}")
    times = []
    for i in range(1, TRAIN_TIMED_STEPS + 1):
        batch = train.device_batch(ds.batch_at(i), dev)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        float(met["loss"])                # waits for the step
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times[1:])) * 1e3
    report["step"] = {"launches": one, "timed_steps": len(times),
                      "median_ms_after_first": step_ms,
                      "first_ms": times[0] * 1e3,
                      "tokens_per_s": flops["tokens"] / step_ms * 1e3,
                      "bound_share": flops["bound_ms"] / step_ms}
    if cuda:
        state = {"params": params, "opt": opt, "batch": batch}

        def one_step():
            state["params"], state["opt"], m = step(
                state["params"], state["opt"], state["batch"])
            float(m["loss"])

        busy, by_kernel = busy_share(one_step)
        report["step"]["busy_share"] = busy
        report["step"]["device_s_by_kernel"] = dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:10])
        del state
    del params, opt, batch
    if cuda:
        torch.cuda.empty_cache()

    # (c) the reduced float32 models against the JAX anchors
    report["anchors"] = {arch: phase_train_anchor(arch, dev)
                         for arch in ("qwen2-0.5b", "gemma2-2b")}
    # (d) a checkpointed run, resumed
    report["resume"] = resume_check(argv, dev, work)
    report["card"] = smi
    print(f"train {cfg.name}: step {step_ms:.3f} ms (median), "
          f"{report['step']['tokens_per_s']:.0f} tokens/s, "
          f"{report['step']['bound_share']:.3f} of the matmul bound "
          f"{flops['bound_ms']:.3f} ms; loss {res['first_loss']:.4f} -> "
          f"{res['last_loss']:.4f}; card {smi}")
    return launches, one, report


def busy_share(run) -> tuple:
    """The device's busy share of one profiled ``run()``: its device time
    over its own wall time, taken inside the trace (the profiler's host
    overhead is in that wall time, so this is a lower bound), and the
    device time by kernel."""
    import torch

    wall = []

    def timed():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    by_kernel = device_busy(timed)
    return sum(by_kernel.values()) / wall[0], by_kernel


def lm_kernel_report(err: dict, dev) -> tuple:
    """Rows D and E of the ``kernels`` line at the LM forward's shapes
    (D: one norm of gemma2-2b's 8192-token prompt; E: one local and one
    global layer's attention, summed), each with a ``kernel`` key that
    the forward's launch count replaces, and each case's timing."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as E
    from repro_torch.kernels import rmsnorm as D

    from repro_torch.kernels.flash_attention.kernel import LIBRARY

    usage = ptxas_usage(LIBRARY.info.get("ptxas", ""))
    norm_rows = []
    for i, (rows, d, dtype, what) in enumerate(RMSNORM_CASES):
        x, scale = rmsnorm_inputs(rows, d, dtype, 40 + i, dev, what)
        w = (1.0 + scale).to(x.dtype)
        nbytes = 2 * x.numel() * x.element_size() + 4 * d
        route = D.plan(rows, d, x.element_size(), x.data_ptr(),
                       scale.data_ptr(), 0).route
        row = {"rows": rows, "d": d, "dtype": dtype, "what": what,
               "route": route, "bytes": nbytes,
               "wall_ms": host_ms(lambda: D.rmsnorm_fused(x, scale), 50),
               "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        timed(row, "ms", lambda: D.rmsnorm_fused(x, scale), 50,
              f"kernel D {what}")
        timed(row, "plain_ms", lambda: D.rmsnorm_ref(x, scale), 20,
              f"kernel D {what}, plain")
        # one PyTorch call: F.rms_norm, weight 1 + scale in x's dtype
        timed(row, "library_ms", lambda: F.rms_norm(x, (d,), w, 1e-6), 50,
              "F.rms_norm")
        row["vs_library"] = row["ms"] / row["library_ms"]
        # the same bytes moved by a plain device copy (x read once, a row's
        # width written once): what the byte bound is in practice
        y = torch.empty_like(x)
        timed(row, "copy_ms", lambda: y.copy_(x), 50, "copy_")
        norm_rows.append(row)
    attn_rows = []
    for i, (name, b, sq, skv, h, kv, dims, causal, window, cap,
            dtype) in enumerate(FLASH_CASES):
        d, dv = head_dims(dims)
        q, k, v = flash_inputs(b, sq, skv, h, kv, d, dtype, 50 + i, dev, dv)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        nbytes, qk_ops, pv_ops = flash_work(b, sq, skv, h, kv, d, causal,
                                            window, q.element_size(), dv)
        bf16 = dtype == "bfloat16"
        b_ms, b_by = flash_bound(nbytes, qk_ops, pv_ops, bf16)
        reps = 3 if sq * skv >= 2**24 else 20
        run = lambda: E.flash_attention_fwd(q, k, v, **kw)  # noqa: E731
        plan = E.plan(b, sq, h, kv, d, q.dtype, dv)
        row = {"name": name, "b": b, "sq": sq, "skv": skv, "h": h, "kv": kv,
               "d": d, "dv": dv, "causal": causal, "window": window,
               "softcap": cap,
               "dtype": dtype, "route": plan.route, "keys": plan.keys,
               "stages": plan.stages, "smem_bytes": plan.smem_bytes,
               "bytes": nbytes, "ops": qk_ops + pv_ops,
               "qk_ops": qk_ops, "pv_ops": pv_ops, "bf16": bf16,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               **flash_kernel_usage(usage, plan.route, d, dv)}
        timed(row, "ms", run, reps, f"kernel E {name}")
        timed(row, "plain_ms", lambda: E.flash_attention_ref(q, k, v, **kw),
              reps, f"kernel E {name}, plain")
        # the function's operations (q.k and p@v once each) a second, and
        # the share of the bound (bf16: p@v as three passes) reached
        row["tflops"] = row["ops"] / row["ms"] / 1e9
        row["bound_share"] = b_ms / row["ms"]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if name.startswith("gemma2"):
            flex_library(row, qt, kt, vt, causal, window, cap, run(), reps)
        elif not cap and not window and (not causal or sq == skv):
            row["library"] = "scaled_dot_product_attention"
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, scale=d ** -0.5,
                enable_gqa=True)
            timed(row, "library_ms", sdpa, reps,
                  "F.scaled_dot_product_attention")
            if d != dv:
                # which of SDPA's backends takes q·k and v apart: the
                # kernels its calls launch, where the trace holds them
                # (some machines' traces lose every record of a short
                # run; the name is a note, not a check)
                try:
                    row["library_kernels"] = sorted(device_busy(
                        lambda: [sdpa() for _ in range(5)]))
                except SmokeFailure as e:
                    row["library_kernels"] = f"not read: {e}"
        attn_rows.append(row)
        del q, k, v, qt, kt, vt

    main_d = norm_rows[0]
    main_e = [r for r in attn_rows if r["name"].startswith("gemma2")]
    e_bound, e_by = flash_bound(sum(r["bytes"] for r in main_e),
                                sum(r["qk_ops"] for r in main_e),
                                sum(r["pv_ops"] for r in main_e), True)
    e_lib = [r["library_ms"] for r in main_e]
    rows = [
        {"name": "rmsnorm_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:20",
         "kernel": "D", "max_abs_err": err["D"],
         "ms": main_d["ms"], "plain_ms": main_d["plain_ms"],
         "bound_ms": main_d["bound_ms"], "bound_by": "bytes",
         "library_ms": main_d["library_ms"],
         **methods([main_d], ("ms", "plain_ms", "library_ms"))},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:35",
         "kernel": "E", "max_abs_err": err["E"],
         "ms": sum(r["ms"] for r in main_e),
         "plain_ms": sum(r["plain_ms"] for r in main_e),
         "bound_ms": e_bound, "bound_by": e_by,
         "library_ms": None if None in e_lib else sum(e_lib),
         **methods(main_e, ("ms", "plain_ms", "library_ms"))}]
    # arctic-480b's shapes (phase 9d): one norm of its 4096-token prompt,
    # one layer's attention
    for row, shape in ((rows[0], [r for r in norm_rows
                                  if r["what"] == "arctic forward"]),
                       (rows[1], [r for r in attn_rows
                                  if r["name"] == "arctic"])):
        row["moe_shape"] = shape_readings(shape[0])
    # the SSM path's shapes (phase 9e): a norm of jamba's and of xlstm's
    # 4096-token prompt; one jamba attention layer
    rows[0]["ssm_shape"] = {
        arch: shape_readings(next(r for r in norm_rows if r["what"] == what))
        for arch, what in (("jamba-v0.1-52b", "jamba forward"),
                           ("xlstm-350m", "xlstm forward"))}
    rows[1]["ssm_shape"] = {"jamba-v0.1-52b": shape_readings(
        next(r for r in attn_rows if r["name"] == "jamba"))}
    # deepseek-v2's shapes (phase 9f): its q_norm and kv_norm on the
    # 4096-token prompt; one MLA layer's attention, q·k 192 and v 128
    rows[0]["mla_shape"] = {
        what: shape_readings(next(r for r in norm_rows if r["what"] == what))
        for what in ("deepseek q_norm", "deepseek kv_norm")}
    mla_row = next(r for r in attn_rows if r["name"] == "deepseek mla")
    rows[1]["mla_shape"] = dict(shape_readings(mla_row),
                                library_kernels=mla_row.get(
                                    "library_kernels"))
    # the modality-stub models' shapes (phase 9g): a norm of each prompt,
    # one attention layer of each
    rows[0]["stub_shape"] = {
        arch: shape_readings(next(r for r in norm_rows if r["what"] == what))
        for arch, what in ((STUB_VL, "qwen2-vl forward"),
                           (STUB_AUDIO, "musicgen forward"))}
    rows[1]["stub_shape"] = {
        arch: shape_readings(next(r for r in attn_rows if r["name"] == name))
        for arch, name in ((STUB_VL, "qwen2-vl"), (STUB_AUDIO, "musicgen"))}
    # kernel E's bf16 route runs on the tensor cores (HMMA) with K/V
    # staged by cp.async (LDGSTS), read by ldmatrix (LDSM)
    sass = sass_opcodes(LIBRARY.path(), ("HMMA", "LDGSTS", "LDSM"))
    check(sass["HMMA"] > 0 and sass["LDGSTS"] > 0,
          f"kernel E's SASS lacks tensor-core or cp.async instructions: "
          f"{sass}")
    return rows, {"rmsnorm_shapes": norm_rows, "flash_shapes": attn_rows,
                  "flash_sass": sass}


def shape_readings(row: dict) -> dict:
    """A kernel case's readings for a main path's row: its time, plain
    time, bound and library time, each with how it was taken."""
    return {k: row[k] for k in (
        "ms", "ms_method", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_ms_method") if k in row}


def flex_library(row, qt, kt, vt, causal, window, cap, out, reps) -> None:
    """``row["library_ms"]``: one call of PyTorch's ``flex_attention``
    computing kernel E's function on (B, H, S, D) inputs: the softcap as
    a score_mod on the scaled score, causal (and the window) as a block
    mask, GQA by ``enable_gqa``.  It is compiled, and the block mask
    made, before the timed calls; its largest difference from kernel E's
    output ``out`` is reported beside it (it rounds p to bf16 before
    p@v, where kernel E keeps p in float32).  A yardstick only: the port
    never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    sq, skv, d = qt.shape[2], kt.shape[2], qt.shape[3]
    off = skv - sq

    def mask_mod(b, h, qi, ki):
        vis = ki <= qi + off if causal else ki >= 0
        return vis & (ki > qi + off - window) if window else vis

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, None, None, sq, skv,
                             device=qt.device)
    flex = torch.compile(flex_attention, dynamic=False)
    call = lambda: flex(qt, kt, vt, score_mod=softcap if cap else None,  # noqa
                        block_mask=mask, scale=d ** -0.5, enable_gqa=True)
    got = call().transpose(1, 2)
    row["library"] = "flex_attention"
    row["library_max_abs_diff"] = (got.float() - out.float()).abs().max() \
        .item()
    check(tuple(got.shape) == tuple(out.shape)
          and bool(got.isfinite().all()), "flex_attention: bad output")
    timed(row, "library_ms", call, reps, "flex_attention")


#: The roofline phase's limit on the counted forward's matmul and
#: attention flops against ``lm_bounds``' bf16 operations (relative).
ROOFLINE_LM_RTOL = 0.05
#: Seconds of the forward loop the card's power is read over, and of the
#: copy and matmul loops that derive the H100 spec's energies; seconds
#: of no work before the idle reading.
POWER_LOOP_S, POWER_PROBE_S, POWER_IDLE_S = 5.0, 2.0, 1.0
#: The matmul loop's shape: gemma2-2b's FFN up projection over the
#: 8192-token prompt, bf16.
POWER_MATMUL = (8192, 2304, 9216)
#: The copy loop's bytes (a device-to-device copy of a bf16 tensor).
POWER_COPY_BYTES = 1 << 30
#: The DOSC reading: the trained model's gradient over two pods of eight.
DOSC_PODS, DOSC_POD_CHIPS = 2, 8


@contextlib.contextmanager
def plain_blockwise():
    """Inside the ``with``, the LM's norms run ``rmsnorm_ref`` and its
    prompt attention ``flash.blockwise_fwd`` (the reference's blockwise
    plain version over the same static block pairs kernel E's launches
    are credited with), on any device: the plain path whose count a
    kernel path's must equal.  The launch counts are set to 0 on entry,
    and the block fails if D or E was launched inside it."""
    from repro_torch.kernels.rmsnorm import rmsnorm_ref
    from repro_torch.models import flash, layers

    saved = layers.rmsnorm_op, flash.flash_attention_fwd
    layers.rmsnorm_op = lambda x, scale, eps=1e-6: rmsnorm_ref(x, scale, eps)
    flash.flash_attention_fwd = flash.blockwise_fwd
    reset_counts()
    try:
        yield
        counts = read_counts()
        check(counts["D"] == counts["E"] == 0,
              f"the plain blockwise path launched kernels: {counts}")
    finally:
        layers.rmsnorm_op, flash.flash_attention_fwd = saved


def attention_pairs(cfg, seq: int, block: int = 512) -> dict:
    """(query, key) pairs of one ``seq``-token prompt summed over ``cfg``'s
    attention layers, three ways: as ``lm_bounds`` counts them (causal,
    every layer, no window), as the mask leaves them visible (the sliding
    window too), and as the blockwise algorithm and kernel E's credit
    compute them (whole blocks of the reference's static block pairs,
    ``block`` wide, clipped to the sequence)."""
    from repro_torch.models.attention import _block_pairs

    b = min(block, seq)
    out = {"lm_bounds": 0, "visible": 0, "blocks": 0}
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if not kind.startswith("attn"):
            continue
        window = cfg.sliding_window if kind == "attn_local" else 0
        out["lm_bounds"] += seq * (seq + 1) // 2
        out["visible"] += visible_pairs(seq, seq, True, window)
        out["blocks"] += len(_block_pairs(seq // b, seq // b, b, b, 0, True,
                                          window)) * b * b
    return out


def power_draw(run, seconds: float) -> dict:
    """The card's ``power.draw`` (W) while ``run()`` repeats for about
    ``seconds`` (``run`` None: while the card does nothing): nvidia-smi
    read in a loop beside it, the median of the second half of the
    readings (the draw ramps up, and nvidia-smi averages over its own
    window)."""
    import threading

    import torch

    readings, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            readings.append(float(query_gpu("power.draw").split()[0]))

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    t0 = time.perf_counter()
    n = 0
    try:
        while time.perf_counter() - t0 < seconds:
            if run is None:
                time.sleep(0.05)
            else:
                run()
                torch.cuda.synchronize()
                n += 1
    finally:
        stop.set()
        t.join(timeout=60)
    check(len(readings) >= 2, f"power: {len(readings)} readings")
    tail = readings[len(readings) // 2:]
    return {"w": float(np.median(tail)), "readings": len(readings),
            "runs": n, "s": time.perf_counter() - t0}


def loop_rate(fn, reps: int) -> float:
    """Calls a second of ``fn`` on the card, by CUDA events around
    ``reps`` back-to-back calls."""
    fn()
    return 1e3 / unheld_ms(fn, reps)


def counted_forward(cfg, params, batch) -> tuple:
    """``analyze_program`` of one forward, and the launches it made."""
    import torch

    from repro_torch.core.hlo_cost import analyze_program
    from repro_torch.models import transformer as T

    reset_counts()
    with torch.no_grad():
        cost = analyze_program(T.forward, cfg, params, batch)
    return cost, read_counts()


def phase_roofline(dev, smi: str, cfg=None, seq: int = LM_SEQ,
                   train_argv: list = TRAIN_ARGV,
                   power: tuple = (POWER_IDLE_S, POWER_LOOP_S,
                                   POWER_PROBE_S)) -> dict:
    """The program count, the H100 roofline and power (phase 9h).

    (a) ``cfg`` (gemma2-2b at full width) forward on a ``seq``-token
    prompt counted by ``hlo_cost.analyze_program`` on the kernel path
    (the launches of D and E ``lm_launches``, each credited with its
    plain twin's flops) and on the plain blockwise path
    (``plain_blockwise``): the two counts' flops equal exactly; the
    matmul and attention flops within ROOFLINE_LM_RTOL of ``lm_bounds``'
    bf16 operations, the difference exactly the attention's (whole block
    pairs against ``lm_bounds``' causal pairs, ``attention_pairs``);
    ``roofline.build_terms`` under ``H100_SXM`` beside the forward's
    device time.  (b) One ``train_argv`` training step (qwen2-0.5b)
    counted: its flops at least ``train_step_flops``' operations; the
    useful-flops ratio.  (c) ``power.draw`` at idle, while the forward
    loops, and while a device copy and a bf16 matmul loop (from which
    the H100 spec's HBM and flop energies are derived), beside
    ``tpu_energy.step_energy`` at the forward's measured time under the
    frozen spec and under this run's readings.  (d) ``dosc.advise`` for
    the trained model's gradient over DOSC_PODS pods of DOSC_POD_CHIPS.
    Returns the ``roofline`` report; with ``power`` None, (c) is left
    out (no card to read)."""
    import torch

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core import dosc, roofline, tpu_energy
    from repro_torch.core.constants import H100_SXM, H100_READINGS
    from repro_torch.core.hlo_analysis import CollectiveSummary
    from repro_torch.core.hlo_cost import analyze_program
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    split: dict = {}

    def lap(name):
        split[name] = time.perf_counter() - t_phase - sum(split.values())

    cfg = cfg if cfg is not None else get_config(LM_ARCH)
    cuda = dev.type == "cuda"
    report: dict = {"arch": cfg.name, "seq": seq, "chip": H100_SXM.name}
    none = CollectiveSummary([])
    if power:
        sync(dev)
        idle = power_draw(None, power[0])
    if cuda:
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        params = T.init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                               device=dev)
    batch = T.Batch(tokens=tokens)
    lap("setup")

    # (a) the forward, counted on both paths
    cost, launches = counted_forward(cfg, params, batch)
    lap("count_kernel_path")
    expect = lm_launches(cfg, params)
    check(launches == expect, f"roofline forward: expected launches "
          f"{expect}, got {launches}")
    for name in ("rmsnorm", "flash_attention"):
        check(cost.bytes_by_op.get(f"kernel {name}", 0) > 0,
              f"roofline forward: no launch of {name} was credited")
    with plain_blockwise():
        plain, _ = counted_forward(cfg, params, batch)
    lap("count_plain_path")
    check(plain.flops == cost.flops
          and dict(plain.flops_by_op) == dict(cost.flops_by_op),
          f"roofline forward: kernel path {dict(cost.flops_by_op)} flops, "
          f"plain path {dict(plain.flops_by_op)}")
    lm = lm_bounds(cfg, params, seq)
    pairs = attention_pairs(cfg, seq)
    per_pair = 2 * (cfg.resolved_head_dim + cfg.resolved_head_dim) \
        * cfg.num_heads
    explained = lm["ops"] + per_pair * (pairs["blocks"] - pairs["lm_bounds"])
    dot = cost.flops_by_op["dot"]
    rel = dot / lm["ops"] - 1.0
    check(dot == explained,
          f"roofline forward: {dot} dot flops, {explained} explained "
          f"(lm_bounds {lm['ops']} with the attention over whole blocks)")
    check(abs(rel) <= ROOFLINE_LM_RTOL,
          f"roofline forward: dot flops {dot} are {rel:+.4f} from "
          f"lm_bounds' {lm['ops']}")
    fwd = lambda: T.forward(cfg, params, batch)  # noqa: E731
    with torch.no_grad():
        fwd_rep: dict = {}
        if cuda:
            # The forward keeps the card busy (96 %, phase 9), so CUDA
            # events around calls back to back read its device time, with
            # the few idle gaps in it (never low); a trace's retries on
            # machines that drop records cost ~10 s of the phase.
            fwd()
            fwd_rep["device_ms"] = unheld_ms(fwd, 3)
            fwd_rep["device_ms_method"] = "events_unheld"
        else:
            t0 = time.perf_counter()
            fwd()
            fwd_rep["device_ms"] = (time.perf_counter() - t0) * 1e3
            fwd_rep["device_ms_method"] = "host"
    lap("forward_time")
    terms = roofline.build_terms(
        cfg.name, f"prompt_{seq}", "1", 1,
        {"flops": cost.flops, "bytes accessed": cost.bytes}, none,
        model_flops_global=lm["ops"], chip=H100_SXM)
    t_fwd = fwd_rep["device_ms"] / 1e3
    report["forward"] = {
        "launches": launches, "flops": cost.flops,
        "flops_by_op": dict(cost.flops_by_op), "bytes": cost.bytes,
        "plain_bytes": plain.bytes, "plain_flops_equal": True,
        "kernel_bytes": {k: v for k, v in cost.bytes_by_op.items()
                         if k.startswith("kernel ")},
        "lm_bounds_ops": lm["ops"], "dot_vs_lm_bounds": rel,
        "attention_pairs": pairs,
        "attention_flops": {k: per_pair * v for k, v in pairs.items()},
        "terms": terms.to_dict(), **fwd_rep,
        "measured_over_bound": t_fwd / terms.t_bound}
    print(f"roofline forward {cfg.name} S={seq}: {cost.flops:.6e} flops "
          f"(dot {dot:.6e}, lm_bounds {lm['ops']:.6e}, {rel:+.4%}), "
          f"{cost.bytes:.6e} bytes; H100 t_compute "
          f"{terms.t_compute * 1e3:.3f} ms, t_memory "
          f"{terms.t_memory * 1e3:.3f} ms, dominant {terms.dominant}; "
          f"measured {fwd_rep['device_ms']:.3f} ms = "
          f"{t_fwd / terms.t_bound:.3f} x t_bound")

    # (c) power: idle, the forward's loop, and the two probes
    if power:
        with torch.no_grad():
            looped = power_draw(fwd, power[1])
        n_el = POWER_COPY_BYTES // 2
        src = torch.empty(n_el, dtype=torch.bfloat16, device=dev)
        dst = torch.empty_like(src)

        def copy():
            for _ in range(20):
                dst.copy_(src)

        copy_rate = loop_rate(copy, 3) * 20 * 2 * POWER_COPY_BYTES
        copied = power_draw(copy, power[2])
        del src, dst
        m, k, n = POWER_MATMUL
        a = torch.randn(m, k, dtype=torch.bfloat16, device=dev)
        w = torch.randn(k, n, dtype=torch.bfloat16, device=dev)

        def matmul():
            for _ in range(20):
                torch.mm(a, w)

        mm_rate = loop_rate(matmul, 3) * 20
        multiplied = power_draw(matmul, power[2])
        del a, w
        mm_bytes = 2 * (m * k + k * n + m * n) * mm_rate
        e_hbm = (copied["w"] - idle["w"]) / copy_rate
        e_flop = (multiplied["w"] - idle["w"] - mm_bytes * e_hbm) \
            / (2 * m * k * n * mm_rate)
        this_run = dataclasses.replace(
            H100_SXM, e_per_flop=e_flop, e_hbm_per_byte=e_hbm,
            idle_power=idle["w"])
        model = tpu_energy.step_energy(terms, none, 1, t_step=t_fwd,
                                       chip=H100_SXM)
        model_now = tpu_energy.step_energy(terms, none, 1, t_step=t_fwd,
                                           chip=this_run)
        report["power"] = {
            "idle_w": idle["w"], "forward_w": looped["w"],
            "copy_w": copied["w"], "matmul_w": multiplied["w"],
            "readings": {"idle": idle, "forward": looped, "copy": copied,
                         "matmul": multiplied},
            "copy_bytes_per_s": copy_rate,
            "matmul_flops_per_s": 2 * m * k * n * mm_rate,
            "matmul_bytes_per_s": mm_bytes,
            "derived": {"e_hbm_per_byte": e_hbm, "e_per_flop": e_flop},
            "spec": {"idle_w": H100_SXM.idle_power,
                     "e_hbm_per_byte": H100_SXM.e_hbm_per_byte,
                     "e_per_flop": H100_SXM.e_per_flop,
                     "frozen_from": H100_READINGS.card},
            "model_avg_power_w": model.avg_power_w,
            "model_breakdown_j": model.breakdown(),
            "model_this_run_avg_power_w": model_now.avg_power_w,
            "model_over_measured": model.avg_power_w / looped["w"]}
        print(f"roofline power: idle {idle['w']:.2f} W, forward loop "
              f"{looped['w']:.2f} W, copy {copied['w']:.2f} W at "
              f"{copy_rate:.4e} B/s, matmul {multiplied['w']:.2f} W at "
              f"{2 * m * k * n * mm_rate:.4e} FLOP/s; step_energy "
              f"{model.avg_power_w:.2f} W (frozen spec), "
              f"{model_now.avg_power_w:.2f} W (this run's readings); "
              f"card {smi}")
        lap("power")
    del params, batch, tokens
    if cuda:
        torch.cuda.empty_cache()

    # (b) one training step, counted
    args = train.build_argparser().parse_args(train_argv)
    tcfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    flops = train_step_flops(tcfg, args.global_batch, args.seq_len)
    tparams = S.trainable(T.init_params(
        tcfg, torch.Generator(device=dev).manual_seed(args.seed), dev))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)
    opt = adamw.init(opt_cfg, tparams)
    tbatch = train.device_batch(SyntheticLM(tcfg, DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        seed=args.seed)).batch_at(0), dev)
    step = S.make_train_step(tcfg, opt_cfg, remat=args.remat)
    grad_elems = T.param_count(tparams)
    reset_counts()
    tcost = analyze_program(step, tparams, opt, tbatch)
    tlaunch = read_counts()
    want = dict(train_launches(tcfg), A=0, B=0, C=0)
    check(tlaunch == want, f"roofline train step: expected launches "
          f"{want}, got {tlaunch}")
    check(tcost.flops >= flops["ops"],
          f"roofline train step: {tcost.flops} flops counted, fewer than "
          f"train_step_flops' {flops['ops']}")
    tterms = roofline.build_terms(
        tcfg.name, f"train_{args.global_batch}x{args.seq_len}", "1", 1,
        {"flops": tcost.flops, "bytes accessed": tcost.bytes}, none,
        model_flops_global=flops["ops"], chip=H100_SXM)
    report["train"] = {
        "arch": tcfg.name, "global_batch": args.global_batch,
        "seq": args.seq_len, "remat": args.remat, "launches": tlaunch,
        "flops": tcost.flops, "flops_by_op": dict(tcost.flops_by_op),
        "bytes": tcost.bytes, "train_step_flops": flops["ops"],
        "useful_flops_ratio": tterms.useful_flops_ratio,
        "terms": tterms.to_dict()}
    lap("train_step")
    print(f"roofline train step {tcfg.name}: {tcost.flops:.6e} flops "
          f"counted, train_step_flops {flops['ops']:.6e}, useful "
          f"{tterms.useful_flops_ratio:.4f}")
    del tparams, opt, tbatch
    if cuda:
        torch.cuda.empty_cache()

    # (d) the partition advisor under the H100 spec
    report["dosc"] = {"grad_elems": grad_elems, "pods": DOSC_PODS,
                      "intra_pod_chips": DOSC_POD_CHIPS}
    for objective in ("energy", "time"):
        report["dosc"][objective] = [
            {"plan": c.plan.name, "t_comm_s": c.t_comm_s,
             "e_comm_j": c.e_comm_j, "ici_bytes": c.ici_bytes,
             "dcn_bytes": c.dcn_bytes}
            for c in dosc.advise(grad_elems, DOSC_PODS, DOSC_POD_CHIPS,
                                 objective=objective, chip=H100_SXM)]
    report["table"] = roofline.format_table([terms, tterms])
    lap("dosc")
    report["phase_s"] = time.perf_counter() - t_phase
    report["split_s"] = split
    report["card"] = smi
    print(report["table"])
    return report


#: The phases of :func:`run`, in the order they run (``--phases`` picks
#: among them; the default runs them all).
PHASES = ("kernels", "dense", "dense_engine", "stream", "stream_resilience",
          "scenario", "optimize", "stream_devices", "service", "rbe",
          "pipeline", "rmsnorm", "flash", "train", "lm", "roofline", "stub",
          "ssm", "moe", "mla")
#: The phases each row of the ``kernels`` line is measured in: a row is
#: left out of the line unless they all ran.
ROW_NEEDS = {"A": ("kernels", "dense_engine", "stream"),
             "B": ("kernels", "dense_engine", "stream"),
             "C": ("rbe", "pipeline"),
             "D": ("rmsnorm", "flash", "lm"),
             "E": ("rmsnorm", "flash", "lm")}
#: The phase that fills each of a row's other launch fields: a row whose
#: phase did not run goes without the field.
FIELD_PHASE = {"launches_grid_argmin": "optimize",
               "launches_service": "service",
               "launches_train": "train", "launches_train_step": "train",
               "launches_ssm": "ssm", "launches_moe": "moe",
               "launches_mla": "mla", "launches_stub": "stub"}
ROW_FIELDS = {"A": ("launches_service",),
              "B": ("launches_grid_argmin", "launches_service"),
              "C": (),
              "D": ("launches_train", "launches_train_step", "launches_ssm",
                    "launches_moe", "launches_mla", "launches_stub"),
              "E": ("launches_train", "launches_train_step", "launches_ssm",
                    "launches_moe", "launches_mla", "launches_stub")}


def parse_phases(argv: list) -> tuple:
    """The phases ``argv`` selects (``--phases a,b,...``; every phase
    without it), in :data:`PHASES` order.  An unknown name is an
    argparse error: exit status 2 before any work."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="chip_smoke.py",
        description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run, of: "
                    + ", ".join(PHASES) + " (default: all)")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.phases.split(",") if n.strip()]
    unknown = sorted(set(names) - set(PHASES))
    if unknown or not names:
        ap.error(f"unknown phase(s) {', '.join(unknown) or '(none)'}; "
                 f"known: {', '.join(PHASES)}")
    return tuple(p for p in PHASES if p in names)


def left_out(phases) -> dict:
    """What the ``kernels`` line cannot fill when only ``phases`` run:
    ``{"rows": {row: phases it lacks}, "fields": {row: {field: phase}},
    "phases": phases not run}``; empty when every phase runs."""
    on = set(phases)
    if on >= set(PHASES):
        return {}
    rows = {r: [p for p in need if p not in on]
            for r, need in ROW_NEEDS.items()
            if not on.issuperset(need)}
    fields = {r: {f: FIELD_PHASE[f] for f in ROW_FIELDS[r]
                  if FIELD_PHASE[f] not in on}
              for r in ROW_NEEDS if r not in rows}
    return {"phases": [p for p in PHASES if p not in on], "rows": rows,
            "fields": {r: f for r, f in fields.items() if f}}


def run(dev, grid_big, smi: str, lm_cfg, lm_seq: int = LM_SEQ,
        serve_argv: list = SERVE_ARGV,
        train_argv: list = TRAIN_ARGV, phases: tuple = PHASES) -> None:
    """Phases 2-11 on ``dev`` with ``grid_big`` as the stream's grid,
    ``lm_cfg`` run at ``lm_seq`` tokens as the LM, ``train.main(
    train_argv)`` as the training path, qwen2-vl-2b and musicgen-large
    as the modality-stub path, xlstm-350m and jamba at
    SSM_JAMBA_LAYERS layers as the SSM path, arctic-480b at MOE_LAYERS
    layers as the MoE path and deepseek-v2-236b at MLA_LAYERS layers as
    the MLA path; of them, the ``phases`` named (every phase keeps all
    of its gates).  A row of the ``kernels`` line is printed only if
    every phase it is measured in ran, and a field of a row only if its
    phase ran; the line says what it left out (:func:`left_out`)."""
    from repro_torch.core import stream as ST
    from repro_torch.core.grids import (ANCHOR_1M, ANCHOR_10M,
                                        REFERENCE_GRID, stream_grid_axes)

    on = set(phases)
    missing = left_out(phases)
    no_row = missing.get("rows", {})
    err, lines, rows = {}, [], []
    if "kernels" in on:
        err.update(phase_kernels(dev, grid_big, REFERENCE_GRID))
    if "dense" in on:
        phase_dense(REFERENCE_GRID, dev)
    if "dense_engine" in on:
        dense = phase_dense_engine(dev, ANCHOR_1M)
    if "stream" in on:
        res, launches, paths, plans = phase_stream(
            grid_big, stream_grid_axes(10_000_000), ANCHOR_10M, dev)
    if "stream_resilience" in on:
        resilience = phase_stream_resilience(dev)
    if "scenario" in on:
        phase_scenario(dev, smi)
    if "optimize" in on:
        opt = phase_optimize(dev, smi)
    if "stream_devices" in on:
        phase_stream_devices(dev, smi)
    if "service" in on:
        served = phase_service(dev, smi)
    if "rbe" in on:
        err["C"] = phase_rbe(dev)
    if "pipeline" in on:
        ht_launches, ht = phase_pipeline(dev, smi)
    if "rmsnorm" in on:
        err["D"] = phase_rmsnorm(dev)
    if "flash" in on:
        err["E"] = phase_flash(dev)
    if "A" not in no_row:
        rows, host = kernel_report(res, launches, err, grid_big, dense, dev)
        if "optimize" in on:
            rows[1]["launches_grid_argmin"] = opt["launches"]["B"]
        if "service" in on:
            for row, key in ((rows[0], "A"), (rows[1], "B")):
                row["launches_service"] = \
                    served["in_process"]["launches"][key]
    if "C" not in no_row:
        row_c, shapes = rbe_report(ht_launches, err["C"], dev, smi)
        rows.append(row_c)
    if "D" not in no_row:
        rows_de, lm_shapes = lm_kernel_report(err, dev)
        rows += rows_de
        lm_shapes["card"] = smi
    if "A" not in no_row:
        print(json.dumps({"host_ms_per_call": host, "card": smi}))
    if "stream" in on:
        # The device's busy share of each path, from one profiled run of
        # the same sweep: its device time over its own wall time (the
        # profiler's host overhead is in that wall time, so the share is
        # a lower bound on the unprofiled run's).  The plans' steps are
        # built, so no capture falls inside a trace.
        for key, plan, prefetch in (("default", plans[0], 2),
                                    ("synchronous", plans[1], 0)):
            profiled = []
            busy = device_busy(lambda: profiled.append(
                ST.stream_grid(plan=plan, prefetch=prefetch)))
            total = sum(busy.values())
            paths[key].update(
                profiled_total_s=profiled[0].stats["total_s"],
                device_busy_s=total,
                device_busy_share=total / profiled[0].stats["total_s"],
                device_s_by_kernel=dict(sorted(
                    busy.items(), key=lambda kv: -kv[1])[:8]))
        stats = dict(paths["default"], synchronous=paths["synchronous"],
                     plain=paths["plain"],
                     bitwise_plain=paths["bitwise_plain"])
    de, reports = {}, {}
    if "train" in on:
        train_main, train_step, reports["train"] = phase_train(
            dev, smi, train_argv)
        de.update(launches_train=train_main, launches_train_step=train_step)
    # The LM last: its serve run's trace (~85,000 kernels) is the largest
    # the script takes.
    if "lm" in on:
        lm_launches, reports["lm"] = phase_lm(dev, lm_cfg, lm_seq,
                                              serve_argv, smi)
    # the program count and the H100 roofline of the LM's forward (its
    # weights rebuilt) and of one training step
    if "roofline" in on:
        reports["roofline"] = phase_roofline(dev, smi, lm_cfg, lm_seq,
                                             train_argv)
    # the modality-stub models (8 GB) before jamba's 52 GB
    if "stub" in on:
        stub_launches, reports["stub"] = phase_stub(dev, smi)
        de["launches_stub"] = stub_launches
    # the SSM path before MoE: jamba's 52 GB, freed before arctic's
    if "ssm" in on:
        ssm_launches, reports["ssm"] = phase_ssm(dev, smi)
        de["launches_ssm"] = ssm_launches
    # MoE after every other phase: its 55 GB of weights need the card
    if "moe" in on:
        moe_fwd, moe_step, reports["moe"] = phase_moe(dev, smi)
        de["launches_moe"] = {"forward": moe_fwd, "decode_step": moe_step}
    # MLA last, after arctic's weights are freed: its 50 GB and the
    # witness's float32 copies need the card
    if "mla" in on:
        mla_fwd, mla_step, reports["mla"] = phase_mla(dev, smi)
        de["launches_mla"] = {"forward": mla_fwd, "decode_step": mla_step}
    for row in rows:
        key = row.pop("kernel", None)
        if key is None:
            continue
        row["launches"] = lm_launches[key]
        for field in ROW_FIELDS[key]:
            if field not in de:
                continue
            if field in ("launches_ssm", "launches_stub"):
                row[field] = {arch: {k: c[key] for k, c in runs.items()}
                              for arch, runs in de[field].items()}
            elif field in ("launches_moe", "launches_mla"):
                row[field] = {k: c[key] for k, c in de[field].items()}
            else:
                row[field] = de[field][key]
    if "stream" in on:
        lines.append({"stream": stats, "card": smi})
    if "stream_resilience" in on:
        lines.append({"stream_resilience": resilience, "card": smi})
    if "C" not in no_row:
        lines.append(shapes)
    if "pipeline" in on:
        lines.append({"handtracking": ht})
    if "D" not in no_row:
        lines.append(lm_shapes)
    for name in ("lm", "stub", "train", "ssm", "moe", "mla", "roofline"):
        if name in reports:
            lines.append({name: reports[name]})
    kernels_line = {"kernels": rows}
    if missing:
        kernels_line["left_out"] = missing
    lines.append(kernels_line)
    for line in lines:
        print(json.dumps(line))


def build(libs) -> None:
    """Build every kernel library (one nvcc each, all started together)
    and print the time and the compiler's register/spill report."""
    from repro_torch.kernels._build import build_all

    t0 = time.perf_counter()
    build_all(libs)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(libs)} libraries in parallel")
    for lib in libs:
        lib.load()
        print(f"build {lib.name}: {lib.info.get('seconds', 0.0):.1f} s nvcc")
        for line in lib.info.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}: {line.strip()}")


def main(argv: list | None = None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    # torch.compile (the flex_attention yardstick) caches in the checkout.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.grids import stream_grid_axes
    from repro_torch.kernels._build import all_libraries

    # Float32 matmuls in full float32 (the default, stated and set): the
    # reduced float32 LMs are held against the JAX anchors.
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}")
    if phases != PHASES:
        print(f"phases: {','.join(phases)} (of {len(PHASES)})")
    build(all_libraries())
    # Card 0 by index: a bare "cuda" would spread the "torch" backend's
    # streams over every visible card (stream_devices runs that case).
    run(torch.device("cuda", 0), stream_grid_axes(100_000_000), smi,
        get_config(LM_ARCH), phases=phases)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
