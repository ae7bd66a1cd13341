#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build: compile the CUDA sources (flash attention's three forward and
   three backward engines, fused MoE's three forward and three backward engines,
   scaled_mm's two) with nvcc, one
   process each, all at once, and the Triton kernels (rmsnorm, silu_mul
   and their backwards), from the sources in this checkout; ptxas's
   registers and spills of each backward instance (flash attention's and
   fused MoE's mma.sync, wgmma and 3xTF32 wgmma engines; flash attention's
   wgmma backward at head dims 64, 80 and 128 and fused MoE's 3xTF32
   engines with no spill) and of the forward wgmma engines (flash
   attention's at head dims 64, 80, 128 and 256 with no spill), flash
   attention's 3xTF32 engines with no spill; flash attention's forward and
   backward wgmma and 3xTF32 engines and fused MoE's two
   3xTF32 engines with no C7515 note
   (ptxas serialized wgmma instructions) and no C7519 or C7520 note (it
   injected a ``warpgroup.arrive``); each library's notes are logged; the
   launch plans,
   and each wgmma engine's SASS
   instruction counts (HGMMA, TMA loads and stores, mbarrier waits, all
   asserted present; the forward engines store no tile by TMA) are logged;
   scaled_mm's wgmma engine with no spill and no C75xx note in any
   instance (registers logged), its SASS held to IGMMA, UTMALDG and SYNCS;
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the reference's test shapes and the main paths' shapes
   (f32 2e-5, bf16 2e-2, scaled_mm 1e-2 and an exact int32 sum, the
   reference's kernel tolerances; full-width f32 MoE sums relative to
   max|ref|; bf16 attention at the main shapes also row by row, within
   2e-2 of each row's max|ref| plus one ulp); flash attention on the
   engine ``fwd_engine`` picks (bf16 at head dims 64, 80, 128 and 256: the
   wgmma engine, its lse against ``lse_ref`` too, then the mma.sync engine
   on the same inputs; f32 at 64, 80 and 128: the 3xTF32 engine, its lse
   too, then the FMA engine on the same inputs; f32 at 256 and head dims
   8-32: the mma.sync engine, whose f32 main path is gemma2-2b's), with
   query offsets at head dim 64, at the lattice's block corners (bf16, the main
   shape) with its launched grid, and rows that see no key; fused MoE and
   scaled_mm at every
   config the tuner's prefilter passes on its default workloads (fused MoE
   also in bf16; f32 with 16-byte rows on the 3xTF32 wgmma engine, held
   also to the plain version run in float64, within 1e-5 of max|ref|, and
   to the mma.sync engine; the reference's 150-wide F blocks on the
   mma.sync engine), flash attention and silu_mul at every config it passes
   on their qwen3-0.6b workloads, and fused MoE and scaled_mm at dbrx-132b
   width (scaled_mm also with 32-deep steps; every scaled_mm case on the
   engine ``engine`` picks, the wgmma engine's bf16 output bit-equal to the
   plain version's, and at the shapes the mma.sync engine stages byte by
   byte and the nearest the wgmma engine takes); fused MoE in bf16 at dbrx-132b's serving shapes, through the
   model's ``expert_ffn``: a decode tick of 4 slots (4 rows an expert) and
   the prefill of a prime-length prompt (8012 rows, padded to 8064); fused
   MoE's forward wgmma engine (bf16 with 16-byte rows at any rows and
   block_m, chosen by ``fwd_engine``) at small ragged shapes over several (block_m, block_f)
   and at dbrx-132b's width with 512 and 640 rows an expert, each also
   within bf16 2e-2 of max|ref| of the mma.sync engine's output; and
   the remaining families' shapes: flash attention at gemma2-2b's prefill
   (4608 tokens, window 4096, softcap 50, head dim 256), whisper-base's
   encoder and cross attention (1500 frames), llama-3.2-vision's cross
   attention (1601 patches), stablelm-3b's head dim 80 and hymba-1.5b's
   global layer (B1 S1528 25/5 heads of 64); silu_mul geglu
   at gemma2-2b's (4608, 9216); and the four backward kernels (rmsnorm,
   silu_mul, flash attention, fused MoE) against their plain backward
   formulas, at qwen3-0.6b's training shapes (B4 S2048; rmsnorm also at
   its q and k norms' rows), stablelm-3b's (B1 S2048, 32/32 heads of 80,
   bf16 and f32), gemma2-2b's (head dim 256 with causal, window and
   softcap 50 masks, small and at B1 S4096 8/4 heads); bf16 at head dims
   64, 80, 128 and 256 runs flash attention's wgmma engine, also small,
   ragged (S 130) with each mask alone, with rows that see no key, a group
   of 6, dbrx-132b's training shape (B1 S2048 48/8 heads of 128),
   gemma2-2b's unmasked at B1 S4096, hymba-1.5b's global layer (B1 S1528
   25/5 heads of 64) and whisper-base's encoder (B1 S1500 8/8 heads of 64,
   no mask), each also held to the mma.sync engine's gradients; f32 at 80
   and 128 runs the 3xTF32 engine, at qwen3-0.6b's, stablelm-3b's and
   dbrx-132b's phase 10 (a) shapes too, held to the FMA engine's gradients;
   the mma.sync engine's main path is f32 at 256), query offsets (a rank's
   block of rows: forward and backward on both engines, f32 and bf16), the
   reference's kernel test shapes (causal and not, a window, a softcap,
   GQA, rows that see no key) and fused MoE's small, ragged, dbrx-132b-wide (2 experts,
   640 rows) and arctic-480b-wide (D 7168, F 4864, 40 rows) shapes, each
   gradient within f32 2e-5 / bf16 2e-2 of its max|ref| (fused MoE's on
   the engine ``bwd_engine`` picks: the wgmma engine for bf16 with 16-byte
   rows, among them a ragged (3, 200, 520, 776) shape, dbrx's and
   arctic's; the 3xTF32 wgmma engine for f32 with 16-byte rows, the same
   shapes and (1, 1, 8, 8), held to the plain formula run in float64; the
   mma.sync engine for the 36/44-wide bf16 and 37/45-wide f32 rows, and
   called directly on dbrx's bf16 inputs, which no model path sends it); every
   case, forward and backward, runs again after the
   caching allocator's free memory is filled with NaN
   (``poison_free_memory``) and must give the same bits;
3. whole-model parity, random weights from one seed, f32 compute: prefill
   of a 64-token prompt and 8 greedy decode steps on the card (kernels) and
   on the CPU (plain versions), same weights: full-width qwen3-0.6b, and
   full-width dbrx-132b cut to 1 layer (18 GB of parameters);
4. serving, the main paths, through ``serve.trace.TraceRecorder``:
   full-width qwen3-0.6b with bf16 compute through ``ServeEngine`` and
   ``ContinuousBatchingEngine`` (every step recorded and stamped, each
   ``StepMeta`` re-lowered by ``step_calls`` to exactly the recorded calls,
   one residual per measured step), one ``ContinuousBatchingEngine`` with
   ``admission="predicted"`` priced by the roofline predictor of a registry
   TPU, with an SLO that defers some admissions, built with ``audit=True``
   (the predictor-coverage pre-flight); then full-width dbrx-132b
   cut to 2 layers, bf16 compute, through both engines. Each run sets the
   launch counts to 0 before it and reads them after: every kernel's count
   must move by exactly what the path implies (fused MoE once per MoE layer
   a step, on either forward engine; flash attention once per layer a
   prefill, on the forward engine ``fwd_engine`` picks for the compute
   type and head dim). Predicted seconds are printed on lines of their
   own, labelled as predictions for the registry TPU;
5. kernel times with CUDA events at the main paths' shapes (device time
   from a CUDA-graph replay; the eager time, launched from Python, is
   logged beside it), beside the plain version's time, one PyTorch library
   call's time where one exists (timed here only; the port never calls it)
   and the least time the card could take (its bound); flash attention's
   forward (bf16) on its wgmma engine and on its mma.sync engine on the
   same inputs, in turns, at the main shape beside SDPA, at gemma2-2b's
   prefill shape (no library call: SDPA takes no softcap; the wgmma
   engine causal only beside SDPA as a logged yardstick, and at other
   blocks), at stablelm-3b's bf16 prefill (B1 S2048 32/32 heads of 80),
   whisper-base's encoder (B1 S1500 8/8 heads of 64, no mask) and
   hymba-1.5b's global layer (B1 S1528 25/5 heads of 64, causal), each
   beside SDPA; fused MoE in bf16 at
   dbrx-132b's 1024-token prefill (the wgmma engine's JSON row) and decode
   serving shapes, at the tuner's dbrx-132b workload (f32, bounded as
   3xTF32: the 3xTF32 engine's JSON row, and the mma.sync engine's from
   its turns on the same inputs; and bf16) and at phase 10 (e)'s 640 rows
   (bf16, and f32 logged), each shape also on the mma.sync engine in turns
   on the same inputs, with each wgmma and 3xTF32 launch under the
   profiler beside its own bound; flash attention's f32 forward on its
   3xTF32 engine in turns with the FMA engine on the same inputs, beside
   SDPA in f32, at qwen3-0.6b's phase 10 (a) (B2 S256 16/8 heads of 128,
   causal: its JSON row), the tuner's workload (B2 S512) and stablelm-3b's
   phase 10 (a) (B2 S256 32/32 heads of 80), each bounded as 3xTF32 (three
   TF32 products for each of its own; the bound at the f32 peak logged);
   the FMA forward's JSON row at the shape its main path runs, gemma2-2b's
   phase 10 (a) (B1 S256 8/4 heads of 256, window 4096, softcap 50, f32;
   its bound at the f32 peak; no library: SDPA takes no softcap; its
   in-turns times at the shapes above are logged); silu_mul
   also at phase 4's prompt lengths,
   scaled_mm at dbrx-132b width on its wgmma engine and its mma.sync
   engine on the same inputs, in turns, beside ``torch._int_mm`` with the
   same epilogue, and so at the tuner's default workload (logged); the three backward kernels at qwen3-0.6b's training
   shapes, beside their plain backward formulas and the backward of
   ``F.rms_norm`` and of SDPA (rows logged beside them: rmsnorm's at the q
   and k norms' (131072, 128) and (65536, 128)); flash attention's
   backward there (B4 S2048 16/8 heads of 128) on the wgmma engine and on
   the mma.sync engine on the same inputs, in turns, and so at
   dbrx-132b's (B1 S2048 48/8), stablelm-3b's (B1 S2048 32/32 heads of 80)
   and hymba-1.5b's global layer (B1 S1528 25/5 heads of 64) (logged),
   each wgmma launch under the profiler beside the bound of its products;
   the f32 backward on its 3xTF32 engine in turns with the FMA engine at
   qwen3-0.6b's phase 10 (a) (its JSON row) and stablelm-3b's, beside SDPA's
   backward in f32, each 3xTF32 launch under the profiler, and the FMA
   backward's JSON row at gemma2-2b's phase 10 (a);
   at gemma2-2b's training shape on the wgmma engine (logged; no library:
   SDPA takes no softcap), in turns with the mma.sync engine, each launch
   under the profiler, and causal only beside SDPA's backward; fused
   MoE's backward at dbrx-132b's training shape (E16, 640 rows, bf16) on
   the wgmma engine, each of its four launches under the profiler beside
   its bound, and on the mma.sync engine on the same inputs, and at the
   tuner's E16 C256 in f32 on the 3xTF32 wgmma engine, in turns with the
   mma.sync engine on the same inputs, each 3xTF32 launch under the
   profiler beside its bound, and at dbrx's 640 rows in f32 (logged),
   beside ``autograd.grad`` of three ``bmm`` and silu * u;
6. where a serving step's time goes: a ``ContinuousBatchingEngine`` with
   every slot filled runs decode ticks, and one more prompt is prefilled,
   under ``torch.profiler``, for qwen3-0.6b, for 2-layer dbrx-132b and for
   full-depth gemma2-2b (4608-token prompts, an 8192-token cache), and a
   prefill and a decode step of full-depth mamba2-370m; for each it prints
   the wall-clock of the profiled window, the device's busy time and idle
   share in that same window, the launches and the kernels
   that take the most device time; and the time one dbrx layer's f32 to
   bf16 parameter cast takes, which the engines do once, not every step;
7. the tuner, the second main path: ``repro_torch.tune.tune`` ranks
   configs with the roofline predictor for a registry TPU and times the
   top 4 and the default on the card: fused MoE (f32: its 3xTF32 wgmma
   engine, never the mma.sync one) and scaled_mm (its wgmma engine, never
   the mma.sync one) at the tuner's default workloads and at dbrx-132b width, flash attention and silu_mul at their
   qwen3-0.6b workloads; every measured config's launched grid must equal
   its ``grid_shape`` and the launch counts must move by exactly (1 +
   repeats) per measured config;
8. the trained predictor (the paper's §IV-D estimator): the six kernel
   families' datasets from ``hwsim`` (220 workloads each, fixed seeds), the
   PipeWeave MLPs trained on the card (rows, epochs, steps, wall-clock and
   ms a step logged per family; one short fit under ``torch.profiler`` for
   the device's busy time, idle share and launches a step), the four baselines fitted on the card, the
   seen/unseen MAPE table gated on ``bench_kernel_mape``'s smoke criteria
   (average MAPE at most 25% seen and 45% unseen, at least 1.2x below the
   best baseline on both splits; the reference's recorded reductions
   printed beside), the P80 ceiling on fused MoE (more than 0.6 of the gaps
   above -0.05), a pickle round trip with bit-equal predictions; then
   full-width qwen3-0.6b served through ``ContinuousBatchingEngine`` with
   ``admission="predicted"`` priced by the synperf backend (deferrals
   asserted; launch counts checked as in phase 4 and added to the
   serving kernels' counts), and ``core.e2e.place_request`` and
   ``simulate_fleet`` over the registry with the synperf backend;
9. the remaining model families: (b) gemma2-2b (2 layers, a 4608-token
   prompt that its window cuts), stablelm-3b (2 layers), mamba2-370m (48),
   hymba-1.5b (4: global layers 0, 2, 3 and one local layer, a 1400-token
   prompt), whisper-base (6 + 6) and llama-3.2-vision-11b (one group of 4
   self and 1 cross layer), each at full width, f32, on the card against
   the CPU within MODEL_TOL of max|logit|, prefill and 8 greedy steps; (c)
   gemma2-2b at full width and depth (26 layers), bf16, served through
   ``ServeEngine`` and ``ContinuousBatchingEngine`` (4 slots, 8192 tokens)
   with prompts of 512-6000 tokens, then each other family through
   ``ServeEngine`` at its depth of (b), every step recorded and re-lowered
   and every kernel's launch count exact (``family_launches``; flash
   attention's prefill calls under the forward engine ``fwd_engine`` picks,
   whisper-base's and hymba-1.5b's at head dim 64 on the wgmma engine),
   and whisper-base's and hymba-1.5b's requests served again with their
   forward on the mma.sync engine (``fwd_on_mma_sync``), the tokens that
   agree counted, and both forwards' prefill logits within 5e-2 of
   max|logit| (``both_forwards``);
10. training, the third main path: (a) qwen3-0.6b, stablelm-3b (head
   dim 80) and gemma2-2b (head dim 256) at full width cut to 2 layers (B2
   S256, gemma2 B1 S256) and dbrx-132b cut to 1 layer (B1 S128, gradients
   only; fused MoE's f32 forward on its 3xTF32 engine), f32, one loss and
   every gradient leaf on the card (kernels and backward kernels) against
   the CPU (plain
   versions, autograd) on the same weights: the loss within 1e-5 relative,
   each leaf within 1e-4 of its max|g|, every leaf's gradient present and
   non-zero; (b) full-depth
   qwen3-0.6b (28 layers, bf16 compute, f32 master weights) trained through
   ``Trainer`` for 10 steps of B4 S2048 with checkpoints every 5 steps: the
   loss falls, every kernel's launch count is exactly 10 x
   ``training_launches`` (layer remat runs each forward kernel twice), the
   step wall-clock, tokens/s and memory peak are printed, one more step is
   profiled (device busy, idle share, launches), and a restart from the
   step-5 checkpoint gives steps 6-10's losses bit for bit under
   ``torch.use_deterministic_algorithms``; (c) two steps with int8
   error-feedback compression (bucketed) and two with 2 microbatches, at
   full width and depth, all losses finite; (d) gemma2-2b at full width
   and depth (26 layers, or the deepest that fits), bf16, B1 S4096, 5 steps
   through ``make_train_step`` with the loss falling and the launch counts
   exact (flash attention's backward on the wgmma engine), its step wall,
   tokens/s, memory peak and one profiled step's device-busy share and
   flash attention's backward share of it; (e) one full-width dbrx-132b layer's forward and
   backward, bf16, 2048 tokens: its wall, launch counts exact (fused MoE's
   forward, twice under remat, and its backward on the wgmma engines), and
   fused MoE's backward and forward kernels' device time;
11. the static auditor: (a) ``python -m repro_torch.analysis --all --strict
   --json`` in a subprocess exits 0 with only info-severity findings, one
   SP105 (no cached dry-run ledger) for each registry arch, and the CUDA
   memory this process holds is the same before and after; its wall
   seconds are printed beside the card's name and power limit; (b) a
   predicted-admission ``ContinuousBatchingEngine(audit=True)`` whose
   roofline predictor carries a stale ``CommRegressor`` (fitted before
   ``all_to_all`` joined its vocabulary) raises ``AuditError`` before it
   builds anything: the CUDA memory allocated is the same before and after.
   Phase 4's predicted-admission engine ran with ``audit=True``, and phases
   3 and 4 ran through the models' ``constrain`` hooks, which without a
   mesh return their input and launch nothing (phase 4's counts are exact).

12. the mesh path, on a one-rank NCCL process group and a ``(1, 1)``
   ``("data", "model")`` ``DeviceMesh`` on the card: (a) full-width,
   full-depth qwen3-0.6b (bf16 compute) through ``ServeEngine(mesh=)`` and
   ``ContinuousBatchingEngine(mesh=)``: parameters and caches are DTensors,
   the kernels run under ``local_map``; the tokens equal the meshless
   engines' on the same weights, each kernel's launches move by exactly
   what they move without the mesh, and the median decode tick is printed
   with and without the mesh (DTensor's host cost); (b) qwen3-0.6b at full
   width, 2 layers, f32: the loss and every gradient leaf on the mesh
   against the meshless ones (phase 10 (a)'s tolerances), then
   ``Trainer(mesh=)``: a checkpoint saved on the mesh resumes without one,
   and one saved without a mesh resumes on it, each giving the same next
   loss as a resume in the same mode; (c) dbrx-132b at full width, 1 layer,
   bf16, under ``no_grad``, expert-parallel on the mesh (``fused_moe``
   through ``local_map``, launched once): the loss equals the meshless
   one. Two ranks sharing the card are not run: gloo refuses CUDA tensors
   for send/recv, which the pipeline needs (its all-gather, reduce-scatter,
   all-reduce and all-to-all take them; PERF.md), and NCCL takes one rank
   a device.

13. the dry run and the roofline, on this machine's CPU with no card: (a)
   ``python -m repro_torch.launch.dryrun`` at full width on fake process
   groups, one process a cell, all at once: qwen3-0.6b x {train_4k,
   prefill_32k, decode_32k} on the 16x16 mesh, dbrx-132b x train_4k on
   2x16x16, and on 16x16 one cell of each class the card host's torch once
   refused: mamba2-370m x decode_32k, gemma2-2b x train_4k, dbrx-132b x
   decode_32k and stablelm-3b x decode_32k; then
   ``python -m repro_torch.roofline.report`` over their
   JSONs, and each cell's lowering seconds, per-device TFLOP, HBM GB,
   collective GB by kind and dominant term under the H100's peaks; (b) the
   op counter (``roofline.op_cost``) over the steps this script timed on
   the card, counted on fake CPU tensors with no mesh: phase 10 (b)'s
   training step, phase 6's qwen3-0.6b decode tick (its cache cut to the
   live span) and 1024-token prefill, their (S, S) attention ops cut to
   the causal pairs; each step's compute and memory terms under this
   card's peaks, and the larger one over its measured wall and
   device-busy time; (c) the dry
   run's ``argument_bytes`` for that training step equal, byte for byte,
   to the ``nbytes`` of the train state and batch phase 10 (b) held on the
   card.

It prints one ``{"kernels": [...]}`` line (eighteen entries: the five
kernels, flash attention's and fused MoE's forward wgmma engines, flash
attention's and fused MoE's 3xTF32 forwards, scaled_mm's wgmma engine, and
the backwards of rmsnorm, silu_mul, flash attention's three engines and
fused MoE's three; fused MoE's mma.sync forward and backward and
scaled_mm's mma.sync engine, which no main path reaches, have 0 launches
and their calls in phases 2 and 5 as ``parity_launches``),
the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Without CUDA, or without the
``src/repro_torch`` package beside it, it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

SEED = 0
F32_TOL, BF16_TOL = 2e-5, 2e-2
# of max|logit|: f32 sums in another order on the card and on the CPU; the gap
# measured on an H100 is about 1.6e-6 of max|logit|
MODEL_TOL = 1e-4
# of max|logit|: a bf16 model's logits on two engines (tests/test_torch_families.py's
# bf16 tolerance)
FAMILY_BF16_TOL = 5e-2
# of max|ref|: the full-width f32 MoE sums run over D=6144 and F=10752 in
# another order on the card than in cuBLAS; the gap measured on an H100 is
# about 5e-6 of max|ref|
MOE_F32_TOL = 1e-4
# of max|float64 ref|: fused MoE's 3xTF32 forward, whose split products are
# exact to f32's rounding and whose stages add into an IEEE f32 total
TF32_F64_TOL = 1e-5
SMM_TOL = 1e-2


def log(msg):
    print(msg, flush=True)


#: bytes of the large block that ``poison_free_memory`` fills: more than any
#: phase 2 case allocates after its inputs
POISON_BYTES = 8 << 30
#: phase 2's cases rerun after ``poison_free_memory``, by kernel
poison_checks: dict = {}


def poison_free_memory(torch):
    """Fill with NaN what the caching allocator hands out next: its cached
    free blocks are released, then one large block (``POISON_BYTES``) and 16
    blocks of its small pool (1 MiB each: 8 of its 2 MiB segments, more
    than a case's small workspaces take) are allocated, filled with NaN and
    freed back into its cache, where the next allocations are carved from.
    A kernel that reads memory it has not written then reads NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    nan = float("nan")
    big = torch.empty(POISON_BYTES // 4, device="cuda").fill_(nan)
    small = [torch.empty(1 << 18, device="cuda").fill_(nan) for _ in range(16)]
    torch.cuda.synchronize()
    del big, small


def same_after_poison(torch, kname, label, fn, first):
    """``fn()`` again after ``poison_free_memory``: each of its outputs must
    be bit-equal to ``first``'s (one tensor or a tuple)."""
    poison_free_memory(torch)
    again = fn()
    torch.cuda.synchronize()
    a = first if isinstance(first, (tuple, list)) else (first,)
    b = again if isinstance(again, (tuple, list)) else (again,)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), (
        f"{label}: the output changed after the free device memory was filled with NaN")
    poison_checks[kname] = poison_checks.get(kname, 0) + 1


class EngineCount:
    """A kernel module's launch count kept under another name (fused MoE's
    and flash attention's forward ``wgmma_launches``), read and set as
    ``launches``, as each of ``main``'s ``kinds`` is."""

    def __init__(self, mod, attr):
        self.mod, self.attr = mod, attr

    @property
    def launches(self):
        return getattr(self.mod, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.mod, self.attr, value)


#: the count (a key of ``main``'s ``kinds``) of each fused MoE forward engine
MOE_FWD_COUNT = {"wgmma": "fused_moe_wgmma", "wgmma_tf32": "fused_moe_tf32",
                 "mma_sync": "fused_moe"}


def moe_fwd_engine(cfg):
    """The engine ``cfg``'s fused MoE forward runs on: what ``fwd_engine``
    gives its compute type and expert widths (at any rows) at the default
    block_f; None for a model without one."""
    import torch

    from repro_torch.kernels.fused_moe.kernel import fwd_engine

    if cfg.family != "moe":
        return None
    return fwd_engine(getattr(torch, cfg.compute_dtype), 1, cfg.d_model, cfg.moe_hidden)


#: the count (a key of ``main``'s ``kinds`` and ``kernel_counts``) of each
#: flash-attention engine, forward and backward
FA_FWD_COUNT = {"wgmma": "flash_attention_wgmma", "tf32": "flash_attention_tf32",
                "mma_sync": "flash_attention"}
FA_BWD_COUNT = {"wgmma": "flash_attention_bwd_wgmma", "tf32": "flash_attention_bwd_tf32",
                "mma_sync": "flash_attention_bwd"}


def model_fa_engines(cfg):
    """The engines ``cfg``'s flash attention runs on, ``(forward,
    backward)``: what ``fwd_engine`` and ``bwd_engine`` give its compute type
    and head dim (the models' q, k and v are fresh tensors, whose bases are
    16-byte multiples)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import bwd_engine, fwd_engine

    dtype, D = getattr(torch, cfg.compute_dtype), cfg.resolved_head_dim
    return fwd_engine(dtype, D), bwd_engine(dtype, D)


@contextlib.contextmanager
def fwd_on_mma_sync(D):
    """Inside the block the forward at head dim ``D`` runs on the mma.sync
    engine: ``fwd_engine`` reads ``FWD_WGMMA_HEAD_DIMS`` at each call, and
    ``D`` is taken out of it."""
    from repro_torch.kernels.flash_attention import kernel as fa_k

    saved = fa_k.FWD_WGMMA_HEAD_DIMS
    fa_k.FWD_WGMMA_HEAD_DIMS = tuple(d for d in saved if d != D)
    try:
        yield
    finally:
        fa_k.FWD_WGMMA_HEAD_DIMS = saved


def on_engines(cfg, counts):
    """``counts``, whose fused MoE and flash attention forward calls stand
    under ``fused_moe`` and ``flash_attention``, with those calls under the
    engine that runs them for ``cfg`` (``moe_fwd_engine``, ``model_fa_engines``):
    the mma.sync engine's name, the wgmma engine's (``..._wgmma``) or the
    3xTF32 engine's (``..._tf32``)."""
    out = dict(counts)
    n = counts.get("fused_moe", 0)
    engine = moe_fwd_engine(cfg) or "mma_sync"
    for name in MOE_FWD_COUNT.values():
        out[name] = n * (name == MOE_FWD_COUNT[engine])
    n, engine = counts.get("flash_attention", 0), model_fa_engines(cfg)[0]
    for e, name in FA_FWD_COUNT.items():
        out[name] = n * (e == engine)
    return out


def bound(peaks, nbytes, ops, kind):
    """``(bound_ms, bound_by)``: the larger of moving ``nbytes`` at the
    memory rate and doing ``ops`` at the peak rate of ``kind``."""
    by_bytes, by_ops = 1e3 * nbytes / peaks["bytes"], 1e3 * ops / peaks[kind]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.silu_mul import kernel as silu_k
    from repro_torch.roofline.analysis import card_peaks

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    kinds = {"rmsnorm": rms_k, "silu_mul": silu_k, "flash_attention": fa_k, "fused_moe": moe_k,
             "fused_moe_wgmma": EngineCount(moe_k, "wgmma_launches"),
             "fused_moe_tf32": EngineCount(moe_k, "tf32_launches"),
             "flash_attention_wgmma": EngineCount(fa_k, "wgmma_launches"),
             "flash_attention_tf32": EngineCount(fa_k, "tf32_launches"),
             "flash_attention_bwd_tf32": EngineCount(fa_k, "bwd_tf32_launches")}

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    with ThreadPoolExecutor(14) as pool:  # one nvcc per CUDA source, all at once
        builds = [pool.submit(f) for f in (fa_k.library, fa_k.fwd_wgmma_library, fa_k.bwd_library,
                                           fa_k.wgmma_library, fa_k.fwd_tf32_library,
                                           fa_k.bwd_tf32_library, moe_k.library,
                                           moe_k.fwd_wgmma_library, moe_k.fwd_tf32_library,
                                           moe_k.bwd_library, moe_k.wgmma_library,
                                           moe_k.tf32_library, smm_k.library,
                                           smm_k.wgmma_library)]
        x = torch.ones(4, 1024, device=dev, dtype=torch.bfloat16)
        rms_k.rmsnorm_cuda(x, torch.zeros(1024, device=dev))
        rms_k.rmsnorm_bwd_cuda(x, x, torch.zeros(1024, device=dev))
        silu_k.silu_mul_cuda(x, x)
        silu_k.silu_mul_bwd_cuda(x, x, x)
        for b in builds:
            b.result()
    torch.cuda.synchronize()
    log(f"[1 build] nvcc + triton: {time.perf_counter() - t0:.1f}s")
    ptxas_report(fa_k, moe_k)
    smm_ptxas_report(smm_k)

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    # the mma.sync engines of fused MoE's forward and backward and of
    # scaled_mm, which no main path reaches: their calls in phases 2 and 5
    off_counts = {"fused_moe": EngineCount(moe_k, "launches"),
                  "fused_moe_bwd": EngineCount(moe_k, "bwd_launches"),
                  "scaled_mm": EngineCount(smm_k, "launches")}
    compared = {k: -c.launches for k, c in off_counts.items()}
    max_err = kernel_parity(torch, dev)
    max_err.update(tuner_kernel_parity(torch, dev))
    moe_serving_parity(torch, dev, max_err)
    max_err.update(backward_parity(torch, dev))
    compared = {k: v + off_counts[k].launches for k, v in compared.items()}
    log(f"[2 kernel parity] passed in {time.perf_counter() - t0:.1f}s; "
        f"max abs err at main-path shapes: {max_err}")

    # ---------------------------------------------------------------- 3
    t0 = time.perf_counter()
    params = model_parity(torch, dev, "qwen3-0.6b")
    model_parity(torch, dev, "dbrx-132b", n_layers=1)  # its 18 GB are freed on return
    torch.cuda.empty_cache()
    log(f"[3 model parity] passed in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 4
    t0 = time.perf_counter()
    launches = serve(torch, dev, params, kinds)
    log(f"[4 serve] passed in {time.perf_counter() - t0:.1f}s; launches {launches}")

    # ---------------------------------------------------------------- 5
    t0 = time.perf_counter()
    gc.collect()  # phase 4's engines, in reference cycles: fused MoE's plain backward needs 28 GB
    torch.cuda.empty_cache()
    log(f"  held on the card before phase 5: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    timed = {k: c.launches for k, c in off_counts.items()}  # phase 4 set fused_moe's to 0
    rows = kernel_times(torch, dev, peaks)
    rows.update(backward_times(torch, dev, peaks))
    compared = {k: v + off_counts[k].launches - timed[k] for k, v in compared.items()}
    log(f"[5 kernel times] done in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 6
    t0 = time.perf_counter()
    served_steps = where_time_goes(torch, dev, params)
    del params
    torch.cuda.empty_cache()
    where_time_goes_moe(torch, dev)
    torch.cuda.empty_cache()
    where_time_goes_gemma2(torch, dev)
    where_time_goes_ssm(torch, dev)
    log(f"[6 where the time goes] done in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 7
    t0 = time.perf_counter()
    tuned = tuner(torch, dev)
    launches["scaled_mm_wgmma"] = tuned["scaled_mm_wgmma"]  # the tuner is scaled_mm's main path
    launches["fused_moe_tf32"] += tuned["fused_moe_tf32"]  # and f32 fused MoE's
    launches["flash_attention_tf32"] += tuned["flash_attention_tf32"]  # and f32 attention's
    log(f"[7 tuner] passed in {time.perf_counter() - t0:.1f}s; launches {tuned}")

    # ---------------------------------------------------------------- 8
    t0 = time.perf_counter()
    priced = trained_predictor(torch, dev, kinds)
    for k, v in priced.items():
        launches[k] += v
    log(f"[8 trained predictor] passed in {time.perf_counter() - t0:.1f}s; launches {priced}")

    # ---------------------------------------------------------------- 9
    t0 = time.perf_counter()
    served = remaining_families(torch, dev, kinds)
    for k, v in served.items():
        launches[k] += v
    log(f"[9 remaining families] passed in {time.perf_counter() - t0:.1f}s; launches {served}")

    # ---------------------------------------------------------------- 10
    t0 = time.perf_counter()
    trained, trained_step = training(torch, dev)
    for k, v in trained.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[10 training] passed in {time.perf_counter() - t0:.1f}s; launches {trained}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    # ---------------------------------------------------------------- 11
    t0 = time.perf_counter()
    static_audit(torch, dev, smi)
    log(f"[11 static auditor] passed in {time.perf_counter() - t0:.1f}s")

    # ---------------------------------------------------------------- 12
    t0 = time.perf_counter()
    sharded = mesh_path(torch, dev, kinds, smi)
    for k, v in sharded.items():
        launches[k] = launches.get(k, 0) + v
    log(f"[12 mesh path] passed in {time.perf_counter() - t0:.1f}s; launches {sharded}")

    # ---------------------------------------------------------------- 13
    t0 = time.perf_counter()
    dry_run_and_roofline(src, name, smi, served_steps, trained_step)
    log(f"[13 dry run and roofline] passed in {time.perf_counter() - t0:.1f}s")

    sources = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/_triton.py",
                    "src/repro/kernels/rmsnorm/kernel.py:13"),
        "silu_mul": ("triton", "src/repro_torch/kernels/silu_mul/_triton.py",
                     "src/repro/kernels/silu_mul/kernel.py:13"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:30"),
        "flash_attention_wgmma": (
            "cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "flash_attention_tf32": (
            "cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tf32.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "fused_moe": ("cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe.cu",
                      "src/repro/kernels/fused_moe/kernel.py:27"),
        "fused_moe_wgmma": ("cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe_wgmma.cu",
                            "src/repro/kernels/fused_moe/kernel.py:27"),
        "fused_moe_tf32": ("cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe_tf32.cu",
                           "src/repro/kernels/fused_moe/kernel.py:27"),
        "scaled_mm": ("cuda", "src/repro_torch/kernels/scaled_mm/csrc/scaled_mm.cu",
                      "src/repro/kernels/scaled_mm/kernel.py:20"),
        "scaled_mm_wgmma": ("cuda", "src/repro_torch/kernels/scaled_mm/csrc/scaled_mm_wgmma.cu",
                            "src/repro/kernels/scaled_mm/kernel.py:20"),
        # the backwards of the kernels training runs through; the TPU kernels
        # have none (the reference differentiates its plain path), so each
        # names the forward TPU kernel whose backward it is
        "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/rmsnorm/_triton.py",
                        "src/repro/kernels/rmsnorm/kernel.py:13"),
        "silu_mul_bwd": ("triton", "src/repro_torch/kernels/silu_mul/_triton.py",
                         "src/repro/kernels/silu_mul/kernel.py:13"),
        "flash_attention_bwd": (
            "cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "flash_attention_bwd_wgmma": (
            "cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_wgmma.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "flash_attention_bwd_tf32": (
            "cuda", "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_tf32.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "fused_moe_bwd": ("cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe_bwd.cu",
                          "src/repro/kernels/fused_moe/kernel.py:27"),
        "fused_moe_bwd_wgmma": (
            "cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe_bwd_wgmma.cu",
            "src/repro/kernels/fused_moe/kernel.py:27"),
        "fused_moe_bwd_tf32": (
            "cuda", "src/repro_torch/kernels/fused_moe/csrc/fused_moe_bwd_tf32.cu",
            "src/repro/kernels/fused_moe/kernel.py:27"),
    }
    # fused_moe's mma.sync engines serve only rows and bases that TMA
    # cannot address (f32 D or F off a multiple of 4, bf16 off 8), which no
    # model config has: since the 3xTF32 engines took f32 (the backward in
    # PR 30, the forward since) no model path reaches them. Their main-path
    # launches are 0; the calls of phases 2 and 5, where they are held
    # against their plain versions and timed, go in a field of their own
    # (scaled_mm's mma.sync engine too: it serves only K or N off 16,
    # unaligned bases and block_k off 32, which no tuner workload or block gives)
    off_path = tuple(off_counts)
    assert not any(launches.get(k) for k in off_path), f"a model path reached {off_path}"
    idle = [k for k in sources if not launches.get(k) and k not in off_path]
    assert not idle, f"kernels the main paths never launched: {idle}"
    assert all(compared.values()), f"phases 2 and 5 never launched one of {compared}"
    kernels = []
    for k, (route, source, replaces) in sources.items():
        kernels.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches.get(k, 0), "max_abs_err": max_err[k], **rows[k],
            **({"parity_launches": compared[k]} if k in off_path else {}),
        })
    log(f"[done] phases 1-13 in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def wgmma_sass(lib, sources, held=("HGMMA", "UTMALDG", "UTMASTG", "SYNCS")):
    """What a wgmma engine's library holds, from ``cuobjdump --dump-sass``:
    its kernels hold warpgroup products (HGMMA; IGMMA for int8), TMA loads
    and stores (UTMALDG, UTMASTG) and mbarrier waits (SYNCS), each of
    ``held``."""
    import collections
    import re

    from repro_torch.kernels._build import _nvcc, library_path

    so = library_path(lib, sources)
    sass = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "--dump-sass", str(so)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    ops = collections.Counter(re.findall(r"\b(HGMMA|IGMMA|UTMALDG|UTMASTG|SYNCS)\b", sass))
    log(f"  {lib} SASS: {dict(sorted(ops.items()))}")
    assert all(ops[k] for k in held), ops


def serialization_notes(lib, sources):
    """ptxas's notes on a library's wgmma, by code: C7515, all of them
    serialized; C7519 and C7520, a ``warpgroup.arrive`` the compiler
    injected. Each note's line, which names its instance, is logged."""
    import re

    from repro_torch.kernels._build import build_log

    text = build_log(lib, sources)
    notes = {n: text.count(n) for n in ("C7515", "C7519", "C7520")}
    if any(notes.values()):
        log(f"  ptxas {lib}: notes on its wgmma instructions {notes}")
        for line in text.splitlines():
            if re.search(r"C75(15|19|20)", line):
                log(f"    {line.strip()[:400]}")
    return notes


def ptxas_report(fa_k, moe_k=None):
    """Phase 1's record of the backward kernels and of the forward wgmma
    engines: ptxas's registers and spills for each instance built
    (``-Xptxas -v``) of flash attention's backward and forward wgmma engine
    and of fused MoE's, each held to at most 1 KB of spill stores (the
    backward wgmma engine's kernels at head dims 64, 80 and 128 to none);
    where ptxas
    serialized a library's wgmma or injected a ``warpgroup.arrive`` (its
    C7515, C7519 and C7520 notes), the count of such notes, which flash
    attention's forward and backward wgmma engines and fused MoE's two
    3xTF32 engines must not have; and the geometry ``bwd_launch_plan`` and
    ``bwd_wgmma_plan`` give at qwen3-0.6b's, gemma2-2b's, stablelm-3b's,
    hymba-1.5b's and whisper-base's training shapes, ``fwd_wgmma_plan`` at
    the forward's main shapes (stablelm-3b's at head dim 80, whisper-base's
    encoder and hymba-1.5b's global layer at 64) and ``tf32_fwd_plan`` at
    the tuner's f32 workload."""
    import re

    import torch

    from repro_torch.kernels._build import build_log

    logs = [("flash_attention_bwd", fa_k.BWD_SOURCES),
            ("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES),
            ("flash_attention_wgmma", fa_k.FWD_WGMMA_SOURCES),
            ("flash_attention_tf32", fa_k.FWD_TF32_SOURCES),
            ("flash_attention_bwd_tf32", fa_k.BWD_TF32_SOURCES)]
    if moe_k is not None:
        logs += [("fused_moe_bwd", moe_k.BWD_SOURCES),
                 ("fused_moe_bwd_wgmma", moe_k.WGMMA_SOURCES),
                 ("fused_moe_bwd_tf32", moe_k.TF32_SOURCES),
                 ("fused_moe_wgmma", moe_k.FWD_WGMMA_SOURCES),
                 ("fused_moe_tf32", moe_k.FWD_TF32_SOURCES)]
    for lib, sources in logs:
        kernel = None
        notes = serialization_notes(lib, sources)
        assert not (any(notes.values()) and lib in (
            "flash_attention_wgmma", "flash_attention_bwd_wgmma", "flash_attention_tf32",
            "flash_attention_bwd_tf32", "fused_moe_bwd_tf32", "fused_moe_tf32")), (
            f"{lib}: ptxas serialized its wgmma or injected arrives: {notes}")
        for line in build_log(lib, sources).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                # the Itanium mangling keeps each name and template argument readable
                name = re.search(r"((?:fa_bwd_\w+?_kernel)|fa_bwd_dq_wgmma|fa_bwd_dkdv_wgmma|"
                                 r"fa_bwd_dq_tf32|fa_bwd_dkdv_tf32|fa_fwd_tf32|"
                                 r"fa_fwd_wgmma|moe_bwd_gemm|moe_bwd_wgmma|moe_bwd_tf32|"
                                 r"moe_fwd_wgmma|moe_fwd_tf32)"
                                 r"(?:I(.*?)EEv)?",
                                 m.group(1))
                if not name:
                    kernel = m.group(1)
                    continue
                args = name.group(2) or ""
                kind = ["bf16"] if "__nv_bfloat16" in args else ["f32"] if args[:1] == "f" else []
                vals = kind + re.findall(r"L[ib](\d+)E", args + "E")
                kernel = name.group(1) + (f"<{', '.join(vals)}>" if vals else "")
            elif kernel and ("spill" in line or "Used" in line):
                log(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
                spill = re.search(r"(\d+) bytes spill stores", line)
                assert spill is None or int(spill.group(1)) <= 1024, f"{kernel} spills: {line}"
                assert spill is None or not re.match(
                    r"fa_bwd_\w+_wgmma<(64|80|128)\b|fa_bwd_\w+_tf32|fa_fwd_tf32|moe_bwd_tf32|"
                    r"moe_fwd_tf32|fa_fwd_wgmma",
                    kernel) or (
                    int(spill.group(1)) == 0), f"{kernel} spills: {line}"
    for kern in fa_k.bwd_launch_plan(4, 2048, 2048, 16, 8, 128):
        log(f"  backward plan, B4 S2048 16/8x128 bf16: {kern.name} grid {kern.grid}, "
            f"{kern.rows} rows a CTA, steps of {kern.step}, {kern.stages} stages, "
            f"{kern.warps} warps, {kern.smem} shared bytes")
    for D, shape in ((128, (4, 2048, 2048, 16, 8)), (256, (1, 4096, 4096, 8, 4)),
                     (80, (1, 2048, 2048, 32, 32)), (64, (1, 1528, 1528, 25, 5)),
                     (64, (1, 1500, 1500, 8, 8))):
        for kern in fa_k.bwd_wgmma_plan(*shape, D):
            log(f"  backward plan (wgmma), B{shape[0]} S{shape[1]} {shape[3]}/{shape[4]}x{D} bf16: "
                f"{kern.name} grid {kern.grid}, {kern.rows} rows a CTA, steps of {kern.step}, "
                f"ring slots {kern.stages}, {kern.warpgroups} consumer warpgroups, "
                f"{kern.smem} shared bytes")
    wgmma_sass("flash_attention_bwd_wgmma", fa_k.WGMMA_SOURCES)
    for D, shape in ((128, (4, 2048, 2048, 16, 8)), (256, (1, 4608, 4608, 8, 4)),
                     (80, (1, 2048, 2048, 32, 32)), (64, (1, 1500, 1500, 8, 8)),
                     (64, (1, 1528, 1528, 25, 5))):
        p = fa_k.fwd_wgmma_plan(*shape, D)
        log(f"  forward plan (wgmma), B{shape[0]} S{shape[1]} {shape[3]}/{shape[4]}x{D} bf16: grid "
            f"{p.grid}, {p.block_q} q rows a CTA in sub-blocks of {p.sub_rows}, steps of "
            f"{p.block_k} keys in {p.tiles_per_step} tile(s) of {p.tile_keys}, {p.stages} stages, "
            f"{p.warpgroups} consumer warpgroups, {p.smem} shared bytes")
    wgmma_sass("flash_attention_wgmma", fa_k.FWD_WGMMA_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
    # the 3xTF32 engines at the f32 paths' shapes: phase 10 (a)'s qwen3-0.6b,
    # stablelm-3b and dbrx-132b gradient runs, the tuner's workload
    for D, shape in ((128, (2, 256, 256, 16, 8)), (80, (2, 256, 256, 32, 32)),
                     (128, (1, 128, 128, 48, 8)), (128, (2, 512, 512, 16, 8))):
        p = fa_k.fwd_tf32_plan(*shape, D)
        log(f"  forward plan (3xTF32), B{shape[0]} S{shape[1]} {shape[3]}/{shape[4]}x{D} f32: grid "
            f"{p.grid}, {p.block_q} q rows a CTA in sub-blocks of {p.sub_rows}, steps of "
            f"{p.block_k} keys in {p.tiles_per_step} tile(s) of {p.tile_keys}, {p.stages} stages, "
            f"{p.warpgroups} consumer warpgroup, {p.smem} shared bytes")
        for kern in fa_k.bwd_tf32_plan(*shape, D, torch.cuda.get_device_properties(
                0).multi_processor_count):
            log(f"  backward plan (3xTF32), B{shape[0]} S{shape[1]} {shape[3]}/{shape[4]}x{D} "
                f"f32: {kern.name} grid {kern.grid}, {kern.rows} rows a CTA, steps of "
                f"{kern.step}, ring slots and lo buffers {kern.stages}, {kern.smem} shared bytes")
    wgmma_sass("flash_attention_tf32", fa_k.FWD_TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
    wgmma_sass("flash_attention_bwd_tf32", fa_k.BWD_TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
    if moe_k is not None:
        for kern in moe_k.bwd_launch_plan(16, 640, 6144, 10752, torch.float32):
            log(f"  fused_moe backward plan (mma.sync), E16 C640 D6144 F10752 f32: {kern.name} "
                f"{kern.layout} grid {kern.grid}, {kern.stages} stages, {kern.smem} shared bytes")
        for kern in moe_k.wgmma_plan(16, 640, 6144, 10752):
            log(f"  fused_moe backward plan (wgmma), E16 C640 D6144 F10752 bf16: {kern.name} "
                f"{kern.layout} tiles an expert {kern.tiles}, {kern.ctas} persistent CTAs, "
                f"{kern.stages} stages, staged output {kern.staged}, {kern.smem} shared bytes")
        wgmma_sass("fused_moe_bwd_wgmma", moe_k.WGMMA_SOURCES)
        for kern in moe_k.tf32_plan(16, 256, 6144, 10752):
            log(f"  fused_moe backward plan (3xTF32 wgmma), E16 C256 D6144 F10752 f32: "
                f"{kern.name} A {kern.layout}-major, tiles {kern.tile}, an expert {kern.tiles}, "
                f"{kern.ctas} persistent CTAs, {kern.stages} stages, {kern.smem} shared bytes")
        wgmma_sass("fused_moe_bwd_tf32", moe_k.TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
        for kern in moe_k.fwd_wgmma_plan(16, 512, 6144, 10752):
            log(f"  fused_moe forward plan (wgmma), E16 C512 D6144 F10752 bf16: {kern.name} "
                f"tiles {kern.tile}, {kern.tiles_e} an expert, {kern.ctas} persistent CTAs, "
                f"K {kern.k}, {kern.stages} stages, {kern.smem} shared bytes")
        wgmma_sass("fused_moe_wgmma", moe_k.FWD_WGMMA_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))
        for kern in moe_k.tf32_fwd_plan(16, 256, 6144, 10752):
            log(f"  fused_moe forward plan (3xTF32 wgmma), E16 C256 D6144 F10752 f32: {kern.name} "
                f"(M, N, K) {kern.products}, tiles {kern.tile}, {kern.tiles_e} an expert, "
                f"{kern.ctas} persistent CTAs, {kern.stages} stages, {kern.smem} shared bytes")
        wgmma_sass("fused_moe_tf32", moe_k.FWD_TF32_SOURCES, ("HGMMA", "UTMALDG", "SYNCS"))


def smm_ptxas_report(smm_k):
    """Phase 1's record of scaled_mm's wgmma engine: ptxas's registers and
    spills of each instance (none may spill), no C7515, C7519 or C7520
    note, its SASS held to IGMMA, UTMALDG and SYNCS, and its plan at
    dbrx-132b width and the tuner's default workload."""
    import re

    from repro_torch.kernels._build import build_log

    notes = serialization_notes("scaled_mm_wgmma", smm_k.WGMMA_SOURCES)
    assert not any(notes.values()), (
        f"scaled_mm_wgmma: ptxas serialized its wgmma or injected arrives: {notes}")
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    kernel, spills = None, []
    for line in build_log("scaled_mm_wgmma", smm_k.WGMMA_SOURCES).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.search(r"smm_wgmmaILi(\d+)E(f|13__nv_bfloat16|6__half)E", m.group(1))
            kernel = f"smm_wgmma<{name.group(1)}, {types[name.group(2)]}>" if name else None
        elif kernel and ("spill" in line or "Used" in line):
            log(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill and spill.groups() != ("0", "0"):
                spills.append(kernel)
    assert not spills, f"scaled_mm_wgmma instances that spill: {spills}"
    for M, K, N in ((1024, 6144, 10752), (1024, 512, 512)):
        for blocks in ({}, dict(block_m=512, block_n=512, block_k=512),
                       dict(block_m=128, block_n=128, block_k=32)):
            p = smm_k.wgmma_plan(M, K, N, **blocks)
            log(f"  scaled_mm plan (wgmma), M{M} K{K} N{N} {blocks or 'default blocks'}: grid "
                f"{p.grid}, {p.ctas} CTAs of {p.threads} threads, sub-tiles {p.sub_tiles} of "
                f"{p.tile}, stages {p.stages} of {p.stage_k} k, {p.smem_bytes} shared bytes")
    wgmma_sass("scaled_mm_wgmma", smm_k.WGMMA_SOURCES, ("IGMMA", "UTMALDG", "SYNCS"))


# ======================================================================
# phase 2: each kernel against its plain version on the card
# ======================================================================


def kernel_parity(torch, dev):
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref

    rng = np.random.default_rng(SEED)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    def check(label, kname, fn, ref, dtype, main, per_row=False):
        """``fn()`` within the reference's tolerance, and bit-equal when run
        again over poisoned memory; with ``per_row``, also each output row
        within BF16_TOL of its own max|ref| plus one bf16 ulp of it, which
        holds long rows (outputs far below 1) to their scale."""
        out = fn()
        torch.cuda.synchronize()
        same_after_poison(torch, kname, label, fn, out)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = F32_TOL if dtype == f32 else BF16_TOL
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{label}: {m}")
        note = ""
        if per_row:
            scale = ref.float().abs().amax(-1)
            ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
            ratio = diff.amax(-1) / (BF16_TOL * scale + ulp)
            worst = float(ratio.max())
            assert worst <= 1.0, f"{label}: a row is off by {worst:.3g} of its tolerance"
            note = (f"; per row at most {worst:.3g} of {BF16_TOL} x max|ref row| + 1 ulp "
                    f"(median max|ref row| {float(scale.median()):.3g})")
        log(f"  {label}: max abs err {err:.3g} (tol {tol}){note}")
        if main:
            max_err[kname] = max(max_err[kname], err)

    max_err = {"rmsnorm": 0.0, "silu_mul": 0.0, "flash_attention": 0.0,
               "flash_attention_wgmma": 0.0, "flash_attention_tf32": 0.0}
    for shape, xd, wd, main in [
        ((8192, 1024), bf16, f32, True), ((8192, 1024), bf16, bf16, True),
        ((8192 * 16, 128), bf16, bf16, True), ((8192, 1024), f32, f32, False),
        ((2, 7, 48), f32, f32, False), ((2, 7, 48), bf16, bf16, False),
    ]:
        x, w = randn(shape, xd), randn(shape[-1:], wd, 0.1)
        check(f"rmsnorm {shape} x={xd} w={wd}", "rmsnorm", lambda: rmsnorm_cuda(x, w),
              rmsnorm_ref(x, w), xd, main)
    for shape, dt, main, acts in [((8192, 3072), bf16, True, ("silu", "geglu")),
                                  ((8192, 3072), f32, False, ("silu", "geglu")),
                                  ((4, 32, 64), f32, False, ("silu", "geglu")),
                                  ((4608, 9216), bf16, True, ("geglu",))]:  # gemma2-2b prefill
        for act in acts:
            g, u = randn(shape, dt, 3.0), randn(shape, dt)
            check(f"silu_mul {shape} {act} {dt}", "silu_mul",
                  lambda: silu_mul_cuda(g, u, act=act),
                  silu_mul_ref(g, u, act=act), dt, main and (act == "silu" or shape[1] == 9216))
    fa_cases = [(*c, 0) for c in [
        # (B, S, Skv, Hq, Hkv, D, causal, window, softcap, dtype, main path),
        # then q_offset; an f32 case is its engine's main path where phases
        # 3, 9 and 10 (a) run its shape (3xTF32 at 64, 80 and 128; the FMA
        # engine at 256: gemma2-2b's)
        (4, 2048, 2048, 16, 8, 128, True, None, None, bf16, True),
        (2, 256, 256, 16, 8, 128, True, None, None, f32, True),  # qwen3's phase 10 (a)
        (2, 256, 256, 32, 32, 80, True, None, None, f32, True),  # stablelm-3b's
        (1, 128, 128, 48, 8, 128, True, None, None, f32, True),  # dbrx-132b's
        (1, 256, 256, 8, 4, 256, True, 4096, 50.0, f32, True),  # gemma2-2b's (FMA)
        (2, 512, 512, 16, 8, 128, True, None, None, f32, True),  # the tuner's
        (4, 2048, 2048, 16, 8, 128, True, None, None, f32, False),
        (1, 1000, 1000, 16, 8, 128, True, None, None, bf16, True),
        (2, 512, 512, 16, 8, 128, True, 256, None, bf16, False),
        (2, 512, 512, 16, 8, 128, True, None, 50.0, bf16, False),
        (2, 512, 512, 16, 8, 128, False, None, None, bf16, False),
        (1, 32, 128, 2, 2, 16, False, None, None, f32, False),
        (1, 64, 64, 2, 2, 16, True, None, None, f32, False),  # queue C's intermittent case
        (1, 64, 64, 2, 1, 16, True, 32, None, f32, False),
        (2, 128, 128, 4, 2, 32, True, None, None, f32, False),
        # rows q >= Skv + window - 1 see no key and average v over every key
        (1, 200, 50, 2, 1, 64, False, 10, None, bf16, False),
        (1, 200, 50, 2, 1, 64, True, 10, None, f32, False),
        # the remaining families (phase 9): gemma2-2b's prefill, a 4608-token
        # prompt that the 4096 window cuts, softcap 50, head dim 256;
        # whisper-base's encoder and its cross attention over 1500 frames;
        # llama-3.2-vision's cross attention over 1601 patches; stablelm-3b's
        # head dim 80; hymba-1.5b's global layer (1400 tokens and 128 meta
        # tokens, 25/5 heads of 64)
        (1, 4608, 4608, 8, 4, 256, True, 4096, 50.0, bf16, True),
        (1, 4608, 4608, 8, 4, 256, True, 4096, 50.0, f32, False),
        (1, 1500, 1500, 8, 8, 64, False, None, None, bf16, True),
        (1, 1500, 1500, 8, 8, 64, False, None, None, f32, True),
        (1, 64, 1500, 8, 8, 64, False, None, None, bf16, True),
        (1, 512, 1601, 32, 8, 128, False, None, None, bf16, True),
        (1, 2048, 2048, 32, 32, 80, True, None, None, bf16, True),
        (1, 2048, 2048, 32, 32, 80, True, None, None, f32, False),
        (1, 1528, 1528, 25, 5, 64, True, None, None, bf16, True),
        # head dim 64 on the wgmma engine: ragged GQA, a window with a
        # softcap, more keys than rows with both
        (2, 300, 300, 8, 2, 64, True, None, None, bf16, False),
        (1, 130, 130, 2, 1, 64, True, 64, 50.0, bf16, False),
        (1, 77, 200, 4, 1, 64, False, 50, 20.0, bf16, False),
    ]] + [
        # query offsets (a rank's block of rows) at head dim 64
        (1, 64, 192, 4, 2, 64, True, None, None, bf16, False, 64),
        (1, 130, 200, 2, 1, 64, False, 64, None, bf16, False, 40),
    ]
    # each case on the engine fwd_engine picks (the wgmma engine for bf16 at
    # head dims 64, 80, 128 and 256, the 3xTF32 engine for f32 at 64, 80 and
    # 128: its lse too; then the mma.sync engine on the same inputs, whose
    # main path is f32 at 256), the other engines' counts not moving
    counts = {e: EngineCount(fa_k, a) for e, a in (
        ("wgmma", "wgmma_launches"), ("tf32", "tf32_launches"), ("mma_sync", "launches"))}
    for B, S, Skv, Hq, Hkv, D, causal, window, softcap, dt, main, off in fa_cases:
        q, k, v = randn((B, S, Hq, D), dt), randn((B, Skv, Hkv, D), dt), randn((B, Skv, Hkv, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        ref = attention_ref(q, k, v, **kw)
        engine = fa_k.fwd_engine(dt, D)
        label = (f"flash_attention B{B} S{S} Skv{Skv} H{Hq}/{Hkv} D{D} causal={causal} "
                 f"window={window} softcap={softcap} q_offset={off} {dt}")
        n0 = {e: c.launches for e, c in counts.items()}
        check(f"{label} ({engine})", FA_FWD_COUNT[engine],
              lambda: flash_attention_cuda(q, k, v, **kw), ref, dt, main, per_row=main)
        assert {e: c.launches - n0[e] for e, c in counts.items()} == {
            e: 2 * (e == engine) for e in counts}, label
        if engine != "mma_sync":
            lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)[1]
            want = lse_ref(q, k, v, **kw)
            fin = torch.isfinite(want)
            assert torch.equal(fin, torch.isfinite(lse)), f"{label}: lse's -inf rows differ"
            lerr = float((lse[fin] - want[fin]).abs().max())
            ltol = BF16_TOL if dt == bf16 else F32_TOL * (1 + float(want[fin].abs().max()))
            assert lerr <= ltol, f"{label}: lse off by {lerr:.3g}"
            log(f"  {label} ({engine}) lse: max abs err {lerr:.3g} (tol {ltol:.3g})")
            check(f"{label} (mma_sync)", "flash_attention",
                  lambda: fa_k.flash_attention_mma_sync_cuda(q, k, v, **kw), ref, dt, False,
                  per_row=main)
        del q, k, v, ref
    # the block knobs' corners at the main shape: each launches the grid it
    # names, on the wgmma engine
    B, S, Hq, Hkv, D = 4, 2048, 16, 8, 128
    q, k, v = randn((B, S, Hq, D), bf16), randn((B, S, Hkv, D), bf16), randn((B, S, Hkv, D), bf16)
    ref = attention_ref(q, k, v, causal=True)
    for bq, bk in ((32, 32), (32, 512), (512, 32), (512, 512), (64, 256)):
        check(f"flash_attention main shape blocks ({bq}, {bk}) (wgmma)", "flash_attention_wgmma",
              lambda: flash_attention_cuda(q, k, v, causal=True, block_q=bq, block_k=bk), ref,
              bf16, True, per_row=True)
        assert fa_k.last_grid == fa_ops.grid_shape(B, S, S, Hq, Hkv, D, block_q=bq, block_k=bk)
    return max_err


def tuner_kernel_parity(torch, dev):
    """Fused MoE and scaled_mm against their plain versions: the reference's
    test cases, every config the tuner's prefilter passes on its default
    workloads (on the tuner's own inputs), and dbrx-132b width."""
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe import ops as moe_ops
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.scaled_mm import ops as smm_ops
    from repro_torch.kernels.scaled_mm.ref import quantize_rowwise, scaled_mm_acc_ref, scaled_mm_ref
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref as fa_ref
    from repro_torch.kernels.silu_mul import kernel as silu_k
    from repro_torch.kernels.silu_mul import ops as silu_ops
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref as silu_ref
    from repro_torch.tune import (DEFAULT_WORKLOADS, arch_workload, enumerate_candidates,
                                  make_inputs, prefilter)
    from repro_torch.tune.space import kernel_entry

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = {"fused_moe": 0.0, "fused_moe_wgmma": 0.0, "fused_moe_tf32": 0.0, "scaled_mm": 0.0,
               "scaled_mm_wgmma": 0.0}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    def moe(label, kw, blocks, args, rel_tol=None, main=False):
        """One launch against the plain version: within the reference's
        tolerances, or within ``rel_tol`` of max|ref| where given; on a
        wgmma engine (``fwd_engine``) also against the mma.sync engine's
        output on the same inputs (bf16 2e-2, f32 2e-5 of max|ref|), and on
        the 3xTF32 one against the plain version run in float64 (1e-5 of
        max|ref|). The mma.sync engine's error at the main shapes is its
        own, from that run."""
        E, C, D, F = (kw[k] for k in "ECDF")
        engine = moe_k.fwd_engine(args[0].dtype, C, D, F, block_f=blocks.get("block_f", 256))
        kname = MOE_FWD_COUNT[engine]
        counts = {e: getattr(moe_k, a) for e, a in (("wgmma", "wgmma_launches"),
                                                    ("wgmma_tf32", "tf32_launches"),
                                                    ("mma_sync", "launches"))}
        out = moe_k.fused_moe_cuda(*args, **blocks)
        assert all(getattr(moe_k, a) == counts[e] + (e == engine)
                   for e, a in (("wgmma", "wgmma_launches"), ("wgmma_tf32", "tf32_launches"),
                                ("mma_sync", "launches"))), (label, engine)
        assert moe_k.last_grid == moe_ops.grid_shape(**kw, **blocks), (label, moe_k.last_grid)
        same_after_poison(torch, kname, label,
                          lambda: moe_k.fused_moe_cuda(*args, **blocks), out)
        ref = fused_moe_ref(*args)
        torch.cuda.synchronize()
        assert out.dtype == args[0].dtype and bool(torch.isfinite(out).all()), label
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if engine != "mma_sync":
            old = moe_k.fused_moe_mma_sync_cuda(*args, **blocks)
            gap = float((out.float() - old.float()).abs().max())
            tol = F32_TOL if engine == "wgmma_tf32" else BF16_TOL
            log(f"  {label}: {engine} engine, {gap / scale:.3g} of max|ref| from the mma.sync "
                f"engine's output (tol {tol})")
            assert gap <= tol * scale, f"{label}: {engine} and mma.sync engines disagree"
            if main and engine == "wgmma_tf32":
                max_err["fused_moe"] = max(max_err["fused_moe"],
                                           float((old - ref).abs().max()))
            del old
        if engine == "wgmma_tf32":
            exact = fused_moe_ref(*(a.double() for a in args))
            e64 = float((out.double() - exact).abs().max()) / float(exact.abs().max())
            log(f"  {label}: {e64:.3g} of max|float64 ref| (tol {TF32_F64_TOL})")
            assert e64 <= TF32_F64_TOL, f"{label}: the 3xTF32 engine is off float64"
            del exact
        if rel_tol is None:
            tol = F32_TOL if out.dtype == f32 else BF16_TOL
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{label}: {m}")
            log(f"  {label}: max abs err {err:.3g} (tol {tol})")
        else:
            log(f"  {label}: max abs err {err:.3g} = {err / scale:.3g} of max|ref| {scale:.4g} "
                f"(tol {rel_tol} of it)")
            assert err <= rel_tol * scale, f"{label}: card and plain version disagree"
        if main:
            max_err[kname] = max(max_err[kname], err)

    def smm(label, kw, blocks, args, main=False):
        """One launch on the engine ``engine`` picks against the plain
        version; the int32 sum is read through unit scales into f32, exact
        while |acc| < 2**24; the wgmma engine's bf16 output must equal the
        plain version's bit for bit."""
        x, w, sx, sw = args
        eng = smm_k.engine(**kw, **blocks)
        counts = (smm_k.wgmma_launches, smm_k.launches)
        out = smm_k.scaled_mm_cuda(x, w, sx, sw, **blocks)
        moved = (smm_k.wgmma_launches - counts[0], smm_k.launches - counts[1])
        assert moved == ((1, 0) if eng == "wgmma" else (0, 1)), (label, eng, moved)
        assert smm_k.last_grid == smm_ops.grid_shape(**kw, **blocks), (label, smm_k.last_grid)
        same_after_poison(torch, "scaled_mm_wgmma" if eng == "wgmma" else "scaled_mm", label,
                          lambda: smm_k.scaled_mm_cuda(x, w, sx, sw, **blocks), out)
        unit = smm_k.scaled_mm_cuda(x, w, torch.ones_like(sx), torch.ones_like(sw),
                                    out_dtype=f32, **blocks)
        acc = scaled_mm_acc_ref(x, w)
        ref = scaled_mm_ref(x, w, sx, sw)
        torch.cuda.synchronize()
        assert int(acc.abs().max()) < 2**24 and torch.equal(unit, acc.float()), f"{label}: int32 sum"
        err = float((out.float() - ref.float()).abs().max())
        torch.testing.assert_close(out.float(), ref.float(), rtol=SMM_TOL, atol=SMM_TOL,
                                   msg=lambda m: f"{label}: {m}")
        same = torch.equal(out, ref)
        assert same or eng != "wgmma", f"{label}: the wgmma engine's bf16 output is not the plain one"
        kname = "scaled_mm_wgmma" if eng == "wgmma" else "scaled_mm"
        if main:
            max_err[kname] = max(max_err[kname], err)
        return same, err

    # the reference's cases (tests/test_kernels.py), f32 and bf16
    for E, C, D, F, bm, bf in [(4, 32, 64, 128, 16, 64), (2, 64, 32, 64, 32, 32),
                               (8, 16, 48, 96, 16, 96), (3, 100, 200, 300, 50, 150)]:
        for dt in (f32, bf16):
            args = (randn((E, C, D), dt, 0.5), randn((E, D, F), dt, 0.1),
                    randn((E, D, F), dt, 0.1), randn((E, F, D), dt, 0.1))
            moe(f"fused_moe E{E} C{C} D{D} F{F} bm{bm} bf{bf} {dt}", dict(E=E, C=C, D=D, F=F),
                dict(block_m=bm, block_f=bf), args)
    for M, K, N in [(64, 128, 96), (128, 64, 128)]:
        x, sx = quantize_rowwise(randn((M, K), f32))
        wq, sw = quantize_rowwise(randn((N, K), f32))
        for bm, bn, bk in [(32, 32, 64), (64, 64, 32)]:
            same, err = smm(f"scaled_mm M{M} K{K} N{N}", dict(M=M, K=K, N=N),
                            dict(block_m=bm, block_n=bn, block_k=bk), (x, wq.t().contiguous(), sx, sw))
            log(f"  scaled_mm M{M} K{K} N{N} blocks ({bm}, {bn}, {bk}), wgmma: int32 sum "
                f"exact, max abs err {err:.3g} (tol {SMM_TOL}), bf16 output bit-equal: {same}")
    # rows or blocks that are not 16-byte multiples: the mma.sync engine
    # stages them byte by byte; then the wgmma engine at the nearest shapes
    # it takes (N 48 with 24-wide blocks; K 96 and N 16 with blocks of 1 x 4 x 32)
    for unaligned, nearest in [((64, 96, 50, 32, 25, 32), (64, 96, 48, 32, 25, 32)),
                               ((7, 100, 13, 3, 5, 7), (7, 96, 16, 3, 5, 32))]:
        for (M, K, N, bm, bn, bk), eng in ((unaligned, "mma_sync"), (nearest, "wgmma")):
            x, sx = quantize_rowwise(randn((M, K), f32))
            wq, sw = quantize_rowwise(randn((N, K), f32))
            blocks = dict(block_m=bm, block_n=bn, block_k=bk)
            assert smm_k.engine(M, K, N, **blocks) == eng, (M, K, N, blocks)
            assert eng == "wgmma" or not smm_k.launch_plan(M, K, N, **blocks).vectorized
            same, err = smm(f"scaled_mm M{M} K{K} N{N}", dict(M=M, K=K, N=N), blocks,
                            (x, wq.t().contiguous(), sx, sw))
            log(f"  scaled_mm M{M} K{K} N{N} blocks ({bm}, {bn}, {bk}), {eng}: int32 sum exact, "
                f"max abs err {err:.3g} (tol {SMM_TOL}), bf16 output bit-equal: {same}")

    # the tuner's default workloads, every config its prefilter passes
    for kernel in ("fused_moe", "scaled_mm"):
        kw = DEFAULT_WORKLOADS[kernel]
        survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
        args = make_inputs(kernel, kw, device="cuda")
        equal, worst = 0, 0.0
        for c in survivors:
            label = f"{kernel} {kw} {c.blocks}"
            if kernel == "fused_moe":
                moe(label, kw, c.blocks, args, rel_tol=MOE_F32_TOL, main=True)
            else:
                same, err = smm(label, kw, c.blocks, args, main=True)
                equal, worst = equal + same, max(worst, err)
        if kernel == "scaled_mm":
            assert all(smm_k.engine(**kw, **c.blocks) == "wgmma" for c in survivors)
            log(f"  scaled_mm {kw}: {len(survivors)} configs on the wgmma engine, int32 sums "
                f"exact, max abs err {worst:.3g}, bf16 output bit-equal in {equal} of "
                f"{len(survivors)}")
        del args
    # the bf16 tensor-core path at the default workload's lattice corners
    kw = DEFAULT_WORKLOADS["fused_moe"]
    E, C, D, F = (kw[k] for k in "ECDF")
    args = (randn((E, C, D), bf16, 0.5), randn((E, D, F), bf16, 0.1),
            randn((E, D, F), bf16, 0.1), randn((E, F, D), bf16, 0.1))
    for blocks in ({}, dict(block_m=32, block_f=32), dict(block_m=512, block_f=512)):
        moe(f"fused_moe {kw} {blocks or 'default blocks'} bf16", kw, blocks, args, main=True)
    # flash attention and silu_mul on the tuner's inputs at their qwen3-0.6b
    # workloads: every config the prefilter passes launches its grid_shape
    for kernel, mod, ops in (("flash_attention", fa_k, fa_ops), ("silu_mul", silu_k, silu_ops)):
        kw = arch_workload(kernel, "qwen3-0.6b")
        survivors, _ = prefilter(kernel, kw, enumerate_candidates(kernel))
        args = make_inputs(kernel, kw, device="cuda")
        ref = fa_ref(*args) if kernel == "flash_attention" else silu_ref(*args)
        worst = 0.0
        kname = kernel
        if kernel == "flash_attention":  # the tuner's f32 inputs: the 3xTF32 engine
            assert mod.fwd_engine(args[0].dtype, kw["D"]) == "tf32"
            kname = "flash_attention_tf32"
        for c in survivors:
            out = kernel_entry(kernel)(*args, **c.blocks)
            assert mod.last_grid == ops.grid_shape(**kw, **c.blocks), (kernel, c.blocks)
            same_after_poison(torch, kname, f"{kernel} {kw} {c.blocks}",
                              lambda: kernel_entry(kernel)(*args, **c.blocks), out)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, rtol=F32_TOL, atol=F32_TOL,
                                       msg=lambda m: f"{kernel} {kw} {c.blocks}: {m}")
            worst = max(worst, float((out - ref).abs().max()))
        log(f"  {kernel} {kw}: {len(survivors)} configs, each its grid_shape, max abs err "
            f"{worst:.3g} (tol {F32_TOL})")
        del args

    # dbrx-132b width: the default blocks and two others
    kw = arch_workload("fused_moe", "dbrx-132b")
    E, C, D, F = (kw[k] for k in "ECDF")
    for dt in (f32, bf16):
        args = (randn((E, C, D), dt), randn((E, D, F), dt, D ** -0.5),
                randn((E, D, F), dt, D ** -0.5), randn((E, F, D), dt, F ** -0.5))
        for blocks in ({}, dict(block_m=512, block_f=512), dict(block_m=32, block_f=64)):
            moe(f"fused_moe {kw} {blocks or 'default blocks'} {dt}", kw, blocks, args,
                rel_tol=MOE_F32_TOL if dt == f32 else BF16_TOL, main=True)
        del args
        torch.cuda.empty_cache()
    # the forward wgmma engine: ragged C, D and F, one and two consumer
    # warpgroups, row blocks in sub-tiles, F blocks cut inside a tile or
    # spanning several; then dbrx-132b's width at its 1024-token prefill
    # (512 rows an expert) and its training layer (640)
    for E, C, D, F, bm, bf in [(3, 200, 520, 776, 100, 776), (2, 192, 136, 264, 64, 88),
                               (2, 384, 200, 328, 192, 8), (4, 256, 256, 512, 128, 64),
                               (16, 512, 6144, 10752, 128, 256), (16, 640, 6144, 10752, 128, 256)]:
        args = (randn((E, C, D), bf16), randn((E, D, F), bf16, D ** -0.5),
                randn((E, D, F), bf16, D ** -0.5), randn((E, F, D), bf16, F ** -0.5))
        moe(f"fused_moe E{E} C{C} D{D} F{F} bm{bm} bf{bf} bf16", dict(E=E, C=C, D=D, F=F),
            dict(block_m=bm, block_f=bf), args, rel_tol=BF16_TOL, main=C >= 512)
        del args
    torch.cuda.empty_cache()
    kw = arch_workload("scaled_mm", "dbrx-132b")
    args = make_inputs("scaled_mm", kw, device="cuda")
    for blocks in ({}, dict(block_m=512, block_n=512, block_k=512),
                   dict(block_m=32, block_n=64, block_k=32),
                   dict(block_m=128, block_n=128, block_k=32)):
        same, err = smm(f"scaled_mm {kw} {blocks}", kw, blocks, args, main=True)
        log(f"  scaled_mm {kw} {blocks or 'default blocks'}, wgmma: int32 sum exact, max abs err "
            f"{err:.3g} (tol {SMM_TOL}), bf16 output bit-equal: {same}")
    # the mma.sync engine on the same inputs at the default blocks, the
    # shape phase 5 times it at: its own error, and its output against the
    # wgmma engine's
    out = smm_k.scaled_mm_wgmma_cuda(*args)
    old = smm_k.scaled_mm_mma_sync_cuda(*args)
    ref = scaled_mm_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(old.float(), ref.float(), rtol=SMM_TOL, atol=SMM_TOL)
    max_err["scaled_mm"] = max(max_err["scaled_mm"],
                               float((old.float() - ref.float()).abs().max()))
    log(f"  scaled_mm {kw} default blocks, mma.sync: max abs err {max_err['scaled_mm']:.3g}, "
        f"bit-equal to the plain version: {torch.equal(old, ref)}, to the wgmma engine: "
        f"{torch.equal(old, out)}")
    return max_err


def moe_serving_parity(torch, dev, max_err):
    """Fused MoE in bf16 at dbrx-132b's serving shapes, through the model's
    ``expert_ffn`` (which pads the rows to a multiple of ``block_m``),
    against the plain version on the unpadded rows: a decode tick of 4 slots
    and the admission prefill of a prime-length prompt."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.models.moe import EXPERT_BLOCK_M, dispatch_geometry, expert_ffn

    cfg = get_arch("dbrx-132b")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_hidden
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(bf16)

    w = (randn((E, D, F), D ** -0.5), randn((E, D, F), D ** -0.5), randn((E, F, D), F ** -0.5))
    for label, tokens in (("decode tick, 4 slots", 4), ("prefill of a 2003-token prompt", 2003)):
        G, Sg, C = dispatch_geometry(cfg, tokens, train=False)
        rows = G * C
        x = randn((E, rows, D))
        w0 = moe_k.wgmma_launches
        out = expert_ffn(x, *w)
        kname = "fused_moe_wgmma" if moe_k.wgmma_launches > w0 else "fused_moe"
        grid = moe_k.last_grid
        same_after_poison(torch, kname, f"fused_moe dbrx {label}",
                          lambda: expert_ffn(x, *w), out)
        ref = fused_moe_ref(x, *w)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all()), label
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        bm = min(EXPERT_BLOCK_M, rows)
        log(f"  fused_moe dbrx {label}: (G, Sg, C) = {(G, Sg, C)}, {rows} rows an expert, "
            f"padded to {-(-rows // bm) * bm} for block_m {bm}, launched grid {grid} on "
            f"{kname}; max abs "
            f"err {err:.3g} = {err / scale:.3g} of max|ref| {scale:.4g} (tol {BF16_TOL} of it)")
        assert err <= BF16_TOL * scale, f"fused_moe dbrx {label}: card and plain version disagree"
        max_err[kname] = max(max_err[kname], err)
        del x, out, ref
    del w
    torch.cuda.empty_cache()


def backward_parity(torch, dev):
    """The four backward kernels against their plain backward formulas
    (``ref.py``) on the same inputs: each gradient within F32_TOL / BF16_TOL
    of its max|ref|, at qwen3-0.6b's training shapes (B4 S2048: 8192 rows
    of d 1024 and d_ff 3072, 131072 q-norm and 65536 k-norm rows of 128,
    16/8 heads of 128), stablelm-3b's (B1 S2048, 32/32 heads of 80),
    gemma2-2b's (head dim 256), the reference's kernel test shapes, and
    fused MoE's at dbrx-132b's and arctic-480b's widths; each kernel run
    twice gives the same bits (no float atomics). Returns the max abs err
    at the training shapes."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    from repro_torch.kernels.fused_moe.kernel import fused_moe_bwd_cuda
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_bwd_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_bwd_ref

    rng = np.random.default_rng(SEED + 7)
    f32, bf16 = torch.float32, torch.bfloat16
    max_err = {"rmsnorm_bwd": 0.0, "silu_mul_bwd": 0.0, "flash_attention_bwd": 0.0,
               "flash_attention_bwd_wgmma": 0.0, "flash_attention_bwd_tf32": 0.0,
               "fused_moe_bwd": 0.0,
               "fused_moe_bwd_wgmma": 0.0, "fused_moe_bwd_tf32": 0.0}

    def randn(shape, dtype, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    def check(label, kname, fn, refs, main):
        """Each gradient within the tolerance of its own type, and bit-equal
        when run again over poisoned memory."""
        got = fn()
        torch.cuda.synchronize()
        same_after_poison(torch, kname[0], label, fn, got)
        notes = []
        for name, a, r in zip(kname[1], got, refs):
            tol = F32_TOL if a.dtype == f32 else BF16_TOL
            scale = float(r.float().abs().max())
            err = float((a.float() - r.float()).abs().max())
            assert bool(torch.isfinite(a).all()) and err <= tol * scale, (
                f"{label} {name}: {err:.3g} of max|ref| {scale:.3g} (tol {tol})")
            notes.append(f"{name} {err:.3g} of {scale:.3g} (tol {tol})")
            if main:
                max_err[kname[0]] = max(max_err[kname[0]], err)
        log(f"  {label}: " + ", ".join(notes) + "; bit-equal over poisoned memory")

    rms = ("rmsnorm_bwd", ("dx", "dw"))
    for shape, xd, wd, main in [((8192, 1024), bf16, bf16, True), ((8192, 1024), bf16, f32, True),
                                ((8192 * 16, 128), bf16, bf16, True),
                                ((8192 * 8, 128), bf16, bf16, True),
                                ((8192, 1024), f32, f32, False), ((2, 7, 48), f32, f32, False)]:
        x, w, g = randn(shape, xd), randn(shape[-1:], wd, 0.1), randn(shape, xd)
        check(f"rmsnorm bwd {shape} x={xd} w={wd}", rms, lambda: rmsnorm_bwd_cuda(g, x, w),
              rmsnorm_bwd_ref(g, x, w), main)
    act = ("silu_mul_bwd", ("dg", "du"))
    for shape, dt, main in [((8192, 3072), bf16, True), ((8192, 3072), f32, False),
                            ((4, 32, 64), f32, False)]:
        for a in ("silu", "geglu"):
            g, u, dh = randn(shape, dt, 3.0), randn(shape, dt), randn(shape, dt)
            check(f"silu_mul bwd {shape} {a} {dt}", act,
                  lambda: silu_mul_bwd_cuda(dh, g, u, act=a),
                  silu_mul_bwd_ref(dh, g, u, act=a), main and a == "silu")
    # flash attention's backward on the engine bwd_engine picks: bf16 at head
    # dims 64, 80, 128 and 256 runs the wgmma engine, and is also checked
    # against the mma.sync engine's gradients on the same inputs; the last
    # cases take a query offset (a rank's block of rows under ops.row_split),
    # whose forward is checked against the plain version too; f32 at head
    # dims 80 and 128 runs the 3xTF32 engine, also held to the FMA engine's
    # gradients. The main paths: qwen3's and gemma2's bf16 training (wgmma),
    # the f32 gradient runs of phase 10 (a) (3xTF32 at qwen3-0.6b's,
    # stablelm-3b's and dbrx-132b's shapes; the FMA engine at gemma2-2b's)
    fa_grads = ("dq", "dk", "dv")
    for B, S, Skv, Hq, Hkv, D, causal, window, softcap, dt, main, off in [(*c, 0) for c in [
        (4, 2048, 2048, 16, 8, 128, True, None, None, bf16, True),  # qwen3-0.6b training
        (4, 2048, 2048, 16, 8, 128, True, None, None, f32, True),
        (2, 256, 256, 16, 8, 128, True, None, None, f32, True),  # its phase 10 (a)
        (2, 256, 256, 32, 32, 80, True, None, None, f32, True),  # stablelm-3b's
        (1, 128, 128, 48, 8, 128, True, None, None, f32, True),  # dbrx-132b's
        (1, 256, 256, 8, 4, 256, True, 4096, 50.0, f32, True),  # gemma2-2b's (FMA)
        (2, 130, 130, 4, 2, 80, True, 64, 50.0, f32, False),
        (1, 77, 200, 4, 1, 128, False, 50, 20.0, f32, False),
        # stablelm-3b's training shape on the wgmma engine's head-dim-80
        # instances, also ragged with a window and a softcap, and with more
        # keys than rows; hymba-1.5b's global layer (25/5, causal) and
        # whisper-base's encoder (8/8, no mask) on its head-dim-64 ones,
        # with a window and a softcap, and ragged
        (1, 2048, 2048, 32, 32, 80, True, None, None, bf16, False),
        (2, 130, 130, 4, 2, 80, True, 64, 50.0, bf16, False),
        (1, 77, 200, 4, 1, 80, False, 50, 20.0, bf16, False),
        (1, 1528, 1528, 25, 5, 64, True, None, None, bf16, False),
        (1, 1500, 1500, 8, 8, 64, False, None, None, bf16, False),
        (1, 130, 130, 2, 1, 64, True, 64, 50.0, bf16, False),
        (2, 300, 300, 12, 2, 64, True, None, None, bf16, False),
        (1, 2048, 2048, 32, 32, 80, True, None, None, f32, False),
        (2, 96, 96, 4, 2, 80, True, 64, None, f32, False),  # queue C's head dim 80 case
        (1, 64, 64, 2, 2, 16, True, None, None, f32, False),  # the reference's cases
        (2, 128, 128, 4, 2, 32, True, None, None, f32, False),
        (1, 64, 64, 2, 1, 16, True, 32, None, f32, False),
        (1, 64, 64, 2, 2, 16, True, None, 30.0, f32, False),
        (2, 64, 64, 4, 4, 16, False, None, None, bf16, False),
        (1, 32, 128, 2, 2, 16, False, None, None, bf16, False),
        (2, 512, 512, 16, 8, 128, True, 256, None, bf16, False),
        (2, 512, 512, 16, 8, 128, True, None, 50.0, bf16, False),
        (1, 77, 200, 2, 1, 64, False, 50, 20.0, f32, False),
        (1, 200, 50, 2, 1, 64, False, 10, None, bf16, False),  # rows that see no key
        (1, 200, 50, 2, 1, 64, True, 10, None, f32, False),
        # head dim 256 with gemma2-2b's masks: small, then its training shape
        (2, 200, 200, 4, 2, 256, True, 64, 50.0, f32, False),
        (2, 200, 200, 4, 2, 256, True, 64, 50.0, bf16, False),
        (1, 4096, 4096, 8, 4, 256, True, 4096, 50.0, bf16, True),
        # head dim 256 on the wgmma engine: small, ragged (S 130) without
        # and with each mask, rows that see no key, gemma2's shape unmasked
        (1, 64, 64, 2, 2, 256, True, None, None, bf16, False),
        (2, 130, 130, 4, 2, 256, False, None, None, bf16, False),
        (2, 130, 130, 4, 2, 256, True, None, None, bf16, False),
        (1, 130, 130, 2, 1, 256, True, 64, None, bf16, False),
        (1, 130, 130, 2, 1, 256, False, None, 50.0, bf16, False),
        (1, 200, 50, 2, 1, 256, True, 10, None, bf16, False),
        (1, 4096, 4096, 8, 4, 256, True, None, None, bf16, False),
        # head dim 128 on the wgmma engine: small, ragged (S 130) without and
        # with each mask, rows that see no key, a group of 6, dbrx-132b's
        # training shape (48/8)
        (1, 64, 64, 2, 2, 128, True, None, None, bf16, False),
        (2, 130, 130, 4, 2, 128, False, None, None, bf16, False),
        (2, 130, 130, 4, 2, 128, True, None, None, bf16, False),
        (1, 130, 130, 2, 1, 128, True, 64, None, bf16, False),
        (1, 130, 130, 2, 1, 128, False, None, 50.0, bf16, False),
        (1, 200, 50, 2, 1, 128, True, 10, None, bf16, False),
        (2, 300, 300, 12, 2, 128, True, None, None, bf16, False),
        (1, 2048, 2048, 48, 8, 128, True, None, None, bf16, True),
    ]] + [
        # query offsets (a rank's rows), rows past Skv + window - 1 among them
        (1, 64, 192, 4, 2, 128, True, None, None, bf16, False, 64),
        (1, 100, 200, 4, 2, 64, True, 48, 30.0, f32, False, 60),
        (1, 64, 96, 2, 1, 256, True, 32, 50.0, bf16, False, 100),
        (1, 64, 96, 2, 1, 256, True, 32, 50.0, f32, False, 100),
        (1, 1024, 4096, 8, 4, 256, True, 4096, 50.0, bf16, False, 3072),
        (1, 130, 200, 2, 1, 256, False, 64, None, bf16, False, 40),
        (1, 130, 200, 6, 1, 128, False, 64, None, bf16, False, 40),
        (1, 130, 200, 6, 1, 128, False, 64, None, f32, False, 40),
        (1, 64, 192, 4, 2, 80, True, None, None, f32, False, 64),
        (1, 64, 192, 4, 2, 80, True, None, None, bf16, False, 64),
        (1, 130, 200, 2, 1, 64, False, 64, None, bf16, False, 40),
        (1, 100, 200, 4, 2, 64, True, 48, 30.0, bf16, False, 60),
    ]:
        q, k, v = randn((B, S, Hq, D), dt), randn((B, Skv, Hkv, D), dt), randn((B, Skv, Hkv, D), dt)
        dout = randn((B, S, Hq, D), dt)
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        label = (f"flash_attention bwd B{B} S{S} Skv{Skv} H{Hq}/{Hkv} D{D} causal={causal} "
                 f"window={window} softcap={softcap} q_offset={off} {dt}")
        if off:
            torch.cuda.synchronize()
            ref_out = attention_ref(q, k, v, **kw)
            err = float((out.float() - ref_out.float()).abs().max())
            tol = F32_TOL if dt == f32 else BF16_TOL
            assert err <= tol * float(ref_out.float().abs().max()), f"{label}: forward {err:.3g}"
            same_after_poison(torch, FA_FWD_COUNT[fa_k.fwd_engine(dt, D)], label + " forward",
                              lambda: flash_attention_cuda(q, k, v, **kw), out)
            log(f"  {label}: forward {err:.3g} of max|ref| (tol {tol})")
        refs = attention_bwd_ref(q, k, v, dout, **kw)
        engine = fa_k.bwd_engine(dt, D)
        check(f"{label} ({engine})", (FA_BWD_COUNT[engine], fa_grads),
              lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw), refs, main)
        if engine != "mma_sync":
            new = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
            check(f"{label} (mma_sync)", ("flash_attention_bwd", fa_grads),
                  lambda: fa_k.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw),
                  refs, False)
            old = fa_k.flash_attention_bwd_mma_sync_cuda(q, k, v, out, lse, dout, **kw)
            gaps = [float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                    for a, b in zip(new, old)]
            tol = BF16_TOL if dt == bf16 else F32_TOL
            assert max(gaps) <= tol, f"{label}: {engine} against mma_sync {gaps}"
            log(f"  {label}: {engine} against mma_sync engine, of max|mma_sync|: "
                + ", ".join(f"{n} {g:.3g}" for n, g in zip(fa_grads, gaps)))
            del new, old
        del q, k, v, dout, out, lse, refs
    torch.cuda.empty_cache()

    # fused MoE's backward on the engine bwd_engine picks: small
    # (vectorised and element-by-element rows), ragged 16-byte rows (M, N
    # and K no tile multiples), dbrx-132b's width with 2 experts (640 rows:
    # its training dispatch of 2048 tokens) and arctic-480b's expert width
    # (40 rows); bf16 with 16-byte rows runs the wgmma engine, f32 with
    # 16-byte rows the 3xTF32 wgmma engine (its gradients held to the plain
    # formula run in float64), the 36/44-wide bf16 and 37/45-wide f32 rows
    # the mma.sync engine. The main paths: dbrx's bf16 training (wgmma) and
    # its f32 gradients (phase 10 (a), 3xTF32 wgmma). No model path reaches
    # the mma.sync engine; its recorded error is its own run on dbrx's bf16
    # inputs, the shape phase 5 times it at
    from repro_torch.kernels.fused_moe.kernel import bwd_engine, fused_moe_bwd_mma_sync_cuda

    grads = ("dx", "dw_gate", "dw_up", "dw_down")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)  # drawn on the card: 400 M values

    def drawn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    knames = {"wgmma": "fused_moe_bwd_wgmma", "wgmma_tf32": "fused_moe_bwd_tf32",
              "mma_sync": "fused_moe_bwd"}
    for E, C, D, F, dt, main in [
        (2, 64, 48, 96, f32, False), (2, 64, 48, 96, bf16, False),
        (3, 20, 36, 44, f32, False), (3, 20, 36, 44, bf16, False), (3, 20, 37, 45, f32, False),
        (3, 200, 520, 776, bf16, False), (3, 200, 520, 776, f32, False), (1, 1, 8, 8, f32, False),
        (2, 640, 6144, 10752, bf16, True), (2, 640, 6144, 10752, f32, True),
        (2, 40, 7168, 4864, bf16, False), (2, 40, 7168, 4864, f32, False),
    ]:
        x, dy = drawn((E, C, D), dt), drawn((E, C, D), dt)
        ws = [drawn(s, dt, 1.0 / np.sqrt(s[1])) for s in ((E, D, F), (E, D, F), (E, F, D))]
        engine = bwd_engine(dt, D, F)
        refs = fused_moe_bwd_ref(*(t.double() if dt == f32 else t for t in (x, *ws, dy)))
        check(f"fused_moe bwd E{E} C{C} D{D} F{F} {dt} ({engine})", (knames[engine], grads),
              lambda: fused_moe_bwd_cuda(x, *ws, dy), refs, main)
        if main and engine == "wgmma":
            check(f"fused_moe bwd E{E} C{C} D{D} F{F} {dt} (mma_sync)", ("fused_moe_bwd", grads),
                  lambda: fused_moe_bwd_mma_sync_cuda(x, *ws, dy), refs, True)
        del x, dy, ws, refs
    torch.cuda.empty_cache()
    log("  reruns over NaN-filled free memory, bit-equal, by kernel: "
        + ", ".join(f"{k} {n}" for k, n in sorted(poison_checks.items())))
    return max_err


# ======================================================================
# phase 3: full-width model on the card against the CPU
# ======================================================================


def model_parity(torch, dev, arch, n_layers=None, prompt_len=64):
    """``arch`` at full width (depth cut to ``n_layers`` where given), f32
    compute, on the card against the CPU with the same weights: prefill of
    a ``prompt_len``-token prompt (with frames or image embeds drawn with
    numpy where the family takes them) and 8 greedy decode steps. Returns
    the card's parameters. llama-vision's cross-attention gates, zero at
    init, are set to 0.5 so that its cross layers reach the logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model, materialize_batch

    cfg = dataclasses.replace(get_arch(arch), compute_dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gpu, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = gpu.init(SEED)
    if cfg.family == "vlm":
        for group in params["segments"][0]:
            for gate in ("gate_attn", "gate_ffn"):
                group["cross"][gate].fill_(0.5)
    n = sum(p.numel() for p in params.parameters())
    log(f"  {arch} full width, {cfg.n_layers} layers: {n / 1e9:.3f}B parameters, f32 compute, "
        f"{prompt_len}-token prompt")
    params_cpu = T.Tree(T.tree_map(lambda a: a.detach().cpu(), params))
    batch = materialize_batch(cfg, 1, prompt_len, seed=SEED, device="cpu")

    def greedy(logits):
        return logits[:, : cfg.vocab_size].argmax(-1)

    def run(api, p, device, forced=None):
        with torch.no_grad():
            logits, caches = api.prefill(p, {k: v.to(device) for k, v in batch.items()})
            caches = T.pad_cache(caches, cfg, prompt_len + 8)
            steps = [logits.float().cpu()]
            for i in range(8):
                tok = forced[i] if forced is not None else greedy(steps[-1])
                pos = torch.full((1,), prompt_len + i, device=device)
                logits, caches = api.decode(p, caches, tok.to(device), pos)
                steps.append(logits.float().cpu())
        return steps

    t0 = time.perf_counter()
    on_gpu = run(gpu, params, dev)
    t1 = time.perf_counter()
    forced = [greedy(s) for s in on_gpu[:-1]]  # the CPU follows the card's tokens
    on_cpu = run(cpu, params_cpu, "cpu", forced)
    log(f"  {arch}: card {t1 - t0:.1f}s, CPU {time.perf_counter() - t1:.1f}s")
    for i, (a, b) in enumerate(zip(on_gpu, on_cpu)):
        assert torch.isfinite(a).all() and a.shape == (1, cfg.padded_vocab)
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        what = "prefill" if i == 0 else f"decode {i}"
        log(f"  {what}: max|logit| {scale:.4g}, max abs diff {err:.3g} "
            f"(tol {MODEL_TOL} x {scale:.4g})")
        assert err <= MODEL_TOL * scale, f"{what}: card and CPU logits disagree"
        ta, tb = int(greedy(a)), int(greedy(b))
        if ta != tb:
            top2 = b[0, : cfg.vocab_size].topk(2).values
            gap = float(top2[0] - top2[1])
            log(f"  {what}: greedy tokens differ ({ta} vs {tb}); CPU top-2 gap {gap:.3g}")
            assert gap <= 2 * MODEL_TOL * scale, f"{what}: greedy tokens differ beyond a tie"
    log(f"  {arch} greedy tokens on the card: {[int(greedy(s)) for s in on_gpu]}")
    del params_cpu
    return params


# ======================================================================
# phase 4: the main path, serving at full width
# ======================================================================


def serve_run(torch, kinds, label, eng, prompts, max_new, per_forward, per_prefill, *,
              predictor=None, results_out=None):
    """Serve ``prompts`` through ``eng`` (its recorder a ``TraceRecorder``)
    with the launch counts set to 0 before and read after; checks that
    every step was recorded and stamped, that each step's ``StepMeta``
    re-lowers to exactly its recorded calls, and that the counts moved by
    exactly ``per_forward`` a step and ``per_prefill`` a prefill. Returns
    the launches; the results are appended to ``results_out`` if given."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.monitor import trace_residuals
    from repro_torch.serve.trace import step_calls

    cfg, rec = eng.cfg, eng.recorder
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    torch.cuda.synchronize()
    for m in kinds.values():
        m.launches = 0
    t0 = time.perf_counter()
    if isinstance(eng, ServeEngine):
        results = []
        while eng.queue:
            results += eng.step_batch()
    else:
        results = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = {k: m.launches for k, m in kinds.items()}
    pre = [m for m in rec.meta if m.phase == "prefill"]
    dec = [m for m in rec.meta if m.phase == "decode"]
    assert len(pre) + len(dec) == rec.n_steps and rec.n_steps > 0
    expect = on_engines(cfg, {k: per_forward.get(k, 0) * rec.n_steps
                              + per_prefill.get(k, 0) * len(pre) for k in kinds})
    assert moved == expect, f"{label}: launches {moved}, expected {expect}"
    assert sorted(r.rid for r in results) == list(range(len(prompts)))
    if results_out is not None:
        results_out.extend(results)
    for r in results:
        assert len(r.tokens) == max_new and all(0 <= t < cfg.vocab_size for t in r.tokens)
    assert all(m.measured_s > 0 for m in rec.meta), f"{label}: a step was not stamped"
    for (_, _, calls), m in zip(rec.steps, rec.meta):
        assert step_calls(cfg, m.B, m.qlen, m.kvlen, m.tp, m.pp) == calls, (label, m)
    pre_tok = sum(m.B * m.qlen for m in pre)
    pre_s, dec_s = sum(m.measured_s for m in pre), sum(m.measured_s for m in dec)
    log(f"  {label}: {len(results)} requests, prompts {sorted(len(p) for p in prompts)}, "
        f"{len(pre)} prefills + {len(dec)} decode steps in {wall:.2f}s; launches {moved}; "
        f"{rec.n_steps} steps recorded and stamped, each re-lowered to its recorded calls")
    log(f"    prefill {pre_tok} tokens (padded) in {pre_s:.3f}s = {pre_tok / pre_s:.0f} tok/s; "
        f"median prefill step {1e3 * float(np.median([m.measured_s for m in pre])):.1f} ms")
    log(f"    decode {rec.decode_tokens} tokens in {dec_s:.3f}s = {rec.decode_tokens / dec_s:.0f} "
        f"tok/s; median decode step "
        f"{1e3 * float(np.median([m.measured_s for m in dec])):.2f} ms")
    if predictor is not None:
        res = trace_residuals(rec, predictor)
        assert len(res) == rec.n_steps, f"{label}: {len(res)} residuals, {rec.n_steps} steps"
        log(f"    {len(res)} residuals, one per measured step")
        log(f"    prediction for the registry TPU {predictor.hw.name} ({predictor.name} "
            f"backend), not this card: the recorded steps take "
            f"{sum(r.predicted_s for r in res):.6f} s there")
    return moved


def serve(torch, dev, params, kinds):
    """Phase 4: qwen3-0.6b (``params``) through both engines and through
    predicted admission, then dbrx-132b at full width, 2 layers."""
    from repro_torch.configs import get_arch
    from repro_torch.core.e2e import model_calls
    from repro_torch.core.hardware import get_hw
    from repro_torch.models.registry import build_model
    from repro_torch.predict import get_predictor
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serve.trace import TraceRecorder

    totals = {k: 0 for k in kinds}
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def check_finite(runner):
        inner = runner.sample

        def sample(logits, temperatures, generator):
            nonlocal finite
            finite = finite & torch.isfinite(logits).all()
            return inner(logits, temperatures, generator)

        runner.sample = sample

    def run(label, eng, prompts, max_new, per_forward, per_prefill, **kw):
        check_finite(eng._runner)
        for k, v in serve_run(torch, kinds, label, eng, prompts, max_new, per_forward,
                              per_prefill, **kw).items():
            totals[k] += v

    cfg = get_arch("qwen3-0.6b")  # bf16 compute, f32 parameters
    n = cfg.n_layers
    per_forward = {"rmsnorm": 4 * n + 1, "silu_mul": n}  # decode attention stays plain
    per_prefill = {"flash_attention": n}
    hw = get_hw("tpu-v5e")
    roofline = get_predictor("roofline", hw)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(512, 2049, 16)
    prompts = [rng.integers(1, cfg.vocab_size, int(L)) for L in lens]
    run("ServeEngine(max_batch=4)",
        ServeEngine(cfg, params=params, max_batch=4, recorder=TraceRecorder(), device="cuda"),
        prompts[:8], 32, per_forward, per_prefill, predictor=roofline)
    run("ContinuousBatchingEngine(slots=4, max_len=4096)",
        ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=4096,
                                 recorder=TraceRecorder(), device="cuda"),
        prompts[8:], 32, per_forward, per_prefill, predictor=roofline)

    # predicted admission: an SLO between the shortest and the longest
    # request's decode tick, so long requests defer the others
    spans = sorted(len(p) + 16 + 1 for p in prompts[:6])
    slo = roofline.predict(model_calls(cfg, 4, 1, spans[len(spans) // 2], tp=1)).total_s
    eng = ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=4096,
                                   recorder=TraceRecorder(), admission="predicted",
                                   predictor=roofline, decode_slo_s=slo, audit=True,
                                   device="cuda")
    log("    audit=True: the roofline predictor passed the coverage pre-flight")
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        run("ContinuousBatchingEngine(slots=4, admission='predicted', audit=True)", eng,
        prompts[:6], 16,
            per_forward, per_prefill, predictor=roofline)
    log(f"    prediction for the registry TPU {hw.name} (roofline backend), not this card: "
        f"decode_slo_s {slo:.6f} s at a {spans[len(spans) // 2]}-token span")
    runs = []  # the log, a deferred head's retries on later ticks counted together
    for d in eng.admission_log:
        key = (d["rid"], d["kv"], d["predicted_s"], d["admitted"], d["forced"])
        if runs and runs[-1][0] == key:
            runs[-1][1] += 1
        else:
            runs.append([key, 1])
    for (rid, kv, pred, admitted, forced), count in runs:
        what = "forced" if forced else "admitted" if admitted else f"deferred x{count}"
        log(f"    admission log: rid {rid}, projected kv {kv}, predicted for {hw.name} "
            f"{pred:.6f} s: {what}")
    deferred = sum(not d["admitted"] for d in eng.admission_log)
    assert deferred > 0, "the SLO deferred no admission"
    assert eng.admission == "predicted" and eng.admission_fallback_reason is None
    log(f"    {deferred} admissions deferred, {eng.slo_forced_admits} forced "
        f"({len(warned)} warnings), every request completed")
    del eng

    # dbrx-132b at full width, depth cut to 2 layers (31 GB of f32 parameters)
    cfg = dataclasses.replace(get_arch("dbrx-132b"), n_layers=2)
    params = build_model(cfg, "cuda").init(SEED)
    log(f"  dbrx-132b full width, 2 layers: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B parameters, bf16 compute")
    n = cfg.n_layers
    per_forward, per_prefill = {"rmsnorm": 2 * n + 1, "fused_moe": n}, {"flash_attention": n}
    rng = np.random.default_rng(SEED + 3)
    # ServeEngine: batches padded to 1024 (2048 tokens, groups of 512) and
    # to 333 (666 tokens, 334 rows an expert, padded to 384); continuous:
    # each prompt alone, 2003 (prime: 8012 rows), 781 (396 rows), 1024,
    # 640 and 1500 tokens
    for label, make, lens in (
        ("dbrx ServeEngine(max_batch=2)",
         lambda: ServeEngine(cfg, params=params, max_batch=2, recorder=TraceRecorder(),
                             device="cuda"), (1024, 517, 333, 200)),
        ("dbrx ContinuousBatchingEngine(slots=4, max_len=2048)",
         lambda: ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=2048,
                                          recorder=TraceRecorder(), device="cuda"),
         (2003, 781, 1024, 640, 1500)),
    ):
        eng = make()
        run(label, eng, [rng.integers(1, cfg.vocab_size, L) for L in lens], 8, per_forward,
            per_prefill, predictor=roofline)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    # dbrx's bf16 serving runs fused MoE's forward on the wgmma engine, its
    # decode ticks too, and both models' prefill attention (head dim 128) runs
    # flash attention's wgmma engine (f32 goes to the 3xTF32 engines: phases
    # 3, 7 and 10 (a); flash attention's f32 at head dim 256 to mma.sync:
    # phase 10 (a); serving runs no backward)
    idle = ("fused_moe", "fused_moe_tf32", "flash_attention", "flash_attention_tf32",
            "flash_attention_bwd_tf32")
    assert all(v > 0 for k, v in totals.items() if k not in idle), totals
    assert not any(totals[k] for k in idle), totals
    assert bool(finite), "non-finite logits on the serving path"
    return totals


# ======================================================================
# phase 9: the remaining model families
# ======================================================================

# (arch, depth for the parity and serving runs (None: full), prompt length
# of the parity run): gemma2's prompt is longer than its 4096 window, and
# hymba's than window + meta tokens + q_block (1280), so that its local
# layers take the sliced path; mamba2's is not a whole number of chunks
FAMILY_RUNS = [
    ("gemma2-2b", 2, 4608),
    ("stablelm-3b", 2, 512),
    ("mamba2-370m", None, 300),
    ("hymba-1.5b", 4, 1400),
    ("whisper-base", None, 64),
    ("llama-3.2-vision-11b", 4, 128),
]


def family_launches(cfg):
    """What one forward (prefill or decode step) and one prefill add to each
    kernel's launch count: ``(per_forward, per_prefill)``. Decode attention
    and hymba's windowed layers (meta tokens) stay on the plain chunked
    path; layernorm and whisper's gelu FFN are plain PyTorch."""
    n = cfg.n_layers
    if cfg.family == "ssm":  # ln1 and the gated norm a layer
        return {"rmsnorm": 2 * n + 1}, {}
    if cfg.family == "hybrid":  # ln1, gated norm, two branch norms, ln2
        return {"rmsnorm": 5 * n + 1, "silu_mul": n}, {"flash_attention": len({0, n // 2, n - 1})}
    if cfg.family == "audio":  # encoder, decoder self and cross attention
        return {}, {"flash_attention": cfg.n_enc_layers + 2 * n}
    if cfg.family == "vlm":  # n self layers and n / cross_every cross layers
        layers = n + n // cfg.cross_every
        return {"rmsnorm": 2 * layers + 1, "silu_mul": layers}, {"flash_attention": layers}
    norms = 0 if cfg.norm == "layernorm" else (4 if cfg.post_norms else 2) + 2 * cfg.qk_norm
    per_forward = {"silu_mul": n}
    if norms:
        per_forward["rmsnorm"] = norms * n + 1
    return per_forward, {"flash_attention": n}


def remaining_families(torch, dev, kinds):
    """Phase 9: (b) each family at full width on the card against the CPU,
    f32; (c) gemma2-2b at full width and depth served in bf16 through both
    engines with prompts longer than its window, then each other family
    through ``ServeEngine`` at its parity depth, launch counts exact; the
    bf16 families at head dim 64 (hymba-1.5b, whisper-base) also with their
    forward on the mma.sync engine (``both_forwards``). Returns the serving
    runs' launches (the mma.sync runs' left out)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.hardware import get_hw
    from repro_torch.models.registry import build_model
    from repro_torch.predict import get_predictor
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serve.trace import TraceRecorder

    t0 = time.perf_counter()
    for arch, depth, prompt_len in FAMILY_RUNS:
        t = time.perf_counter()
        params = model_parity(torch, dev, arch, n_layers=depth, prompt_len=prompt_len)
        del params
        torch.cuda.empty_cache()
        log(f"  (b) {arch} parity in {time.perf_counter() - t:.1f}s")
    log(f"  (b) every family within {MODEL_TOL} of max|logit| in {time.perf_counter() - t0:.1f}s")

    totals = {k: 0 for k in kinds}
    roofline = get_predictor("roofline", get_hw("tpu-v5e"))
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def run(label, eng, prompts, max_new, results_out=None, add=True):
        nonlocal finite
        inner = eng._runner.sample

        def sample(logits, temperatures, generator):
            nonlocal finite
            finite = finite & torch.isfinite(logits).all()
            return inner(logits, temperatures, generator)

        eng._runner.sample = sample
        per_forward, per_prefill = family_launches(eng.cfg)
        moved = serve_run(torch, kinds, label, eng, prompts, max_new, per_forward, per_prefill,
                          predictor=roofline, results_out=results_out)
        for k, v in moved.items():
            totals[k] += v * add

    # gemma2-2b at full width and depth, bf16 compute
    t0 = time.perf_counter()
    cfg = get_arch("gemma2-2b")
    params = build_model(cfg, "cuda").init(SEED)
    log(f"  (c) gemma2-2b full width, {cfg.n_layers} layers: "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B parameters, bf16 compute, "
        f"window {cfg.window}, softcaps {cfg.attn_softcap}/{cfg.final_softcap}")
    rng = np.random.default_rng(SEED + 5)
    for label, make, lens in (
        ("gemma2 ServeEngine(max_batch=2)",
         lambda: ServeEngine(cfg, params=params, max_batch=2, recorder=TraceRecorder(),
                             device="cuda"), (6000, 4500, 1024, 512)),
        ("gemma2 ContinuousBatchingEngine(slots=4, max_len=8192)",
         lambda: ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=8192,
                                          recorder=TraceRecorder(), device="cuda"),
         (5000, 700, 4200, 2048, 512, 3001)),
    ):
        eng = make()
        run(label, eng, [rng.integers(1, cfg.vocab_size, L) for L in lens], 16)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    log(f"  (c) gemma2-2b served in {time.perf_counter() - t0:.1f}s")

    # every other family through ServeEngine at its parity depth, bf16
    for arch, depth, prompt_len in FAMILY_RUNS[1:]:
        t0 = time.perf_counter()
        cfg = get_arch(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        params = build_model(cfg, "cuda").init(SEED)
        lens = (prompt_len, prompt_len // 2 + 1, 200)
        prompts = [rng.integers(1, cfg.vocab_size, L) for L in lens]
        label = f"{arch} ({cfg.n_layers} layers) ServeEngine(max_batch=2)"
        served = []
        eng = ServeEngine(cfg, params=params, max_batch=2, recorder=TraceRecorder(), device="cuda")
        run(label, eng, prompts, 8, served)
        del eng
        if cfg.resolved_head_dim == 64 and model_fa_engines(cfg)[0] == "wgmma":
            both_forwards(torch, cfg, params, prompts, served, label, run)
        del params
        torch.cuda.empty_cache()
        log(f"  (c) {arch} served in {time.perf_counter() - t0:.1f}s")
    assert bool(finite), "non-finite logits on the families' serving paths"
    return totals


def both_forwards(torch, cfg, params, prompts, served, label, run):
    """Phase 9 (c) for a bf16 family at head dim 64, whose forward the
    wgmma engine took from the mma.sync engine: the same requests served
    again with the forward on the mma.sync engine (``run`` leaves their
    launches out of the main path's counts), and both forwards' prefill
    logits at every position of one batch of the family's parity length, within
    ``FAMILY_BF16_TOL`` of max|logit|. Greedy tokens of random weights
    flip where two logits nearly tie, so the served tokens are counted, not
    required equal."""
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import materialize_batch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.trace import TraceRecorder

    before = []
    with fwd_on_mma_sync(64):
        eng = ServeEngine(cfg, params=params, max_batch=2, recorder=TraceRecorder(),
                          device="cuda")
        run(label + ", forward on mma.sync", eng, prompts, 8, before, add=False)
    del eng
    want = {r.rid: r.tokens for r in before}
    pairs = [(a, b) for r in served for a, b in zip(r.tokens, want[r.rid])]
    first = {r.rid: next((i for i, (a, b) in enumerate(zip(r.tokens, want[r.rid])) if a != b),
                         None) for r in served}
    length = dict((a, L) for a, _, L in FAMILY_RUNS)[cfg.name]
    compute = T.cast_for_compute(params, cfg)
    batch = materialize_batch(cfg, 2, length, seed=SEED, device="cuda")

    def logits():  # every position's, as a prefill computes them
        with torch.no_grad():
            hidden = T.forward(compute, cfg, batch, "prefill")[0]
            return T.full_logits(compute, cfg, hidden).float()

    wg = logits()
    with fwd_on_mma_sync(64):
        ms = logits()
    torch.cuda.synchronize()
    scale = float(ms.abs().max())
    err = float((wg - ms).abs().max())
    top = wg.reshape(-1, wg.shape[-1]).argmax(-1) == ms.reshape(-1, ms.shape[-1]).argmax(-1)
    assert bool(torch.isfinite(wg).all()) and err <= FAMILY_BF16_TOL * scale, (
        f"{cfg.name}: prefill logits on the two forwards {err:.3g} apart, max|logit| {scale:.3g}")
    log(f"  (c) {cfg.name}: served tokens equal on both forward engines "
        f"{sum(a == b for a, b in pairs)} of {len(pairs)} (first difference a request: "
        f"{first}); prefill logits (B2 S{length}) {err:.3g} apart, of max|logit| {scale:.3g} "
        f"(tol {FAMILY_BF16_TOL}), argmax equal at {int(top.sum())} of {top.numel()} rows")
    del compute, batch, wg, ms


# ======================================================================
# phase 5: kernel times
# ======================================================================


def cuda_ms(torch, fn, inputs, iters):
    """Mean milliseconds of one ``fn(*inputs[i % len(inputs)])`` on the
    device, and the same through eager launches: ``(device_ms, eager_ms)``.

    The device time replays ``iters`` calls captured in one CUDA graph, so
    the host's launch overhead is left out; the eager time launches them
    from Python between the same CUDA events, as the model does, and is
    above the device time wherever the host cannot keep up. Rotating inputs
    larger than the L2 cache makes every call read from device memory, as
    the model's calls do. Both follow a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (and Triton's compile) off the capture
        for a in inputs[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the side stream's cached blocks: a large plain call needs them
    for a in inputs[:2]:  # and on this stream, whose allocator pool the eager calls draw from
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    torch.cuda.empty_cache()  # the eager calls' cached blocks, before the graph's own pool
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    del graph
    return device, eager


def kernel_times(torch, dev, peaks):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_moe.kernel import fused_moe_cuda
    from repro_torch.kernels.fused_moe.ref import fused_moe_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.scaled_mm.ref import scaled_mm_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_ref
    from repro_torch.kernels.silu_mul import kernel as silu_k
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import dispatch_geometry
    from repro_torch.tune import DEFAULT_WORKLOADS, arch_workload

    bf16, f32 = torch.bfloat16, torch.float32
    bw = peaks["bytes"]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=bf16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    rows, eager = {}, {}

    def row(kname, kernel, plain, library, inputs, iters, bound_ms, bound_by):
        """Device times of the kernel, its plain version and the library
        call (``library = (fn, inputs)`` or None); eager times are logged."""
        ms, eager[kname] = cuda_ms(torch, kernel, inputs, iters)
        plain_ms, eager[kname + " plain"] = cuda_ms(torch, plain, inputs, max(2, iters // 4))
        library_ms = None
        if library is not None:
            library_ms, eager[kname + " library"] = cuda_ms(torch, library[0], library[1], iters)
        rows[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}

    # rmsnorm: the layer norms of a 4 x 2048-token prefill, (8192, 1024) bf16
    R, d = 8192, 1024
    xs = [(randn(R, d), randn(d, scale=0.1)) for _ in range(8)]  # 8 x 16 MiB > L2
    row("rmsnorm", rmsnorm_cuda, rmsnorm_ref,
        (lambda x, w: F.rms_norm(x, (d,), w, 1e-6), [(x, 1.0 + w) for x, w in xs]),
        xs, 200, 1e3 * (2 * R * d * 2 + d * 2) / bw, "bytes")
    qk = [(randn(R * 16, 128), randn(128, scale=0.1)) for _ in range(2)]
    qk_ms, qk_eager = cuda_ms(torch, rmsnorm_cuda, qk, 100)
    log(f"  rmsnorm (131072, 128) bf16 (q norm): {qk_ms:.4f} ms (eager {qk_eager:.4f}), "
        f"bound {1e3 * (2 * R * 16 * 128 * 2) / bw:.4f} ms")
    # silu_mul: gate and up of the same prefill, (8192, 3072) bf16, with the
    # rows a program owns on the serving path (SERVING_BLOCK_ROWS); logged
    # beside it: the reference's default of 128 rows, and the single
    # prompts of phase 4's continuous engine (781-2004 tokens, some prime)
    # at 1, 8 and 128 rows a program
    F_ = 3072
    gs = [(randn(R, F_, scale=3.0), randn(R, F_)) for _ in range(2)]
    row("silu_mul", lambda g, u: silu_mul_cuda(g, u, block_rows=silu_k.SERVING_BLOCK_ROWS),
        silu_mul_ref, None, gs, 200, 1e3 * (3 * R * F_ * 2) / bw, "bytes")
    for n_rows in (8192, 781, 1024, 1444, 1633, 2004):
        small = [(randn(n_rows, F_, scale=3.0), randn(n_rows, F_)) for _ in range(8)]
        times = []
        for rows_ in sorted({silu_k.SERVING_BLOCK_ROWS, 8, 128}):
            t, _ = cuda_ms(torch, lambda g, u, r=rows_: silu_mul_cuda(g, u, block_rows=r),
                           small, 100)
            programs = silu_k.launch_plan(n_rows, F_, block_rows=rows_).grid[0]
            times.append(f"block_rows={rows_} ({programs} programs) {t:.4f} ms")
        log(f"  silu_mul ({n_rows}, {F_}) bf16: " + ", ".join(times)
            + f"; bound {1e3 * 3 * n_rows * F_ * 2 / bw:.4f} ms")
        del small
    # flash attention's forward, bf16: the wgmma engine's row and the
    # mma.sync engine's on the same inputs, the two in turns (wgmma,
    # mma.sync, mma.sync, wgmma; kernel times drift as the card heats), each
    # row's ms the mean of its two turns; f32 the same with the 3xTF32
    # engine (``engine``) and the FMA engine, each with its own bound
    from repro_torch.kernels.flash_attention import kernel as fa_k

    def fa_engines(label, kw, inputs, plain, library, bnd, engine="wgmma", old_bnd=None):
        names = {engine: f"flash_attention_{engine}" + label, "mma_sync": "flash_attention" + label}
        turns = {}
        for e in (engine, "mma_sync", "mma_sync", engine):
            fn = getattr(fa_k, f"flash_attention_{e}_cuda")
            call = lambda a, b, c, fn=fn: fn(a, b, c, **kw)
            if names[e] not in rows:
                row(names[e], call, plain, library, inputs, 20,
                    *(old_bnd if e == "mma_sync" and old_bnd else bnd))
                turns[e] = [rows[names[e]]["ms"]]
            else:
                turns[e].append(cuda_ms(torch, call, inputs, 20)[0])
        for e, name in names.items():
            rows[name]["ms"] = float(np.mean(turns[e]))
        w, m = rows[names[engine]], rows[names["mma_sync"]]
        lib = "n/a" if w["library_ms"] is None else f"{w['library_ms']:.4f}"
        log(f"  flash_attention{label} in turns (ms): {engine} {turns[engine]}, mma.sync "
            f"{turns['mma_sync']}; {engine} {w['bound_ms'] / w['ms']:.4f} of the bound, "
            f"{m['ms'] / w['ms']:.2f}x faster than mma.sync, library {lib}")
        return w

    # the serving path's causal prefill B=4, S=2048, 16/8 heads of 128
    B, S, Hq, Hkv, D = 4, 2048, 16, 8, 128
    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    pairs = B * Hq * S * (S + 1) // 2  # (query, key) pairs the causal mask keeps
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True)
    w = fa_engines("", dict(causal=True), [(q, k, v)],
                   lambda a, b, c: attention_ref(a, b, c, causal=True), (sdpa, [(qt, kt, vt)]),
                   bound(peaks, nbytes, flops, "bfloat16"))
    log(f"  flash_attention causal work: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; wgmma "
        f"{flops / w['ms'] / 1e9:.1f} TFLOP/s")
    del q, k, v, qt, kt, vt
    # stablelm-3b's bf16 prefill, B=1, S=2048, 32/32 heads of 80, causal:
    # the wgmma engine's head-dim-80 instance in turns with the mma.sync
    # engine, beside SDPA (the main shape's in-turns mma.sync time stays as
    # a logged row)
    rows["flash_attention (main shape, D128, in turns)"] = rows.pop("flash_attention")
    B, S, Hq, Hkv, D = 1, 2048, 32, 32, 80
    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    pairs = B * Hq * S * (S + 1) // 2
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    w = fa_engines(" (stablelm-3b prefill, D80)", dict(causal=True), [(q, k, v)],
                   lambda a, b, c: attention_ref(a, b, c, causal=True), (sdpa, [(qt, kt, vt)]),
                   bound(peaks, nbytes, flops, "bfloat16"))
    log(f"  flash_attention at stablelm-3b's prefill, B1 S2048 32/32x80 causal bf16: "
        f"{flops / 1e9:.2f} GFLOP; wgmma {w['ms']:.4f} ms, {flops / w['ms'] / 1e9:.1f} TFLOP/s, "
        f"{w['bound_ms'] / w['ms']:.4f} of the bound, {w['ms'] / w['library_ms']:.2f}x SDPA's "
        f"{w['library_ms']:.4f}")
    del q, k, v, qt, kt, vt
    # whisper-base's encoder (phase 9), B=1, 1500 frames, 8/8 heads of 64,
    # no mask, and hymba-1.5b's global layer, B=1, 1528 tokens (1400 and
    # 128 meta tokens), 25/5 heads of 64, causal: the wgmma engine's
    # head-dim-64 instance in turns with the mma.sync engine (which no
    # longer runs these shapes), beside SDPA
    for label, (B, S, Hq, Hkv, D), causal in (
            (" (whisper-base encoder, D64)", (1, 1500, 8, 8, 64), False),
            (" (hymba-1.5b global layer, D64)", (1, 1528, 25, 5, 64), True)):
        q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        flops = 4 * D * B * Hq * (S * (S + 1) // 2 if causal else S * S)
        nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        w = fa_engines(label, dict(causal=causal), [(q, k, v)],
                       lambda a, b, c, causal=causal: attention_ref(a, b, c, causal=causal),
                       (lambda a, b, c, causal=causal: F.scaled_dot_product_attention(
                           a, b, c, is_causal=causal, enable_gqa=True), [(qt, kt, vt)]),
                       bound(peaks, nbytes, flops, "bfloat16"))
        log(f"  flash_attention_wgmma{label}, B{B} S{S} {Hq}/{Hkv}x{D} causal={causal} bf16: "
            f"{flops / 1e9:.2f} GFLOP; {w['ms']:.4f} ms, {flops / w['ms'] / 1e9:.1f} TFLOP/s, "
            f"{w['bound_ms'] / w['ms']:.4f} of the bound, {w['ms'] / w['library_ms']:.2f}x "
            f"SDPA's {w['library_ms']:.4f}")
        del q, k, v, qt, kt, vt
    # f32: the 3xTF32 engine in turns with the FMA engine on the same inputs
    # (tf32, mma.sync, mma.sync, tf32), beside SDPA in f32, bounded as 3xTF32
    # (three TF32 products for each of its own, at the TF32 peak; the FMA
    # engine at the f32 peak), at qwen3-0.6b's gradient run of phase 10 (a)
    # (B2 S256 16/8 heads of 128, causal: the 3xTF32 engine's JSON row; 16
    # input sets, 64 MB, so that every call reads from device memory), the
    # tuner's flash-attention workload (B2 S512, the same heads) and
    # stablelm-3b's gradient run (B2 S256 32/32 heads of 80)
    for label, (B, S, Hq, Hkv, D), n_sets in (("", (2, 256, 16, 8, 128), 16),
                                              (" (tuner, B2 S512)", (2, 512, 16, 8, 128), 8),
                                              (" (stablelm-3b f32, D80)", (2, 256, 32, 32, 80), 8)):
        sets = [(randn(B, S, Hq, D, dtype=f32), randn(B, S, Hkv, D, dtype=f32),
                 randn(B, S, Hkv, D, dtype=f32)) for _ in range(n_sets)]
        flops = 4 * D * B * Hq * S * (S + 1) // 2
        nbytes = 4 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        f32_bound = bound(peaks, nbytes, flops, "float32")
        w = fa_engines(label, dict(causal=True), sets,
                       lambda a, b, c: attention_ref(a, b, c, causal=True),
                       (sdpa, [tuple(t.transpose(1, 2).contiguous() for t in x) for x in sets]),
                       bound(peaks, nbytes, 3 * flops, "tf32"), "tf32", f32_bound)
        m = rows["flash_attention" + label]
        log(f"  flash_attention f32{label or ' (qwen3-0.6b, phase 10 (a))'}, B{B} S{S} "
            f"{Hq}/{Hkv}x{D} causal: {flops / 1e9:.3f} GFLOP; 3xTF32 {w['ms']:.4f} ms, "
            f"{w['bound_ms'] / w['ms']:.4f} of its 3xTF32 bound {w['bound_ms']:.4f}, "
            f"{f32_bound[0] / w['ms']:.4f} of the f32-peak bound {f32_bound[0]:.4f}; FMA "
            f"{m['ms']:.4f} ms ({m['ms'] / w['ms']:.2f}x the 3xTF32 engine's); SDPA "
            f"{w['library_ms']:.4f}")
        del sets
    rows["flash_attention (qwen3-0.6b f32, FMA in turns)"] = rows.pop("flash_attention")
    # the FMA engine's row at the shape its main path runs: gemma2-2b's
    # gradient run of phase 10 (a), B1 S256 8/4 heads of 256, causal, window
    # 4096, softcap 50, f32 (its bound at the f32 peak; no library call: SDPA
    # takes no softcap); 16 input sets
    B, S, Hq, Hkv, D = 1, 256, 8, 4, 256
    gkw = dict(causal=True, window=4096, softcap=50.0)
    sets = [(randn(B, S, Hq, D, dtype=f32), randn(B, S, Hkv, D, dtype=f32),
             randn(B, S, Hkv, D, dtype=f32)) for _ in range(16)]
    flops = 4 * D * B * Hq * S * (S + 1) // 2
    nbytes = 4 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    row("flash_attention", lambda a, b, c: fa_k.flash_attention_mma_sync_cuda(a, b, c, **gkw),
        lambda a, b, c: attention_ref(a, b, c, **gkw), None, sets, 40,
        *bound(peaks, nbytes, flops, "float32"))
    r = rows["flash_attention"]
    log(f"  flash_attention (FMA) at gemma2-2b's phase 10 (a) shape, B1 S256 8/4x256 causal "
        f"window 4096 softcap 50 f32: {r['ms']:.4f} ms, {flops / 1e9:.3f} GFLOP, "
        f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.4f} of the f32 bound")
    del sets
    # gemma2-2b's prefill: B=1, S=4608, 8/4 heads of 256, causal, window
    # 4096, softcap 50. A row past the window sees 4096 keys. SDPA takes no
    # softcap, so the rows have no library call; the causal-only row beside
    # them (window and softcap off) has SDPA as its yardstick
    B, S, Hq, Hkv, D, W = 1, 4608, 8, 4, 256, 4096
    q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    pairs = B * Hq * sum(min(i + 1, W) for i in range(S))
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    kw = dict(causal=True, window=W, softcap=50.0)
    w = fa_engines(" gemma2 prefill", kw, [(q, k, v)], lambda a, b, c: attention_ref(a, b, c, **kw),
                   None, bound(peaks, nbytes, flops, "bfloat16"))
    log(f"  flash_attention gemma2 prefill work: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"wgmma {flops / w['ms'] / 1e9:.1f} TFLOP/s, {w['bound_ms'] / w['ms']:.3f} of the bound")
    causal_flops = 4 * D * B * Hq * S * (S + 1) // 2
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row("flash_attention_wgmma (gemma2-2b prefill shape, causal only)",
        lambda a, b, c: fa_k.flash_attention_wgmma_cuda(a, b, c, causal=True),
        lambda a, b, c: attention_ref(a, b, c, causal=True), (sdpa, [(qt, kt, vt)]), [(q, k, v)],
        20, *bound(peaks, nbytes, causal_flops, "bfloat16"))
    del qt, kt, vt
    # the wgmma engine at other (block_q, block_k): a CTA's q rows and the
    # keys of a step (cut into tiles of 64 keys at D 256)
    corners = []
    for bq, bk in ((128, 64), (64, 64), (256, 128), (128, 256)):
        t, _ = cuda_ms(torch, lambda a, b, c: fa_k.flash_attention_wgmma_cuda(
            a, b, c, block_q=bq, block_k=bk, **kw), [(q, k, v)], 20)
        plan = fa_k.fwd_wgmma_plan(B, S, S, Hq, Hkv, D, block_q=bq, block_k=bk)
        corners.append(f"({bq}, {bk}) {t:.4f} ms [grid {plan.grid}, {plan.tiles_per_step} "
                       f"tile(s) a step]")
    log("  flash_attention_wgmma gemma2 prefill at other blocks: " + "; ".join(corners))
    del q, k, v

    # fused MoE at dbrx-132b width, default blocks. The serving shapes, bf16
    # as served: a 1024-token prefill (groups of 512, 256 rows a group: 512
    # rows an expert: the wgmma engine's JSON row) and a decode tick of 4
    # slots (4 rows an expert), rows from the model's dispatch_geometry; the
    # tuner's dbrx workload (C256), f32 (its inputs: the 3xTF32 engine's
    # JSON row, and the mma.sync engine's from its turns on the same inputs)
    # and bf16; and the training layer of phase 10 (e) (2048 tokens: 640
    # rows an expert), bf16 and f32. Library yardstick: three bmm's with
    # silu * mul. On every shape the mma.sync engine is timed on the same
    # inputs in turns (wgmma or 3xTF32, mma.sync, mma.sync, wgmma or 3xTF32).
    from repro_torch.kernels.fused_moe import kernel as moe_k

    dbrx = get_arch("dbrx-132b")
    E, D, Fm = dbrx.n_experts, dbrx.d_model, dbrx.moe_hidden

    def rows_of(tokens, train=False):
        G, _, C = dispatch_geometry(dbrx, tokens, train=train)
        return G * C

    def bmm_moe(x, wg, wu, wd):
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    # The f32 kernel runs 3xTF32 on the tensor cores, three TF32 products for
    # each one, so its bound is that of 3 x the operations at the TF32 peak;
    # the f32 FMA units' bound, which a kernel of this design can beat, is
    # logged beside it.
    C_tune = arch_workload("fused_moe", "dbrx-132b")["C"]
    for kname, C, dt, iters in (("fused_moe_wgmma", rows_of(1024), bf16, 4),
                                ("fused_moe decode tick", rows_of(4), bf16, 8),
                                ("fused_moe_tf32", C_tune, f32, 2),
                                ("fused_moe bf16 tuner", C_tune, bf16, 2),
                                ("fused_moe training layer", rows_of(2048, train=True), bf16, 2),
                                ("fused_moe_tf32 training rows", rows_of(2048, train=True), f32,
                                 2)):
        args = (randn(E, C, D, dtype=dt), randn(E, D, Fm, scale=D ** -0.5, dtype=dt),
                randn(E, D, Fm, scale=D ** -0.5, dtype=dt), randn(E, Fm, D, scale=Fm ** -0.5, dtype=dt))
        nbytes = args[0].element_size() * (2 * E * C * D + 3 * E * D * Fm)
        flops = 6 * E * C * D * Fm
        engine = moe_k.fwd_engine(dt, C, D, Fm)
        assert engine == ("wgmma_tf32" if dt == f32 else "wgmma"), (kname, C, engine)
        row(kname, fused_moe_cuda, fused_moe_ref, (bmm_moe, [args]), [args], iters,
            *(bound(peaks, nbytes, 3 * flops, "tf32") if dt == f32
              else bound(peaks, nbytes, flops, "bfloat16")))
        log(f"  {kname}: E{E} C{C} D{D} F{Fm} {dt}: {flops / 1e12:.4f} TFLOP, "
            f"{nbytes / 1e9:.2f} GB, the {engine} engine")
        if dt == f32:
            fma_ms, fma_by = bound(peaks, nbytes, flops, "float32")
            log(f"  {kname}: bound {rows[kname]['bound_ms']:.4f} ms as 3xTF32 (the row's), "
                f"{fma_ms:.4f} ms by {fma_by} on the f32 FMA units")
        turns = [rows[kname]["ms"]]
        mma = [cuda_ms(torch, moe_k.fused_moe_mma_sync_cuda, [args], iters) for _ in range(2)]
        turns += [t for t, _ in mma]
        turns.append(cuda_ms(torch, fused_moe_cuda, [args], iters)[0])
        r = rows[kname]
        if dt == f32:  # each engine's ms the mean of its two turns
            r["ms"] = (turns[0] + turns[3]) / 2
            if kname == "fused_moe_tf32":  # the mma.sync engine's row: the same inputs
                rows["fused_moe"] = dict(r, ms=(turns[1] + turns[2]) / 2)
                eager["fused_moe"] = mma[0][1]
        log(f"  {kname} in turns: {engine} {turns[0]:.4f}, mma.sync {turns[1]:.4f}, mma.sync "
            f"{turns[2]:.4f}, {engine} {turns[3]:.4f} ms (mma.sync "
            f"{(turns[1] + turns[2]) / (turns[0] + turns[3]):.2f}x); "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.4f} of the bound, "
            f"{r['ms'] / r['library_ms']:.2f}x the library's {r['library_ms']:.4f} ms")
        if engine == "wgmma":
            fwd_launch_times(torch, peaks, args)
        else:
            tf32_fwd_launch_times(torch, moe_k, peaks, args)
        del args
        torch.cuda.empty_cache()

    # scaled_mm at dbrx-132b width (its FFN projection), default blocks, bf16
    # out: the wgmma engine and the mma.sync engine on the same inputs in
    # turns (``smm_engines_in_turns``), each row's ms the mean of its two;
    # library yardstick: torch._int_mm and the same epilogue
    M, K, N = (arch_workload("scaled_mm", "dbrx-132b")[k] for k in "MKN")

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def scales(n):
        return 0.5 + 1.5 * torch.rand(n, generator=gen, device=dev)

    smm_args = [(int8(M, K), int8(K, N), scales(M), scales(N)) for _ in range(2)]  # 2 x 72 MB > L2
    turns, eager_t = smm_engines_in_turns(torch, smm_args, 10)
    plain_ms, eager["scaled_mm plain"] = cuda_ms(torch, scaled_mm_ref, smm_args, 2)
    lib_ms, eager["scaled_mm library"] = cuda_ms(torch, smm_library, smm_args, 10)
    bound_ms, bound_by = smm_bound(peaks, M, K, N)
    for e, kname in (("wgmma", "scaled_mm_wgmma"), ("mma_sync", "scaled_mm")):
        eager[kname] = eager_t[e]
        rows[kname] = {"ms": float(np.mean(turns[e])), "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms}
    r, old = rows["scaled_mm_wgmma"], rows["scaled_mm"]
    log(f"  scaled_mm M{M} K{K} N{N}: {2 * M * K * N / 1e12:.4f} Tops; in turns (ms): wgmma "
        f"{turns['wgmma']}, mma.sync {turns['mma_sync']}; wgmma {2 * M * K * N / r['ms'] / 1e9:.1f} "
        f"TOPS, {r['bound_ms'] / r['ms']:.3f} of the bound, {old['ms'] / r['ms']:.2f}x faster than "
        f"mma.sync, {r['library_ms'] / r['ms']:.2f}x faster than _int_mm + epilogue")
    del smm_args
    # the tuner's default workload, where its inputs stay in L2 as they do in tune()
    M, K, N = (DEFAULT_WORKLOADS["scaled_mm"][k] for k in "MKN")
    small = [(int8(M, K), int8(K, N), scales(M), scales(N)) for _ in range(2)]
    turns, _ = smm_engines_in_turns(torch, small, 100)
    lib_ms, _ = cuda_ms(torch, smm_library, small, 100)
    b_ms, b_by = smm_bound(peaks, M, K, N)
    ms = float(np.mean(turns["wgmma"]))
    log(f"  scaled_mm M{M} K{K} N{N} (tuner default), default blocks, in turns (ms): wgmma "
        f"{turns['wgmma']}, mma.sync {turns['mma_sync']}; _int_mm + epilogue {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}; wgmma {2 * M * K * N / ms / 1e9:.1f} TOPS")
    for kname, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {kname}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    log("  eager launches from Python, ms a call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in eager.items()))
    return rows


def fwd_launch_times(torch, peaks, args):
    """Each of the forward wgmma engine's two launches at these inputs: its
    device ms under ``torch.profiler`` (the mean of 5 calls) beside its own
    bound (gate/up: two products, x, Wg, Wu in and h out; down: one, h and
    Wd in and y out)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.fused_moe.kernel import fused_moe_wgmma_cuda

    x, w_gate = args[0], args[1]
    E, C, D = x.shape
    F_ = w_gate.shape[2]
    fused_moe_wgmma_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused_moe_wgmma_cuda(*args)
        torch.cuda.synchronize()
    times = {e.key: e.device_time_total / 1e3 / 5 for e in prof.key_averages()
             if "moe_fwd_wgmma" in e.key and e.device_time_total > 0}
    assert len(times) == 2, f"fused_moe_wgmma: the profiler saw {sorted(times)}"
    total = 0.0
    for key, ms in sorted(times.items()):
        # the template's second argument: 1 the gate/up epilogue, 2 the down one
        gate = re.search(r"moe_fwd_wgmma(?:<\d+, 1>|ILi\d+ELi1E)", key) is not None
        products, nbytes = (2, E * C * D + 2 * E * D * F_ + E * C * F_) if gate else (
            1, E * C * F_ + E * F_ * D + E * C * D)
        b, by = bound(peaks, 2 * nbytes, products * 2 * E * C * D * F_, "bfloat16")
        total += ms
        log(f"  fused_moe_wgmma launch {'gate_up' if gate else 'down'}: {ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}), {b / ms:.4f} of it")
    log(f"  fused_moe_wgmma: the two launches {total:.4f} ms under the profiler")


def moe_launch_times(torch, moe_k, peaks, args):
    """Each of the wgmma engine's four launches at these inputs: its device
    ms under ``torch.profiler`` (the mean of 5 calls) beside the bound of
    its products at the bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    x, w_gate = args[0], args[1]
    E, C, D = x.shape
    F_ = w_gate.shape[2]
    moe_k.fused_moe_bwd_wgmma_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            moe_k.fused_moe_bwd_wgmma_cuda(*args)
        torch.cuda.synchronize()
    # the launches' instances, in order: (A MN-major, B MN-major, epilogue)
    instance = {"gate_up": "<false, true, 1>", "dh": "<false, false, 2>",
                "dw": "<true, true, 4>", "dx": "<false, false, 3>"}
    times = {e.key: e.device_time_total / 1e3 / e.count for e in prof.key_averages()
             if "moe_bwd_wgmma" in e.key and e.device_time_total > 0}
    total = 0.0
    for launch in moe_k.wgmma_plan(E, C, D, F_):
        ms = sum(v for k, v in times.items() if instance[launch.name] in k)
        flops = sum(2 * E * M * N * K * seg for M, N, K, seg in launch.products)
        b = 1e3 * flops / peaks["bfloat16"]
        total += ms
        log(f"  fused_moe_bwd_wgmma launch {launch.name} ({launch.layout}): {ms:.4f} ms, bound "
            f"{b:.4f} (operations), {b / ms:.4f} of it")
    log(f"  fused_moe_bwd_wgmma: the four launches {total:.4f} ms under the profiler")


def tf32_launch_times(torch, moe_k, peaks, args):
    """Each launch of the 3xTF32 engine at these f32 inputs (dy's transposing
    copy, then the four products, each its own kernel instance): its device
    ms under ``torch.profiler`` (the mean of 3 calls) beside the bound of its
    products run three times at the TF32 peak."""
    import re

    from torch.profiler import ProfilerActivity, profile

    x, w_gate = args[0], args[1]
    E, C, D = x.shape
    F_ = w_gate.shape[2]
    moe_k.fused_moe_bwd_tf32_cuda(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            moe_k.fused_moe_bwd_tf32_cuda(*args)
        torch.cuda.synchronize()
    times = {e.key: e.device_time_total / 1e3 / e.count for e in prof.key_averages()
             if ("moe_bwd_tf32" in e.key or "transpose_pad" in e.key) and e.device_time_total > 0}
    assert len(times) == 5, f"fused_moe_bwd_tf32: the profiler saw {sorted(times)}"
    copy = sum(v for k, v in times.items() if "transpose_pad" in k)
    total = copy
    log(f"  fused_moe_bwd_tf32 dy's transposing copy: {copy:.4f} ms")
    for i, launch in enumerate(moe_k.tf32_plan(E, C, D, F_), start=1):
        # the instance's second template argument is the launch (1-4)
        ms = sum(v for k, v in times.items()
                 if re.search(rf"moe_bwd_tf32(?:<\w+, {i}, \d+>|I\w+?ELi{i}ELi\d+E)", k))
        flops = 3 * sum(2 * E * M * N * K * seg for M, N, K, seg in launch.products)
        b = 1e3 * flops / peaks["tf32"]
        total += ms
        log(f"  fused_moe_bwd_tf32 launch {launch.name} (A {launch.layout}-major, tile "
            f"{launch.tile}): {ms:.4f} ms, bound {b:.4f} (operations, 3xTF32), {b / ms:.4f} "
            f"of it; its own products at the TF32 peak {b / 3 / ms:.4f}")
    log(f"  fused_moe_bwd_tf32: the five launches {total:.4f} ms under the profiler")


def tf32_fwd_launch_times(torch, moe_k, peaks, args, block_m=128, block_f=256):
    """Each launch of fused MoE's 3xTF32 forward at these f32 inputs (gate,
    up, down, each its own kernel instance): its device ms under
    ``torch.profiler`` (the mean of 3 calls) beside the bound of its product
    run three times at the TF32 peak."""
    import re

    from torch.profiler import ProfilerActivity, profile

    x, w_gate = args[0], args[1]
    E, C, D = x.shape
    F_ = w_gate.shape[2]
    kw = dict(block_m=block_m, block_f=block_f)
    moe_k.fused_moe_tf32_cuda(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            moe_k.fused_moe_tf32_cuda(*args, **kw)
        torch.cuda.synchronize()
    times = {e.key: e.device_time_total / 1e3 / e.count for e in prof.key_averages()
             if "moe_fwd_tf32" in e.key and e.device_time_total > 0}
    assert len(times) == 3, f"fused_moe_tf32: the profiler saw {sorted(times)}"
    total = 0.0
    for i, launch in enumerate(moe_k.tf32_fwd_plan(E, C, D, F_, block_m, block_f)):
        # the instance's first template argument is the launch (0-2)
        ms = sum(v for k, v in times.items()
                 if re.search(rf"moe_fwd_tf32(?:<{i}, \d+>|ILi{i}ELi\d+E)", k))
        M, N, K = launch.products
        b = 1e3 * 3 * 2 * E * M * N * K / peaks["tf32"]
        total += ms
        log(f"  fused_moe_tf32 launch {launch.name} (tile {launch.tile}, {launch.ctas} CTAs): "
            f"{ms:.4f} ms, bound {b:.4f} (operations, 3xTF32), {b / ms:.4f} of it; its own "
            f"product at the TF32 peak {b / 3 / ms:.4f}")
    log(f"  fused_moe_tf32: the three launches {total:.4f} ms under the profiler")


def fa_launch_times(torch, fa_k, peaks, args, kw, pairs, engine="wgmma"):
    """Each of flash attention's backward launches on ``engine`` (``wgmma``
    or ``tf32``) at these inputs: its device ms under ``torch.profiler``
    (the mean of 5 calls) beside the bound of the products it computes (dQ:
    S, dP and dS K, ``6 D`` a visible pair; dK/dV: S^T, dP^T, P^T dO and
    dS^T Q, ``8 D``) at the bf16 peak, or for ``tf32`` three times those at
    the TF32 peak (3xTF32)."""
    from torch.profiler import ProfilerActivity, profile

    D = args[0].shape[-1]
    fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
    fn(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn(*args, **kw)
        torch.cuda.synchronize()
    times = {e.key: e.device_time_total / 1e3 / e.count for e in prof.key_averages()
             if f"_{engine}" in e.key and e.device_time_total > 0}
    total = 0.0
    ops, kind = (3, "tf32") if engine == "tf32" else (1, "bfloat16")
    for name, per_pair in (("dq", 6), ("dkdv", 8)):
        ms = sum(v for k, v in times.items() if f"fa_bwd_{name}_{engine}" in k)
        b = 1e3 * ops * per_pair * D * pairs / peaks[kind]
        total += ms
        log(f"  flash_attention_bwd_{engine} launch {name}: {ms:.4f} ms, bound {b:.4f} "
            f"(operations), {b / ms:.4f} of it")
    log(f"  flash_attention_bwd_{engine}: the two launches {total:.4f} ms under the profiler")


def library_bwd_ms(torch, fwd, inputs, iters, kname):
    """The library's backward alone: ``autograd.grad`` of its forward,
    both captured in one CUDA graph (autograd runs the backward on the
    forward's stream, so the two are captured together), less the forward
    alone: ``(ms, eager ms of the forward and backward)``. Each input tuple
    ends with the output's gradient."""
    def fwd_bwd(*a):
        return torch.autograd.grad(fwd(*a[:-1]), a[:-1], a[-1])

    def fwd_only(*a):
        with torch.no_grad():
            return fwd(*a[:-1])

    both, both_eager = cuda_ms(torch, fwd_bwd, inputs, iters)
    only, _ = cuda_ms(torch, fwd_only, inputs, iters)
    log(f"  {kname} library: forward and backward {both:.4f} ms, forward {only:.4f} ms")
    return both - only, both_eager


def smm_library(x, w, sx, sw):
    """scaled_mm as one library product computes it: ``torch._int_mm`` and
    the same epilogue, a bf16 output (a yardstick; the port never calls it)."""
    import torch

    return (torch._int_mm(x, w).float() * sx[:, None] * sw[None, :]).to(torch.bfloat16)


def smm_bound(peaks, M, K, N):
    """scaled_mm's ``(bound_ms, bound_by)``: int8 x and w and the f32 scales
    read once, a bf16 output written once, 2 M K N int8 operations."""
    return bound(peaks, M * K + K * N + 4 * (M + N) + 2 * M * N, 2 * M * K * N, "int8")


def smm_engines_in_turns(torch, inputs, iters, **blocks):
    """scaled_mm's two engines on the same inputs, in turns (wgmma, mma.sync,
    mma.sync, wgmma), each turn ``cuda_ms`` over ``iters`` calls:
    ``({engine: [device ms of each turn]}, {engine: eager ms of its first})``."""
    from repro_torch.kernels.scaled_mm import kernel as smm_k

    turns, eager = {"wgmma": [], "mma_sync": []}, {}
    for e in ("wgmma", "mma_sync", "mma_sync", "wgmma"):
        fn = getattr(smm_k, f"scaled_mm_{e}_cuda")
        ms, eg = cuda_ms(torch, lambda *a, fn=fn: fn(*a, **blocks), inputs, iters)
        turns[e].append(ms)
        eager.setdefault(e, eg)
    return turns, eager


def moe_library(x, w_gate, w_up, w_down):
    """Fused MoE's forward as the library computes it: three ``bmm`` and
    silu * u, which autograd differentiates."""
    import torch
    import torch.nn.functional as F

    return torch.bmm(F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up), w_down)


def backward_times(torch, dev, peaks):
    """Phase 5 for the backward kernels at qwen3-0.6b's training shapes
    (B4 S2048, bf16): device ms from a CUDA-graph replay, eager ms, the
    plain backward formula's time, and the library's backward (of
    ``F.rms_norm``, of SDPA; none for act * u) timed the same way. The
    bound counts each input read once and each output written once; for
    flash attention the operations of the five products a backward needs
    (``10 D`` a visible pair) at the bf16 tensor-core peak."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe.ref import fused_moe_bwd_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
    from repro_torch.kernels.silu_mul.kernel import silu_mul_bwd_cuda
    from repro_torch.kernels.silu_mul.ref import silu_mul_bwd_ref

    bf16 = torch.bfloat16
    bw = peaks["bytes"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape, scale=1.0, dtype=bf16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    rows, logged, eager = {}, {}, {}

    def library_ms(fwd, inputs, iters, kname):
        ms, eager[kname + " library fwd+bwd"] = library_bwd_ms(torch, fwd, inputs, iters, kname)
        return ms

    def row(kname, kernel, plain, library, inputs, iters, bound_ms, bound_by, into=rows):
        """The kernel's row (``into=logged``: a row that is logged only)."""
        ms, eager[kname] = cuda_ms(torch, kernel, inputs, iters)
        plain_ms, eager[kname + " plain"] = cuda_ms(torch, plain, inputs, max(2, iters // 4))
        lib = None if library is None else library_ms(library[0], library[1], iters, kname)
        into[kname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib}

    R, d, F_ = 8192, 1024, 3072
    # the layer norms (the kernel's row), then the q and k norms (logged rows)
    for rn, dn in ((R, d), (R * 16, 128), (R * 8, 128)):
        sets = [(randn(rn, dn), randn(rn, dn), randn(dn, scale=0.1)) for _ in range(4)]  # > L2
        lib_sets = [(x.clone().requires_grad_(), (1.0 + w).requires_grad_(), g)
                    for g, x, w in sets]
        row("rmsnorm_bwd" if dn == d else f"rmsnorm_bwd ({rn}, {dn})", rmsnorm_bwd_cuda,
            rmsnorm_bwd_ref, (lambda x, w, dn=dn: F.rms_norm(x, (dn,), w, 1e-6), lib_sets),
            sets, 200, 1e3 * (3 * rn * dn * 2 + 2 * dn * 2) / bw, "bytes",
            rows if dn == d else logged)
        del sets, lib_sets
    gus = [(randn(R, F_), randn(R, F_, scale=3.0), randn(R, F_)) for _ in range(2)]
    row("silu_mul_bwd", silu_mul_bwd_cuda, silu_mul_bwd_ref, None, gus, 100,
        1e3 * (5 * R * F_ * 2) / bw, "bytes")
    del gus
    # qwen3-0.6b's training shape, B4 S2048 16/8 heads of 128, causal: the
    # wgmma engine's row beside SDPA's backward, then the mma.sync engine on
    # the same inputs, the two in turns (wgmma, mma.sync, mma.sync, wgmma;
    # kernel times drift as the card heats), each row's ms the mean of its
    # turns, and each wgmma launch under the profiler beside the bound of its
    # products; then, as logged rows with their launches, dbrx-132b's
    # training shape (B1 S2048 48/8 heads of 128), stablelm-3b's (B1 S2048
    # 32/32 heads of 80) and hymba-1.5b's global layer (B1 S1528 25/5 heads
    # of 64), the mma.sync engine in turns at shapes it no longer runs
    sdpa = (lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                           enable_gqa=True))
    for label, (B, S, Hq, Hkv, D) in (("qwen3-0.6b", (4, 2048, 16, 8, 128)),
                                      ("dbrx-132b", (1, 2048, 48, 8, 128)),
                                      ("stablelm-3b", (1, 2048, 32, 32, 80)),
                                      ("hymba-1.5b", (1, 1528, 25, 5, 64))):
        q, k, v = randn(B, S, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        dout = randn(B, S, Hq, D)
        out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        pairs = B * Hq * S * (S + 1) // 2
        flops = 10 * D * pairs
        nbytes = 2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        f_in = [(q, k, v, out, lse, dout)]
        main = label == "qwen3-0.6b"  # the wgmma engine's JSON row
        name = "flash_attention_bwd_wgmma" + ("" if main else f" ({label})")
        row(name, lambda *a: fa_k.flash_attention_bwd_wgmma_cuda(*a, causal=True),
            lambda q_, k_, v_, o_, l_, d_: attention_bwd_ref(q_, k_, v_, d_, causal=True),
            (sdpa, [(qt, kt, vt, dout.transpose(1, 2).contiguous())]), f_in, 5,
            *bound(peaks, nbytes, flops, "bfloat16"), into=rows if main else logged)
        r = (rows | logged)[name]
        turns = {"wgmma": [r["ms"]], "mma_sync": []}
        for engine in ("mma_sync", "mma_sync", "wgmma"):
            fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
            turns[engine].append(cuda_ms(torch, lambda *a, fn=fn: fn(*a, causal=True), f_in, 5)[0])
        r["ms"] = float(np.mean(turns["wgmma"]))
        old = dict(r, ms=float(np.mean(turns["mma_sync"])))
        logged[f"flash_attention_bwd ({label}, mma.sync in turns)"] = old
        log(f"  flash_attention_bwd at {label}'s training shape, in turns (ms): wgmma "
            f"{turns['wgmma']}, mma.sync {turns['mma_sync']}; the wgmma engine "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s of the 5 products (it computes 7: S and dP "
            f"in both launches), {r['bound_ms'] / r['ms']:.4f} of the bound, "
            f"{old['ms'] / r['ms']:.2f}x faster than mma.sync, library {r['library_ms']:.4f}")
        fa_launch_times(torch, fa_k, peaks, f_in[0], dict(causal=True), pairs)
        del q, k, v, dout, out, lse, qt, kt, vt, f_in
        torch.cuda.empty_cache()
    # f32, phase 10 (a)'s gradient runs: the 3xTF32 engine's row at
    # qwen3-0.6b's (B2 S256 16/8 heads of 128, causal; 16 input sets, 80 MB,
    # so that every call reads from device memory) and stablelm-3b's (B2 S256
    # 32/32 heads of 80, a logged row), each in turns with the FMA engine on
    # the same inputs (tf32, mma.sync, mma.sync, tf32), bounded as 3xTF32
    # (the FMA engine at the f32 peak), beside SDPA's backward in f32, each
    # 3xTF32 launch under the profiler
    f32 = torch.float32
    for label, (B, S, Hq, Hkv, D), n_sets in (("qwen3-0.6b", (2, 256, 16, 8, 128), 16),
                                              ("stablelm-3b", (2, 256, 32, 32, 80), 8)):
        sets = []
        for _ in range(n_sets):
            q, k, v = (randn(B, S, h, D, dtype=f32) for h in (Hq, Hkv, Hkv))
            dout = randn(B, S, Hq, D, dtype=f32)
            sets.append((q, k, v, *flash_attention_cuda(q, k, v, causal=True, return_lse=True),
                         dout))
        pairs = B * Hq * S * (S + 1) // 2
        nbytes = 4 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        main = label == "qwen3-0.6b"  # the 3xTF32 engine's JSON row
        name = "flash_attention_bwd_tf32" + ("" if main else f" ({label} f32)")
        row(name, lambda *a: fa_k.flash_attention_bwd_tf32_cuda(*a, causal=True),
            lambda q_, k_, v_, o_, l_, d_: attention_bwd_ref(q_, k_, v_, d_, causal=True),
            (sdpa, [(*(t.transpose(1, 2).contiguous().requires_grad_() for t in x[:3]),
                     x[5].transpose(1, 2).contiguous()) for x in sets]), sets, 20,
            *bound(peaks, nbytes, 3 * 10 * D * pairs, "tf32"), into=rows if main else logged)
        r = (rows | logged)[name]
        turns = {"tf32": [r["ms"]], "mma_sync": []}
        for engine in ("mma_sync", "mma_sync", "tf32"):
            fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
            turns[engine].append(cuda_ms(torch, lambda *a, fn=fn: fn(*a, causal=True), sets,
                                         20)[0])
        r["ms"] = float(np.mean(turns["tf32"]))
        b32, by32 = bound(peaks, nbytes, 10 * D * pairs, "float32")
        old = dict(r, ms=float(np.mean(turns["mma_sync"])), bound_ms=b32, bound_by=by32)
        logged[f"flash_attention_bwd ({label} f32, FMA in turns)"] = old
        log(f"  flash_attention_bwd at {label}'s f32 gradient shape, B{B} S{S} {Hq}/{Hkv}x{D} "
            f"causal, in turns (ms): 3xTF32 {turns['tf32']}, FMA {turns['mma_sync']}; 3xTF32 "
            f"{r['bound_ms'] / r['ms']:.4f} of its 3xTF32 bound {r['bound_ms']:.4f}, "
            f"{b32 / r['ms']:.4f} of the f32-peak bound {b32:.4f}, {old['ms'] / r['ms']:.2f}x "
            f"faster than the FMA engine; SDPA's backward {r['library_ms']:.4f}")
        fa_launch_times(torch, fa_k, peaks, sets[0], dict(causal=True), pairs, "tf32")
        del sets
        torch.cuda.empty_cache()
    # the FMA engine's row at the shape its main path runs: gemma2-2b's
    # gradient run of phase 10 (a), B1 S256 8/4 heads of 256, causal, window
    # 4096, softcap 50, f32, its bound at the f32 peak (no library call: SDPA
    # takes no softcap); 16 input sets
    B, S, Hq, Hkv, D = 1, 256, 8, 4, 256
    gkw32 = dict(causal=True, window=4096, softcap=50.0)
    sets = []
    for _ in range(16):
        q, k, v = (randn(B, S, h, D, dtype=f32) for h in (Hq, Hkv, Hkv))
        dout = randn(B, S, Hq, D, dtype=f32)
        sets.append((q, k, v, *flash_attention_cuda(q, k, v, return_lse=True, **gkw32), dout))
    pairs = B * Hq * S * (S + 1) // 2
    nbytes = 4 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
    row("flash_attention_bwd", lambda *a: fa_k.flash_attention_bwd_mma_sync_cuda(*a, **gkw32),
        lambda q_, k_, v_, o_, l_, d_: attention_bwd_ref(q_, k_, v_, d_, **gkw32), None, sets, 20,
        *bound(peaks, nbytes, 10 * D * pairs, "float32"))
    r = rows["flash_attention_bwd"]
    log(f"  flash_attention_bwd (FMA) at gemma2-2b's phase 10 (a) shape, B1 S256 8/4x256 "
        f"causal window 4096 softcap 50 f32: {r['ms']:.4f} ms, "
        f"{10 * D * pairs / r['ms'] / 1e9:.1f} TFLOP/s of the 5 products, "
        f"{r['bound_ms'] / r['ms']:.4f} of the f32 bound")
    del sets
    torch.cuda.empty_cache()
    # gemma2-2b's training shape, B1 S4096 8/4 heads of 256, window 4096,
    # softcap 50: the wgmma engine's row (no library call: SDPA takes no
    # softcap), then the mma.sync engine on the same inputs, the two in
    # turns (wgmma, mma.sync, mma.sync, wgmma; kernel times drift as the card
    # heats), each wgmma launch under the profiler beside the bound of its
    # products, and the causal-only yardstick: the wgmma engine with window
    # and softcap off beside SDPA's backward on those inputs (logged rows);
    # the window cuts no causal pair at S 4096
    B, S4, Hq, Hkv, D = 1, 4096, 8, 4, 256
    q, dout = randn(B, S4, Hq, D), randn(B, S4, Hq, D)
    k, v = randn(B, S4, Hkv, D), randn(B, S4, Hkv, D)
    gkw = dict(causal=True, window=4096, softcap=50.0)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **gkw)
    pairs = B * Hq * S4 * (S4 + 1) // 2
    g_bytes = 2 * (4 * B * S4 * Hq * D + 4 * B * S4 * Hkv * D) + 4 * B * Hq * S4
    g_bound = bound(peaks, g_bytes, 10 * D * pairs, "bfloat16")
    g_in = [(q, k, v, out, lse, dout)]
    g_name = "flash_attention_bwd_wgmma (gemma2-2b, D256)"
    row(g_name, lambda *a: fa_k.flash_attention_bwd_wgmma_cuda(*a, **gkw),
        lambda q_, k_, v_, o_, l_, d_: attention_bwd_ref(q_, k_, v_, d_, **gkw), None,
        g_in, 5, *g_bound, into=logged)
    turns = {"wgmma": [logged[g_name]["ms"]], "mma_sync": []}
    for engine in ("mma_sync", "mma_sync", "wgmma"):
        fn = getattr(fa_k, f"flash_attention_bwd_{engine}_cuda")
        turns[engine].append(cuda_ms(torch, lambda *a, fn=fn: fn(*a, **gkw), g_in, 5)[0])
    logged["flash_attention_bwd (gemma2-2b, D256, mma.sync)"] = dict(
        logged[g_name], ms=float(np.mean(turns["mma_sync"])))
    r = logged[g_name]
    log(f"  flash_attention_bwd at gemma2-2b's training shape, in turns (ms): wgmma "
        f"{turns['wgmma']}, mma.sync {turns['mma_sync']}; the wgmma engine "
        f"{10 * D * pairs / r['ms'] / 1e9:.1f} TFLOP/s of the 5 products, "
        f"{r['bound_ms'] / r['ms']:.4f} of the bound, "
        f"{np.mean(turns['mma_sync']) / np.mean(turns['wgmma']):.2f}x faster than mma.sync")
    fa_launch_times(torch, fa_k, peaks, g_in[0], gkw, pairs)
    ckw = dict(causal=True)
    out_c, lse_c = flash_attention_cuda(q, k, v, return_lse=True, **ckw)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    row("flash_attention_bwd_wgmma (gemma2-2b shape, causal only)",
        lambda *a: fa_k.flash_attention_bwd_wgmma_cuda(*a, **ckw),
        lambda q_, k_, v_, o_, l_, d_: attention_bwd_ref(q_, k_, v_, d_, **ckw),
        (lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True, enable_gqa=True),
         [(qt, kt, vt, dout.transpose(1, 2).contiguous())]),
        [(q, k, v, out_c, lse_c, dout)], 5, *g_bound, into=logged)
    del q, k, v, dout, out, lse, out_c, lse_c, qt, kt, vt, g_in
    torch.cuda.empty_cache()

    # fused MoE's backward at dbrx-132b's training shape (E16, 640 rows an
    # expert from 2048 tokens, bf16): the wgmma engine's row, then the
    # mma.sync engine's on the same inputs (the two compared in one call;
    # its plain and library times are the same call's); then at the tuner's
    # f32 workload (E16 C256) the 3xTF32 wgmma engine's row, in turns with
    # the mma.sync engine on the same inputs (tf32, mma.sync, mma.sync, tf32;
    # each row's ms the mean of its turns; the mma.sync one a logged row),
    # both bounded as 3xTF32, each 3xTF32 launch under the profiler; then
    # the 3xTF32 engine at dbrx's training rows in f32 (E16 C640, a logged
    # row); the library is three bmm and silu * u, differentiated by autograd
    # (``moe_library``)
    D, F_ = 6144, 10752
    for E, C, dt in ((16, 640, bf16), (16, 256, torch.float32), (16, 640, torch.float32)):
        x, dy = randn(E, C, D, dtype=dt), randn(E, C, D, dtype=dt)
        ws = [randn(*s_, scale=s_[1] ** -0.5, dtype=dt) for s_ in ((E, D, F_), (E, D, F_),
                                                                  (E, F_, D))]
        size = x.element_size()
        flops = 16 * E * C * D * F_
        nbytes = size * (3 * E * C * D + 6 * E * D * F_)  # x, dy, dx; the weights, their grads
        lib = [(*(t.detach().requires_grad_() for t in (x, *ws)), dy)]
        if dt == bf16:
            row("fused_moe_bwd_wgmma", moe_k.fused_moe_bwd_wgmma_cuda, fused_moe_bwd_ref,
                (moe_library, lib), [(x, *ws, dy)], 5, *bound(peaks, nbytes, flops, "bfloat16"))
            ms, eager["fused_moe_bwd"] = cuda_ms(torch, moe_k.fused_moe_bwd_mma_sync_cuda,
                                                 [(x, *ws, dy)], 5)
            rows["fused_moe_bwd"] = dict(rows["fused_moe_bwd_wgmma"], ms=ms)
            moe_launch_times(torch, moe_k, peaks, (x, *ws, dy))
            names = ("fused_moe_bwd_wgmma", "fused_moe_bwd")
        elif C == 256:
            row("fused_moe_bwd_tf32", moe_k.fused_moe_bwd_tf32_cuda, fused_moe_bwd_ref,
                (moe_library, lib), [(x, *ws, dy)], 3, *bound(peaks, nbytes, 3 * flops, "tf32"))
            r = rows["fused_moe_bwd_tf32"]
            turns = {"tf32": [r["ms"]], "mma_sync": []}
            for engine in ("mma_sync", "mma_sync", "tf32"):
                fn = getattr(moe_k, f"fused_moe_bwd_{engine}_cuda")
                turns[engine].append(cuda_ms(torch, fn, [(x, *ws, dy)], 3)[0])
            r["ms"] = float(np.mean(turns["tf32"]))
            names = ("fused_moe_bwd_tf32", "fused_moe_bwd (tuner E16 C256, f32)")
            logged[names[1]] = dict(r, ms=float(np.mean(turns["mma_sync"])))
            log(f"  fused_moe_bwd at the tuner's f32 workload, in turns (ms): 3xTF32 wgmma "
                f"{turns['tf32']}, mma.sync {turns['mma_sync']}; "
                f"{logged[names[1]]['ms'] / r['ms']:.2f}x faster than mma.sync, library "
                f"{r['library_ms']:.4f}")
            tf32_launch_times(torch, moe_k, peaks, (x, *ws, dy))
        else:
            names = ("fused_moe_bwd_tf32 (dbrx rows E16 C640, f32)",)
            row(names[0], moe_k.fused_moe_bwd_tf32_cuda, fused_moe_bwd_ref, (moe_library, lib),
                [(x, *ws, dy)], 3, *bound(peaks, nbytes, 3 * flops, "tf32"), into=logged)
        for kname in names:
            r = (rows | logged)[kname]
            log(f"  {kname}: {flops / 1e12:.3f} TFLOP in its products, {nbytes / 1e9:.2f} GB; "
                f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, {r['bound_ms'] / r['ms']:.4f} of the bound")
            if dt != bf16:
                # the 3xTF32 bound counts three products each, the price of f32
                # accuracy on the tensor cores; the function's own count at
                # the TF32 peak is the headroom left against plain TF32
                own = 1e3 * flops / peaks["tf32"]
                log(f"  {kname}: its own {flops / 1e12:.3f} TFLOP at the TF32 peak "
                    f"{own:.4f} ms, {own / r['ms']:.4f} of it (3xTF32's bound "
                    f"{r['bound_ms']:.4f} ms counts them three times)")
        del x, dy, ws, lib
        torch.cuda.empty_cache()
    for kname, r in (rows | logged).items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {kname}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {lib}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
    log("  backward, eager launches from Python, ms a call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in eager.items()))
    return rows


# ======================================================================
# phase 6: where a serving step's time goes
# ======================================================================


def profiled(torch, fn, steps, named=()):
    """Run ``fn`` ``steps`` times under ``torch.profiler``. Per step: the
    wall-clock of the profiled window (ended by a device sync), the device's
    busy time in that window (the union of its kernels and copies), the
    idle share left, the launches, the kernels taking the most time, and
    the device ms of the kernels whose names hold each string of ``named``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in work):
        if e > end:
            busy += e - max(s, end)
            end = e
    assert work, "the profiler saw no device work"
    busy_ms = busy / 1e3 / steps
    by_name = {}
    for e in work:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "launches": len(work) / steps,
            "top": [(name[:90], n / steps, us / 1e3 / steps) for name, (n, us) in top],
            "named_ms": {k: sum(us for name, (_, us) in by_name.items() if k in name) / 1e3 / steps
                         for k in named}}


def where_time_goes(torch, dev, params, cfg=None, max_len=4096, prompt_len=1024):
    """Profile decode ticks of a full slot pool and one prefill of
    ``cfg`` (default: qwen3-0.6b with bf16 compute, as served in phase 4),
    every prompt ``prompt_len`` tokens. Returns each step's shape, median
    unprofiled wall and device-busy ms: ``{"decode": {...}, "prefill":
    {...}}``, the decode tick's with ``kv``, its mean attended cache span
    (phase 13 bounds them)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    cfg = cfg or get_arch("qwen3-0.6b")
    slots, ticks, warm = 4, 8, 3
    eng = ContinuousBatchingEngine(cfg, params=params, slots=slots, max_len=max_len, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len) for _ in range(slots + 1)]
    for i, p in enumerate(prompts[:-1]):  # room for every tick below, so no slot retires
        eng.submit(Request(rid=i, prompt=p, max_new=warm + 2 * ticks + 2))
    batch = {"tokens": torch.as_tensor(prompts[-1][None, :], device=dev)}

    def prefill():
        eng._runner.prefill(batch)

    for _ in range(warm):  # the first tick admits (prefills) every slot
        eng.step()
    prefill()
    torch.cuda.synchronize()
    steps_seen = {}
    for kind, B, S, label, fn, steps in (
            ("decode", slots, max_len, f"{cfg.name} decode tick ({slots} slots, {prompt_len}-token "
             f"prompts)", eng.step, ticks),
            ("prefill", 1, prompt_len, f"{cfg.name} prefill (1 x {prompt_len} tokens)", prefill, 3)):
        span = max(s.pos for s in eng.slots) + 1  # the next tick's attended cache span
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        r = profiled(torch, fn, steps)
        log(f"  {label}: profiled wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms "
            f"(idle {100 * r['idle_share']:.1f}%), {r['launches']:.0f} launches; "
            f"unprofiled wall {float(np.median(walls)):.3f} ms")
        for name, n, ms in r["top"]:
            log(f"    {ms:9.4f} ms  x{n:<6g} {name}")
        steps_seen[kind] = {"B": B, "S": S, "wall_ms": float(np.median(walls)),
                            "busy_ms": r["busy_ms"]}
        if kind == "decode":  # the mean span of the 2 x ticks ticks measured, rounded up
            steps_seen[kind]["kv"] = span + steps
    return steps_seen


def where_time_goes_gemma2(torch, dev):
    """Phase 6 for gemma2-2b at full width and depth, bf16 compute: decode
    ticks of 4 slots over 4608-token prompts (past its 4096 window) in an
    8192-token cache, and one 4608-token prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model

    cfg = get_arch("gemma2-2b")
    params = build_model(cfg, "cuda").init(SEED)
    where_time_goes(torch, dev, params, cfg, max_len=8192, prompt_len=4608)
    del params
    torch.cuda.empty_cache()


def where_time_goes_ssm(torch, dev):
    """Phase 6 for mamba2-370m at full width and depth, bf16 compute, through
    the model API (the continuous engine takes KV-cache families only): one
    2048-token prefill (the SSD scan's chunk products and its chunk loop)
    and a decode step of 4 rows (the recurrent update)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model, materialize_batch

    cfg = get_arch("mamba2-370m")
    api = build_model(cfg, "cuda")
    params = T.cast_for_compute(api.init(SEED), cfg)
    batch = materialize_batch(cfg, 1, 2048, seed=SEED, device="cuda")
    with torch.no_grad():
        _, caches = api.prefill(params, materialize_batch(cfg, 4, 2048, seed=SEED, device="cuda"))
        tok = torch.ones(4, dtype=torch.long, device=dev)
        pos = torch.full((4,), 2048, device=dev)
        steps = (("decode step (4 rows)", lambda: api.decode(params, caches, tok, pos), 8),
                 ("prefill (1 x 2048 tokens)", lambda: api.prefill(params, batch), 3))
        for label, fn, n in steps:
            fn()
            r = profiled(torch, fn, n)
            log(f"  mamba2-370m {label}: profiled wall {r['wall_ms']:.3f} ms, device busy "
                f"{r['busy_ms']:.3f} ms (idle {100 * r['idle_share']:.1f}%), "
                f"{r['launches']:.0f} launches")
            for name, k, ms in r["top"]:
                log(f"    {ms:9.4f} ms  x{k:<6g} {name}")
    del params, caches
    torch.cuda.empty_cache()


def where_time_goes_moe(torch, dev):
    """Phase 6 for dbrx-132b at full width, 2 layers, bf16 compute; and the
    time of one layer's f32 to bf16 parameter cast (the engines cast once,
    when they take the parameters, so no serving step pays it)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_arch("dbrx-132b"), n_layers=2)
    params = build_model(cfg, "cuda").init(SEED)
    where_time_goes(torch, dev, params, cfg, max_len=2048)
    layer = params["segments"][0][0]
    nbytes = sum(a.numel() for a in layer.parameters()) * (4 + 2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    T._cast(layer, torch.bfloat16)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        T._cast(layer, torch.bfloat16)
    end.record()
    end.synchronize()
    log(f"  dbrx-132b one layer's f32 -> bf16 parameter cast: {start.elapsed_time(end) / 3:.3f} ms "
        f"({nbytes / 1e9:.2f} GB read and written), paid once per engine, not per step")
    del params, layer
    torch.cuda.empty_cache()


# ======================================================================
# phase 7: the tuner
# ======================================================================


def tuner(torch, dev):
    """``tune()`` on the card for fused MoE and scaled_mm, at the tuner's
    default workloads and at dbrx-132b width, and for flash attention and
    silu_mul at their qwen3-0.6b workloads, ranked with the roofline
    predictor of a registry TPU. The predictions price that TPU; the times
    are the H100's, and their rank correlation is logged, not judged."""
    from repro_torch.analysis.kernels import check_blocks
    from repro_torch.core.hardware import REGISTRY
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.fused_moe import ops as moe_ops
    from repro_torch.kernels.scaled_mm import kernel as smm_k
    from repro_torch.kernels.scaled_mm import ops as smm_ops
    from repro_torch.kernels.silu_mul import kernel as silu_k
    from repro_torch.kernels.silu_mul import ops as silu_ops
    from repro_torch.predict.backends import get_predictor
    from repro_torch.tune import DEFAULT_WORKLOADS, arch_workload, make_inputs, measure, tune
    from repro_torch.tune.__main__ import report_lines

    hw = REGISTRY["tpu-v4"]
    predictor = get_predictor("roofline", hw)
    # each kernel's module, ops and the count of the engine its inputs take
    # (fused MoE's and flash attention's f32: the 3xTF32 engine; scaled_mm's:
    # the wgmma engine; asserted below)
    kernels = {"fused_moe": (moe_k, moe_ops, "tf32_launches"),
               "scaled_mm": (smm_k, smm_ops, "wgmma_launches"),
               "flash_attention": (fa_k, fa_ops, "tf32_launches"),
               "silu_mul": (silu_k, silu_ops, "launches")}
    runs = [(k, kw) for k in ("fused_moe", "scaled_mm")
            for kw in (DEFAULT_WORKLOADS[k], arch_workload(k, "dbrx-132b"))]
    runs += [(k, arch_workload(k, "qwen3-0.6b")) for k in ("flash_attention", "silu_mul")]
    repeats = 3
    inputs = [make_inputs(k, kw, device="cuda") for k, kw in runs]  # the tuner's inputs
    torch.cuda.synchronize()
    for mod, _, count in kernels.values():
        setattr(mod, count, 0)
    moe_k.launches = 0  # fused MoE's mma.sync engine, which the tuner must not reach
    fa_k.launches = 0  # nor flash attention's FMA engine
    smm_k.launches = 0  # nor scaled_mm's mma.sync engine
    for (kernel, kw), args in zip(runs, inputs):
        mod, ops, count = kernels[kernel]
        if kernel == "fused_moe":
            assert moe_k.fwd_engine(args[0].dtype, kw["C"], kw["D"], kw["F"]) == "wgmma_tf32"
        if kernel == "flash_attention":
            assert fa_k.fwd_engine(args[0].dtype, kw["D"]) == "tf32"
        if kernel == "scaled_mm":
            assert smm_k.engine(**kw) == "wgmma"
        grids = []

        def timed(kernel, kw, blocks, *, args=None, repeats, device, _args=args, _mod=mod):
            s = measure(kernel, kw, blocks, args=_args, repeats=repeats, device=device)
            grids.append((dict(blocks), _mod.last_grid))
            return s

        before = getattr(mod, count)
        t0 = time.perf_counter()
        report = tune(kernel, hw, workload=kw, predictor=predictor, predictor_name="roofline",
                      top_k=4, repeats=repeats, device="cuda", measure_fn=timed)
        wall = time.perf_counter() - t0
        for line in report_lines(report):
            log("  " + line)
        distinct = {tuple(sorted(c.blocks.items())) for c in report.measured}
        distinct.add(tuple(sorted(report.default_blocks.items())))
        moved = getattr(mod, count) - before
        assert moved == (1 + repeats) * len(distinct) == (1 + repeats) * len(grids), (
            f"{kernel} {kw}: {moved} launches for {len(distinct)} configs")
        for blocks, grid in grids:
            assert grid == ops.grid_shape(**kw, **blocks), (kernel, kw, blocks, grid)
        assert not report.interpret and report.t_default > 0
        assert all(0 < c.measured_s < float("inf") for c in report.measured)
        assert not check_blocks(kernel, kw, report.best.blocks)
        log(f"    {len(grids)} configs measured in {wall:.1f}s, {moved} launches, every launched "
            f"grid equal to grid_shape")
        log(f"    {kernel} {kw}: default {report.default_blocks} {report.t_default * 1e3:.4f} ms, "
            f"picked {report.best.blocks} {report.best.measured_s * 1e3:.4f} ms")
    del inputs
    torch.cuda.empty_cache()
    launches = {k: getattr(mod, count) for k, (mod, _, count) in kernels.items()}
    assert all(v > 0 for v in launches.values()), launches
    assert moe_k.launches == 0, "the tuner's f32 fused MoE reached the mma.sync engine"
    assert fa_k.launches == 0, "the tuner's f32 flash attention reached the FMA engine"
    assert smm_k.launches == 0, "the tuner's scaled_mm reached the mma.sync engine"
    log(f"    launches in the tuner's runs: {launches} (fused_moe's and flash_attention's on "
        f"their 3xTF32 engines, scaled_mm's on its wgmma engine)")
    # the JSON line's counts: the tuner is the main path of these three
    return {"fused_moe_tf32": launches["fused_moe"], "scaled_mm_wgmma": launches["scaled_mm"],
            "flash_attention_tf32": launches["flash_attention"]}


# ======================================================================
# phase 8: the trained predictor on the card
# ======================================================================

# the reference's recorded accuracy (results/bench_baseline/metrics.json,
# BENCH_kernel_mape.json): printed beside this run's, not a gate
REFERENCE_REDUCTION = {"seen": 2.7074403831420653, "unseen": 1.7375928251074266}
# benchmarks/bench_kernel_mape.py's smoke criteria
MAX_MAPE = {"seen": 25.0, "unseen": 45.0}
MIN_ERROR_REDUCTION = 1.2
BASELINE_NAMES = ("roofline", "linear", "habitat", "neusight")


def trained_predictor(torch, dev, kinds):
    """Phase 8: build the six families' datasets from ``hwsim`` (220
    workloads each, as ``benchmarks/common.py``, with seeds fixed across
    processes), train the PipeWeave MLPs and the four baselines on the card,
    gate the seen/unseen MAPE table on ``bench_kernel_mape``'s smoke
    criteria, fit the P80 ceiling, round-trip the estimator through a
    pickle, then price full-width qwen3-0.6b's served steps with it
    (predicted admission) and place and replay requests over the registry.
    Returns the serving run's launches."""
    import tempfile
    import zlib

    from repro_torch.configs import get_arch
    from repro_torch.core.baselines import BASELINES
    from repro_torch.core.dataset import KERNELS, SEEN, build_dataset, mape
    from repro_torch.core.e2e import model_calls, place_request, simulate_fleet
    from repro_torch.core.estimator import PipeWeave, train_pipeweave
    from repro_torch.core.hardware import REGISTRY, get_hw
    from repro_torch.core.nn import fit_mlp
    from repro_torch.core.quantile import perf_gap, train_ceiling
    from repro_torch.models.registry import build_model
    from repro_torch.predict import get_predictor
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.trace import TraceRecorder

    # (a) data
    t0 = time.perf_counter()
    datasets = {k: build_dataset(k, n_workloads=220, seed=zlib.crc32(k.encode())) for k in KERNELS}
    log(f"  (a) datasets: {len(KERNELS)} families x 220 workloads x 11 registry TPUs = "
        f"{sum(len(d.X) for d in datasets.values())} rows in {time.perf_counter() - t0:.1f}s")

    # (b) the PipeWeave MLPs, one family at a time so each is timed
    models = {}
    for kind, ds in datasets.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models.update(train_pipeweave({kind: ds}, max_epochs=250, device=dev).models)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = models[kind]
        log(f"  (b) train {kind}: {len(ds.mask_hw(SEEN).X)} seen rows, {m.epochs} epochs "
            f"(max 250), {m.steps} steps in {wall:.2f}s = {1e3 * wall / m.steps:.3f} ms/step")
    pw = PipeWeave(models=models)
    # where a training step's time goes: a short fit of gemm under the profiler
    gemm = datasets["gemm"].mask_hw(SEEN)
    fits = []
    prof = profiled(torch, lambda: fits.append(
        fit_mlp(gemm.X, gemm.y_eff, max_epochs=20, min_epochs=20, device=dev)), 1)
    steps = fits[0].steps
    log(f"  (b) profiled fit of gemm, {steps} steps and {fits[0].epochs} validations: "
        f"{prof['wall_ms'] / steps:.3f} ms/step wall, {prof['busy_ms'] / steps:.4f} ms/step "
        f"device busy, idle {100 * prof['idle_share']:.1f}%, {prof['launches'] / steps:.1f} "
        f"launches a step")
    for name, n, ms in prof["top"][:5]:
        log(f"    {ms / steps:8.4f} ms/step  {n / steps:6.1f}x  {name}")

    # (c) the baselines and the MAPE table
    table = {}
    t0 = time.perf_counter()
    for kind, ds in datasets.items():
        seen = np.array([h in SEEN for h in ds.hw_names])
        preds = {"pipeweave": pw.predict_dataset(ds)}
        for b in BASELINE_NAMES:
            preds[b] = BASELINES[b]().fit(ds, device=dev).predict(ds)
        for name, p in preds.items():
            assert np.isfinite(p).all() and (p > 0).all(), (kind, name)
            for split, m in (("seen", seen), ("unseen", ~seen)):
                table[(kind, name, split)] = mape(p[m], ds.actual_s[m])
    log(f"  (c) baselines fitted in {time.perf_counter() - t0:.1f}s; MAPE % seen / unseen:")
    names = ("pipeweave", *BASELINE_NAMES)
    log("    " + f"{'family':<10}" + "".join(f"{n:>20}" for n in names))
    for kind in KERNELS:
        log("    " + f"{kind:<10}" + "".join(
            f"{table[(kind, n, 'seen')]:>10.2f}{table[(kind, n, 'unseen')]:>10.2f}" for n in names))
    avg = {(n, split): float(np.mean([table[(k, n, split)] for k in KERNELS]))
           for n in names for split in ("seen", "unseen")}
    log("    " + f"{'average':<10}" + "".join(
        f"{avg[(n, 'seen')]:>10.2f}{avg[(n, 'unseen')]:>10.2f}" for n in names))
    for split in ("seen", "unseen"):
        best = min(avg[(b, split)] for b in BASELINE_NAMES)
        reduction = best / max(avg[("pipeweave", split)], 1e-9)
        log(f"    error_reduction_{split}: {reduction:.4f} over the best baseline "
            f"({best:.2f}%); the reference recorded {REFERENCE_REDUCTION[split]:.4f}")
        assert avg[("pipeweave", split)] <= MAX_MAPE[split], (split, avg)
        assert reduction >= MIN_ERROR_REDUCTION, (split, reduction)

    # (d) the P80 ceiling (tests/test_core.py's criterion)
    t0 = time.perf_counter()
    moe = build_dataset("fused_moe", n_workloads=50, seed=6)
    ceiling = train_ceiling(moe, max_epochs=200, device=dev)
    gaps = perf_gap(ceiling, moe)
    above = float((gaps.gaps > -0.05).mean())
    log(f"  (d) P80 ceiling on fused_moe (50 workloads): {ceiling.model.epochs} epochs in "
        f"{time.perf_counter() - t0:.2f}s; {above:.3f} of the gaps above -0.05; "
        f"underperforming per TPU {gaps.per_hw_counts}")
    assert above > 0.6, above

    # (e) the pickle round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "pipeweave_torch_smoke.pkl")
        pw.save(path)
        loaded = PipeWeave.load(path)
    for ds in datasets.values():
        assert np.array_equal(loaded.predict_dataset(ds), pw.predict_dataset(ds)), ds.kind
    log("  (e) pickle round trip: predictions bit-equal on every row")

    # (f) pricing served steps: qwen3-0.6b at full width, predicted admission
    hw = get_hw("tpu-v5e")
    synperf = get_predictor("synperf", hw, estimator=pw)
    cfg = get_arch("qwen3-0.6b")
    params = build_model(cfg, "cuda").init(SEED)
    n = cfg.n_layers
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(L)) for L in rng.integers(512, 2049, 6)]
    spans = sorted(len(p) + 16 + 1 for p in prompts)
    slo = synperf.predict(model_calls(cfg, 4, 1, spans[len(spans) // 2], tp=1)).total_s
    eng = ContinuousBatchingEngine(cfg, params=params, slots=4, max_len=4096,
                                   recorder=TraceRecorder(), admission="predicted",
                                   predictor=synperf, decode_slo_s=slo, device="cuda")
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        moved = serve_run(torch, kinds, "(f) ContinuousBatchingEngine(slots=4, "
                          "admission='predicted', synperf)", eng, prompts, 16,
                          {"rmsnorm": 4 * n + 1, "silu_mul": n}, {"flash_attention": n},
                          predictor=synperf)
    deferred = sum(not d["admitted"] for d in eng.admission_log)
    log(f"    prediction for the registry TPU {hw.name} (synperf backend), not this card: "
        f"decode_slo_s {slo:.6f} s at a {spans[len(spans) // 2]}-token span; admissions "
        f"predicted {[round(d['predicted_s'], 6) for d in eng.admission_log[:8]]} s")
    assert deferred > 0, "the synperf-priced SLO deferred no admission"
    assert eng.admission == "predicted" and eng.admission_fallback_reason is None
    log(f"    {deferred} admissions deferred, {eng.slo_forced_admits} forced "
        f"({len(warned)} warnings), every request completed")
    del eng, params
    torch.cuda.empty_cache()

    # (g) the fleet: place and replay qwen3-0.6b requests over the registry
    t0 = time.perf_counter()
    pl = place_request(cfg, 4, 1024, 128, backend="synperf", estimator=pw, objective="latency")
    assert set(pl.ranking()) == set(REGISTRY) and not pl.skipped, pl.table()
    log(f"  (g) place_request(qwen3-0.6b, B=4, lin=1024, lout=128), predictions for the "
        f"registry TPUs (synperf backend), not this card:")
    for line in pl.table().splitlines():
        log("    " + line)
    report = simulate_fleet(cfg, 1, 512, 64, rate_rps=20.0, n_requests=400, replicas=2,
                            backend="synperf", estimator=pw, seed=SEED)
    assert report.n_requests == 400 and np.isfinite(report.latencies).all()
    assert report.latency_p95_s >= report.latency_p50_s > 0
    log(f"    simulate_fleet(qwen3-0.6b, B=1, lin=512, lout=64, 20 req/s, 400 requests, 2 "
        f"replicas), predicted for the registry TPUs: assignment {report.assignment}, "
        f"p50 {report.latency_p50_s:.6f} s, p95 {report.latency_p95_s:.6f} s "
        f"({time.perf_counter() - t0:.2f}s)")
    return moved


# ======================================================================
# phase 10: training
# ======================================================================

# the 2-layer f32 loss, card against CPU: relative
TRAIN_LOSS_RTOL = 1e-5
# each gradient leaf, card against CPU: of that leaf's max|g| (f32 sums over
# 512 rows and vocab 151936 run in other orders on the card and the CPU)
TRAIN_GRAD_TOL = 1e-4


def kernel_counts(zero=False):
    """Every forward and backward kernel's launch count (set to 0 first
    with ``zero``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_k
    from repro_torch.kernels.fused_moe import kernel as moe_k
    from repro_torch.kernels.rmsnorm import kernel as rms_k
    from repro_torch.kernels.silu_mul import kernel as silu_k

    counters = {}
    for name, mod in (("rmsnorm", rms_k), ("silu_mul", silu_k), ("flash_attention", fa_k),
                      ("fused_moe", moe_k)):
        counters[name] = (mod, "launches")
        counters[name + "_bwd"] = (mod, "bwd_launches")
    counters["fused_moe_wgmma"] = (moe_k, "wgmma_launches")
    counters["fused_moe_tf32"] = (moe_k, "tf32_launches")
    counters["fused_moe_bwd_wgmma"] = (moe_k, "bwd_wgmma_launches")
    counters["fused_moe_bwd_tf32"] = (moe_k, "bwd_tf32_launches")
    counters["flash_attention_bwd_wgmma"] = (fa_k, "bwd_wgmma_launches")
    counters["flash_attention_wgmma"] = (fa_k, "wgmma_launches")
    counters["flash_attention_tf32"] = (fa_k, "tf32_launches")
    counters["flash_attention_bwd_tf32"] = (fa_k, "bwd_tf32_launches")
    if zero:
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def training_launches(cfg):
    """What one training step of a dense or MoE decoder adds to each count:
    under layer remat each layer's forward runs twice (in the forward pass
    and again in the backward pass), the final norm once; each backward
    once. An MoE layer's FFN is one fused_moe call (and a silu_mul one for
    a dense residual FFN), whose forward runs on the engine ``fwd_engine``
    picks for the compute type and widths (``moe_fwd_engine``) and whose
    backward on the engine ``bwd_engine`` picks; flash attention's
    forward and backward run on the engines its ``fwd_engine`` and
    ``bwd_engine`` pick for the compute type and head dim."""
    import torch

    from repro_torch.kernels.fused_moe.kernel import bwd_engine

    n = cfg.n_layers
    twice = 2 if cfg.remat == "layer" else 1
    # rmsnorm's launches a layer (layernorm is plain PyTorch), and the final norm's
    norms, final = (0, 0) if cfg.norm == "layernorm" else (
        2 + 2 * cfg.qk_norm + 2 * cfg.post_norms, 1)
    moe = cfg.family == "moe"
    dense = n if not moe or cfg.dense_residual else 0
    engine = moe and bwd_engine(getattr(torch, cfg.compute_dtype), cfg.d_model, cfg.moe_hidden)
    fwd = moe_fwd_engine(cfg)
    fa_fwd, fa_bwd = model_fa_engines(cfg)
    return {"rmsnorm": twice * norms * n + final, "rmsnorm_bwd": norms * n + final,
            "silu_mul": twice * dense, "silu_mul_bwd": dense,
            **{name: twice * n * (fa_fwd == e) for e, name in FA_FWD_COUNT.items()},
            **{name: n * (fa_bwd == e) for e, name in FA_BWD_COUNT.items()},
            **{name: twice * n * (fwd == e) for e, name in MOE_FWD_COUNT.items()},
            "fused_moe_bwd": n * moe * (engine == "mma_sync"),
            "fused_moe_bwd_wgmma": n * moe * (engine == "wgmma"),
            "fused_moe_bwd_tf32": n * moe * (engine == "wgmma_tf32")}


def training(torch, dev):
    """Phase 10 (the module docstring's (a)-(e)). Returns the launches of
    the gradient runs (a), the full-depth training run (b) and the runs of
    (d) and (e), and (b)'s step: ``B``, ``S``, the
    median unprofiled step wall and the profiled step's device-busy ms, and
    the bytes of the train state and batch it held on the card (phase 13
    bounds it)."""
    import os
    import shutil
    import tempfile
    import warnings

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.dryrun import local_nbytes
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import (
        TrainConfig,
        init_train_state,
        make_optimizer,
        make_train_step,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()  # what earlier phases left for the collector
    torch.cuda.empty_cache()
    log(f"  held on the card before phase 10: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (a) one loss and its gradients, card against CPU, same weights:
    # qwen3-0.6b, stablelm-3b (the backward kernel's head dim 80), gemma2-2b
    # (head dim 256, its windows and softcaps) and one full-width dbrx-132b
    # layer (fused_moe's backward; gradients only: the optimizer state would
    # not fit beside a full-width f32 layer); their launches join the ones
    # returned (f32 training: fused_moe's backward on its 3xTF32 wgmma engine)
    grad_runs = {}
    for arch, depth, B_, S_ in (("qwen3-0.6b", 2, 2, 256), ("stablelm-3b", 2, 2, 256),
                                ("gemma2-2b", 2, 1, 256), ("dbrx-132b", 1, 1, 128)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), n_layers=depth, compute_dtype="float32")
        params = build_model(cfg, "cuda").init(SEED)
        tokens = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, (B_, S_))

        def loss_and_grads(tree, device, cfg=cfg, tokens=tokens):
            leaves_tree = T.trainable(tree)
            leaves = tree_leaves(leaves_tree)
            loss, _ = build_model(cfg, device).loss(
                leaves_tree, {"tokens": torch.from_numpy(tokens).to(device)})
            return float(loss), [g.float() for g in torch.autograd.grad(loss, leaves)]

        kernel_counts(zero=True)
        loss_gpu, g_gpu = loss_and_grads(params, dev)  # kept on the card
        torch.cuda.synchronize()
        moved = kernel_counts()
        assert moved == training_launches(cfg), f"(a) {arch} launches {moved}"
        for k, v in moved.items():
            grad_runs[k] = grad_runs.get(k, 0) + v
        t1 = time.perf_counter()
        host = T.tree_map(lambda a: a.detach().cpu(), params)
        del params
        loss_cpu, g_cpu = loss_and_grads(host, "cpu")
        del host
        rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        assert rel <= TRAIN_LOSS_RTOL, (
            f"(a) {arch} loss {loss_gpu} on the card, {loss_cpu} on the CPU")

        def ratio(a, b, i, arch=arch):
            """|a - b| over max|b| of one leaf, compared on the card (18 GB for dbrx)."""
            b = b.to(dev)
            scale = float(b.abs().max())
            assert float(a.abs().max()) > 0 and scale > 0, f"(a) {arch} gradient leaf {i} is zero"
            return float((a - b).abs().max()) / scale

        ratios = []
        for i, (a, b) in enumerate(zip(g_gpu, g_cpu)):
            ratios.append(ratio(a, b, i))
            assert ratios[-1] <= TRAIN_GRAD_TOL, (
                f"(a) {arch} gradient leaf {i}: {ratios[-1]:.3g} of max|g|")
        del a, b
        log(f"  (a) {arch} full width, {depth} layer(s), f32, B{B_} S{S_}: loss {loss_gpu:.6f} on "
            f"the card, {loss_cpu:.6f} on the CPU (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL}); "
            f"{len(ratios)} gradient leaves, each present and non-zero, the worst "
            f"{max(ratios):.3g} of its max|g| (median {float(np.median(ratios)):.3g}, tol "
            f"{TRAIN_GRAD_TOL}); launches {moved}; card {t1 - t0:.1f}s, CPU "
            f"{time.perf_counter() - t1:.1f}s")
        del g_gpu, g_cpu
        gc.collect()
        torch.cuda.empty_cache()

    # (b) full depth through Trainer, checkpoints, a bit-equal restart
    cfg = get_arch("qwen3-0.6b")
    B, S, steps = 4, 2048, 10
    tc = TrainConfig(lr=1e-3, warmup=2, total_steps=steps)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)  # the embedding's index_put
    # the mode's NaN fill of every torch.empty is a debugging aid, not part
    # of any algorithm: left off, so that the step times are the step's
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")

            def trainer():
                return Trainer(cfg, DataConfig(batch=B, seq_len=S, seed=SEED), tc,
                               TrainerConfig(total_steps=steps, ckpt_every=5, ckpt_dir=tmp,
                                             async_save=True, log_every=steps), device="cuda")

            tr = trainer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            kernel_counts(zero=True)
            t0 = time.perf_counter()
            _, state, losses = tr.run(seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            moved = kernel_counts()
            peak = torch.cuda.max_memory_allocated()
            per_step = training_launches(cfg)
            assert moved == {k: steps * v for k, v in per_step.items()}, (
                f"(b) launches {moved}")
            assert np.isfinite(losses).all() and losses[-1] < losses[0], f"(b) losses {losses}"
            step_ms = 1e3 * float(np.median(tr.step_times[1:]))
            n = sum(p.numel() for p in tree_leaves(state["params"]))
            batch = tr.batch_at(steps)
            held_bytes = local_nbytes(state) + local_nbytes(batch)
            log(f"  (b) qwen3-0.6b, 28 layers ({n / 1e9:.4f}B parameters), bf16 compute, f32 "
                f"master weights, B{B} S{S}: {steps} steps in {wall:.1f}s (checkpoints at 5 and "
                f"10 included); losses {[round(x, 4) for x in losses]}")
            log(f"  (b) step wall-clock (train_step to its loss on the host) median "
                f"{step_ms:.1f} ms (steps 2-{steps}; the first {1e3 * tr.step_times[0]:.1f} ms), "
                f"{B * S / step_ms * 1e3:.0f} tokens/s; torch.cuda.max_memory_allocated "
                f"{peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB of it held before the run "
                f"began; launches a step {per_step}")

            def one_step():
                nonlocal state
                state, _ = tr.train_step(state, batch)

            r = profiled(torch, one_step, 1, named=("fa_bwd_",))
            log(f"  (b) one training step under torch.profiler: profiled wall {r['wall_ms']:.3f} "
                f"ms, device busy {r['busy_ms']:.3f} ms (idle {100 * r['idle_share']:.1f}%), "
                f"{r['launches']:.0f} launches; flash attention's backward kernels "
                f"{r['named_ms']['fa_bwd_']:.3f} ms of it")
            for name, k, ms in r["top"]:
                log(f"    {ms:9.4f} ms  x{k:<6g} {name}")
            measured = {"B": B, "S": S, "wall_ms": step_ms, "busy_ms": r["busy_ms"],
                        "held_bytes": held_bytes}
            del state, tr
            torch.cuda.empty_cache()
            shutil.rmtree(os.path.join(tmp, f"step_{steps:010d}"))
            t0 = time.perf_counter()
            tr = trainer()
            _, _, resumed = tr.run(seed=SEED)
            assert resumed == losses[5:], f"(b) resumed {resumed} vs {losses[5:]}"
            log(f"  (b) restarted from the step-5 checkpoint: steps 6-{steps} bit-equal "
                f"({time.perf_counter() - t0:.1f}s)")
            del tr
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) error-feedback compression (bucketed), and microbatches
    api = build_model(cfg, "cuda")
    source = SyntheticLM(cfg, DataConfig(batch=B, seq_len=S, seed=SEED))
    for label, tcx in (("compress_grads + overlap_grads",
                        dataclasses.replace(tc, compress_grads=True, overlap_grads=True)),
                       ("microbatches=2", dataclasses.replace(tc, microbatches=2))):
        t0 = time.perf_counter()
        opt = make_optimizer(tcx)
        st = init_train_state(api, opt, SEED, compress_grads=tcx.compress_grads)
        step = make_train_step(api, opt, tcx)
        ls = []
        for i in range(2):
            st, m = step(st, {k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()})
            ls.append(float(m["loss"]))
        assert np.isfinite(ls).all(), f"(c) {label}: losses {ls}"
        log(f"  (c) {label}: losses {ls} ({time.perf_counter() - t0:.1f}s)")
        del st
        torch.cuda.empty_cache()
    del api, source
    gc.collect()
    torch.cuda.empty_cache()

    # (d) gemma2-2b at full width, 5 bf16 steps of B1 S4096 (f32 master
    # weights, layer remat): at full depth if the train state fits beside its
    # activations, else at the deepest that does (an even depth: its layers
    # alternate local and global)
    g_cfg = get_arch("gemma2-2b")
    card = torch.cuda.mem_get_info()[1]

    def need(n):
        """Bytes a step at ``n`` layers peaks at: f32 parameters, their
        gradients and both moments, and AdamW's functional update's new
        parameters and moments and scaled gradients (8 x 4 bytes a
        parameter), beside the f32 logits' work (3 x 4 bytes a logit)."""
        params = dataclasses.replace(g_cfg, n_layers=n).n_params()
        return 32 * params + 12 * 4096 * g_cfg.padded_vocab

    depths = [n for n in range(g_cfg.n_layers, 0, -2) if need(n) <= card]
    log(f"  (d) gemma2-2b: {g_cfg.n_layers} layers need about {need(g_cfg.n_layers) / 1e9:.1f} GB "
        f"({g_cfg.n_params() / 1e9:.3f} B parameters), the card holds {card / 1e9:.1f}: "
        f"the deepest that fits is {depths[0]}")
    for depth in depths[:3]:
        try:
            run = train_steps(torch, dev, dataclasses.replace(g_cfg, n_layers=depth), 1, 4096, 5,
                              named=("fa_bwd_", "fa_bf16_kernel", "fa_fwd_wgmma"))
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"  (d) gemma2-2b at {depth} layers does not fit: {str(e).splitlines()[0]}")
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise RuntimeError(f"(d) gemma2-2b does not train at {depths[:3]} layers")
    prof = run["prof"]
    log(f"  (d) gemma2-2b, {depth} layers ({run['params'] / 1e9:.4f}B parameters), bf16 compute, "
        f"f32 master weights, B1 S4096: losses {[round(x, 4) for x in run['losses']]}; step "
        f"wall-clock median {run['step_ms']:.1f} ms (steps 2-5; the first "
        f"{run['first_ms']:.1f} ms), {4096 / run['step_ms'] * 1e3:.0f} tokens/s; "
        f"torch.cuda.max_memory_allocated {run['peak'] / 2**30:.2f} GiB; one more step under "
        f"torch.profiler: wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy), {prof['launches']:.0f} "
        f"launches; launches a step {run['per_step']}")
    fa_bwd = prof["named_ms"]["fa_bwd_"]
    log(f"  (d) gemma2-2b: flash attention's backward kernels {fa_bwd:.3f} ms "
        f"({100 * fa_bwd / prof['busy_ms']:.1f}% of device busy; on the "
        f"{'wgmma' if run['moved']['flash_attention_bwd_wgmma'] else 'mma.sync'} engine), its "
        f"forward kernels {prof['named_ms']['fa_fwd_wgmma']:.3f} ms on the wgmma engine and "
        f"{prof['named_ms']['fa_bf16_kernel']:.3f} ms on the mma.sync one")
    assert run["moved"]["flash_attention_wgmma"] > 0 == run["moved"]["flash_attention"], (
        f"(d) flash attention's forward did not run on the wgmma engine: {run['moved']}")
    assert run["moved"]["flash_attention_bwd_wgmma"] == 5 * depth, (
        f"(d) flash attention's backward did not run on the wgmma engine: {run['moved']}")
    for name, k, ms in prof["top"]:
        log(f"    {ms:9.4f} ms  x{k:<6g} {name}")
    for k, v in run["moved"].items():
        moved[k] += v
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # (e) one full-width dbrx-132b layer's forward and backward, bf16
    # compute, 2048 tokens, and fused_moe's backward share of its device time
    cfg = dataclasses.replace(get_arch("dbrx-132b"), n_layers=1)
    api = build_model(cfg, "cuda")
    tree = T.trainable(api.init(SEED))
    leaves = tree_leaves(tree)
    tokens = torch.from_numpy(
        np.random.default_rng(SEED + 4).integers(0, cfg.vocab_size, (1, 2048))).to(dev)

    def fwd_bwd():
        loss, _ = api.loss(tree, {"tokens": tokens})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    kernel_counts(zero=True)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, grads = fwd_bwd()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    layer_moved = kernel_counts()
    assert layer_moved == {k: 3 * v for k, v in training_launches(cfg).items()}, (
        f"(e) launches {layer_moved}")
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    assert layer_moved["fused_moe_bwd_wgmma"] == 3 and layer_moved["fused_moe_bwd"] == 0, (
        f"(e) fused_moe's backward did not run on the wgmma engine: {layer_moved}")
    assert layer_moved["fused_moe_wgmma"] == 6 and layer_moved["fused_moe"] == 0, (
        f"(e) fused_moe's forward (twice a step: remat) did not run on the wgmma engine: "
        f"{layer_moved}")
    r = profiled(torch, fwd_bwd, 1,
                 named=("moe_bwd_", "moe_gate_up", "moe_down", "moe_fwd_wgmma"))
    share = r["named_ms"]["moe_bwd_"] / r["busy_ms"]
    log(f"  (e) dbrx-132b, 1 layer at full width, bf16 compute, B1 S2048: forward and backward "
        f"median {float(np.median(walls)):.1f} ms, {2048 / float(np.median(walls)) * 1e3:.0f} "
        f"tokens/s; under torch.profiler: wall {r['wall_ms']:.3f} ms, device busy "
        f"{r['busy_ms']:.3f} ms (idle {100 * r['idle_share']:.1f}%), {r['launches']:.0f} launches; "
        f"fused_moe's backward kernels (wgmma) {r['named_ms']['moe_bwd_']:.3f} ms "
        f"({100 * share:.1f}% of device busy), its forward's twice (wgmma) "
        f"{r['named_ms']['moe_fwd_wgmma']:.3f} ms (mma.sync "
        f"{r['named_ms']['moe_gate_up'] + r['named_ms']['moe_down']:.3f})")
    for name, k, ms in r["top"]:
        log(f"    {ms:9.4f} ms  x{k:<6g} {name}")
    for k, v in (*layer_moved.items(), *grad_runs.items()):
        moved[k] += v
    del api, tree, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return moved, measured


def train_steps(torch, dev, cfg, B, S, steps, named=()):
    """``steps`` training steps of ``cfg`` through ``make_train_step`` from
    a fresh train state, then one more under ``torch.profiler``: the losses,
    the median step wall (steps 2 on), the first step's, the memory peak,
    the launches (each count exactly ``steps`` x ``training_launches``), the
    parameter count and the profile (with the device ms of the kernels
    whose names hold each string of ``named``)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import (
        TrainConfig,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    api = build_model(cfg, "cuda")
    tc = TrainConfig(lr=3e-4, warmup=1, total_steps=steps + 1)  # launch.train's rate
    opt = make_optimizer(tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(api, opt, SEED)
    step = make_train_step(api, opt, tc)
    source = SyntheticLM(cfg, DataConfig(batch=B, seq_len=S, seed=SEED))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()}
               for i in range(steps + 1)]
    kernel_counts(zero=True)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
        times.append(1e3 * (time.perf_counter() - t0))
    moved = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = training_launches(cfg)
    assert moved == {k: steps * v for k, v in per_step.items()}, f"launches {moved}"
    assert np.isfinite(losses).all() and losses[-1] < losses[0], f"losses {losses}"

    def one_step():
        nonlocal state
        state, _ = step(state, batches[steps])

    prof = profiled(torch, one_step, 1, named=named)
    n = sum(p.numel() for p in tree_leaves(state["params"]))
    return {"losses": losses, "step_ms": float(np.median(times[1:])), "first_ms": times[0],
            "peak": peak, "moved": moved, "per_step": per_step, "params": n, "prof": prof}


# ======================================================================
# phase 11: the static auditor
# ======================================================================


def static_audit(torch, dev, smi):
    """Phase 11 (the module docstring's (a), (b))."""
    import os

    from repro_torch.analysis import AuditError
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core.hardware import get_hw
    from repro_torch.predict import CommRegressor, get_predictor
    from repro_torch.serve.engine import ContinuousBatchingEngine

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--strict", "--json"],
        capture_output=True, text=True, cwd=root, env=env, timeout=600,
    )
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, f"(a) auditor exit {proc.returncode}: {proc.stderr[-2000:]}"
    diags = json.loads(proc.stdout)
    assert all(d["severity"] == "info" for d in diags), diags
    archs = {d["arch"] for d in diags if d["code"] == "SP105"}
    assert archs == set(list_archs()) and len(archs) == 10, archs
    assert torch.cuda.memory_allocated() == held, "(a) the audit moved CUDA memory"
    log(f"  (a) python -m repro_torch.analysis --all --strict --json: exit 0, {len(diags)} "
        f"findings, all info (SP105 for each of the {len(archs)} archs), {wall:.2f}s wall "
        f"(card: {smi}); CUDA memory held {held / 2**30:.2f} GiB before and after")

    hw = get_hw("tpu-v5e")
    stale = CommRegressor().fit(hw)  # fitted before all_to_all joined CommRegressor.OPS
    for k in [k for k in stale.theta if k[0] == "all_to_all"]:
        del stale.theta[k]
    bad = get_predictor("roofline", hw, comm=stale)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    try:
        ContinuousBatchingEngine(get_arch("qwen3-0.6b"), slots=4, max_len=4096,
                                 admission="predicted", predictor=bad, decode_slo_s=1.0,
                                 audit=True, device="cuda")
    except AuditError as e:
        codes = [d.code for d in e.diagnostics]
    else:
        raise AssertionError("(b) a stale CommRegressor passed the audit")
    torch.cuda.synchronize()
    assert codes == ["SP401"], codes
    assert torch.cuda.memory_allocated() == held, "(b) the refused engine allocated CUDA memory"
    log(f"  (b) a stale CommRegressor: AuditError {codes} before any parameter was built; "
        f"CUDA memory held {held / 2**30:.2f} GiB before and after")


# ======================================================================
# phase 12: the mesh path (DTensors on a one-rank NCCL group)
# ======================================================================


def mesh_path(torch, dev, kinds, smi):
    """Phase 12 (the module docstring's (a), (b), (c)). Returns the launches
    of the mesh engines' runs in (a) and the mesh forward in (c)."""
    import os
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.sharding import param_pspecs, place, use_mesh
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServeEngine
    from repro_torch.serve.trace import TraceRecorder
    from repro_torch.train.step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    totals = {k: 0 for k in kinds}
    try:
        with process_group(os.path.join(tmp, "rendezvous"), backend="nccl"):
            mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
            t_part = time.perf_counter()

            # (a) both engines, with and without the mesh, on the same weights
            cfg = get_arch("qwen3-0.6b")
            n = cfg.n_layers
            params = build_model(cfg, "cuda").init(SEED)
            per_forward = {"rmsnorm": 4 * n + 1, "silu_mul": n}
            per_prefill = {"flash_attention": n}
            rng = np.random.default_rng(SEED + 12)
            prompts = [rng.integers(1, cfg.vocab_size, int(L)) for L in (300, 517, 256, 129)]
            for label, make in (
                ("ServeEngine(max_batch=4)", lambda m: ServeEngine(
                    cfg, params=params, max_batch=4, recorder=TraceRecorder(), mesh=m,
                    device="cuda")),
                ("ContinuousBatchingEngine(slots=4, max_len=1024)",
                 lambda m: ContinuousBatchingEngine(
                     cfg, params=params, slots=4, max_len=1024, recorder=TraceRecorder(),
                     mesh=m, device="cuda")),
            ):
                got = {}
                for m in (None, mesh):
                    eng, results = make(m), []
                    tag = f"{label}{' on the (1, 1) mesh' if m is not None else ''}"
                    moved = serve_run(torch, kinds, tag, eng, prompts, 12, per_forward,
                                      per_prefill, results_out=results)
                    ticks = [x.measured_s for x in eng.recorder.meta if x.phase == "decode"]
                    got[m is not None] = ({r.rid: r.tokens for r in results}, moved,
                                          1e3 * float(np.median(ticks)))
                    if m is not None:
                        assert eng.tp == 1 and all(x.tp == 1 for x in eng.recorder.meta)
                        leaf = eng.params["embed"]["head"]
                        assert type(leaf.data).__name__ == "DTensor", type(leaf.data)
                        for k, v in moved.items():
                            totals[k] += v
                    del eng
                (ref, moved0, tick0), (tok, moved1, tick1) = got[False], got[True]
                assert tok == ref, f"(a) {label}: tokens on the mesh differ"
                assert moved1 == moved0, f"(a) {label}: launches {moved1} vs {moved0}"
                log(f"  (a) {label}: tokens equal the meshless engine's; launches {moved1} "
                    f"equal; median decode tick {tick0:.2f} ms without the mesh, {tick1:.2f} "
                    f"ms on it (card: {smi})")
            del params
            torch.cuda.empty_cache()
            log(f"  (a) {time.perf_counter() - t_part:.1f}s")
            t_part = time.perf_counter()

            # (b) loss and gradients on the mesh, then Trainer(mesh=) checkpoints
            cfg = dataclasses.replace(get_arch("qwen3-0.6b"), n_layers=2,
                                      compute_dtype="float32")
            api = build_model(cfg, "cuda")
            base = T.trainable(api.init(SEED))
            tokens = torch.from_numpy(
                np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, (2, 256))).to(dev)

            def loss_and_grads(tree):
                leaves = tree_leaves(tree)
                loss, _ = api.loss(tree, {"tokens": tokens})
                grads = torch.autograd.grad(loss, leaves)
                full = [g.full_tensor() if hasattr(g, "full_tensor") else g for g in grads]
                loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
                return float(loss.detach()), [g.float() for g in full]

            kernel_counts(zero=True)
            loss0, g0 = loss_and_grads(base)
            moved0 = kernel_counts()
            kernel_counts(zero=True)
            with use_mesh(mesh):
                placed = place(base, param_pspecs(base, mesh), mesh)
                for leaf in tree_leaves(placed):
                    leaf.requires_grad_(True)
                loss1, g1 = loss_and_grads(placed)
            moved1 = kernel_counts()
            assert moved1 == moved0, f"(b) launches {moved1} vs {moved0}"
            rel = abs(loss1 - loss0) / abs(loss0)
            assert rel <= TRAIN_LOSS_RTOL, f"(b) loss {loss1} on the mesh, {loss0} without"
            ratios = []
            for i, (a, b) in enumerate(zip(g1, g0)):
                scale = float(b.abs().max())
                assert scale > 0, f"(b) gradient leaf {i} is zero"
                ratios.append(float((a - b).abs().max()) / scale)
                assert ratios[-1] <= TRAIN_GRAD_TOL, f"(b) gradient leaf {i}: {ratios[-1]:.3g}"
            log(f"  (b) qwen3-0.6b full width, 2 layers, f32, B2 S256: loss {loss1:.6f} on the "
                f"mesh, {loss0:.6f} without (rel {rel:.3g}); {len(ratios)} gradient leaves, the "
                f"worst {max(ratios):.3g} of its max|g|; launches {moved1} equal")
            del base, placed, g0, g1

            def trainer(ckpt_dir, total, m):
                return Trainer(cfg, DataConfig(batch=2, seq_len=256, seed=SEED),
                               TrainConfig(lr=1e-3, warmup=1, total_steps=4),
                               TrainerConfig(total_steps=total, ckpt_every=2,
                                             ckpt_dir=ckpt_dir, log_every=100),
                               mesh=m, device="cuda")

            for saved_on, other in ((mesh, None), (None, mesh)):
                first = os.path.join(tmp, "first")
                trainer(first, 2, saved_on).run(seed=SEED)
                second = os.path.join(tmp, "second")
                shutil.copytree(first, second)
                same = trainer(first, 3, saved_on).run(seed=SEED)[2]
                moved = trainer(second, 3, other).run(seed=SEED)[2]
                assert len(same) == len(moved) == 1, (same, moved)
                rel = abs(moved[0] - same[0]) / abs(same[0])
                assert rel <= TRAIN_LOSS_RTOL, f"(b) resumed step 3: {moved} vs {same}"
                where = "on the mesh" if saved_on is not None else "without a mesh"
                log(f"  (b) a checkpoint saved {where} resumed "
                    f"{'without one' if other is None else 'on the mesh'}: step 3 loss "
                    f"{moved[0]:.6f}, {same[0]:.6f} resumed as saved (rel {rel:.3g})")
                shutil.rmtree(first)
                shutil.rmtree(second)
            torch.cuda.empty_cache()
            log(f"  (b) {time.perf_counter() - t_part:.1f}s")
            t_part = time.perf_counter()

            # (c) dbrx-132b expert parallel, one layer, bf16, under no_grad
            cfg = dataclasses.replace(get_arch("dbrx-132b"), n_layers=1)
            api = build_model(cfg, "cuda")
            params = T.cast_for_compute(api.init(SEED), cfg)
            batch = {"tokens": torch.from_numpy(
                np.random.default_rng(SEED + 5).integers(0, cfg.vocab_size, (2, 256))).to(dev)}
            with torch.no_grad():
                for m in kinds.values():
                    m.launches = 0
                loss0 = float(api.loss(params, batch)[0])
                moved0 = {k: m.launches for k, m in kinds.items()}
                with use_mesh(mesh):
                    placed = place(params, param_pspecs(params, mesh), mesh)
                    del params
                    for m in kinds.values():
                        m.launches = 0
                    loss1 = float(api.loss(placed, batch)[0].full_tensor())
                moved1 = {k: m.launches for k, m in kinds.items()}
            assert moved1 == moved0 and all(
                moved1[name] == (e == moe_fwd_engine(cfg)) for e, name in MOE_FWD_COUNT.items()), (
                moved1, moved0)
            for k, v in moved1.items():
                totals[k] += v
            rel = abs(loss1 - loss0) / abs(loss0)
            assert rel <= TRAIN_LOSS_RTOL, f"(c) loss {loss1} on the mesh, {loss0} without"
            log(f"  (c) dbrx-132b full width, 1 layer, bf16, no_grad, B2 S256: loss {loss1:.6f} "
                f"on the mesh, {loss0:.6f} without (rel {rel:.3g}); "
                f"launches {moved1} equal")
            del placed
            log(f"  (c) {time.perf_counter() - t_part:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return totals


# ======================================================================
# phase 13: the dry run and the roofline
# ======================================================================

# (arch, shape, multi-pod): the production cells phase 13 (a) lowers
DRYRUN_CELLS = [("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "prefill_32k", False),
                ("qwen3-0.6b", "decode_32k", False), ("dbrx-132b", "train_4k", True),
                # one 16x16 cell of each class the card host's torch once refused:
                # the SSM's convs, a head merge the model axis splits apart, the
                # MoE's routing on sharded groups, decode attention on head shards
                ("mamba2-370m", "decode_32k", False), ("gemma2-2b", "train_4k", False),
                ("dbrx-132b", "decode_32k", False), ("stablelm-3b", "decode_32k", False)]
# seconds one cell's lowering may take on the host (the slowest, dbrx-132b on
# 2x16x16, takes tens of seconds; PERF.md)
DRYRUN_TIMEOUT_S = 300


def dry_run_and_roofline(src, name, smi, served, trained):
    """Phase 13 (the module docstring's (a), (b), (c)). ``served`` and
    ``trained`` are the steps phases 6 and 10 (b) timed on the card."""
    import os
    import shutil
    import tempfile

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    from repro_torch.roofline.analysis import H100_SXM, card_peaks, load_rows
    from repro_torch.roofline.op_cost import analyze_ledger, count

    # the counter on this machine's torch: a DTensor matmul on the 16x16 fake
    # mesh counts its local product only (each rank 1/16 of the rows and of
    # the columns)
    with fake_process_group(256):
        mesh = make_production_mesh()
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = distribute_tensor(torch.empty(4096, 1024), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(1024, 4096), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            _, c = count(lambda: a @ w)
        got, want = c.summary().dot_flops, 2 * 256 * 1024 * 256
        assert got == want, f"(a) a DTensor matmul counted {got} FLOP, its local product {want}"

    # (a) the dry run at full width, one process a cell, all at once
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        t0 = time.perf_counter()
        for arch, shape, multi_pod in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--out", out] + (["--multi-pod"] if multi_pod else [])
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for (arch, shape, _), p in zip(DRYRUN_CELLS, procs):
            text, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            fails = "".join(f.read_text()[-4000:]
                            for f in Path(out).glob(f"{arch}__{shape}__*.fail"))
            assert p.returncode == 0, (
                f"(a) the dry run of {arch} x {shape} failed:\n{text[-2000:]}{fails}")
        log(f"  (a) {len(DRYRUN_CELLS)} cells lowered in {time.perf_counter() - t0:.1f}s "
            f"(wall, in parallel)")
        rep = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", "--dir", out],
                             env=env, capture_output=True, text=True, check=True, timeout=120)
        log(rep.stdout)
        rows = {(r.arch, r.shape): r for r in load_rows(out, H100_SXM)}
        for path in sorted(Path(out).glob("*.json")):
            d = json.loads(path.read_text())
            assert d["dot_flops"] > 0 and d["hbm_bytes"] > 0 and not d["unknown_ops"], (
                f"(a) {path.name}: {d['dot_flops']} dot FLOP, {d['hbm_bytes']} B, unknown ops "
                f"{d['unknown_ops']}")
            assert ("ep_alltoall" in d) == bool(get_arch(d["arch"]).n_experts), path.name
            r = rows[(d["arch"], d["shape"])]
            coll = {k: round(v["bytes"] / 1e9, 3) for k, v in d["collectives"].items()
                    if isinstance(v, dict)}
            log(f"  (a) {d['arch']} x {d['shape']} on {d['mesh']}: lowered in {d['compile_s']} s; "
                f"per device {d['flops'] / 1e12:.3f} TFLOP ({d['dot_flops'] / 1e12:.3f} in dots), "
                f"{d['hbm_bytes'] / 1e9:.1f} GB HBM (eager, unfused), collectives GB {coll}, "
                f"{d['hlo_lines']} ledger lines; under the H100's peaks compute "
                f"{r.compute_s:.4g} s, memory {r.memory_s:.4g} s, collective {r.collective_s:.4g} s:"
                f" {r.dominant}-bound")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out, ignore_errors=True)

    # (b) the card's own steps, counted on fake CPU tensors with no mesh, at
    # what each needs: a decode tick's cache cut to its live span, and the
    # plain program's whole (S, S) attention cut to the causal pairs
    peaks = card_peaks(name)
    cfg = get_arch("qwen3-0.6b")
    dec = served["decode"]
    steps = [("train", trained, trained["S"],
              f"training step (phase 10 (b), B{trained['B']} S{trained['S']})"),
             ("decode", dec, dec["kv"], f"decode tick (phase 6, {dec['B']} slots, cache span "
                                        f"{dec['kv']} of max_len {dec['S']})"),
             ("prefill", served["prefill"], served["prefill"]["S"],
              f"prefill (phase 6, 1 x {served['prefill']['S']})")]
    lowered = {}
    for kind, meas, S, label in steps:
        lw = lower_step(cfg, kind, meas["B"], S, compute_params=kind != "train")
        lowered[kind] = lw
        whole = lw.counter.summary()
        assert whole.dot_flops > 0 and not whole.unknown_ops, f"(b) {label}: {whole.as_dict()}"
        c = analyze_ledger(lw.counter.ledger_lines(),
                           causal=None if kind == "decode" else (S, meas["B"] * cfg.n_heads))
        # compute: the dots at the bf16 tensor-core peak or the vector ops at
        # the f32 one, whichever takes longer (the two units run at once);
        # memory: the step's inputs read once and its new outputs written
        # once (the plain program's unfused traffic is logged beside it)
        dots_ms = 1e3 * c.dot_flops / peaks["bfloat16"]
        vector_ms = 1e3 * c.vector_ops / peaks["float32"]
        compute_ms = max(dots_ms, vector_ms)
        least = lw.argument_bytes + lw.new_output_bytes
        memory_ms = 1e3 * least / peaks["bytes"]
        bound_ms = max(compute_ms, memory_ms)
        log(f"  (b) qwen3-0.6b {label}, counted in {lw.seconds:.1f}s: {c.dot_flops:.6g} dot FLOP, "
            f"{c.vector_ops:.6g} vector ops needed (the plain program: {whole.dot_flops:.6g}, "
            f"{whole.vector_ops:.6g}); {lw.argument_bytes} B in, {lw.new_output_bytes} B "
            f"of new outputs; compute term {compute_ms:.4f} ms (dots {dots_ms:.4f}, vector "
            f"{vector_ms:.4f}), memory term {memory_ms:.4f} ms: bound {bound_ms:.4f} ms by "
            f"{'operations' if compute_ms >= memory_ms else 'bytes'} (the eager plain program "
            f"moves {whole.hbm_bytes:.6g} B, {1e3 * whole.hbm_bytes / peaks['bytes']:.3f} ms); "
            f"measured unprofiled wall {meas['wall_ms']:.3f} ms, bound/wall "
            f"{bound_ms / meas['wall_ms']:.4f}; device busy {meas['busy_ms']:.3f} ms, bound/busy "
            f"{bound_ms / meas['busy_ms']:.4f}; {smi}")

    # (c) the dry run's argument bytes against what phase 10 (b) held on the card
    got = lowered["train"].argument_bytes
    assert got == trained["held_bytes"], (
        f"(c) the dry run counts {got} argument bytes, the card held {trained['held_bytes']}")
    log(f"  (c) training step's argument bytes: dry run {got}, train state and batch on the "
        f"card {trained['held_bytes']}: equal")


if __name__ == "__main__":
    sys.exit(main())
