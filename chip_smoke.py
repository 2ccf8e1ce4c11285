#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repo root, on a machine with the card

Phases, each printed as one JSON line (any failure raises and exits
non-zero, printing no result):

1. device — the card's name and power limit as nvidia-smi gives them (also
   printed raw on a line of its own);
2. build — the CUDA kernels built from the repo's sources (seconds), and
   the tensor-core instructions in their SASS (HGMMA in the prefill
   kernel, HMMA in the decode kernel and in the SSD scan's two product
   kernels);
3. kernels — each kernel on the card against its plain PyTorch version at
   every shape the paths below give it and at a long-context shape, with
   its time, the plain version's, the least time the card could take
   (bound) and, where one exists, one PyTorch call computing the same
   function (SDPA, F.rms_norm) as a yardstick, never called by the port;
   the decode rows take every kernel one call launches (split and
   combine) by torch.profiler, beside the CUDA-event wall time, with the
   route and splits, and SDPA's device time likewise; the decode entries
   also run under torch.cuda.set_sync_debug_mode("error") (no host sync
   in a call), and the decode route of f32 tensors (the CUDA cores) on its
   own path;
   the quantize, dequantize, RMSNorm and SSD scan rows also take the
   kernel's device time from torch.profiler (quantize and dequantize also
   at DDL's pod-hop slices, bitwise; the SSD rows every kernel a call
   launches, the RMSNorm rows `F.rms_norm`'s device time likewise); the
   int8 rows assert their path (a row held in registers, or element by
   element), and so do the decode step's fused K/V write
   (`quantize_kv_write`: the engine's arena, 16 slots, slot-contiguous,
   with inactive slots and NaN rows, bitwise on every cache byte, under
   sync-debug "error") and the pod sum (`dequantize_sum_rows`: 2 and 4
   pods, the embedding's tail, bitwise), each timed beside the composition
   of launches it replaces; the
   SSD and RMSNorm rows assert the route or path they took (the scan on
   the tensor cores or the CUDA cores, RMSNorm's row held in registers or
   element by element); SSD rows with dt in a trained model's range
   also show that the plain scan with the decayed state dropped from what
   each chunk hands on fails the row's rule; the scan with its final
   state (`final_state=True`, the serve path's prefill) by route at every
   prompt of the Mamba-2 trace and run_static's batch, y and the state
   against the plain scan's, y bitwise the same call without the state;
   the RMSNorm autograd Function's gradient against autograd through the
   plain version; the scan's CUDA-core route on its own path (the scan
   entry on f32 views, with and without the final state);
4. reference (qwen2.5-14b at full width, 2 layers, random bf16 weights
   from a seed) — the serve engine with model-width and int8 KV pages;
   the engine with the flash-attention prefill (attn_impl="pallas",
   whole-prompt prefill); the static whole-batch loop (`run_static`:
   flash-attention prefill, then lockstep decode through the
   slot-contiguous flash-decode kernel, whose greedy tokens may part from
   the engine's only at a narrow dense margin); the slot decode step
   without a page arena against the paged one, bf16 and int8. Logits are
   held against a dense one-shot pass over each request's prompt and
   tokens. Then `Model.forward` (attn_impl="pallas") against
   `Model.prefill` on the static prefill's batch;
5. Mamba-2 (mamba2-1.3b at full width, random weights from a seed with
   dt_bias drawn as Mamba-2 draws it, 4 x 2048 tokens) — `Model.forward` and `loss` through the SSD scan kernel
   (ssd_impl="pallas") against the same model through the plain scan, at
   2 layers (values and argmax) and at the full 48 (launches exactly 48,
   all on the tensor-core route, argmax where the margin is wide, both
   losses, forward time);
5a. mamba2_serve (mamba2-1.3b's 48-layer weights of 5, in a spawned
   process sharing them on the card) — 8 requests on 4 slots, prompts of
   2, 3, 256, 300, 511, 700, 1024 and 1100 tokens, 32 greedy tokens each,
   half of them prefilled into host slots to wait: the engine at 2 layers
   against `Model.forward` over each prompt and its tokens; at 24 layers
   (the first of the 48) resident, under the serve plan of LMSConfig(hbm_budget=1e9) (params
   and the waiting state on the host: tokens, the hidden state entering
   the head and the logits bitwise resident, the head in vocab slices,
   the swap bytes exact, the peak at most 1.10 x the plan's), through a
   preemption (tokens bitwise, the
   slot's state moved whole); `run_static` resident and under the plan;
   the prefill's scan only with its final state, L launches a prefill;
5b. mamba2_lms (in that process) — 4 layers, 3 steps of `Trainer.train`
   on 2 x 2048 tokens under the plan of LMSConfig(hbm_budget=2e9) (params
   and AdamW state streamed) against resident: losses, grad norms,
   params, mu, nu and masters bitwise, the swap bytes a step exactly the
   count, RMSNorm 2L+1 a step, the peak at most 1.10 x the plan's;
6. training (qwen2.5-14b at full width, bf16, 2 x 2048 tokens of the
   synthetic stream) — at 2 layers, 3 steps of `build_train_step` from one
   init through the kernels and through the plain versions (step 1's
   grads, each step's loss and grad norm, RMSNorm launches exactly 4L+1 a
   step: 2L+1 in the forward, 2L in the checkpointed layers' recompute;
   step 1 again with RMSNorm's plain forward, and with RMSNorm swapped for
   its plain version, each against both runs);
   at 4 layers, the main path: `Trainer.train` for 5 steps (losses, step
   time, tokens/s, model FLOP/s, peak memory, launches) and one more step
   under torch.profiler;
7. engine and static at the full 48 layers — the engine serving 8
   requests with half the device pages full residency needs (the backlog
   spills to pinned host memory), with model-width then int8 KV pages;
   then `run_static` on the same weights, held to the same loop with its
   kernels swapped for their plain versions (teacher-forced), its dense
   deviation and its parity with the engine's tokens reported; then its
   prefill step timed warm with flash attention on the tensor cores and
   on the CUDA cores, in turns;
8. determinism — the model-width trace twice on the first 4 layers of
   the 48-layer weights, token for token;
9. profile — that 4-layer trace once more with each KV width under
   torch.profiler: the device's busy share, its top kernels, and the
   runtime launch calls per layer-tick;
9a. serve_plan — serving under a serve plan, in a spawned process sharing
   those 4 layers' weights on the card: the plan of
   LMSConfig(hbm_budget=3e9) puts the params on the host, the weights are
   copied into its pinned arena, and every prefill chunk and decode tick
   of the engine streams the stack a layer at a time and the rest (the
   batch's embedding rows, the final norm, the head) from there: tokens
   and every logits row bitwise the resident engine's at model width and
   int8, the params' swap bytes exactly what the sweeps copy, the
   engine's peak at most 1.10 x the plan's, the kernels' launches as the
   trace implies; the preemption and pool-exhaustion drills of the fault
   injector bitwise the undisturbed run; `run_static` under the plan
   through the prefill kernel and the contiguous decode, bitwise resident,
   its peak at most 1.10 x the plan's too;
9b. dense_configs — the registry's other dense decoders at their published
   widths, random weights from a seed: olmo-1b (MHA 16/16, LayerNorm
   without params, tied embeddings) serving at 2 layers (against the
   dense pass) and its full 16 (argmax), the engine at both KV widths and
   `run_static`; `Trainer.train` 3 steps resident and 3 under the plan of
   LMSConfig(hbm_budget=8e9) (params and AdamW state streamed), in a
   spawned process, bitwise equal, no kernel launched; starcoder2-7b
   (GQA 36/4, LayerNorm with a bias, GELU with biases) serving at 2
   layers (both widths, and the flash-attention prefill) against the
   dense pass and at 8 of its 32 (argmax), 2 train steps at 2 layers
   through the kernels against the plain versions; qwen2-72b (GQA 64/8,
   d_model 8192) serving at 2 layers and 2 train steps at 1 layer through
   the kernels against the plain versions (4L+1 RMSNorm launches a step);
10. DDL at full width (qwen2.5-14b cut to 1 layer, random weights from a
   seed, 2 ranks spawned on the one card over gloo, a 2x1x1 mesh,
   compress_dcn, the overlapped backward: each layer's grads reduced on the
   DDL queue's thread and stream while the backward goes on, 2048 tokens a
   rank) — `Trainer.train` for 2 steps: replicas bitwise in sync, the int8
   pod hop through the kernels bitwise against the plain quantizers and
   within the int8 bound of the exact sum, the launches the leaf sizes
   give (quantize and the pod sum once a slice, no dequantize), the step
   time, the reduction's share, the queue's times and the pod-hop bytes;
   then error feedback's path (one leaf reduced with EF: the dequantizer
   once a slice, bitwise against the plain quantizers);
11. DDL at smoke width (4 ranks, a 2x2x1 mesh) — the overlapped backward
   off and on x compression off and on, each against one rank on the
   global batch; each overlapped run again with the queue's reductions
   issued inline in the backward (`ReductionQueue.put` patched), bitwise
   the queued run;
12. DDL's sharded paths (qwen2.5-14b at full width cut to 1 layer, 2 ranks
   on a 1x2x1 mesh: 2 data ranks, no pod hop, one step a run at the
   peak lr, one after another; run first of all the rank phases, just
   after the kernel checks, for host memory) — (i) allreduce and (ii) zero1, resident, overlapped, a row
   of 2048 tokens a rank; (iii) zero1 under the plan of
   LMSConfig(hbm_budget=16e9); (iv) the sharded microbatch accumulator
   and (v) the serialized one under that plan, two rows a rank in 2
   microbatches: replicas bitwise in sync, step 1's loss bitwise equal
   across (i)-(iii) and (iv)-(v), (ii) within the JAX package's zero1
   bounds of (i) and (iv) of (v), (iii) bitwise (ii), zero1's optimizer
   bytes a rank exactly 12 x padded / 2 and its peak below allreduce's,
   RMSNorm's launches, each run's peak against its plan's; then zero1
   and 2 microbatches at smoke width on 4 ranks (2x2x1, the int8 pod
   hop), overlapped and serialized, against one rank on the global batch,
   the quantizer and the pod sum launched as the shard sizes imply;
   tp — then, in the same two ranks (warm, their pinned arena reused),
   tensor parallelism on a 1x1x2 mesh (a `model` axis over the two
   ranks: 20 / 4 heads, half of d_ff and of the vocab a rank) at 2
   layers, 2 x 2048 tokens (every `model` rank takes the whole batch), 2
   steps: (i) resident against the one-device run from the same seed
   (made by each rank in turn), loss, ce and grad norm within 2e-3 relative each
   step, the masters within the CPU tests' lr-N bounds, the replicated
   leaves bitwise across the ranks; (ii) under the plan of
   LMSConfig(hbm_budget=8e9) (params and the AdamW state in pinned host
   memory) bitwise against (i), the peak against the plan's; (iii) a
   forward through kernel #1 at the local heads (2 launches) against the
   blockwise forward, within 2**-5 of the largest |logit|, RMSNorm's
   4L+1 launches a step resident and the plan's implied count streamed;
   tp_serve — then serving on that mesh (TP_SERVE_LAYERS' comment):
   qwen2.5-14b at 2 layers, the engine at both KV widths through a
   preemption teacher-forced against the one-device engine, `run_static`
   through kernel #1 against one device, the engine under a serve plan
   bitwise resident; qwen3-moe's layer under expert parallelism against
   the one-device layer and its engine with k = E against the dense pass;
   the gathered logits bitwise the same on both ranks; the decode kernels
   at one rank's heads timed first (`tp_serve_kernel_phases`);
13. LMS + DDL (qwen2.5-14b at full width, 2 ranks spawned on the one card
   over gloo, the 2x1x1 mesh, compress_dcn, 2048 tokens a rank, the plan
   of LMSConfig(hbm_budget=16e9): params, grads and the AdamW state in
   pinned host memory, each layer's grads reduced on the DDL queue's
   thread while the backward goes on and sunk to the host) — (a) 1 layer,
   2 steps, bitwise against the DDL phase's resident run (losses, grad
   norms, every param's checksum), its launches, the pod hop on the
   queue's stream; (b) 1 layer if two ranks' pinned state fits 80% of
   MemAvailable, 2 steps overlapped and 2 with the overlap off: step time, tokens/s, the reduction's time and its part
   under the backward, swap bytes, peaks and pinned bytes against the
   plan's, MemAvailable before and after the ranks (waiting until the host
   has handed their memory back);
14. ckpt (checkpoints, resume, supervised crash recovery) — (a) in a
   process spawned on the card, qwen2.5-14b at full width cut to 1 layer
   under the plan of LMSConfig(hbm_budget=16e9) (params streamed, the
   AdamW state in a pinned arena reserved once): `Trainer.train` 4 steps
   without checkpoints, then the `Supervisor` over the same run with
   async checkpoints every 2 steps and a crash before step 4: step 2
   written from the arena while step 3 runs, restored into the arena by
   attempt 2, steps 3-4 replayed, step 4 written; every row, grad norm
   and leaf checksum bitwise the uninterrupted run's, RMSNorm as the plan
   implies, committed steps [2, 4], the resident-set peak of each save and
   of the restore under its bound; the save's blocking and writer seconds,
   the restore's, GB/s, step 3 beside the write. The files (two 27.2 GB
   checkpoints) go to RAM (/dev/shm): the machine lets a run write at most
   45 GiB to its disk; after (b) the parent waits for the host to hand
   the process's memory back before the LMS phases. (b) at smoke width, 2
   ranks over gloo (one spawn, the modes in turn): zero1 on 1x2x1 under a
   plan with the optimizer on the host, allreduce on 2x1x1 with the int8
   pod hop, each bitwise its uninterrupted run through a crash and
   restart, the pod hop's launches as the leaf sizes imply;
14a. moe (qwen3-moe-235b-a22b at its published width: 128 experts of
   d_ff 1536, top-8; random weights drawn on the card; a process of its
   own, which pins one arena for its largest state while its resident
   runs go) — the MoE layer at 2 x 2048 tokens with ample capacity
   against every expert on every token (within 2**-5 of max |y|); the
   engine at 2 layers with every token routed to every expert against the
   dense pass, model width and int8 (the kernels of #2b and #4b); at 4
   layers the trace with a preemption, `run_static` on 4 x (300 + 8)
   tokens through the prefill kernel, and a 2-request trace resident and
   under the serve plan of LMSConfig(hbm_budget=16e9) (params on the host:
   tokens and logits bitwise, swap bytes exact, peak within 1.10 x the
   plan's); training at 1 layer, 2 steps of 2 x 2048 tokens, resident
   against the plan of 16e9 (params and AdamW state streamed): losses,
   aux, grad norms and the state's checksums bitwise, swap bytes exact;
   grok-1-314b at 1 layer resident and under a serve plan, bitwise. Every
   call's capacity drops (`moe.dropped`) are printed; every launch at a
   shape the kernel phases checked; the after-phase waits for the host to
   hand the pinned memory back before the LMS phases;
15. host — MemTotal and MemAvailable, and the achieved pinned copy rate
   host to device, device to host and both at once (1 GiB each way, CUDA
   events); the gate's depth is chosen here (the most layers L <= 48 whose
   pinned state fits 80% of MemAvailable, failing unless that state plus
   the grads exceeds the card's 80 GB) and its pinned state reserved once;
16. lms_ab (qwen2.5-14b at full width cut to 4 layers, 2 x 2048 tokens, 2
   steps of `Trainer.train` from one seed) — under the plan of
   LMSConfig(hbm_budget=16e9) (params and AdamW state streamed from
   pinned host memory, five activation classes offloaded, mlp_hidden
   recomputed) against resident: losses, grad norms and every param
   bitwise equal; the RMSNorm launches the plan implies (2L+1 a step
   against 4L+1); both step times, the swap counters a step by class
   against the plan's, the measured peak against the plan's; then the
   same at 2 microbatches a step (a row each), streamed against resident
   m = 2, bitwise, the params swapped in twice as often as at m = 1;
17. lms_gate (qwen2.5-14b at full width, the host phase's L layers, 2 x
   2048 tokens, 2 steps) — the budget from lms_ab's measured-minus-planned
   peak fed to the planner as its audited live-bytes margin (lowered until
   the params stream); finite losses, step 1's loss bitwise equal to a
   layer-by-layer no-grad forward of the phase's own; step time, tokens/s,
   model FLOP/s, peak against the plan's, pinned bytes against the plan's
   host bytes, swap bytes a step against the plan's, the link rate in the
   step against the host phase's, the set-up times.

Every phase's seconds are printed as a row of their own.

Every run of a path records the shape of each kernel call and fails on one
the kernel phases did not check, and its launch counts (flash attention's
also by route) are reset just before and read just after: the static
loop's, the engine's whole-prompt prefill's and `Model.forward`'s attention
launches must all take the tensor-core route, and so must every decode
launch of the engine, the static loop and the slot decode, and every scan
launch of the Mamba-2 forward and of its serve path's prefill. The line
before the last lists every ported kernel (flash attention, decode and the
SSD scan once per route, the scan with its final state once per route
again; the int8 quantizer and dequantizer with their fused entries) with
its launches on the main path, on the MoE path (`moe_launches`) and on the
tensor-parallel path (`tp_launches`); the last line is {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # CUDA cores, outside the tensor cores
BF16_TENSOR_FLOPS_PER_S = 989e12  # tensor cores, dense

ARCH = "qwen2.5-14b"
H, K, D, PAGE = 40, 8, 128, 16   # qwen2.5-14b attention
SEED = 0
# the served trace: 8 requests of prompt 128 + 32 greedy tokens on 4 slots,
# with half the 40 device pages full residency needs
REQUESTS, PROMPT, GEN = 8, 128, 32
SLOTS, MAX_LEN, CHUNK, DEVICE_PAGES = 4, 160, 32, 20
# Mamba-2's forward and loss: mamba2-1.3b at 4 sequences of 2048 tokens,
# the Mamba-2 paper's training context
MAMBA = "mamba2-1.3b"
SSD_BATCH, SSD_LEN = 4, 2048
# Mamba-2 serving (mamba2_serve): mamba2-1.3b at full width, 8 requests on 4
# slots, 32 greedy tokens each, prompts under K - 1 (2), of K - 1 (3), one
# whole chunk of 256, partial last chunks (300, 511, 700, 1100: 5 chunks) and
# four whole chunks (1024): the device holds the state of 4 requests, the
# other 4 wait on the host. The engine against Model.forward at 2 layers,
# then at all 48 resident, under the serve plan of
# LMSConfig(hbm_budget=MAMBA_SERVE_BUDGET) (params and the waiting state on
# the host; its peak held to SERVE_PLAN_PEAK_OVER_PLAN x the plan's) and
# through a preemption at tick MAMBA_PREEMPT_TICK; `run_static` on 8 prompts
# of MAMBA_STATIC_PROMPT tokens, MAMBA_STATIC_GEN new tokens each (a decode
# step under the plan streams the stack and each layer's cache: 8 steps keep
# the phase inside chip_smoke's time), resident and under the plan
MAMBA_PROMPTS = (700, 2, 1100, 256, 511, 3, 1024, 300)
MAMBA_GEN, MAMBA_SLOTS, MAMBA_MAX_LEN = 32, 4, 1136
# the serve runs take the first MAMBA_SERVE_LAYERS of the 48 layers' weights
# (24 since the moe phase came, 16 since the tp_serve cases: chip_smoke's
# time limit). The budget puts the params and the state on the host (at 16
# layers a plan of 1e9, 24's, keeps the state on the card, and the static
# loop would no longer stream its cache)
MAMBA_SERVE_LAYERS = 16
MAMBA_SERVE_BUDGET, MAMBA_PREEMPT_TICK = 8 * 10**8, 20
MAMBA_STATIC_PROMPT, MAMBA_STATIC_GEN = 300, 8
MAMBA_TIMEOUT_S = 720
# Mamba-2 training under an LMS plan (mamba2_lms): MAMBA_LMS_LAYERS layers at
# full width, MAMBA_LMS_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, the plan of
# LMSConfig(hbm_budget=MAMBA_LMS_BUDGET) (params and AdamW state streamed)
# against resident
MAMBA_LMS_LAYERS, MAMBA_LMS_BUDGET, MAMBA_LMS_STEPS = 4, 2 * 10**9, 3
# training: 2 sequences of 2048 tokens a step; the reference check at 2
# layers, the main path (Trainer) at 4, where params, grads and f32 Adam
# state stay resident (~16 B a param: ~42.5 GB; the 48 layers need ~236 GB,
# the case of LMS: the lms phases)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_CHECK_LAYERS, TRAIN_CHECK_STEPS = 2, 3
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 4, 5, 3e-4, 1
# data-parallel training (DDL) over torch.distributed, its ranks sharing the
# one card over gloo: qwen2.5-14b at full width cut to 1 layer (1.83 B
# params, ~32 GB a rank with AdamW) on a 2x1x1 mesh (2 pods of 1 data rank)
# with the int8 pod hop, 2048 tokens a rank a step; then the smoke config on
# a 2x2x1 mesh, held against one rank on the global batch
DDL_LAYERS, DDL_STEPS, DDL_MESH = 1, 2, (2, 1, 1)
DDL_SMOKE_MESH, DDL_SMOKE_BATCH, DDL_SMOKE_SEQ = (2, 2, 1), 8, 128
DDL_AXES = ("pod", "data", "model")
# error feedback's path on the full-width ranks: one leaf of 2**24 + 3000
# elements reduced with EF (two pod-hop slices), after the training steps
DDL_EF_LEAF = (1 << 24) + 3000
DDL_TIMEOUT_S = 420
# LMS + DDL on the same 2x1x1 mesh under LMSConfig(hbm_budget=16e9), whose
# plan puts params, grads and the AdamW state on the host: (a) at 1 layer
# against the DDL phase's resident run, (b) at the most of LMS_DDL_DEPTHS
# layers whose two ranks' pinned state fits LMS_HOST_SHARE of MemAvailable,
# LMS_DDL_STEPS_B steps a run (2 layers and 2 steps keep the script inside
# its time limit; scripts/ddl_four_cards.py runs LMS + DDL at depth)
LMS_DDL_BUDGET, LMS_DDL_LAYERS_A, LMS_DDL_DEPTHS = 16 * 10**9, 1, (1,)
LMS_DDL_STEPS_B = 2
LMS_DDL_TIMEOUT_S = 720
# after the ranks exit the host hands their pinned memory back over some
# seconds: the phase waits (at most LMS_DDL_MEM_WAIT_S) until MemAvailable
# is back within LMS_DDL_MEM_SLACK of its value before the ranks, so the
# LMS phases after it size themselves from the whole host
LMS_DDL_MEM_WAIT_S, LMS_DDL_MEM_SLACK = 180, 2 * 10**9
# DDL's sharded paths at full width cut to 1 layer on a 1x2x1 mesh (2 data
# ranks sharing the card over gloo, no pod hop): (i) allreduce, (ii) zero1,
# (iii) zero1 under the plan of LMSConfig(hbm_budget=DDL_SHARDED_BUDGET),
# each on 2 x 2048 tokens; (iv) the sharded microbatch accumulator and (v)
# the serialized one under that budget, 4 x 2048 tokens in
# DDL_SHARDED_MICROBATCHES microbatches of a row each; then the smoke
# config on the 2x2x1 mesh, zero1 and m = 2, each overlapped and serialized.
# One step a run, at the peak lr (no warmup), so that step updates the
# params: a second step at this width repeats ~100 s of gloo, and the
# state carried across steps is held by ddl_sharded_smoke's DDL_STEPS steps
DDL_SHARDED_MESH, DDL_SHARDED_STEPS, DDL_SHARDED_BUDGET = (1, 2, 1), 1, 16 * 10**9
DDL_SHARDED_MICROBATCHES, DDL_SHARDED_TIMEOUT_S = 2, 900
# the kernels of each route of the SSD scan and RMSNorm (csrc/ssd_scan_mma.cu,
# ssd_scan.cu, rmsnorm.cu); the first two SSD ones run on the tensor cores
SSD_MMA_KERNELS = ("ssd_chunk_state_kernel", "ssd_chunk_out_kernel")
SSD_KERNELS = {"tensor_core": (*SSD_MMA_KERNELS, "ssd_state_pass_kernel"),
               "cuda_core": ("ssd_scan_kernel",)}
RMSNORM_KERNELS = {"register": "rmsnorm_rows_kernel", "element": "rmsnorm_elements_kernel"}
# the tensor-core route's h_final, in bf16 units of each head's max
# |h_final|: its hi + lo operands read ~0.0013 of a unit, the hi operand
# alone (the lo dropped) ~0.7-0.9, which the timed rows show as a control
SSD_H_FINAL_BF16_TOL = 0.05
# LMS on one card: the A/B of streamed against resident at 4 layers under a
# 16 GB planning budget (params and optimizer streamed, five activation
# classes offloaded, one recomputed), LMS_STEPS steps; the gate trains the
# most layers whose pinned state fits LMS_HOST_SHARE of MemAvailable. Its
# budget margin is lms_ab's measured peak over its plan's, plus the
# allowance; the host phase copies HOST_COPY_BYTES each way
LMS_AB_LAYERS, LMS_AB_BUDGET, LMS_STEPS = 4, 16 * 10**9, 2
LMS_HOST_SHARE, LMS_MARGIN_ALLOWANCE = 0.8, 2 * 10**9
CARD_BYTES = 80 * 10**9
HOST_COPY_BYTES, HOST_COPY_REPS = 1 << 30, 5
# checkpoints and supervised recovery (the ckpt phase, before the LMS
# phases): the plan of lms_ab at CKPT_LAYERS layer, CKPT_STEPS steps, a
# crash injected before the step of 0-based index CKPT_FAULT_AT; the files
# need two checkpoints' bytes + CKPT_ROOM_SLACK of room; VmRSS sampled
# every CKPT_RSS_PERIOD_S; (b) at smoke width under
# LMSConfig(CKPT_SMOKE_BUDGET)
CKPT_LAYERS, CKPT_STEPS, CKPT_FAULT_AT = 1, 4, 3
CKPT_ROOM_SLACK, CKPT_RSS_PERIOD_S, CKPT_SMOKE_BUDGET = 4 * 10**9, 0.01, 600_000
# the card's machine lets a run write at most 45 GiB to its disk; (a)'s two
# checkpoints (54.4 GB) go to RAM
CKPT_RAM_ROOT, CKPT_TIMEOUT_S = "/dev/shm", 900
# the dense_configs phase: the JAX registry's other dense decoders at their
# published widths, random weights from a seed. olmo-1b (MHA 16/16,
# non-parametric LayerNorm, tied embeddings) serves at 2 layers and its full
# 16 and trains 3 steps resident and under the plan of
# LMSConfig(hbm_budget=DENSE_OLMO_BUDGET), which streams the params and the
# AdamW state (in a spawned process: its pinned state goes back to the host
# when it exits); starcoder2-7b (GQA 36/4, LayerNorm with a bias, GELU with
# biases) serves and trains 2 steps at 2 layers and serves at 4 of its 32;
# qwen2-72b (GQA 64/8, d_model 8192) serves at 2 layers and trains 2 steps at
# 1 (~54 GB of params and AdamW state)
DENSE_OLMO, DENSE_STARCODER, DENSE_QWEN72 = "olmo-1b", "starcoder2-7b", "qwen2-72b"
# starcoder2-7b's deep serve run: 4 of its 32 layers (16 since the moe
# phase came, 8 since the tp phase, 4 since the tp_serve cases: chip_smoke's
# time limit)
DENSE_STARCODER_SERVE_LAYERS = 4
DENSE_OLMO_BUDGET, DENSE_TRAIN_STEPS, DENSE_CHECK_STEPS = 8 * 10**9, 3, 2
DENSE_TIMEOUT_S = 420
# the 48-layer engine's determinism and profile reruns run on the first
# RERUN_LAYERS layers of its weights
RERUN_LAYERS = 4
# serving under a serve plan (the serve_plan phase, on the RERUN_LAYERS
# rerun's weights): the budget puts the params on the host (the plan's
# device params are 2 layers' share of the whole model); the engine's peak
# is held to 1.10 x the plan's; the preemption drill spills the youngest
# slot at this tick, the exhaustion drill refuses this many reservations
SERVE_PLAN_BUDGET, SERVE_PLAN_PEAK_OVER_PLAN = 3 * 10**9, 1.10
SERVE_PLAN_PREEMPT_TICK, SERVE_PLAN_EXHAUSTIONS, SERVE_PLAN_TIMEOUT_S = 60, 3, 420
# the moe phase: qwen3-moe-235b-a22b at its published width (d_model 4096,
# GQA 64/4, 128 experts of d_ff 1536, top-8, vocab 151936), random weights
# drawn on the card from the seed, in a process of its own. The layer alone
# at TRAIN_BATCH x TRAIN_SEQ tokens with ample capacity against every expert
# on every token; the engine at MOE_CHECK_LAYERS layers with every token
# routed to every expert (k = E: a continuous layer, no call drops) against
# the dense pass, at model width and int8; at
# MOE_SERVE_LAYERS layers at the published capacity factor: the trace (8
# requests of 128 + 32 tokens on 4 slots) with a preemption at tick
# MOE_PREEMPT_TICK, `run_static` on MOE_STATIC_REQUESTS prompts of
# MOE_STATIC_PROMPT tokens + MOE_STATIC_GEN, and a shorter trace
# (MOE_PLAN_REQUESTS requests, MOE_PLAN_GEN tokens, a preemption at tick
# MOE_PLAN_PREEMPT_TICK: a tick under the plan copies all 4 layers, ~20 GB;
# 8 layers before the tp phase came: chip_smoke's time limit; at 2 the
# plan's two layers in flight are the whole stack, and the serve plan of
# MOE_BUDGET keeps the params on the card)
# resident and under the serve plan of LMSConfig(hbm_budget=MOE_BUDGET)
# (params on the host), bitwise; training at MOE_TRAIN_LAYERS layer,
# MOE_TRAIN_STEPS steps resident and under the plan of MOE_BUDGET (params and
# AdamW state streamed), bitwise. grok-1-314b serves the shorter trace at
# MOE_GROK_LAYERS layer resident and under the plan of MOE_GROK_BUDGET
# (params and the KV cache on the host: at 1 layer the plan's two layers in
# flight are the whole stack; the engine keeps the trace's page geometry,
# so both runs send the same calls). The process pins one arena for its
# largest state (the training's) while its resident runs go, and every
# placement reuses it
MOE, MOE_GROK = "qwen3-moe-235b-a22b", "grok-1-314b"
MOE_CHECK_LAYERS, MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_GROK_LAYERS = 2, 4, 1, 1
MOE_BUDGET, MOE_GROK_BUDGET = 16 * 10**9, 8 * 10**9
MOE_PREEMPT_TICK, MOE_PLAN_REQUESTS, MOE_PLAN_GEN, MOE_PLAN_PREEMPT_TICK = 20, 2, 8, 4
MOE_STATIC_REQUESTS, MOE_STATIC_PROMPT, MOE_STATIC_GEN = 4, 300, 8
MOE_TRAIN_STEPS, MOE_TIMEOUT_S = 2, 720
# tensor parallelism (the tp phase, in the ddl_sharded ranks after their
# cases, which reuse their reserved pinned arena): qwen2.5-14b at
# full width cut to TP_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ tokens a step
# (every `model` rank takes the whole batch), TP_STEPS steps at TRAIN_LR,
# on 2 ranks of a TP_MESH mesh sharing the card over gloo (20 of the 40
# query heads, 4 of the 8 kv heads, half of d_ff and of the vocab a rank):
# (i) resident against one device (1x1x1) from the same seed, loss, ce and
# grad norm within TP_REL_TOL relative each step and the masters within
# the CPU tests' lr-N bounds; (ii) under the plan of
# LMSConfig(hbm_budget=TP_BUDGET), params and AdamW state on the host,
# bitwise against (i); (iii) the kernels at the local shapes, and a
# forward through kernel #1 against the blockwise one
# (TP_STEPS 3 before the tp_serve cases: chip_smoke's time limit)
TP_MESH, TP_LAYERS, TP_STEPS, TP_BUDGET = (1, 1, 2), 2, 2, 8 * 10**9
TP_REL_TOL = 2e-3
# serving on the model axis (the tp_serve cases, in the ddl_sharded ranks
# after the tp cases, on TP_MESH over gloo): (i) qwen2.5-14b at full width
# cut to TP_SERVE_LAYERS layers (20 / 4 heads, half of d_ff and of the
# vocab a rank): the trace on the engine at both KV widths (DEVICE_PAGES
# device pages: requests spill; a preemption at tick TP_SERVE_PREEMPT_TICK),
# teacher-forced with the one-device engine's tokens on the same params
# (rank 0 runs the one-device references and sends their tokens), each
# row within 2**-5 of the one-device row's max |logit|, the gathered rows
# bitwise the same on both ranks; `run_static` through kernel #1 against
# the one-device loop (greedy tokens the same or parted at a near tie, its
# loop teacher-forced within 2**-5); the engine under the serve plan of
# LMSConfig(hbm_budget=TP_SERVE_BUDGET) (params and the KV backlog on the
# host, pinned per rank) bitwise the resident engine of the plan's page
# geometry, its peak within SERVE_PLAN_PEAK_OVER_PLAN x the plan's; (ii)
# qwen3-moe-235b-a22b under expert parallelism (64 of the 128 experts a
# rank): one layer at TRAIN_BATCH x TRAIN_SEQ tokens at the published
# capacity against the one-device `apply_moe` (within 2**-5 of its max
# |y|, the same drops and aux), and the engine at TP_MOE_LAYERS layer
# with k = E against the one-device dense pass (within 2**-5)
TP_SERVE_LAYERS, TP_SERVE_BUDGET, TP_SERVE_PREEMPT_TICK = 2, 15 * 10**8, 20
# the runs generate TP_SERVE_GEN tokens a request (the trace's prompts; the
# planned pair serves its first TP_PLAN_REQUESTS requests)
TP_MOE_LAYERS, TP_PLAN_REQUESTS, TP_SERVE_GEN = 1, 4, 16
# torch.profiler sessions that time a kernel: at most this many for one
# number, the timed calls this far (s) inside each end of a session
PROFILE_ATTEMPTS, PROFILE_PAD_S = 8, 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    """-> (bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak for their type (f32 on the CUDA cores
    by default; bf16 products on the tensor cores where the work is one)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled_events(fn, iters: int, accept, what: str, attempts: int = PROFILE_ATTEMPTS):
    """-> the CUDA events (kernels, copies, fills) of a torch.profiler
    session of `iters` calls of fn(), from the first session of up to
    `attempts` whose events `accept` takes. The calls sit PROFILE_PAD_S of
    host time inside each end of the session, so that a device timestamp
    placed a little off the host's clock still falls in it. A session the
    check rejects is reported (`profiler_miss`: what it recorded, and where
    its missing launches fall among the session's runtime launches) and run
    again after a pause: now and then a session on the card records only
    part of its device operations, or none, and the next one or two
    sessions may too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        evs = list(prof.profiler.kineto_results.events())
        dev = [ev for ev in evs if ev.device_type() == DeviceType.CUDA]
        if accept(dev):
            return dev
        seen.append(len(dev))
        got = ({ev.correlation_id() for ev in dev}
               | {ev.linked_correlation_id() for ev in dev})
        launches = sorted(ev.correlation_id() for ev in evs
                          if ev.device_type() == DeviceType.CPU
                          and ev.name().startswith("cuda") and ev.correlation_id())
        emit({"phase": "profiler_miss", "kernel": what, "calls": iters,
              "recorded": len(dev), "runtime_launches": len(launches),
              "missing_at": [j for j, c in enumerate(launches) if c not in got][:40]})
        time.sleep(0.5 * (attempt + 1))
    raise AssertionError(f"{what}: the profiler recorded {seen} device operations for "
                         f"{iters} calls in {attempts} sessions")


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel whose name contains
    `kernel`, over `iters` calls of fn() under torch.profiler: the kernel's
    own time on the card. (Back-to-back timing by CUDA events reads the
    wrapper's host time instead where that is the longer.) Only a session
    that recorded all `iters` launches counts."""
    dev = _profiled_events(
        fn, iters, lambda dev: sum(kernel in ev.name() for ev in dev) == iters, kernel)
    durs = [ev.duration_ns() for ev in dev if kernel in ev.name()]
    return sum(durs) / len(durs) / 1e6


def device_ms_per_call(fn, iters: int = 20):
    """Mean device time of one call of fn(), summed over every CUDA kernel
    (and copy or fill) the call launches, over `iters` calls under
    torch.profiler: a call that launches a split kernel and its combine,
    or SDPA's own kernels, is timed whole, and the wrapper's host time is
    left out. -> (ms, device operations a call, {kernel: ms a call}). Only
    a session whose count of operations is a positive multiple of `iters`
    counts."""
    import re
    evs = _profiled_events(fn, iters, lambda dev: dev and len(dev) % iters == 0,
                           "per call")
    by = {}
    for ev in evs:   # short names: "fd_mma_kernel", "fd_combine_kernel", ...
        name = re.sub(r"[<(].*", "", ev.name().replace("(anonymous namespace)", ""))
        name = name.split("::")[-1].split()[-1]
        by[name] = by.get(name, 0.0) + ev.duration_ns() / iters / 1e6
    return sum(by.values()), len(evs) // iters, by


def bf16_row_ulp(o):
    """One bf16 ulp (8 significand bits) at each output row's largest |o|.
    Per row, not per element: an output near zero is a sum that cancels,
    and two f32 sums in different orders differ there by far more ulps of
    the tiny result than the result is worth."""
    import torch
    top = o.abs().float().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    # f32 matmuls in the plain versions run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    emit({"phase": "device", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


def build_phase():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.extension()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "route": "torch.utils.cpp_extension.load",
          "sources": [f"src/repro_torch/kernels/csrc/{s}" for s in _build.SOURCES],
          "cuda_flags": list(_build.CUDA_FLAGS)})
    return sass_phase()


def sass_phase():
    """The tensor-core instructions in the built extension's SASS, from
    `cuobjdump -sass`: HGMMA (wgmma) by instance of the flash-attention
    kernel (`fa_wgmma_kernel<D>`), HMMA (mma.sync) in the decode kernel
    (`fd_mma_kernel`), and HMMA and HGMMA in the SSD scan's two product
    kernels (`ssd_chunk_state_kernel`, `ssd_chunk_out_kernel`). Fails if any
    has none, since each of those routes must run on the tensor cores."""
    import re
    import shutil
    from repro_torch.kernels import _build
    lib = sorted(_build.BUILD_DIR.glob("*.so"))[0]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, hmma, fn = {}, 0, None
    ssd = {name: {"HMMA": 0, "HGMMA": 0} for name in SSD_MMA_KERNELS}
    for text in sass.splitlines():
        if "Function :" in text:
            fn = text.split("Function :", 1)[1].strip()
        elif fn and "fa_wgmma_kernel" in fn and "HGMMA" in text:
            d = re.search(r"fa_wgmma_kernelILi(\d+)E", fn)
            key = f"head_dim_{d.group(1)}" if d else fn
            counts[key] = counts.get(key, 0) + 1
        elif fn and "fd_mma_kernel" in fn and "HMMA" in text:
            hmma += 1
        elif fn and ("HMMA" in text or "HGMMA" in text):
            for name in ssd:
                if name in fn:
                    ssd[name]["HGMMA" if "HGMMA" in text else "HMMA"] += 1
    row = {"phase": "sass", "library": os.path.relpath(lib, ROOT),
           "kernel": "fa_wgmma_kernel", "hgmma": counts, "hgmma_total": sum(counts.values()),
           "decode_kernel": "fd_mma_kernel", "decode_hmma_total": hmma, "ssd_tensor_core": ssd}
    emit(row)
    if not row["hgmma_total"]:
        raise AssertionError("the tensor-core flash-attention kernel has no HGMMA in its SASS")
    if not hmma:
        raise AssertionError("the tensor-core decode kernel has no HMMA in its SASS")
    if not all(sum(n.values()) for n in ssd.values()):
        raise AssertionError(f"a tensor-core SSD kernel has no HMMA or HGMMA in its SASS: {ssd}")
    return row


def _decode_inputs(kv_lens, seed, paged: bool, pages=None, max_pages=None, smax=None,
                   heads=H, kv_heads=K, d=D, dtype="bfloat16"):
    """q + caches of `dtype` on the card. Paged: arenas and a scrambled table,
    each slot owning distinct random pages in random order; empty slots
    and unused entries point at the null page (the last row); spare pages
    and the null page hold garbage. `pages` (arena rows less the null page)
    and `max_pages` (table width) default to what kv_lens need, plus 8
    spare pages. Contiguous: caches [B, smax, kv_heads, d] whose positions
    past each kv_len hold garbage. -> (q, k, v, kv_len, table or None)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b = len(kv_lens)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    dt = getattr(torch, dtype)
    q = torch.randn((b, heads, d), generator=gen, device=dev).to(dt)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    if not paged:
        assert max(kv_lens) <= smax
        k = torch.randn((b, smax, kv_heads, d), generator=gen, device=dev).to(dt)
        v = torch.randn((b, smax, kv_heads, d), generator=gen, device=dev).to(dt)
        return q, k, v, kvl, None
    need = sum(-(-n // PAGE) for n in kv_lens)
    max_pages = max_pages or -(-max(kv_lens) // PAGE)
    pages = pages or need + 8
    assert need <= pages and max(kv_lens) <= max_pages * PAGE
    tab = np.full((b, max_pages), pages, np.int32)
    perm = rng.permutation(pages)
    nxt = 0
    for i, n in enumerate(kv_lens):
        need = -(-n // PAGE)
        tab[i, :need] = perm[nxt:nxt + need]
        nxt += need
    k = torch.randn((pages + 1, PAGE, kv_heads, d), generator=gen, device=dev).to(dt)
    v = torch.randn((pages + 1, PAGE, kv_heads, d), generator=gen, device=dev).to(dt)
    return q, k, v, kvl, torch.from_numpy(tab).to(dev)


def _quantize_cache(x):
    """A cache [..., D] as int8 codes of its shape and f32 scales [...], by
    the plain quantizer."""
    from repro_torch.kernels.quantize.ref import quantize_ref
    c, s = quantize_ref(x.reshape(-1, x.shape[-1]))
    return c.reshape(x.shape), s.reshape(x.shape[:-1])


def _sdpa(q, kc, vc, kv_len):
    """One SDPA call (GQA) on slot-contiguous caches, the yardstick: -> a
    function of no arguments that makes it."""
    import torch
    import torch.nn.functional as F
    s = kc.shape[1]
    qs = q[:, :, None]                                   # [B,H,1,D]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < kv_len[:, None].long()
            )[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)


# What each kernel's launch depends on besides the data: a run of a path
# fails on a call whose signature no kernel phase checked.

def attention_route(q) -> str:
    """The route of kernel #1 a CUDA call should take, as the wrapper's
    docstring states it: bf16 at head_dim 64, 128 or 256 on the tensor
    cores (wgmma), everything else on the CUDA cores."""
    import torch
    return ("wgmma" if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128, 256)
            else "cuda_core")


def decode_route(q, k) -> str:
    """The route of kernels #2 and #3 a CUDA call should take, as the
    wrappers' docstrings state it: bf16 q at head_dim 64, 128 or 256 with
    at most 16 query heads per kv head on the tensor cores (mma.sync),
    everything else on the CUDA cores. q [B,H,D]; k the cache or arena."""
    import torch
    return ("tensor_core" if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128, 256)
            and q.shape[1] // k.shape[2] <= 16 else "cuda_core")


def attention_sig(q, k, causal, window, q_offset):
    if q_offset is None:
        q_offset = k.shape[1] - q.shape[1] if causal else 0
    return ("flash_attention", tuple(q.shape), str(q.dtype), tuple(k.shape),
            bool(causal), int(window), int(q_offset))


def decode_sig(q, k, page_table=None):
    """q [B,H,D]; k the cache (or arena, with its table)."""
    if page_table is None:
        return ("flash_decode", tuple(q.shape), str(q.dtype), tuple(k.shape), str(k.dtype))
    return ("flash_decode_paged", tuple(q.shape), str(q.dtype),
            tuple(k.shape), str(k.dtype), tuple(page_table.shape))


def quantize_sig(x):
    return ("quantize_rows", tuple(x.shape), str(x.dtype))


def dequantize_sig(q, out_dtype):
    return ("dequantize_rows", tuple(q.shape), str(out_dtype))


def quantize_kv_write_sig(k, codes, page_table):
    """k [B,1,K,D] is read through its strides; the cache is the arena
    (with its table) or slot-contiguous (no table)."""
    return ("quantize_kv_write", tuple(k.shape), str(k.dtype), tuple(k.stride()),
            tuple(codes.shape), None if page_table is None else tuple(page_table.shape))


def dequantize_sum_sig(q, n):
    return ("dequantize_sum_rows", tuple(q.shape), int(n))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def quantize_path(x) -> str:
    """The path of the quantizer a CUDA call of `quantize` takes, as
    `q_ops.quantize_layout` chooses it ("vector": the row held in
    registers, or "element"); its codes are a fresh, aligned tensor."""
    from repro_torch.kernels.quantize.ops import quantize_layout
    return ("vector" if quantize_layout(x.shape[-1], x.element_size(), _aligned(x))
            else "element")


def kv_write_path(k, v, k_codes, v_codes) -> str:
    """The path of the fused decode-step write: `quantize_layout` at width
    D, with both rows' strides and every pointer aligned."""
    from repro_torch.kernels.quantize.ops import quantize_layout
    vec = 16 // k.element_size()
    aligned = (_aligned(k, v, k_codes, v_codes)
               and all(t.stride(i) % vec == 0 for t in (k, v) for i in (0, 2)))
    return ("vector" if quantize_layout(k.shape[-1], k.element_size(), aligned)
            else "element")


def dequantize_path(q) -> str:
    """The dequantizers' path (`q_ops.dequantize_layout`), with the output
    a fresh, aligned tensor."""
    from repro_torch.kernels.quantize.ops import dequantize_layout
    return "vector" if dequantize_layout(q.shape[-1], _aligned(q)) else "element"


def path_launches(launcher) -> dict:
    """A quantize launcher's counts: all, and by path."""
    return {"launches": launcher.launches, "vector": launcher.vector_launches,
            "element": launcher.element_launches}


def path_delta(launcher, before: dict, path: str) -> bool:
    """True iff the launcher counted exactly one launch since `before`, on
    `path`."""
    after = path_launches(launcher)
    want = {"launches": 1, "vector": int(path == "vector"), "element": int(path == "element")}
    return {k: after[k] - before[k] for k in after} == want


def rmsnorm_sig(x, eps):
    """x [..., d] as the kernel sees it: [rows, d]."""
    return ("rmsnorm", int(x.numel() // x.shape[-1]), int(x.shape[-1]), str(x.dtype),
            float(eps))


def ssd_sig(x, B, chunk, final_state=False):
    """x, B and C are read through their strides: those are part of it; and
    whether the call returns the final state."""
    return ("ssd_scan", tuple(x.shape), str(x.dtype), tuple(x.stride()), tuple(B.shape),
            tuple(B.stride()), int(chunk), bool(final_state))


def rmsnorm_path(x, scale) -> str:
    """The path of the RMSNorm kernel a CUDA call of `rmsnorm` takes, as
    `rms_ops.rmsnorm_layout` chooses it: "register" (the row held in
    registers) or "element". A non-contiguous x is copied, so aligned."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_layout
    aligned = (not x.is_contiguous() or x.data_ptr() % 16 == 0) and scale.data_ptr() % 16 == 0
    return ("register" if rmsnorm_layout(x.shape[-1], x.element_size(), aligned)
            else "element")


def decode_kernel_phase(shape: str, kv_lens, int8: bool, seed: int, checked: set,
                        paged: bool = True, pages=None, max_pages=None, smax=None, *,
                        heads=H, kv_heads=K, d=D, dtype="bfloat16", timed: bool = True):
    """One decode kernel (paged, or slot-contiguous with `smax` positions)
    against its plain version: within one bf16 ulp of each output row's
    largest |o| (f32: 1e-5 of it), and exact zeros for kv_len 0. The call
    must take the route `decode_route` names; the row reports it, the
    splits, the device time of one call (every kernel it launches, by
    torch.profiler) and of SDPA on the same values, and the back-to-back
    CUDA-event time (`wall_ms`, which reads the host's time where that is
    the longer); the times only if `timed` (else a shape checked for its
    launch signature alone)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_decode_paged_ref,
                                                         flash_decode_ref, gather_pages)
    q, k, v, kvl, tab = _decode_inputs(kv_lens, seed, paged, pages, max_pages, smax,
                                       heads=heads, kv_heads=kv_heads, d=d, dtype=dtype)
    kw = {}
    if int8:
        (k, ks), (v, vs) = _quantize_cache(k), _quantize_cache(v)
        kw = {"k_scale": ks, "v_scale": vs}
    launcher = fa_ops.flash_decode_paged_cuda if paged else fa_ops.flash_decode_cuda
    if paged:
        def kernel():
            return launcher(q, k, v, kvl, tab, **kw)

        def plain():
            return flash_decode_paged_ref(q, k, v, kvl, tab, **kw)

        def dense(x):
            return gather_pages(x, tab)
    else:
        def kernel():
            return launcher(q, k, v, kvl, **kw)

        def plain():
            return flash_decode_ref(q, k, v, kvl, **kw)

        def dense(x):
            return x
    counters = {r: f"{r}_launches" for r in ("tensor_core", "cuda_core")}
    before = {r: getattr(launcher, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(launcher, a) > before[r]]
    name = (("flash_decode_paged_" if paged else "flash_decode_")
            + ("int8" if int8 else {"bfloat16": "bf16", "float32": "f32"}[dtype]))
    if took != [decode_route(q, k)]:
        raise AssertionError(f"{name} {shape}: took route {took}, expected "
                             f"{decode_route(q, k)}")
    want = plain()
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_row_ulp(want), 1.0
    else:
        unit, tol = want.abs().float().amax(dim=-1, keepdim=True).clamp_min(1e-30), 1e-5
    worst = (err / unit).max().item()
    zeros = bool((out[kvl == 0] == 0).all())
    if not (worst <= tol and zeros and torch.isfinite(out).all()):
        raise AssertionError(f"{name} {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit), "
                             f"zeros={zeros}")
    checked.add(decode_sig(q, k, tab))
    capacity = tab.shape[1] * PAGE if paged else smax
    b = len(kv_lens)
    splits = (fa_ops.decode_splits(b, kv_heads, capacity, fa_ops._sm_count(q.device))[0]
              if took[0] == "tensor_core" else 1)
    if not timed:
        row = {"phase": "kernel", "kernel": name, "shape": shape, "route": took[0],
               "splits": splits, "slots": b, "heads": heads, "kv_heads": kv_heads,
               "head_dim": d, "dtype": dtype, "cache": list(k.shape),
               "max_abs_err": err.max().item(), "max_err_over_unit": worst,
               "timed": False}
        emit(row)
        return row
    kernel_ms, device_ops, by_kernel = device_ms_per_call(kernel)
    wall_ms = time_ms(kernel)
    plain_ms = time_ms(plain, iters=10, warmup=2)
    # the yardstick sees the same values as slot-contiguous caches of q's type
    kc, vc = dense(k), dense(v)
    if int8:
        kc = (kc.float() * dense(ks)[..., None]).to(q.dtype)
        vc = (vc.float() * dense(vs)[..., None]).to(q.dtype)
    sdpa = _sdpa(q, kc, vc, kvl)
    library_ms, library_ops, _ = device_ms_per_call(sdpa)
    library_wall_ms = time_ms(sdpa)
    tokens = sum(kv_lens)
    esize = q.element_size()
    kv_bytes = tokens * kv_heads * d * (1 if int8 else esize) * 2
    if int8:
        kv_bytes += tokens * kv_heads * 4 * 2
    table_bytes = sum(-(-n // PAGE) for n in kv_lens) * 4 if paged else 0
    nbytes = 2 * b * heads * d * esize + kv_bytes + table_bytes + b * 4
    flops = 4 * heads * d * tokens + (2 * kv_heads * d * tokens * 2 if int8 else 0)
    peak = BF16_TENSOR_FLOPS_PER_S if took[0] == "tensor_core" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"phase": "kernel", "kernel": name, "shape": shape, "route": took[0],
           "splits": splits, "device_ops_per_call": device_ops,
           "device_ms_by_kernel": by_kernel, "slots": b,
           "heads": heads, "kv_heads": kv_heads, "head_dim": d, "dtype": dtype,
           "cache": list(k.shape), "kv_len_min": min(kv_lens), "kv_len_max": max(kv_lens),
           "kv_tokens": tokens, "max_abs_err": err.max().item(),
           "max_err_over_unit": worst,
           "tolerance": ("1 bf16 ulp of each row's max |plain|" if dtype == "bfloat16"
                         else "1e-5 of each row's max |plain|"),
           "kernel_ms": kernel_ms, "wall_ms": wall_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
           "library_ms": library_ms, "library_ops_per_call": library_ops,
           "library_wall_ms": library_wall_ms,
           "library": "F.scaled_dot_product_attention(enable_gqa=True)",
           "timing": "kernel_ms, library_ms: device time a call (torch.profiler); "
                     "wall_ms, library_wall_ms, plain_ms: CUDA events, back to back"}
    if paged:
        row["table_width"] = tab.shape[1]
    emit(row)
    return row


def decode_sync_phase(line):
    """The decode entries (`flash_decode_paged`, `flash_decode`) at the
    engine's shape and at long context, bf16 and int8, under
    torch.cuda.set_sync_debug_mode("error"), which raises on any host
    synchronisation inside the call; each output equals, bitwise, that of
    the same call made outside the mode."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    rng = np.random.default_rng(SEED + 6)
    long_lens = [int(n) for n in rng.integers(2048, 4097, 16)]
    cases = []
    for shape, lens, paged, kw in (
            ("engine", [160, 97, 0, 33], True,
             {"pages": DEVICE_PAGES, "max_pages": MAX_LEN // PAGE}),
            ("static_decode", [144] * REQUESTS, False, {"smax": MAX_LEN}),
            ("long_context", long_lens, True, {}),
            ("long_context", long_lens, False, {"smax": 4096})):
        for int8 in (False, True):
            q, k, v, kvl, tab = _decode_inputs(lens, 60 + len(cases), paged, **kw)
            extra = {}
            if int8:
                (k, ks), (v, vs) = _quantize_cache(k), _quantize_cache(v)
                extra = {"k_scale": ks, "v_scale": vs}
            call = ((lambda q=q, k=k, v=v, kvl=kvl, tab=tab, extra=extra:
                     fa_ops.flash_decode_paged(q, k, v, kvl, tab, **extra)) if paged else
                    (lambda q=q, k=k, v=v, kvl=kvl, extra=extra:
                     fa_ops.flash_decode(q, k, v, kvl, **extra)))
            cases.append((f"{'paged' if paged else 'contiguous'}_{shape}_"
                          f"{'int8' if int8 else 'bf16'}", call))
    outside = {name: call() for name, call in cases}
    torch.cuda.synchronize()
    inside = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, call in cases:
            inside[name] = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(inside[name], outside[name])) for name in inside}
    row = {"phase": "decode_sync_debug", "card": line, "mode": "error",
           "calls": list(inside), "bitwise_equal": same}
    emit(row)
    if not all(same.values()):
        raise AssertionError(f"decode under sync debug: outputs differ {same}")
    return row


def f32_decode_phase(line, checked):
    """The decode kernels' CUDA-core route on its own path. No configuration
    of the repo reaches it from a model (every serve path is bf16 at
    head_dim 128), so its path is the decode entry `flash_decode` on f32
    tensors at qwen2.5-14b's attention width and the static loop's shape
    (q [8, 40, 128], caches [8, 160, 8, 128], kv_len 144), counts reset just
    before and read just after: one launch, on the CUDA cores, of a shape
    the kernel phases checked, and a finite f32 output."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    q, k, v, kvl, _ = _decode_inputs([144] * REQUESTS, SEED + 7, False, smax=MAX_LEN,
                                     dtype="float32")
    with launch_signatures() as (seen, calls, launches):
        o = fa_ops.flash_decode(q, k, v, kvl)
        torch.cuda.synchronize()
    unchecked = sorted(seen - checked)
    checks = {
        "one_launch": launches["flash_decode"] == 1,
        "took_cuda_core": launches["flash_decode_cuda_core"] == 1,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "f32_output": o.shape == q.shape and o.dtype == torch.float32,
        "finite": bool(torch.isfinite(o).all()),
    }
    row = {"phase": "f32_decode", "q": list(q.shape), "kv": list(k.shape), "card": line,
           "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 decode: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def attention_kernel_phase(shape: str, b: int, sq: int, seed: int, checked: set, *,
                           skv=None, heads=H, kv_heads=K, d=D, dtype="bfloat16",
                           window=0, q_offset=0, timed: bool = True):
    """Kernel #1 (causal) against its plain version: within one bf16 ulp of
    each output row's largest |o| (f32 inputs: 1e-5 of it), every row; a
    row with no visible key holds the mean of v over all keys of its kv
    head (as the JAX oracle's), which it is held to by the same rule. The
    call must take the route `attention_route` names (bf16 at head_dim 64,
    128 or 256: wgmma; else the CUDA cores); the row reports it. Timed
    unless `timed` is False (a shape checked for its launch signature)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         flash_attention_ref)
    skv = skv or sq
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shp, generator=gen, device="cuda").to(dt)
               for shp in ((b, sq, heads, d), (b, skv, kv_heads, d), (b, skv, kv_heads, d)))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))   # kernel layout

    def kernel():
        return flash_attention_cuda(q, k, v, **kw)

    def plain():
        return flash_attention_ref(qt, kt, vt, **kw)
    counters = {r: f"{r}_launches" for r in ("wgmma", "cuda_core")}
    before = {r: getattr(flash_attention_cuda, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(flash_attention_cuda, a) > before[r]]
    if took != [attention_route(q)]:
        raise AssertionError(f"flash_attention {shape}: took route {took}, expected "
                             f"{attention_route(q)}")
    want = plain().transpose(1, 2)
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_row_ulp(want), 1.0
    else:
        unit, tol = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30), 1e-5
    worst = (err / unit).max().item()
    off = k.shape[1] - sq if q_offset is None else q_offset
    mask = attention_mask(sq, skv, "cuda", causal=True, window=window, q_offset=off)
    empty = ~mask.any(dim=-1)                                     # rows with no key
    # [B, Sq, H, D]: query head h reads kv head h // (H / K)
    vmean = v.float().mean(dim=1).repeat_interleave(heads // kv_heads, dim=1)
    no_key_err = (out[:, empty].float() - vmean[:, None]).abs()
    no_key_worst = (no_key_err / unit[:, empty]).max().item() if bool(empty.any()) else 0.0
    if not (worst <= tol and no_key_worst <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"flash_attention {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit), rows "
                             f"without a key {no_key_worst} units from the mean of v")
    checked.add(attention_sig(q, k, True, window, q_offset))
    if not timed:
        row = {"phase": "kernel", "kernel": "flash_attention_fwd", "shape": shape,
               "route": took[0], "q": list(q.shape), "kv": list(k.shape), "dtype": dtype,
               "max_abs_err": err.max().item(), "max_err_over_unit": worst, "timed": False}
        emit(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        return row
    kernel_ms = time_ms(kernel, iters=20, warmup=3)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    if q_offset == 0 and window == 0 and sq == skv:
        sdpa_kw = {"is_causal": True}
    else:   # SDPA's causal mask is top-left aligned: give it ours
        sdpa_kw = {"attn_mask": mask}
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **sdpa_kw), iters=20, warmup=3)
    pairs = int(mask.sum().item())                 # (query, key) pairs this run computes
    esize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
    flops = 4 * d * pairs * b * heads
    peak = BF16_TENSOR_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    row = {"phase": "kernel", "kernel": "flash_attention_fwd", "shape": shape,
           "route": took[0], "q": list(q.shape), "kv": list(k.shape), "dtype": dtype,
           "window": window,
           "q_offset": q_offset, "pairs": pairs * b * heads, "gflop": flops / 1e9,
           "rows_without_key": int(empty.sum().item()),
           "no_key_rows_vs_mean_of_v_over_unit": no_key_worst, "max_abs_err": err.max().item(),
           "max_err_over_unit": worst,
           "tolerance": ("1 bf16 ulp of each row's max |plain|" if dtype == "bfloat16"
                         else "1e-5 of each row's max |plain|"),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_peak": peak, "library_ms": library_ms,
           "library": "F.scaled_dot_product_attention(enable_gqa=True, "
                      + ("is_causal=True)" if "is_causal" in sdpa_kw else "attn_mask=mask)"),
           "kernel_tflop_s": flops / kernel_ms / 1e9}
    emit(row)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def _quantize_input(rows: int, cols: int, dtype: str, seed: int, nonfinite: bool = False):
    """Rows of very different sizes, the first all zeros (scale 1). With
    `nonfinite`, rows 1-5 hold a NaN, +inf, -inf, NaN with both infinities,
    and only NaN (a NaN or an infinity in a gradient on DDL's pod hop, or
    in a k/v row on the int8 serve path)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, cols), generator=gen, device="cuda")
         * torch.rand((rows, 1), generator=gen, device="cuda") * 4).to(getattr(torch, dtype))
    x[0] = 0
    if nonfinite:
        nan, inf = float("nan"), float("inf")
        x[1, 3] = nan
        x[2, 0] = inf
        x[3, cols - 1] = -inf
        x[4, :3] = torch.tensor([nan, inf, -inf])
        x[5] = nan
    return x


def quantize_kernel_phase(shape: str, rows: int, seed: int, checked: set, *, cols: int = D,
                          dtype: str = "bfloat16", timed: bool = True, nonfinite: bool = False,
                          offset: int = 0):
    """The quantizer against its plain version, bitwise (codes and scales),
    asserting the path it took; timed unless `timed` is False (a shape
    checked only for its launch signature); with `nonfinite`, on rows
    holding NaN and infinities; with `offset`, on rows that start that many
    elements into their buffer (unaligned: the element path)."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_cuda
    from repro_torch.kernels.quantize.ref import quantize_ref
    x = _quantize_input(rows, cols, dtype, seed, nonfinite)
    if offset:
        buf = torch.empty(rows * cols + offset, dtype=x.dtype, device="cuda")
        x = buf[offset:].view(rows, cols).copy_(x)
    path = quantize_path(x)
    before = path_launches(quantize_cuda)
    q, s = quantize_cuda(x)
    torch.cuda.synchronize()
    if not path_delta(quantize_cuda, before, path):
        raise AssertionError(f"quantize {shape}: did not take the {path} path")
    pq, ps = quantize_ref(x)
    if not (torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32))):
        raise AssertionError(f"quantize {shape}: codes or scales differ from the "
                             "plain version")
    checked.add(quantize_sig(x))
    row = {"phase": "kernel", "kernel": "quantize_rows", "shape": shape, "rows": rows,
           "cols": cols, "dtype": dtype, "path": path,
           "max_abs_err": float((q.float() - pq.float()).abs().max()),
           "tolerance": "bitwise"}
    if nonfinite:
        row["nonfinite_rows"] = {"scales": [str(x) for x in s[1:6].tolist()],
                                 "codes_of_nan_elements": q[x.isnan()].unique().tolist()}
    if timed:
        # the launch is shorter than its wrapper's host time: back-to-back
        # events read the host, the profiler the kernel itself
        back_to_back_ms = time_ms(lambda: quantize_cuda(x))
        kernel_ms = device_ms(lambda: quantize_cuda(x), "quantize_rows_kernel")
        plain_ms = time_ms(lambda: quantize_ref(x), iters=20)
        bound_ms, bound_by = bound(rows * cols * x.element_size() + rows * cols + rows * 4,
                                   rows * cols * 5)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
                    "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    return row


def dequantize_kernel_phase(shape: str, rows: int, cols: int, seed: int, checked: set, *,
                            out_dtype: str = "float32", timed: bool = True):
    """The dequantizer against its plain version, bitwise, on the codes and
    scales of the quantizer's plain version; timed unless `timed` is False.
    Its bound is bytes: 1 B of code in and 4 (f32) or 2 (bf16) B out an
    element, 4 B of scale a row, for one multiply an element. No single
    PyTorch call computes it (`q.float() * scale[:, None]` is two passes):
    library_ms is null."""
    import torch
    from repro_torch.kernels.quantize.ops import dequantize_cuda
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    q, s = quantize_ref(_quantize_input(rows, cols, "float32", seed))
    dt = getattr(torch, out_dtype)
    path = dequantize_path(q)
    before = path_launches(dequantize_cuda)
    out = dequantize_cuda(q, s, dt)
    torch.cuda.synchronize()
    if not path_delta(dequantize_cuda, before, path):
        raise AssertionError(f"dequantize {shape}: did not take the {path} path")
    want = dequantize_ref(q, s, dt)
    ints = torch.int32 if dt == torch.float32 else torch.int16
    if not torch.equal(out.view(ints), want.view(ints)):
        raise AssertionError(f"dequantize {shape}: output differs from the plain version")
    checked.add(dequantize_sig(q, dt))
    row = {"phase": "kernel", "kernel": "dequantize_rows", "shape": shape, "rows": rows,
           "cols": cols, "out_dtype": out_dtype, "path": path,
           "max_abs_err": float((out.float() - want.float()).abs().max()),
           "tolerance": "bitwise"}
    if timed:
        back_to_back_ms = time_ms(lambda: dequantize_cuda(q, s, dt))
        kernel_ms = device_ms(lambda: dequantize_cuda(q, s, dt), "dequantize_rows")
        plain_ms = time_ms(lambda: dequantize_ref(q, s, dt), iters=20)
        bound_ms, bound_by = bound(rows * cols * (1 + out.element_size()) + rows * 4,
                                   rows * cols)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
                    "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    del q, s, out, want
    return row


def _kv_write_inputs(b: int, paged: bool, seed: int, dtype: str = "bfloat16", kv_heads=K):
    """The decode step's k/v rows [b, 1, K, D] (slot 0's second kv head of
    k all NaN, slot 1's v holding one NaN), int8 caches with arbitrary
    contents (the engine's arena of DEVICE_PAGES + 1 pages of PAGE for 4
    slots, MAX_LEN / PAGE pages a slot beyond; slot-contiguous [b,
    MAX_LEN]), positions with writes at a page's start and end (and past
    MAX_LEN on slot-contiguous caches), every fourth slot inactive, and,
    paged, a table as the pool keeps it: each active slot's pages distinct
    and scrambled, the rest on the null page (the arena's last)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_pages = MAX_LEN // PAGE
    if paged:
        shape = (DEVICE_PAGES + 1 if b <= SLOTS else b * max_pages + 1, PAGE)
        starts = [PAGE, PAGE - 1, 0, MAX_LEN - 1]
    else:
        shape = (b, MAX_LEN)
        starts = [2 * MAX_LEN, PAGE - 1, 0, MAX_LEN - 1, PAGE]
    pos = [starts[i % len(starts)] for i in range(b)]
    act = [i % 4 != 2 for i in range(b)]
    k, v = ((torch.randn((b, 1, kv_heads, D), generator=gen, device="cuda") * 3).to(
        getattr(torch, dtype)) for _ in range(2))
    k[0, 0, 1] = float("nan")
    v[min(1, b - 1), 0, 0, 5] = float("nan")
    caches = [torch.randint(-127, 128, shape + (kv_heads, D), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2)]
    caches += [torch.rand(shape + (kv_heads,), generator=gen, device="cuda") for _ in range(2)]
    table = None
    if paged:
        null = shape[0] - 1
        table = torch.full((b, max_pages), null, dtype=torch.int32)
        perm = torch.randperm(null, generator=torch.Generator().manual_seed(seed))
        nxt = 0
        for i in range(b):
            if act[i]:
                need = pos[i] // PAGE + 1
                table[i, :need] = perm[nxt:nxt + need]
                nxt += need
        table = table.cuda()
    positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
    active = torch.tensor(act, device="cuda")
    return k, v, caches, table, positions, active


def _kv_write_composition(k, v, caches, table, positions, active):
    """The decode step's int8 write as it ran before the fused kernel:
    each of k and v through the quantize kernel, then codes and scales
    written by four gather/where/scatter passes (`paging.paged_write`, or
    `_slot_write` at min(pos, Smax - 1)). A yardstick only."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_cuda
    from repro_torch.models import paging
    from repro_torch.models.transformer import _slot_write
    kc, vc, ks, vs = caches
    (kq, kss), (vq, vss) = (quantize_cuda(x.reshape(-1, x.shape[-1])) for x in (k, v))
    b = k.shape[0]
    new = {"k": kq.reshape(k.shape), "v": vq.reshape(v.shape),
           "ks": kss.reshape(b, 1, -1), "vs": vss.reshape(b, 1, -1)}
    slots = None if table is not None else torch.clamp(positions, max=kc.shape[1] - 1)
    for cache, key in ((ks, "ks"), (vs, "vs"), (kc, "k"), (vc, "v")):
        if table is None:
            _slot_write(cache, new[key], slots, active)
        else:
            paging.paged_write(cache, new[key], table, positions, active, kc.shape[1])


def quantize_kv_write_kernel_phase(shape: str, b: int, paged: bool, seed: int, checked: set,
                                   *, dtype: str = "bfloat16", kv_heads: int = K,
                                   timed: bool = True):
    """The fused decode-step write against its plain version on copies of
    the same caches, bitwise on every byte of codes and scales (inactive
    slots, NaN rows, a page's first and last position, positions past
    Smax), under torch.cuda.set_sync_debug_mode("error") (the wrapper reads
    no device value on the host), asserting its path; timed by
    torch.profiler beside the composition it replaces (two quantize
    launches and four plain writes: its device time and device operations
    a call; unless `timed` is False). Bound: bytes, k and v read and codes
    and scales written."""
    import torch
    from repro_torch.kernels.quantize.ops import quantize_kv_write_cuda
    from repro_torch.kernels.quantize.ref import quantize_kv_write_ref
    k, v, caches, table, positions, active = _kv_write_inputs(b, paged, seed, dtype, kv_heads)
    want = [c.clone() for c in caches]
    quantize_kv_write_ref(k, v, *want, table, positions, active)
    got = [c.clone() for c in caches]
    path = kv_write_path(k, v, got[0], got[1])
    before = path_launches(quantize_kv_write_cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        quantize_kv_write_cuda(k, v, *got, table, positions, active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not path_delta(quantize_kv_write_cuda, before, path):
        raise AssertionError(f"quantize_kv_write {shape}: did not take the {path} path")
    same = all(torch.equal(g.view(torch.uint8) if g.dtype == torch.int8 else g.view(torch.int32),
                           w.view(torch.uint8) if w.dtype == torch.int8 else w.view(torch.int32))
               for g, w in zip(got, want))
    if not same:
        raise AssertionError(f"quantize_kv_write {shape}: caches differ from the plain version")
    checked.add(quantize_kv_write_sig(k, got[0], table))
    if not timed:
        row = {"phase": "kernel", "kernel": "quantize_kv_write", "shape": shape, "slots": b,
               "kv_heads": kv_heads, "head_dim": D, "paged": paged, "dtype": dtype,
               "path": path, "max_abs_err": 0.0, "tolerance": "bitwise", "timed": False}
        emit(row)
        return row
    kernel_ms, ops, by = device_ms_per_call(
        lambda: quantize_kv_write_cuda(k, v, *got, table, positions, active))
    comp_ms, comp_ops, _ = device_ms_per_call(
        lambda: _kv_write_composition(k, v, got, table, positions, active))
    plain_ms = time_ms(lambda: quantize_kv_write_ref(k, v, *got, table, positions, active),
                       iters=20)
    elems = 2 * b * kv_heads * D
    bound_ms, bound_by = bound(elems * k.element_size() + elems + 2 * b * kv_heads * 4
                               + b * (4 + 1 + (4 if paged else 0)), elems * 5)
    row = {"phase": "kernel", "kernel": "quantize_kv_write", "shape": shape, "slots": b,
           "kv_heads": kv_heads, "head_dim": D, "paged": paged, "dtype": dtype, "path": path,
           "max_abs_err": 0.0, "tolerance": "bitwise", "sync_debug": "error",
           "kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler", "device_ops": ops,
           "by_kernel": by, "composition_ms": comp_ms, "composition_device_ops": comp_ops,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    emit(row)
    return row


def dequantize_sum_kernel_phase(shape: str, pods: int, rows: int, n: int, seed: int,
                                checked: set, *, cols: int = 1024, timed: bool = True):
    """The pod sum against its plain version (the pod hop's loop), bitwise,
    on the codes and scales of `pods` pods' quantized rows (one pod's rows
    holding NaN and infinities), asserting its path; timed unless `timed`
    is False, by torch.profiler beside the composition it replaces (a zero
    fill, a dequantize launch and an add a pod). Bound: bytes, every pod's
    codes and scales read, n f32 written; 2 operations an element a pod.
    No single PyTorch call computes it: library_ms is null."""
    import torch
    from repro_torch.kernels.quantize.ops import dequantize_cuda, dequantize_sum_rows_cuda
    from repro_torch.kernels.quantize.ref import dequantize_sum_rows_ref, quantize_ref
    parts = [quantize_ref(_quantize_input(rows, cols, "float32", seed + p,
                                          nonfinite=p == 1 and rows > 5))
             for p in range(pods)]
    qg = torch.stack([c for c, _ in parts])
    sg = torch.stack([sc for _, sc in parts])
    del parts
    path = dequantize_path(qg)
    before = path_launches(dequantize_sum_rows_cuda)
    out = dequantize_sum_rows_cuda(qg, sg, n)
    torch.cuda.synchronize()
    if not path_delta(dequantize_sum_rows_cuda, before, path):
        raise AssertionError(f"dequantize_sum_rows {shape}: did not take the {path} path")
    want = dequantize_sum_rows_ref(qg, sg, n)
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"dequantize_sum_rows {shape}: output differs from the plain "
                             "version")
    checked.add(dequantize_sum_sig(qg, n))
    row = {"phase": "kernel", "kernel": "dequantize_sum_rows", "shape": shape, "pods": pods,
           "rows": rows, "cols": cols, "n": n, "path": path,
           "max_abs_err": float((out - want).abs().nan_to_num().max()),
           "tolerance": "bitwise"}
    if timed:
        def composition():
            total = torch.zeros(n, dtype=torch.float32, device="cuda")
            for i in range(pods):
                total = total + dequantize_cuda(qg[i], sg[i]).reshape(-1)[:n]
            return total
        kernel_ms, ops, _ = device_ms_per_call(lambda: dequantize_sum_rows_cuda(qg, sg, n))
        comp_ms, comp_ops, comp_by = device_ms_per_call(composition)
        plain_ms = time_ms(lambda: dequantize_sum_rows_ref(qg, sg, n), iters=20)
        bound_ms, bound_by = bound(pods * (rows * cols + rows * 4) + n * 4, 2 * pods * n)
        row.update({"kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler", "device_ops": ops,
                    "composition_ms": comp_ms, "composition_device_ops": comp_ops,
                    "composition_by_kernel": comp_by, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    emit(row)
    del qg, sg, out, want
    return row


def bf16_ulp(x):
    """One bf16 ulp (8 significand bits) at each element's |x|, floored at
    the smallest normal."""
    import torch
    e = torch.floor(torch.log2(x.abs().float().clamp_min(1e-30)))
    return torch.exp2(e - 7).clamp_min(2.0 ** -126)


def rmsnorm_kernel_phase(shape: str, rows: int, d: int, seed: int, checked: set, *,
                         dtype="bfloat16", eps=1e-6, offset=0, timed: bool = True):
    """The RMSNorm kernel against its plain version on rows of varied
    scale (one all zero): bf16 within one bf16 ulp of each element (both
    are the f32 value x * r * s rounded once, and the f32 values differ by
    a few f32 ulps of the row's sum of squares and rsqrt, so they round to
    the same or neighbouring bf16 values); f32 within 2e-6 of each
    element (one product chain per element, with r = rsqrt(mean + eps)
    computed from sums in other orders: a few f32 ulps). x starts `offset`
    elements into its buffer (an unaligned start with offset 1). The call
    must take the path `rmsnorm_path` names, which the row reports with the
    warps a row (`ops.rmsnorm_layout`). Kernel and `F.rms_norm` are both
    timed on the card by torch.profiler (every kernel a call launches), and
    both back to back by CUDA events too; unless `timed` is False (a shape
    checked for its launch signature)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_cuda, rmsnorm_layout
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device="cuda")
         * (torch.rand((rows, 1), generator=gen, device="cuda") * 8 + 0.05)).to(
             getattr(torch, dtype))
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(rows, d)
    x[min(1, rows - 1)] = 0
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")

    def kernel():
        return rmsnorm_cuda(x, scale, eps=eps)

    def plain():
        return rmsnorm_ref(x, scale, eps=eps)
    path = rmsnorm_path(x, scale)
    counters = {p: f"{p}_launches" for p in RMSNORM_KERNELS}
    before = {p: getattr(rmsnorm_cuda, a) for p, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [p for p, a in counters.items() if getattr(rmsnorm_cuda, a) > before[p]]
    if took != [path]:
        raise AssertionError(f"rmsnorm {shape}: took path {took}, expected {path}")
    want = plain()
    err = (out.float() - want.float()).abs()
    if dtype == "bfloat16":
        unit, tol = bf16_ulp(want), 1.0
    else:
        unit, tol = want.abs().clamp_min(1e-30), 2e-6
    worst = (err / unit).max().item()
    differing = (out != want).double().mean().item()
    if not (worst <= tol and out.dtype == x.dtype and bool(torch.isfinite(out).all())):
        raise AssertionError(f"rmsnorm {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit)")
    checked.add(rmsnorm_sig(x, eps))
    if not timed:
        row = {"phase": "kernel", "kernel": "rmsnorm", "shape": shape, "rows": rows, "d": d,
               "dtype": dtype, "eps": eps, "path": path, "max_abs_err": err.max().item(),
               "max_err_over_unit": worst, "timed": False}
        emit(row)
        return row
    back_to_back_ms = time_ms(kernel)
    kernel_ms = device_ms(kernel, RMSNORM_KERNELS[path])
    plain_ms = time_ms(plain, iters=20)
    w = scale.to(x.dtype)             # F.rms_norm takes a weight of the input's type

    def library():
        return F.rms_norm(x, (d,), weight=w, eps=eps)
    library_ms, library_ops, library_by = device_ms_per_call(library)
    library_back_to_back_ms = time_ms(library)
    nbytes = 2 * x.numel() * x.element_size() + 4 * d
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())
    layout = rmsnorm_layout(d, x.element_size(), path == "register")
    row = {"phase": "kernel", "kernel": "rmsnorm", "shape": shape, "rows": rows, "d": d,
           "dtype": dtype, "eps": eps, "path": path, "kernel_name": RMSNORM_KERNELS[path],
           "warps_per_row": layout[0] if layout else None,
           "vectors_per_lane": layout[1] if layout else None, "x_offset": offset,
           "max_abs_err": err.max().item(),
           "max_err_over_unit": worst, "share_of_elements_differing": differing,
           "tolerance": ("1 bf16 ulp of each element" if dtype == "bfloat16"
                         else "2e-6 of each element"),
           "kernel_ms": kernel_ms, "kernel_ms_by": "torch.profiler",
           "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
           "library_ms": library_ms, "library_ms_by": "torch.profiler, every kernel a call",
           "library_ops_per_call": library_ops, "library_ms_by_kernel": library_by,
           "library_back_to_back_ms": library_back_to_back_ms,
           "library": "F.rms_norm(x, (d,), weight=scale in x's dtype, eps=eps)",
           "kernel_over_library": kernel_ms / library_ms,
           "kernel_gb_s": nbytes / kernel_ms / 1e6}
    emit(row)
    return row


def rmsnorm_grad_phase(rows: int, d: int, seed: int):
    """The autograd Function the model calls on the card (kernel forward,
    plain analytic backward) against torch autograd through the plain
    version, f32: output within 2e-6 of each element, dx and dscale within
    1e-5 of their largest |value| (the terms of dx cancel); the forward
    launches the kernel once; bf16 x gives a bf16 dx and an f32 dscale."""
    import torch
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device="cuda") * 3
    scale = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")
    dy = torch.randn((rows, d), generator=gen, device="cuda")
    before = rms_ops.rmsnorm_cuda.launches
    xk, sk = x.clone().requires_grad_(), scale.clone().requires_grad_()
    out = rms_ops.rmsnorm(xk, sk, eps=1e-6)
    out.backward(dy)
    launched = rms_ops.rmsnorm_cuda.launches - before
    xp, sp = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rmsnorm_ref(xp, sp, eps=1e-6)
    want.backward(dy)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    xb = x.bfloat16().requires_grad_()
    rms_ops.rmsnorm(xb, sk.detach().requires_grad_(), eps=1e-6).backward(dy.bfloat16())
    checks = {
        "out_within_2e-6": ((out - want).abs() / want.abs().clamp_min(1e-30)).max().item()
                           <= 2e-6,
        "dx_within_1e-5": rel(xk.grad, xp.grad) <= 1e-5,
        "dscale_within_1e-5": rel(sk.grad, sp.grad) <= 1e-5,
        "one_launch": launched == 1,
        "bf16_dx_dtype": xb.grad.dtype == torch.bfloat16,
    }
    emit({"phase": "rmsnorm_grad", "rows": rows, "d": d, "dx_rel_err": rel(xk.grad, xp.grad),
          "dscale_rel_err": rel(sk.grad, sp.grad), "tolerance": "1e-5 of the largest |value|",
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"rmsnorm grad: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")


def _log_uniform(shape, lo, hi, gen):
    """exp(U[log lo, log hi]) on the card."""
    import math
    import torch
    u = torch.rand(shape, generator=gen, device="cuda")
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def _ssd_inputs(b, l, h, p, g, n, dtype, seed, dt_kind):
    """Scan inputs on the card as apply_ssm hands them over: x, B and C
    views into one [b, l, h*p + 2*g*n] buffer of `dtype` (the convolution's
    output), A = -uniform[1, 16) [h] (the range of the `ssm_a` init) and
    dt f32 [b, l, h]: "softplus", softplus(normal), as a model with
    dt_bias 0 gives it; "trained", a level per (batch row, head) log-
    uniform on [1e-3, 1e-1] (the range Mamba-2 draws dt_bias from) times
    exp(N(0, 0.5**2)) per position, where the state carried from one chunk
    to the next keeps a share of itself that the check can see."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    buf = torch.randn((b, l, di + 2 * g * n), generator=gen, device="cuda").to(dtype)
    x = buf[..., :di].reshape(b, l, h, p)
    B = buf[..., di:di + g * n].reshape(b, l, g, n)
    C = buf[..., di + g * n:].reshape(b, l, g, n)
    noise = torch.randn((b, l, h), generator=gen, device="cuda")
    if dt_kind == "softplus":
        dt = F.softplus(noise)
    elif dt_kind == "trained":
        dt = _log_uniform((b, 1, h), 1e-3, 1e-1, gen) * torch.exp(0.5 * noise)
    else:
        raise ValueError(dt_kind)
    A = -(torch.rand((h,), generator=gen, device="cuda") * 15.0 + 1.0)
    return x, dt, A, B, C


def _scan_without_decayed_state(x, dt, A, B, C, chunk):
    """The plain scan with a planted fault: the state handed to each chunk
    is the previous chunk's own contribution S alone, the older state it
    should carry on, exp(cum_last) * h, dropped. Chunk c's rows are the
    plain scan's over chunks c-1 and c from a zero state."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    q = min(chunk, x.shape[1])
    ys = []
    for c0 in range(0, x.shape[1], q):
        a, e = max(c0 - q, 0), c0 + q
        y = ssd_scan_ref(x[:, a:e], dt[:, a:e], A, B[:, a:e], C[:, a:e], chunk=q)[0]
        ys.append(y[:, c0 - a:])
    return torch.cat(ys, dim=1)


def _chunk_decays(dt, A, chunk):
    """exp(cum_last) of every chunk but the last, per (batch row, chunk,
    head): the share of the state that each chunk hands on to the next."""
    import torch
    b, l, h = dt.shape
    q = min(chunk, l)
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, (-l) % q))
    cum_last = dA.double().reshape(b, -1, q, h).sum(dim=2)
    return torch.exp(cum_last[:, :-1]).flatten()


def ssd_kernel_phase(shape: str, b: int, l: int, seed: int, checked: set, *, h=64, p=64,
                     g=1, n=128, chunk=256, dtype="bfloat16", dt_kind="softplus", route=None):
    """The SSD scan kernel against its plain version, per (batch row,
    head): bf16 within one bf16 ulp of that head's largest |y| (the two
    f32 results, summed in other orders, round apart by at most that);
    f32 within 2e-5 of it. Both take the chunk's prefix sums of dt * A in
    f64 and round each once, so their decays differ only by the f32 exp;
    the products over n and the chunk's rows sum in other orders.

    Where the sequence spans chunks, the plain scan with a planted fault —
    the older state exp(cum_last) * h dropped from what each chunk hands
    on — is held to the plain scan by the same rule and its error
    reported, with the chunks' decays exp(cum_last): with softplus(normal)
    dt they are ~0 and the fault is invisible; with "trained" dt the row
    fails unless the faulty scan lies 10 tolerances away, so a kernel
    with that fault could not pass it.

    The call must take the route `ssd_ops.ssd_route` names (`route`, where
    given, must be it too); the row reports it, and the device time of one
    call, every kernel it launches summed (torch.profiler), beside the
    back-to-back CUDA-event time (`wall_ms`)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, getattr(torch, dtype), seed, dt_kind)
    launcher = ssd_ops.ssd_scan_cuda

    def kernel():
        return launcher(x, dt, A, B, C, chunk=chunk)

    def plain():
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)[0]
    expected = ssd_ops.ssd_route(x, B, C, chunk)
    counters = {r: f"{r}_launches" for r in SSD_KERNELS}
    before = {r: getattr(launcher, a) for r, a in counters.items()}
    out = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(launcher, a) > before[r]]
    if took != [expected] or (route is not None and expected != route):
        raise AssertionError(f"ssd_scan {shape}: took route {took}, expected {expected} "
                             f"(wanted {route})")
    want = plain()
    err = (out.float() - want.float()).abs().amax(dim=(1, 3))          # [b, h]
    top = want.float().abs().amax(dim=(1, 3)).clamp_min(1e-30)
    if dtype == "bfloat16":
        unit, tol = torch.exp2(torch.floor(torch.log2(top)) - 7), 1.0
    else:
        unit, tol = top, 2e-5
    worst = (err / unit).max().item()
    if not (worst <= tol and bool(torch.isfinite(out).all())):
        raise AssertionError(f"ssd_scan {shape}: kernel vs plain max |diff| "
                             f"{err.max().item()} ({worst} of the tolerance unit)")
    carry = None
    if l > chunk:
        faulty = _scan_without_decayed_state(x, dt, A, B, C, chunk).float()
        fault_worst = ((faulty - want.float()).abs().amax(dim=(1, 3)) / unit).max().item()
        decays = _chunk_decays(dt, A, chunk)
        carry = {"chunk_decay_min": decays.min().item(),
                 "chunk_decay_median": decays.median().item(),
                 "chunk_decay_max": decays.max().item(),
                 "chunk_decay_share_above_1e-3": (decays > 1e-3).double().mean().item(),
                 "decayed_state_dropped_err_over_unit": fault_worst}
        del faulty
        if dt_kind == "trained" and not fault_worst > 10 * tol:
            raise AssertionError(f"ssd_scan {shape}: the plain scan without the decayed "
                                 f"state lies only {fault_worst} units from it")
    checked.add(ssd_sig(x, B, chunk))
    wall_ms = time_ms(kernel, iters=10, warmup=2)
    kernel_ms, device_ops, by_kernel = device_ms_per_call(kernel)
    if not set(by_kernel) <= set(SSD_KERNELS[took[0]]) | {"Memset"}:
        raise AssertionError(f"ssd_scan {shape}: a call ran {sorted(by_kernel)}")
    plain_ms = time_ms(plain, iters=3, warmup=1)
    q = min(chunk, l)
    rows = [min(q, l - c0) for c0 in range(0, l, q)]
    pairs = sum(r * (r + 1) // 2 for r in rows)     # causal (i, j) pairs in the chunks
    # scores C_i . B_j and S . (dt x) over the pairs; the inter-chunk readout
    # and the state update, p x n products per row each
    flops = b * h * (2 * pairs * (n + p) + 4 * l * p * n)
    esize = x.element_size()
    nbytes = 2 * b * l * h * p * esize + b * l * h * 4 + h * 4 + 2 * b * l * g * n * esize
    peak = BF16_TENSOR_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
    bound_ms, bound_by = bound(nbytes, flops, peak)
    q = min(chunk, l)
    nc1 = -(-l // q) - 1
    row = {"phase": "kernel", "kernel": "ssd_scan", "shape": shape, "route": took[0],
           "x": list(x.shape), "groups": g, "state": n, "chunk": chunk, "dtype": dtype,
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "workspace_mbytes": (b * nc1 * h * (p * n + 1) * 4 / 1e6
                                if took[0] == "tensor_core" else 0.0),
           "max_abs_err": err.max().item(),
           "max_err_over_unit": worst, "dt": dt_kind, "carry": carry,
           "tolerance": ("1 bf16 ulp of each (batch, head)'s max |plain|"
                         if dtype == "bfloat16" else "2e-5 of each (batch, head)'s max |plain|"),
           "kernel_ms": kernel_ms, "device_ops_per_call": device_ops,
           "device_ms_by_kernel": by_kernel, "wall_ms": wall_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": peak,
           "bound_share": bound_ms / kernel_ms,
           "library_ms": None, "library": "none: no single PyTorch call computes the scan",
           "timing": "kernel_ms: device time a call, every kernel summed (torch.profiler); "
                     "wall_ms, plain_ms: CUDA events, back to back",
           "kernel_tflop_s": flops / kernel_ms / 1e9}
    emit(row)
    del x, dt, A, B, C, out, want
    torch.cuda.empty_cache()
    return row


def ssd_final_state_kernel_phase(shape: str, b: int, l: int, seed: int, checked: set, *,
                                 dtype="bfloat16", timed: bool = True, h=64, p=64, g=1, n=128,
                                 chunk=256):
    """The SSD scan with its final state (`final_state=True`, the serve
    path's prefill) against the plain scan's (y, h_final), per (batch row,
    head), at the inputs `ssd_kernel_phase` makes with dt in a trained
    model's range (where the state carried across chunks shows): y by that
    phase's rule for the route (bf16: one bf16 ulp of the head's max |y|;
    f32: 2e-5 of it), h_final against the head's max |h_final| (bf16:
    SSD_H_FINAL_BF16_TOL of its bf16 ulp, and at a timed shape the plain
    model of the route with the lo operands dropped must miss that rule;
    f32: 2e-5 of it). y must equal bitwise the same call without the final state
    (the final state adds an output and changes nothing else), and the
    call must take the route `ssd_route` names, counted in the launcher's
    final-state count of that route. Timed (unless `timed` is False: a
    shape checked for its launch signature) as `ssd_kernel_phase` times,
    with the same call without the final state beside it."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref
    x, dt, A, B, C = _ssd_inputs(b, l, h, p, g, n, getattr(torch, dtype), seed, "trained")
    launcher = ssd_ops.ssd_scan_cuda

    def kernel():
        return launcher(x, dt, A, B, C, chunk=chunk, final_state=True)

    def without():
        return launcher(x, dt, A, B, C, chunk=chunk)

    def plain():
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    route = ssd_ops.ssd_route(x, B, C, chunk)
    counters = {r: f"final_state_{r}_launches" for r in SSD_KERNELS}
    before = {r: getattr(launcher, a) for r, a in counters.items()}
    y, hf = kernel()
    torch.cuda.synchronize()
    took = [r for r, a in counters.items() if getattr(launcher, a) > before[r]]
    want_route = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    if took != [route] or route != want_route:
        raise AssertionError(f"ssd_scan final state {shape}: took route {took}, expected "
                             f"{route} (wanted {want_route})")
    y0 = without()
    want_y, want_h = plain()
    bf16 = dtype == "bfloat16"

    def rule(got, want, dims, tol):
        err = (got.float() - want.float()).abs().amax(dim=dims)          # [b, h]
        top = want.float().abs().amax(dim=dims).clamp_min(1e-30)
        unit = torch.exp2(torch.floor(torch.log2(top)) - 7) if bf16 else top
        return {"max_abs_err": err.max().item(),
                "max_err_over_unit": (err / unit).max().item(), "tolerance": tol}
    rules = {"y": rule(y, want_y, (1, 3), 1.0 if bf16 else 2e-5),
             "h_final": rule(hf, want_h, (2, 3), SSD_H_FINAL_BF16_TOL if bf16 else 2e-5)}
    ok = (all(r["max_err_over_unit"] <= r["tolerance"] for r in rules.values())
          and hf.shape == (b, h, p, n) and hf.dtype == torch.float32
          and bool(torch.isfinite(hf).all()) and bool(torch.isfinite(y).all()))
    same_y = torch.equal(y, y0)
    control = None
    if bf16 and timed:
        # the planted fault: the route's bf16 products with the hi operands
        # alone, whose h_final the rule must refuse
        _, hc = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk, operands="bf16",
                                     final_state=True)
        control = rule(hc, want_h, (2, 3), SSD_H_FINAL_BF16_TOL)
        control["refused"] = control["max_err_over_unit"] > SSD_H_FINAL_BF16_TOL
        del hc
    if not (ok and same_y and (control is None or control["refused"])):
        raise AssertionError(f"ssd_scan final state {shape}: {rules}, y bitwise the call "
                             f"without the final state: {same_y}, the hi-operand control: "
                             f"{control}")
    checked.add(ssd_sig(x, B, chunk, True))
    row = {"phase": "kernel", "kernel": "ssd_scan_final_state", "shape": shape, "route": route,
           "x": list(x.shape), "chunk": chunk, "dtype": dtype, "dt": "trained", **rules,
           "max_abs_err": max(r["max_abs_err"] for r in rules.values()),
           "y_bitwise_without_final_state": same_y, "h_final_hi_operands_only": control,
           "tolerance": (f"y: 1 bf16 ulp, h_final: {SSD_H_FINAL_BF16_TOL} of it, of each "
                         "(batch, head)'s max |plain|" if bf16
                         else "y and h_final: 2e-5 of each (batch, head)'s max |plain|"),
           "timed": timed}
    if timed:
        kernel_ms, device_ops, by_kernel = device_ms_per_call(kernel)
        without_ms, _, _ = device_ms_per_call(without)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        q = min(chunk, l)
        rows = [min(q, l - c0) for c0 in range(0, l, q)]
        pairs = sum(r * (r + 1) // 2 for r in rows)
        flops = b * h * (2 * pairs * (n + p) + 4 * l * p * n)
        esize = x.element_size()
        nbytes = (2 * b * l * h * p * esize + b * l * h * 4 + h * 4 + 2 * b * l * g * n * esize
                  + b * h * p * n * 4)
        peak = BF16_TENSOR_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        bound_ms, bound_by = bound(nbytes, flops, peak)
        row.update({"gflop": flops / 1e9, "mbytes": nbytes / 1e6, "kernel_ms": kernel_ms,
                    "device_ops_per_call": device_ops, "device_ms_by_kernel": by_kernel,
                    "without_final_state_ms": without_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bound_peak": peak,
                    "bound_share": bound_ms / kernel_ms, "library_ms": None,
                    "library": "none: no single PyTorch call computes the scan",
                    "timing": "kernel_ms, without_final_state_ms: device time a call, every "
                              "kernel summed (torch.profiler); plain_ms: CUDA events"})
    emit(row)
    del x, dt, A, B, C, y, hf, y0, want_y, want_h
    torch.cuda.empty_cache()
    return row


def kernel_phases(num_layers: int):
    """Each kernel against its plain version at every shape the paths give
    it and at a long-context shape: flash attention's tensor-core route at
    the static prefill (8 prompts of 128), the engine's whole-prompt
    prefill (1 of 128), a long prompt, a ragged long prompt, a window with
    an offset, head_dim 64, a window over a long prompt and rows without a
    key at head_dim 256, and its
    CUDA-core route in f32 at the static prefill's shape and with a window
    and an offset; slot-contiguous
    decode at the static loop's cache (8 x 160, kv_len 129..159) and the
    slot decode's (4 x 160, ragged with a 0), bf16 and int8; paged decode
    at the engine's arena and table; both decode layouts at long context,
    with 16 and 9 query heads per kv head, head_dim 256 and 64, on the
    tensor cores, and in f32 on the CUDA cores; quantize at each decoded token's rows
    and the pool's quantize of a prefill cache of 2 and of num_layers
    layers; the SSD scan at the Mamba-2 forward's 4 x 2048 tokens (views
    of the convolution's output, as apply_ssm passes them), a ragged
    length, a length under the chunk, two groups, a chunk of 100 rows and
    head_dim 32 with state 64 on the tensor cores, f32, a narrow f32 head
    and a narrow bf16 head on the CUDA cores, and the main and ragged
    shapes again with dt in a trained model's range, where the state
    carried across chunks shows; RMSNorm at the train step's rows, every
    serve path's, Mamba-2's, ragged, f32 and a narrow row (the row held in
    registers by 1, 2, 4 and 8 warps), two rows of the element path (a
    width of no whole 16-byte vectors, an unaligned start), and its
    autograd Function's gradient; then DDL's shapes (`ddl_kernel_phases`)
    and the dense configs' (`dense_kernel_phases`).
    The first row of each kernel is the main path's shape.
    -> ({kernel: [rows]}, the launch signatures checked)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    long_lens = [int(n) for n in rng.integers(2048, 4097, 16)]
    out, checked = {}, set()
    # kernel #1 by route: bf16 at head_dim 64/128/256 on the tensor cores
    # (the model's prefill), f32 on the CUDA cores
    out["flash_attention_fwd_wgmma"] = [
        attention_kernel_phase("static_prefill", REQUESTS, PROMPT, 11, checked),
        attention_kernel_phase("engine_prefill", 1, PROMPT, 12, checked),
        attention_kernel_phase("long_prompt", 2, 4096, 13, checked),
        attention_kernel_phase("long_prompt_ragged", 2, 3001, 51, checked),
        attention_kernel_phase("bf16_window_offset", 2, 100, 52, checked, skv=230, heads=10,
                               kv_heads=2, window=50, q_offset=130),
        attention_kernel_phase("d64", 1, 1500, 53, checked, heads=6, kv_heads=6, d=64),
        # a window that starts the kv walk past the first tiles, and tiles
        # wholly outside it for one warpgroup's rows only
        attention_kernel_phase("bf16_window_long", 1, 1000, 55, checked, heads=8, kv_heads=2,
                               window=200),
        attention_kernel_phase("rows_without_key", 1, 96, 15, checked, skv=80, heads=4,
                               kv_heads=4, d=256, q_offset=None),
    ]
    out["flash_attention_fwd_cuda_core"] = [
        attention_kernel_phase("f32_prefill", REQUESTS, PROMPT, 54, checked,
                               dtype="float32"),
        attention_kernel_phase("f32_window_offset", 2, 100, 14, checked, skv=230, heads=10,
                               kv_heads=2, d=64, dtype="float32", window=50, q_offset=130),
    ]
    # the static loop's decode steps see kv_len PROMPT + 1 .. MAX_LEN - 1
    static_lens = [(PROMPT + 1 + MAX_LEN - 1) // 2] * REQUESTS
    out["flash_decode_bf16"] = [
        decode_kernel_phase("static_decode", static_lens, False, 16, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("static_decode_first", [PROMPT + 1] * REQUESTS, False, 17, checked,
                            paged=False, smax=MAX_LEN),
        decode_kernel_phase("static_decode_last", [MAX_LEN - 1] * REQUESTS, False, 18, checked,
                            paged=False, smax=MAX_LEN),
        decode_kernel_phase("slot_decode", [160, 97, 0, 33], False, 19, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("long_context", long_lens, False, 20, checked, paged=False,
                            smax=4096),
    ]
    out["flash_decode_int8"] = [
        decode_kernel_phase("slot_decode", [160, 97, 0, 33], True, 21, checked, paged=False,
                            smax=MAX_LEN),
        decode_kernel_phase("long_context", long_lens, True, 22, checked, paged=False,
                            smax=4096),
    ]
    for int8 in (False, True):
        name = "flash_decode_paged_" + ("int8" if int8 else "bf16")
        out[name] = [decode_kernel_phase("engine", [160, 97, 0, 33], int8, 1, checked,
                                         pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE),
                     decode_kernel_phase("long_context", long_lens, int8, 2, checked)]
    # the tensor-core route at the group sizes and head widths of the repo's
    # other configs: G 16 at D 128 (qwen3-moe, 64/4 heads), G 9 (starcoder2-7b,
    # 36/4), G 16 at D 256 (recurrentgemma-9b, 16/1), D 64 with G 1 (6/6)
    for int8 in (False, True):
        kind = "int8" if int8 else "bf16"
        out[f"flash_decode_paged_{kind}"].append(decode_kernel_phase(
            "long_context_g16", long_lens, int8, 61 + int8, checked, heads=64, kv_heads=4))
        out[f"flash_decode_{kind}"].append(decode_kernel_phase(
            "long_context_g9", long_lens, int8, 63 + int8, checked, paged=False, smax=4096,
            heads=36, kv_heads=4))
    out["flash_decode_paged_bf16"].append(decode_kernel_phase(
        "long_context_g16_d256", long_lens, False, 65, checked, heads=16, kv_heads=1, d=256))
    out["flash_decode_bf16"].append(decode_kernel_phase(
        "d64_g1", [160, 97, 0, 33, 1500], False, 66, checked, paged=False, smax=1536,
        heads=6, kv_heads=6, d=64))
    # the CUDA-core route: f32 (its own path, `f32_decode_phase`)
    out["flash_decode_cuda_core"] = [
        decode_kernel_phase("f32_static_decode", [144] * REQUESTS, False, 67, checked,
                            paged=False, smax=MAX_LEN, dtype="float32"),
        decode_kernel_phase("f32_engine", [160, 97, 0, 33], False, 68, checked,
                            pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE, dtype="float32"),
    ]
    out["quantize_rows"] = [
        quantize_kernel_phase("kv_rows_32", SLOTS * K, 3, checked),
        quantize_kernel_phase("kv_rows_128", 16 * K, 4, checked),
        quantize_kernel_phase("prefill", 4 * MAX_LEN * K, 5, checked),
        quantize_kernel_phase("pool_ingest_2_layers", 2 * MAX_LEN * K, 6, checked),
        quantize_kernel_phase(f"pool_ingest_{num_layers}_layers",
                              num_layers * MAX_LEN * K, 7, checked),
        quantize_kernel_phase("nonfinite_rows", 64, 8, checked, timed=False, nonfinite=True),
        quantize_kernel_phase("nonfinite_rows_pod_hop", 64, 9, checked, cols=1024,
                              dtype="float32", timed=False, nonfinite=True),
        # the element path: a width of no whole 16-byte vectors, an unaligned start
        quantize_kernel_phase("element_37x100", 37, 77, checked, cols=100, timed=False,
                              nonfinite=True),
        quantize_kernel_phase("element_unaligned", 64, 78, checked, cols=1024,
                              dtype="float32", timed=False, offset=1)]
    # the decode step's fused int8 write: the engine's arena (4 slots) and
    # 16 slots, paged and slot-contiguous
    out["quantize_kv_write"] = [
        quantize_kv_write_kernel_phase("engine", SLOTS, True, 79, checked),
        quantize_kv_write_kernel_phase("slots_16", 16, True, 80, checked),
        quantize_kv_write_kernel_phase("contiguous", SLOTS, False, 81, checked),
        quantize_kv_write_kernel_phase("contiguous_16", 16, False, 82, checked)]
    from repro_torch.configs import get_config
    m = get_config(MAMBA)
    # the SSD scan by route: bf16 at head_dim and state multiples of 16 on
    # the tensor cores (the model's scan), f32 and other shapes on the CUDA cores
    tc = {"route": "tensor_core"}
    out["ssd_scan_tensor_core"] = [
        ssd_kernel_phase("mamba2_forward", SSD_BATCH, SSD_LEN, 23, checked, h=m.ssm_nheads,
                         p=m.ssm_headdim, g=m.ssm_ngroups, n=m.ssm_state, chunk=m.ssm_chunk,
                         **tc),
        ssd_kernel_phase("mamba2_forward_trained_dt", SSD_BATCH, SSD_LEN, 29, checked,
                         h=m.ssm_nheads, p=m.ssm_headdim, g=m.ssm_ngroups, n=m.ssm_state,
                         chunk=m.ssm_chunk, dt_kind="trained", **tc),
        ssd_kernel_phase("ragged_2000", 2, 2000, 24, checked, **tc),
        ssd_kernel_phase("ragged_2000_trained_dt", 2, 2000, 30, checked, dt_kind="trained",
                         **tc),
        ssd_kernel_phase("under_chunk_100", SSD_BATCH, 100, 25, checked, **tc),
        ssd_kernel_phase("groups_2", 2, SSD_LEN, 27, checked, g=2, **tc),
        # a chunk that is not a whole number of 64-row tiles, ragged at the end
        ssd_kernel_phase("chunk_100_ragged_trained_dt", 2, 1000, 70, checked, chunk=100,
                         dt_kind="trained", **tc),
        # head_dim 32 and state 64: half the warps of a state block idle
        ssd_kernel_phase("p32_n64_g2_trained_dt", 2, 700, 71, checked, h=8, p=32, g=2, n=64,
                         chunk=128, dt_kind="trained", **tc),
    ]
    # with its final state (the serve path's prefill): the main prompts timed,
    # every other prompt of the trace and run_static's batch for its shape
    out["ssd_scan_final_state_tensor_core"] = [
        ssd_final_state_kernel_phase("mamba2_prefill_1100", 1, 1100, 110, checked),
        ssd_final_state_kernel_phase("mamba2_prefill_700", 1, 700, 111, checked)] + [
        ssd_final_state_kernel_phase(f"mamba2_prefill_{n}", 1, n, 112 + i, checked, timed=False)
        for i, n in enumerate(sorted(set(MAMBA_PROMPTS) - {700, 1100}))] + [
        ssd_final_state_kernel_phase("mamba2_static_prefill", REQUESTS, MAMBA_STATIC_PROMPT,
                                     120, checked, timed=False)]
    out["ssd_scan_final_state_cuda_core"] = [
        ssd_final_state_kernel_phase("f32_1100", 1, 1100, 121, checked, dtype="float32"),
        ssd_final_state_kernel_phase("f32_700", 1, 700, 122, checked, dtype="float32"),
        ssd_final_state_kernel_phase("narrow_f32_300", 2, 300, 123, checked, dtype="float32",
                                     timed=False, h=8, p=40, g=2, n=48, chunk=64)]
    out["ssd_scan_cuda_core"] = [
        ssd_kernel_phase("f32", 2, SSD_LEN, 26, checked, dtype="float32", route="cuda_core"),
        ssd_kernel_phase("narrow_f32", 2, 300, 28, checked, h=8, p=40, g=2, n=48, chunk=64,
                         dtype="float32", route="cuda_core"),
        ssd_kernel_phase("narrow_bf16", 2, 300, 72, checked, h=8, p=40, g=2, n=48, chunk=64,
                         route="cuda_core"),
    ]
    d, md = get_config(ARCH).d_model, m.d_model
    out["rmsnorm"] = [
        rmsnorm_kernel_phase("train_step", TRAIN_BATCH * TRAIN_SEQ, d, 31, checked),
        rmsnorm_kernel_phase("static_prefill", REQUESTS * PROMPT, d, 32, checked),
        rmsnorm_kernel_phase("static_decode", REQUESTS, d, 33, checked),
        rmsnorm_kernel_phase("engine_prefill_chunk", CHUNK, d, 34, checked),
        rmsnorm_kernel_phase("engine_whole_prefill", PROMPT, d, 35, checked),
        rmsnorm_kernel_phase("engine_decode", SLOTS, d, 36, checked),
        rmsnorm_kernel_phase("ragged_300", 300, d, 37, checked),
        rmsnorm_kernel_phase("mamba2_forward", SSD_BATCH * SSD_LEN, md, 38, checked,
                             eps=m.norm_eps),
        rmsnorm_kernel_phase("mamba2_2x2048", 2 * SSD_LEN, md, 39, checked, eps=m.norm_eps),
        rmsnorm_kernel_phase("train_step_f32", TRAIN_BATCH * TRAIN_SEQ, d, 40, checked,
                             dtype="float32"),
        rmsnorm_kernel_phase("narrow_37x64", 37, 64, 41, checked),
        # the element path: a width that is no whole number of vectors, and an
        # unaligned start
        rmsnorm_kernel_phase("element_37x100", 37, 100, 73, checked),
        rmsnorm_kernel_phase("element_unaligned_300", 300, d, 74, checked, offset=1),
        # the row over four and eight warps: f32 at d 8192 and 16384
        rmsnorm_kernel_phase("f32_8192", 512, 8192, 75, checked, dtype="float32"),
        rmsnorm_kernel_phase("f32_16384", 256, 16384, 76, checked, dtype="float32"),
    ]
    # Mamba-2 serving's rows: each prompt's prefill, the decode step's slots,
    # run_static's prefill and decode
    out["rmsnorm"] += [
        rmsnorm_kernel_phase(f"mamba2_serve_{rows}", rows, md, 130 + i, checked,
                             eps=m.norm_eps, timed=False)
        for i, rows in enumerate(sorted(set(MAMBA_PROMPTS) | {
            MAMBA_SLOTS, REQUESTS, REQUESTS * MAMBA_STATIC_PROMPT}))]
    rmsnorm_grad_phase(TRAIN_BATCH * TRAIN_SEQ, d, 42)
    ddl_kernel_phases(out, checked)
    dense_kernel_phases(out, checked)
    moe_kernel_phases(out, checked)
    tp_kernel_phases(out, checked)
    return out, checked


def ddl_kernel_phases(out: dict, checked: set):
    """The quantizer, the pod sum and the dequantizer at DDL's compressed
    pod hop: a full 2**24-element slice of a gradient shard ([16384, 1024]
    f32), the ragged tail of the embedding's grad, the pod sum over 2 pods
    (the main path) and 4, the dequantizer (error feedback's) with a bf16
    output and at narrow shapes, each timed; then every other slice the two
    DDL phases give the kernels, and those of the error-feedback path,
    checked without timing. Adds the rows to `out`; the pod-hop slice is
    the first row of the quantizer's (its main path's shape)."""
    from repro_torch.configs import get_smoke_config
    cfg = _ddl_config(DDL_LAYERS, DDL_MESH).model
    d = cfg.d_model
    full = ddl_pod_hop_sizes(cfg, 1, overlap=True)
    tail = cfg.vocab_size * d % (1 << 24)
    out["dequantize_rows"] = [
        dequantize_kernel_phase("pod_hop_slice", 1 << 14, 1024, 43, checked),
        dequantize_kernel_phase("embedding_grad_tail", -(-tail // 1024), 1024, 44, checked),
        dequantize_kernel_phase("pod_hop_slice_bf16", 1 << 14, 1024, 45, checked,
                                out_dtype="bfloat16"),
        dequantize_kernel_phase("narrow_37x64", 37, 64, 46, checked),
        dequantize_kernel_phase("element_5x30", 5, 30, 83, checked, timed=False)]
    out["dequantize_sum_rows"] = [
        dequantize_sum_kernel_phase("pod_hop_slice", DDL_MESH[0], 1 << 14, 1 << 24, 84,
                                    checked),
        dequantize_sum_kernel_phase("pod_hop_slice_4_pods", 4, 1 << 14, 1 << 24, 85, checked),
        dequantize_sum_kernel_phase("embedding_grad_tail", DDL_MESH[0], -(-tail // 1024), tail,
                                    86, checked),
        dequantize_sum_kernel_phase("element_7x30", 2, 7, 200, 87, checked, cols=30,
                                    timed=False)]
    quantize_rows = out.setdefault("quantize_rows", [])
    quantize_rows.insert(0, quantize_kernel_phase("pod_hop_slice", 1 << 14, 47, checked,
                                                  cols=1024, dtype="float32"))
    quantize_rows.append(quantize_kernel_phase("embedding_grad_tail", -(-tail // 1024), 48,
                                               checked, cols=1024, dtype="float32"))
    smoke = get_smoke_config(ARCH)
    # RMSNorm at each DDL rank's rows
    out.setdefault("rmsnorm", []).extend([
        rmsnorm_kernel_phase("ddl_rank", TRAIN_BATCH * TRAIN_SEQ // DDL_MESH[0], d, 49, checked),
        rmsnorm_kernel_phase("ddl_smoke_rank", DDL_SMOKE_BATCH // 4 * DDL_SMOKE_SEQ,
                             smoke.d_model, 49, checked, eps=smoke.norm_eps),
        rmsnorm_kernel_phase("ddl_smoke_microbatch",
                             DDL_SMOKE_BATCH // 4 // DDL_SHARDED_MICROBATCHES * DDL_SMOKE_SEQ,
                             smoke.d_model, 49, checked, eps=smoke.norm_eps),
        # the ckpt phase's 2 smoke-width ranks
        rmsnorm_kernel_phase("ckpt_smoke_rank", DDL_SMOKE_BATCH // 2 * DDL_SMOKE_SEQ,
                             smoke.d_model, 49, checked, eps=smoke.norm_eps)])
    sizes = set(full) | {n for ov in (False, True)
                         for n in ddl_pod_hop_sizes(smoke, DDL_SMOKE_MESH[1], overlap=ov)}
    # ddl_sharded_smoke: zero1 and the microbatch accumulator
    sizes |= {n for zero1 in (False, True) for ov in (False, True)
              for n in ddl_sharded_pod_hop_sizes(smoke, DDL_SMOKE_MESH[1], zero1=zero1,
                                                 overlap=ov)}
    sizes |= set(ddl_ef_slices())
    # the ckpt phase's compressed 2x1x1 run at smoke width
    sizes |= set(ddl_pod_hop_sizes(smoke, 1, overlap=True))
    # lms_ddl (b) without the overlapped backward reduces whole stacked leaves
    sizes |= {n for L in LMS_DDL_DEPTHS
              for n in ddl_pod_hop_sizes(_ddl_config(L, DDL_MESH).model, 1, overlap=False)}
    for i, n in enumerate(sorted(sizes)):
        quantize_kernel_phase(f"pod_hop_{n}", -(-n // 1024), 50 + i, checked, cols=1024,
                              dtype="float32", timed=False)
        dequantize_kernel_phase(f"pod_hop_{n}", -(-n // 1024), 1024, 50 + i, checked,
                                timed=False)
        dequantize_sum_kernel_phase(f"pod_hop_{n}", DDL_MESH[0], -(-n // 1024), n, 50 + i,
                                    checked, timed=False)


def dense_kernel_phases(out: dict, checked: set):
    """The kernels at the dense_configs phase's shapes (`dense_configs_phase`):
    flash attention at olmo-1b's static prefill (MHA 16/16) and the
    engine's whole-prompt prefill of starcoder2-7b (36/4) and qwen2-72b
    (64/8), each timed (each config's main prefill); paged decode at the
    engine's arena for each config (model width timed: its main decode;
    int8 for olmo-1b, G = 1, and starcoder2-7b, G = 9, untimed) and
    olmo-1b's slot-contiguous static decode; the int8 pool's quantize of a
    prefill cache and the decode step's fused write at olmo-1b's and
    starcoder2-7b's kv heads; RMSNorm in bf16 at d_model 8192 (qwen2-72b)
    at the train step's, the whole-prompt prefill's and the decode step's
    rows and a prefill chunk's. Adds the rows to `out`, after each kernel's
    main-path row."""
    from repro_torch.configs import get_config
    olmo, star, big = (get_config(a) for a in (DENSE_OLMO, DENSE_STARCODER, DENSE_QWEN72))

    def heads(cfg):
        return {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
    out["flash_attention_fwd_wgmma"] += [
        attention_kernel_phase("olmo_1b_static_prefill", REQUESTS, PROMPT, 90, checked,
                               **heads(olmo)),
        attention_kernel_phase("starcoder2_7b_engine_prefill", 1, PROMPT, 91, checked,
                               **heads(star)),
        attention_kernel_phase("qwen2_72b_engine_prefill", 1, PROMPT, 92, checked,
                               **heads(big))]
    out["flash_decode_bf16"].append(decode_kernel_phase(
        "olmo_1b_static_decode", [(PROMPT + 1 + MAX_LEN - 1) // 2] * REQUESTS, False, 93,
        checked, paged=False, smax=MAX_LEN, timed=False, **heads(olmo)))
    for name, cfg, widths, seed in (("olmo_1b", olmo, (False, True), 94),
                                    ("starcoder2_7b", star, (False, True), 96),
                                    ("qwen2_72b", big, (False,), 98)):
        for int8 in widths:
            out["flash_decode_paged_" + ("int8" if int8 else "bf16")].append(
                decode_kernel_phase(f"{name}_engine", [160, 97, 0, 33], int8, seed + int8,
                                    checked, pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE,
                                    timed=not int8, **heads(cfg)))
    for name, cfg, layers, seed in (("olmo_1b", olmo, 2, 100),
                                    ("olmo_1b", olmo, olmo.num_layers, 101),
                                    ("starcoder2_7b", star, 2, 102)):
        out["quantize_rows"].append(quantize_kernel_phase(
            f"{name}_pool_ingest_{layers}_layers", layers * MAX_LEN * cfg.num_kv_heads, seed,
            checked, timed=False))
    for name, cfg, seed in (("olmo_1b", olmo, 103), ("starcoder2_7b", star, 104)):
        out["quantize_kv_write"].append(quantize_kv_write_kernel_phase(
            f"{name}_engine", SLOTS, True, seed, checked, kv_heads=cfg.num_kv_heads,
            timed=False))
    out["rmsnorm"] += [
        rmsnorm_kernel_phase(f"qwen2_72b_{name}", rows, big.d_model, seed, checked,
                             eps=big.norm_eps, timed=False)
        for name, rows, seed in (("train_step", TRAIN_BATCH * TRAIN_SEQ, 105),
                                 ("engine_whole_prefill", PROMPT, 106),
                                 ("engine_prefill_chunk", CHUNK, 108),
                                 ("engine_decode", SLOTS, 107))]


def moe_kernel_phases(out: dict, checked: set):
    """The kernels at the moe phase's shapes (`moe_phase`): flash attention
    at qwen3-moe-235b-a22b's static prefill (GQA 64/4), timed; its static
    decode; paged decode at the engine's arena for qwen3-moe (G = 16, bf16
    timed, int8) and grok-1-314b (48/8); the int8 pool's quantize of a
    2-layer prefill cache and the decode step's fused write at 4 kv heads;
    RMSNorm at d_model 4096 (the train step's, the static prefill's, a
    prefill chunk's and the decode step's rows) and 6144 (grok's chunk and
    decode rows). Adds the rows to `out`, after each kernel's main-path
    row."""
    from repro_torch.configs import get_config
    qw, gk = get_config(MOE), get_config(MOE_GROK)

    def heads(cfg):
        return {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
    smax = MOE_STATIC_PROMPT + MOE_STATIC_GEN
    out["flash_attention_fwd_wgmma"].append(attention_kernel_phase(
        "qwen3_moe_static_prefill", MOE_STATIC_REQUESTS, MOE_STATIC_PROMPT, 140, checked,
        **heads(qw)))
    out["flash_decode_bf16"].append(decode_kernel_phase(
        "qwen3_moe_static_decode", [(MOE_STATIC_PROMPT + smax) // 2] * MOE_STATIC_REQUESTS,
        False, 141, checked, paged=False, smax=smax, timed=False, **heads(qw)))
    for name, cfg, widths, seed in (("qwen3_moe", qw, (False, True), 142),
                                    ("grok_1", gk, (False,), 144)):
        for int8 in widths:
            out["flash_decode_paged_" + ("int8" if int8 else "bf16")].append(
                decode_kernel_phase(f"{name}_engine", [160, 97, 0, 33], int8, seed + int8,
                                    checked, pages=DEVICE_PAGES, max_pages=MAX_LEN // PAGE,
                                    timed=cfg is qw and not int8, **heads(cfg)))
    out["quantize_rows"].append(quantize_kernel_phase(
        f"qwen3_moe_pool_ingest_{MOE_CHECK_LAYERS}_layers",
        MOE_CHECK_LAYERS * MAX_LEN * qw.num_kv_heads, 146, checked, timed=False))
    out["quantize_kv_write"].append(quantize_kv_write_kernel_phase(
        "qwen3_moe_engine", SLOTS, True, 147, checked, kv_heads=qw.num_kv_heads, timed=False))
    out["rmsnorm"] += [
        rmsnorm_kernel_phase(f"{name}_{rows}", rows, cfg.d_model, seed, checked,
                             eps=cfg.norm_eps, timed=False)
        for name, cfg, rows, seed in (
            ("qwen3_moe_train", qw, TRAIN_BATCH * TRAIN_SEQ, 148),
            ("qwen3_moe_static_prefill", qw, MOE_STATIC_REQUESTS * MOE_STATIC_PROMPT, 149),
            ("qwen3_moe_chunk", qw, CHUNK, 150), ("qwen3_moe_decode", qw, SLOTS, 151),
            ("grok_1_chunk", gk, CHUNK, 152), ("grok_1_decode", gk, SLOTS, 153))]


def tp_kernel_phases(out: dict, checked: set):
    """The kernels at the tp phase's local shapes (`tp_phase`): flash
    attention at one rank's heads of qwen2.5-14b on TP_MESH (20 / 4 at
    head_dim 128) over the train step's TRAIN_BATCH x TRAIN_SEQ tokens,
    timed; RMSNorm at the replicated norms' rows (the whole d_model)."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    m = TP_MESH[-1]
    out["flash_attention_fwd_wgmma"].append(attention_kernel_phase(
        "tp_local_heads", TRAIN_BATCH, TRAIN_SEQ, 160, checked, d=cfg.head_dim,
        heads=cfg.num_heads // m, kv_heads=cfg.num_kv_heads // m))
    out["rmsnorm"].append(rmsnorm_kernel_phase(
        "tp_replicated_norm", TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, 161, checked,
        eps=cfg.norm_eps, timed=False))
    tp_serve_kernel_phases(out, checked)


# serving on a model axis: one rank's head counts (q / kv) of each config at
# its |model| (the tp_serve cases on TP_MESH, four cards (h1) and (h2))
TP_SERVE_HEADS = (("qwen2_5_14b", ARCH, 2), ("qwen3_moe", MOE, 2), ("qwen2_72b", "qwen2-72b", 4))


def tp_serve_kernel_phases(out: dict, checked: set):
    """The decode kernels at one rank's local decode shapes (TP_SERVE_HEADS):
    #2 paged bf16 and #2b int8 at the engine's arena, #3 at `run_static`'s
    slot-contiguous cache and #4b, the int8 step's fused write, each timed
    with its bound, at qwen2.5-14b on 2 ranks (20 / 4 heads, G 5),
    qwen3-moe on 2 (32 / 2, G 16) and qwen2-72b on 4 (16 / 2, G 8); and,
    untimed, the other shapes the tp_serve runs launch: the arena of the
    serve plan of TP_SERVE_BUDGET, the int8 pool's quantize at 4 kv heads,
    and kernel #1 at `run_static`'s prefill on 20 / 4 heads."""
    import dataclasses
    from repro_torch.configs import get_config
    smax = PROMPT + TP_SERVE_GEN
    for name, arch, m in TP_SERVE_HEADS:
        cfg = get_config(arch)
        hk = {"heads": cfg.num_heads // m, "kv_heads": cfg.num_kv_heads // m,
              "d": cfg.head_dim}
        for int8 in (False, True):
            out["flash_decode_paged_" + ("int8" if int8 else "bf16")].append(
                decode_kernel_phase(f"tp_serve_{name}_engine", [160, 97, 0, 33], int8,
                                    170 + int8, checked, pages=DEVICE_PAGES,
                                    max_pages=MAX_LEN // PAGE, **hk))
        out["flash_decode_bf16"].append(decode_kernel_phase(
            f"tp_serve_{name}_static_decode", [(PROMPT + smax) // 2] * REQUESTS, False, 172,
            checked, paged=False, smax=smax, **hk))
        out["quantize_kv_write"].append(quantize_kv_write_kernel_phase(
            f"tp_serve_{name}_engine", SLOTS, True, 173, checked, kv_heads=hk["kv_heads"]))
    cfg = get_config(ARCH)
    m = TP_MESH[-1]
    hk = {"heads": cfg.num_heads // m, "kv_heads": cfg.num_kv_heads // m, "d": cfg.head_dim}
    plan = _tp_serve_plan(dataclasses.replace(cfg, num_layers=TP_SERVE_LAYERS))
    out["flash_decode_paged_bf16"].append(decode_kernel_phase(
        "tp_serve_planned_engine", [80, 40, 0, 16], False, 174, checked,
        pages=plan.kv_paging.device_pages, max_pages=MAX_LEN // plan.kv_paging.page_size,
        timed=False, **hk))
    out["quantize_rows"].append(quantize_kernel_phase(
        f"tp_serve_pool_ingest_{TP_SERVE_LAYERS}_layers",
        TP_SERVE_LAYERS * MAX_LEN * hk["kv_heads"], 175, checked, timed=False))
    out["flash_attention_fwd_wgmma"].append(attention_kernel_phase(
        "tp_serve_static_prefill", REQUESTS, PROMPT, 176, checked, timed=False, **hk))


# the CUDA launchers whose counts a run of a path resets and reads
def _launchers():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.flash_attention_cuda,
            "flash_decode": fa_ops.flash_decode_cuda,
            "flash_decode_paged": fa_ops.flash_decode_paged_cuda,
            "quantize_rows": q_ops.quantize_cuda,
            "quantize_kv_write": q_ops.quantize_kv_write_cuda,
            "dequantize_rows": q_ops.dequantize_cuda,
            "dequantize_sum_rows": q_ops.dequantize_sum_rows_cuda,
            "rmsnorm": rms_ops.rmsnorm_cuda,
            "ssd_scan": ssd_ops.ssd_scan_cuda}


@contextlib.contextmanager
def launch_signatures():
    """Record the launch signature of every kernel call inside the block,
    with every launch count set to 0 on entry. The dispatchers the model
    calls through (`flash_attention`, `flash_decode`, `flash_decode_paged`,
    `quantize`, `quantize_kv_write`, `dequantize`, `dequantize_sum_rows`,
    `rmsnorm`, `ssd_scan`) are swapped for recording stand-ins
    that call them; the wrappers below them launch and count as always. ->
    (signatures seen, {kernel: calls recorded}, {kernel: launches}), the
    last filled on exit, for the caller to match the calls against. The
    flash-attention calls are also counted by the route `attention_route`
    expects (`flash_attention_wgmma`, `flash_attention_cuda_core`), and the
    decode calls by the route `decode_route` expects
    (`flash_decode_tensor_core`, `flash_decode_paged_cuda_core`, ...), the
    scan calls by the route `ssd_ops.ssd_route` names (`ssd_scan_tensor_core`,
    `ssd_scan_cuda_core`; those that return the final state by the route
    again, `ssd_scan_final_state_tensor_core`, ...) and the RMSNorm calls by
    the path `rmsnorm_path`
    names (`rmsnorm_register`, `rmsnorm_element`), and the int8 calls by
    the path `quantize_path`, `kv_write_path` or `dequantize_path` names
    (`quantize_rows_vector`, `dequantize_sum_rows_element`, ...), against
    the wrappers' per-route counts."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    launchers = _launchers()
    routes = {"flash_attention_wgmma": ("flash_attention", "wgmma_launches"),
              "flash_attention_cuda_core": ("flash_attention", "cuda_core_launches"),
              "rmsnorm_register": ("rmsnorm", "register_launches"),
              "rmsnorm_element": ("rmsnorm", "element_launches")}
    for name in ("flash_decode", "flash_decode_paged", "ssd_scan"):
        for route in ("tensor_core", "cuda_core"):
            routes[f"{name}_{route}"] = (name, f"{route}_launches")
    for route in ("tensor_core", "cuda_core"):
        routes[f"ssd_scan_final_state_{route}"] = ("ssd_scan", f"final_state_{route}_launches")
    for name in ("quantize_rows", "quantize_kv_write", "dequantize_rows", "dequantize_sum_rows"):
        for path in ("vector", "element"):
            routes[f"{name}_{path}"] = (name, f"{path}_launches")
    seen, calls, launches = set(), {name: 0 for name in [*launchers, *routes]}, {}
    attend, decode, paged, quantize, scan = (fa_ops.flash_attention, fa_ops.flash_decode,
                                             fa_ops.flash_decode_paged, q_ops.quantize,
                                             ssd_ops.ssd_scan)
    norm, dequantize = rms_ops.rmsnorm, q_ops.dequantize
    kv_write, dequantize_sum = q_ops.quantize_kv_write, q_ops.dequantize_sum_rows

    def attend_spy(q, k, v, *, causal=True, window=0, q_offset=None):
        seen.add(attention_sig(q, k, causal, window, q_offset))
        calls["flash_attention"] += 1
        calls["flash_attention_" + attention_route(q)] += 1
        return attend(q, k, v, causal=causal, window=window, q_offset=q_offset)

    def decode_spy(q, k_cache, v_cache, kv_len, **kw):
        q3 = q[:, 0] if q.dim() == 4 else q
        seen.add(decode_sig(q3, k_cache))
        calls["flash_decode"] += 1
        calls["flash_decode_" + decode_route(q3, k_cache)] += 1
        return decode(q, k_cache, v_cache, kv_len, **kw)

    def paged_spy(q, k_pages, v_pages, kv_len, page_table, **kw):
        q3 = q[:, 0] if q.dim() == 4 else q
        seen.add(decode_sig(q3, k_pages, page_table))
        calls["flash_decode_paged"] += 1
        calls["flash_decode_paged_" + decode_route(q3, k_pages)] += 1
        return paged(q, k_pages, v_pages, kv_len, page_table, **kw)

    def quantize_spy(x):
        seen.add(quantize_sig(x))
        calls["quantize_rows"] += 1
        calls["quantize_rows_" + quantize_path(x)] += 1
        return quantize(x)

    def kv_write_spy(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions, active):
        seen.add(quantize_kv_write_sig(k, k_codes, page_table))
        calls["quantize_kv_write"] += 1
        calls["quantize_kv_write_" + kv_write_path(k, v, k_codes, v_codes)] += 1
        return kv_write(k, v, k_codes, v_codes, k_scale, v_scale, page_table, positions, active)

    def dequantize_spy(q, scale, out_dtype=torch.float32):
        seen.add(dequantize_sig(q, out_dtype))
        calls["dequantize_rows"] += 1
        calls["dequantize_rows_" + dequantize_path(q)] += 1
        return dequantize(q, scale, out_dtype)

    def dequantize_sum_spy(q, scale, n):
        seen.add(dequantize_sum_sig(q, n))
        calls["dequantize_sum_rows"] += 1
        calls["dequantize_sum_rows_" + dequantize_path(q)] += 1
        return dequantize_sum(q, scale, n)

    def scan_spy(x, dt, A, B, C, *, chunk=256, final_state=False):
        seen.add(ssd_sig(x, B, chunk, final_state))
        route = ssd_ops.ssd_route(x, B, C, chunk)
        calls["ssd_scan"] += 1
        calls["ssd_scan_" + route] += 1
        if final_state:
            calls["ssd_scan_final_state_" + route] += 1
        return scan(x, dt, A, B, C, chunk=chunk, final_state=final_state)

    def norm_spy(x, scale, *, eps=1e-6):
        seen.add(rmsnorm_sig(x, eps))
        calls["rmsnorm"] += 1
        calls["rmsnorm_" + rmsnorm_path(x, scale)] += 1
        return norm(x, scale, eps=eps)
    (fa_ops.flash_attention, fa_ops.flash_decode, fa_ops.flash_decode_paged,
     q_ops.quantize, ssd_ops.ssd_scan) = (attend_spy, decode_spy, paged_spy, quantize_spy,
                                          scan_spy)
    rms_ops.rmsnorm, q_ops.dequantize = norm_spy, dequantize_spy
    q_ops.quantize_kv_write, q_ops.dequantize_sum_rows = kv_write_spy, dequantize_sum_spy
    for fn in launchers.values():
        fn.launches = 0
    for owner, attr in routes.values():
        setattr(launchers[owner], attr, 0)
    try:
        yield seen, calls, launches
    finally:
        (fa_ops.flash_attention, fa_ops.flash_decode, fa_ops.flash_decode_paged,
         q_ops.quantize, ssd_ops.ssd_scan) = attend, decode, paged, quantize, scan
        rms_ops.rmsnorm, q_ops.dequantize = norm, dequantize
        q_ops.quantize_kv_write, q_ops.dequantize_sum_rows = kv_write, dequantize_sum
        launches.update({name: fn.launches for name, fn in launchers.items()})
        launches.update({name: getattr(launchers[owner], attr)
                         for name, (owner, attr) in routes.items()})


def _serve(model, params, kv_dtype, rows=None, around_run=None, prefill_chunk=CHUNK,
           plan=None, injector=None):
    """Serve the trace once, inside `around_run` (a context manager) if
    given, under a serve plan and a fault injector if given (the page
    geometry stays the trace's); -> (engine, requests, finite logits?,
    seconds of eng.run)."""
    import numpy as np
    from repro_torch.serve import ServeEngine, synth_requests
    eng = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                      prefill_chunk=prefill_chunk, device_pages=DEVICE_PAGES,
                      host_pages=2 * SLOTS * (MAX_LEN // PAGE), params=params,
                      kv_dtype=kv_dtype, plan=plan, injector=injector, device="cuda")
    finite = [True]
    select = eng._select

    def checked(req, row):
        finite[0] &= bool(np.isfinite(row).all())
        if rows is not None:
            rows.setdefault(req.rid, []).append(row.copy())
        return select(req, row)
    eng._select = checked
    reqs = synth_requests(model.cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    with around_run if around_run is not None else contextlib.nullcontext():
        t0 = time.monotonic()
        eng.run(reqs)
        wall = time.monotonic() - t0
    del eng._select       # no reference cycle: the engine (and params) can go
    return eng, reqs, finite[0], wall


def _dense_rows(model, params, req):
    """One dense pass at model width (naive attention, plain RMSNorm, no
    kernel) over a request's prompt and its generated tokens but the last;
    row j scores generated token j. -> [GEN, V] f32 numpy."""
    import numpy as np
    import torch
    toks = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
    cache = model.init_cache(1, MAX_LEN, "cuda")
    with torch.no_grad(), plain_versions():
        logits, _ = model.prefill_chunk(
            params, cache, {"tokens": torch.from_numpy(toks[None]).cuda()}, 0, len(toks))
    return logits[0, len(req.prompt) - 1:].float().cpu().numpy()


def _wide(w) -> bool:
    """The dense row's top-2 margin exceeds 2**-4 of its max |logit|."""
    import numpy as np
    top2 = np.partition(w, -2)[-2:]
    return top2[1] - top2[0] > 2.0 ** -4 * float(np.abs(w).max())


def _deviation(reference, rows):
    """Logits rows of a run against a reference's, per request ({rid:
    rows}). -> {"worst": max over rows of max |diff| / max |reference|,
    "prefill_row": the same for the prefill rows alone, "argmax_mismatches":
    rows whose argmax differs where the reference's top-2 margin is wide}."""
    import numpy as np
    worst = first = 0.0
    mismatches = 0
    for rid, want in reference.items():
        got = np.stack(rows[rid])
        assert want.shape == got.shape, (want.shape, got.shape)
        for i, (g, w) in enumerate(zip(got, want)):
            dev = float(np.abs(g - w).max()) / float(np.abs(w).max())
            worst = max(worst, dev)
            if i == 0:
                first = max(first, dev)
            if _wide(w) and int(np.argmax(g)) != int(np.argmax(w)):
                mismatches += 1
    return {"worst": worst, "prefill_row": first, "argmax_mismatches": mismatches}


def _rmsnorm_on(cfg) -> int:
    """1 where the config's norms are RMSNorm (the kernel's launches), 0 for
    LayerNorm with or without params (plain torch: no kernel)."""
    return int(cfg.norm_type == "rmsnorm")


def engine_phase(model, params, kv_dtype, line, checked, dense_tol=None,
                 prefill_chunk=CHUNK):
    """Serve the trace with counts reset just before and read just after;
    check the run, that every launch had a signature the kernel phases
    held against the plain version, and the logits of the first and last
    request against the dense pass (argmax always; the deviation too when
    dense_tol is given). prefill_chunk=0 prefills whole prompts, through
    the flash-attention kernel when the model's attn_impl is "pallas"."""
    import torch
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    with launch_signatures() as (seen, calls, launches):
        eng, reqs, finite, wall = _serve(model, params, kv_dtype, rows,
                                         prefill_chunk=prefill_chunk)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = eng.metrics()
    cfg = model.cfg
    layers = cfg.num_layers
    kernel_prefill = prefill_chunk == 0 and model.attn_impl == "pallas"
    bad = [(r.rid, r.status, len(r.tokens)) for r in reqs
           if r.status != "ok" or len(r.tokens) != GEN]
    dense = _deviation({r.rid: _dense_rows(model, params, r) for r in (reqs[0], reqs[-1])},
                       rows)
    unchecked = sorted(seen - checked)
    # every model call (each prefill chunk or whole prompt, each tick)
    # normalises 2 x layers + 1 times
    prefill_calls = len(reqs) * (-(-PROMPT // prefill_chunk) if prefill_chunk else 1)
    norms = (2 * layers + 1) * (int(m["ticks"]) + prefill_calls) * _rmsnorm_on(cfg)
    checks = {
        "all_ok_32_tokens": not bad,
        "spilled": m["pool_spilled_pages"] > 0,
        "returned": m["pool_fetched_pages"] + m["pool_prefetched_pages"] > 0,
        "decode_launches_eq_layers_x_ticks":
            launches["flash_decode_paged"] == layers * int(m["ticks"]),
        # int8: the decode step's fused write once a layer-tick, the row
        # quantizer only at the pool's boundary (k and v of each prefill)
        "quantize_launches": (launches["quantize_kv_write"] == layers * int(m["ticks"])
                              and launches["quantize_rows"] == 2 * len(reqs))
                             if kv_dtype == "int8"
                             else launches["quantize_rows"] == launches["quantize_kv_write"] == 0,
        "quantize_took_vector": launches["quantize_rows_vector"] == launches["quantize_rows"]
                                and launches["quantize_kv_write_vector"]
                                == launches["quantize_kv_write"],
        "attention_launches": launches["flash_attention"]
            == (layers * len(reqs) if kernel_prefill else 0),
        "attention_took_wgmma": launches["flash_attention_wgmma"]
            == launches["flash_attention"],
        "decode_took_tensor_core":
            launches["flash_decode_paged_tensor_core"] == launches["flash_decode_paged"],
        "no_contiguous_decode": launches["flash_decode"] == 0,
        "rmsnorm_launches": launches["rmsnorm"] == norms,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": finite,
        "dense_argmax": dense["argmax_mismatches"] == 0,
    }
    if dense_tol is not None:
        checks["dense_within_tol"] = dense["worst"] <= dense_tol
    row = {"phase": "engine", "kv_dtype": kv_dtype, "arch": cfg.name,
           "layers": layers, "d_model": cfg.d_model, "requests": len(reqs),
           "prompt": PROMPT, "gen": GEN, "slots": SLOTS, "page_size": PAGE,
           "device_pages": DEVICE_PAGES, "prefill_chunk": prefill_chunk,
           "attn_impl": model.attn_impl, "card": line,
           "decode_tok_s": m["decode_tok_s"], "ttft_mean_s": m.get("ttft_mean_s"),
           "ttft_p95_s": m.get("ttft_p95_s"), "tpot_p50_s": m.get("tpot_p50_s"),
           "tpot_p95_s": m.get("tpot_p95_s"), "ticks": m["ticks"],
           "mean_concurrency": m["mean_concurrency"], "run_s": wall,
           "max_memory_allocated_gb": peak_gb,
           "pool_spilled_pages": m["pool_spilled_pages"],
           "pool_fetched_pages": m["pool_fetched_pages"],
           "pool_prefetched_pages": m["pool_prefetched_pages"],
           "decode_launches": launches["flash_decode_paged"],
           "decode_tensor_core_launches": launches["flash_decode_paged_tensor_core"],
           "quantize_launches": launches["quantize_rows"],
           "quantize_kv_write_launches": launches["quantize_kv_write"],
           "attention_launches": launches["flash_attention"],
           "attention_wgmma_launches": launches["flash_attention_wgmma"],
           "rmsnorm_launches": launches["rmsnorm"],
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "dense": dense, "dense_tol": dense_tol, "checks": checks, "bad": bad}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"engine {cfg.name} {kv_dtype} ({layers} layers, prefill_chunk "
                             f"{prefill_chunk}): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row, {r.rid: list(r.tokens) for r in reqs}


@contextlib.contextmanager
def plain_versions():
    """Swap the attention and RMSNorm dispatchers the model calls for their
    plain versions, which then run on the same (CUDA) tensors, RMSNorm
    under ordinary autograd."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         flash_decode_ref)
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    attend, decode, norm = fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm

    def attend_plain(q, k, v, *, causal=True, window=0, q_offset=None):
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window,
                                   q_offset=q_offset).transpose(1, 2)

    def decode_plain(q, k_cache, v_cache, kv_len, **kw):
        return flash_decode_ref(q[:, 0], k_cache, v_cache, kv_len, **kw)[:, None]
    fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm = (attend_plain,
                                                                    decode_plain, rmsnorm_ref)
    try:
        yield
    finally:
        fa_ops.flash_attention, fa_ops.flash_decode, rms_ops.rmsnorm = attend, decode, norm


def _static_plain_steps(model, params, reqs, toks):
    """The static loop's steps with its kernels swapped for their plain
    versions (the same GEMMs at the same shapes), teacher-forced with the
    kernel run's tokens. -> [GEN, N, V] f32 numpy."""
    import torch
    from repro_torch.serve import static_batch_from_requests
    forced = torch.from_numpy(toks).cuda()
    with plain_versions():
        logits, cache = model.prefill(params, static_batch_from_requests(model.cfg, reqs, "cuda"),
                                      cache_len=MAX_LEN)
        steps = [logits]
        for i in range(GEN - 1):
            logits, cache = model.decode_step(params, cache, {"tokens": forced[:, i:i + 1]},
                                              PROMPT + i)
            steps.append(logits)
    return torch.stack(steps).float().cpu().numpy()


def static_phase(model, params, line, checked, engine_tokens, dense_tol=None):
    """`run_static` on the engine's trace (8 prompts of 128, 32 greedy
    tokens): the flash-attention prefill of the whole batch, then 31
    lockstep decode steps through the slot-contiguous flash-decode kernel,
    with counts reset just before and read just after.

    Every request's logits are held against the same loop with its kernels
    swapped for their plain versions, teacher-forced with its tokens (the
    same GEMMs at the same shapes, so only the kernels differ): no argmax
    flip where that run's top-2 margin is wide. Against the dense pass
    (other GEMM shapes, naive attention) and the engine's greedy tokens —
    which may part only at a step whose dense margin is narrow — they are
    held when dense_tol is given (2 layers, with the deviations within it)
    and reported at full depth, where bf16 GEMMs of other shapes alone move
    the logits by more than the margin rule allows."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import run_static
    from repro_torch.serve import synth_requests
    cfg = model.cfg
    layers = cfg.num_layers
    reqs = synth_requests(cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    recorded = []          # each step's logits, kept on the card until the end
    prefill, decode_step = model.prefill, model.decode_step

    def prefill_rec(*args, **kw):
        logits, cache = prefill(*args, **kw)
        recorded.append(logits)
        return logits, cache

    def decode_rec(*args, **kw):
        logits, cache = decode_step(*args, **kw)
        recorded.append(logits)
        return logits, cache
    model.prefill, model.decode_step = prefill_rec, decode_rec
    try:
        with launch_signatures() as (seen, calls, launches):
            _, toks, t = run_static(model, reqs, PROMPT, GEN, params=params, device="cuda")
    finally:
        del model.prefill, model.decode_step
    steps = torch.stack(recorded).float().cpu().numpy()        # [GEN, N, V]
    del recorded
    rows = {r.rid: list(steps[:, i]) for i, r in enumerate(reqs)}
    plain_steps = _static_plain_steps(model, params, reqs, toks)
    plain_rows = {r.rid: plain_steps[:, i] for i, r in enumerate(reqs)}
    plain = _deviation(plain_rows, rows)
    for i, r in enumerate(reqs):
        r.tokens = [int(x) for x in toks[i]]
    dense_rows = {r.rid: _dense_rows(model, params, r) for r in reqs}
    dense = _deviation(dense_rows, rows)
    plain_dense = _deviation(dense_rows, {rid: list(x) for rid, x in plain_rows.items()})
    parted = []    # (rid, first step where static and engine differ, its dense margin / max)
    for r in reqs:
        diff = [j for j, (a, b) in enumerate(zip(r.tokens, engine_tokens[r.rid])) if a != b]
        if diff:
            w = dense_rows[r.rid][diff[0]]
            top2 = np.partition(w, -2)[-2:]
            parted.append((r.rid, diff[0], float((top2[1] - top2[0]) / np.abs(w).max())))
    unchecked = sorted(seen - checked)
    checks = {
        "tokens_shape": toks.shape == (REQUESTS, GEN),
        "attention_launches_eq_layers": launches["flash_attention"] == layers,
        "attention_took_wgmma": launches["flash_attention_wgmma"] == layers,
        "decode_launches_eq_layers_x_steps": launches["flash_decode"] == layers * (GEN - 1),
        "decode_took_tensor_core":
            launches["flash_decode_tensor_core"] == launches["flash_decode"],
        "no_paged_or_quantize_launches":
            launches["flash_decode_paged"] == 0 and launches["quantize_rows"] == 0
            and launches["quantize_kv_write"] == 0,
        "rmsnorm_launches_eq_norms_x_steps":
            launches["rmsnorm"] == (2 * layers + 1) * GEN * _rmsnorm_on(cfg),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": bool(np.isfinite(steps).all()),
        "plain_argmax": plain["argmax_mismatches"] == 0,
    }
    if dense_tol is not None:
        checks["plain_within_tol"] = plain["worst"] <= dense_tol
        checks["dense_within_tol"] = dense["worst"] <= dense_tol
        checks["dense_argmax"] = dense["argmax_mismatches"] == 0
        checks["engine_parity"] = all(m <= 2.0 ** -4 for _, _, m in parted)
    row = {"phase": "static", "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
           "attn_impl": model.attn_impl, "requests": REQUESTS, "prompt": PROMPT, "gen": GEN,
           "card": line, "prefill_ms": t["prefill_s"] * 1e3, "decode_s": t["decode_s"],
           "decode_tok_s": t["decode_tok_s"], "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "plain": plain, "dense": dense, "plain_vs_dense": plain_dense,
           "dense_tol": dense_tol,
           "engine_parity": {"requests_identical": REQUESTS - len(parted),
                             "parted_at_margin": parted},
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"static {cfg.name} ({layers} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def prefill_route_ab_phase(model, params, line):
    """What kernel #1's redesign moves end to end: the static loop's
    prefill step (`build_prefill_step`, as `run_static` builds it: 8
    prompts of 128 into the decode-capacity cache) on the same weights in
    one process, with the prefill attention on its tensor-core route and
    with the CUDA-core kernel (flash_attention_fwd.cu, which takes bf16 at
    head_dim 128 too) called in its place, in turns (tensor cores, CUDA
    cores, CUDA cores, tensor cores), 3 warm prefills a turn, each timed
    on the host clock to its synchronize. The run_static row's prefill_ms
    is one cold call; these are warm. Launches here are not counted."""
    import numpy as np
    import torch
    from repro_torch.config.base import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.serve import static_batch_from_requests, synth_requests
    from repro_torch.train.steps import StepSpec, build_prefill_step
    reqs = synth_requests(model.cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    batch = static_batch_from_requests(model.cfg, reqs, "cuda")
    prefill_fn, _ = build_prefill_step(model, ShapeConfig("serve_prefill", "prefill", PROMPT,
                                                          REQUESTS), StepSpec(cache_len=MAX_LEN))
    attend = fa_ops.flash_attention

    def cuda_core(q, k, v, *, causal=True, window=0, q_offset=None):
        if q_offset is None:
            q_offset = k.shape[1] - q.shape[1] if causal else 0
        out = torch.empty_like(q)
        _build.extension().flash_attention(q, k, v, out, bool(causal), int(window),
                                           int(q_offset), 1.0 / math.sqrt(q.shape[-1]))
        return out
    times = {"wgmma": [], "cuda_core": []}
    prefill_fn(params, batch)                   # warm: allocator, cuBLAS
    for route in ("wgmma", "cuda_core", "cuda_core", "wgmma"):
        fa_ops.flash_attention = attend if route == "wgmma" else cuda_core
        try:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill_fn(params, batch)
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
        finally:
            fa_ops.flash_attention = attend
    med = {r: float(np.median(t)) for r, t in times.items()}
    row = {"phase": "prefill_route_ab", "arch": ARCH, "layers": model.cfg.num_layers,
           "requests": REQUESTS, "prompt": PROMPT, "card": line, "prefill_ms": times,
           "median_ms": med, "wgmma_minus_cuda_core_ms": med["wgmma"] - med["cuda_core"]}
    emit(row)
    return row


def _shapes(tree):
    """Sorted leaf shapes of a nested dict (of tensors or ParamDefs)."""
    if isinstance(tree, dict):
        return sorted(x for sub in tree.values() for x in _shapes(sub))
    return [tuple(tree.shape)]


def slot_decode_phase(model, params, line, checked):
    """The slot decode step without a page arena (slot-contiguous caches,
    the flash_decode kernel) against the paged step (flash_decode_paged)
    on the same params, cache contents, positions and tokens, with model-
    width then int8 KV: 4 steps of 4 slots (one inactive), counts reset
    just before and read just after; the logits of the active slots within
    2**-5 of each row's max |logit|. -> {kv_dtype: the run's launches}."""
    import numpy as np
    import torch
    from repro_torch.config.base import ShapeConfig
    from repro_torch.models import kvquant
    from repro_torch.models.paging import PageArena
    from repro_torch.train.steps import StepSpec, build_slot_decode_step
    cfg = model.cfg
    layers = cfg.num_layers
    steps = 4
    shape = ShapeConfig("slot_decode", "decode", MAX_LEN, SLOTS)
    max_pages = MAX_LEN // PAGE
    arena = PageArena(page_size=PAGE, device_pages=DEVICE_PAGES, slots=SLOTS,
                      max_pages=max_pages)
    start = np.array([120, 97, 0, 33], np.int32)
    active = np.array([True, True, False, True])
    rng = np.random.default_rng(SEED + 3)
    # a scrambled table mapping every page the steps reach; the rest null
    table = np.full((SLOTS, max_pages), DEVICE_PAGES, np.int32)
    perm = rng.permutation(DEVICE_PAGES)
    nxt = 0
    for b in np.flatnonzero(active):
        need = -(-(int(start[b]) + steps) // PAGE)
        table[b, :need] = perm[nxt:nxt + need]
        nxt += need
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    content = {key: torch.randn((layers, SLOTS, MAX_LEN, K, D), generator=gen,
                                device="cuda").bfloat16() for key in ("k", "v")}
    toks = rng.integers(0, cfg.vocab_size, (steps, SLOTS, 1))
    active_t = torch.from_numpy(active).cuda()
    out = {}
    for kv_dtype in ("model", "int8"):
        layer = (kvquant.quantize_cache_tree(content) if kv_dtype == "int8"
                 else dict(content))
        contiguous = {"stack0": {"attn_0": {key: x.clone() for key, x in layer.items()}}}
        paged_layer = {}
        for key, x in layer.items():      # [L, SLOTS, MAX_LEN, ...] -> arena rows
            a = torch.zeros((layers, DEVICE_PAGES + 1, PAGE) + tuple(x.shape[3:]),
                            dtype=x.dtype, device="cuda")
            for b, j in zip(*np.nonzero(table != DEVICE_PAGES)):
                a[:, table[b, j]] = x[:, b, j * PAGE:(j + 1) * PAGE]
            paged_layer[key] = a
        paged = {"stack0": {"attn_0": paged_layer},
                 "page_table": torch.from_numpy(table).cuda()}
        runs = {}
        with launch_signatures() as (seen, calls, launches):
            for name, cache, spec in (("contiguous", contiguous, StepSpec(kv_dtype=kv_dtype)),
                                      ("paged", paged, StepSpec(kv_dtype=kv_dtype, arena=arena))):
                fn, defs = build_slot_decode_step(model, shape, spec)
                assert _shapes(defs) == _shapes(cache), (name, _shapes(defs), _shapes(cache))
                logits = []
                for i in range(steps):
                    pos = torch.from_numpy(np.where(active, start + i, 0).astype(np.int32)).cuda()
                    lg, _ = fn(params, cache, {"tokens": torch.from_numpy(toks[i]).cuda()},
                               pos, active_t)
                    logits.append(lg[active_t].float())
                runs[name] = torch.stack(logits)
        got, want = runs["contiguous"], runs["paged"]
        dev = ((got - want).abs().amax(dim=-1) / want.abs().amax(dim=-1)).max().item()
        unchecked = sorted(seen - checked)
        # int8: one fused k/v write a layer a step, in each of the two runs
        writes = 2 * layers * steps if kv_dtype == "int8" else 0
        checks = {
            "contiguous_launches_eq_layers_x_steps": launches["flash_decode"] == layers * steps,
            "paged_launches_eq_layers_x_steps": launches["flash_decode_paged"] == layers * steps,
            "decode_took_tensor_core":
                launches["flash_decode_tensor_core"] == layers * steps
                and launches["flash_decode_paged_tensor_core"] == layers * steps,
            "quantize_launches": launches["quantize_kv_write"] == writes
                                 and launches["quantize_rows"] == 0,
            "rmsnorm_launches": launches["rmsnorm"] == 2 * (2 * layers + 1) * steps,
            "every_launch_recorded": calls == launches,
            "every_launch_shape_checked": not unchecked,
            "finite_logits": bool(torch.isfinite(got).all()),
            "within_tol": dev <= 2.0 ** -5,
        }
        emit({"phase": "slot_decode", "kv_dtype": kv_dtype, "layers": layers, "slots": SLOTS,
              "max_len": MAX_LEN, "steps": steps, "card": line, "max_dev": dev,
              "bitwise_equal": bool(torch.equal(got, want)), "tolerance": 2.0 ** -5,
              "launches": launches, "launch_signatures": sorted(seen),
              "unchecked_signatures": unchecked, "checks": checks})
        if not all(checks.values()):
            raise AssertionError(f"slot decode {kv_dtype}: failed checks "
                                 f"{[k for k, v in checks.items() if not v]}")
        out[kv_dtype] = launches
    return out


def busy_seconds(intervals) -> float:
    """Length of the union of [start_ns, end_ns) intervals, in seconds:
    time in which at least one of them ran."""
    total = 0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e9


def device_summary(prof, wall: float):
    """What a torch.profiler run saw on the card. The device is busy while
    at least one kernel, copy or fill runs (the union of their intervals,
    so overlaps count once); its busy share is that over `wall`, the
    host's seconds for the run, which the profiler's own host overhead
    lengthens, so the share is a lower bound. The port's own kernels (the
    `__global__` functions of csrc/) are also summed by kernel. -> a dict
    for the phase row."""
    import re
    from torch.autograd import DeviceType
    from repro_torch.kernels import _build
    ours = {name for src in _build.CSRC.glob("*.cu") for name in re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", src.read_text())}
    intervals, by_name, runtime_launches = [], {}, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start, dur = ev.start_ns(), ev.duration_ns()
            intervals.append((start, start + dur))
            total, count = by_name.get(ev.name(), (0, 0))
            by_name[ev.name()] = (total + dur, count + 1)
        elif ev.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            runtime_launches += 1
    if not intervals:
        raise AssertionError("the profiler saw no device activity")
    busy = busy_seconds(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port = {}
    for n, (t, c) in by_name.items():
        short = re.sub(r"[<(].*", "", n.replace("(anonymous namespace)", ""))
        short = short.split("::")[-1].split()[-1]
        if short in ours:
            total, count = port.get(short, (0, 0))
            port[short] = (total + t, count + c)
    return {"run_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_summed_s": sum(e - s for s, e in intervals) / 1e9,
            "device_events": len(intervals), "runtime_launch_calls": runtime_launches,
            "top_device": [{"name": n[:120], "s": t / 1e9, "count": c} for n, (t, c) in top],
            "port_kernels": {n: {"s": t / 1e9, "count": c} for n, (t, c) in sorted(port.items())}}


def profile_phase(model, params, line):
    """The trace once more with each KV width, under torch.profiler: the
    device's busy share over the seconds of eng.run, its top kernels, and
    the runtime launch calls of the run and per layer-tick (every launch of
    the run over layers x ticks: what the host dispatches for one layer of
    one decode step, the prefill's spread over them). -> {kv_dtype: row}."""
    from torch.profiler import ProfilerActivity, profile
    rows = {}
    for kv_dtype in ("model", "int8"):
        t0 = time.monotonic()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        eng, _, _, wall = _serve(model, params, kv_dtype, around_run=prof)
        m = eng.metrics()
        summary = device_summary(prof, wall)
        layer_ticks = model.cfg.num_layers * int(m["ticks"])
        rows[kv_dtype] = {"phase": "profile", "kv_dtype": kv_dtype,
                          "layers": model.cfg.num_layers, "card": line,
                          "seconds": time.monotonic() - t0, **summary, "ticks": m["ticks"],
                          "layer_ticks": layer_ticks,
                          "launch_calls_per_layer_tick":
                              summary["runtime_launch_calls"] / layer_ticks,
                          "decode_tok_s": m["decode_tok_s"]}
        emit(rows[kv_dtype])
        del eng, prof
    return rows


def _serve_plan(cfg):
    """The serve plan of the trace at `cfg` under SERVE_PLAN_BUDGET."""
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.core.lms.planner import PlanRequest, plan
    return plan(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
                            mesh=MeshSpec((1, 1), ("data", "model")),
                            lms=LMSConfig(hbm_budget=SERVE_PLAN_BUDGET), serve=True,
                            slots=SLOTS, backlog_slots=2 * SLOTS, page_size=PAGE))


def _sweep_bytes(params, rows: int) -> int:
    """Params bytes one streamed sweep copies in: the stack, the final
    norm, the head, and `rows` f32 embedding rows."""
    from repro_torch.core.lms import offload as off
    embed = params["embed"]
    return (off.tree_bytes(params["decoder"]["stack0"]) + off.tree_bytes(params["final_norm"])
            + off.tree_bytes(embed["lm_head"]) + rows * embed["embedding"].shape[1] * 4)


def _pool_invariants(eng) -> bool:
    """The pool after a run: nothing held, every device page free, every
    spilled page come back."""
    pool, st = eng.pool, eng.pool.stats
    return (pool._table == {} and pool._resident == 0
            and len(pool._free_dev) == pool.device_pages
            and st["spilled_pages"] == st["fetched_pages"] + st["prefetched_pages"])


def _serve_plan_rank(rank: int, world: int, layers: int, box, checked):
    """`_serve_plan_runs` on the parent's weights, `box[0]` (shared with it
    on the card through CUDA IPC), which this process then lets go of
    (every reference dropped and collected before it returns), so the
    parent can free that memory. -> the rows' facts."""
    import gc
    import torch
    params = box.pop()
    try:
        return _serve_plan_runs(layers, params, checked)
    finally:
        del params
        gc.collect()
        torch.cuda.synchronize()


def _serve_plan_runs(layers: int, params, checked):
    """On the parent's weights of the first `layers` layers (no new
    init), in the process `_serve_plan_rank` runs: the serve
    plan of SERVE_PLAN_BUDGET (params on the host); the resident engine at
    model width and int8 (the references); the params copied into the
    plan's pinned arena (`train.steps.place_params`); the streamed engine
    at both widths, counts reset just before and read just after, its peak
    over the memory allocated before it; the preemption and exhaustion
    drills (resident, model width); `run_static` resident and under the
    plan through the prefill kernel, its peak taken as the engine's. ->
    the rows' facts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lms import offload as off
    from repro_torch.launch.serve import run_static
    from repro_torch.models.model import Model
    from repro_torch.runtime.inject import FaultEvent, FaultInjector, FaultPlan
    from repro_torch.serve import synth_requests
    from repro_torch.train.steps import place_params
    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
    model = Model(cfg, attn_impl="blockwise")
    plan = _serve_plan(cfg)
    out = {"plan": _plan_row(plan), "plan_calibrated": plan.calibrated}

    def served(params, kv, **kw):
        rows = {}
        eng, reqs, finite, wall = _serve(model, params, kv, rows, **kw)
        return eng, {r.rid: list(r.tokens) for r in reqs}, rows, finite, wall, reqs

    resident = {}
    for kv in ("model", "int8"):
        _, toks, rows, _, wall, _ = served(params, kv)
        resident[kv] = (toks, rows)
        out[f"resident_{kv}_run_s"] = wall
    t0 = time.monotonic()
    placed = place_params(params, plan, "cuda")
    torch.cuda.synchronize()
    out["place_s"] = time.monotonic() - t0
    out["pinned_bytes"] = off.pinned_bytes()
    sweep = {"chunk": _sweep_bytes(placed, CHUNK), "tick": _sweep_bytes(placed, SLOTS)}
    for kv in ("model", "int8"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = off.swap_counters()
        with launch_signatures() as (seen, calls, launches):
            eng, toks, rows, finite, wall, reqs = served(placed, kv, plan=plan)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
        m = eng.metrics()
        want_toks, want_rows = resident[kv]
        ticks = int(m["ticks"])
        chunks = len(reqs) * (-(-PROMPT // CHUNK))
        out[kv] = {
            "tokens_bitwise": toks == want_toks,
            "logits_bitwise": all(len(rows[rid]) == len(want_rows[rid]) and all(
                np.array_equal(a, b) for a, b in zip(rows[rid], want_rows[rid]))
                for rid in want_rows),
            "all_ok": all(r.status == "ok" and len(r.tokens) == GEN for r in reqs),
            "finite": finite, "run_s": wall, "decode_tok_s": m["decode_tok_s"],
            "ticks": ticks, "prefill_chunks": chunks,
            "swap_in_bytes_params": moved.get("lms.swap_in_bytes.params", 0),
            "swap_in_bytes_predicted": chunks * sweep["chunk"] + ticks * sweep["tick"],
            "peak_bytes": peak, "launches": launches,
            "every_launch_recorded": calls == launches,
            "unchecked": sorted(map(str, seen - checked)),
            "pool_invariants": _pool_invariants(eng),
            "spilled_pages": m["pool_spilled_pages"]}
        del eng
    drills = {"preempt": [("engine.tick", SERVE_PLAN_PREEMPT_TICK, "preempt", 1)],
              "exhaust": [("pool.reserve", 0, "exhaust", SERVE_PLAN_EXHAUSTIONS)]}
    for name, events in drills.items():
        inj = FaultInjector(FaultPlan([FaultEvent(site, at=at, kind=kind, times=times)
                                       for site, at, kind, times in events]))
        eng, toks, _, _, wall, reqs = served(params, "model", injector=inj)
        st = eng.pool.stats
        out[f"drill_{name}"] = {
            "tokens_bitwise": toks == resident["model"][0],
            "all_ok": all(r.status == "ok" for r in reqs),
            "fired": len(inj.fired), "preempted_requests": st["preempted_requests"],
            "preempted_pages": st["preempted_pages"],
            "injected_exhaustions": st["injected_exhaustions"],
            "pool_invariants": _pool_invariants(eng), "run_s": wall}
        del eng
    kernel_model = Model(cfg, attn_impl="pallas")
    reqs = synth_requests(cfg, REQUESTS, PROMPT, GEN, np.random.default_rng(SEED))
    _, want, _ = run_static(kernel_model, reqs, PROMPT, GEN, params=params, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = off.swap_counters()
    with launch_signatures() as (seen, calls, launches):
        _, got, t = run_static(kernel_model, reqs, PROMPT, GEN, params=placed, device="cuda",
                               plan=plan)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    rows_in = len(reqs) * PROMPT + (GEN - 1) * len(reqs)
    out["static"] = {
        "tokens_bitwise": bool(np.array_equal(got, want)), "timings": t,
        "swap_in_bytes_params": moved.get("lms.swap_in_bytes.params", 0),
        "swap_in_bytes_predicted": GEN * _sweep_bytes(placed, 0)
        + rows_in * cfg.d_model * 4,
        "peak_bytes": peak, "launches": launches, "every_launch_recorded": calls == launches,
        "unchecked": sorted(map(str, seen - checked))}
    del placed
    off.release_arenas()
    return out


def serve_plan_phase(short, short_params, line, checked):
    """Serving under a serve plan at qwen2.5-14b's full width, the first
    RERUN_LAYERS layers of the 48-layer engine's weights (the determinism
    rerun's model and params), in a spawned process that shares them on
    the card through CUDA IPC and lets go of them before it exits
    (`_serve_plan_rank`): the plan of
    LMSConfig(hbm_budget=SERVE_PLAN_BUDGET) puts the params on the host, so
    every prefill chunk and decode tick streams the stack a layer at a
    time and the rest (the batch's embedding rows, the final norm, the
    head) from pinned host memory. Held: the streamed engine's tokens and
    every logits row bitwise the resident engine's, model width and int8;
    the params' swap bytes exactly (chunks + ticks) sweeps of the stack,
    the final norm and the head plus the rows; the engine's peak at most
    SERVE_PLAN_PEAK_OVER_PLAN x the plan's; the paged decode (#2 / #2b),
    the int8 write (#4b) and RMSNorm (#6) launched as the trace implies,
    every launch at a checked shape; the preemption drill (a forced
    spill-and-requeue at tick SERVE_PLAN_PREEMPT_TICK) and the exhaustion
    drill (pool.reserve full SERVE_PLAN_EXHAUSTIONS times) bitwise the
    undisturbed run with the pool's invariants; `run_static` under the
    plan through the prefill kernel (#1) and the contiguous decode (#3)
    bitwise resident, its peak too at most SERVE_PLAN_PEAK_OVER_PLAN x the
    plan's. -> the row."""
    import torch
    t0 = time.monotonic()
    got = spawn_ranks("_serve_plan_rank", 1, RERUN_LAYERS, [short_params], checked,
                      timeout=SERVE_PLAN_TIMEOUT_S)[0]
    # the weights the process shared go back to the caching allocator
    # once it has let go of them (a shared block is held until then)
    torch.cuda.ipc_collect()
    cfg = short.cfg
    L = cfg.num_layers
    plan_peak = got["plan"]["peak_bytes"]
    checks = {"params_on_host": got["plan"]["residency"].get("params") == "host"}
    for kv in ("model", "int8"):
        r = got[kv]
        la = r["launches"]
        norms = (2 * L + 1) * (r["ticks"] + r["prefill_chunks"]) * _rmsnorm_on(cfg)
        checks.update({
            f"{kv}_tokens_bitwise": r["tokens_bitwise"],
            f"{kv}_logits_bitwise": r["logits_bitwise"],
            f"{kv}_all_ok": r["all_ok"] and r["finite"],
            f"{kv}_swap_bytes_exact": r["swap_in_bytes_params"] == r["swap_in_bytes_predicted"],
            f"{kv}_peak_within_plan": r["peak_bytes"] <= SERVE_PLAN_PEAK_OVER_PLAN * plan_peak,
            f"{kv}_paged_decode_launches": la["flash_decode_paged"] == L * r["ticks"]
            and la["flash_decode_paged_tensor_core"] == la["flash_decode_paged"],
            f"{kv}_kv_write_launches": (la["quantize_kv_write"] == L * r["ticks"])
            if kv == "int8" else la["quantize_kv_write"] == 0,
            f"{kv}_rmsnorm_launches": la["rmsnorm"] == norms,
            f"{kv}_launches_recorded": r["every_launch_recorded"] and not r["unchecked"],
            f"{kv}_pool_invariants": r["pool_invariants"] and r["spilled_pages"] > 0})
    for name in ("preempt", "exhaust"):
        d = got[f"drill_{name}"]
        checks[f"drill_{name}"] = (d["tokens_bitwise"] and d["all_ok"] and d["pool_invariants"]
                                   and d["fired"] > 0
                                   and (d["preempted_requests"] > 0 if name == "preempt"
                                        else d["injected_exhaustions"] > 0))
    st = got["static"]
    la = st["launches"]
    checks.update({
        "static_tokens_bitwise": st["tokens_bitwise"],
        "static_swap_bytes_exact": st["swap_in_bytes_params"] == st["swap_in_bytes_predicted"],
        "static_peak_within_plan": st["peak_bytes"] <= SERVE_PLAN_PEAK_OVER_PLAN * plan_peak,
        "static_prefill_launches": la["flash_attention"] == L
        and la["flash_attention_wgmma"] == L,
        "static_decode_launches": la["flash_decode"] == L * (GEN - 1)
        and la["flash_decode_tensor_core"] == la["flash_decode"],
        "static_rmsnorm_launches": la["rmsnorm"] == (2 * L + 1) * GEN * _rmsnorm_on(cfg),
        "static_launches_recorded": st["every_launch_recorded"] and not st["unchecked"]})
    row = {"phase": "serve_plan", "arch": ARCH, "layers": L, "card": line,
           "hbm_budget": SERVE_PLAN_BUDGET, "plan_peak_bytes": plan_peak,
           "peak_over_plan_limit": SERVE_PLAN_PEAK_OVER_PLAN, **got,
           "seconds": time.monotonic() - t0, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"serve_plan: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def compare_logits(got, want, margin: float):
    """Logits [..., V] of a run against a reference's, row by row on the
    card. -> {"worst": max over rows of max |diff| / max |want|,
    "argmax_flips": rows whose argmax differs, "argmax_flips_wide": those
    where want's top-2 margin exceeds `margin` of its max |logit|,
    "wide_rows": rows with such a margin, "rows"}."""
    import torch
    v = want.shape[-1]
    g_all, w_all = got.reshape(-1, v), want.reshape(-1, v)
    worst, flips, flips_wide, wide = 0.0, 0, 0, 0
    for i in range(0, w_all.shape[0], 1024):
        g, w = g_all[i:i + 1024].float(), w_all[i:i + 1024].float()
        top = w.abs().amax(dim=-1)
        worst = max(worst, ((g - w).abs().amax(dim=-1) / top.clamp_min(1e-30)).max().item())
        top2 = w.topk(2, dim=-1).values
        is_wide = (top2[:, 0] - top2[:, 1]) > margin * top
        flip = g.argmax(dim=-1) != w.argmax(dim=-1)
        flips += int(flip.sum().item())
        flips_wide += int((flip & is_wide).sum().item())
        wide += int(is_wide.sum().item())
    return {"worst": worst, "argmax_flips": flips, "argmax_flips_wide": flips_wide,
            "wide_rows": wide, "rows": int(w_all.shape[0]), "margin": margin}


def forward_phase(model, params, line, checked):
    """qwen2.5-14b `Model.forward` (2 layers, attn_impl="pallas") on the
    static prefill's batch, 8 prompts of 128, against `Model.prefill` on
    the same tokens: the same ops at the same shapes up to the head, so the
    hidden state entering the head is bitwise equal at the last position;
    the head's GEMM has another M (all rows against the last), so the
    logits are held within one bf16 ulp of each row's max |logit|. Counts
    reset just before, read just after: per layer 1 flash-attention and 2
    RMSNorm launches each, and the final norm."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_mod
    rng = np.random.default_rng(SEED + 4)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (REQUESTS, PROMPT))).cuda()
    heads = []
    head = model_mod.lm_logits

    def head_rec(cfg, p, x, *mesh):
        heads.append(x)
        return head(cfg, p, x, *mesh)
    model_mod.lm_logits = head_rec
    try:
        with torch.no_grad(), launch_signatures() as (seen, calls, launches):
            logits, aux = model.forward(params, {"tokens": toks})
            last, _ = model.prefill(params, {"tokens": toks})
    finally:
        model_mod.lm_logits = head
    layers = model.cfg.num_layers
    diff = (logits[:, -1].float() - last.float()).abs()
    ulps = (diff / bf16_row_ulp(last)).max().item()
    unchecked = sorted(seen - checked)
    checks = {
        "logits_shape": tuple(logits.shape) == (REQUESTS, PROMPT, model.cfg.vocab_size),
        "aux_zero": aux.item() == 0.0,
        "hidden_bitwise_equal": torch.equal(heads[0][:, -1], heads[1][:, 0]),
        "last_row_within_1_ulp": ulps <= 1.0,
        "same_argmax": torch.equal(logits[:, -1].argmax(-1), last.argmax(-1)),
        "attention_launches": launches["flash_attention"] == 2 * layers,
        "attention_took_wgmma": launches["flash_attention_wgmma"] == 2 * layers,
        "rmsnorm_launches": launches["rmsnorm"] == 2 * (2 * layers + 1),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite_logits": bool(torch.isfinite(logits).all()),
    }
    row = {"phase": "forward_vs_prefill", "arch": ARCH, "layers": layers,
           "attn_impl": model.attn_impl, "batch": REQUESTS, "seq": PROMPT, "card": line,
           "last_row_bitwise_equal": torch.equal(logits[:, -1], last),
           "last_row_max_ulps": ulps, "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"forward vs prefill: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def f32_attention_phase(line, checked):
    """Kernel #1's CUDA-core route on its own path. No configuration of the
    repo reaches that route from a model (all are bf16 at head_dim 64, 128
    or 256), so its path is the attention entry `flash_attention` on f32
    tensors at qwen2.5-14b's attention width and the static prefill's
    shape (q [8, 128, 40, 128], k and v [8, 128, 8, 128]), counts reset
    just before and read just after: one launch, on the CUDA cores, of a
    shape the kernel phases checked, and a finite f32 output."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q = torch.randn((REQUESTS, PROMPT, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((REQUESTS, PROMPT, K, D), generator=gen, device="cuda")
            for _ in range(2))
    with launch_signatures() as (seen, calls, launches):
        o = fa_ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    unchecked = sorted(seen - checked)
    checks = {
        "one_launch": launches["flash_attention"] == 1,
        "took_cuda_core": launches["flash_attention_cuda_core"] == 1,
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "f32_output": o.shape == q.shape and o.dtype == torch.float32,
        "finite": bool(torch.isfinite(o).all()),
    }
    row = {"phase": "f32_attention", "q": list(q.shape), "kv": list(k.shape), "card": line,
           "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 attention: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def f32_ssd_phase(line, checked):
    """The SSD scan's CUDA-core route on its own path. The repo's Mamba-2
    config (bf16, head_dim 64, state 128) reaches only the tensor-core
    route, so this path is the scan entry `ssd_scan` on f32 views of one
    buffer, as apply_ssm hands them over, at mamba2-1.3b's widths (64 heads
    of 64, state 128, chunk 256) on 2 x 2048 tokens, counts reset just
    before and read just after: one launch, on the CUDA cores, of a shape
    the kernel phases checked, and a finite f32 output; then the same
    entry with the final state (`final_state=True`, as the prefill asks
    for it) on a prompt of 1100 tokens: one launch on the CUDA cores,
    counted as the final-state route's, and a finite f32 state."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    x, dt, A, B, C = _ssd_inputs(2, SSD_LEN, 64, 64, 1, 128, torch.float32, 26, "softplus")
    with launch_signatures() as (seen, calls, launches):
        y = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=256)
        torch.cuda.synchronize()
    # the final state's route: the prefill's scan on f32 views of a prompt
    # of 1100 tokens
    xf, dtf, Af, Bf, Cf = _ssd_inputs(1, 1100, 64, 64, 1, 128, torch.float32, 121, "trained")
    with launch_signatures() as (seen_f, calls_f, launches_f):
        yf, hf = ssd_ops.ssd_scan(xf, dtf, Af, Bf, Cf, chunk=256, final_state=True)
        torch.cuda.synchronize()
    unchecked = sorted((seen | seen_f) - checked)
    checks = {
        "one_launch": launches["ssd_scan"] == 1,
        "took_cuda_core": launches["ssd_scan_cuda_core"] == 1,
        "every_launch_recorded": calls == launches and calls_f == launches_f,
        "every_launch_shape_checked": not unchecked,
        "f32_output": y.shape == x.shape and y.dtype == torch.float32,
        "finite": bool(torch.isfinite(y).all()) and bool(torch.isfinite(hf).all()),
        "final_state_one_launch": launches_f["ssd_scan"] == 1
        and launches_f["ssd_scan_final_state_cuda_core"] == 1,
        "final_state_f32": hf.shape == (1, 64, 64, 128) and hf.dtype == torch.float32,
    }
    row = {"phase": "f32_ssd", "x": list(x.shape), "card": line, "launches": launches,
           "final_state_x": list(xf.shape), "final_state_launches": launches_f,
           "launch_signatures": sorted(seen | seen_f), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"f32 ssd scan: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def _first_layers(params, n: int):
    """The model's params with the decoder cut to its first n layers
    (views into the stacked [L, ...] leaves)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "decoder": cut(params["decoder"])}


def _mamba_batch(cfg, seed):
    """SSD_BATCH sequences of SSD_LEN random tokens, next-token labels."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (SSD_BATCH, SSD_LEN + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).cuda(),
            "labels": torch.from_numpy(toks[:, 1:]).cuda()}


def _trained_dt_bias(params, seed):
    """Every dt_bias leaf drawn as Mamba-2 draws it, in place: softplus^-1
    of a per-head dt0 log-uniform on [1e-3, 1e-1]. (The JAX package and
    the port init it to 0, so dt = softplus(dt_raw) ~ 0.7 and exp(cum_last)
    over a chunk of 256 rows is ~0: the state carried across chunks would
    not show in the comparison.)"""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            _trained_dt_bias(leaf, seed + 1)
        elif key == "dt_bias":
            dt0 = _log_uniform(leaf.shape, 1e-3, 1e-1, gen)
            leaf.copy_(dt0 + torch.log(-torch.expm1(-dt0)))


def _timed_forward(model, params, batch):
    """-> (logits, aux, seconds to the last kernel's end)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, aux = model.forward(params, batch)
    torch.cuda.synchronize()
    return logits, aux, time.monotonic() - t0


def mamba_phases(line, checked):
    """mamba2-1.3b's forward and loss at full width (d_model 2048, 64 SSM
    heads of 64, state 128, chunk 256, vocab 50280) on 4 x 2048 tokens,
    random weights from a seed with dt_bias as Mamba-2 draws it (so the
    state carried across chunks counts), with counts reset just before and
    read just after each run.

    2 layers: Model(ssd_impl="pallas").forward and .loss against the same
    model with ssd_impl="ref" (the plain scan; every other op the same):
    logits within 2**-5 of each row's max |logit|, no argmax flip where
    the plain run's top-2 margin exceeds that, the loss within 1%.
    Each forward launches the RMSNorm kernel layers + 1 times.
    48 layers: the forward through the kernel, 48 launches exactly, against
    the same forward through the plain scan: no argmax flip where the
    margin exceeds 2**-4 of the row max (48 random bf16 layers carry
    one-ulp differences far: the value deviation is reported, not held),
    both losses reported; the forward timed three more times, and once
    under torch.profiler (busy share, top kernels).
    -> the 48-layer row."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.model import Model
    cfg = get_config(MAMBA)
    t0 = time.monotonic()
    params = Model(cfg).init(SEED + 5, "cuda")
    _trained_dt_bias(params, SEED + 6)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": MAMBA, "seconds": time.monotonic() - t0,
          "params": cfg.param_count(), "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    batch = _mamba_batch(cfg, SEED + 5)
    tokens = SSD_BATCH * SSD_LEN

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    params2 = _first_layers(params, 2)
    kernel2, plain2 = Model(cfg2, ssd_impl="pallas"), Model(cfg2, ssd_impl="ref")
    with torch.no_grad():
        with launch_signatures() as (seen, calls, launches):
            logits_k, aux_k = kernel2.forward(params2, batch)
            loss_k, parts_k = kernel2.loss(params2, batch)
        logits_p, _ = plain2.forward(params2, batch)
        loss_p, _ = plain2.loss(params2, batch)
    cmp2 = compare_logits(logits_k, logits_p, 2.0 ** -5)
    unchecked = sorted(seen - checked)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    checks = {
        "logits_shape": tuple(logits_k.shape) == (SSD_BATCH, SSD_LEN, cfg.vocab_size),
        "aux_zero": aux_k.item() == 0.0,
        "scan_launches_eq_layers_x_2": launches["ssd_scan"] == 2 * 2,
        "scan_on_tensor_cores": launches["ssd_scan_tensor_core"] == 2 * 2,
        "rmsnorm_launches_eq_2_x_(layers+1)": launches["rmsnorm"] == 2 * (2 + 1),
        "no_other_launches": all(n == 0 for k, n in launches.items()
                                 if k.split("_")[0] not in ("ssd", "rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite": bool(torch.isfinite(logits_k).all()) and bool(torch.isfinite(loss_k)),
        "within_2**-5": cmp2["worst"] <= 2.0 ** -5,
        "argmax_wide": cmp2["argmax_flips_wide"] == 0,
        "loss_within_1%": loss_rel <= 1e-2,
    }
    emit({"phase": "mamba2_reference", "arch": MAMBA, "layers": 2, "batch": SSD_BATCH,
          "seq": SSD_LEN, "card": line, "plain": cmp2, "loss_kernel": loss_k.item(),
          "loss_plain": loss_p.item(), "ce_kernel": parts_k["ce"].item(),
          "loss_rel_diff": loss_rel, "launches": launches,
          "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
          "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"mamba2 2 layers: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    del logits_k, logits_p, params2
    torch.cuda.empty_cache()

    layers = cfg.num_layers
    kernel_model, plain_model = Model(cfg, ssd_impl="pallas"), Model(cfg, ssd_impl="ref")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with launch_signatures() as (seen, calls, launches):
            logits_k, aux_k, kernel_s = _timed_forward(kernel_model, params, batch)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        loss_k = cross_entropy(logits_k, batch["labels"]).item()
        logits_p, _, plain_s = _timed_forward(plain_model, params, batch)
        loss_p = cross_entropy(logits_p, batch["labels"]).item()
        cmp48 = compare_logits(logits_k, logits_p, 2.0 ** -4)
        finite = bool(torch.isfinite(logits_k).all())
        del logits_k, logits_p
        again = [_timed_forward(kernel_model, params, batch)[2] for _ in range(3)]
        again_plain = _timed_forward(plain_model, params, batch)[2]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = _timed_forward(kernel_model, params, batch)[2]
    unchecked = sorted(seen - checked)
    checks = {
        "scan_launches_eq_layers": launches["ssd_scan"] == layers,
        "scan_on_tensor_cores": launches["ssd_scan_tensor_core"] == layers,
        "rmsnorm_launches_eq_layers+1": launches["rmsnorm"] == layers + 1,
        "no_other_launches": all(n == 0 for k, n in launches.items()
                                 if k.split("_")[0] not in ("ssd", "rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
        "finite": finite and loss_k == loss_k,
        "argmax_wide": cmp48["argmax_flips_wide"] == 0,
    }
    row = {"phase": "mamba2_forward", "arch": MAMBA, "layers": layers, "batch": SSD_BATCH,
           "seq": SSD_LEN, "card": line, "forward_s": kernel_s, "forward_s_again": again,
           "tokens_per_s": tokens / min(again), "plain_forward_s": [plain_s, again_plain],
           "max_memory_allocated_gb": peak_gb, "plain": cmp48, "loss_kernel": loss_k,
           "loss_plain": loss_p, "launches": launches, "launch_signatures": sorted(seen),
           "unchecked_signatures": unchecked, "checks": checks,
           "profile": device_summary(prof, profiled_s)}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"mamba2 48 layers: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    torch.cuda.empty_cache()
    return row, params


def _mamba2_requests(cfg, prompts=None):
    """The Mamba-2 serve trace: a request a prompt length (MAMBA_PROMPTS
    unless given), random prompts from the seed, MAMBA_GEN new tokens
    each."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(SEED + 7)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32),
                    max_new=MAMBA_GEN) for i, n in enumerate(prompts or MAMBA_PROMPTS)]


def _mamba2_serve(model, params, rows=None, plan=None, injector=None, setup=None):
    """Serve the Mamba-2 trace once on MAMBA_SLOTS slots, greedy, under a
    serve plan and a fault injector if given; setup(engine) runs before the
    trace. -> (engine, requests, finite logits?, seconds of eng.run)."""
    import numpy as np
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, slots=MAMBA_SLOTS, max_len=MAMBA_MAX_LEN, plan=plan,
                      params=params, injector=injector, device="cuda")
    finite = [True]
    select = eng._select

    def checked(req, row):
        finite[0] &= bool(np.isfinite(row).all())
        if rows is not None:
            rows.setdefault(req.rid, []).append(row.copy())
        return select(req, row)
    eng._select = checked
    if setup is not None:
        setup(eng)
    reqs = _mamba2_requests(model.cfg)
    t0 = time.monotonic()
    eng.run(reqs)
    wall = time.monotonic() - t0
    del eng._select
    return eng, reqs, finite[0], wall


def _mamba2_serve_plan(cfg):
    """The serve plan of the Mamba-2 trace under MAMBA_SERVE_BUDGET."""
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.core.lms.planner import PlanRequest, plan
    return plan(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", MAMBA_MAX_LEN,
                                                       MAMBA_SLOTS),
                            mesh=MeshSpec((1, 1), ("data", "model")),
                            lms=LMSConfig(hbm_budget=MAMBA_SERVE_BUDGET), serve=True,
                            slots=MAMBA_SLOTS, backlog_slots=2 * MAMBA_SLOTS, page_size=PAGE))


def _serve_launch_checks(launches, calls, unchecked, L, prefills, ticks):
    """The launches of a Mamba-2 serve run: the scan with its final state
    once a layer a prefill (on the tensor cores), never without it; RMSNorm
    L + 1 times a prefill and a tick; no other kernel."""
    return {"scan_final_state_launches": launches["ssd_scan"] == L * prefills
            and launches["ssd_scan_final_state_tensor_core"] == L * prefills
            and launches["ssd_scan_tensor_core"] == L * prefills,
            "rmsnorm_launches": launches["rmsnorm"] == (L + 1) * (prefills + ticks),
            "no_other_launches": all(n == 0 for k, n in launches.items()
                                     if k.split("_")[0] not in ("ssd", "rmsnorm")),
            "every_launch_recorded": calls == launches,
            "every_launch_shape_checked": not unchecked}


def _mamba2_serve_runs(params, checked):
    """mamba2_serve's runs, on the first MAMBA_SERVE_LAYERS layers of the
    parent's 48-layer weights (no new init), in the process `_mamba2_rank`
    runs. -> the row's facts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.lms import offload as off
    from repro_torch.launch.serve import run_static
    from repro_torch.models import rest
    from repro_torch.models.model import Model
    from repro_torch.runtime.inject import FaultEvent, FaultInjector, FaultPlan
    from repro_torch.train.steps import place_params
    cfg = dataclasses.replace(get_config(MAMBA), num_layers=MAMBA_SERVE_LAYERS)
    params = _first_layers(params, MAMBA_SERVE_LAYERS)
    L = cfg.num_layers
    out = {}

    # 2 layers: the engine's logits against Model.forward over each prompt
    # and its tokens (the kernel route; the forward outside the recording)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2, params2 = Model(cfg2, ssd_impl="pallas"), _first_layers(params, 2)
    rows2 = {}
    with launch_signatures() as (seen, calls, launches):
        eng, reqs, finite, wall = _mamba2_serve(model2, params2, rows2)
    ticks = int(eng.metrics()["ticks"])
    worst, flips, flips_wide, wide = 0.0, 0, 0, 0
    with torch.no_grad():
        for r in reqs:
            toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
            logits, _ = model2.forward(params2, {"tokens": torch.from_numpy(toks[None]).cuda()})
            want = logits[0, len(r.prompt) - 1:]
            got = torch.from_numpy(np.stack(rows2[r.rid])).cuda()
            cmp = compare_logits(got, want, 2.0 ** -5)
            worst = max(worst, cmp["worst"])
            flips += cmp["argmax_flips"]
            flips_wide += cmp["argmax_flips_wide"]
            wide += cmp["wide_rows"]
            del logits, want, got
    out["layers_2"] = {
        "run_s": wall, "ticks": ticks, "finite": finite,
        "all_ok": all(r.status == "ok" and len(r.tokens) == MAMBA_GEN for r in reqs),
        "worst_over_row_max": worst, "argmax_flips": flips, "argmax_flips_wide": flips_wide,
        "wide_rows": wide, "launches": launches,
        "checks": _serve_launch_checks(launches, calls, sorted(map(str, seen - checked)), 2,
                                       len(reqs), ticks)}
    del eng, params2
    torch.cuda.empty_cache()

    model = Model(cfg, ssd_impl="pallas")

    def pool_after(eng):
        pool = eng.pool
        return {"empty": pool._table == {},
                "host_slots_back": len(pool._free_host_slots) == pool._host[
                    ("stack0", "ssd_0", "h")].shape[0],
                "spilled_requests": pool.stats["spilled_requests"],
                "preempted_requests": pool.stats["preempted_requests"],
                "state_bytes": pool._state_bytes, "has_paged": pool.has_paged}

    def head_inputs(heads):
        """Record the hidden state entering the head at every prefill and
        tick of the next run (the model's `_logits` wrapped)."""
        orig = Model._logits

        def rec(self, params, x, stream, sink=None, mesh=None):
            heads.append(x.detach().cpu())
            return orig(self, params, x, stream, sink, mesh=mesh)
        return rec

    def served(p, rows, plan=None, injector=None, setup=None, record=True, heads=None):
        if heads is not None:
            model._logits = head_inputs(heads).__get__(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = off.swap_counters()
        ctx = launch_signatures() if record else contextlib.nullcontext((set(), {}, {}))
        with ctx as (seen, calls, launches):
            eng, reqs, finite, wall = _mamba2_serve(model, p, rows, plan=plan,
                                                    injector=injector, setup=setup)
        torch.cuda.synchronize()
        m = eng.metrics()
        facts = {"layers": L, "run_s": wall, "finite": finite, "peak_bytes":
                 torch.cuda.max_memory_allocated() - base,
                 "all_ok": all(r.status == "ok" and len(r.tokens) == MAMBA_GEN for r in reqs),
                 "ticks": int(m["ticks"]), "decode_tok_s": m["decode_tok_s"],
                 "ttft_mean_s": m.get("ttft_mean_s"), "tpot_p50_s": m.get("tpot_p50_s"),
                 "pool": pool_after(eng),
                 "swap_in_bytes_params": off.swap_counters().get("lms.swap_in_bytes.params", 0)
                 - before.get("lms.swap_in_bytes.params", 0)}
        if record:
            facts["launches"] = launches
            facts["checks"] = _serve_launch_checks(launches, calls,
                                                   sorted(map(str, seen - checked)), L,
                                                   len(reqs), facts["ticks"])
        model.__dict__.pop("_logits", None)
        return {r.rid: list(r.tokens) for r in reqs}, facts, reqs

    # MAMBA_SERVE_LAYERS layers resident, the references
    rows_res, heads_res = {}, []
    toks_res, out["resident"], reqs = served(params, rows_res, heads=heads_res)
    prompt_rows = [len(r.prompt) for r in reqs]
    # under the serve plan: the params copied into its pinned arena
    plan = _mamba2_serve_plan(cfg)
    out["plan"] = _plan_row(plan)
    t0 = time.monotonic()
    placed = place_params(params, plan, "cuda")
    torch.cuda.synchronize()
    out["place_s"] = time.monotonic() - t0
    rows_plan, heads_plan = {}, []
    toks_plan, out["planned"], _ = served(placed, rows_plan, plan=plan, heads=heads_plan)
    ticks = out["planned"]["ticks"]
    # the head larger than the plan's window comes in vocab slices of
    # whole blocks, the products the resident head takes a block at a time
    out["planned"].update({
        "head_in_vocab_slices": off.tree_bytes(placed["embed"]["lm_head"])
        > rest.window(cfg, plan.swap_schedule),
        "head_inputs_bitwise": len(heads_plan) == len(heads_res) and all(
            torch.equal(a, b) for a, b in zip(heads_plan, heads_res)),
        "tokens_bitwise": toks_plan == toks_res,
        "logits_bitwise": all(len(rows_plan[rid]) == len(rows_res[rid]) and all(
            np.array_equal(a, b) for a, b in zip(rows_plan[rid], rows_res[rid]))
            for rid in rows_res),
        "logits_max_abs_diff": max(float(np.abs(a - b).max()) for rid in rows_res
                                   for a, b in zip(rows_plan[rid], rows_res[rid])),
        "swap_in_bytes_predicted": sum(_sweep_bytes(placed, n) for n in prompt_rows)
        + ticks * _sweep_bytes(placed, MAMBA_SLOTS),
        "pinned_bytes": off.pinned_bytes()})
    del rows_plan

    # the preemption drill, resident: the preempted slot's state must reach
    # its host slot whole
    moved_whole = []

    def watch(eng):
        pool, orig = eng.pool, eng.pool.preempt

        def preempt(rid, length):
            slot = pool._table[rid].slot
            held = {k: pool._slot_state(k, slot).clone() for k in pool._state}
            done = orig(rid, length)
            if done:
                torch.cuda.synchronize()
                hslot = pool._table[rid].host_slot
                moved_whole.append(all(torch.equal(pool._host[k][hslot].cuda(), t)
                                       for k, t in held.items()))
            return done
        pool.preempt = preempt
    inj = FaultInjector(FaultPlan([FaultEvent("engine.tick", at=MAMBA_PREEMPT_TICK,
                                              kind="preempt")]))
    toks_pre, out["preempt"], _ = served(params, None, injector=inj, setup=watch,
                                         record=False)
    out["preempt"].update({"tokens_bitwise": toks_pre == toks_res, "fired": len(inj.fired),
                           "state_moved_whole": moved_whole})

    # run_static, resident and under the plan
    sreqs = _mamba2_requests(cfg, (MAMBA_STATIC_PROMPT,) * REQUESTS)
    _, want, t_res = run_static(model, sreqs, MAMBA_STATIC_PROMPT, MAMBA_STATIC_GEN,
                                params=params, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = off.swap_counters()
    with launch_signatures() as (seen, calls, launches):
        _, got, t = run_static(model, sreqs, MAMBA_STATIC_PROMPT, MAMBA_STATIC_GEN,
                               params=placed, device="cuda", plan=plan)
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0) for k, v in off.swap_counters().items()}
    n = len(sreqs)
    cache_bytes = n * out["resident"]["pool"]["state_bytes"]
    rows_in = n * MAMBA_STATIC_PROMPT + (MAMBA_STATIC_GEN - 1) * n
    # what the plan says of the cache: on the host, the prefill emits it
    # and each decode step streams it; on the card, it stays there, and the
    # plan's peak holds MAMBA_SLOTS requests' state where the static loop
    # holds n
    cache_on_host = plan.residency.get("kvcache") == "host"
    out["static"] = {
        "tokens_bitwise": bool(np.array_equal(got, want)), "timings": t, "resident": t_res,
        "peak_bytes": torch.cuda.max_memory_allocated() - base,
        "swap_in_bytes_params": moved.get("lms.swap_in_bytes.params", 0),
        "swap_in_bytes_predicted": MAMBA_STATIC_GEN * _sweep_bytes(placed, 0)
        + rows_in * cfg.d_model * 4,
        "swap_bytes_kvcache": [moved.get("lms.swap_out_bytes.kvcache", 0),
                               moved.get("lms.swap_in_bytes.kvcache", 0)],
        "swap_bytes_kvcache_predicted": [MAMBA_STATIC_GEN * cache_bytes,
                                         (MAMBA_STATIC_GEN - 1) * cache_bytes]
        if cache_on_host else [0, 0],
        "cache_on_host": cache_on_host,
        "unpriced_state_bytes": 0 if cache_on_host
        else (n - MAMBA_SLOTS) * out["resident"]["pool"]["state_bytes"],
        "launches": launches,
        "checks": {
            "scan_final_state_launches": launches["ssd_scan"] == L
            and launches["ssd_scan_final_state_tensor_core"] == L,
            "rmsnorm_launches": launches["rmsnorm"] == (L + 1) * MAMBA_STATIC_GEN,
            "no_other_launches": all(v == 0 for k, v in launches.items()
                                     if k.split("_")[0] not in ("ssd", "rmsnorm")),
            "every_launch_recorded": calls == launches,
            "every_launch_shape_checked": not (seen - checked)}}
    del placed
    off.release_arenas()
    return out


def _train_swap_count(cfg, state, plan, tokens: int) -> dict:
    """The `lms.swap_*` bytes a training step under `plan` moves, from the
    state's sizes: the stack in twice (the forward, and the backward's
    re-stream), the head, the final norm and the batch's embedding rows
    (f32) in once, every param out once (the optimizer sweep writes them
    back), mu, nu and the masters in and out once, and each activation
    class the policy offloads out and in once a layer (`resid`, the layer
    input, [tokens, d] bf16; `ssd_xz`, z, and `ssd_state`, y, [tokens,
    d_inner] bf16)."""
    from repro_torch.core.lms import offload as off
    p, o = state.params, state.opt
    L = cfg.num_layers
    stack = off.tree_bytes(p["decoder"]["stack0"])
    act = {"resid": tokens * cfg.d_model * 2, "ssd_xz": tokens * cfg.d_inner * 2,
           "ssd_state": tokens * cfg.d_inner * 2}
    offloaded = sum(b for name, b in act.items()
                    if plan.assignment.get(name) == "offload") * L
    optimizer = sum(off.tree_bytes(t) for t in (o.mu, o.nu, o.master))
    return {"lms.swap_in_bytes.params": 2 * stack + off.tree_bytes(p["embed"]["lm_head"])
            + off.tree_bytes(p["final_norm"]) + tokens * cfg.d_model * 4,
            "lms.swap_out_bytes.params": off.tree_bytes(p),
            "lms.swap_in_bytes.optimizer": optimizer, "lms.swap_out_bytes.optimizer": optimizer,
            "lms.swap_in_bytes.activations": offloaded,
            "lms.swap_out_bytes.activations": offloaded}


def _mamba2_lms_runs(checked):
    """mamba2_lms's runs: `Trainer.train` at MAMBA_LMS_LAYERS layers of
    mamba2-1.3b's full width, MAMBA_LMS_STEPS steps from one seed, under the plan
    of MAMBA_LMS_BUDGET and resident. -> the row's facts."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.tree import tree_leaves
    L, n = MAMBA_LMS_LAYERS, MAMBA_LMS_STEPS
    base = _train_config(L, arch=MAMBA, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=n)
    runs, leaves = {}, {}
    for name, lms in (("streamed", LMSConfig(hbm_budget=MAMBA_LMS_BUDGET)),
                      ("resident", LMSConfig(enabled=False))):
        # what this process holds before the run (the serve runs' leftovers)
        # is not the run's: its peak is taken above it
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        trainer, state, hist, facts = _lms_run(dataclasses.replace(base, lms=lms), n)
        plan = trainer.plan
        o = state.opt
        leaves[name] = [t for tree in (state.params, o.mu, o.nu, o.master)
                        for t in tree_leaves(tree)]
        launches = facts["launches"]
        count = (_train_swap_count(base.model, state, plan, TRAIN_BATCH * TRAIN_SEQ)
                 if name == "streamed" else None)
        swap = {k: v for k, v in facts["swap_per_step"].items() if "_bytes." in k and v}
        runs[name] = {
            "plan": _plan_row(plan), "loss": [r["loss"] for r in hist],
            "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
            "median_step_s_after_1": statistics.median(r["time_s"] for r in hist[1:]),
            "setup_s": facts["setup_s"], "allocated_before_bytes": before,
            "max_memory_allocated_bytes": facts["peak_bytes"] - before,
            "pinned_bytes": facts["pinned_bytes"], "swap_per_step": swap,
            "swap_per_step_count": count, "launches": launches,
            "checks": {"finite": all(math.isfinite(r["loss"]) for r in hist),
                       # ln1 and the final norm in the forward, ln1 again in
                       # each layer's recompute (its output is never kept)
                       "rmsnorm_launches": launches["rmsnorm"] == n * (2 * L + 1),
                       "no_other_launches": all(v == 0 for k, v in launches.items()
                                                if not k.startswith("rmsnorm")),
                       "every_launch_recorded": facts["calls"] == launches,
                       "every_launch_shape_checked": not (facts["seen"] - checked)}}
        del trainer, state, hist
        torch.cuda.empty_cache()
    s, r = runs["streamed"], runs["resident"]
    same = [torch.equal(a.to(b.device), b) for a, b in zip(leaves["streamed"],
                                                          leaves["resident"])]
    del leaves
    off.release_arenas()
    return {"streamed": s, "resident": r, "state_bitwise": all(same),
            "state_unequal": [i for i, ok in enumerate(same) if not ok]}


def _mamba2_rank(rank: int, world: int, box, checked):
    """mamba2_serve's runs on the parent's weights, `box[0]` (shared with it
    on the card through CUDA IPC, dropped and collected before the LMS runs
    and before this process returns, so the parent can free them), then
    mamba2_lms's. -> {"serve": facts, "lms": facts}."""
    import gc
    import torch
    params = box.pop()
    try:
        serve = _mamba2_serve_runs(params, checked)
    finally:
        del params
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"serve": serve, "lms": _mamba2_lms_runs(checked)}


def mamba2_phases(line, checked, params):
    """Mamba-2 serving and training under a plan, in a process spawned on
    the card that shares mamba_phases' 48-layer weights through CUDA IPC
    (`_mamba2_rank`; its pinned memory goes back to the host when it
    exits). Rows:

    mamba2_serve — the trace of MAMBA_PROMPTS (8 requests on MAMBA_SLOTS
    slots, MAMBA_GEN greedy tokens each: a prompt under K - 1, one of
    K - 1, one whole chunk, partial last chunks, up to 5 chunks of 256;
    the device holds the state of 4 requests, the other 4 are prefilled
    into host slots and wait) through `ServeEngine` with ssd_impl="pallas":
    the whole-prompt prefill takes the SSD scan with its final state (the
    tensor-core route, once a layer a prefill) and writes each layer's
    state straight into its slot or host slot; decode is plain torch
    (decode_ssm, as the JAX package's is plain jnp). At 2 layers: every
    decoded logits row within 2**-5 of its max |logit| of Model.forward's
    over the prompt and the tokens before it (the kernel route), no argmax
    flip where that row's top-2 margin exceeds 2**-5. At MAMBA_SERVE_LAYERS layers: the
    resident engine; under the serve plan of
    LMSConfig(hbm_budget=MAMBA_SERVE_BUDGET) (params and the waiting state
    on the host), tokens and every logits row bitwise resident, the
    params' swap bytes exactly a sweep a prefill and a tick, the peak at
    most SERVE_PLAN_PEAK_OVER_PLAN x the plan's; a preemption at tick
    MAMBA_PREEMPT_TICK, tokens bitwise, the preempted slot's state in its
    host slot bitwise; the pool empty after each run. Each recorded run:
    the scan only with its final state, L a prefill; RMSNorm L + 1 a
    prefill and a tick; every launch at a checked shape. `run_static` on 8
    prompts of MAMBA_STATIC_PROMPT tokens, MAMBA_STATIC_GEN new tokens each,
    under the plan (the cache
    emitted to the host a layer at a time by the prefill, streamed by each
    decode step, as the plan's residency says at MAMBA_SERVE_LAYERS)
    bitwise resident, its swap bytes exact as that residency implies, its
    peak within the same bound (plus the state of the requests beyond
    MAMBA_SLOTS where the plan keeps the cache on the card).

    mamba2_lms — MAMBA_LMS_LAYERS layers, MAMBA_LMS_STEPS steps of 2 x 2048
    tokens of `Trainer.train` under the plan of
    LMSConfig(hbm_budget=MAMBA_LMS_BUDGET) (params and AdamW state streamed
    from pinned memory; the scan's plain version, whose autograd gives the
    grads: the kernel has no backward) against resident: losses, grad
    norms and every leaf of params, mu, nu and the masters bitwise (mu
    and nu bitwise mean every step's grads were); the swap bytes a step
    exactly `_train_swap_count`; RMSNorm 2L + 1 a step; the peak at most
    SERVE_PLAN_PEAK_OVER_PLAN x the plan's. -> the serve row."""
    import torch
    t0 = time.monotonic()
    got = spawn_ranks("_mamba2_rank", 1, [params], checked, timeout=MAMBA_TIMEOUT_S)[0]
    torch.cuda.ipc_collect()
    sv, lm = got["serve"], got["lms"]
    bound = SERVE_PLAN_PEAK_OVER_PLAN * sv["plan"]["peak_bytes"]
    two, res, pl, pre, st = (sv[k] for k in ("layers_2", "resident", "planned", "preempt",
                                             "static"))
    checks = {f"layers_2_{k}": v for k, v in two["checks"].items()}
    checks.update({f"resident_{k}": v for k, v in res["checks"].items()})
    checks.update({f"planned_{k}": v for k, v in pl["checks"].items()})
    checks.update({f"static_{k}": v for k, v in st["checks"].items()})
    checks.update({
        "layers_2_within_2**-5": two["worst_over_row_max"] <= 2.0 ** -5,
        "layers_2_argmax_wide": two["argmax_flips_wide"] == 0 and two["wide_rows"] > 0,
        "layers_2_all_ok": two["all_ok"] and two["finite"],
        "all_ok": res["all_ok"] and pl["all_ok"] and pre["all_ok"] and res["finite"],
        "state_only_pool": not res["pool"]["has_paged"],
        "half_wait_on_the_host": res["pool"]["spilled_requests"] == len(MAMBA_PROMPTS)
        - MAMBA_SLOTS,
        "pools_empty": all(x["pool"]["empty"] and x["pool"]["host_slots_back"]
                           for x in (res, pl, pre)),
        "params_on_host": sv["plan"]["residency"].get("params") == "host",
        "planned_tokens_bitwise": pl["tokens_bitwise"],
        "planned_head_inputs_bitwise": pl["head_inputs_bitwise"],
        "planned_head_in_vocab_slices": pl["head_in_vocab_slices"],
        "planned_logits_bitwise": pl["logits_bitwise"],
        "planned_swap_bytes_exact": pl["swap_in_bytes_params"] == pl["swap_in_bytes_predicted"],
        "planned_peak_within_plan": pl["peak_bytes"] <= bound,
        "preempt_tokens_bitwise": pre["tokens_bitwise"] and pre["fired"] > 0,
        "preempt_state_moved_whole": pre["pool"]["preempted_requests"] >= 1
        and len(pre["state_moved_whole"]) == pre["pool"]["preempted_requests"]
        and all(pre["state_moved_whole"]),
        "static_tokens_bitwise": st["tokens_bitwise"],
        "static_swap_bytes_exact": st["swap_in_bytes_params"] == st["swap_in_bytes_predicted"]
        and st["swap_bytes_kvcache"] == st["swap_bytes_kvcache_predicted"],
        "static_peak_within_plan": st["peak_bytes"] <= bound + st["unpriced_state_bytes"],
        # the path this run is here for: the cache through the host
        "static_cache_streamed": st["cache_on_host"]})
    row = {"phase": "mamba2_serve", "arch": MAMBA, "layers": res["layers"], "card": line,
           "prompts": MAMBA_PROMPTS, "gen": MAMBA_GEN, "slots": MAMBA_SLOTS,
           "hbm_budget": MAMBA_SERVE_BUDGET, "plan_peak_bytes": sv["plan"]["peak_bytes"],
           "peak_over_plan_limit": SERVE_PLAN_PEAK_OVER_PLAN, **sv,
           "seconds": time.monotonic() - t0, "checks": checks}
    emit(row)
    s, r = lm["streamed"], lm["resident"]
    lchecks = {f"streamed_{k}": v for k, v in s["checks"].items()}
    lchecks.update({f"resident_{k}": v for k, v in r["checks"].items()})
    lchecks.update({
        "plan_streams_params_and_optimizer": s["plan"]["residency"].get("params") == "host"
        and s["plan"]["residency"].get("optimizer") == "host",
        "loss_bitwise": s["loss"] == r["loss"],
        "grad_norm_bitwise": s["grad_norm"] == r["grad_norm"],
        "state_bitwise": lm["state_bitwise"],
        "swap_bytes_exact": all(s["swap_per_step"].get(k, 0) == v
                                for k, v in s["swap_per_step_count"].items())
        and set(s["swap_per_step"]) <= set(s["swap_per_step_count"]),
        "peak_within_plan": s["max_memory_allocated_bytes"]
        <= SERVE_PLAN_PEAK_OVER_PLAN * s["plan"]["peak_bytes"]})
    lrow = {"phase": "mamba2_lms", "arch": MAMBA, "layers": MAMBA_LMS_LAYERS,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MAMBA_LMS_STEPS, "card": line,
            "hbm_budget": MAMBA_LMS_BUDGET, **lm,
            "overhead": s["median_step_s_after_1"] / r["median_step_s_after_1"] - 1,
            "peak_vs_plan": {"measured": s["max_memory_allocated_bytes"],
                             "plan": s["plan"]["peak_bytes"],
                             "ratio": s["max_memory_allocated_bytes"] / s["plan"]["peak_bytes"]},
            "checks": lchecks}
    emit(lrow)
    failed = [k for k, v in {**checks, **lchecks}.items() if not v]
    if failed:
        raise AssertionError(f"mamba2 serve / lms: failed checks {failed}")
    return row


def _train_config(layers: int, arch: str = ARCH, **kw):
    """`arch` (qwen2.5-14b unless named) at full width, cut to `layers`,
    trained on one device with LMS off on TRAIN_BATCH x TRAIN_SEQ tokens a
    step, without checkpoints (checkpoint_dir None) unless given one."""
    import dataclasses
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    return TrainConfig(model=cfg, shape=ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_BATCH),
                       mesh=MeshSpec((1, 1), ("data", "model")),
                       lms=LMSConfig(enabled=False), seed=SEED,
                       **{"checkpoint_dir": None, **kw})


def _rel_frobenius(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@contextlib.contextmanager
def _norm_as(fn):
    """The RMSNorm dispatcher the model calls swapped for fn."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    norm = rms_ops.rmsnorm
    rms_ops.rmsnorm = fn
    try:
        yield
    finally:
        rms_ops.rmsnorm = norm


def _plain_norm_analytic_backward(x, scale, *, eps=1e-6):
    """RMSNorm's plain forward with the kernel Function's backward (the
    analytic gradient in f32): a second plain version, which differs from
    autograd through the plain version only in the backward's f32
    roundings."""
    import torch
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    class PlainAnalytic(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, scale):
            ctx.save_for_backward(x, scale)
            return rmsnorm_ref(x, scale, eps=eps)

        @staticmethod
        def backward(ctx, dy):
            return rmsnorm_bwd_ref(*ctx.saved_tensors, dy, eps=eps)
    return PlainAnalytic.apply(x, scale)


def _max_or_none(errors: dict):
    vals = [v for v in errors.values() if v is not None]
    return max(vals) if vals else None


def train_reference_phase(line, checked, arch=ARCH, layers=TRAIN_CHECK_LAYERS,
                          steps=TRAIN_CHECK_STEPS, ab: bool = True):
    """`steps` (3) steps of `build_train_step` at `layers` (2) layers of
    `arch` (qwen2.5-14b) from one init (a seeded
    torch generator, drawn again for each run) on the same 3 batches of the
    synthetic stream, through the kernels (counts reset just before, read
    just after) and through the plain versions; and step 1 once more with
    the plain forward and the kernel's analytic backward, the rounding
    floor: two plain versions that differ only in f32 roundings.

    Held: each step's loss and grad norm within 1%; exactly 4L+1 RMSNorm
    launches a step (2L+1 in the forward, 2L in the checkpointed layers'
    recompute; none for a LayerNorm config) and none through the plain
    versions; step 1's grads leaf by
    leaf within 2**-5 relative Frobenius error. At random init the bf16
    grads are small sums of large terms that cancel, so roundings move
    them far: the kernel's outputs differ from the plain version's in a
    small share of elements by one bf16 ulp (the kernel rows report it),
    yet the grads move by about 1%, and the floor route lies about as far
    from the plain one. Both errors are reported.

    The A/B of that gap (ROADMAP 3.3): step 1 once more with RMSNorm swapped
    for its plain version as `plain_versions()` swaps it and every other
    kernel on (in training none other runs), reported against the plain
    run (what a rerun of it gives) and against the kernel run; and the
    floor route against the kernel run, the two differing only in
    RMSNorm's forward (kernel against plain); not if `ab` is False. A
    LayerNorm config runs no kernel in training: its kernel and plain runs
    are the same computation, and it has no floor route or A/B. Step 1's
    grads are kept on the host (qwen2-72b's state at 1 layer fills most of
    the card) and compared leaf by leaf on the card."""
    import torch
    from repro_torch.data import DataLoader, SyntheticTokens
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    from repro_torch.tree import tree_leaves, tree_map
    L, n = layers, steps
    tcfg = _train_config(L, arch, learning_rate=TRAIN_LR, warmup_steps=0, total_steps=n)
    model = Model(tcfg.model)
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=SEED), shard=0,
                        num_shards=1, batch_per_shard=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
               for _ in range(n)]
    clip = steps_mod.clip_by_global_norm

    def run(around, steps):
        """-> (step 1's grads, [metrics as floats], [RMSNorm launches a
        step], what `around` yields)."""
        state = steps_mod.init_train_state(model, tcfg, SEED + 7, "cuda")
        step = steps_mod.build_train_step(model, tcfg)
        first = []

        def clip_rec(grads, max_norm, *tp):
            if not first:
                first.append(tree_map(lambda g: g.to("cpu"), grads))
            return clip(grads, max_norm, *tp)
        steps_mod.clip_by_global_norm = clip_rec
        mets, per_step = [], []
        try:
            with around as rec:
                for b in batches[:steps]:
                    before = _launchers()["rmsnorm"].launches
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    state, m = step(state, b)
                    mets.append({k: float(v) for k, v in m.items()})
                    mets[-1]["step_s"] = time.monotonic() - t0
                    per_step.append(_launchers()["rmsnorm"].launches - before)
        finally:
            steps_mod.clip_by_global_norm = clip
        del state
        torch.cuda.empty_cache()
        return first[0], mets, per_step, rec

    def leaf_errors(got, want):
        return {f"/{i}": _rel_frobenius(g.cuda(), w.cuda())
                for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want)))}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    grads_k, mets_k, per_step, (seen, calls, launches) = run(launch_signatures(), n)
    kernel_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads_p, mets_p, plain_per_step, _ = run(plain_versions(), n)
    names = []
    tree_map(lambda g: names.append(tuple(g.shape)), grads_k)
    err = leaf_errors(grads_k, grads_p)
    dtypes_ok = all(g.dtype == p.dtype for g, p in zip(tree_leaves(grads_k),
                                                      tree_leaves(grads_p)))
    floor = floor_vs_kernel = ab_vs_plain = ab_vs_kernel = {"/0": None}
    floor_per_step = ab_per_step = []
    if _rmsnorm_on(tcfg.model):
        grads_f, _, floor_per_step, _ = run(_norm_as(_plain_norm_analytic_backward), 1)
        floor = leaf_errors(grads_f, grads_p)
        floor_vs_kernel = leaf_errors(grads_f, grads_k)
        del grads_f
    if _rmsnorm_on(tcfg.model) and ab:
        # A/B of the kernel route's gap: RMSNorm swapped for its plain version as
        # plain_versions() swaps it (plain forward, autograd backward), every
        # other kernel left on (none other runs in training): step 1 again
        grads_a, _, ab_per_step, _ = run(_norm_as(rmsnorm_ref), 1)
        ab_vs_plain = leaf_errors(grads_a, grads_p)
        ab_vs_kernel = leaf_errors(grads_a, grads_k)
        del grads_a
    del grads_p, grads_k
    torch.cuda.empty_cache()
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mets_k, mets_p)]
           for k in ("loss", "grad_norm")}
    step_s = [m["step_s"] for m in mets_k]
    unchecked = sorted(seen - checked)
    checks = {
        "grads_within_2**-5": max(err.values()) <= 2.0 ** -5,
        "grad_dtypes": dtypes_ok,
        "loss_within_1%": max(rel["loss"]) <= 1e-2,
        "grad_norm_within_1%": max(rel["grad_norm"]) <= 1e-2,
        "finite": all(x == x and abs(x) != float("inf") for m in mets_k for x in m.values()),
        "rmsnorm_launches_4L+1_a_step": per_step == [(4 * L + 1) * _rmsnorm_on(tcfg.model)] * n,
        "plain_runs_launch_no_rmsnorm":
            plain_per_step + floor_per_step + ab_per_step
            == [0] * (n + len(floor_per_step) + len(ab_per_step)),
        "no_other_launches": all(v == 0 for k, v in launches.items()
                                 if not k.startswith("rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
    }
    row = {"phase": "train_reference", "arch": arch, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": n, "lr": TRAIN_LR, "card": line,
           "loss_kernel": [m["loss"] for m in mets_k], "loss_plain": [m["loss"] for m in mets_p],
           "grad_norm_kernel": [m["grad_norm"] for m in mets_k],
           "grad_norm_plain": [m["grad_norm"] for m in mets_p], "rel_diff": rel,
           "step_s_kernel": step_s,
           "tokens_per_s_last_step": TRAIN_BATCH * TRAIN_SEQ / step_s[-1],
           "grad_rel_frobenius_max": max(err.values()),
           "grad_rel_frobenius_floor_max": _max_or_none(floor),
           "grad_rel_frobenius_floor_vs_kernel_max": _max_or_none(floor_vs_kernel),
           "ab_plain_rmsnorm_vs_plain_max": _max_or_none(ab_vs_plain),
           "ab_plain_rmsnorm_vs_kernel_max": _max_or_none(ab_vs_kernel),
           "grad_leaf_shapes": names, "grad_rel_frobenius": err,
           "grad_rel_frobenius_floor": floor,
           "grad_rel_frobenius_floor_vs_kernel": floor_vs_kernel,
           "ab_plain_rmsnorm_vs_plain": ab_vs_plain, "ab_plain_rmsnorm_vs_kernel": ab_vs_kernel,
           "rmsnorm_launches_per_step": per_step, "launches": launches,
           "kernel_run_s": kernel_s, "max_memory_allocated_gb": peak_gb,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train reference {arch} ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def _train_flops(cfg, tokens: int, seq: int):
    """-> (model FLOPs a step, FLOPs a step with the recompute): 6 N T over
    the matmul params N (attention and MLP projections and the head; the
    embedding is a lookup) plus causal attention (QK^T and PV, 4 D per
    visible (query, key) pair a head, 3x for forward and backward); the
    recompute runs every layer's forward once more."""
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    # an MoE layer's FFN: its k routed experts and the router
    layer = (d * hd + 2 * d * kvd + hd * d + 3 * d * cfg.d_ff * max(cfg.experts_per_token, 1)
             + d * cfg.num_experts)
    head = d * cfg.vocab_size
    pairs = tokens * (seq + 1) / 2                 # visible pairs over the batch
    attn_fwd = 4 * hd * pairs * cfg.num_layers
    model = 6 * (layer * cfg.num_layers + head) * tokens + 3 * attn_fwd
    return model, model + 2 * layer * cfg.num_layers * tokens + attn_fwd


def device_time_by_kind(prof) -> dict:
    """Device seconds of a torch.profiler run by kind of kernel: cuBLAS
    GEMMs (bf16 on the tensor cores, f32 on the CUDA cores), the port's
    RMSNorm kernel, reductions, and the elementwise kernels and copies."""
    from torch.autograd import DeviceType
    out = {"gemm_bf16_s": 0.0, "gemm_f32_s": 0.0, "rmsnorm_kernel_s": 0.0,
           "reduce_s": 0.0, "elementwise_and_copy_s": 0.0}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name, dur = ev.name(), ev.duration_ns() / 1e9
        if "f32f32" in name and "gemm" in name:
            out["gemm_f32_s"] += dur
        elif any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
            out["gemm_bf16_s"] += dur
        elif "rmsnorm_kernel" in name:
            out["rmsnorm_kernel_s"] += dur
        elif "reduce" in name:
            out["reduce_s"] += dur
        else:
            out["elementwise_and_copy_s"] += dur
    return out


def step_split_ms(step_fn, state, batch):
    """One train step with CUDA events at its start, at the clip (the end
    of the loss and its grads: forward, the layers' recompute and the
    backward), after the clip (the streamed step: after the clip's norm,
    its scaling lies in the sweep) and at its end (the optimizer). ->
    (state, {part: ms}); device time, idle gaps included."""
    import torch
    from repro_torch.train import steps as steps_mod
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    clip, norm = steps_mod.clip_by_global_norm, steps_mod._global_norm_streamed

    def timed(fn):
        def run(*a, **k):
            ev[1].record()
            out = fn(*a, **k)
            ev[2].record()
            return out
        return run
    # the resident step clips in one pass; the streamed step takes the
    # norm here and scales each slice inside the sweep (optimizer_ms)
    steps_mod.clip_by_global_norm = timed(clip)
    steps_mod._global_norm_streamed = timed(norm)
    try:
        ev[0].record()
        state, _ = step_fn(state, batch)
        ev[3].record()
    finally:
        steps_mod.clip_by_global_norm = clip
        steps_mod._global_norm_streamed = norm
    torch.cuda.synchronize()
    return state, {"loss_and_grads_ms": ev[0].elapsed_time(ev[1]),
                   "clip_ms": ev[1].elapsed_time(ev[2]),
                   "optimizer_ms": ev[2].elapsed_time(ev[3]),
                   "step_ms": ev[0].elapsed_time(ev[3])}


def trainer_phase(line, checked):
    """The main path: `Trainer(tcfg).train(TRAIN_STEPS)` at 4 layers of
    qwen2.5-14b's full width (warmup 1, lr 3e-4, log_every 1, so each step
    is timed to its last kernel), counts reset just before and read just
    after: finite losses, 4L+1 RMSNorm launches a step and no other kernel
    (blockwise attention, as the JAX trainer's default); then one more step
    under torch.profiler (busy share, top kernels, device time by kind of
    kernel) and one split by CUDA events into the loss and its grads, the
    clip and the optimizer. -> the phase row."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    L = TRAIN_LAYERS
    tcfg = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(tcfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=TRAIN_STEPS)
    run_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = trainer._make_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.monotonic() - t1
    state, split = step_split_ms(trainer.step_fn, state, batch)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = statistics.median(r["time_s"] for r in hist[1:])
    model_flops, hw_flops = _train_flops(tcfg.model, tokens, TRAIN_SEQ)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    unchecked = sorted(seen - checked)
    checks = {
        "steps": [r["step"] for r in hist] == list(range(1, TRAIN_STEPS + 1)),
        "finite_losses": all(r["loss"] == r["loss"] and abs(r["loss"]) != float("inf")
                             for r in hist),
        "rmsnorm_launches_4L+1_a_step": launches["rmsnorm"] == (4 * L + 1) * TRAIN_STEPS,
        "no_other_launches": all(v == 0 for k, v in launches.items()
                                 if not k.startswith("rmsnorm")),
        "every_launch_recorded": calls == launches,
        "every_launch_shape_checked": not unchecked,
    }
    row = {"phase": "trainer", "arch": ARCH, "layers": L, "d_model": tcfg.model.d_model,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "card": line, "params": n_params,
           "why_4_layers": "params + grads + f32 Adam mu/nu/master stay resident at ~16 B a "
                           "param (~42.5 GB); all 48 layers need ~236 GB, the case of LMS "
                           "(lms_ab, lms_gate)",
           "loss": [r["loss"] for r in hist], "grad_norm": [r["grad_norm"] for r in hist],
           "lr_per_step": [r["lr"] for r in hist], "step_s": [r["time_s"] for r in hist],
           "median_step_s_after_1": step_s, "tokens_per_s": tokens / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "model_tflop_s": model_flops / step_s / 1e12,
           "model_flops_share_of_989": model_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "with_recompute_tflop_s": hw_flops / step_s / 1e12,
           "with_recompute_share_of_989": hw_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "run_s": run_s, "max_memory_allocated_gb": peak_gb, "launches": launches,
           "launch_signatures": sorted(seen), "unchecked_signatures": unchecked,
           "checks": checks, "step_split_ms": split,
           "profile": {**device_summary(prof, profiled_s),
                       "by_kind": device_time_by_kind(prof)}}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"trainer ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# DDL: data-parallel training, its ranks in processes of their own
# ---------------------------------------------------------------------------

def _ddl_config(layers: int, mesh, *, smoke: bool = False, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, arch: str = ARCH, **kw):
    """`arch` (qwen2.5-14b unless named) at full width cut to `layers` (or
    its smoke config) on `mesh` (pod, data, model), LMS off, `batch` x
    `seq` tokens a step over all the ranks, without checkpoints
    (checkpoint_dir None) unless given one."""
    import dataclasses
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config(arch) if smoke
           else dataclasses.replace(get_config(arch), num_layers=layers))
    return TrainConfig(model=cfg, shape=ShapeConfig("ddl", "train", seq, batch),
                       mesh=MeshSpec(tuple(mesh), DDL_AXES), lms=LMSConfig(enabled=False),
                       seed=SEED, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=DDL_STEPS, **{"checkpoint_dir": None, **kw})


def ddl_pod_hop_sizes(cfg, data_size: int, *, overlap: bool):
    """Elements of each call of the compressed pod hop in one train step,
    worked out from the leaf sizes: with the overlapped backward each
    layer's buckets (`make_buckets` at the default 64 MiB, padded to
    |data|, this rank's 1/|data| shard of each) and then the other leaves
    (embedding, head, final norm); without it every leaf; a leaf with no
    dimension divisible by |data| takes a plain psum. Each shard is cut into
    POD_SLICE-element slices, one call each."""
    import math
    from repro_torch.config.base import DDLConfig
    from repro_torch.core.ddl.allreduce import POD_SLICE, _choose_scatter_dim, make_buckets
    from repro_torch.core.ddl.overlap import _bucket_elems
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    defs = Model(cfg).param_defs()
    stacked = tree_leaves(defs["decoder"]["stack0"])
    rest = tree_leaves({k: v for k, v in defs.items() if k != "decoder"})
    shards = []

    def per_leaf(shape):
        if _choose_scatter_dim(shape, data_size) is not None:
            shards.append(math.prod(shape) // data_size)
    if overlap:
        sizes = [max(math.prod(d.shape[1:]), 1) for d in stacked]
        for _ in range(cfg.num_layers):
            for b in make_buckets(sizes, _bucket_elems(DDLConfig())):
                n = sum(sizes[i] for i in b)
                shards.append((n + (-n) % data_size) // data_size)
    else:
        for d in stacked:
            per_leaf(d.shape)
    for d in rest:
        per_leaf(d.shape)
    return [min(POD_SLICE, n - i) for n in shards for i in range(0, n, POD_SLICE)]


def ddl_sharded_pod_hop_sizes(cfg, data_size: int, *, zero1: bool, overlap: bool,
                              microbatches: int = DDL_SHARDED_MICROBATCHES):
    """Elements of each call of the compressed pod hop in one step of zero1
    (one pass over the batch) or of the microbatch accumulator (m passes),
    worked out from the leaf sizes: overlapped, each layer's buckets in the
    hooks' shard mode (a bucket's shard is the sum of its leaves'
    ceil(n / |data|) slots) and then each other leaf's slot
    (`local_shard_parts` reduce-scatters its padded flat row), once a pass;
    serialized, zero1's whole flat vector padded to |data| once, and the
    accumulator's tree pass once after the last microbatch
    (`ddl_pod_hop_sizes`). Each shard in POD_SLICE-element slices."""
    import math
    from repro_torch.config.base import DDLConfig
    from repro_torch.core.ddl.allreduce import POD_SLICE, make_buckets
    from repro_torch.core.ddl.overlap import _bucket_elems
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    if not overlap and not zero1:
        return ddl_pod_hop_sizes(cfg, data_size, overlap=False)
    defs = Model(cfg).param_defs()
    stacked = tree_leaves(defs["decoder"]["stack0"])
    rest = tree_leaves({k: v for k, v in defs.items() if k != "decoder"})

    def slot(n):
        return -(-n // data_size)
    if not overlap:
        total = sum(math.prod(d.shape) for d in tree_leaves(defs))
        shards = [slot(total)]
    else:
        sizes = [max(math.prod(d.shape[1:]), 1) for d in stacked]
        one = [sum(slot(sizes[i]) for i in b) for _ in range(cfg.num_layers)
               for b in make_buckets(sizes, _bucket_elems(DDLConfig()))]
        one += [slot(max(math.prod(d.shape), 1)) for d in rest]
        shards = one * (1 if zero1 else microbatches)
    return [min(POD_SLICE, n - i) for n in shards for i in range(0, n, POD_SLICE)]


def ddl_ef_slices():
    """The pod-hop slices of the error-feedback path's leaf."""
    from repro_torch.core.ddl.allreduce import POD_SLICE
    return [min(POD_SLICE, DDL_EF_LEAF - i) for i in range(0, DDL_EF_LEAF, POD_SLICE)]


def _tuplify(x):
    return tuple(_tuplify(i) for i in x) if isinstance(x, list) else x


def _checksums(params) -> list:
    """Each leaf's bits summed with positional weights in int64 (wrapping),
    on the card wherever the leaf lies: two replicas whose leaves are
    bitwise equal give equal sums, and a changed or moved element changes
    them."""
    import torch
    from repro_torch.tree import tree_leaves
    out = []
    for t in tree_leaves(params):
        flat = t.detach().reshape(-1).view(torch.int32 if t.element_size() == 4 else torch.int16)
        acc = torch.zeros((), dtype=torch.int64, device="cuda")
        for i in range(0, flat.numel(), 1 << 24):
            # a host leaf (LMS) is summed on the card a slice at a time
            part = flat[i:i + (1 << 24)].to("cuda").long()
            acc += (part * torch.arange(i + 1, i + 1 + part.numel(), device="cuda")).sum()
        out.append(int(acc))
    return out


def _same_on_all_ranks(obj) -> bool:
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return all(g == got[0] for g in got)


def _rank_main(rank: int, world: int, tmp: str, name: str, args):
    """A spawned rank: join the gloo group through a FileStore in `tmp`,
    run the function `name`, write its JSON result to tmp/rank<r>.json."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DDL_TIMEOUT_S))
    try:
        out = globals()[name](rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(name: str, world: int, *args, timeout: float = DDL_TIMEOUT_S):
    """Run the function `name`(rank, world, *args) in `world` processes
    started with the spawn method, all on the one card, joined over gloo;
    -> each rank's result. A failed rank stops the others and raises; so
    does the timeout, after killing them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddl_")
    try:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, name, args), nprocs=world,
                                 start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{name}: {world} ranks did not finish in {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _inline_put(self, i, grads, dst):
    """`ReductionQueue.put` with the layer reduced at once, in the backward:
    the reductions the queue's worker would make, inline (patched in for
    the queued-against-inline checks only)."""
    self._step.count += 1
    self._reduce_into(i, grads, dst, self._step.squares, self._step.accumulate)


@contextlib.contextmanager
def _inline_reductions():
    """Every `ReductionQueue.put` inside the block reduces inline
    (`_inline_put`)."""
    from repro_torch.core.ddl import overlap
    put = overlap.ReductionQueue.put
    overlap.ReductionQueue.put = _inline_put
    try:
        yield
    finally:
        overlap.ReductionQueue.put = put


@contextlib.contextmanager
def _plain_quantizers():
    """The quantize, dequantize and pod-sum dispatchers the pod hop calls
    swapped for their plain versions."""
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import (dequantize_ref, dequantize_sum_rows_ref,
                                                  quantize_ref)
    saved = q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows
    q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows = (
        quantize_ref, dequantize_ref, dequantize_sum_rows_ref)
    try:
        yield
    finally:
        q_ops.quantize, q_ops.dequantize, q_ops.dequantize_sum_rows = saved


def _ddl_full_rank(rank: int, world: int):
    """One rank of the full-width DDL phase: `Trainer.train` on the 2x1x1
    mesh with compress_dcn and the overlapped backward. Every compressed
    pod-hop call counts the bytes this rank sends (int8 codes and f32
    scales, against 4 B an element uncompressed); on step 1 each call is
    also run through the plain quantizers (bitwise equal required) and
    uncompressed (the int8 result within the sum over pods of each row's
    scale / 2 of the exact f32 sum). The reductions are timed by CUDA
    events; after each step the params' checksums are compared across the
    ranks and the step's kernel launches read and reset."""
    import importlib
    import torch
    from repro_torch.config.base import DDLConfig
    from repro_torch.core.ddl import allreduce, overlap
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.quantize.ref import quantize_ref
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.trainer import Trainer
    comp = importlib.import_module("repro_torch.core.ddl.compress")
    tcfg = _ddl_config(DDL_LAYERS, DDL_MESH, ddl=DDLConfig(compress_dcn=True), log_every=1)
    trainer = Trainer(tcfg, device="cuda")
    box, in_sync = {}, []
    init = trainer.init_state

    sums = []

    def init_state():
        st = init()
        box["params"] = st.params
        sums.append(_checksums(st.params))
        in_sync.append(_same_on_all_ranks(sums[-1]))
        return st
    trainer.init_state = init_state

    hop = allreduce.compressed_allreduce_pod
    stats = {"calls": 0, "int8_bytes": 0, "f32_bytes": 0, "kernel_eq_plain": True,
             "worst_err_over_bound": 0.0, "max_abs_err": 0.0, "checked_calls": 0}
    check = [True]

    def hop_checked(x, axis, *, mesh, error_feedback=None):
        out, ef = hop(x, axis, mesh=mesh, error_feedback=error_feedback)
        rows = -(-x.numel() // 1024)
        stats["calls"] += 1
        stats["int8_bytes"] += rows * 1024 + rows * 4
        stats["f32_bytes"] += x.numel() * 4
        if check[0]:
            with _plain_quantizers():
                plain, _ = hop(x, axis, mesh=mesh, error_feedback=error_feedback)
            stats["kernel_eq_plain"] &= torch.equal(out.view(torch.int32),
                                                    plain.view(torch.int32))
            exact = mesh.psum(x.float(), axis)
            _, sc = quantize_ref(comp._to_rows(x)[0])
            pods = mesh.size(axis)
            half = mesh.all_gather(sc, axis).view(pods, -1).sum(0) / 2
            bound = half.repeat_interleave(1024)[:x.numel()] * (1 + 2.0 ** -10)
            err = (out.float() - exact).abs()
            stats["worst_err_over_bound"] = max(stats["worst_err_over_bound"],
                                                float((err / bound).max()))
            stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
            stats["checked_calls"] += 1
        return out, ef
    allreduce.compressed_allreduce_pod = hop_checked

    spans = []

    def timed(fn):
        def run(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            spans.append((e0, e1))
            return r
        return run
    overlap.reduce_tree_bucketed = timed(overlap.reduce_tree_bucketed)
    steps_mod.ddl_reduce_tree = timed(steps_mod.ddl_reduce_tree)
    step_events = []
    step_fn = trainer.step_fn

    def step_timed(state, batch):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(state, batch)
        e1.record()
        step_events.append((e0, e1))
        return out
    trainer.step_fn = step_timed

    steps = []
    queue = step_fn.queue

    def on_step(step, row):
        torch.cuda.synchronize()
        e0, e1 = step_events[-1]
        reduce_ms = sum(a.elapsed_time(b) for a, b in spans)
        spans.clear()
        steps.append({"step": step, "loss": row["loss"], "grad_norm": row["grad_norm"],
                      "time_s": row["time_s"], "step_ms": e0.elapsed_time(e1),
                      "reduce_ms": reduce_ms, "queue_reduce_s": queue.reduce_s,
                      "queue_under_backward_s": queue.under_backward_s,
                      "queue_drain_wait_s": queue.drain_wait_s,
                      "quantize_launches": q_ops.quantize_cuda.launches,
                      "dequantize_launches": q_ops.dequantize_cuda.launches,
                      "dequantize_sum_launches": q_ops.dequantize_sum_rows_cuda.launches,
                      "pod_hop_calls": stats["calls"]})
        q_ops.quantize_cuda.launches = q_ops.dequantize_cuda.launches = 0
        q_ops.dequantize_sum_rows_cuda.launches = 0
        stats["calls"] = 0
        sums.append(_checksums(box["params"]))
        in_sync.append(_same_on_all_ranks(sums[-1]))
        check[0] = False

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with launch_signatures() as (seen, _, _):
        trainer.train(DDL_STEPS, on_step=on_step)
    wall = time.monotonic() - t0
    same_losses = _same_on_all_ranks([(r["loss"], r["grad_norm"]) for r in steps])
    allreduce.compressed_allreduce_pod = hop
    ef_row, ef_seen = _ddl_error_feedback(trainer.mesh, rank)
    return {"rank": rank, "steps": steps, "in_sync": in_sync, "same_losses": same_losses,
            "checksums": sums, "queued": queue is not None,
            "pod_hop": {k: v for k, v in stats.items() if k != "calls"},
            "error_feedback": ef_row,
            "signatures": sorted(seen | ef_seen), "seconds": wall,
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card_free_gb": torch.cuda.mem_get_info()[0] / 1e9}


def _ddl_error_feedback(mesh, rank: int):
    """Error feedback's path on a rank of the 2x1x1 mesh: one leaf of
    DDL_EF_LEAF elements reduced by `ddl_reduce_leaf` with compress_dcn and
    a nonzero EF buffer, launch counts reset just before and read just
    after (the local dequantize once a slice beside the pod sum), then
    again through the plain quantizers: the mean and the new EF bitwise
    equal. -> (row, signatures seen)."""
    import torch
    from repro_torch.core.ddl.allreduce import ddl_reduce_leaf
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7 + rank)
    g = torch.randn(DDL_EF_LEAF, generator=gen, device="cuda")
    ef = torch.randn(DDL_EF_LEAF, generator=gen, device="cuda") * 1e-2
    kw = dict(mesh=mesh, data_axis="data", pod_axis="pod", data_size=mesh.size("data"),
              pod_size=mesh.size("pod"), compress_dcn=True, topology_aware=True)
    with launch_signatures() as (seen, calls, launches):
        out, new_ef = ddl_reduce_leaf(g.clone(), error_feedback=ef.clone(), **kw)
    with _plain_quantizers():
        want, want_ef = ddl_reduce_leaf(g.clone(), error_feedback=ef.clone(), **kw)
    bitwise = (torch.equal(out.view(torch.int32), want.view(torch.int32))
               and torch.equal(new_ef.view(torch.int32), want_ef.view(torch.int32)))
    row = {"leaf": DDL_EF_LEAF, "slices": len(ddl_ef_slices()), "bitwise_vs_plain": bitwise,
           "every_launch_recorded": calls == launches,
           "launches": {k: launches[k] for k in ("quantize_rows", "dequantize_rows",
                                                 "dequantize_sum_rows", "dequantize_rows_vector")}}
    return row, seen


def _ddl_smoke_run(tcfg, mesh, inline: bool = False):
    """One run of `_ddl_smoke_rank`: DDL_STEPS steps from the seed's init on this
    rank's rows, the queue's reductions inline if `inline`. -> (rows,
    checksums after init and each step, in sync after each, signatures,
    launches)."""
    import torch
    from repro_torch.data import local_rows
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step, init_train_state
    model = Model(tcfg.model)
    step = build_train_step(model, tcfg, mesh=mesh)
    state = init_train_state(model, tcfg, SEED, "cuda")
    sums = [_checksums(state.params)]
    rows, in_sync = [], [_same_on_all_ranks(sums[0])]
    with contextlib.ExitStack() as stack:
        if inline:
            stack.enter_context(_inline_reductions())
        seen, _, launches = stack.enter_context(launch_signatures())
        for b in _ddl_batches(tcfg):
            local = local_rows(b, mesh.dp_index, mesh.dp_size)
            state, met = step(state, {k: torch.from_numpy(v).cuda() for k, v in local.items()})
            rows.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
            sums.append(_checksums(state.params))
            in_sync.append(_same_on_all_ranks(sums[-1]))
    return rows, sums, in_sync, seen, launches


def _ddl_smoke_rank(rank: int, world: int):
    """One rank of the smoke-width DDL phase on the 2x2x1 mesh: the train
    step with the overlapped backward off and on, compression off and on,
    DDL_STEPS steps each from one init, on this rank's rows of the global batch;
    each step's loss and grad norm, and whether the params' checksums agree
    across all ranks after each step; each overlapped run again with the
    queue's reductions inline (`_inline_put`): whether its rows and
    checksums equal the queued run's."""
    import dataclasses
    from repro_torch.config.base import DDLConfig
    from repro_torch.launch.mesh import make_mesh
    tcfg0 = _ddl_config(0, DDL_SMOKE_MESH, smoke=True, batch=DDL_SMOKE_BATCH,
                        seq=DDL_SMOKE_SEQ)
    mesh = make_mesh(tcfg0.mesh)
    out = {}
    for ov in (False, True):
        for c in (False, True):
            tcfg = dataclasses.replace(tcfg0, ddl=DDLConfig(compress_dcn=c, overlap_grads=ov))
            rows, sums, in_sync, seen, launches = _ddl_smoke_run(tcfg, mesh)
            got = out[f"overlap={ov},compress={c}"] = {
                "rows": rows, "in_sync": in_sync, "signatures": sorted(seen),
                "quantize_launches": launches["quantize_rows"],
                "dequantize_launches": launches["dequantize_rows"],
                "dequantize_sum_launches": launches["dequantize_sum_rows"]}
            if ov:
                i_rows, i_sums, i_sync, _, _ = _ddl_smoke_run(tcfg, mesh, inline=True)
                got["inline_bitwise"] = i_rows == rows and i_sums == sums and all(i_sync)
    return out


def _ddl_batches(tcfg):
    """The global batches of DDL_STEPS steps of the synthetic stream."""
    from repro_torch.data import DataLoader, SyntheticTokens
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=tcfg.seed), shard=0,
                        num_shards=1, batch_per_shard=tcfg.shape.global_batch,
                        seq_len=tcfg.shape.seq_len)
    return [next(loader) for _ in range(DDL_STEPS)]


def ddl_phase(line, checked):
    """The main path of data-parallel training at qwen2.5-14b's full width,
    cut to 1 layer: `Trainer.train` for DDL_STEPS steps on 2 ranks (a 2x1x1 mesh:
    2 pods of 1 data rank) with compress_dcn and the overlapped backward
    (the layer's grads reduced on the DDL queue's thread and stream; its
    times reported), 2048 tokens a rank a step. The ranks share the one
    card and talk over gloo, staged through host memory, so the times are
    those of two ranks time-slicing one card, not DDL's speed across
    cards.

    Memory: 1 layer is 1.833 B params (embedding and head 778.6 M each, the
    layer 275.3 M); with the f32 embedding, bf16 weights, their grads and
    AdamW's f32 moments and master copy that is ~32.4 GB a rank, ~65 GB for
    two, and the reduction works on 2**24-element slices of a leaf.

    Held: (a) every param leaf's checksum equal across the ranks at init
    and after every step; (b) on step 1, every pod-hop call through the
    kernels bitwise equal to the same call through the plain quantizers;
    (c) the int8 sum within the sum over pods of scale/2 of each 1024-row
    of the exact f32 sum; (d) each step's launches: quantize and the pod
    sum once for each compressed slice, worked out from the leaf sizes and
    buckets, and no dequantize; (e) finite losses, equal on both ranks;
    (f) error feedback's path after the steps (`_ddl_error_feedback`): its
    launches, and its mean and EF bitwise through the kernels and through
    the plain versions; and every launch at a shape the kernel phases
    checked. -> the phase row."""
    import torch
    tcfg = _ddl_config(DDL_LAYERS, DDL_MESH)
    pods = DDL_MESH[0]
    slices = len(ddl_pod_hop_sizes(tcfg.model, DDL_MESH[1], overlap=True))
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = spawn_ranks("_ddl_full_rank", pods)
    r0 = ranks[0]
    unchecked = {_tuplify(sig) for r in ranks for sig in r["signatures"]} - checked
    checks = {
        "replicas_in_sync": all(all(r["in_sync"]) and len(r["in_sync"]) == DDL_STEPS + 1
                                for r in ranks),
        "kernels_eq_plain_bitwise": all(r["pod_hop"]["kernel_eq_plain"]
                                        and r["pod_hop"]["checked_calls"] == slices
                                        for r in ranks),
        "within_int8_bound": all(r["pod_hop"]["worst_err_over_bound"] <= 1.0 for r in ranks),
        # a step: quantize and the pod sum once a slice, no dequantize (no EF)
        "launches": all(s["quantize_launches"] == slices
                        and s["dequantize_sum_launches"] == slices
                        and s["dequantize_launches"] == 0
                        and s["pod_hop_calls"] == slices for r in ranks for s in r["steps"]),
        # error feedback's path: the local dequantize once a slice, on the vector path
        "error_feedback": all(
            r["error_feedback"]["bitwise_vs_plain"] and r["error_feedback"]["every_launch_recorded"]
            and r["error_feedback"]["launches"] == {
                "quantize_rows": len(ddl_ef_slices()), "dequantize_rows": len(ddl_ef_slices()),
                "dequantize_sum_rows": len(ddl_ef_slices()),
                "dequantize_rows_vector": len(ddl_ef_slices())} for r in ranks),
        "finite_equal_losses": all(r["same_losses"] for r in ranks) and all(
            math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in r0["steps"]),
        "reduced_on_the_queue": all(r["queued"] for r in ranks),
        "shapes_checked": not unchecked}
    steady = r0["steps"][1:]
    row = {"phase": "ddl_full_width", "arch": ARCH, "layers": DDL_LAYERS,
           "mesh": list(DDL_MESH), "ranks": pods, "backend": "gloo (host-staged)",
           "compress_dcn": True, "overlap_grads": True,
           "tokens_per_rank": TRAIN_BATCH * TRAIN_SEQ // pods, "card": line,
           "note": "two ranks time-slice one card over gloo through host memory: "
                   "not DDL's speed across cards",
           "steps": r0["steps"], "expected_slices_per_step": slices,
           "error_feedback": r0["error_feedback"], "checksums": r0["checksums"],
           "step_ms_steady": sum(s["step_ms"] for s in steady) / len(steady),
           "reduce_ms_steady": sum(s["reduce_ms"] for s in steady) / len(steady),
           "reduce_share_steady": (sum(s["reduce_ms"] for s in steady)
                                   / sum(s["step_ms"] for s in steady)),
           **{k: _steady(r0["steps"], k) for k in ("queue_reduce_s", "queue_under_backward_s",
                                                  "queue_drain_wait_s")},
           "pod_hop_bytes_per_step": r0["pod_hop"]["int8_bytes"] / DDL_STEPS,
           "pod_hop_f32_bytes_per_step": r0["pod_hop"]["f32_bytes"] / DDL_STEPS,
           "pod_hop_worst_err_over_bound": max(r["pod_hop"]["worst_err_over_bound"]
                                               for r in ranks),
           "pod_hop_max_abs_err": max(r["pod_hop"]["max_abs_err"] for r in ranks),
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
           "card_free_gb_at_end": [r["card_free_gb"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks],
           "seconds": time.monotonic() - t0, "checks": checks,
           "unchecked_shapes": sorted(map(str, unchecked))}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"ddl (full width): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def ddl_smoke_phase(line, checked):
    """The hierarchical schedule with |data| = 2 on the card: 4 ranks on a
    2x2x1 mesh at the qwen2.5-14b smoke config (the one part at reduced
    width: 4 full-width replicas do not fit one card), the overlapped
    backward off and on x compression off and on, DDL_STEPS steps each, each held
    against one rank (the train step on a 1-device mesh) on the global
    batch from the same init. Tolerance, stated before the first run: the
    ranks' bf16 GEMMs have a quarter of the rows, so cuBLAS may sum in
    another order, and the int8 pod hop rounds each grad element by up to
    half its row's scale: loss within 5e-3 relative, grad norm within
    2e-2. Replicas stay bitwise in sync; compressed runs launch quantize
    and the pod sum as the leaf sizes say, and no dequantize; each
    overlapped run equals its rerun with the queue's reductions issued
    inline in the backward, bit for bit (losses, grad norms, every param's
    checksum after each step). The same 4 ranks then run
    `ddl_sharded_smoke_phase`'s runs (one spawn for both: `_smoke_ranks`).
    -> (the one-rank reference, each rank's sharded-run results)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step, init_train_state
    tcfg = _ddl_config(0, (1, 1, 1), smoke=True, batch=DDL_SMOKE_BATCH, seq=DDL_SMOKE_SEQ)
    model = Model(tcfg.model)
    step = build_train_step(model, tcfg)
    state = init_train_state(model, tcfg, SEED, "cuda")
    reference = []
    for b in _ddl_batches(tcfg):
        state, met = step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        reference.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
    del state
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    both = spawn_ranks("_smoke_ranks", 4)
    ranks = [r["smoke"] for r in both]
    data = DDL_SMOKE_MESH[1]
    variants, checks, unchecked = {}, {}, set()
    for name, v in ranks[0].items():
        ov, c = "overlap=True" in name, "compress=True" in name
        slices = len(ddl_pod_hop_sizes(tcfg.model, data, overlap=ov)) * DDL_STEPS if c else 0
        err = [{k: abs(row[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for row, ref in zip(v["rows"], reference)]
        unchecked |= {_tuplify(sig) for r in ranks for sig in r[name]["signatures"]} - checked
        checks[name] = {
            "in_sync": all(all(r[name]["in_sync"]) for r in ranks),
            "same_metrics": all(r[name]["rows"] == v["rows"] for r in ranks),
            "loss": max(e["loss"] for e in err) <= 5e-3,
            "grad_norm": max(e["grad_norm"] for e in err) <= 2e-2,
            "launches": all(r[name]["quantize_launches"] == slices
                            and r[name]["dequantize_sum_launches"] == slices
                            and r[name]["dequantize_launches"] == 0 for r in ranks)}
        if ov:
            checks[name]["queued_equals_inline_bitwise"] = all(r[name]["inline_bitwise"]
                                                               for r in ranks)
        variants[name] = {"rows": v["rows"], "rel_err": err,
                          "quantize_launches": v["quantize_launches"],
                          "dequantize_launches": v["dequantize_launches"],
                          "dequantize_sum_launches": v["dequantize_sum_launches"]}
    ok = all(all(c.values()) for c in checks.values()) and not unchecked
    emit({"phase": "ddl_smoke_width", "arch": ARCH, "config": "smoke",
          "mesh": list(DDL_SMOKE_MESH), "ranks": 4, "backend": "gloo (host-staged)",
          "batch": DDL_SMOKE_BATCH, "seq": DDL_SMOKE_SEQ, "card": line,
          "reference": reference, "variants": variants, "checks": checks,
          "unchecked_shapes": sorted(map(str, unchecked)),
          "seconds": time.monotonic() - t0})
    if not ok:
        raise AssertionError("ddl (smoke width, 4 ranks): failed checks")
    return reference, [r["sharded"] for r in both]


def _smoke_ranks(rank: int, world: int):
    """One rank of the smoke-width phases, one spawn for both:
    `_ddl_smoke_rank`'s runs, then `_ddl_sharded_smoke_rank`'s."""
    return {"smoke": _ddl_smoke_rank(rank, world),
            "sharded": _ddl_sharded_smoke_rank(rank, world)}


# ---------------------------------------------------------------------------
# DDL's sharded paths: zero1, the sharded microbatch accumulator, LMS at m > 1
# ---------------------------------------------------------------------------

def _ddl_sharded_cases():
    """The full-width runs of ddl_sharded: name -> TrainConfig, in the
    order they run."""
    import dataclasses
    from repro_torch.config.base import DDLConfig, LMSConfig
    plan = LMSConfig(hbm_budget=DDL_SHARDED_BUDGET)
    one = dict(batch=TRAIN_BATCH, log_every=1)
    two = dict(batch=TRAIN_BATCH * DDL_SHARDED_MICROBATCHES, log_every=1,
               microbatches=DDL_SHARDED_MICROBATCHES)
    cases = {
        "i_allreduce": (_ddl_config(1, DDL_SHARDED_MESH, ddl=DDLConfig(), **one), None),
        "ii_zero1": (_ddl_config(1, DDL_SHARDED_MESH, ddl=DDLConfig(mode="zero1"), **one),
                     None),
        "iii_zero1_plan": (_ddl_config(1, DDL_SHARDED_MESH, ddl=DDLConfig(mode="zero1"),
                                       **one), plan),
        "iv_sharded_accumulator": (_ddl_config(1, DDL_SHARDED_MESH,
                                               ddl=DDLConfig(overlap_grads=True), **two), plan),
        "v_serialized_accumulator": (_ddl_config(1, DDL_SHARDED_MESH,
                                                 ddl=DDLConfig(overlap_grads=False), **two),
                                     plan)}
    return {name: dataclasses.replace(tcfg, total_steps=DDL_SHARDED_STEPS, warmup_steps=0,
                                      **({"lms": lms} if lms is not None else {}))
            for name, (tcfg, lms) in cases.items()}


def _sharded_train(tcfg, steps: int):
    """One rank's `Trainer` for `steps` steps: the state set up (timed),
    then each step's loss, grad norm, time, the params' checksums (and
    whether they agree across the ranks), RMSNorm's launches and the swap
    bytes, reset just before the step and read just after. -> (plan row,
    rows, facts): the optimizer's bytes on this rank, the flat layout's
    padded length (zero1), the peak and pinned bytes, the queue."""
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.train.steps import Zero1State
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    trainer = Trainer(tcfg, device="cuda")
    plan = trainer.plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    zero1 = isinstance(state, Zero1State)
    opt = ([state.mu, state.nu, state.master] if zero1 else
           [x for t in (state.opt.mu, state.opt.nu, state.opt.master) for x in tree_leaves(t)])
    opt_bytes = sum(t.numel() * t.element_size() for t in opt)
    opt_on_host = all(t.device.type == "cpu" for t in opt)
    del opt
    params = state.params
    sums = [_checksums(params)]
    in_sync = [_same_on_all_ranks(sums[0])]
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    launchers = _launchers()
    rows, before = [], [off.swap_counters()]

    def on_step(step, row):
        swap = _swap_per_step(before[0], off.swap_counters(), 1)
        before[0] = off.swap_counters()
        sums.append(_checksums(params))
        in_sync.append(_same_on_all_ranks(sums[-1]))
        rows.append({"step": step, "loss": row["loss"], "grad_norm": row["grad_norm"],
                     "time_s": row["time_s"], "checksums": sums[-1], "swap": swap,
                     "launches": {k: launchers[k].launches for k in
                                  ("quantize_rows", "dequantize_sum_rows", "rmsnorm")}})
        for launcher in launchers.values():
            launcher.launches = 0
    with launch_signatures() as (seen, calls, launches):
        state, _ = trainer.train(steps, on_step=on_step)
    layout = getattr(trainer.step_fn, "layout", None)
    facts = {"setup_s": setup_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "pinned_bytes": off.pinned_bytes(), "in_sync": in_sync,
             "init_checksums": sums[0], "signatures": sorted(seen),
             "opt_bytes": opt_bytes, "opt_on_host": opt_on_host,
             "padded": layout.padded if layout is not None else None,
             "layout": type(layout).__name__ if layout is not None else None,
             "queue": trainer.step_fn.queue is not None}
    del trainer, state, params, init
    off.release_arenas()
    torch.cuda.empty_cache()
    return _plan_row(plan), rows, facts


def _ddl_sharded_rank(rank: int, world: int):
    """One rank of ddl_sharded: a pinned arena reserved once, at the
    largest plan's state (`offload.reserve_pinned`), then every case of
    `_ddl_sharded_cases` in turn. -> {case: {plan, rows, facts}}."""
    from repro_torch.core.lms import offload as off
    t0 = time.monotonic()
    off.reserve_pinned(_lms_ddl_pinned_bytes(1), "cuda")
    out = {"rank": rank, "pinned": {"bytes": _lms_ddl_pinned_bytes(1),
                                    "seconds": time.monotonic() - t0}}
    for name, tcfg in _ddl_sharded_cases().items():
        plan, rows, facts = _sharded_train(tcfg, DDL_SHARDED_STEPS)
        out[name] = {"plan": plan, "rows": rows, **facts}
    out["tp"] = _tp_cases(rank, world)
    out["tp_serve"] = _tp_serve_cases(rank, world)
    return out


def ddl_sharded_phase(line, checked):
    """-> (the row, the tp phase's runs, the tp_serve runs): after their
    cases the same ranks run `_tp_cases` (the tp phase, `tp_phase`) and
    `_tp_serve_cases` (`tp_serve_phase`), warm and in the arena they
    reserved.

    DDL's sharded paths at qwen2.5-14b's full width cut to 1 layer
    (1.83 B params), `Trainer.train` for DDL_SHARDED_STEPS step(s) a run,
    at the peak lr, on
    2 ranks of a 1x2x1 mesh (2 data ranks on the one card over gloo), all
    from one seed, the runs one after another: (i) allreduce and (ii)
    zero1, resident, overlapped, 2 x 2048 tokens (a row a rank); (iii)
    zero1 under the plan of LMSConfig(hbm_budget=DDL_SHARDED_BUDGET), the
    same batches; (iv) LMS + DDL allreduce under that budget at m = 2, 4 x
    2048 tokens (two rows a rank, one a microbatch), overlapped (the
    sharded accumulator: the executor's queue adds each layer's slot), and
    (v) the same serialized (the full-tree f32 accumulator). A resident
    m = 2 run at this width does not fit two ranks on one card (replicated
    AdamW alone is 22 GB a rank): the CPU tests and lms_ab_microbatches
    hold it bitwise.

    Held: every rank's params bitwise equal after each step; step 1's loss
    bitwise equal across (i), (ii), (iii) and between (iv) and (v) (the
    forward depends on neither the optimizer nor the reduction); each
    step of (ii) within the JAX package's zero1 bounds of (i), and (iv) of
    (v) (tests/test_ddl_overlap.py: loss 2e-3, taken relative here at a
    loss of ~12, grad norm 2e-2 x (1 + grad norm)); (iii) bitwise (ii):
    losses, grad norms, every checksum; zero1's optimizer bytes a rank
    exactly 3 x 4 x padded / |data|; (ii)'s peak below (i)'s; RMSNorm 4L+1
    launches a step in (i) and (ii), m x the plan's implied count under a
    plan; finite losses; the params changed by the step in every run;
    every launch at a checked shape. Reported: each run's step times,
    peaks against its plan's, pinned bytes, swap bytes. Then waits until the host has the ranks' pinned memory back. -> the
    phase row."""
    import gc
    import types
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    avail = _meminfo()["MemAvailable"]
    t0 = time.monotonic()
    # (i) peaks at 37 GB a rank: two such ranks beside this process leave
    # no room on the card for the caching allocator's split blocks, so the
    # ranks map their memory in growable segments
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_ranks("_ddl_sharded_rank", DDL_SHARDED_MESH[1],
                            timeout=DDL_SHARDED_TIMEOUT_S)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    seconds = time.monotonic() - t0
    returned = _await_mem_available(avail - LMS_DDL_MEM_SLACK, LMS_DDL_MEM_WAIT_S)
    r0 = ranks[0]
    names = list(_ddl_sharded_cases())
    runs = {name: r0[name] for name in names}
    i, ii, iii, iv, v = (runs[n] for n in names)
    unchecked = {_tuplify(sig) for r in ranks for n in names
                 for sig in r[n]["signatures"]} - checked
    L = DDL_LAYERS
    m = DDL_SHARDED_MICROBATCHES

    def rms_expected(run, micro):
        if run["plan"] is None:
            return micro * (4 * L + 1)
        plan = types.SimpleNamespace(assignment=run["plan"]["assignment"])
        return micro * _implied_rmsnorm_launches(plan, L)

    def within(a, b):
        return all(abs(x["loss"] - y["loss"]) <= 2e-3 * abs(y["loss"])
                   and abs(x["grad_norm"] - y["grad_norm"]) <= 2e-2 * (1 + y["grad_norm"])
                   for x, y in zip(a["rows"], b["rows"]))
    peak = {n: max(r[n]["peak_bytes"] for r in ranks) for n in names}
    zero1_opt = 3 * 4 * ii["padded"] // DDL_SHARDED_MESH[1]
    checks = {
        "replicas_in_sync": all(all(r[n]["in_sync"]) and len(r[n]["in_sync"])
                                == DDL_SHARDED_STEPS + 1 for r in ranks for n in names),
        "step1_loss_bitwise_i_ii_iii": i["rows"][0]["loss"] == ii["rows"][0]["loss"]
        == iii["rows"][0]["loss"],
        "step1_loss_bitwise_iv_v": iv["rows"][0]["loss"] == v["rows"][0]["loss"],
        "ii_within_jax_bounds_of_i": within(ii, i),
        "iv_within_jax_bounds_of_v": within(iv, v),
        "iii_bitwise_ii": ([s["loss"] for s in iii["rows"]] == [s["loss"] for s in ii["rows"]]
                           and [s["grad_norm"] for s in iii["rows"]]
                           == [s["grad_norm"] for s in ii["rows"]]
                           and [iii["init_checksums"]] + [s["checksums"] for s in iii["rows"]]
                           == [ii["init_checksums"]] + [s["checksums"] for s in ii["rows"]]),
        "zero1_optimizer_bytes": all(r[n]["opt_bytes"] == zero1_opt and r[n]["padded"]
                                     == ii["padded"] for r in ranks
                                     for n in ("ii_zero1", "iii_zero1_plan")),
        "zero1_peak_below_allreduce": peak["ii_zero1"] < peak["i_allreduce"],
        "paths": (ii["layout"] == iii["layout"] == "ShardSpec" and i["queue"] and ii["queue"]
                  and iii["queue"] and iv["queue"] and not v["queue"]),
        "rmsnorm_launches": all(
            s["launches"]["rmsnorm"] == rms_expected(r[n], m if n.startswith(("iv", "v_")) else 1)
            for r in ranks for n in names for s in r[n]["rows"]),
        "no_pod_hop": all(s["launches"]["quantize_rows"] == 0
                          and s["launches"]["dequantize_sum_rows"] == 0
                          for r in ranks for n in names for s in r[n]["rows"]),
        "finite_losses": all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                             for run in runs.values() for s in run["rows"]),
        "params_updated": all(run["rows"][-1]["checksums"] != run["init_checksums"]
                              for run in runs.values()),
        "shapes_checked": not unchecked}

    def summary(name):
        run = runs[name]
        later = run["rows"][1:] or run["rows"]
        return {"loss": [s["loss"] for s in run["rows"]],
                "grad_norm": [s["grad_norm"] for s in run["rows"]],
                "step_s": [s["time_s"] for s in run["rows"]],
                "peak_bytes": [r[name]["peak_bytes"] for r in ranks],
                "plan_peak_bytes": run["plan"]["peak_bytes"] if run["plan"] else None,
                "plan_residency": run["plan"]["residency"] if run["plan"] else None,
                "plan_host_bytes": run["plan"]["host_bytes"] if run["plan"] else None,
                "pinned_bytes": run["pinned_bytes"], "opt_bytes": run["opt_bytes"],
                "opt_on_host": run["opt_on_host"], "layout": run["layout"],
                "padded": run["padded"], "queue": run["queue"], "setup_s": run["setup_s"],
                "rmsnorm_per_step": run["rows"][-1]["launches"]["rmsnorm"],
                "rmsnorm_expected": rms_expected(run, m if name.startswith(("iv", "v_"))
                                                 else 1),
                "swap_per_step": ({k: sum(s["swap"].get(k, 0) for s in later) / len(later)
                                   for k in later[0]["swap"]} if later else {})}
    row = {"phase": "ddl_sharded", "arch": ARCH, "layers": L, "mesh": list(DDL_SHARDED_MESH),
           "ranks": DDL_SHARDED_MESH[1], "backend": "gloo (host-staged)", "card": line,
           "steps": DDL_SHARDED_STEPS, "hbm_budget": DDL_SHARDED_BUDGET, "microbatches": m,
           "note": "two ranks time-slice one card over gloo: not DDL's speed across cards",
           "zero1_opt_bytes_expected": zero1_opt,
           "runs": {n: summary(n) for n in names}, "peak_bytes": peak,
           "arena": [r["pinned"] for r in ranks], "mem_available_before": avail,
           "mem_available_returning": returned, "seconds": seconds, "checks": checks,
           "unchecked_shapes": sorted(map(str, unchecked))}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"ddl_sharded: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row, [r["tp"] for r in ranks], [r["tp_serve"] for r in ranks]


def _ddl_sharded_smoke_rank(rank: int, world: int):
    """One rank of ddl_sharded_smoke on the 2x2x1 mesh: zero1 and m = 2,
    each overlapped and serialized, compress_dcn, DDL_STEPS steps from one
    seed on this rank's rows; each step's loss and grad norm, replicas'
    checksums, the int8 kernels' launches over the run."""
    import dataclasses
    import torch
    from repro_torch.config.base import DDLConfig
    from repro_torch.data import local_rows
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train.steps import (build_train_step, build_zero1_train_step,
                                         init_train_state, init_zero1_state)
    tcfg0 = _ddl_config(0, DDL_SMOKE_MESH, smoke=True, batch=DDL_SMOKE_BATCH,
                        seq=DDL_SMOKE_SEQ)
    mesh = make_mesh(tcfg0.mesh)
    out = {}
    for zero1 in (True, False):
        for ov in (True, False):
            ddl = DDLConfig(mode="zero1" if zero1 else "allreduce", compress_dcn=True,
                            overlap_grads=ov)
            tcfg = dataclasses.replace(tcfg0, ddl=ddl,
                                       microbatches=1 if zero1 else DDL_SHARDED_MICROBATCHES)
            model = Model(tcfg.model)
            if zero1:
                step = build_zero1_train_step(model, tcfg, mesh=mesh)
                state = init_zero1_state(model, tcfg, SEED, "cuda", mesh.size("data"),
                                         data_index=mesh.index("data"))
            else:
                step = build_train_step(model, tcfg, mesh=mesh)
                state = init_train_state(model, tcfg, SEED, "cuda")
            rows, in_sync = [], [_same_on_all_ranks(_checksums(state.params))]
            with launch_signatures() as (seen, calls, launches):
                for b in _ddl_batches(tcfg):
                    local = local_rows(b, mesh.dp_index, mesh.dp_size)
                    state, met = step(state, {k: torch.from_numpy(v).cuda()
                                              for k, v in local.items()})
                    rows.append({"loss": float(met["loss"]),
                                 "grad_norm": float(met["grad_norm"])})
                    in_sync.append(_same_on_all_ranks(_checksums(state.params)))
            out[f"{'zero1' if zero1 else 'microbatches_2'},overlap={ov}"] = {
                "rows": rows, "in_sync": in_sync, "signatures": sorted(seen),
                "quantize_calls": calls["quantize_rows"],
                "dequantize_sum_calls": calls["dequantize_sum_rows"],
                "quantize_launches": launches["quantize_rows"],
                "dequantize_launches": launches["dequantize_rows"],
                "dequantize_sum_launches": launches["dequantize_sum_rows"]}
    return out


def ddl_sharded_smoke_phase(line, checked, reference, ranks):
    """zero1 and the microbatch accumulator (m = 2) with |data| = 2 and the
    int8 pod hop: 4 ranks on a 2x2x1 mesh at the qwen2.5-14b smoke config,
    compress_dcn, each overlapped and serialized, DDL_STEPS steps each from one
    seed, against one rank on the global batch from the same init
    (`reference`, ddl_smoke_phase's: the replicated step at m = 1; zero1's
    update is AdamW's, and the mean over 2 microbatches of a row is the
    mean over the rows). Tolerance, ddl_smoke_phase's, stated before its
    first run: loss within 5e-3 relative, grad norm within 2e-2. Replicas
    bitwise in sync; the quantizer and the pod sum launched once for each
    compressed slice `ddl_sharded_pod_hop_sizes` gives, no dequantize.
    `ranks`: each rank's results, run in ddl_smoke_phase's spawn. -> the
    phase row."""
    t0 = time.monotonic()
    data = DDL_SMOKE_MESH[1]
    tcfg = _ddl_config(0, (1, 1, 1), smoke=True, batch=DDL_SMOKE_BATCH, seq=DDL_SMOKE_SEQ)
    variants, checks, unchecked = {}, {}, set()
    for name, v in ranks[0].items():
        zero1, ov = name.startswith("zero1"), "overlap=True" in name
        slices = len(ddl_sharded_pod_hop_sizes(tcfg.model, data, zero1=zero1,
                                               overlap=ov)) * DDL_STEPS
        err = [{k: abs(row[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for row, ref in zip(v["rows"], reference)]
        unchecked |= {_tuplify(sig) for r in ranks for sig in r[name]["signatures"]} - checked
        checks[name] = {
            "in_sync": all(all(r[name]["in_sync"]) for r in ranks),
            "same_metrics": all(r[name]["rows"] == v["rows"] for r in ranks),
            "loss": max(e["loss"] for e in err) <= 5e-3,
            "grad_norm": max(e["grad_norm"] for e in err) <= 2e-2,
            "launches": all(r[name]["quantize_launches"] == r[name]["quantize_calls"] == slices
                            and r[name]["dequantize_sum_launches"]
                            == r[name]["dequantize_sum_calls"] == slices
                            and r[name]["dequantize_launches"] == 0 for r in ranks)}
        variants[name] = {"rows": v["rows"], "rel_err": err, "expected_slices": slices,
                          "quantize_launches": v["quantize_launches"],
                          "dequantize_launches": v["dequantize_launches"],
                          "dequantize_sum_launches": v["dequantize_sum_launches"]}
    ok = all(all(c.values()) for c in checks.values()) and not unchecked
    emit({"phase": "ddl_sharded_smoke", "arch": ARCH, "config": "smoke",
          "mesh": list(DDL_SMOKE_MESH), "ranks": 4, "backend": "gloo (host-staged)",
          "batch": DDL_SMOKE_BATCH, "seq": DDL_SMOKE_SEQ, "card": line,
          "reference": reference, "variants": variants, "checks": checks,
          "unchecked_shapes": sorted(map(str, unchecked)),
          "seconds": time.monotonic() - t0})
    if not ok:
        raise AssertionError(f"ddl_sharded_smoke: failed checks "
                             f"{[(n, k) for n, c in checks.items() for k, x in c.items() if not x]}"
                             f", unchecked shapes {sorted(map(str, unchecked))}")


# ---------------------------------------------------------------------------
# LMS + DDL: layer-streamed training on 2 ranks, grads reduced in the backward
# ---------------------------------------------------------------------------

def _lms_ddl_config(layers: int, overlap=None, mesh=DDL_MESH, batch: int = TRAIN_BATCH):
    """`_ddl_config`'s qwen2.5-14b at full width cut to `layers` on `mesh`
    (the 2x1x1 one by default) with compress_dcn, `batch` x TRAIN_SEQ
    tokens a step, under LMS at LMS_DDL_BUDGET; overlap:
    DDLConfig.overlap_grads (None: the plan's recommendation)."""
    import dataclasses
    from repro_torch.config.base import DDLConfig, LMSConfig
    tcfg = _ddl_config(layers, mesh, ddl=DDLConfig(compress_dcn=True, overlap_grads=overlap),
                       batch=batch, log_every=1)
    return dataclasses.replace(tcfg, lms=LMSConfig(hbm_budget=LMS_DDL_BUDGET))


def _lms_ddl_pinned_bytes(layers: int) -> int:
    """A rank's pinned state at `layers` layers under a plan with params,
    grads and the AdamW state on the host (`train.steps._state_layout`)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=layers))
    paths = [(path, d.shape, DTYPES[d.dtype])
             for path, d in steps_mod._def_paths(model.param_defs())]
    return steps_mod._state_layout(paths, "adamw", True, True, grads_host=True)[0]


def _lms_ddl_train(tcfg, steps: int, *, pod_hops=None):
    """One rank's `Trainer` under its plan for `steps` steps: the state set
    up first (timed), then each step's loss, grad norm, time, the params'
    checksums (and whether they agree across the ranks), the kernels'
    launches, the swap bytes by class, the reduction queue's times and the
    tree pass's (CUDA-synced wall time), all reset just before the step and
    read just after. `pod_hops`: a list the pod hop's calls are recorded
    into (thread, stream). -> (plan row, setup, rows, facts)."""
    import threading
    import torch
    from repro_torch.core.ddl import allreduce
    from repro_torch.core.lms import offload as off
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(tcfg, device="cuda")
    plan = trainer.plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    params = state.params
    sums = [_checksums(params)]
    in_sync = [_same_on_all_ranks(sums[0])]
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    queue = trainer.step_fn.queue
    tree = steps_mod.ddl_reduce_tree
    hop = allreduce.compressed_allreduce_pod
    tree_s = [0.0]

    def tree_timed(*a, **k):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = tree(*a, **k)
        torch.cuda.synchronize()
        tree_s[0] += time.monotonic() - t
        return out

    def hop_seen(x, axis, **k):
        pod_hops.append((threading.current_thread().name,
                         torch.cuda.current_stream().cuda_stream))
        return hop(x, axis, **k)
    steps_mod.ddl_reduce_tree = tree_timed
    if pod_hops is not None:
        allreduce.compressed_allreduce_pod = hop_seen
    rows, before = [], [off.swap_counters()]
    launchers = _launchers()

    def on_step(step, row):
        swap = _swap_per_step(before[0], off.swap_counters(), 1)
        before[0] = off.swap_counters()
        sums.append(_checksums(params))
        in_sync.append(_same_on_all_ranks(sums[-1]))
        rows.append({"step": step, "loss": row["loss"], "grad_norm": row["grad_norm"],
                     "time_s": row["time_s"], "checksums": sums[-1],
                     "launches": {k: launchers[k].launches for k in
                                  ("quantize_rows", "dequantize_rows", "dequantize_sum_rows",
                                   "rmsnorm")},
                     "swap": swap, "tree_pass_s": tree_s[0],
                     "queue_reduce_s": queue.reduce_s if queue else None,
                     "queue_under_backward_s": queue.under_backward_s if queue else None,
                     "queue_drain_wait_s": queue.drain_wait_s if queue else None})
        for launcher in launchers.values():
            launcher.launches = 0
        tree_s[0] = 0.0
    try:
        with launch_signatures() as (seen, calls, launches):
            state, _ = trainer.train(steps, on_step=on_step)
    finally:
        steps_mod.ddl_reduce_tree = tree
        allreduce.compressed_allreduce_pod = hop
    facts = {"setup_s": setup_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "pinned_bytes": off.pinned_bytes(), "in_sync": in_sync,
             "init_checksums": sums[0],
             "signatures": sorted(seen), "overlap": queue is not None,
             "grads_sunk": state.grads is not None}
    del trainer, state, params, init
    torch.cuda.empty_cache()
    return _plan_row(plan), rows, facts


def _lms_ddl_rank(rank: int, world: int, layers: int):
    """One rank of lms_ddl: its pinned arena reserved once, at the deeper
    run's state (`offload.reserve_pinned`), then (a) LMS_DDL_LAYERS_A
    layer(s) for DDL_STEPS steps, the pod hop's calls recorded; then (b)
    `layers` layers for LMS_DDL_STEPS_B steps with the plan's overlapped backward
    and again with DDLConfig(overlap_grads=False), each state placed in the
    same arena. -> {"a", "b_overlapped", "b_serialized", "pinned"}."""
    import torch
    from repro_torch.core.ddl import overlap
    from repro_torch.core.lms import offload as off
    t0 = time.monotonic()
    off.reserve_pinned(_lms_ddl_pinned_bytes(max(layers, LMS_DDL_LAYERS_A)), "cuda")
    pinned = {"bytes": _lms_ddl_pinned_bytes(max(layers, LMS_DDL_LAYERS_A)),
              "seconds": time.monotonic() - t0}
    out = {"rank": rank, "pinned": pinned}
    hops = []
    plan, rows, facts = _lms_ddl_train(_lms_ddl_config(LMS_DDL_LAYERS_A), DDL_STEPS,
                                       pod_hops=hops)
    worker = overlap.worker_stream("cuda").cuda_stream
    default = torch.cuda.default_stream().cuda_stream
    off.release_arenas()
    out["a"] = {"plan": plan, "rows": rows, **facts,
                "pod_hops_in_worker": sum(t == "ddl-reduce" for t, _ in hops),
                "pod_hops_in_main": sum(t != "ddl-reduce" for t, _ in hops),
                "worker_hops_on_worker_stream": all(st == worker for t, st in hops
                                                    if t == "ddl-reduce"),
                "main_hops_on_default_stream": all(st == default for t, st in hops
                                                   if t != "ddl-reduce")}
    for name, ov in (("b_overlapped", None), ("b_serialized", False)):
        plan, rows, facts = _lms_ddl_train(_lms_ddl_config(layers, ov), LMS_DDL_STEPS_B)
        off.release_arenas()
        out[name] = {"plan": plan, "rows": rows, **facts}
    return out


def _await_mem_available(target: int, timeout_s: float) -> list:
    """Read MemAvailable every second until it reaches `target` bytes or
    `timeout_s` passes. -> [(seconds since the call, MemAvailable)], the
    first reading and every one after."""
    t0 = time.monotonic()
    seen = []
    while True:
        avail = _meminfo()["MemAvailable"]
        seen.append((time.monotonic() - t0, avail))
        if avail >= target or seen[-1][0] > timeout_s:
            return seen
        time.sleep(1.0)


def _steady(rows, key):
    vals = [r[key] for r in rows[1:]]
    return sum(vals) / len(vals) if vals else None


def lms_ddl_phase(line, checked, ddl_row):
    """LMS + DDL: qwen2.5-14b at full width on 2 ranks of the 2x1x1 mesh
    (gloo, both on the one card) with compress_dcn, 2 x 2048 tokens a step
    (a row a rank), under the plan of LMSConfig(hbm_budget=LMS_DDL_BUDGET):
    params, grads and the AdamW state in pinned host memory, each layer's
    grads reduced by the DDL hook's queue on its own thread and stream
    while the backward goes on, and sunk into pinned host memory.

    (a) LMS_DDL_LAYERS_A layer, DDL_STEPS steps, against ddl_phase's
    resident run of the same config (overlapped, compress_dcn): each
    step's loss, grad norm and every param leaf's checksum bitwise equal;
    the pod hop's 115 quantize and 115 pod-sum launches a step and no
    dequantize; the RMSNorm launches `_implied_rmsnorm_launches` gives for
    the plan; the stack's pod hops on the queue's thread and stream;
    replicas in sync after every step.

    (b) the most layers of LMS_DDL_DEPTHS whose two ranks' pinned state
    fits LMS_HOST_SHARE of MemAvailable: LMS_DDL_STEPS_B steps with the plan's
    overlapped backward (grads sunk), then, on the same ranks and arena,
    DDLConfig(overlap_grads=False) (planned again: the planner does not
    read that knob, so the grads stay on the card through the backward and
    the tree pass and are placed on the host after it). Reported: step time
    and tokens/s of both; the reduction's wall time and how much of it lay
    under the backward; swap bytes a step by class against the plan's;
    each rank's peak against the plan's; pinned bytes against the plan's
    host bytes; MemAvailable before the ranks start, after they exit, and
    each second until it is back within LMS_DDL_MEM_SLACK of where it
    started (the host hands the ranks' pinned memory back over seconds;
    the phase waits up to LMS_DDL_MEM_WAIT_S, so the LMS phases after it
    size themselves from the whole host). Held: replicas bitwise in sync; finite losses; step 1's loss equal
    across the runs; later steps within 2e-3 relative. -> the phase row."""
    import ctypes
    import gc
    import types
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    mem_before = _mem_row()
    avail = mem_before["MemAvailable"]
    fit = [L for L in LMS_DDL_DEPTHS
           if 2 * _lms_ddl_pinned_bytes(L) <= LMS_HOST_SHARE * avail]
    if not fit:
        raise AssertionError(f"lms_ddl: MemAvailable {avail} B holds no depth of "
                             f"{LMS_DDL_DEPTHS} for two ranks' pinned state")
    L = max(fit)
    cfg_a = _lms_ddl_config(LMS_DDL_LAYERS_A).model
    slices = len(ddl_pod_hop_sizes(cfg_a, DDL_MESH[1], overlap=True))
    t0 = time.monotonic()
    ranks = spawn_ranks("_lms_ddl_rank", DDL_MESH[0], L, timeout=LMS_DDL_TIMEOUT_S)
    seconds = time.monotonic() - t0
    gc.collect()
    mem_after = _mem_row()
    returned = _await_mem_available(avail - LMS_DDL_MEM_SLACK, LMS_DDL_MEM_WAIT_S)
    r0 = ranks[0]
    a = r0["a"]
    unchecked = {_tuplify(sig) for r in ranks for run in ("a", "b_overlapped", "b_serialized")
                 for sig in r[run]["signatures"]} - checked
    res = ddl_row["steps"]
    implied = _implied_rmsnorm_launches(types.SimpleNamespace(assignment=a["plan"]["assignment"]),
                                        LMS_DDL_LAYERS_A)
    b_ov, b_ser = r0["b_overlapped"], r0["b_serialized"]
    checks = {
        "a_plan_all_on_host": all(a["plan"]["residency"][k] == "host"
                                  for k in ("params", "grads", "optimizer")),
        "a_overlapped_and_sunk": a["overlap"] and a["grads_sunk"],
        "a_losses_bitwise": [s["loss"] for s in a["rows"]] == [s["loss"] for s in res],
        "a_grad_norms_bitwise": [s["grad_norm"] for s in a["rows"]]
        == [s["grad_norm"] for s in res],
        "a_checksums_bitwise": [a["init_checksums"]] + [s["checksums"] for s in a["rows"]]
        == ddl_row["checksums"],
        "a_launches": all(s["launches"]["quantize_rows"] == slices
                          and s["launches"]["dequantize_sum_rows"] == slices
                          and s["launches"]["dequantize_rows"] == 0
                          and s["launches"]["rmsnorm"] == implied
                          for r in ranks for s in r["a"]["rows"]),
        "a_pod_hops_on_the_queue_stream": all(
            r["a"]["worker_hops_on_worker_stream"] and r["a"]["main_hops_on_default_stream"]
            and r["a"]["pod_hops_in_worker"] > 0 and r["a"]["pod_hops_in_main"] > 0
            for r in ranks),
        "replicas_in_sync": all(all(r[run]["in_sync"]) and len(r[run]["in_sync"]) == steps + 1
                                for r in ranks for run, steps in (
                                    ("a", DDL_STEPS), ("b_overlapped", LMS_DDL_STEPS_B),
                                    ("b_serialized", LMS_DDL_STEPS_B))),
        "finite_losses": all(math.isfinite(s["loss"]) for run in (a, b_ov, b_ser)
                             for s in run["rows"]),
        "b_overlapped_sunk_serialized_not": (b_ov["overlap"] and b_ov["grads_sunk"]
                                             and not b_ser["overlap"]),
        "b_step1_loss_equal": b_ov["rows"][0]["loss"] == b_ser["rows"][0]["loss"],
        "b_later_losses_within_2e-3": all(
            abs(x["loss"] - y["loss"]) <= 2e-3 * abs(y["loss"])
            for x, y in zip(b_ov["rows"][1:], b_ser["rows"][1:])),
        "shapes_checked": not unchecked}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def summary(name):
        """Run `name` of rank 0 (its peaks from both ranks): the steady
        steps' means (after step 1)."""
        run = r0[name]
        later = run["rows"][1:]
        step_s = _steady(run["rows"], "time_s")
        queue = ("queue_reduce_s", "queue_under_backward_s", "queue_drain_wait_s")
        return {"layers": L, "step_s_steady": step_s, "tokens_per_s": tokens / step_s,
                "step_s": [r["time_s"] for r in run["rows"]],
                "loss": [r["loss"] for r in run["rows"]],
                "grad_norm": [r["grad_norm"] for r in run["rows"]],
                **{k: _steady(run["rows"], k) if run["overlap"] else None for k in queue},
                "tree_pass_s": _steady(run["rows"], "tree_pass_s"),
                "swap_per_step": {k: sum(r["swap"].get(k, 0) for r in later) / len(later)
                                  for k in later[0]["swap"]},
                "plan_swap_bytes": run["plan"]["swap_bytes"],
                "plan_swap_bytes_per_step": run["plan"]["swap_bytes_per_step"],
                "peak_bytes": [r[name]["peak_bytes"] for r in ranks],
                "plan_peak_bytes": run["plan"]["peak_bytes"],
                "pinned_bytes": run["pinned_bytes"], "plan_host_bytes": run["plan"]["host_bytes"],
                "setup_s": run["setup_s"], "residency": run["plan"]["residency"],
                "launches": run["rows"][-1]["launches"], "plan_summary": run["plan"]["summary"]}
    row = {"phase": "lms_ddl", "arch": ARCH, "mesh": list(DDL_MESH), "ranks": DDL_MESH[0],
           "backend": "gloo (host-staged, pinned)", "compress_dcn": True,
           "hbm_budget": LMS_DDL_BUDGET, "tokens_per_step": tokens, "card": line,
           "note": "two ranks time-slice one card over gloo: not DDL's speed across cards",
           "a": {"layers": LMS_DDL_LAYERS_A, "rows": [{k: v for k, v in s.items()
                                                       if k != "checksums"} for s in a["rows"]],
                 "ddl_phase_losses": [s["loss"] for s in res],
                 "implied_rmsnorm_launches": implied, "expected_slices": slices,
                 "pod_hops_in_worker": a["pod_hops_in_worker"],
                 "pod_hops_in_main": a["pod_hops_in_main"],
                 "peak_bytes": [r["a"]["peak_bytes"] for r in ranks],
                 "pinned_bytes": a["pinned_bytes"], "plan": a["plan"]},
           "b_layers": L, "b_fit": fit,
           "b_overlapped": summary("b_overlapped"), "b_serialized": summary("b_serialized"),
           "arena": [r["pinned"] for r in ranks],
           "mem_available_before": avail, "mem_available_after": mem_after["MemAvailable"],
           "meminfo_before": mem_before, "meminfo_after": mem_after,
           "mem_available_returning": returned,
           "seconds": seconds, "checks": checks,
           "unchecked_shapes": sorted(map(str, unchecked))}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"lms_ddl: failed checks {[k for k, v in checks.items() if not v]}")
    return row



# ---------------------------------------------------------------------------
# LMS: training beyond the card's memory on one card
# ---------------------------------------------------------------------------

def _meminfo() -> dict:
    """/proc/meminfo in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for row in f:
            key, val = row.split(":", 1)
            parts = val.split()
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


MEMINFO_KEYS = ("MemTotal", "MemFree", "MemAvailable", "Cached", "Shmem", "AnonPages",
                "Mlocked", "Unevictable")


def _mem_row() -> dict:
    """The /proc/meminfo fields of MEMINFO_KEYS, in bytes."""
    mem = _meminfo()
    return {k: mem.get(k) for k in MEMINFO_KEYS}


def host_phase(line):
    """The host: MemTotal and MemAvailable, and the achieved pinned copy
    rate between host and card, HOST_COPY_BYTES each way, host to device,
    device to host, and both at once (each on a stream of its own), timed
    with CUDA events, the median of HOST_COPY_REPS: the link rate swap
    time is held against (`hw.host_bw`, 64 GB/s a direction, is a data
    sheet's figure). -> the phase row."""
    import ctypes
    import gc
    import statistics
    import torch
    # what the earlier phases freed, handed back first: Python's cycles,
    # the card's cached blocks, and the C heap's free pages (glibc keeps
    # freed blocks under its mmap threshold in the heap until trimmed)
    anon_before = _meminfo().get("AnonPages")
    gc.collect()
    torch.cuda.empty_cache()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    mem = _meminfo()
    n = HOST_COPY_BYTES
    host = [torch.empty(n, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    dev = [torch.empty(n, dtype=torch.uint8, device="cuda") for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]

    def timed(copies):
        """Seconds from a start event all streams wait on to the last end."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        ends = []
        for stream, fn in zip(streams, copies):
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                fn()
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                ends.append(end)
        torch.cuda.synchronize()
        return max(start.elapsed_time(e) for e in ends) / 1e3

    def h2d():
        dev[0].copy_(host[0], non_blocking=True)

    def d2h():
        host[1].copy_(dev[1], non_blocking=True)
    rates = {}
    for name, copies, nbytes in (("h2d", [h2d], n), ("d2h", [d2h], n),
                                 ("both", [h2d, d2h], 2 * n)):
        timed(copies)
        secs = [timed(copies) for _ in range(HOST_COPY_REPS)]
        rates[name] = {"bytes": nbytes, "seconds": secs,
                       "gb_s": nbytes / statistics.median(secs) / 1e9}
    row = {"phase": "host", "card": line, "meminfo": {k: mem.get(k) for k in MEMINFO_KEYS},
           "anon_pages_before_trim": anon_before,
           "mem_total_bytes": mem["MemTotal"],
           "mem_available_bytes": mem["MemAvailable"], "copy_bytes": n,
           "h2d_gb_s": rates["h2d"]["gb_s"], "d2h_gb_s": rates["d2h"]["gb_s"],
           "both_gb_s": rates["both"]["gb_s"], "rates": rates,
           "hw_host_bw_gb_s": 64.0}
    emit(row)
    del host, dev
    return row


def _swap_per_step(before: dict, after: dict, steps: int) -> dict:
    """{counter: (after - before) / steps} of the `lms.swap_*` counters."""
    return {k: (v - before.get(k, 0)) / steps for k, v in sorted(after.items())}


def _implied_rmsnorm_launches(plan, layers: int) -> int:
    """RMSNorm launches a step the plan's assignment implies: 2L+1 in the
    forward (two a layer and the final norm), and in the backward's replay
    one a layer for each of attn_norm and mlp_norm the plan rematerializes
    (a saved or offloaded norm output is not recomputed); 4L+1 without a
    plan (every layer recomputed whole)."""
    if plan is None:
        return 4 * layers + 1
    remat = sum(plan.assignment.get(n, "remat") == "remat" for n in ("attn_norm", "mlp_norm"))
    return 2 * layers + 1 + remat * layers


def _lms_run(tcfg, steps: int, profile=None):
    """A `Trainer` on the card for `steps` steps from its seed, the state
    set up (placed as its plan says) and timed first; counts reset just
    before the steps and read just after. -> (trainer, final state,
    history, facts)."""
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(tcfg, device="cuda", profile=profile)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    init = [state]
    trainer.init_state = lambda: init.pop()
    before = off.swap_counters()
    t1 = time.monotonic()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=steps)
    run_s = time.monotonic() - t1
    facts = {"setup_s": setup_s, "run_s": run_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "pinned_bytes": off.pinned_bytes(),
             "swap_per_step": _swap_per_step(before, off.swap_counters(), steps),
             "seen": seen, "calls": calls, "launches": launches}
    return trainer, state, hist, facts


def _plan_row(plan) -> dict:
    if plan is None:
        return None
    return {"peak_bytes": plan.peak_bytes, "budget": plan.budget, "fits": plan.fits,
            "host_bytes": plan.host_bytes, "swap_bytes_per_step": plan.swap_bytes_per_step,
            "swap_bytes": dict(plan.swap_schedule.swap_bytes) if plan.swap_schedule else {},
            "residency": plan.residency, "assignment": plan.assignment,
            "prefetch_depth": plan.swap_schedule.prefetch_depth if plan.swap_schedule else None,
            "summary": plan.summary()}


def lms_ab_phase(line, checked):
    """LMS against resident at qwen2.5-14b's full width cut to
    LMS_AB_LAYERS layers, 2 x 2048 tokens a step, LMS_STEPS steps of
    `Trainer.train` from one seed: first under the plan of
    LMSConfig(hbm_budget=LMS_AB_BUDGET) (params and optimizer state in
    pinned host memory, streamed; resid, attn_norm, qkv, attn_out and
    mlp_norm offloaded, mlp_hidden recomputed), then resident
    (LMSConfig(enabled=False)). Held: every step's loss and grad norm and
    every param after the last step bitwise equal; finite losses; the
    RMSNorm launches a step the plan's assignment implies
    (`_implied_rmsnorm_launches`) and none of another kernel. Reported:
    both step times (median after step 1) and their ratio, LMS's overhead
    at this size; the swap counters a step by class against the plan's
    `swap_schedule.swap_bytes`; the measured peak against the plan's.
    -> the phase row."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.tree import tree_leaves
    L, n = LMS_AB_LAYERS, LMS_STEPS
    base = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n)
    runs, params = {}, {}
    for name, lms in (("streamed", LMSConfig(hbm_budget=LMS_AB_BUDGET)),
                      ("resident", LMSConfig(enabled=False))):
        trainer, state, hist, facts = _lms_run(dataclasses.replace(base, lms=lms), n)
        plan = trainer.plan
        # kept where they lie (the stack in pinned host memory, the rest on
        # the card) and compared leaf by leaf on the card
        params[name] = tree_leaves(state.params)
        unchecked = sorted(facts["seen"] - checked)
        launches = facts["launches"]
        runs[name] = {
            "plan": _plan_row(plan), "loss": [r["loss"] for r in hist],
            "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
            "median_step_s_after_1": statistics.median(r["time_s"] for r in hist[1:]),
            "setup_s": facts["setup_s"], "max_memory_allocated_bytes": facts["peak_bytes"],
            "pinned_bytes": facts["pinned_bytes"], "swap_per_step": facts["swap_per_step"],
            "rmsnorm_launches_per_step": launches["rmsnorm"] / n,
            "implied_rmsnorm_launches_per_step": _implied_rmsnorm_launches(plan, L),
            "launches": launches, "unchecked_signatures": unchecked,
            "checks": {"finite": all(math.isfinite(r["loss"]) for r in hist),
                       "rmsnorm_launches_as_the_plan_implies":
                           launches["rmsnorm"] == n * _implied_rmsnorm_launches(plan, L),
                       "no_other_launches": all(v == 0 for k, v in launches.items()
                                                if not k.startswith("rmsnorm")),
                       "every_launch_recorded": facts["calls"] == launches,
                       "every_launch_shape_checked": not unchecked}}
        del trainer, state, hist
        torch.cuda.empty_cache()
    s, r = runs["streamed"], runs["resident"]
    same_params = [torch.equal(a.to(b.device), b)
                   for a, b in zip(params["streamed"], params["resident"])]
    del params
    off.release_arenas()
    swap = s["swap_per_step"]
    plan = s["plan"]
    checks = {**{f"streamed_{k}": v for k, v in s["checks"].items()},
              **{f"resident_{k}": v for k, v in r["checks"].items()},
              "plan_streams_params_and_optimizer":
                  set(plan["swap_bytes"]) == {"params", "optimizer"},
              "loss_bitwise": s["loss"] == r["loss"],
              "grad_norm_bitwise": s["grad_norm"] == r["grad_norm"],
              "params_bitwise": all(same_params)}
    row = {"phase": "lms_ab", "arch": ARCH, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": n, "card": line, "hbm_budget": LMS_AB_BUDGET,
           "streamed": s, "resident": r,
           "overhead": s["median_step_s_after_1"] / r["median_step_s_after_1"] - 1,
           "params_unequal": [i for i, ok in enumerate(same_params) if not ok],
           "swap_vs_plan": {
               "params_in_per_step": swap.get("lms.swap_in_bytes.params", 0),
               "params_out_per_step": swap.get("lms.swap_out_bytes.params", 0),
               "params_priced": plan["swap_bytes"].get("params"),
               "optimizer_in_out_per_step": swap.get("lms.swap_in_bytes.optimizer", 0)
               + swap.get("lms.swap_out_bytes.optimizer", 0),
               "optimizer_priced": plan["swap_bytes"].get("optimizer"),
               "activations_in_out_per_step": swap.get("lms.swap_in_bytes.activations", 0)
               + swap.get("lms.swap_out_bytes.activations", 0)},
           "peak_vs_plan": {"measured": s["max_memory_allocated_bytes"],
                            "plan": plan["peak_bytes"],
                            "delta": s["max_memory_allocated_bytes"] - plan["peak_bytes"]},
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"lms_ab: failed checks {[k for k, v in checks.items() if not v]}")
    return row


def lms_ab_microbatches_phase(line, checked, ab_row):
    """LMS with microbatches against resident on one card: lms_ab's
    qwen2.5-14b at full width cut to LMS_AB_LAYERS layers, 2 x 2048 tokens
    a step in DDL_SHARDED_MICROBATCHES microbatches of a row, LMS_STEPS
    steps of `Trainer.train` from one seed: under the plan of
    LMSConfig(hbm_budget=LMS_AB_BUDGET) at m = 2 (the executor once a
    microbatch, its stack grads added into the f32 accumulator on the
    card), then resident at m = 2. Held: every step's loss and grad norm
    and every param after the last step bitwise equal; finite losses;
    RMSNorm m x the plan's implied launches a step, m x (4L+1) resident.
    Reported: both step times, the params' swap-in bytes a step against m
    x lms_ab's (m = 1) less the embedding rows of m - 1 batches (they come
    in once a token), and against the plan's, both peaks against the
    plan's. -> the phase row."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.tree import tree_leaves
    L, n, m = LMS_AB_LAYERS, LMS_STEPS, DDL_SHARDED_MICROBATCHES
    base = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n,
                         microbatches=m)
    runs, params = {}, {}
    for name, lms in (("streamed", LMSConfig(hbm_budget=LMS_AB_BUDGET)),
                      ("resident", LMSConfig(enabled=False))):
        trainer, state, hist, facts = _lms_run(dataclasses.replace(base, lms=lms), n)
        plan = trainer.plan
        params[name] = tree_leaves(state.params)
        unchecked = sorted(facts["seen"] - checked)
        launches = facts["launches"]
        implied = m * _implied_rmsnorm_launches(plan, L)
        runs[name] = {
            "plan": _plan_row(plan), "loss": [r["loss"] for r in hist],
            "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
            "median_step_s_after_1": statistics.median(r["time_s"] for r in hist[1:]),
            "setup_s": facts["setup_s"], "max_memory_allocated_bytes": facts["peak_bytes"],
            "pinned_bytes": facts["pinned_bytes"], "swap_per_step": facts["swap_per_step"],
            "rmsnorm_launches_per_step": launches["rmsnorm"] / n,
            "implied_rmsnorm_launches_per_step": implied,
            "unchecked_signatures": unchecked,
            "checks": {"finite": all(math.isfinite(r["loss"]) for r in hist),
                       "rmsnorm_launches_as_the_plan_implies": launches["rmsnorm"] == n * implied,
                       "no_other_launches": all(v == 0 for k, v in launches.items()
                                                if not k.startswith("rmsnorm")),
                       "every_launch_recorded": facts["calls"] == launches,
                       "every_launch_shape_checked": not unchecked}}
        del trainer, state, hist
        torch.cuda.empty_cache()
    s, r = runs["streamed"], runs["resident"]
    same_params = [torch.equal(a.to(b.device), b)
                   for a, b in zip(params["streamed"], params["resident"])]
    del params
    off.release_arenas()
    params_in = s["swap_per_step"].get("lms.swap_in_bytes.params", 0)
    params_in_m1 = ab_row["streamed"]["swap_per_step"].get("lms.swap_in_bytes.params", 0)
    checks = {**{f"streamed_{k}": v for k, v in s["checks"].items()},
              **{f"resident_{k}": v for k, v in r["checks"].items()},
              "plan_streams_params": "params" in s["plan"]["swap_bytes"],
              "loss_bitwise": s["loss"] == r["loss"],
              "grad_norm_bitwise": s["grad_norm"] == r["grad_norm"],
              "params_bitwise": all(same_params),
              # the stack, the final norm and the head once a microbatch;
              # the embedding rows once a token (the rest is on the host)
              "params_swapped_in_m_times_m1": params_in == m * params_in_m1 - (m - 1)
              * TRAIN_BATCH * TRAIN_SEQ * base.model.d_model * 4 > 0}
    row = {"phase": "lms_ab_microbatches", "arch": ARCH, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": m, "steps": n, "card": line,
           "hbm_budget": LMS_AB_BUDGET, "streamed": s, "resident": r,
           "overhead": s["median_step_s_after_1"] / r["median_step_s_after_1"] - 1,
           "params_unequal": [i for i, ok in enumerate(same_params) if not ok],
           "params_in_per_step": params_in, "params_in_per_step_m1": params_in_m1,
           "params_priced": s["plan"]["swap_bytes"].get("params"),
           "peak_vs_plan": {k: {"measured": runs[k]["max_memory_allocated_bytes"],
                                "plan": runs[k]["plan"]["peak_bytes"] if runs[k]["plan"]
                                else None} for k in runs},
           "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"lms_ab_microbatches: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def copy_seconds(prof) -> dict:
    """Device seconds of a torch.profiler run's host-device copies by
    direction, and the busy time of the copies and of everything else
    (kernels, fills): {h2d_s, d2h_s, copy_busy_s, compute_busy_s,
    overlap_s}, the last the time both ran at once."""
    from torch.autograd import DeviceType
    out = {"h2d_s": 0.0, "d2h_s": 0.0}
    copies, compute = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name, start, dur = ev.name(), ev.start_ns(), ev.duration_ns()
        if "HtoD" in name or "DtoH" in name:
            out["h2d_s" if "HtoD" in name else "d2h_s"] += dur / 1e9
            copies.append((start, start + dur))
        else:
            compute.append((start, start + dur))
    out["copy_busy_s"] = busy_seconds(copies)
    out["compute_busy_s"] = busy_seconds(compute)
    out["overlap_s"] = (out["copy_busy_s"] + out["compute_busy_s"]
                        - busy_seconds(copies + compute))
    return out


def _pinned_state_bytes(layers: int) -> int:
    """Pinned host bytes of qwen2.5-14b's train state at `layers` layers
    when the plan puts the stack's params and the AdamW state on the host
    (the port's layout rule, `train.steps._state_layout`)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=layers))
    paths = [(path, d.shape, DTYPES[d.dtype])
             for path, d in steps_mod._def_paths(model.param_defs())]
    return steps_mod._state_layout(paths, "adamw", True, True)[0]


def _grad_bytes(layers: int) -> int:
    """Bytes of the grads (the params' dtypes, on the card)."""
    import dataclasses
    import math as m
    from repro_torch.configs import get_config
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    model = Model(dataclasses.replace(get_config(ARCH), num_layers=layers))
    return sum(m.prod(d.shape) * DTYPES[d.dtype].itemsize
               for d in tree_leaves(model.param_defs()))


def _layerwise_loss(model, state, batch):
    """The loss of `batch` under `state`'s params without the executor: a
    no-grad forward that copies the unstacked rest (embedding, final norm,
    head) whole and one layer at a time from pinned host memory to the card
    and calls `apply_layer`, then the final norm, the head and the
    cross-entropy, as `Model.loss` composes them."""
    import torch
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import (apply_norm, cross_entropy, embed_tokens,
                                           lm_logits)
    from repro_torch.tree import tree_map
    cfg = model.cfg
    params = {**state.params, **{k: tree_map(lambda t: t.to("cuda"), state.params[k])
                                 for k in ("embed", "final_norm")}}
    with torch.no_grad():
        x = embed_tokens(cfg, params["embed"], batch["tokens"])
        ctx = model._ctx(x.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            layer = tree_map(lambda t: t.to("cuda"), tr._layer(params["decoder"]["stack0"], i))
            x, da = tr.apply_layer(cfg, "attn", layer["attn_0"], x, ctx)
            aux = aux + da
        x = apply_norm(cfg, params["final_norm"], x)
        ce = cross_entropy(lm_logits(cfg, params["embed"], x), batch["labels"])
        return ce + 0.01 * aux


def gate_layers(host_row) -> int:
    """The gate's depth: the most layers L <= 48 whose pinned state fits
    LMS_HOST_SHARE of MemAvailable as the host phase read it. Fails, naming
    the host's memory, unless that state plus the grads exceeds the card's
    80 GB."""
    avail, total = host_row["mem_available_bytes"], host_row["mem_total_bytes"]
    fit = [L for L in range(1, 49) if _pinned_state_bytes(L) <= LMS_HOST_SHARE * avail]
    if not fit:
        raise AssertionError(f"lms_gate: the host's MemAvailable {avail} B (MemTotal "
                             f"{total} B) holds no layer's pinned state")
    L = max(fit)
    pinned, grads = _pinned_state_bytes(L), _grad_bytes(L)
    if pinned + grads <= CARD_BYTES:
        raise AssertionError(
            f"lms_gate: the host's MemAvailable {avail} B (MemTotal {total} B) holds the "
            f"pinned state of {L} layers ({pinned} B), which with the grads ({grads} B) "
            f"does not exceed the card's {CARD_BYTES} B")
    return L


def lms_gate_phase(line, checked, host_row, ab_row, L):
    """The paper's case: qwen2.5-14b at full width with the most layers
    L <= 48 whose pinned state (bf16 stack params, f32 AdamW mu, nu and
    master) fits LMS_HOST_SHARE of MemAvailable, trained LMS_STEPS steps of
    2 x 2048 tokens by `Trainer` under an LMS plan. It fails, naming the
    host's memory, unless that state plus the grads exceeds the card's 80
    GB: the run must be training beyond the card's capacity.

    The budget, by the planner's own means: the audited live-bytes margin
    m = lms_ab's measured peak - its plan's peak + LMS_MARGIN_ALLOWANCE
    (what the executor holds beyond the plan's pricing), fed as the plan's
    profile (`CostModel.from_reports(None, {"steps": [{"name": "train",
    "plan_delta_bytes": m}]})`), which tightens the budget by m and charges
    m into the plan's peak. hbm_budget is the card's unless the params
    would not stream there (params + grads under half the budget): then
    the largest budget under which they stream. No retry on out of memory.

    Held: finite losses; step 1's loss bitwise equal to the phase's own
    no-grad forward (`_layerwise_loss`), independent of the executor; the
    RMSNorm launches the plan implies. Reported: step time (median after
    step 1), tokens/s, model FLOP/s and its share of 989 TFLOP/s, the
    measured peak against the plan's, the pinned bytes against
    `plan.host_bytes`, the host-to-device and device-to-host bytes a step
    from the counters against `plan.swap_bytes_per_step`, the link rate
    they give over the step against the host phase's, and the state's set
    up time. -> the phase row."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.costmodel import CostModel
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.data import DataLoader, SyntheticTokens
    from repro_torch.models.model import Model
    n = LMS_STEPS
    pinned, grads = _pinned_state_bytes(L), _grad_bytes(L)
    margin = int(ab_row["peak_vs_plan"]["delta"]) + LMS_MARGIN_ALLOWANCE
    profile = CostModel.from_reports(None, {"steps": [{"name": "train",
                                                       "plan_delta_bytes": margin}]})
    base = _train_config(L, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=n)

    def plan_at(budget):
        lms = LMSConfig(hbm_budget=budget)
        return lms, plan_lms(PlanRequest(cfg=base.model, shape=base.shape, mesh=base.mesh,
                                         lms=lms, optimizer=base.optimizer), profile=profile)
    lms, plan = plan_at(0)
    budget_why = "the card's: the params stream there"
    if plan.swap_schedule is None or not plan.swap_schedule.streams_params:
        n_params = base.model.param_count()
        # params stream iff 2 N + 2 N > (budget (1 - workspace) - m) / 2
        budget = int(0.99 * (2 * 4 * n_params + max(margin, 0)) / (1 - lms.workspace_frac))
        budget_why = (f"lowered from the card's: at {L} layers params + grads "
                      f"({4 * n_params} B priced) stay under half the budget, so the plan "
                      f"keeps params resident; at {budget} B they stream")
        lms, plan = plan_at(budget)
    derivation = {"lms_ab_measured_peak": ab_row["peak_vs_plan"]["measured"],
                  "lms_ab_plan_peak": ab_row["peak_vs_plan"]["plan"],
                  "allowance": LMS_MARGIN_ALLOWANCE, "margin": margin,
                  "hbm_budget": lms.hbm_budget, "why": budget_why}
    emit({"phase": "lms_gate_plan", "layers": L,
          "mem_available_bytes": host_row["mem_available_bytes"],
          "mem_total_bytes": host_row["mem_total_bytes"], "meminfo_now": _mem_row(),
          "host_share": LMS_HOST_SHARE, "pinned_state_bytes": pinned,
          "grad_bytes": grads, "budget_derivation": derivation, "plan": _plan_row(plan)})
    if not plan.swap_schedule.streams_params:
        raise AssertionError("lms_gate: the plan does not stream the params")
    tcfg = dataclasses.replace(base, lms=lms)
    model = Model(tcfg.model)
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=SEED), shard=0,
                        num_shards=1, batch_per_shard=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    first = {k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(tcfg, device="cuda", profile=profile)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    ref_loss = float(_layerwise_loss(model, state, first))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    before = off.swap_counters()
    with launch_signatures() as (seen, calls, launches):
        state, hist = trainer.train(steps=n)
    peak = torch.cuda.max_memory_allocated()
    swap = _swap_per_step(before, off.swap_counters(), n)
    pinned_now = off.pinned_bytes()
    step_s = statistics.median(r["time_s"] for r in hist[1:])
    # where the step's time goes: one more step split by CUDA events (the
    # loss and its grads, the clip, the optimizer sweep), and one under
    # torch.profiler (the device's busy share, its copies by direction)
    batch = trainer._make_batch()
    state, split = step_split_ms(trainer.step_fn, state, batch)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        state, _ = trainer.step_fn(state, batch)
        torch.cuda.synchronize()
        profiled_s = time.monotonic() - t1
    profiled = {**device_summary(prof, profiled_s), "copies": copy_seconds(prof)}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, hw_flops = _train_flops(tcfg.model, tokens, TRAIN_SEQ)
    h2d = sum(v for k, v in swap.items() if k.startswith("lms.swap_in_bytes."))
    d2h = sum(v for k, v in swap.items() if k.startswith("lms.swap_out_bytes."))
    unchecked = sorted(seen - checked)
    implied = _implied_rmsnorm_launches(plan, L)
    checks = {"finite": all(math.isfinite(r["loss"]) for r in hist),
              "step1_loss_bitwise_layerwise_forward": hist[0]["loss"] == ref_loss,
              "beyond_the_card": pinned_now + grads > CARD_BYTES,
              "rmsnorm_launches_as_the_plan_implies": launches["rmsnorm"] == n * implied,
              "no_other_launches": all(v == 0 for k, v in launches.items()
                                       if not k.startswith("rmsnorm")),
              "every_launch_recorded": calls == launches,
              "every_launch_shape_checked": not unchecked}
    row = {"phase": "lms_gate", "arch": ARCH, "layers": L, "d_model": tcfg.model.d_model,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": n, "card": line,
           "params": tcfg.model.param_count(), "hbm_budget": lms.hbm_budget,
           "loss": [r["loss"] for r in hist], "layerwise_loss_step1": ref_loss,
           "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
           "median_step_s_after_1": step_s, "tokens_per_s": tokens / step_s,
           "model_tflop_per_step": model_flops / 1e12,
           "model_tflop_s": model_flops / step_s / 1e12,
           "model_flops_share_of_989": model_flops / step_s / BF16_TENSOR_FLOPS_PER_S,
           "with_recompute_tflop_s": hw_flops / step_s / 1e12,
           "setup_s": setup_s,
           "peak_vs_plan": {"measured": peak, "plan": plan.peak_bytes},
           "pinned_vs_plan": {"measured": pinned_now, "plan_host_bytes": plan.host_bytes},
           "grad_bytes": grads, "state_plus_grads_bytes": pinned_now + grads,
           "swap_per_step": swap,
           "h2d_bytes_per_step": h2d, "d2h_bytes_per_step": d2h,
           "plan_swap_bytes_per_step": plan.swap_bytes_per_step,
           "link_gb_s_in_step": {"h2d": h2d / step_s / 1e9, "d2h": d2h / step_s / 1e9,
                                 "both": (h2d + d2h) / step_s / 1e9},
           "host_phase_gb_s": {"h2d": host_row["h2d_gb_s"], "d2h": host_row["d2h_gb_s"],
                               "both": host_row["both_gb_s"]},
           "rmsnorm_launches_per_step": launches["rmsnorm"] / n,
           "implied_rmsnorm_launches_per_step": implied, "launches": launches,
           "step_split_ms": split, "profile": profiled,
           "unchecked_signatures": unchecked, "checks": checks}
    emit(row)
    del trainer, state, batch
    torch.cuda.empty_cache()
    off.release_arenas()
    if not all(checks.values()):
        raise AssertionError(f"lms_gate ({L} layers): failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    return row


def reference_phase(line, checked):
    """The trace at full width but 2 layers, where bf16 rounding stays
    small, held against the dense pass: 4 bf16 ulps of each row's largest
    |logit| (2**-5 of it) at model width, 2**-4 with int8 KV pages. (At 48
    layers, GEMMs of other shapes alone — chunked against one-shot prefill,
    no kernel involved — move the logits by several percent, so the
    full-depth run holds only the argmax where the dense margin is wide.)
    On the same weights: the engine with the flash-attention prefill
    (argmax), the static loop (2**-5, and the engine's tokens), the slot
    decode step without a page arena against the paged one, and
    `Model.forward` against `Model.prefill`.
    -> {kv_dtype: launches of the slot decode phase}."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(ARCH), num_layers=2)
    model = Model(cfg, attn_impl="blockwise")
    params = model.init(SEED + 1, "cuda")
    _, tokens = engine_phase(model, params, "model", line, checked, dense_tol=2.0 ** -5)
    # int8 codes hold each k/v element to half a step of its row's amax/127
    # (0.4% of the row's largest |value|) on top of the bf16 rounding
    engine_phase(model, params, "int8", line, checked, dense_tol=2.0 ** -4)
    kernel_model = Model(cfg, attn_impl="pallas")
    engine_phase(kernel_model, params, "model", line, checked, prefill_chunk=0)
    static_phase(kernel_model, params, line, checked, tokens, dense_tol=2.0 ** -5)
    launches = slot_decode_phase(kernel_model, params, line, checked)
    forward_phase(kernel_model, params, line, checked)
    del params
    torch.cuda.empty_cache()
    return launches


def lms_phases(line, checked):
    """The LMS phases: the host, lms_ab, lms_gate. The gate's depth is
    chosen first, from the host phase's MemAvailable, and its pinned state
    reserved once (`offload.reserve_pinned`), so lms_ab's state and then
    the gate's reuse one pinned arena: on the card's machine pinned memory
    does not come back to MemAvailable once freed, even after the process
    exits (PERF.md §6). -> their rows."""
    from repro_torch.core.lms import offload as off
    host_row = host_phase(line)
    layers = gate_layers(host_row)
    t0 = time.monotonic()
    off.reserve_pinned(_pinned_state_bytes(layers), "cuda")
    emit({"phase": "lms_reserve", "layers": layers, "bytes": _pinned_state_bytes(layers),
          "seconds": time.monotonic() - t0, "meminfo": _mem_row()})
    ab_row = lms_ab_phase(line, checked)
    lms_ab_microbatches_phase(line, checked, ab_row)
    return host_row, ab_row, lms_gate_phase(line, checked, host_row, ab_row, layers)


# ---------------------------------------------------------------------------
# checkpoints, resume and supervised crash recovery
# ---------------------------------------------------------------------------

class _RssSampler:
    """The process's VmRSS sampled every CKPT_RSS_PERIOD_S on a thread:
    (monotonic time, bytes) pairs, for the resident-set peak of a window."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for row in f:
                if row.startswith("VmRSS:"):
                    return int(row.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self):
        while not self._stop.is_set():
            self.samples.append((time.monotonic(), self.rss()))
            self._stop.wait(CKPT_RSS_PERIOD_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def over(self, t0: float, t1: float) -> dict:
        """The peak over the window [t0, t1] above the last sample before
        t0 (the baseline: the arena is resident by then)."""
        before = [r for t, r in self.samples if t <= t0]
        inside = [r for t, r in self.samples if t0 <= t <= t1]
        base = before[-1] if before else inside[0]
        peak = max(inside + [base])
        return {"baseline_bytes": base, "peak_bytes": peak, "over_bytes": peak - base,
                "samples": len(inside)}


def _mount_of(path: str) -> dict:
    """The filesystem holding `path`: its mount point and type (the longest
    mount point of /proc/mounts that prefixes it) and its free bytes."""
    import shutil
    path = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/mounts") as f:
        for row in f:
            parts = row.split()
            mnt, fstype = parts[1], parts[2]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    usage = shutil.disk_usage(path)
    return {"mount": best[0], "fstype": best[1], "free_bytes": usage.free,
            "total_bytes": usage.total}


def _state_checksums(state) -> list:
    """`_checksums` of every param and optimizer leaf (TrainState or
    Zero1State), the step counters' values after them."""
    if hasattr(state, "opt"):
        return (_checksums({"params": state.params, "opt": dict(state.opt._asdict())})
                + [int(state.step)])
    return _checksums({"params": state.params, "mu": state.mu, "nu": state.nu,
                       "master": state.master}) + [int(state.step)]


def _leaf_bytes(state) -> dict:
    """Bytes of the checkpointed leaves: on the card, all, the largest."""
    from repro_torch.tree import tree_leaves
    if hasattr(state, "opt"):
        leaves = tree_leaves({"params": state.params, "opt": dict(state.opt._asdict())})
    else:
        leaves = tree_leaves(state.params) + [state.mu, state.nu, state.master, state.step]
    sizes = [(t.numel() * t.element_size(), t.device.type) for t in leaves]
    return {"total": sum(n for n, _ in sizes),
            "device": sum(n for n, d in sizes if d == "cuda"),
            "largest": max(n for n, _ in sizes)}


def _supervised(tcfg, steps: int, at: int, rows: list):
    """`Supervisor.run(steps)` of `tcfg` with one injected crash before the
    at-th step's dispatch (0-based) and no delay; every history row, the
    replays too, appended to `rows` in order. -> the result."""
    from repro_torch.runtime import (FaultEvent, FaultInjector, FaultPlan, RestartPolicy,
                                     Supervisor)
    sup = Supervisor(tcfg, device="cuda",
                     policy=RestartPolicy(max_restarts=1, backoff_base=0.0, jitter=False),
                     injector=FaultInjector(FaultPlan([FaultEvent("trainer.step", at=at)])),
                     sleep_fn=lambda d: None)
    res = sup.run(steps=steps, on_step=lambda s, r: rows.append(dict(r)))
    res.obs = sup.obs
    return res


def _ckpt_full(rank: int, world: int, root: str):
    """(a) of the ckpt phase, in a process of its own (spawned): its pinned
    arena reserved once at the 1-layer state's size and reused by every
    placement; the checkpoint files under `root`. -> the row, with the
    launch signatures seen (the parent checks them)."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import Trainer
    n = CKPT_STEPS
    tcfg = dataclasses.replace(
        _train_config(CKPT_LAYERS, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                      total_steps=n), lms=LMSConfig(hbm_budget=LMS_AB_BUDGET))
    off.reserve_pinned(_pinned_state_bytes(CKPT_LAYERS), "cuda")
    # the uninterrupted run
    trainer = Trainer(tcfg, device="cuda")
    plan = trainer.plan
    with launch_signatures() as (seen0, calls0, launches0):
        state, hist0 = trainer.train(steps=n)
    sums0 = _state_checksums(state)
    sizes = _leaf_bytes(state)
    del trainer, state
    torch.cuda.empty_cache()
    off.release_arenas()
    # room for two checkpoints, checked before the first write
    fs = _mount_of(root)
    room = {"mem_available_bytes": _meminfo()["MemAvailable"],
            "needed_bytes": 2 * sizes["total"] + CKPT_ROOM_SLACK}
    if fs["free_bytes"] < room["needed_bytes"] or (
            fs["fstype"] == "tmpfs" and room["mem_available_bytes"] < room["needed_bytes"]):
        raise AssertionError(f"ckpt: {fs} and MemAvailable {room['mem_available_bytes']} B "
                             f"hold less than two checkpoints ({room['needed_bytes']} B)")
    # the supervised run, timed by the save calls, the writers' spans and
    # the restore
    ck_tcfg = dataclasses.replace(tcfg, checkpoint_dir=os.path.join(root, "a"),
                                  checkpoint_every=2, async_checkpoint=True)
    saves, restores = [], []
    real_save, real_restore = Checkpointer.save, trainer_mod.restore_train_state

    def timed_save(self, step, state_, **kw):
        saves.append((step, time.monotonic()))
        return real_save(self, step, state_, **kw)

    def timed_restore(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = real_restore(*a, **kw)
        torch.cuda.synchronize()
        restores.append((t0, time.monotonic()))
        return out
    Checkpointer.save, trainer_mod.restore_train_state = timed_save, timed_restore
    rows = []
    try:
        with _RssSampler() as rss, launch_signatures() as (seen, calls, launches):
            res = _supervised(ck_tcfg, n, CKPT_FAULT_AT, rows)
    finally:
        Checkpointer.save, trainer_mod.restore_train_state = real_save, real_restore
    sums = _state_checksums(res.state)
    del res.state
    torch.cuda.empty_cache()
    off.release_arenas()
    committed = Checkpointer(ck_tcfg.checkpoint_dir).all_steps()
    writers = {e.attrs["step"]: (e.t0, e.dur) for e in res.obs.ring.events()
               if e.site == "ckpt.save" and e.kind == "span" and e.t0 >= saves[0][1]}
    reg = res.obs.registry
    save_rows = []
    for (step, t_call), block_s in zip(saves, reg.histogram("ckpt.save_block_s").window):
        w0, dur = writers[step]
        save_rows.append({"step": step, "block_s": block_s, "write_s": dur,
                          "write_gb_s": sizes["total"] / dur / 1e9,
                          "rss": rss.over(t_call, w0 + dur)})
    (r0, r1), = restores
    restore_row = {"seconds": r1 - r0, "gb_s": sizes["total"] / (r1 - r0) / 1e9,
                   "rss": rss.over(r0, r1)}
    bound = sizes["device"] + 2 * sizes["largest"] + (1 << 30)
    executed = [r["step"] for r in rows]
    want = [hist0[s - 1] for s in executed]
    implied = _implied_rmsnorm_launches(plan, CKPT_LAYERS)
    step3 = [r for r in rows if r["step"] == 3]
    checks = {
        "attempts_2_restarts_1": (res.attempts, res.restarts) == (2, 1),
        "history_steps_1_to_4": [r["step"] for r in res.hist] == list(range(1, n + 1)),
        "executed_1_2_3_3_4": executed == [1, 2, 3, 3, 4],
        "loss_bitwise": [r["loss"] for r in rows] == [r["loss"] for r in want],
        "grad_norm_bitwise": [r["grad_norm"] for r in rows] == [r["grad_norm"] for r in want],
        "checksums_bitwise": sums == sums0,
        "rmsnorm_launches_as_the_plan_implies":
            launches0["rmsnorm"] == n * implied and launches["rmsnorm"] == len(rows) * implied,
        "no_other_launches": all(v == 0 for k, v in {**launches, **launches0}.items()
                                 if not k.startswith("rmsnorm")),
        "every_launch_recorded": calls == launches and calls0 == launches0,
        "committed_2_4": committed == [2, 4],
        "save_rss_under_bound": all(r["rss"]["over_bytes"] <= bound for r in save_rows),
        "restore_rss_under_bound": restore_row["rss"]["over_bytes"] <= bound,
    }
    return {"phase": "ckpt", "arch": ARCH, "layers": CKPT_LAYERS, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": n, "hbm_budget": LMS_AB_BUDGET,
            "plan": _plan_row(plan), "checkpoint_bytes": sizes["total"],
            "device_leaf_bytes": sizes["device"], "largest_leaf_bytes": sizes["largest"],
            "rss_bound_bytes": bound, "filesystem": fs, "room": room, "saves": save_rows,
            "restore": restore_row, "writer_wait_s": reg.histogram("ckpt.wait_s").summary(),
            "step3_beside_write_s": step3[0]["time_s"],
            "step3_uninterrupted_s": hist0[2]["time_s"],
            "uninterrupted_step_s": [r["time_s"] for r in hist0],
            "median_step_s_uninterrupted": statistics.median(r["time_s"] for r in hist0[1:]),
            "supervised_rows": [{k: r[k] for k in ("step", "loss", "grad_norm", "time_s")}
                                for r in rows],
            "committed": committed, "rmsnorm_launches": launches["rmsnorm"],
            "implied_rmsnorm_launches_per_step": implied,
            "signatures": sorted(seen | seen0), "checks": checks}


def ckpt_phase(line, checked):
    """Checkpoints, resume and supervised crash recovery.

    (a) The paper's case under checkpoints, in a process spawned on the
    card (`_ckpt_full`) before the LMS phases: qwen2.5-14b at full width
    cut to CKPT_LAYERS layer, 2 x 2048 tokens a step, the plan of
    LMSConfig(hbm_budget=LMS_AB_BUDGET) (params streamed, the AdamW state
    in a pinned arena reserved once). `Trainer.train` for CKPT_STEPS steps
    with no checkpoints, then the `Supervisor` over the same run with
    asynchronous checkpoints every 2 steps and a crash injected before
    step 4's dispatch: attempt 1 trains steps 1-3 (step 2 written from the
    arena while step 3 runs), attempt 2 restores step 2 into the arena,
    replays 3-4 and writes step 4. Held: 2 attempts, 1 restart, steps 1-4;
    every row's loss and grad norm (attempt 1's step 3 too) and every
    leaf's checksum after step 4 bitwise the uninterrupted run's;
    RMSNorm's launches the plan implies a step executed, of shapes the
    kernel phases checked; committed steps [2, 4]; the resident-set peak
    during each save and the restore, above its baseline, under the
    card-resident leaves' bytes + 2 x the largest leaf + 1 GiB. Reported:
    checkpoint bytes, the save call's blocking seconds, the writer's
    seconds and GB/s, step 3 beside the write against the uninterrupted
    step 3, the update's wait for the writer, the restore's seconds and
    GB/s, the filesystem.

    Where the files go: the card's machine lets a run write at most 45 GiB
    to its disk, and two checkpoints are 54.4 GB, so they go to
    a directory of their own in RAM (CKPT_RAM_ROOT, tmpfs; room checked
    against MemAvailable first, removed at the end); the process runs
    before the LMS phases, beside no reserved arena of the parent's, and
    after (b) the parent waits until MemAvailable is back within
    LMS_DDL_MEM_SLACK of its value before (a) (the host hands a child's
    memory back over seconds, while (b) runs), so the gate sizes itself
    from the whole host.

    (b) At smoke width, 2 ranks spawned on the card over gloo
    (`ckpt_ranks_phase`). -> the phase row."""
    import shutil
    import tempfile
    before = _meminfo()["MemAvailable"]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=CKPT_RAM_ROOT)
    t0 = time.monotonic()
    try:
        row, = spawn_ranks("_ckpt_full", 1, root, timeout=CKPT_TIMEOUT_S)
    finally:
        shutil.rmtree(root)
    seconds = time.monotonic() - t0
    unchecked = sorted({_tuplify(sig) for sig in row.pop("signatures")} - checked)
    row["checks"]["every_launch_shape_checked"] = not unchecked
    row.update(card=line, seconds=seconds, unchecked_signatures=unchecked,
               mem_available_before=before)
    emit(row)
    if not all(row["checks"].values()):
        raise AssertionError(f"ckpt: failed checks "
                             f"{[k for k, v in row['checks'].items() if not v]}")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_ranks_", dir=os.path.join(ROOT, "build"))
    try:
        row["ranks"] = ckpt_ranks_phase(line, checked, root)
    finally:
        shutil.rmtree(root)
    # (b) ran while the host handed (a)'s memory back
    t0 = time.monotonic()
    row["mem_available_after"] = _await_mem_available(before - LMS_DDL_MEM_SLACK,
                                                      LMS_DDL_MEM_WAIT_S)
    emit({"phase": "ckpt_memory", "mem_available_before": before,
          "mem_available_after": row["mem_available_after"],
          "wait_s": time.monotonic() - t0})
    return row


CKPT_RANK_MODES = ("zero1_planned", "allreduce_compress")


def _ckpt_rank_config(mode: str, ckpt_dir):
    """The smoke config on 2 ranks: zero1 on 1x2x1 under
    LMSConfig(hbm_budget=CKPT_SMOKE_BUDGET), or allreduce on 2x1x1 with
    the int8 pod hop, CKPT_STEPS steps."""
    import dataclasses
    from repro_torch.config.base import DDLConfig, LMSConfig
    mesh, ddl, lms = {"zero1_planned": ((1, 2, 1), DDLConfig(mode="zero1"),
                                        LMSConfig(hbm_budget=CKPT_SMOKE_BUDGET)),
                      "allreduce_compress": ((2, 1, 1), DDLConfig(compress_dcn=True),
                                             LMSConfig(enabled=False))}[mode]
    tcfg = _ddl_config(0, mesh, smoke=True, batch=DDL_SMOKE_BATCH, seq=DDL_SMOKE_SEQ, ddl=ddl,
                       checkpoint_dir=ckpt_dir, checkpoint_every=2)
    return dataclasses.replace(tcfg, lms=lms, total_steps=CKPT_STEPS)


def _ckpt_rank(rank: int, world: int, modes, root: str):
    """One rank of (b), each mode in turn (its checkpoints in
    root/b_<mode>): -> {mode: `_ckpt_rank_mode`'s result}."""
    return {mode: _ckpt_rank_mode(mode, os.path.join(root, f"b_{mode}")) for mode in modes}


def _ckpt_rank_mode(mode: str, ckpt_dir: str):
    """One mode of a rank of (b): the uninterrupted run, then the
    supervised one with a crash before step 4; each row, the checksums
    after the last step, the launches of each run, the plan's residency."""
    import dataclasses
    from repro_torch.core.lms import offload as off
    from repro_torch.train.trainer import Trainer
    tcfg = _ckpt_rank_config(mode, ckpt_dir)
    out = {}
    trainer = Trainer(dataclasses.replace(tcfg, checkpoint_dir=None), device="cuda")
    with launch_signatures() as (seen0, _, launches0):
        state, hist0 = trainer.train(steps=CKPT_STEPS)
    out["uninterrupted"] = {"rows": [{"step": r["step"], "loss": r["loss"],
                                      "grad_norm": r["grad_norm"]} for r in hist0],
                            "checksums": _state_checksums(state), "launches": launches0,
                            "signatures": sorted(seen0)}
    out["residency"] = trainer.plan.residency if trainer.plan is not None else None
    del trainer, state
    off.release_arenas()
    rows = []
    with launch_signatures() as (seen, _, launches):
        res = _supervised(tcfg, CKPT_STEPS, CKPT_FAULT_AT, rows)
    out["supervised"] = {"rows": [{"step": r["step"], "loss": r["loss"],
                                   "grad_norm": r["grad_norm"]} for r in rows],
                         "attempts": res.attempts, "restarts": res.restarts,
                         "checksums": _state_checksums(res.state), "launches": launches,
                         "signatures": sorted(seen)}
    del res
    off.release_arenas()
    return out


def ckpt_ranks_phase(line, checked, root):
    """(b) of the ckpt phase: each mode's 2 ranks spawned on the card. ->
    the row."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train.steps import _resolve_overlap
    t0 = time.monotonic()
    out, checks, unchecked = {}, {}, set()
    # both modes in one spawn of the 2 ranks
    by_rank = spawn_ranks("_ckpt_rank", 2, CKPT_RANK_MODES, root)
    for mode in CKPT_RANK_MODES:
        ckpt_dir = os.path.join(root, f"b_{mode}")
        ranks = [r[mode] for r in by_rank]
        tcfg = _ckpt_rank_config(mode, ckpt_dir)
        c = {}
        for r, got in enumerate(ranks):
            u, s = got["uninterrupted"], got["supervised"]
            by_step = {row["step"]: row for row in u["rows"]}
            c[f"rank{r}"] = {
                "attempts_2_restarts_1": (s["attempts"], s["restarts"]) == (2, 1),
                "rows_bitwise": [row["step"] for row in s["rows"]] == [1, 2, 3, 3, 4]
                and all(row == by_step[row["step"]] for row in s["rows"]),
                "checksums_bitwise": s["checksums"] == u["checksums"]}
            unchecked |= {_tuplify(sig) for sig in u["signatures"] + s["signatures"]} - checked
        c["same_on_both_ranks"] = ranks[0]["supervised"]["rows"] == ranks[1]["supervised"]["rows"]
        c["committed_2_4"] = Checkpointer(ckpt_dir).all_steps() == [2, 4]
        if mode == "zero1_planned":
            c["optimizer_on_the_host"] = all(got["residency"]["optimizer"] == "host"
                                             for got in ranks)
        else:
            pods, data = tcfg.mesh.shape[0], tcfg.mesh.shape[1]
            ov = _resolve_overlap(None, None, tcfg, pods * data)
            per_step = len(ddl_pod_hop_sizes(tcfg.model, data, overlap=ov))
            c["launches"] = all(
                got[run]["launches"]["quantize_rows"] == len(got[run]["rows"]) * per_step
                and got[run]["launches"]["dequantize_sum_rows"] == len(got[run]["rows"]) * per_step
                and got[run]["launches"]["dequantize_rows"] == 0
                for got in ranks for run in ("uninterrupted", "supervised"))
        c["rmsnorm_launched"] = all(got[run]["launches"]["rmsnorm"] > 0 for got in ranks
                                    for run in ("uninterrupted", "supervised"))
        checks[mode] = c
        out[mode] = {"mesh": list(tcfg.mesh.shape), "residency": ranks[0]["residency"],
                     "rows": ranks[0]["supervised"]["rows"],
                     "launches": ranks[0]["supervised"]["launches"]}
    flat = {f"{mode}.{k}": all(v.values()) if isinstance(v, dict) else v
            for mode, c in checks.items() for k, v in c.items()}
    flat["every_launch_shape_checked"] = not unchecked
    row = {"phase": "ckpt_ranks", "arch": ARCH, "config": "smoke", "ranks": 2,
           "backend": "gloo (host-staged)", "batch": DDL_SMOKE_BATCH, "seq": DDL_SMOKE_SEQ,
           "steps": CKPT_STEPS, "card": line, "modes": out, "checks": checks,
           "unchecked_signatures": sorted(map(str, unchecked)),
           "seconds": time.monotonic() - t0}
    emit(row)
    if not all(flat.values()):
        raise AssertionError(f"ckpt_ranks: failed checks {[k for k, v in flat.items() if not v]}")
    return row


# ---------------------------------------------------------------------------
# the other dense decoders of the registry
# ---------------------------------------------------------------------------

def _dense_serve(arch: str, layers: int, line, checked, *, dense: bool, int8: bool,
                 flash_prefill: bool, static: bool) -> dict:
    """`arch` at full width cut to `layers`, random weights from a seed,
    served on the trace: the engine at model width (chunked prefill), with
    int8 pages if `int8`, with the flash-attention whole-prompt prefill if
    `flash_prefill`, and `run_static` if `static`. With `dense` (2 layers)
    the engine and the static loop are held to the dense pass's values as
    `reference_phase` holds qwen2.5-14b's; at depth, its argmax where the
    margin is wide. -> {run: its row's numbers}."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = Model(cfg, attn_impl="blockwise")
    params = model.init(SEED + 2, "cuda")
    keep = ("decode_tok_s", "ticks", "decode_launches", "quantize_kv_write_launches",
            "quantize_launches", "attention_launches", "rmsnorm_launches", "dense")
    out = {}
    row, tokens = engine_phase(model, params, "model", line, checked,
                               dense_tol=2.0 ** -5 if dense else None)
    out["engine_model"] = {k: row[k] for k in keep}
    if int8:
        row, _ = engine_phase(model, params, "int8", line, checked,
                              dense_tol=2.0 ** -4 if dense else None)
        out["engine_int8"] = {k: row[k] for k in keep}
    kernel_model = Model(cfg, attn_impl="pallas")
    if flash_prefill:
        row, _ = engine_phase(kernel_model, params, "model", line, checked, prefill_chunk=0)
        out["engine_flash_prefill"] = {k: row[k] for k in keep}
    if static:
        row = static_phase(kernel_model, params, line, checked, tokens,
                           dense_tol=2.0 ** -5 if dense else None)
        out["static"] = {k: row[k] for k in ("decode_tok_s", "prefill_ms", "launches",
                                             "plain", "dense")}
    del params, model, kernel_model
    torch.cuda.empty_cache()
    return out


def _dense_olmo_rank(rank: int, world: int, checked):
    """In a process of its own: olmo-1b at its full 16 layers, `Trainer.train`
    for DENSE_TRAIN_STEPS steps resident, then under the plan of
    LMSConfig(hbm_budget=DENSE_OLMO_BUDGET) from the same seed; counts reset
    just before each run and read just after. -> both runs' rows."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.configs import get_config
    n = DENSE_TRAIN_STEPS
    L = get_config(DENSE_OLMO).num_layers
    base = _train_config(L, DENSE_OLMO, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=n)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, _ = _train_flops(base.model, tokens, TRAIN_SEQ)
    out = {}
    for name, lms in (("resident", LMSConfig(enabled=False)),
                      ("streamed", LMSConfig(hbm_budget=DENSE_OLMO_BUDGET))):
        trainer, state, hist, facts = _lms_run(dataclasses.replace(base, lms=lms), n)
        step_s = statistics.median(r["time_s"] for r in hist[1:])
        out[name] = {
            "plan": _plan_row(trainer.plan), "loss": [r["loss"] for r in hist],
            "grad_norm": [r["grad_norm"] for r in hist], "step_s": [r["time_s"] for r in hist],
            "median_step_s_after_1": step_s, "tokens_per_s": tokens / step_s,
            "model_tflop_s": model_flops / step_s / 1e12,
            "setup_s": facts["setup_s"], "max_memory_allocated_bytes": facts["peak_bytes"],
            "pinned_bytes": facts["pinned_bytes"], "swap_per_step": facts["swap_per_step"],
            "checksums": _checksums(state.params), "launches": facts["launches"],
            "every_launch_recorded": facts["calls"] == facts["launches"],
            "unchecked_signatures": sorted(facts["seen"] - checked)}
        del trainer, state, hist
        torch.cuda.empty_cache()
    off.release_arenas()
    return out


def dense_configs_phase(line, checked):
    """The registry's other dense decoders at their published widths, each
    through the kernels, with counts reset just before each run and read
    just after (the engine's, the static loop's and training's checks;
    LayerNorm configs launch no RMSNorm kernel):

    - olmo-1b: the engine (model width and int8) and `run_static` at 2
      layers against the dense pass, and at its full 16 layers (argmax);
      `Trainer.train` for 3 steps resident and 3 under the plan of
      LMSConfig(hbm_budget=8e9) (params and AdamW state streamed from
      pinned host memory), in a spawned process: losses, grad norms and
      every param's checksum bitwise equal, no kernel launched;
    - starcoder2-7b: at 2 layers the engine (both widths, and the
      flash-attention prefill) against the dense pass, and 2 train steps
      through the kernels against the plain versions; at 16 of its 32
      layers the engine at model width (argmax, launch counts);
    - qwen2-72b: at 2 layers the engine at model width (and the
      flash-attention prefill); at 1 layer (~54 GB of params and AdamW
      state) 2 train steps through the kernels against the plain versions,
      4L+1 RMSNorm launches a step. -> the phase row."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.monotonic()
    times, serve = {}, {}

    def lap(name):
        times[name] = time.monotonic() - t0 - sum(times.values())
    olmo_layers = get_config(DENSE_OLMO).num_layers
    serve["olmo_1b_2"] = _dense_serve(DENSE_OLMO, 2, line, checked, dense=True, int8=True,
                                      flash_prefill=False, static=True)
    serve[f"olmo_1b_{olmo_layers}"] = _dense_serve(DENSE_OLMO, olmo_layers, line, checked,
                                                   dense=False, int8=True,
                                                   flash_prefill=False, static=True)
    lap("olmo_1b_serve")
    train, = spawn_ranks("_dense_olmo_rank", 1, checked, timeout=DENSE_TIMEOUT_S)
    lap("olmo_1b_train")
    serve["starcoder2_7b_2"] = _dense_serve(DENSE_STARCODER, 2, line, checked, dense=True,
                                            int8=True, flash_prefill=True, static=False)
    star_train = train_reference_phase(line, checked, DENSE_STARCODER, 2, DENSE_CHECK_STEPS,
                                       ab=False)
    star_layers = DENSE_STARCODER_SERVE_LAYERS
    serve[f"starcoder2_7b_{star_layers}"] = _dense_serve(
        DENSE_STARCODER, star_layers, line, checked, dense=False, int8=False,
        flash_prefill=False, static=False)
    lap("starcoder2_7b")
    serve["qwen2_72b_2"] = _dense_serve(DENSE_QWEN72, 2, line, checked, dense=True, int8=False,
                                        flash_prefill=True, static=False)
    big_train = train_reference_phase(line, checked, DENSE_QWEN72, 1, DENSE_CHECK_STEPS,
                                      ab=False)
    lap("qwen2_72b")
    res, st = train["resident"], train["streamed"]
    checks = {
        "olmo_plan_streams_params_and_optimizer":
            set(st["plan"]["swap_bytes"]) == {"params", "optimizer"},
        "olmo_loss_bitwise": st["loss"] == res["loss"],
        "olmo_grad_norm_bitwise": st["grad_norm"] == res["grad_norm"],
        "olmo_params_bitwise": st["checksums"] == res["checksums"],
        "olmo_finite": all(math.isfinite(x) for x in res["loss"] + res["grad_norm"]),
        "olmo_no_launches": all(v == 0 for r in (res, st) for v in r["launches"].values()),
        "olmo_every_launch_recorded": res["every_launch_recorded"]
        and st["every_launch_recorded"],
        "olmo_every_launch_shape_checked": not res["unchecked_signatures"]
        and not st["unchecked_signatures"],
        "starcoder2_no_rmsnorm": star_train["launches"]["rmsnorm"] == 0,
        "qwen2_72b_rmsnorm_4L+1": big_train["rmsnorm_launches_per_step"]
        == [4 * 1 + 1] * DENSE_CHECK_STEPS}
    row = {"phase": "dense_configs", "card": line, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "serve": serve, "olmo_1b_train": {"layers": olmo_layers,
                                             "hbm_budget": DENSE_OLMO_BUDGET, **train},
           "starcoder2_7b_train": {k: star_train[k] for k in (
               "layers", "loss_kernel", "loss_plain", "grad_norm_kernel", "grad_norm_plain",
               "grad_rel_frobenius_max", "step_s_kernel", "tokens_per_s_last_step",
               "max_memory_allocated_gb")},
           "qwen2_72b_train": {k: big_train[k] for k in (
               "layers", "loss_kernel", "loss_plain", "grad_norm_kernel", "grad_norm_plain",
               "rel_diff", "grad_rel_frobenius_max", "grad_rel_frobenius_floor_max",
               "rmsnorm_launches_per_step", "step_s_kernel", "tokens_per_s_last_step",
               "max_memory_allocated_gb")},
           "seconds_by_part": times, "seconds": time.monotonic() - t0, "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"dense_configs: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the MoE family (the moe phase)
# ---------------------------------------------------------------------------

def _tp_config(mesh, **kw):
    """The tp phase's TrainConfig on `mesh` (a shape over DDL_AXES)."""
    import dataclasses
    from repro_torch.config.base import MeshSpec
    return dataclasses.replace(
        _train_config(TP_LAYERS, learning_rate=TRAIN_LR, warmup_steps=0,
                      total_steps=TP_STEPS), mesh=MeshSpec(mesh, DDL_AXES), **kw)


def _tp_batches(tcfg):
    """TP_STEPS batches of the synthetic stream, on the card."""
    import torch
    from repro_torch.data import DataLoader, SyntheticTokens
    loader = DataLoader(SyntheticTokens(tcfg.model.vocab_size, seed=SEED), shard=0,
                        num_shards=1, batch_per_shard=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    return [{k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
            for _ in range(TP_STEPS)]


def _tp_steps(tcfg, plan, mesh):
    """`build_train_step` of `tcfg` for TP_STEPS steps from the seed, the
    state placed as `plan` says (None: resident), the counts reset just
    before each step and read just after. -> (state, rows, facts)."""
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    model = Model(tcfg.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = steps_mod.init_train_state(model, tcfg, SEED + 11, "cuda", plan=plan, mesh=mesh)
    step = steps_mod.build_train_step(model, tcfg, plan=plan, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    rows = []
    with launch_signatures() as (seen, calls, launches):
        for b in _tp_batches(tcfg):
            before = _launchers()["rmsnorm"].launches
            torch.cuda.synchronize()
            t1 = time.monotonic()
            state, m = step(state, b)
            torch.cuda.synchronize()
            rows.append({"step_s": time.monotonic() - t1,
                         "rmsnorm_launches": _launchers()["rmsnorm"].launches - before,
                         **{k: float(m[k]) for k in ("loss", "ce", "grad_norm", "lr")}})
    return state, rows, {"setup_s": setup_s, "peak_bytes": torch.cuda.max_memory_allocated(),
                         "pinned_bytes": off.pinned_bytes(), "seen": seen, "calls": calls,
                         "launches": launches}


def _tp_reference_masters(masters, mesh):
    """(i)'s reference: the same steps on one device, run by each `model`
    rank in turn (the card holds one such run beside the ranks' masters'
    blocks), and this rank's masters held against its blocks of the
    reference's. -> (the reference's rows, the masters against them: max
    and the shares past 0.01 and 0.1 lr N, the median and 99th
    percentile bounds)."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    tcfg = _tp_config((1, 1, 1))
    specs = tree_leaves(Model(tcfg.model).param_specs(mesh))
    unit = TRAIN_LR * TP_STEPS
    out = None
    for m in range(mesh.size("model")):
        if m == mesh.index("model"):
            state, rows, _ = _tp_steps(tcfg, None, None)
            n = worst = over_median = over_p99 = 0
            for mine, ref, sp in zip(masters, tree_leaves(state.opt.master), specs):
                d = (mine - shd.local_shard(ref, sp, mesh)).abs()
                n += d.numel()
                worst = max(worst, d.max().item())
                over_median += int((d > 0.01 * unit).sum())
                over_p99 += int((d > 0.1 * unit).sum())
                del d
            del state
            torch.cuda.empty_cache()
            out = rows, {"elements": n, "max_over_lr_n": worst / unit,
                         "share_over_0.01_lr_n": over_median / n,
                         "share_over_0.1_lr_n": over_p99 / n}
        dist.barrier(group=mesh.groups["model"])
    return out


def _tp_cases(rank: int, world: int):
    """The tp phase's runs, in the ddl_sharded ranks after their cases (its
    reserved arena and warm processes): (i) resident on TP_MESH, its
    replicated leaves' checksums against the other rank's and its masters
    against the one-device run's (`_tp_reference_masters`); (iii) a
    forward through kernel #1 at this rank's heads against the blockwise
    forward; (ii) the same steps under the plan of TP_BUDGET. -> the
    rows' facts."""
    import gc
    import torch
    from repro_torch.config.base import LMSConfig, MeshSpec
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    t0 = time.monotonic()
    mesh = make_mesh(MeshSpec(TP_MESH, DDL_AXES))
    tcfg = _tp_config(TP_MESH)
    model = Model(tcfg.model)
    out = {"rank": rank, "model_index": mesh.index("model")}
    state, rows, facts = _tp_steps(tcfg, None, mesh)
    sums = _state_checksums(state)
    sharded = tree_leaves(shd.sharded_tree(model.param_defs(), mesh))
    # the replicated leaves (params and each AdamW tree) the same on both ranks
    replicated = _checksums({f"{name}/{i}": t for name, tree in (
        ("params", state.params), ("master", state.opt.master), ("mu", state.opt.mu),
        ("nu", state.opt.nu)) for i, (t, sh) in enumerate(zip(tree_leaves(tree), sharded))
        if not sh})
    out["resident"] = {"rows": rows, "checksums": sums, **{
        k: facts[k] for k in ("setup_s", "peak_bytes")},
        "launches": facts["launches"], "calls": facts["calls"],
        "signatures": sorted(facts["seen"]), "replicated_leaves": len(replicated),
        "replicated_same_on_ranks": _same_on_all_ranks(replicated)}
    # (iii) kernel #1 on the main path at this rank's heads: a forward of the
    # trained blocks through it against the blockwise one
    batch = _tp_batches(tcfg)[0]
    with torch.no_grad():
        want, _ = Model(tcfg.model, attn_impl="blockwise").forward(state.params, batch,
                                                                   mesh=mesh)
        torch.cuda.synchronize()
        with launch_signatures() as (seen, calls, launches):
            t1 = time.monotonic()
            got, _ = Model(tcfg.model, attn_impl="pallas").forward(state.params, batch,
                                                                   mesh=mesh)
            torch.cuda.synchronize()
            fwd_s = time.monotonic() - t1
        out["forward"] = {"err_over_max": ((got.float() - want.float()).abs().max()
                                           / want.float().abs().max()).item(),
                          "logits_shape": list(got.shape), "seconds": fwd_s,
                          "launches": launches, "calls": calls, "signatures": sorted(seen)}
    masters = tree_leaves(state.opt.master)
    del state, want, got
    gc.collect()
    torch.cuda.empty_cache()
    out["reference_rows"], out["masters"] = _tp_reference_masters(masters, mesh)
    del masters
    # (ii) under the plan: params and the AdamW state in pinned host memory
    plan = plan_lms(PlanRequest(cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh,
                                lms=LMSConfig(hbm_budget=TP_BUDGET)))
    before = off.swap_counters()
    state, rows, facts = _tp_steps(tcfg, plan, mesh)
    out["planned"] = {"rows": rows, "checksums": _state_checksums(state),
                      "plan": _plan_row(plan),
                      "implied_rmsnorm_launches": _implied_rmsnorm_launches(plan, TP_LAYERS),
                      "swap_per_step": _swap_per_step(before, off.swap_counters(), TP_STEPS),
                      **{k: facts[k] for k in ("setup_s", "peak_bytes", "pinned_bytes")},
                      "launches": facts["launches"], "calls": facts["calls"],
                      "signatures": sorted(facts["seen"])}
    del state
    off.release_arenas()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    return out


def tp_phase(line, checked, ranks):
    """Tensor parallelism on the port's training path (TP_MESH's comment),
    from the runs `_tp_cases` made in the ddl_sharded ranks. Row `tp`. ->
    {kernel: launches on the tensor-parallel path} (rank 0's: the
    resident and planned steps and the forward)."""
    L = TP_LAYERS
    r0 = ranks[0]
    res, pl, fw, ref = r0["resident"], r0["planned"], r0["forward"], r0["reference_rows"]

    def rel(got, want):
        return abs(got - want) / abs(want)

    def metrics(rows):
        return [{k: x[k] for k in ("loss", "ce", "grad_norm", "lr")} for x in rows]
    rels = {k: max(rel(r["resident"]["rows"][i][k], ref[i][k])
                   for r in ranks for i in range(TP_STEPS))
            for k in ("loss", "ce", "grad_norm")}
    unit_bounds = {"max_over_lr_n": 2.0, "share_over_0.01_lr_n": 0.5,
                   "share_over_0.1_lr_n": 0.01}
    runs = ("resident", "planned", "forward")
    unchecked = sorted({_tuplify(sig) for r in ranks for part in runs
                        for sig in r[part]["signatures"]} - checked)
    checks = {
        **{f"{k}_within_{TP_REL_TOL}": v <= TP_REL_TOL for k, v in rels.items()},
        **{f"masters_{k}": all(r["masters"][k] <= b for r in ranks)
           for k, b in unit_bounds.items()},
        "ranks_same_metrics": all(metrics(r["resident"]["rows"]) == metrics(res["rows"])
                                  for r in ranks),
        "replicated_leaves_bitwise_across_model":
            all(r["resident"]["replicated_same_on_ranks"] for r in ranks),
        "planned_streams_params_and_optimizer":
            pl["plan"]["residency"].get("params") == "host"
            and pl["plan"]["residency"].get("optimizer") == "host",
        "planned_state_bitwise": all(r["planned"]["checksums"] == r["resident"]["checksums"]
                                     for r in ranks),
        "planned_metrics_bitwise": all(metrics(r["planned"]["rows"])
                                       == metrics(r["resident"]["rows"]) for r in ranks),
        "rmsnorm_launches_4L+1_a_step": all(
            [x["rmsnorm_launches"] for x in r["resident"]["rows"]] == [4 * L + 1] * TP_STEPS
            for r in ranks),
        "planned_rmsnorm_launches_as_the_plan_implies": all(
            [x["rmsnorm_launches"] for x in r["planned"]["rows"]]
            == [r["planned"]["implied_rmsnorm_launches"]] * TP_STEPS for r in ranks),
        "forward_wgmma_launches_L": all(
            r["forward"]["launches"].get("flash_attention_wgmma") == L
            and r["forward"]["launches"].get("flash_attention") == L for r in ranks),
        "forward_within_2**-5": all(r["forward"]["err_over_max"] <= 2.0 ** -5 for r in ranks),
        "every_launch_recorded": all(r[p]["calls"] == r[p]["launches"] for r in ranks
                                     for p in runs),
        "no_other_launches": all(
            v == 0 for r in ranks for p in runs for k, v in r[p]["launches"].items()
            if not (k.startswith("rmsnorm") or k.startswith("flash_attention"))),
        "every_launch_shape_checked": not unchecked,
    }
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def steady(rows):
        return sum(x["step_s"] for x in rows[1:]) / max(len(rows) - 1, 1)
    row = {"phase": "tp", "arch": ARCH, "card": line, "mesh": "x".join(map(str, TP_MESH)),
           "ranks": TP_MESH[-1], "backend": "gloo (host-staged)",
           "note": "two ranks time-slice one card over gloo: not tensor parallelism's speed "
                   "across cards (scripts/ddl_four_cards.py --phases g); run in the "
                   "ddl_sharded ranks after their cases",
           "layers": L, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS,
           "lr": TRAIN_LR, "hbm_budget": TP_BUDGET, "reference_rows": ref,
           "rel_vs_one_device": rels, "masters": [r["masters"] for r in ranks],
           "resident": {k: res[k] for k in ("rows", "setup_s", "peak_bytes")},
           "planned": {k: pl[k] for k in ("rows", "setup_s", "peak_bytes", "pinned_bytes",
                                          "plan", "swap_per_step")},
           "step_s": {"one_device": steady(ref), "resident": steady(res["rows"]),
                      "planned": steady(pl["rows"])},
           "tokens_per_s_resident": tokens / steady(res["rows"]),
           "peak_vs_plan": {"resident_bytes": res["peak_bytes"],
                            "planned_bytes": pl["peak_bytes"],
                            "plan_bytes": pl["plan"]["peak_bytes"],
                            "ratio": pl["peak_bytes"] / pl["plan"]["peak_bytes"]},
           "forward": {k: fw[k] for k in ("err_over_max", "logits_shape", "seconds")},
           "unchecked_signatures": unchecked,
           "seconds_in_ranks": [r["seconds"] for r in ranks], "checks": checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"tp: failed checks {[k for k, v in checks.items() if not v]}")
    return {"flash_attention_fwd_wgmma": fw["launches"]["flash_attention_wgmma"],
            "rmsnorm": sum(x["rmsnorm_launches"] for x in res["rows"] + pl["rows"])}


def _tp_serve_plan(cfg, mesh_shape=TP_MESH):
    """The serve plan of the trace at `cfg` on a model mesh under
    TP_SERVE_BUDGET (params and the KV backlog on the host)."""
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.core.lms.planner import PlanRequest, plan
    return plan(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
                            mesh=MeshSpec(mesh_shape, DDL_AXES),
                            lms=LMSConfig(hbm_budget=TP_SERVE_BUDGET), serve=True,
                            slots=SLOTS, backlog_slots=2 * SLOTS, page_size=PAGE))


def _serve_on(model, params, kv_dtype, mesh, *, forced=None, plan=None, geometry=None,
              preempt_at=None, requests=REQUESTS, gen=GEN):
    """The trace (`requests` of PROMPT + `gen` tokens on SLOTS slots) on the
    engine on `mesh` (None: one device), teacher-forced with `forced` {rid:
    tokens} where given (the rows are the engine's, the argmaxes its own),
    a preemption at tick `preempt_at`, under `plan`; the page geometry the
    trace's (DEVICE_PAGES), or `geometry`, or the plan's. The counts (the
    kernels' launches, the MoE drops, the params' swap bytes) are reset
    just before and read just after the run. -> facts, with the tokens,
    the rows and each row's argmax."""
    import numpy as np
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.models import moe
    from repro_torch.runtime.inject import FaultEvent, FaultInjector, FaultPlan
    from repro_torch.serve import ServeEngine, synth_requests
    inj = (FaultInjector(FaultPlan([FaultEvent("engine.tick", at=preempt_at, kind="preempt")]))
           if preempt_at is not None else None)
    if geometry is None and plan is None:
        geometry = {"page_size": PAGE, "device_pages": DEVICE_PAGES,
                    "host_pages": 2 * SLOTS * (MAX_LEN // PAGE)}
    made = _moe_calls(model)
    torch.cuda.synchronize()
    before_engine = torch.cuda.memory_allocated()
    eng = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                      params=params, kv_dtype=kv_dtype, plan=plan, injector=inj,
                      device="cuda", mesh=mesh, **(geometry or {}))
    rows, own = {}, {}
    select = eng._select

    def pick(req, row):
        rows.setdefault(req.rid, []).append(row.copy())
        own.setdefault(req.rid, []).append(int(np.argmax(row)))
        if forced is None:
            return select(req, row)
        return int(forced[req.rid][len(req.tokens)])
    eng._select = pick
    reqs = synth_requests(model.cfg, requests, PROMPT, gen, np.random.default_rng(SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = off.swap_counters()
    moe.reset_dropped()
    try:
        with launch_signatures() as (seen, calls, launches):
            t0 = time.monotonic()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        for name in made:
            delattr(model, name)
        del eng._select
    m = eng.metrics()
    moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
        "lms.swap_in_bytes.params", 0)
    facts = {"run_s": wall, "decode_tok_s": m["decode_tok_s"], "ticks": m["ticks"],
             "decode_tokens": m["decode_tokens"],
             "ttft_mean_s": m.get("ttft_mean_s"), "tpot_p50_s": m.get("tpot_p50_s"),
             "tpot_p95_s": m.get("tpot_p95_s"), "peak_bytes": torch.cuda.max_memory_allocated(),
             "base_bytes": base, "engine_base_bytes": before_engine,
             "dropped": moe.dropped(), "swap_in_bytes_params": moved,
             "pool_invariants": _pool_invariants(eng),
             "pool": {k: m[f"pool_{k}"] for k in ("spilled_pages", "fetched_pages",
                                                  "prefetched_pages", "preempted_requests")},
             "page_geometry": [eng.pool.page_size, eng.pool.device_pages],
             "statuses": sorted(r.status for r in reqs), "calls": calls, "launches": launches,
             "model_calls": dict(made), "seen": seen,
             "tokens": {r.rid: list(map(int, r.tokens)) for r in reqs},
             "rows": {rid: np.stack(v) for rid, v in rows.items()}, "own": own,
             "finite": all(np.isfinite(r).all() for v in rows.values() for r in v)}
    del eng
    return facts


def _static_rows(model, params, mesh, forced=None, gen=TP_SERVE_GEN):
    """The static loop of `run_static` (the trace's REQUESTS prompts, `gen`
    tokens each) with every step's logits kept, greedy or fed `forced`
    [N, gen]. -> (tokens [N, gen], {rid: rows [gen, V]})."""
    import numpy as np
    import torch
    from repro_torch.config.base import ShapeConfig
    from repro_torch.serve import decode_step_batch, static_batch_from_requests, synth_requests
    from repro_torch.train.steps import StepSpec, build_decode_step, build_prefill_step
    cfg = model.cfg
    reqs = synth_requests(cfg, REQUESTS, PROMPT, gen, np.random.default_rng(SEED))
    n, total = len(reqs), PROMPT + gen
    prefill, _ = build_prefill_step(model, ShapeConfig("p", "prefill", PROMPT, n),
                                    StepSpec(cache_len=total), mesh=mesh)
    decode, _ = build_decode_step(model, ShapeConfig("d", "decode", total, n), mesh=mesh)
    rows, toks = [], []
    with torch.no_grad():
        logits, cache = prefill(params, static_batch_from_requests(cfg, reqs, "cuda"))
        for i in range(gen):
            rows.append(logits.float().cpu().numpy())
            t = (torch.argmax(logits, -1) if forced is None
                 else torch.from_numpy(np.asarray(forced)[:, i]).cuda())
            toks.append(t.cpu().numpy())
            if i < gen - 1:
                logits, cache = decode(params, cache, decode_step_batch(
                    cfg, t[:, None].to(torch.int32), None), PROMPT + i)
    rows = np.stack(rows, 1)
    return np.stack(toks, 1).astype(np.int32), {i: rows[i] for i in range(n)}


def _near_tie_parting(reference_rows, want, got, tol: float) -> bool:
    """Two greedy runs' tokens agree, or first part where the reference's
    top-2 margin lies within 2 tol of its row's max |logit|."""
    import numpy as np
    for i in range(want.shape[0]):
        parted = np.flatnonzero(want[i] != got[i])
        if parted.size:
            w = reference_rows[i][parted[0]]
            top = np.sort(w)
            if top[-1] - top[-2] > 2 * tol * np.abs(w).max():
                return False
    return True


def _attn_serve_launch_checks(run, L, kv_dtype):
    """An "attn" stack's engine run (`_serve_on`): its launches as its
    calls imply, L paged decodes a tick (int8: L fused writes), 2L + 1
    RMSNorms a model call; every launch recorded (the shapes: the caller
    checks `seen`)."""
    mc = run["model_calls"]
    ln = run["launches"]
    out = {"decode_launches": ln["flash_decode_paged"] == L * mc["decode_slots"]
           and ln["flash_decode_paged_tensor_core"] == ln["flash_decode_paged"],
           "rmsnorm_launches": ln["rmsnorm"] == (2 * L + 1) * sum(mc.values()),
           "every_launch_recorded": run["calls"] == ln}
    if kv_dtype == "int8":
        out["quantize_kv_write_launches"] = ln["quantize_kv_write"] == L * mc["decode_slots"]
    return out


def _tp_serve_cases(rank: int, world: int):
    """The tp_serve runs (TP_SERVE_LAYERS' comment), in the ddl_sharded
    ranks after the tp cases. The one-device references run on rank 0 and
    go to rank 1 over the mesh (`broadcast_object_list`). -> the rows'
    facts (rank 0's hold the comparisons)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.config.base import MeshSpec
    from repro_torch.configs import get_config
    from repro_torch.core.lms import offload as off
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import run_static
    from repro_torch.models import moe
    from repro_torch.models import sharding as shd
    from repro_torch.models.layers import tree_init
    from repro_torch.models.model import Model
    from repro_torch.serve import synth_requests
    from repro_torch.train.steps import init_params, place_params
    t0 = time.monotonic()
    mesh = make_mesh(MeshSpec(TP_MESH, DDL_AXES))
    group = mesh.groups["model"]
    lead = rank == 0

    def share(obj):
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=group)
        return box[0]

    def public(run):
        """A run's facts for the JSON row (no rows), its launch signatures
        as `signatures`."""
        out = {k: v for k, v in run.items() if k not in ("rows", "own", "seen", "tokens")}
        out["signatures"] = sorted(run["seen"])
        return out

    def rows_sum(run):
        return _checksums({str(k): torch.from_numpy(v) for k, v in sorted(run["rows"].items())})
    out = {"rank": rank}
    # (i) qwen2.5-14b at TP_SERVE_LAYERS layers: the one-device references
    cfg = dataclasses.replace(get_config(ARCH), num_layers=TP_SERVE_LAYERS)
    model = Model(cfg, attn_impl="blockwise")
    kernel_model = Model(cfg, attn_impl="pallas")
    L = TP_SERVE_LAYERS
    ref = None
    if lead:
        full = model.init(SEED, "cuda")
        ref = {kv: _serve_on(model, full, kv, None, preempt_at=TP_SERVE_PREEMPT_TICK,
                             gen=TP_SERVE_GEN) for kv in ("model", "int8")}
        ref["static"] = _static_rows(kernel_model, full, None)
        del full
        gc.collect()
        torch.cuda.empty_cache()
    forced = share(None if ref is None else {kv: ref[kv]["tokens"] for kv in ("model", "int8")}
                   | {"static": ref["static"][0]})
    blocks = init_params(model, SEED, "cuda", mesh=mesh)
    engine = {}
    for kv in ("model", "int8"):
        run = _serve_on(model, blocks, kv, mesh, forced=forced[kv],
                        preempt_at=TP_SERVE_PREEMPT_TICK, gen=TP_SERVE_GEN)
        facts = public(run)
        facts["checks"] = _attn_serve_launch_checks(run, L, kv)
        facts["rows_checksums"] = rows_sum(run)
        facts["own"] = run["own"]
        if lead:
            facts["against_one_device"] = _deviation(ref[kv]["rows"], run["rows"])
            facts["one_device"] = public(ref[kv])
        engine[kv] = facts
    out["engine"] = engine
    # run_static on the mesh (the kernel prefill), and its loop teacher-forced
    t1 = time.monotonic()
    reqs = synth_requests(cfg, REQUESTS, PROMPT, TP_SERVE_GEN, np.random.default_rng(SEED))
    with launch_signatures() as (seen, calls, launches):
        toks, timing = run_static(kernel_model, reqs, PROMPT, TP_SERVE_GEN, params=blocks,
                                  device="cuda", mesh=mesh)[1:]
    forced_toks, forced_rows = _static_rows(kernel_model, blocks, mesh, forced["static"])
    static = {"seconds": time.monotonic() - t1, "timing": timing, "launches": launches,
              "tokens_checksum": int(np.asarray(toks, np.int64).sum()),
              "tokens": toks.tolist(),
              "rows_checksums": _checksums({str(k): torch.from_numpy(v)
                                            for k, v in sorted(forced_rows.items())}),
              "signatures": sorted(seen),
              "checks": {"every_launch_recorded": calls == launches,
                         "prefill_wgmma_launches_L":
                             launches["flash_attention_wgmma"] == L,
                         "decode_launches": launches["flash_decode"] == L * (TP_SERVE_GEN - 1)
                         and launches["flash_decode_tensor_core"]
                         == L * (TP_SERVE_GEN - 1)}}
    if lead:
        one_toks, one_rows = ref["static"]
        static["forced_against_one_device"] = _deviation(one_rows, forced_rows)
        static["greedy_same_or_near_tie"] = _near_tie_parting(one_rows, one_toks, toks,
                                                              2.0 ** -5)
        static["greedy_identical_requests"] = int((one_toks == toks).all(axis=1).sum())
    out["static"] = static
    # under the serve plan: params (and the KV backlog) pinned per rank,
    # bitwise the resident run of the plan's page geometry
    plan = _tp_serve_plan(cfg)
    geo = {"page_size": plan.kv_paging.page_size, "device_pages": plan.kv_paging.device_pages,
           "host_pages": plan.kv_paging.host_pages}
    resident = _serve_on(model, blocks, "model", mesh, geometry=geo, requests=TP_PLAN_REQUESTS,
                         gen=TP_SERVE_GEN)
    placed = place_params(blocks, plan, "cuda")
    del blocks
    gc.collect()
    torch.cuda.empty_cache()
    before = off.swap_counters()
    planned = _serve_on(model, placed, "model", mesh, plan=plan, requests=TP_PLAN_REQUESTS,
                        gen=TP_SERVE_GEN)
    moved = off.swap_counters().get("lms.swap_in_bytes.params", 0) - before.get(
        "lms.swap_in_bytes.params", 0)
    same = (resident["tokens"] == planned["tokens"]
            and all(resident["rows"][k].tobytes() == planned["rows"][k].tobytes()
                    for k in resident["rows"]))
    out["serve_plan"] = {
        "plan": _plan_row(plan), "geometry": geo, "resident": public(resident),
        "peak_over_plan": (planned["peak_bytes"] - planned["engine_base_bytes"])
        / plan.peak_bytes,
        "planned": public(planned), "swap_in_bytes_params": moved,
        "checks": {"plan_puts_params_on_the_host": plan.residency.get("params") == "host",
                   "planned_bitwise_resident": same,
                   "peak_within_plan": planned["peak_bytes"] - planned["engine_base_bytes"]
                   <= SERVE_PLAN_PEAK_OVER_PLAN * plan.peak_bytes,
                   **{f"planned_{k}": v for k, v in
                      _attn_serve_launch_checks(planned, L, "model").items()},
                   **{f"resident_{k}": v for k, v in
                      _attn_serve_launch_checks(resident, L, "model").items()}}}
    del placed, resident, planned
    off.release_arenas()
    gc.collect()
    torch.cuda.empty_cache()
    out["qwen_seconds"] = time.monotonic() - t0

    # (ii) qwen3-moe-235b-a22b under expert parallelism: one layer
    t1 = time.monotonic()
    mcfg = _moe_cfg(1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    defs = moe.moe_defs(mcfg)
    whole = tree_init(defs, gen, "cuda")
    specs = shd.spec_tree(defs, mesh)
    mine = {k: shd.local_shard(v, specs[k], mesh).contiguous() for k, v in whole.items()}
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, mcfg.d_model, generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    layer = {}
    # the published capacity factor, and half of it (the capacity drops
    # assignments: the drop mask on both paths)
    for cf in (mcfg.moe_capacity_factor, mcfg.moe_capacity_factor / 2):
        c = dataclasses.replace(mcfg, moe_capacity_factor=cf)
        with torch.no_grad():
            (y_ep, aux_ep), dropped_ep = _moe_dropped(moe.apply_moe, c, mine, x, mesh)
            (y_one, aux_one), dropped_one = _moe_dropped(moe.apply_moe, c, whole, x)
            err = float((y_ep.float() - y_one.float()).abs().max())
            top = float(y_one.float().abs().max())
            ep_ms = time_ms(lambda: moe.apply_moe(c, mine, x, mesh), 3)
            one_ms = time_ms(lambda: moe.apply_moe(c, whole, x), 3)
        layer[str(cf)] = {
            "capacity_factor": cf, "capacity": moe._capacity(c, TRAIN_BATCH * TRAIN_SEQ),
            "dropped": [dropped_ep, dropped_one], "aux": [float(aux_ep), float(aux_one)],
            "err_over_max": err / top, "expert_parallel_ms": ep_ms, "one_device_ms": one_ms,
            "y_checksum": _checksums({"y": y_ep}),
            "checks": {"within_2**-5": err <= 2.0 ** -5 * top,
                       "dropped_equal": dropped_ep == dropped_one,
                       "aux_bitwise": float(aux_ep) == float(aux_one)}}
        del y_ep, y_one
    halved = layer[str(mcfg.moe_capacity_factor / 2)]
    halved["checks"]["drops_some"] = halved["dropped"][0] > 0
    out["moe_layer"] = {
        "tokens": TRAIN_BATCH * TRAIN_SEQ, "experts_a_rank": mine["w_gate"].shape[0],
        "tol_over_max": 2.0 ** -5, "by_capacity_factor": layer,
        "y_checksums": [v["y_checksum"] for v in layer.values()],
        "seconds": time.monotonic() - t1,
        "checks": {f"{k}_cf_{cf}": v for cf, run in layer.items()
                   for k, v in run["checks"].items()}}
    del whole, mine, x
    gc.collect()
    torch.cuda.empty_cache()
    # the engine at TP_MOE_LAYERS layers with k = E against the dense pass
    t1 = time.monotonic()
    ecfg = _moe_cfg(TP_MOE_LAYERS, every=True)
    emodel = Model(ecfg, attn_impl="blockwise")
    eblocks = init_params(emodel, SEED, "cuda", mesh=mesh)
    run = _serve_on(emodel, eblocks, "model", mesh, gen=TP_SERVE_GEN)
    del eblocks
    gc.collect()
    torch.cuda.empty_cache()
    facts = public(run)
    facts["checks"] = _attn_serve_launch_checks(run, TP_MOE_LAYERS, "model")
    facts["rows_checksums"] = rows_sum(run)
    if lead:
        full = emodel.init(SEED, "cuda")
        reqs = _mesh_requests(ecfg, run["tokens"])
        dense = {r.rid: _dense_rows(emodel, full, r) for r in reqs}
        facts["against_dense"] = _deviation(dense, run["rows"])
        del full
        gc.collect()
        torch.cuda.empty_cache()
    facts["seconds"] = time.monotonic() - t1
    out["moe_engine"] = facts
    out["seconds"] = time.monotonic() - t0
    return out


def _mesh_requests(cfg, tokens):
    """The trace's requests with the tokens a run generated (for
    `_dense_rows`)."""
    import numpy as np
    from repro_torch.serve import synth_requests
    reqs = synth_requests(cfg, REQUESTS, PROMPT, TP_SERVE_GEN, np.random.default_rng(SEED))
    for r in reqs:
        r.tokens = list(tokens[r.rid])
    return reqs


def tp_serve_phase(line, checked, ranks):
    """Serving on the model axis (TP_SERVE_LAYERS' comment), from the runs
    `_tp_serve_cases` made in the ddl_sharded ranks. Row `tp_serve`. ->
    {kernel: launches on the serve-on-mesh path} (rank 0's: the engines at
    both KV widths, `run_static`, the planned engine, the MoE engine)."""
    r0 = ranks[0]
    eng, st, sp, ml, me = (r0["engine"], r0["static"], r0["serve_plan"], r0["moe_layer"],
                           r0["moe_engine"])
    tol = 2.0 ** -5

    def same(key):
        return all(json.dumps(key(r), sort_keys=True) == json.dumps(key(r0), sort_keys=True)
                   for r in ranks)
    checks = {
        **{f"engine_{kv}_within_2**-5_of_one_device": eng[kv]["against_one_device"]["worst"]
           <= tol for kv in ("model", "int8")},
        **{f"engine_{kv}_{k}": all(r["engine"][kv]["checks"][k] for r in ranks)
           for kv in ("model", "int8") for k in eng[kv]["checks"]},
        **{f"engine_{kv}_preempted_and_spilled": eng[kv]["pool"]["preempted_requests"] >= 1
           and eng[kv]["pool"]["spilled_pages"] > 0 for kv in ("model", "int8")},
        **{f"engine_{kv}_all_ok": eng[kv]["statuses"] == ["ok"] * REQUESTS
           for kv in ("model", "int8")},
        "engine_rows_bitwise_across_ranks": same(lambda r: [r["engine"][kv]["rows_checksums"]
                                                            for kv in ("model", "int8")]),
        "engine_tokens_and_pool_same_across_ranks": same(
            lambda r: [[r["engine"][kv][k] for k in ("own", "pool", "ticks", "statuses")]
                       for kv in ("model", "int8")]),
        "engine_finite": all(r["engine"][kv]["finite"] for r in ranks for kv in ("model", "int8")),
        "static_forced_within_2**-5_of_one_device":
            st["forced_against_one_device"]["worst"] <= tol,
        "static_greedy_same_or_parted_at_a_near_tie": st["greedy_same_or_near_tie"],
        "static_same_across_ranks": same(lambda r: [r["static"]["tokens"],
                                                    r["static"]["rows_checksums"]]),
        **{f"static_{k}": all(r["static"]["checks"][k] for r in ranks)
           for k in st["checks"]},
        **{f"serve_plan_{k}": all(r["serve_plan"]["checks"][k] for r in ranks)
           for k in sp["checks"]},
        **{f"moe_layer_{k}": all(r["moe_layer"]["checks"][k] for r in ranks)
           for k in ml["checks"]},
        "moe_layer_same_across_ranks": same(lambda r: r["moe_layer"]["y_checksums"]),
        "moe_engine_within_2**-5_of_the_dense_pass": me["against_dense"]["worst"] <= tol,
        **{f"moe_engine_{k}": all(r["moe_engine"]["checks"][k] for r in ranks)
           for k in me["checks"]},
        "moe_engine_rows_bitwise_across_ranks": same(lambda r: r["moe_engine"]["rows_checksums"]),
    }
    runs = [r["engine"][kv] for r in ranks for kv in ("model", "int8")] + [
        r[k] for r in ranks for k in ("static", "moe_engine")] + [
        r["serve_plan"][k] for r in ranks for k in ("resident", "planned")]
    unchecked = sorted({_tuplify(sig) for run in runs for sig in run["signatures"]} - checked)
    checks["every_launch_shape_checked"] = not unchecked
    drop = ("own", "rows_checksums", "signatures")
    row = {"phase": "tp_serve", "arch": ARCH, "moe_arch": MOE, "card": line,
           "mesh": "x".join(map(str, TP_MESH)), "backend": "gloo (host-staged)",
           "note": "two ranks time-slice one card over gloo: correctness, not serving speed "
                   "across cards (scripts/ddl_four_cards.py --phases h)",
           "layers": TP_SERVE_LAYERS, "moe_layers": TP_MOE_LAYERS,
           "engine": {kv: {k: v for k, v in eng[kv].items() if k not in drop}
                      for kv in ("model", "int8")},
           "static": {k: v for k, v in st.items()
                      if k not in ("tokens", "rows_checksums", "signatures")},
           "serve_plan": {k: ({kk: vv for kk, vv in v.items() if kk != "signatures"}
                              if k in ("resident", "planned") else v) for k, v in sp.items()},
           "moe_layer": ml, "unchecked_signatures": unchecked,
           "moe_engine": {k: v for k, v in me.items() if k not in drop},
           "seconds_in_ranks": [r["seconds"] for r in ranks], "checks": checks}
    emit(row)
    emit({"phase": "seconds", "of": "tp_serve_in_ranks",
          "seconds": max(r["seconds"] for r in ranks)})
    if not all(checks.values()):
        raise AssertionError(f"tp_serve: failed checks {[k for k, v in checks.items() if not v]}")
    launches = {}
    for run in (eng["model"], eng["int8"], sp["planned"], me):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k, v in st["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return {"flash_attention_fwd_wgmma": launches.get("flash_attention_wgmma", 0),
            "flash_decode_bf16": launches.get("flash_decode", 0),
            "flash_decode_paged_bf16": eng["model"]["launches"]["flash_decode_paged"]
            + sp["planned"]["launches"]["flash_decode_paged"]
            + me["launches"]["flash_decode_paged"],
            "flash_decode_paged_int8": eng["int8"]["launches"]["flash_decode_paged"],
            "quantize_rows": eng["int8"]["launches"]["quantize_rows"],
            "quantize_kv_write": eng["int8"]["launches"]["quantize_kv_write"],
            "rmsnorm": launches.get("rmsnorm", 0)}


def _moe_cfg(layers: int, arch: str = MOE, ample: bool = False, every: bool = False):
    """`arch` at its published width cut to `layers`; `ample`: capacity for
    every assignment (cf = E / k), so no call drops one; `every`: each
    token routed to every expert (k = E, cf 1), so the layer is a
    continuous function of its input."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if every:
        cfg = dataclasses.replace(cfg, experts_per_token=cfg.num_experts,
                                  moe_capacity_factor=1.0)
    elif ample:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                                  / cfg.experts_per_token)
    return cfg


def _moe_dropped(fn, *args, **kw):
    """fn(*args, **kw) with the MoE layers' dropped assignments counted
    from 0. -> (fn's result, dropped)."""
    from repro_torch.models import moe
    moe.reset_dropped()
    out = fn(*args, **kw)
    return out, moe.dropped()


def _moe_layer_run():
    """`apply_moe` on one layer of qwen3-moe-235b-a22b's FFN (random params
    from the seed, on the card) over TRAIN_BATCH x TRAIN_SEQ tokens with
    ample capacity, against `apply_moe_dense_fallback` (every expert on
    every token): max |diff| over max |dense|, held to 2**-5 (4 bf16
    ulps: the dispatched path sums a token's k rows in f32 and rounds once,
    the dense one contracts all E experts' rows, the unrouted ones at
    weight 0, in one bf16 product); each path timed by CUDA events."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_init
    cfg = _moe_cfg(1, ample=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    p = tree_init(moe.moe_defs(cfg), gen, "cuda")
    x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    with torch.no_grad():
        (y, aux), dropped = _moe_dropped(moe.apply_moe, cfg, p, x)
        dense = moe.apply_moe_dense_fallback(cfg, p, x)
        err = float((y.float() - dense.float()).abs().max())
        top = float(dense.float().abs().max())
        ms = time_ms(lambda: moe.apply_moe(cfg, p, x), 5)
        dense_ms = time_ms(lambda: moe.apply_moe_dense_fallback(cfg, p, x), 3)
    return {"tokens": TRAIN_BATCH * TRAIN_SEQ, "capacity_factor": cfg.moe_capacity_factor,
            "capacity": moe._capacity(cfg, TRAIN_BATCH * TRAIN_SEQ), "dropped": dropped,
            "aux": float(aux), "max_abs_err": err, "max_abs_dense": top,
            "err_over_max": err / top, "tol_over_max": 2.0 ** -5,
            "dispatched_ms": ms, "dense_ms": dense_ms}


def _moe_calls(model):
    """Count the serve calls a run makes: {"prefill_chunk", "decode_slots"},
    each wrapped on the model."""
    counts = {"prefill_chunk": 0, "decode_slots": 0}
    for name in counts:
        fn = getattr(model, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        setattr(model, name, counted)
    return counts


def _moe_serve(model, params, checked, *, requests=REQUESTS, gen=GEN, preempt_at=None,
               plan=None):
    """Serve `requests` of the trace's prompts (PROMPT tokens, `gen` greedy
    tokens) on SLOTS slots at the trace's page geometry, a preemption at
    tick `preempt_at` if given, under `plan` if given (`_serve_on`). ->
    (facts, tokens, rows)."""
    geometry = {"page_size": PAGE, "device_pages": DEVICE_PAGES,
                "host_pages": 2 * SLOTS * (MAX_LEN // PAGE)}
    run = _serve_on(model, params, None, None, plan=plan, geometry=geometry,
                    preempt_at=preempt_at, requests=requests, gen=gen)
    calls_made = run["model_calls"]
    unchecked = run["seen"] - checked
    facts = {"layers": model.cfg.num_layers, "requests": requests, "gen": gen,
             **{k: run[k] for k in ("run_s", "decode_tok_s", "ticks", "tpot_p50_s",
                                    "ttft_mean_s", "dropped", "swap_in_bytes_params",
                                    "launches", "pool_invariants")},
             "calls": calls_made, "peak_bytes": run["peak_bytes"] - run["base_bytes"],
             "preempted_requests": run["pool"]["preempted_requests"],
             "spilled_pages": run["pool"]["spilled_pages"],
             "unchecked": sorted(map(str, unchecked)),
             "checks": {"all_ok": run["statuses"] == ["ok"] * requests
                        and all(len(t) == gen for t in run["tokens"].values()),
                        "finite": run["finite"],
                        **_attn_serve_launch_checks(run, model.cfg.num_layers, "model"),
                        "every_launch_shape_checked": not unchecked}}
    if preempt_at is not None:
        facts["checks"]["preempted"] = facts["preempted_requests"] >= 1
    if plan is not None:
        facts["swap_in_bytes_predicted"] = (calls_made["prefill_chunk"] * _sweep_bytes(params, CHUNK)
                                            + calls_made["decode_slots"]
                                            * _sweep_bytes(params, SLOTS))
    return facts, run["tokens"], {rid: list(r) for rid, r in run["rows"].items()}


def _same_rows(a, b) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
        for k in a)


def _moe_plan(cfg, budget: int):
    """The serve plan of the trace's shape at `cfg` under `budget`."""
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.core.lms.planner import PlanRequest, plan
    return plan(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", MAX_LEN, SLOTS),
                            mesh=MeshSpec((1, 1), ("data", "model")),
                            lms=LMSConfig(hbm_budget=budget), serve=True, slots=SLOTS,
                            backlog_slots=2 * SLOTS, page_size=PAGE))


def _moe_planned_pair(model, params, checked, budget: int):
    """The short trace (MOE_PLAN_REQUESTS requests, MOE_PLAN_GEN tokens, a
    preemption at MOE_PLAN_PREEMPT_TICK) resident, then the params placed
    as the serve plan of `budget` says (the resident copy freed first) and
    the same trace under it. -> {"resident", "planned", "plan", ...}."""
    import gc
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.train.steps import place_params
    plan = _moe_plan(model.cfg, budget)
    kw = dict(requests=MOE_PLAN_REQUESTS, gen=MOE_PLAN_GEN, preempt_at=MOE_PLAN_PREEMPT_TICK)
    res, res_toks, res_rows = _moe_serve(model, params, checked, **kw)
    t0 = time.monotonic()
    placed = place_params(params, plan, "cuda")
    torch.cuda.synchronize()
    place_s = time.monotonic() - t0
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    pl, toks, rows = _moe_serve(model, placed, checked, plan=plan, **kw)
    pl["tokens_bitwise"] = toks == res_toks
    pl["logits_bitwise"] = _same_rows(rows, res_rows)
    bound = SERVE_PLAN_PEAK_OVER_PLAN * plan.peak_bytes
    pl["checks"].update({
        "params_on_host": plan.residency.get("params") == "host",
        "tokens_bitwise": pl["tokens_bitwise"], "logits_bitwise": pl["logits_bitwise"],
        "dropped_as_resident": pl["dropped"] == res["dropped"],
        "swap_bytes_exact": pl["swap_in_bytes_params"] == pl["swap_in_bytes_predicted"],
        "peak_within_plan": pl["peak_bytes"] <= bound})
    out = {"plan": _plan_row(plan), "place_s": place_s, "pinned_bytes": off.pinned_bytes(),
           "resident": res, "planned": pl}
    del placed
    off.release_arenas()
    return out


def _moe_pinned_bytes() -> int:
    """The largest pinned state of the moe phase: the training's at
    MOE_TRAIN_LAYERS layer (params and AdamW state, `_state_layout`), or the
    serve params of MOE_SERVE_LAYERS or MOE_GROK_LAYERS layers."""
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod

    def paths(cfg):
        return [(path, d.shape, DTYPES[d.dtype])
                for path, d in steps_mod._def_paths(Model(cfg).param_defs())]
    train = steps_mod._state_layout(paths(_moe_cfg(MOE_TRAIN_LAYERS)), "adamw", True, True)[0]
    serve = [sum(steps_mod._leaf_bytes(shape, dt) for _, shape, dt in paths(cfg))
             for cfg in (_moe_cfg(MOE_SERVE_LAYERS), _moe_cfg(MOE_GROK_LAYERS, arch=MOE_GROK))]
    return max([train] + serve)


def _moe_static(model, params, checked):
    """`run_static` on MOE_STATIC_REQUESTS prompts of MOE_STATIC_PROMPT
    tokens, MOE_STATIC_GEN new tokens each, through the prefill kernel,
    counts reset just before and read just after."""
    import numpy as np
    from repro_torch.launch.serve import run_static
    from repro_torch.models import moe
    from repro_torch.serve import synth_requests
    n, p, g = MOE_STATIC_REQUESTS, MOE_STATIC_PROMPT, MOE_STATIC_GEN
    reqs = synth_requests(model.cfg, n, p, g, np.random.default_rng(SEED))
    moe.reset_dropped()
    with launch_signatures() as (seen, calls, launches):
        _, toks, t = run_static(model, reqs, p, g, params=params, device="cuda")
    L = model.cfg.num_layers
    return {"requests": n, "prompt": p, "gen": g, "timings": t, "dropped": moe.dropped(),
            "launches": launches, "unchecked": sorted(map(str, seen - checked)),
            "checks": {
                "tokens": toks.shape == (n, g) and bool((toks >= 0).all()),
                "attention_launches": launches["flash_attention"] == L
                and launches["flash_attention_wgmma"] == L,
                "decode_launches": launches["flash_decode"] == L * (g - 1)
                and launches["flash_decode_tensor_core"] == L * (g - 1),
                "rmsnorm_launches": launches["rmsnorm"] == (2 * L + 1) * g,
                "every_launch_recorded": calls == launches,
                "every_launch_shape_checked": not (seen - checked)}}


def _moe_train_runs(checked):
    """MOE_TRAIN_LAYERS layer of qwen3-moe-235b-a22b, MOE_TRAIN_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ tokens, `Trainer.train` resident and under
    the plan of LMSConfig(hbm_budget=MOE_BUDGET) (params and AdamW state
    streamed from pinned memory, six activation classes offloaded): losses,
    grad norms and aux bitwise, the state's checksums (params, mu, nu,
    masters) bitwise; the swap bytes a step exactly the count: the stack in
    twice, the rest once, every param out once, the optimizer in and out
    once, and each offloaded activation out and in once (the bytes the
    policy tagged for offload, `lms.offload_bytes.*`); RMSNorm as the plan
    implies; the peak within 1.10 x the plan's."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.config.base import LMSConfig
    from repro_torch.core.lms import offload as off
    from repro_torch.obs import get_obs
    L, n = MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS
    base = _train_config(L, arch=MOE, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=n)
    runs = {}
    for name, lms in (("resident", LMSConfig(enabled=False)),
                      ("streamed", LMSConfig(hbm_budget=MOE_BUDGET))):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reg = get_obs().registry

        def offloaded():
            return {k: reg.counter(k).value for k in reg.names()
                    if k.startswith("lms.offload_bytes.")}
        offl = offloaded()
        (trainer, state, hist, facts), dropped = _moe_dropped(
            _lms_run, dataclasses.replace(base, lms=lms), n)
        offl = {k: (v - offl.get(k, 0)) / n for k, v in offloaded().items()}
        plan = trainer.plan
        o = state.opt
        sums = {"params": _checksums(state.params), "mu": _checksums(o.mu),
                "nu": _checksums(o.nu), "master": _checksums(o.master)}
        launches = facts["launches"]
        swap = {k: v for k, v in facts["swap_per_step"].items() if "_bytes." in k and v}
        row = {"plan": _plan_row(plan), "loss": [r["loss"] for r in hist],
               "ce": [r["ce"] for r in hist], "aux": [r["aux"] for r in hist],
               "grad_norm": [r["grad_norm"] for r in hist],
               "step_s": [r["time_s"] for r in hist],
               "median_step_s_after_1": statistics.median(r["time_s"] for r in hist[1:]),
               "setup_s": facts["setup_s"], "allocated_before_bytes": before,
               "max_memory_allocated_bytes": facts["peak_bytes"] - before,
               "pinned_bytes": facts["pinned_bytes"], "swap_per_step": swap,
               "dropped": dropped, "launches": launches, "checksums": sums,
               "offload_bytes_per_step": offl,
               "checks": {"finite": all(math.isfinite(r["loss"]) for r in hist),
                          "aux_positive": all(r["aux"] > 0 for r in hist),
                          "rmsnorm_launches": launches["rmsnorm"]
                          == n * _implied_rmsnorm_launches(plan, L),
                          "no_other_launches": all(v == 0 for k, v in launches.items()
                                                   if not k.startswith("rmsnorm")),
                          "every_launch_recorded": facts["calls"] == launches,
                          "every_launch_shape_checked": not (facts["seen"] - checked)}}
        if plan is not None:
            p = state.params
            stack = off.tree_bytes(p["decoder"]["stack0"])
            opt = sum(off.tree_bytes(t) for t in (o.mu, o.nu, o.master))
            acts = sum(offl.values())
            row["swap_per_step_count"] = {
                "lms.swap_in_bytes.params": 2 * stack + off.tree_bytes(p["embed"]["lm_head"])
                + off.tree_bytes(p["final_norm"]) + TRAIN_BATCH * TRAIN_SEQ
                * base.model.d_model * 4,
                "lms.swap_out_bytes.params": off.tree_bytes(p),
                "lms.swap_in_bytes.optimizer": opt, "lms.swap_out_bytes.optimizer": opt,
                "lms.swap_in_bytes.activations": acts, "lms.swap_out_bytes.activations": acts}
        runs[name] = row
        del trainer, state, hist, o
        torch.cuda.empty_cache()
        off.release_arenas()
    return runs


def _moe_rank(rank: int, world: int, line, checked):
    """The moe phase's runs, in a process of its own on the card (its
    pinned memory goes back to the host when it exits). -> the rows'
    facts."""
    import gc
    import threading
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.models.model import Model
    out = {}
    pinned = {"bytes": _moe_pinned_bytes()}

    def reserve():
        t = time.monotonic()
        try:
            off.reserve_pinned(pinned["bytes"], "cuda")
        except BaseException as e:  # re-raised by the main thread after the join
            pinned["error"] = e
        pinned["seconds"] = time.monotonic() - t
    reserving = threading.Thread(target=reserve)
    reserving.start()
    out["pinned"] = pinned
    t0 = time.monotonic()
    out["layer"] = _moe_layer_run()
    out["layer"]["seconds"] = time.monotonic() - t0
    # 2 layers, every token routed to every expert: the engine against the
    # dense pass. Top-k routing is discontinuous: where a token's k-th and
    # (k+1)-th router probabilities lie closer than the two passes' bf16
    # differences, they pick another expert and the row moves by a share of
    # the layer's output (top-8 of 128 at this width: the worst row 0.37 of
    # its max |logit| off the dense pass, an argmax flip at a wide margin in
    # int8); with k = E (and capacity for all) the layer is continuous and
    # the rows are held to the bounds
    t0 = time.monotonic()
    model = Model(_moe_cfg(MOE_CHECK_LAYERS, every=True), attn_impl="blockwise")
    params = model.init(SEED, "cuda")
    (row, _), dropped = _moe_dropped(engine_phase, model, params, "model", line, checked,
                                     dense_tol=2.0 ** -5)
    (row8, _), dropped8 = _moe_dropped(engine_phase, model, params, "int8", line, checked,
                                       dense_tol=2.0 ** -4)
    out["check"] = {"dropped": dropped, "dropped_int8": dropped8,
                    "decode_launches": row["decode_launches"],
                    "int8_decode_launches": row8["decode_launches"],
                    "quantize_kv_write_launches": row8["quantize_kv_write_launches"],
                    "quantize_launches": row8["quantize_launches"],
                    "dense": row["dense"], "dense_int8": row8["dense"],
                    "seconds": time.monotonic() - t0}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    # MOE_SERVE_LAYERS layers at the published capacity factor
    t0 = time.monotonic()
    model = Model(_moe_cfg(MOE_SERVE_LAYERS), attn_impl="blockwise")
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t0
    out["engine"], _, _ = _moe_serve(model, params, checked, preempt_at=MOE_PREEMPT_TICK)
    out["static"] = _moe_static(Model(model.cfg, attn_impl="pallas"), params, checked)
    reserving.join()
    if "error" in pinned:
        raise pinned.pop("error")
    out["serve_plan"] = _moe_planned_pair(model, params, checked, MOE_BUDGET)
    out["serve_s"] = time.monotonic() - t0
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    # grok-1-314b at MOE_GROK_LAYERS layers
    t0 = time.monotonic()
    model = Model(_moe_cfg(MOE_GROK_LAYERS, arch=MOE_GROK), attn_impl="blockwise")
    params = model.init(SEED, "cuda")
    out["grok"] = _moe_planned_pair(model, params, checked, MOE_GROK_BUDGET)
    out["grok"]["seconds"] = time.monotonic() - t0
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out["train"] = _moe_train_runs(checked)
    out["train_s"] = time.monotonic() - t0
    return out


def moe_phase(line, checked):
    """The MoE family at published width, in a process spawned on the card
    (`_moe_rank`). Rows: moe_layer, moe_serve, moe_train, moe_grok (see
    MOE's comment). -> {kernel: launches on the MoE path}."""
    t0 = time.monotonic()
    got = spawn_ranks("_moe_rank", 1, line, checked, timeout=MOE_TIMEOUT_S)[0]
    lay = got["layer"]
    emit({"phase": "moe_layer", "arch": MOE, "card": line, **lay,
          "checks": {"within_2**-5": lay["err_over_max"] <= lay["tol_over_max"],
                     "nothing_dropped": lay["dropped"] == 0,
                     "aux_positive": lay["aux"] > 0}})
    eng, st, sp, chk = got["engine"], got["static"], got["serve_plan"], got["check"]
    checks = {"check_nothing_dropped": chk["dropped"] == 0 and chk["dropped_int8"] == 0}
    checks.update({f"engine_{k}": v for k, v in eng["checks"].items()})
    checks.update({f"static_{k}": v for k, v in st["checks"].items()})
    checks.update({f"plan_resident_{k}": v for k, v in sp["resident"]["checks"].items()})
    checks.update({f"plan_{k}": v for k, v in sp["planned"]["checks"].items()})
    checks["engine_pool_invariants"] = eng["pool_invariants"]
    emit({"phase": "moe_serve", "arch": MOE, "card": line, "layers": MOE_SERVE_LAYERS,
          "check_layers": MOE_CHECK_LAYERS, "requests": REQUESTS, "prompt": PROMPT,
          "gen": GEN, "slots": SLOTS, "hbm_budget": MOE_BUDGET, "init_s": got["init_s"],
          "pinned": got["pinned"],
          "check": chk, "engine": eng, "static": st, "serve_plan": sp,
          "seconds": got["serve_s"], "checks": checks})
    tr = got["train"]
    s, r = tr["streamed"], tr["resident"]
    tchecks = {f"streamed_{k}": v for k, v in s["checks"].items()}
    tchecks.update({f"resident_{k}": v for k, v in r["checks"].items()})
    tchecks.update({
        "plan_streams_params_and_optimizer": s["plan"]["residency"].get("params") == "host"
        and s["plan"]["residency"].get("optimizer") == "host",
        "loss_bitwise": s["loss"] == r["loss"], "aux_bitwise": s["aux"] == r["aux"],
        "grad_norm_bitwise": s["grad_norm"] == r["grad_norm"],
        "state_bitwise": s["checksums"] == r["checksums"],
        "swap_bytes_exact": all(s["swap_per_step"].get(k, 0) == v
                                for k, v in s["swap_per_step_count"].items())
        and set(s["swap_per_step"]) <= set(s["swap_per_step_count"]),
        "peak_within_plan": s["max_memory_allocated_bytes"]
        <= SERVE_PLAN_PEAK_OVER_PLAN * s["plan"]["peak_bytes"]})
    emit({"phase": "moe_train", "arch": MOE, "card": line, "layers": MOE_TRAIN_LAYERS,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": MOE_TRAIN_STEPS,
          "hbm_budget": MOE_BUDGET, **tr,
          "overhead": s["median_step_s_after_1"] / r["median_step_s_after_1"] - 1,
          "peak_vs_plan": {"measured": s["max_memory_allocated_bytes"],
                           "plan": s["plan"]["peak_bytes"],
                           "ratio": s["max_memory_allocated_bytes"] / s["plan"]["peak_bytes"]},
          "seconds": got["train_s"], "checks": tchecks})
    gk = got["grok"]
    gchecks = {f"resident_{k}": v for k, v in gk["resident"]["checks"].items()}
    gchecks.update({f"planned_{k}": v for k, v in gk["planned"]["checks"].items()})
    emit({"phase": "moe_grok", "arch": MOE_GROK, "card": line, "layers": MOE_GROK_LAYERS,
          "hbm_budget": MOE_GROK_BUDGET, **gk, "checks": gchecks})
    failed = [k for c in (checks, tchecks, gchecks) for k, v in c.items() if not v]
    lay_ok = lay["err_over_max"] <= lay["tol_over_max"] and lay["dropped"] == 0
    if failed or not lay_ok:
        raise AssertionError(f"moe: failed checks {failed}, layer ok {lay_ok}")
    launches = {
        "flash_attention_fwd_wgmma": st["launches"]["flash_attention_wgmma"],
        "flash_decode_bf16": st["launches"]["flash_decode"],
        "flash_decode_paged_bf16": eng["launches"]["flash_decode_paged"],
        "flash_decode_paged_int8": chk["int8_decode_launches"],
        "quantize_rows": chk["quantize_launches"],
        "quantize_kv_write": chk["quantize_kv_write_launches"],
        "rmsnorm": eng["launches"]["rmsnorm"] + st["launches"]["rmsnorm"]
        + r["launches"]["rmsnorm"]}
    emit({"phase": "moe_launches", "card": line, "launches": launches,
          "seconds": time.monotonic() - t0})
    return launches


def main() -> int:
    started = time.monotonic()
    line = device_phase()
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    def timed(fn, *args):
        """fn(*args), its seconds printed as a row of their own."""
        t = time.monotonic()
        out = fn(*args)
        emit({"phase": "seconds", "of": fn.__name__, "seconds": time.monotonic() - t})
        return out
    sass_row = timed(build_phase)
    kernels, checked = timed(kernel_phases, get_config(ARCH).num_layers)
    # first of the rank phases: its two ranks hold 2 x 27.8 GB of pinned
    # state and gloo's staging at once, which fits the machine's 96 GiB
    # only while this process has touched little host memory
    _, tp_ranks, tp_serve_ranks = timed(ddl_sharded_phase, line, checked)
    tp_launches = timed(tp_phase, line, checked, tp_ranks)
    tp_serve_launches = timed(tp_serve_phase, line, checked, tp_serve_ranks)
    f32_attention_row = timed(f32_attention_phase, line, checked)
    f32_decode_row = timed(f32_decode_phase, line, checked)
    f32_ssd_row = timed(f32_ssd_phase, line, checked)
    timed(decode_sync_phase, line)
    slot_launches = timed(reference_phase, line, checked)
    mamba_row, mamba_params = timed(mamba_phases, line, checked)
    mamba2_row = timed(mamba2_phases, line, checked, mamba_params)
    del mamba_params
    torch.cuda.empty_cache()
    timed(train_reference_phase, line, checked)
    trainer_row = timed(trainer_phase, line, checked)

    t0 = time.monotonic()
    model = Model(get_config(ARCH), attn_impl="blockwise")
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": ARCH, "seconds": time.monotonic() - t0,
          "params": model.cfg.param_count(),
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    model_row, tokens = timed(engine_phase, model, params, "model", line, checked)
    int8_row, _ = timed(engine_phase, model, params, "int8", line, checked)
    kernel_model = Model(get_config(ARCH), attn_impl="pallas")
    static_row = timed(static_phase, kernel_model, params, line, checked, tokens)
    timed(prefill_route_ab_phase, kernel_model, params, line)

    # the determinism and profile reruns at RERUN_LAYERS of the same
    # weights (the first layers), where a trace costs a twelfth of the 48's
    t0 = time.monotonic()
    short = Model(dataclasses.replace(get_config(ARCH), num_layers=RERUN_LAYERS),
                  attn_impl="blockwise")
    short_params = _first_layers(params, RERUN_LAYERS)
    runs = []
    for _ in range(2):
        eng, reqs, _, _ = _serve(short, short_params, "model")
        runs.append({r.rid: list(r.tokens) for r in reqs})
        del eng
    same = runs[0] == runs[1]
    emit({"phase": "determinism", "layers": RERUN_LAYERS, "identical_tokens": same,
          "seconds": time.monotonic() - t0})
    if not same:
        raise AssertionError("the model-width trace gave other tokens on a rerun")
    profiled = timed(profile_phase, short, short_params, line)
    timed(serve_plan_phase, short, short_params, line, checked)
    # the engine by KV width, from this run: tok/s of the engine rows,
    # launch calls per layer-tick of the profiled reruns
    emit({"phase": "engine_by_kv_width", "layers": model.cfg.num_layers,
          "profiled_layers": RERUN_LAYERS, "card": line,
          **{kv: {"decode_tok_s": row["decode_tok_s"],
                  "quantize_kv_write_launches": row["quantize_kv_write_launches"],
                  "launch_calls_per_layer_tick": profiled[kv]["launch_calls_per_layer_tick"],
                  "runtime_launch_calls": profiled[kv]["runtime_launch_calls"]}
             for kv, row in (("model", model_row), ("int8", int8_row))}})
    # the DDL ranks are processes of their own on the same card: free it
    del model, params, short, short_params
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    timed(dense_configs_phase, line, checked)
    ddl_row = timed(ddl_phase, line, checked)
    smoke_reference, sharded_smoke = timed(ddl_smoke_phase, line, checked)
    timed(ddl_sharded_smoke_phase, line, checked, smoke_reference, sharded_smoke)
    timed(lms_ddl_phase, line, checked, ddl_row)
    timed(ckpt_phase, line, checked)
    # the MoE runs pin up to ~46 GB in a child of their own; the LMS phases
    # after them size their depth from what the host has back
    avail = _mem_row()["MemAvailable"]
    moe_launches = timed(moe_phase, line, checked)
    _await_mem_available(avail - LMS_DDL_MEM_SLACK, LMS_DDL_MEM_WAIT_S)
    timed(lms_phases, line, checked)

    decode_kernel = "src/repro/kernels/flash_attention/decode_kernel.py"
    replaces = {
        "flash_attention_fwd_wgmma": "src/repro/kernels/flash_attention/kernel.py:76",
        "flash_attention_fwd_cuda_core": "src/repro/kernels/flash_attention/kernel.py:76",
        "flash_decode_bf16": f"{decode_kernel}:233",
        "flash_decode_int8": f"{decode_kernel}:233",
        "flash_decode_paged_bf16": f"{decode_kernel}:155",
        "flash_decode_paged_int8": f"{decode_kernel}:155",
        "flash_decode_cuda_core": f"{decode_kernel}:233",
        "quantize_rows": "src/repro/kernels/quantize/kernel.py:25",
        "quantize_kv_write": "src/repro/kernels/quantize/kernel.py:25",
        "dequantize_rows": "src/repro/kernels/quantize/kernel.py:46",
        "dequantize_sum_rows": "src/repro/kernels/quantize/kernel.py:46",
        "ssd_scan_tensor_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "ssd_scan_cuda_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "ssd_scan_final_state_tensor_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "ssd_scan_final_state_cuda_core": "src/repro/kernels/ssd_scan/kernel.py:72",
        "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:24",
    }
    csrc = "src/repro_torch/kernels/csrc"
    sources = {
        "flash_attention_fwd_wgmma": f"{csrc}/flash_attention_wgmma.cu",
        "flash_attention_fwd_cuda_core": f"{csrc}/flash_attention_fwd.cu",
        "flash_decode_bf16": f"{csrc}/flash_decode.cu",
        "flash_decode_int8": f"{csrc}/flash_decode.cu",
        "flash_decode_paged_bf16": f"{csrc}/flash_decode.cu",
        "flash_decode_paged_int8": f"{csrc}/flash_decode.cu",
        "flash_decode_cuda_core": f"{csrc}/flash_decode.cu",
        "quantize_rows": f"{csrc}/quantize.cu",
        "quantize_kv_write": f"{csrc}/quantize.cu",
        "dequantize_rows": f"{csrc}/quantize.cu",
        "dequantize_sum_rows": f"{csrc}/quantize.cu",
        "ssd_scan_tensor_core": f"{csrc}/ssd_scan_mma.cu",
        "ssd_scan_cuda_core": f"{csrc}/ssd_scan.cu",
        "ssd_scan_final_state_tensor_core": f"{csrc}/ssd_scan_mma.cu",
        "ssd_scan_final_state_cuda_core": f"{csrc}/ssd_scan.cu",
        "rmsnorm": f"{csrc}/rmsnorm.cu",
    }
    # each kernel's launches on its main path: the 48-layer static loop
    # (kernel #1's tensor-core route, kernel #3's), the f32 attention call
    # (kernel #1's CUDA-core route), the f32 decode call (that of #2 and #3),
    # the slot decode without an arena (int8), the 48-layer engine,
    # the 48-layer Mamba-2 forward (the scan's tensor-core route), the f32
    # scan call (its CUDA-core route), the 48-layer Mamba-2 engine's
    # prefills (the scan with its final state on the tensor cores) and the
    # f32 prefill scan (with its final state on the CUDA cores), the 4-layer
    # Trainer's 5 steps, the
    # full-width DDL Trainer's DDL_STEPS steps (rank 0; the pod sum), and error
    # feedback's path after them (the dequantizer)
    launches = {"flash_attention_fwd_wgmma": static_row["launches"]["flash_attention_wgmma"],
                "flash_attention_fwd_cuda_core":
                    f32_attention_row["launches"]["flash_attention_cuda_core"],
                "flash_decode_bf16": static_row["launches"]["flash_decode"],
                "flash_decode_int8": slot_launches["int8"]["flash_decode"],
                "flash_decode_paged_bf16": model_row["decode_launches"],
                "flash_decode_paged_int8": int8_row["decode_launches"],
                "flash_decode_cuda_core": f32_decode_row["launches"]["flash_decode_cuda_core"],
                "quantize_rows": int8_row["quantize_launches"],
                "quantize_kv_write": int8_row["quantize_kv_write_launches"],
                "dequantize_rows": ddl_row["error_feedback"]["launches"]["dequantize_rows"],
                "dequantize_sum_rows": sum(st["dequantize_sum_launches"]
                                           for st in ddl_row["steps"]),
                "ssd_scan_tensor_core": mamba_row["launches"]["ssd_scan_tensor_core"],
                "ssd_scan_cuda_core": f32_ssd_row["launches"]["ssd_scan_cuda_core"],
                "ssd_scan_final_state_tensor_core":
                    mamba2_row["resident"]["launches"]["ssd_scan_final_state_tensor_core"],
                "ssd_scan_final_state_cuda_core":
                    f32_ssd_row["final_state_launches"]["ssd_scan_final_state_cuda_core"],
                "rmsnorm": trainer_row["launches"]["rmsnorm"]}
    out = []
    for name, phase_rows in kernels.items():
        main_row = phase_rows[0]              # the main path's shape
        out.append({"name": name, "route": "cuda", "source": sources[name],
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in phase_rows),
                    "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                    "library_ms": main_row["library_ms"],
                    "moe_launches": moe_launches.get(name, 0),
                    "tp_launches": tp_launches.get(name, 0),
                    "tp_serve_launches": tp_serve_launches.get(name, 0)})
    emit({"phase": "seconds", "of": "chip_smoke", "seconds": time.monotonic() - started})
    emit({"phase": "sass_summary", "kernel": "fa_wgmma_kernel",
          "hgmma_total": sass_row["hgmma_total"], "hgmma": sass_row["hgmma"],
          "decode_kernel": "fd_mma_kernel", "decode_hmma_total": sass_row["decode_hmma_total"],
          "ssd_tensor_core": sass_row["ssd_tensor_core"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every rank has exited and every temp dir is gone: skip the
    # interpreter's teardown of this process's pinned arenas and CUDA
    # context after the last line (the command has outlasted the script's
    # own `seconds` row by 23-28 s), which the time limit counts
    os._exit(code)
