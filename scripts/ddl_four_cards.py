#!/usr/bin/env python3
"""DDL across four H100s of one host: one rank a card over NCCL, the
port's data-parallel training of qwen2.5-14b, olmo-1b and
qwen3-moe-235b-a22b at their published widths.

    python3 scripts/ddl_four_cards.py                # from the repo root
    python3 scripts/ddl_four_cards.py --phases c,f   # some of the phases

Needs a machine with 4 cards: it raises unless torch.cuda.device_count()
>= 4. It prints each card's `nvidia-smi --query-gpu=name,power.limit`
line, the host's MemAvailable and core count, NCCL's version and
`nvidia-smi topo -m`; builds the kernels; then runs each phase in 4 ranks
started with the spawn method (a `FileStore` rendezvous in a temp dir, a
timeout on every spawn), rank r on cuda:r over NCCL, and prints one JSON
row a phase (the whole rows also go to chiprun_out/ddl_four_cards.json).
2048 tokens a rank a step, from the synthetic stream; 3 steps a run.

(a) Resident DDL on a 2x2x1 mesh with compress_dcn (the int8 pod hop), at
    the most layers of 1-4 whose resident state fits the card: the
    overlapped backward with its reductions on the DDL queue, the same
    with them issued inline in the backward (`ReductionQueue.put`
    patched), and serialized (`DDLConfig(overlap_grads=False)`). Held:
    queued bitwise inline on every rank (losses, grad norms, every param's
    checksum after each step, the optimizer state's after the last);
    replicas in sync; serialized within 2e-3 relative of queued from step 2
    on, step 1's loss equal; the kernels' launches as the leaf sizes imply.
    Two diagnostic reruns of the queued step, each bitwise the queued run:
    with the queue's stream and the process groups' NCCL streams at high
    priority, and with Python's thread switch interval at 0.5 ms (the
    worker's and the backward's host work share the GIL).
(b) LMS + DDL on the 2x2x1 mesh with compress_dcn under
    LMSConfig(hbm_budget=16e9) (params, grads and the AdamW state in
    pinned host memory, each layer's grads reduced on the queue and sunk
    to the host), at the most layers whose four ranks' pinned state fits
    80% of MemAvailable; the plan's overlapped run, then serialized. Held:
    replicas in sync, finite losses, step 1's loss equal, later steps
    within 2e-3 relative.
(c) zero1 under LMS on a 1x4x1 mesh (uncompressed: no pod axis) at that
    budget, at the most layers up to 48 whose four ranks' pinned state
    fits 80% of MemAvailable and whose plan puts the optimizer on the
    host. Held: replicas in sync, finite losses, the optimizer's bytes a
    rank exactly 12 x padded / 4, each rank's peak at most 1.10 x the
    plan's (phase 3 gathers a stacked leaf a layer at a time). Each rank
    also records the allocator's peak by phase of each step
    (`phase_peaks`: reset and read at the cross-entropy's entry and exit,
    at the end of its backward, at the end of the backward, before the
    update, and around phase 3, `_zero1_params_from`).
(d) The smoke config on the 2x2x1 mesh: the overlapped backward off and
    on x compression off and on, each overlapped run also inline, against
    one rank on the global batch: loss within 5e-3 relative, grad norm
    within 2e-2 (chip_smoke's ddl_smoke_phase's tolerances); queued
    bitwise inline; replicas in sync.
(e) olmo-1b at its full 16 layers (MHA, non-parametric LayerNorm, tied
    embeddings), 3 steps resident on the 2x2x1 mesh with compress_dcn (the
    overlapped backward on the queue, the int8 pod hop) and zero1 on the
    1x4x1 mesh, each against one rank on the global batch: loss within
    5e-3 relative, grad norm within 2e-2 ((d)'s tolerances); replicas in
    sync; the pod hop's launches as olmo-1b's leaf sizes imply, no RMSNorm
    launch.
(f) qwen3-moe-235b-a22b at 2 layers (128 experts, top-8), zero1 on the
    1x4x1 mesh, resident, then under LMSConfig(hbm_budget=16e9) (the
    params and the flat optimizer shard in pinned host memory; the plan's
    peak and the ranks' peaks by phase recorded). Held: the two runs
    bitwise on every rank (losses, grad norms, aux, the params' checksums
    after each step, the shard's at the end), replicas in sync, finite
    losses, aux > 0.

(g) Tensor parallelism (a `model` axis over the cards), qwen2.5-14b at
    full width, 2048 tokens a data rank, 3 steps: (g1) 1x2x2 at G1_LAYERS
    layers against 1x2x1 on two cards on the same global batch, both with
    the overlapped backward: loss, ce and grad norm within 2e-3 relative
    each step, the masters within the CPU tests' lr-N bounds (max 2 lr N,
    the shares past 0.01 and 0.1 lr N at most 50% and 1%), the replicated
    leaves bitwise across `model` and the blocks across `data`; (g2)
    1x1x4 at G2_LAYERS layers resident (~59 GB of state a rank): s a
    step, tokens/s, model FLOP/s and its share of the four cards' bf16
    peak, each rank's peak against the planner's resident plan of that
    mesh; (g3) 1x2x2 at G3_LAYERS layers under
    LMSConfig(hbm_budget=16e9) (params, grads and the AdamW state in
    pinned host memory) bitwise against the resident run at that depth.

(h) Serving on a `model` axis over the cards (one rank a card, NCCL):
    (h1) qwen2-72b at all H1_LAYERS layers resident on MESH_H (~37 GB of
    params a rank), chip_smoke's trace (8 requests of 128 + 32 tokens on 4
    slots, half the device pages full residency needs): decode tok/s,
    TTFT, TPOT p50/p95, s a tick against PR27_TICK_S (its tick streamed
    from pinned host memory on one card), each rank's peak against the
    resident serve plan of the mesh, the tokens and the gathered rows the
    same on every rank; first the same run at H_CHECK_LAYERS layers
    teacher-forced against one card (rank 0's) on the same params, every
    row within 2**-5 of its max |logit|. (h2) qwen3-moe-235b-a22b at
    H2_LAYERS layers on MESH_H, the experts over `model` (32 of 128 a
    rank): teacher-forced against rank 0's one-card engine (top-8 routing
    moves near ties between the two: reported, not held), free-running
    (tok/s against PR30_MOE_TOK_S on one card), and with k = E held within
    2**-5 of rank 0's one-card dense pass. (h3) the MoE layer training:
    qwen3-moe at H3_LAYERS layers, 3 steps on 1x2x2 (expert parallelism
    and tensor parallelism over `model`, DDL over `data`) against 1x2x1 on
    two cards (whose replicated state does not fit a card at this depth:
    under LMSConfig(hbm_budget=16e9), which the port runs bitwise
    resident). With k = E (each token to every expert, H3E_SEQ tokens a
    data rank: a continuous layer), every one of (g1)'s bounds; with the
    published top-8, whose routing parts at near ties of the router's 8th
    and 9th choices, loss and ce within 2e-3, the masters within 2 lr N
    and the leaves bitwise across ranks, the grad norm and the masters'
    shares reported (`--phases h3e` runs the k = E run alone).

A phase whose depth the host cannot hold at 1 layer raises with the
numbers. Any failed check raises; the script then exits non-zero and
prints no last line. The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (after the path set-up)

WORLD = 4
MESH_A, MESH_C = (2, 2, 1), (1, 4, 1)
BATCH = WORLD              # a row of TRAIN_SEQ tokens a rank
STEPS = cs.DDL_STEPS
RESIDENT_DEPTHS = (1, 2, 3, 4)
# a resident rank's allowance above params, grads and AdamW state
# (activations of one 2048-token row, the reductions' f32 work buffers)
RESIDENT_ALLOWANCE = 12 * 10**9
MAX_LAYERS = 48
TIMEOUT_S = {"ad": 600, "b": 900, "c": 900, "e": 600, "f": 900, "g": 900, "h": 600}
# (c): each rank's measured peak against its plan's
PEAK_OVER_PLAN = 1.10
# (e): olmo-1b at its full depth, resident on MESH_A and zero1 on MESH_C
OLMO = "olmo-1b"
OUT = os.path.join(ROOT, "chiprun_out", "ddl_four_cards.json")
LAUNCH_KEYS = ("quantize_rows", "dequantize_rows", "dequantize_sum_rows", "rmsnorm")
# (f): the MoE decoder at MOE_LAYERS layers
MOE, MOE_LAYERS = "qwen3-moe-235b-a22b", 2
# (g): tensor parallelism; the meshes, and the depth of each run
MESH_G1_DP, MESH_G1, MESH_G2 = (1, 2, 1), (1, 2, 2), (1, 1, 4)
G1_LAYERS, G2_LAYERS, G3_LAYERS, G_STEPS = 4, 48, 16, 3
# (h): serving on a model axis; the mesh, the configs and their depths; the
# one-card numbers it is held beside (qwen2-72b's tick streamed from pinned
# host memory, PR 27's serve_beyond_card.py; qwen3-moe's 8-layer engine on
# one card, PR 30's chip_smoke)
MESH_H = (1, 1, 4)
H1_ARCH, H1_LAYERS, H_CHECK_LAYERS, H2_LAYERS, H3_LAYERS = "qwen2-72b", 80, 2, 8, 2
# (h3)'s k = E run: H3E_SEQ tokens a data rank, so that its E x H3E_SEQ
# assignments a layer are the top-8 run's 8 x TRAIN_SEQ (the same dispatch
# buffers; the reference's peak stays where the top-8 run's was)
H3E_SEQ = 128
PR27_TICK_S, PR30_MOE_TOK_S = 3.04, 52.9


class _PhasePeaks:
    """The allocator's peak by phase of a train step: `mark(name)` records
    the peak since the last mark under `name` (the largest over the steps
    in `peaks`, each step's in `rows`) and resets it; `overall` is the
    largest peak of all. Phases, in a step's order: "forward" (from the
    last step's end to the cross-entropy), "loss" (its forward),
    "loss_backward" (its backward), "backward" (the rest of the backward),
    "reduction" (to the update: the shard's reductions, the norm),
    "update", "phase3" (`_zero1_params_from`)."""

    def __init__(self):
        self.rows, self.peaks, self.overall, self.row = [], {}, 0, {}

    def mark(self, name):
        import torch
        peak = torch.cuda.max_memory_allocated()
        self.overall = max(self.overall, peak)
        self.peaks[name] = max(self.peaks.get(name, 0), peak)
        self.row[name] = max(self.row.get(name, 0), peak)
        if name == "phase3":
            self.rows.append(self.row)
            self.row = {}
        torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def _phase_peaks():
    """Record `_PhasePeaks` for the train steps run inside the block (the
    zero1 step's functions wrapped where they are looked up)."""
    import torch
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps as steps_mod
    rec = _PhasePeaks()

    class Mark(torch.autograd.Function):
        """An identity on the logits whose backward marks "loss_backward":
        the cross-entropy's backward is done when the logits' grad reaches
        it."""

        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            rec.mark("loss_backward")
            return g
    saved = (model_mod.cross_entropy, steps_mod._sunk_loss_and_grads,
             steps_mod._before_update, steps_mod._zero1_params_from)
    ce, sunk, before, phase3 = saved

    def ce_marked(logits, labels, *a, **k):
        rec.mark("forward")
        out = ce(Mark.apply(logits), labels, *a, **k)
        rec.mark("loss")
        return out

    def sunk_marked(*a, **k):
        out = sunk(*a, **k)
        rec.mark("backward")
        return out

    def before_marked(*a, **k):
        rec.mark("reduction")
        return before(*a, **k)

    def phase3_marked(*a, **k):
        rec.mark("update")
        out = phase3(*a, **k)
        rec.mark("phase3")
        return out
    (model_mod.cross_entropy, steps_mod._sunk_loss_and_grads, steps_mod._before_update,
     steps_mod._zero1_params_from) = ce_marked, sunk_marked, before_marked, phase3_marked
    try:
        yield rec
    finally:
        (model_mod.cross_entropy, steps_mod._sunk_loss_and_grads, steps_mod._before_update,
         steps_mod._zero1_params_from) = saved


# ---------------------------------------------------------------------------
# ranks: one a card, NCCL
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, name: str, args):
    """A spawned rank on cuda:rank: join the NCCL group through a
    FileStore in `tmp`, run the function `name`, write its JSON result to
    tmp/rank<r>.json."""
    import datetime
    import torch
    import torch.distributed as dist
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"rank {rank}: {torch.cuda.device_count()} cards, "
                           f"{world} ranks need one each")
    torch.cuda.set_device(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=cs.DDL_TIMEOUT_S))
    try:
        out = globals()[name](rank, world, *args)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(name: str, *args, timeout: float, world: int = WORLD):
    """`name`(rank, world, *args) in `world` processes started with the
    spawn method, rank r on cuda:r; -> each rank's result. A failed rank
    stops the others and raises; so does the timeout, after killing
    them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ddl_four_cards_")
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


@contextlib.contextmanager
def _high_priority_streams():
    """The reduction queue's stream, and the NCCL streams of the process
    groups made inside the block, at high priority (a diagnostic)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.ddl import overlap
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = overlap._WORKER_STREAMS.get(dev)
    overlap._WORKER_STREAMS[dev] = torch.cuda.Stream(dev, priority=-1)
    new_group = dist.new_group

    def high_priority_group(*a, **k):
        opts = dist.ProcessGroupNCCL.Options()
        opts.is_high_priority_stream = True
        return new_group(*a, pg_options=opts, **k)
    dist.new_group = high_priority_group
    try:
        yield
    finally:
        dist.new_group = new_group
        overlap._WORKER_STREAMS[dev] = saved


@contextlib.contextmanager
def _switch_interval(seconds: float):
    """Python's thread switch interval set to `seconds` (a diagnostic)."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


def _train(tcfg, *, inline: bool = False, steps: int = STEPS, around=None,
           peaks: bool = False):
    """One rank's `Trainer` for `steps` steps: the state set up (timed),
    then each step's loss, grad norm, time (synced), the params' checksums
    and whether they agree across the ranks, the kernels' launches, the
    swap bytes by class, the queue's times, and the device time of the
    stack's reductions (CUDA events around each layer's, on the stream it
    ran on) and of the rest's tree pass; at the end the optimizer state's
    checksums. inline: the queue's reductions issued in the backward;
    around: a context manager the Trainer is built and run inside; peaks:
    the peak by phase of each step recorded (`_phase_peaks`). ->
    {"plan", "rows", "facts"}."""
    with around if around is not None else contextlib.nullcontext():
        return _train_in(tcfg, inline, steps, peaks)


def _train_in(tcfg, inline: bool, steps: int, peaks: bool = False):
    import torch
    from repro_torch.core.ddl import overlap
    from repro_torch.core.lms import offload as off
    from repro_torch.train import steps as steps_mod
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
    opt = _opt_tree(state)
    opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(opt))
    opt_on_host = all(t.device.type == "cpu" for t in tree_leaves(opt))
    params = state.params
    sums = [cs._checksums(params)]
    in_sync = [cs._same_on_all_ranks(sums[0])]
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    queue = trainer.step_fn.queue
    spans = {"stack": [], "tree": []}
    saved = overlap.reduce_tree_bucketed, steps_mod.ddl_reduce_tree

    def timed(fn, key):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run
    overlap.reduce_tree_bucketed = timed(saved[0], "stack")
    steps_mod.ddl_reduce_tree = timed(saved[1], "tree")
    launchers = cs._launchers()
    for launcher in launchers.values():
        launcher.launches = 0
    rows, before = [], [off.swap_counters()]

    def on_step(step, row):
        torch.cuda.synchronize()
        swap = cs._swap_per_step(before[0], off.swap_counters(), 1)
        before[0] = off.swap_counters()
        ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
        layers_reduced = len(spans["stack"])
        for v in spans.values():
            v.clear()
        sums.append(cs._checksums(params))
        in_sync.append(cs._same_on_all_ranks(sums[-1]))
        rows.append({"step": step, "loss": row["loss"], "grad_norm": row["grad_norm"],
                     "aux": row["aux"], "time_s": row["time_s"], "checksums": sums[-1],
                     "launches": {k: launchers[k].launches for k in LAUNCH_KEYS},
                     "swap": swap, "stack_reduce_ms": ms["stack"],
                     "stack_reductions": layers_reduced, "tree_pass_ms": ms["tree"],
                     "queue_reduce_s": queue.reduce_s if queue else None,
                     "queue_under_backward_s": queue.under_backward_s if queue else None,
                     "queue_drain_wait_s": queue.drain_wait_s if queue else None})
        for launcher in launchers.values():
            launcher.launches = 0
    try:
        with contextlib.ExitStack() as stack:
            if inline:
                stack.enter_context(cs._inline_reductions())
            rec = stack.enter_context(_phase_peaks()) if peaks else None
            state, _ = trainer.train(steps, on_step=on_step)
    finally:
        overlap.reduce_tree_bucketed, steps_mod.ddl_reduce_tree = saved
    opt_sums = cs._checksums(_opt_tree(state))
    layout = getattr(trainer.step_fn, "layout", None)
    peak = torch.cuda.max_memory_allocated()
    if rec is not None:
        peak = max(peak, rec.overall)
    facts = {"setup_s": setup_s, "peak_bytes": peak,
             "phase_peaks": rec.rows if rec is not None else None,
             "pinned_bytes": off.pinned_bytes(), "in_sync": in_sync,
             "init_checksums": sums[0], "opt_checksums": opt_sums,
             "opt_in_sync": None if zero1 else cs._same_on_all_ranks(opt_sums),
             "opt_bytes": opt_bytes, "opt_on_host": opt_on_host,
             "padded": layout.padded if layout is not None else None,
             "queued": queue is not None,
             "grads_sunk": (not zero1) and state.grads is not None}
    del trainer, state, params, init, opt
    off.release_arenas()
    torch.cuda.empty_cache()
    return {"plan": cs._plan_row(plan), "rows": rows, "facts": facts}


def _opt_tree(state):
    """The optimizer state of a TrainState (AdamW) or a Zero1State."""
    o = state if not hasattr(state, "opt") else state.opt
    return {"mu": o.mu, "nu": o.nu, "master": o.master}


# ---------------------------------------------------------------------------
# configurations and sizes
# ---------------------------------------------------------------------------

def _resident_config(layers: int, overlap: bool):
    from repro_torch.config.base import DDLConfig
    return cs._ddl_config(layers, MESH_A, ddl=DDLConfig(compress_dcn=True, overlap_grads=overlap),
                          batch=BATCH, log_every=1)


def _zero1_config(layers: int, arch: str = cs.ARCH, lms: bool = True):
    import dataclasses
    from repro_torch.config.base import DDLConfig, LMSConfig
    tcfg = cs._ddl_config(layers, MESH_C, ddl=DDLConfig(mode="zero1"), batch=BATCH,
                          log_every=1, arch=arch)
    if not lms:
        return tcfg
    return dataclasses.replace(tcfg, lms=LMSConfig(hbm_budget=cs.LMS_DDL_BUDGET))


def _resident_bytes(layers: int) -> int:
    """A resident rank's params, grads and AdamW state (f32 mu, nu and
    master) at `layers` layers, plus RESIDENT_ALLOWANCE."""
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    import torch
    model = Model(_resident_config(layers, True).model)
    total = RESIDENT_ALLOWANCE
    for _, d in steps_mod._def_paths(model.param_defs()):
        n = math.prod(d.shape)
        total += n * (2 * torch.empty((), dtype=DTYPES[d.dtype]).element_size() + 12)
    return total


def _zero1_sizing(layers: int, arch: str = cs.ARCH):
    """-> (the plan of (c) at `layers`, a rank's pinned bytes under it, or
    None where the plan keeps the optimizer on the device with the params
    on the host: not ported). The bytes: the stack's params when they
    stream (`train.steps._state_layout`), and the flat mu, nu and master
    (12 B a padded element over |data| = 4) when the optimizer is on the
    host."""
    from repro_torch.core.lms import offload as off
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.model import Model
    from repro_torch.train import steps as steps_mod
    tcfg = _zero1_config(layers, arch)
    model = Model(tcfg.model)
    plan = plan_lms(PlanRequest(cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh, lms=tcfg.lms,
                                optimizer=tcfg.optimizer, zero1=True,
                                microbatches=tcfg.microbatches))
    params_host, opt_host = steps_mod._host_classes(plan)
    if params_host and not opt_host:
        return plan, None
    paths = [(path, d.shape, DTYPES[d.dtype])
             for path, d in steps_mod._def_paths(model.param_defs())]
    host = steps_mod._state_layout(paths, "adamw", params_host, False)[0]
    _, layout = steps_mod._zero1_layout(model, tcfg, MESH_C[1], MESH_C[1])
    if opt_host:
        host += 3 * off.PinnedArena.padded(4 * steps_mod._local_size(layout))
    return plan, host


# ---------------------------------------------------------------------------
# the ranks' phases
# ---------------------------------------------------------------------------

def _resident_rank(rank: int, world: int, layers: int):
    """(a) queued, inline and serialized at `layers` layers, then (d) the
    smoke config: the one-rank reference on the global batch and
    chip_smoke's `_ddl_smoke_rank` on the 2x2x1 mesh."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.train.steps import build_train_step, init_train_state
    out = {"rank": rank,
           "a": {"queued": _train(_resident_config(layers, True)),
                 "inline": _train(_resident_config(layers, True), inline=True),
                 "serialized": _train(_resident_config(layers, False)),
                 "queued_high_priority": _train(_resident_config(layers, True),
                                                around=_high_priority_streams()),
                 "queued_switch_0.5ms": _train(_resident_config(layers, True),
                                               around=_switch_interval(5e-4))}}
    tcfg = cs._ddl_config(0, (1, 1, 1), smoke=True, batch=cs.DDL_SMOKE_BATCH,
                          seq=cs.DDL_SMOKE_SEQ)
    model = Model(tcfg.model)
    step = build_train_step(model, tcfg)
    state = init_train_state(model, tcfg, cs.SEED, "cuda")
    reference = []
    for b in cs._ddl_batches(tcfg):
        state, met = step(state, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        reference.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])})
    del state
    out["d_reference"] = reference
    out["d"] = cs._ddl_smoke_rank(rank, world)
    return out


def _lms_rank(rank: int, world: int, layers: int, pinned: int):
    """(b): the arena reserved once at `pinned` bytes, then the plan's
    overlapped run and the serialized one in it."""
    from repro_torch.core.lms import offload as off
    t0 = time.monotonic()
    off.reserve_pinned(pinned, "cuda")
    out = {"rank": rank, "pinned": {"bytes": pinned, "seconds": time.monotonic() - t0}}
    for name, ov in (("overlapped", None), ("serialized", False)):
        out[name] = _train(cs._lms_ddl_config(layers, ov, mesh=MESH_A, batch=BATCH))
    return out


def _zero1_rank(rank: int, world: int, layers: int, pinned: int):
    """(c): the arena reserved at `pinned` bytes, then zero1 under the plan."""
    from repro_torch.core.lms import offload as off
    t0 = time.monotonic()
    off.reserve_pinned(pinned, "cuda")
    return {"rank": rank, "pinned": {"bytes": pinned, "seconds": time.monotonic() - t0},
            "run": _train(_zero1_config(layers), peaks=True)}


def _moe_rank(rank: int, world: int, layers: int, pinned: int):
    """(f): zero1 resident, then the arena reserved at `pinned` bytes and
    zero1 under the plan, with the peaks by phase."""
    from repro_torch.core.lms import offload as off
    out = {"rank": rank, "resident": _train(_zero1_config(layers, MOE, lms=False),
                                            peaks=True)}
    t0 = time.monotonic()
    off.reserve_pinned(pinned, "cuda")
    out["pinned"] = {"bytes": pinned, "seconds": time.monotonic() - t0}
    out["planned"] = _train(_zero1_config(layers, MOE), peaks=True)
    return out


# ---------------------------------------------------------------------------
# the parent: sizing, checks, rows
# ---------------------------------------------------------------------------

def _steady(rows, key):
    vals = [r[key] for r in rows[1:]]
    return sum(vals) / len(vals) if vals and None not in vals else None


def _moved(swap) -> float:
    """Bytes over the host link in a step's swap counters (in and out)."""
    return sum(v for k, v in swap.items() if "_bytes." in k)


def _run_summary(ranks, get, cfg, line):
    """A run's row: rank 0's steady steps (after step 1), every rank's peak,
    the link rate each rank's swaps reached in the step, model FLOP/s."""
    run = get(ranks[0])
    rows = run["rows"]
    step_s = _steady(rows, "time_s")
    tokens = cs.TRAIN_SEQ
    flops, _ = cs._train_flops(cfg, tokens, cs.TRAIN_SEQ)
    later = rows[1:]
    swap = {k: sum(r["swap"].get(k, 0) for r in later) / len(later) for k in later[0]["swap"]}
    moved = _moved(swap)
    link = []
    for r in ranks:
        rr = get(r)["rows"][1:]
        b = sum(_moved(s["swap"]) for s in rr) / len(rr)
        link.append(b / _steady(get(r)["rows"], "time_s") / 1e9)
    plan = run["plan"]
    return {"card": line, "layers": cfg.num_layers, "step_s_steady": step_s,
            "tokens_per_s": WORLD * tokens / step_s,
            "tokens_per_s_per_rank": tokens / step_s,
            "model_flops_per_s_per_rank": flops / step_s,
            "bf16_peak_share": flops / step_s / cs.BF16_TENSOR_FLOPS_PER_S,
            "step_s": [r["time_s"] for r in rows], "loss": [r["loss"] for r in rows],
            "grad_norm": [r["grad_norm"] for r in rows],
            **{k: _steady(rows, k) for k in ("queue_reduce_s", "queue_under_backward_s",
                                             "queue_drain_wait_s", "stack_reduce_ms",
                                             "tree_pass_ms")},
            "stack_reductions_per_step": rows[-1]["stack_reductions"],
            "launches_per_step": rows[-1]["launches"], "swap_per_step": swap,
            "swap_bytes_per_step": moved, "link_gb_s_per_rank": link,
            "link_gb_s_all_ranks": sum(link),
            "plan_swap_bytes": plan["swap_bytes"] if plan else None,
            "plan_swap_bytes_per_step": plan["swap_bytes_per_step"] if plan else None,
            "plan_residency": plan["residency"] if plan else None,
            "plan_peak_bytes": plan["peak_bytes"] if plan else None,
            "plan_host_bytes": plan["host_bytes"] if plan else None,
            "peak_bytes": [get(r)["facts"]["peak_bytes"] for r in ranks],
            "pinned_bytes": [get(r)["facts"]["pinned_bytes"] for r in ranks],
            "opt_bytes": run["facts"]["opt_bytes"], "opt_on_host": run["facts"]["opt_on_host"],
            "setup_s": [get(r)["facts"]["setup_s"] for r in ranks],
            "queued": run["facts"]["queued"], "grads_sunk": run["facts"]["grads_sunk"]}


def _in_sync(ranks, get) -> bool:
    return all(all(get(r)["facts"]["in_sync"]) and len(get(r)["facts"]["in_sync"]) == STEPS + 1
               for r in ranks)


def _trace(run) -> list:
    return ([run["facts"]["init_checksums"]]
            + [[s["loss"], s["grad_norm"], s["checksums"]] for s in run["rows"]]
            + [run["facts"]["opt_checksums"]])


def _within(a, b, tol=2e-3) -> bool:
    return all(abs(x["loss"] - y["loss"]) <= tol * abs(y["loss"])
               for x, y in zip(a["rows"][1:], b["rows"][1:]))


def _finite(run) -> bool:
    return all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in run["rows"])


def _fail(name, checks):
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"{name}: failed checks {bad}")


def phase_a_d(line, rows_out):
    """(a) and (d), in one set of 4 ranks."""
    from repro_torch.configs import get_smoke_config
    fit = [L for L in RESIDENT_DEPTHS if _resident_bytes(L) <= cs.CARD_BYTES]
    if not fit:
        raise AssertionError(f"(a): no depth of {RESIDENT_DEPTHS} fits the card: "
                             f"{_resident_bytes(RESIDENT_DEPTHS[0])} B at 1 layer")
    L = max(fit)
    cfg = _resident_config(L, True).model
    t0 = time.monotonic()
    ranks = spawn_ranks("_resident_rank", L, timeout=TIMEOUT_S["ad"])
    seconds = time.monotonic() - t0
    runs = {m: (lambda r, m=m: r["a"][m]) for m in ("queued", "inline", "serialized")}
    diagnostics = ("queued_high_priority", "queued_switch_0.5ms")
    slices = {ov: len(cs.ddl_pod_hop_sizes(cfg, MESH_A[1], overlap=ov)) for ov in (True, False)}

    def launches_ok(mode):
        ov = mode != "serialized"
        return all(s["launches"] == {"quantize_rows": slices[ov], "dequantize_rows": 0,
                                     "dequantize_sum_rows": slices[ov], "rmsnorm": 4 * L + 1}
                   for r in ranks for s in runs[mode](r)["rows"])
    q = ranks[0]["a"]["queued"]
    s = ranks[0]["a"]["serialized"]
    checks = {
        "queued_equals_inline_bitwise_every_rank": all(
            _trace(r["a"]["queued"]) == _trace(r["a"]["inline"]) for r in ranks),
        "diagnostics_bitwise_queued": all(_trace(r["a"]["queued"]) == _trace(r["a"][d])
                                          for r in ranks for d in diagnostics),
        "replicas_in_sync": all(_in_sync(ranks, g) for g in runs.values())
        and all(r["a"][m]["facts"]["opt_in_sync"] for r in ranks for m in runs),
        "serialized_step1_loss_equal": q["rows"][0]["loss"] == s["rows"][0]["loss"],
        "serialized_within_2e-3_from_step_2": _within(q, s),
        "finite": all(_finite(r["a"][m]) for r in ranks for m in runs),
        "queued_on_the_queue": all(r["a"]["queued"]["facts"]["queued"]
                                   and r["a"]["queued"]["rows"][-1]["stack_reductions"] == L
                                   for r in ranks),
        "launches": all(launches_ok(m) for m in runs)}
    row = {"phase": "a_resident_ddl", "arch": cs.ARCH, "layers": L, "fit": fit,
           "resident_bytes_estimate": {Lx: _resident_bytes(Lx) for Lx in RESIDENT_DEPTHS},
           "mesh": list(MESH_A), "ranks": WORLD, "backend": "nccl", "compress_dcn": True,
           "tokens_per_rank": cs.TRAIN_SEQ, "card": line,
           "expected_slices_per_step": slices,
           **{m: _run_summary(ranks, g, cfg, line) for m, g in runs.items()},
           **{d: _run_summary(ranks, lambda r, d=d: r["a"][d], cfg, line) for d in diagnostics},
           "seconds": seconds, "checks": checks}
    emit(row, rows_out)
    _fail("(a)", checks)

    smoke = get_smoke_config(cs.ARCH)
    reference = ranks[0]["d_reference"]
    variants, dchecks = {}, {}
    for name, v in ranks[0]["d"].items():
        ov, c = "overlap=True" in name, "compress=True" in name
        n = len(cs.ddl_pod_hop_sizes(smoke, cs.DDL_SMOKE_MESH[1], overlap=ov)) * STEPS if c else 0
        err = [{k: abs(row[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for row, ref in zip(v["rows"], reference)]
        dchecks[name] = {
            "in_sync": all(all(r["d"][name]["in_sync"]) for r in ranks),
            "same_metrics": all(r["d"][name]["rows"] == v["rows"] for r in ranks),
            "same_reference": all(r["d_reference"] == reference for r in ranks),
            "loss": max(e["loss"] for e in err) <= 5e-3,
            "grad_norm": max(e["grad_norm"] for e in err) <= 2e-2,
            "launches": all(r["d"][name]["quantize_launches"] == n
                            and r["d"][name]["dequantize_sum_launches"] == n
                            and r["d"][name]["dequantize_launches"] == 0 for r in ranks)}
        if ov:
            dchecks[name]["queued_equals_inline_bitwise"] = all(r["d"][name]["inline_bitwise"]
                                                                for r in ranks)
        variants[name] = {"rows": v["rows"], "rel_err": err,
                          "quantize_launches": v["quantize_launches"],
                          "dequantize_sum_launches": v["dequantize_sum_launches"]}
    emit({"phase": "d_smoke_width", "arch": cs.ARCH, "config": "smoke",
          "mesh": list(cs.DDL_SMOKE_MESH), "ranks": WORLD, "backend": "nccl", "card": line,
          "batch": cs.DDL_SMOKE_BATCH, "seq": cs.DDL_SMOKE_SEQ, "reference": reference,
          "variants": variants, "checks": dchecks}, rows_out)
    _fail("(d)", {f"{n}/{k}": v for n, c in dchecks.items() for k, v in c.items()})


def _host_room(what: str, need_one_layer: int):
    """MemAvailable after gc and malloc_trim, failing if `need_one_layer`
    (four ranks at 1 layer) does not fit LMS_HOST_SHARE of it."""
    import ctypes
    import gc
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    mem = cs._mem_row()
    if need_one_layer > cs.LMS_HOST_SHARE * mem["MemAvailable"]:
        raise AssertionError(
            f"{what}: four ranks' pinned state at 1 layer is {need_one_layer} B, more than "
            f"{cs.LMS_HOST_SHARE} of MemAvailable {mem['MemAvailable']} B")
    return mem


def phase_b(line, rows_out):
    """(b) LMS + DDL at the most layers the host holds."""
    mem = _host_room("(b)", WORLD * cs._lms_ddl_pinned_bytes(1))
    avail = mem["MemAvailable"]
    fit = [L for L in range(1, MAX_LAYERS + 1)
           if WORLD * cs._lms_ddl_pinned_bytes(L) <= cs.LMS_HOST_SHARE * avail]
    L = max(fit)
    pinned = cs._lms_ddl_pinned_bytes(L)
    cfg = cs._lms_ddl_config(L, mesh=MESH_A, batch=BATCH).model
    t0 = time.monotonic()
    ranks = spawn_ranks("_lms_rank", L, pinned, timeout=TIMEOUT_S["b"])
    seconds = time.monotonic() - t0
    after = cs._mem_row()
    returned = cs._await_mem_available(avail - cs.LMS_DDL_MEM_SLACK, cs.LMS_DDL_MEM_WAIT_S)
    runs = {m: (lambda r, m=m: r[m]) for m in ("overlapped", "serialized")}
    ov, ser = ranks[0]["overlapped"], ranks[0]["serialized"]
    checks = {
        "plan_all_on_host": all(ov["plan"]["residency"][k] == "host"
                                for k in ("params", "grads", "optimizer")),
        "overlapped_queued_and_sunk": all(r["overlapped"]["facts"]["queued"]
                                          and r["overlapped"]["facts"]["grads_sunk"]
                                          for r in ranks),
        "serialized_not_queued": not any(r["serialized"]["facts"]["queued"] for r in ranks),
        "replicas_in_sync": all(_in_sync(ranks, g) for g in runs.values()),
        "finite": all(_finite(r[m]) for r in ranks for m in runs),
        "step1_loss_equal": ov["rows"][0]["loss"] == ser["rows"][0]["loss"],
        "later_losses_within_2e-3": _within(ov, ser)}
    emit({"phase": "b_lms_ddl", "arch": cs.ARCH, "layers": L, "mesh": list(MESH_A),
          "ranks": WORLD, "backend": "nccl", "compress_dcn": True,
          "hbm_budget": cs.LMS_DDL_BUDGET, "card": line, "pinned_bytes_per_rank": pinned,
          "fits_up_to": L, "arena": [r["pinned"] for r in ranks],
          **{m: _run_summary(ranks, g, cfg, line) for m, g in runs.items()},
          "meminfo_before": mem, "meminfo_after": after,
          "mem_available_returning": returned[-1:], "nproc": os.cpu_count(),
          "seconds": seconds, "checks": checks}, rows_out)
    _fail("(b)", checks)


def phase_c(line, rows_out):
    """(c) zero1 under LMS at the most layers up to 48 the host holds (the
    first depth, from 48 down, whose plan keeps the optimizer on the host
    and whose four ranks' pinned state fits)."""
    mem = _host_room("(c)", 0)
    avail = mem["MemAvailable"]
    sized = {}
    for L in range(MAX_LAYERS, 0, -1):
        plan, host = _zero1_sizing(L)
        sized[L] = host
        if host is not None and WORLD * host <= cs.LMS_HOST_SHARE * avail:
            break
    else:
        raise AssertionError(f"(c): no depth up to {MAX_LAYERS} fits {cs.LMS_HOST_SHARE} of "
                             f"MemAvailable {avail} B with the optimizer on the host: {sized}")
    pinned = sized[L]
    cfg = _zero1_config(L).model
    t0 = time.monotonic()
    ranks = spawn_ranks("_zero1_rank", L, pinned, timeout=TIMEOUT_S["c"])
    seconds = time.monotonic() - t0
    after = cs._mem_row()
    returned = cs._await_mem_available(avail - cs.LMS_DDL_MEM_SLACK, cs.LMS_DDL_MEM_WAIT_S)
    run = ranks[0]["run"]
    padded = run["facts"]["padded"]
    checks = {
        "optimizer_on_host": all(r["run"]["facts"]["opt_on_host"] for r in ranks),
        "optimizer_bytes": padded is not None and all(
            r["run"]["facts"]["opt_bytes"] == 12 * padded // MESH_C[1] for r in ranks),
        "queued": all(r["run"]["facts"]["queued"] for r in ranks),
        "replicas_in_sync": _in_sync(ranks, lambda r: r["run"]),
        "finite": all(_finite(r["run"]) for r in ranks),
        "peak_within_1.10_of_plan": all(
            r["run"]["facts"]["peak_bytes"] <= PEAK_OVER_PLAN * run["plan"]["peak_bytes"]
            for r in ranks)}
    emit({"phase": "c_zero1_lms", "arch": cs.ARCH, "layers": L, "mesh": list(MESH_C),
          "ranks": WORLD, "backend": "nccl", "compress_dcn": False,
          "hbm_budget": cs.LMS_DDL_BUDGET, "card": line, "params": cfg.param_count(),
          "pinned_bytes_per_rank": pinned, "padded": padded,
          "opt_bytes_expected": 12 * padded // MESH_C[1] if padded else None,
          "sized_bytes": sized, "arena": [r["pinned"] for r in ranks],
          "run": _run_summary(ranks, lambda r: r["run"], cfg, line),
          "phase_peaks": [r["run"]["facts"]["phase_peaks"] for r in ranks],
          "meminfo_before": mem, "meminfo_after": after,
          "mem_available_returning": returned[-1:], "seconds": seconds,
          "checks": checks}, rows_out)
    _fail("(c)", checks)


def phase_f(line, rows_out):
    """(f) qwen3-moe-235b-a22b at MOE_LAYERS layers: zero1 on 1x4x1,
    resident and under the plan, bitwise."""
    plan, pinned = _zero1_sizing(MOE_LAYERS, MOE)
    if pinned is None:
        raise AssertionError(f"(f): the plan keeps the optimizer on the device: "
                             f"{plan.residency}")
    mem = _host_room("(f)", WORLD * pinned)
    cfg = _zero1_config(MOE_LAYERS, MOE).model
    t0 = time.monotonic()
    ranks = spawn_ranks("_moe_rank", MOE_LAYERS, pinned, timeout=TIMEOUT_S["f"])
    seconds = time.monotonic() - t0
    runs = {m: (lambda r, m=m: r[m]) for m in ("resident", "planned")}
    pl = ranks[0]["planned"]
    checks = {
        "plan_params_and_optimizer_on_host": pl["plan"]["residency"]["params"] == "host"
        and pl["plan"]["residency"]["optimizer"] == "host",
        "optimizer_on_host": all(r["planned"]["facts"]["opt_on_host"] for r in ranks),
        "planned_bitwise_resident_every_rank": all(
            _trace(r["planned"]) == _trace(r["resident"])
            and [s["aux"] for s in r["planned"]["rows"]]
            == [s["aux"] for s in r["resident"]["rows"]] for r in ranks),
        "replicas_in_sync": all(_in_sync(ranks, g) for g in runs.values()),
        "finite": all(_finite(r[m]) for r in ranks for m in runs),
        "aux_positive": all(s["aux"] > 0 for r in ranks for m in runs for s in r[m]["rows"])}
    emit({"phase": "f_moe_zero1", "arch": MOE, "layers": MOE_LAYERS, "mesh": list(MESH_C),
          "ranks": WORLD, "backend": "nccl", "hbm_budget": cs.LMS_DDL_BUDGET, "card": line,
          "params": cfg.param_count(), "pinned_bytes_per_rank": pinned,
          "arena": [r["pinned"] for r in ranks],
          **{m: _run_summary(ranks, g, cfg, line) for m, g in runs.items()},
          "aux": {m: [s["aux"] for s in ranks[0][m]["rows"]] for m in runs},
          "phase_peaks": {m: [r[m]["facts"]["phase_peaks"] for r in ranks] for m in runs},
          "meminfo_before": mem, "seconds": seconds, "checks": checks}, rows_out)
    _fail("(f)", checks)


def _olmo_run(tcfg, mesh, zero1: bool = False):
    """DDL_STEPS steps of the train step (zero1's if `zero1`) from the
    seed's init on this rank's rows of the global batches (all of them
    without a mesh): each step's loss, grad norm and time (synced); with a
    mesh whether the params' checksums agree across the ranks after
    init and each step; the kernels' launches over the run; the peak."""
    import torch
    from repro_torch.data import local_rows
    from repro_torch.models.model import Model
    from repro_torch.train.steps import (build_train_step, build_zero1_train_step,
                                         init_train_state, init_zero1_state)
    model = Model(tcfg.model)
    torch.cuda.reset_peak_memory_stats()
    if zero1:
        step = build_zero1_train_step(model, tcfg, mesh=mesh)
        state = init_zero1_state(model, tcfg, cs.SEED, "cuda", mesh.size("data"),
                                 data_index=mesh.index("data"))
    else:
        step = build_train_step(model, tcfg, mesh=mesh)
        state = init_train_state(model, tcfg, cs.SEED, "cuda")
    in_sync = [cs._same_on_all_ranks(cs._checksums(state.params))] if mesh else []
    rows = []
    with cs.launch_signatures() as (seen, calls, launches):
        for b in cs._ddl_batches(tcfg):
            local = local_rows(b, mesh.dp_index, mesh.dp_size) if mesh else b
            batch = {k: torch.from_numpy(v).cuda() for k, v in local.items()}
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, met = step(state, batch)
            rows.append({"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                         "time_s": time.monotonic() - t0})
            if mesh:
                in_sync.append(cs._same_on_all_ranks(cs._checksums(state.params)))
    peak = torch.cuda.max_memory_allocated()
    del state, step
    torch.cuda.empty_cache()
    return {"rows": rows, "in_sync": in_sync, "peak_bytes": peak,
            "launches": {k: launches[k] for k in LAUNCH_KEYS}}


def _olmo_rank(rank: int, world: int):
    """(e): the one-rank reference on the global batch (every rank runs it
    on its own card), then resident on MESH_A with the int8 pod hop and
    the overlapped backward, then zero1 on MESH_C."""
    from repro_torch.config.base import DDLConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    L = get_config(OLMO).num_layers
    out = {"rank": rank, "reference": _olmo_run(
        cs._ddl_config(L, (1, 1, 1), batch=BATCH, arch=OLMO), None)}
    for name, mesh, ddl in (("resident", MESH_A, DDLConfig(compress_dcn=True,
                                                           overlap_grads=True)),
                            ("zero1", MESH_C, DDLConfig(mode="zero1"))):
        tcfg = cs._ddl_config(L, mesh, batch=BATCH, arch=OLMO, ddl=ddl)
        out[name] = _olmo_run(tcfg, make_mesh(tcfg.mesh), zero1=name == "zero1")
    return out


def phase_e(line, rows_out):
    """(e) olmo-1b at full width on 2x2x1 (resident, compressed) and 1x4x1
    (zero1), each against one rank on the global batch."""
    from repro_torch.configs import get_config
    cfg = get_config(OLMO)
    t0 = time.monotonic()
    ranks = spawn_ranks("_olmo_rank", timeout=TIMEOUT_S["e"])
    seconds = time.monotonic() - t0
    reference = ranks[0]["reference"]["rows"]
    slices = len(cs.ddl_pod_hop_sizes(cfg, MESH_A[1], overlap=True))
    expected = {"resident": {"quantize_rows": slices * STEPS, "dequantize_rows": 0,
                             "dequantize_sum_rows": slices * STEPS, "rmsnorm": 0},
                "zero1": {k: 0 for k in LAUNCH_KEYS}}
    runs, checks = {}, {}
    for name in ("resident", "zero1"):
        run = ranks[0][name]
        err = [{k: abs(row[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
               for row, ref in zip(run["rows"], reference)]
        checks[name] = {
            "in_sync": all(all(r[name]["in_sync"]) and len(r[name]["in_sync"]) == STEPS + 1
                           for r in ranks),
            "same_metrics": all([(x["loss"], x["grad_norm"]) for x in r[name]["rows"]]
                                == [(x["loss"], x["grad_norm"]) for x in run["rows"]]
                                for r in ranks),
            "same_reference": all(r["reference"]["rows"][i][k] == reference[i][k]
                                  for r in ranks for i in range(STEPS)
                                  for k in ("loss", "grad_norm")),
            "loss_within_5e-3": max(e["loss"] for e in err) <= 5e-3,
            "grad_norm_within_2e-2": max(e["grad_norm"] for e in err) <= 2e-2,
            "finite": all(math.isfinite(x["loss"]) for x in run["rows"]),
            "launches": all(r[name]["launches"] == expected[name] for r in ranks)}
        step_s = _steady(run["rows"], "time_s")
        runs[name] = {"mesh": list(MESH_A if name == "resident" else MESH_C),
                      "rows": run["rows"], "rel_err": err, "step_s_steady": step_s,
                      "tokens_per_s": WORLD * cs.TRAIN_SEQ / step_s,
                      "peak_bytes": [r[name]["peak_bytes"] for r in ranks],
                      "launches": run["launches"], "expected_launches": expected[name]}
    emit({"phase": "e_olmo_1b", "arch": OLMO, "layers": cfg.num_layers,
          "params": cfg.param_count(), "ranks": WORLD, "backend": "nccl", "card": line,
          "tokens_per_rank": cs.TRAIN_SEQ, "reference": reference,
          "reference_step_s_steady": _steady(ranks[0]["reference"]["rows"], "time_s"),
          "reference_peak_bytes": ranks[0]["reference"]["peak_bytes"],
          "pod_hop_slices_per_step": slices, **runs, "seconds": seconds,
          "checks": checks}, rows_out)
    _fail("(e)", {f"{n}/{k}": v for n, c in checks.items() for k, v in c.items()})


# ---------------------------------------------------------------------------
# (g) tensor parallelism
# ---------------------------------------------------------------------------

def _tp_config(mesh, layers: int, lms=None):
    """qwen2.5-14b at `layers` layers on `mesh`, a TRAIN_SEQ row a data
    rank, the overlapped backward, at the peak lr (no warmup)."""
    import dataclasses
    from repro_torch.config.base import DDLConfig
    tcfg = cs._ddl_config(layers, mesh, ddl=DDLConfig(overlap_grads=True),
                          batch=mesh[0] * mesh[1], log_every=1)
    tcfg = dataclasses.replace(tcfg, learning_rate=cs.TRAIN_LR, warmup_steps=0,
                               total_steps=G_STEPS)
    return tcfg if lms is None else dataclasses.replace(tcfg, lms=lms)


def _tp_run(tcfg, masters_out=None, masters_ref=None):
    """One rank's `Trainer` on `tcfg` for G_STEPS steps from the seed: each
    step's loss, ce, grad norm and time (synced), RMSNorm's launches; the
    state's checksums at the end, the replicated leaves' apart; the
    masters saved to `masters_out` (rank 0) or held against the global
    ones in `masters_ref` (this rank's blocks of them)."""
    import torch
    from repro_torch.core.lms import offload as off
    from repro_torch.models import sharding as shd
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    trainer = Trainer(tcfg, device="cuda")
    mesh = trainer.mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.init_state()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    init = [state]
    trainer.init_state = lambda: init.pop()
    del state
    launchers = cs._launchers()
    launchers["rmsnorm"].launches = 0
    rows, before = [], [off.swap_counters()]

    def on_step(step, row):
        torch.cuda.synchronize()
        swap = cs._swap_per_step(before[0], off.swap_counters(), 1)
        before[0] = off.swap_counters()
        rows.append({"step": step, **{k: row[k] for k in ("loss", "ce", "grad_norm",
                                                          "time_s")},
                     "rmsnorm_launches": launchers["rmsnorm"].launches, "swap": swap})
        launchers["rmsnorm"].launches = 0
    state, _ = trainer.train(G_STEPS, on_step=on_step)
    model = trainer.model
    sharded = tree_leaves(shd.sharded_tree(model.param_defs(), mesh))
    replicated = cs._checksums({f"{name}/{i}": t for name, tree in (
        ("params", state.params), ("master", state.opt.master), ("mu", state.opt.mu),
        ("nu", state.opt.nu)) for i, (t, sh) in enumerate(zip(tree_leaves(tree), sharded))
        if not sh})
    sums = cs._state_checksums(state)
    peers = [None] * mesh.size("data")
    if mesh.size("data") > 1:
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, [mesh.index("model"), sums])
        peers = [s for m, s in got if m == mesh.index("model")]
    facts = {"setup_s": setup_s, "peak_bytes": torch.cuda.max_memory_allocated(),
             "pinned_bytes": off.pinned_bytes(), "checksums": sums,
             "replicated_leaves": len(replicated),
             "replicated_same_on_ranks": cs._same_on_all_ranks(replicated),
             "blocks_same_across_data": all(p == sums for p in peers if p is not None),
             "coords": [mesh.index(a) for a in cs.DDL_AXES]}
    masters = tree_leaves(state.opt.master)
    if masters_out is not None and mesh.rank == 0:
        torch.save([t.cpu() for t in masters], masters_out)
    if masters_ref is not None:
        unit = cs.TRAIN_LR * G_STEPS
        ref = torch.load(masters_ref, mmap=True)
        specs = tree_leaves(model.param_specs(mesh))
        n = worst = over_median = over_p99 = 0
        for got, want, sp in zip(masters, ref, specs):
            d = (got - shd.local_shard(want, sp, mesh).cuda()).abs()
            n += d.numel()
            worst = max(worst, d.max().item())
            over_median += int((d > 0.01 * unit).sum())
            over_p99 += int((d > 0.1 * unit).sum())
        facts["masters"] = {"elements": n, "max_over_lr_n": worst / unit,
                            "share_over_0.01_lr_n": over_median / n,
                            "share_over_0.1_lr_n": over_p99 / n}
    plan = trainer.plan
    del trainer, state, init, masters
    off.release_arenas()
    torch.cuda.empty_cache()
    return {"plan": cs._plan_row(plan), "rows": rows, "facts": facts}


def _tp_dp_rank(rank: int, world: int, path: str):
    """(g1)'s reference on 1x2x1: its masters saved to `path`."""
    return _tp_run(_tp_config(MESH_G1_DP, G1_LAYERS), masters_out=path)


def _tp_g1_rank(rank: int, world: int, path: str):
    return _tp_run(_tp_config(MESH_G1, G1_LAYERS), masters_ref=path)


def _tp_g2_rank(rank: int, world: int):
    return _tp_run(_tp_config(MESH_G2, G2_LAYERS))


def _tp_g3_rank(rank: int, world: int):
    """(g3): resident, then under the plan of LMS_DDL_BUDGET."""
    from repro_torch.config.base import LMSConfig
    return {"resident": _tp_run(_tp_config(MESH_G1, G3_LAYERS)),
            "planned": _tp_run(_tp_config(MESH_G1, G3_LAYERS,
                                          LMSConfig(hbm_budget=cs.LMS_DDL_BUDGET)))}


def _tp_summary(ranks, get, cfg, mesh, line, seq: int = cs.TRAIN_SEQ):
    """A tensor-parallel run's row: rank 0's steady steps, tokens/s of the
    global batch (a row of `seq` tokens a data rank), model FLOP/s over the
    cards and its share of their bf16 peak, each rank's peak."""
    run = get(ranks[0])
    rows = run["rows"]
    step_s = _steady(rows, "time_s")
    tokens = mesh[0] * mesh[1] * seq
    flops, _ = cs._train_flops(cfg, tokens, seq)
    cards = math.prod(mesh)
    return {"card": line, "layers": cfg.num_layers, "mesh": list(mesh),
            "step_s_steady": step_s, "step_s": [r["time_s"] for r in rows],
            "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
            "model_flops_per_s": flops / step_s,
            "bf16_peak_share": flops / step_s / (cards * cs.BF16_TENSOR_FLOPS_PER_S),
            "loss": [r["loss"] for r in rows], "grad_norm": [r["grad_norm"] for r in rows],
            "rmsnorm_launches": [r["rmsnorm_launches"] for r in rows],
            "swap_bytes_per_step": _steady([{"m": _moved(r["swap"])} for r in rows], "m"),
            "peak_bytes": [get(r)["facts"]["peak_bytes"] for r in ranks],
            "pinned_bytes": [get(r)["facts"]["pinned_bytes"] for r in ranks],
            "setup_s": [get(r)["facts"]["setup_s"] for r in ranks],
            "plan": run["plan"]}


def _tp_plan(mesh, layers: int, lms):
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    tcfg = _tp_config(mesh, layers, lms)
    return plan_lms(PlanRequest(cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh,
                                lms=tcfg.lms))


def phase_g(line, rows_out):
    """(g) tensor parallelism across the cards (the module docstring)."""
    import shutil
    import tempfile
    from repro_torch.config.base import LMSConfig
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ddl_four_cards_tp_", dir=cs.CKPT_RAM_ROOT)
    try:
        path = os.path.join(tmp, "masters.pt")
        dp = spawn_ranks("_tp_dp_rank", path, timeout=TIMEOUT_S["g"], world=2)
        tp = spawn_ranks("_tp_g1_rank", path, timeout=TIMEOUT_S["g"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def rel(k):
        return max(abs(r["rows"][i][k] - dp[0]["rows"][i][k]) / abs(dp[0]["rows"][i][k])
                   for r in tp for i in range(G_STEPS))
    bounds = {"max_over_lr_n": 2.0, "share_over_0.01_lr_n": 0.5, "share_over_0.1_lr_n": 0.01}
    cfg = _tp_config(MESH_G1, G1_LAYERS).model
    checks = {
        **{f"{k}_within_2e-3": rel(k) <= 2e-3 for k in ("loss", "ce", "grad_norm")},
        **{f"masters_{k}": all(r["facts"]["masters"][k] <= b for r in tp)
           for k, b in bounds.items()},
        "replicated_leaves_bitwise_across_model":
            all(r["facts"]["replicated_same_on_ranks"] for r in tp),
        "blocks_bitwise_across_data": all(r["facts"]["blocks_same_across_data"] for r in tp),
        "rmsnorm_launches_4L+1_a_step": all(
            x["rmsnorm_launches"] == 4 * G1_LAYERS + 1 for r in tp for x in r["rows"]),
        "finite": all(_finite(r) for r in tp + dp)}
    emit({"phase": "g1_tp_against_dp", "arch": cs.ARCH, "layers": G1_LAYERS,
          "mesh": list(MESH_G1), "reference_mesh": list(MESH_G1_DP), "backend": "nccl",
          "card": line, "rel": {k: rel(k) for k in ("loss", "ce", "grad_norm")},
          "masters": [r["facts"]["masters"] for r in tp],
          "tp": _tp_summary(tp, lambda r: r, cfg, MESH_G1, line),
          "dp": _tp_summary(dp, lambda r: r, cfg, MESH_G1_DP, line),
          "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail("(g1)", checks)

    t0 = time.monotonic()
    g2 = spawn_ranks("_tp_g2_rank", timeout=TIMEOUT_S["g"])
    cfg2 = _tp_config(MESH_G2, G2_LAYERS).model
    plan2 = _tp_plan(MESH_G2, G2_LAYERS, LMSConfig(enabled=False))
    summary = _tp_summary(g2, lambda r: r, cfg2, MESH_G2, line)
    checks = {"finite": all(_finite(r) for r in g2),
              "replicated_leaves_bitwise_across_model":
                  all(r["facts"]["replicated_same_on_ranks"] for r in g2),
              "rmsnorm_launches_4L+1_a_step": all(
                  x["rmsnorm_launches"] == 4 * G2_LAYERS + 1 for r in g2 for x in r["rows"])}
    emit({"phase": "g2_tp_resident", "arch": cs.ARCH, "backend": "nccl", **summary,
          "params": cfg2.param_count(),
          "plan_peak_bytes": plan2.peak_bytes,
          "peak_over_plan": [p / plan2.peak_bytes for p in summary["peak_bytes"]],
          "against_c": {"c_step_s": 8.45, "c_tokens_per_step": WORLD * cs.TRAIN_SEQ,
                        "c_tokens_per_s": WORLD * cs.TRAIN_SEQ / 8.45},
          "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail("(g2)", checks)

    t0 = time.monotonic()
    budget = LMSConfig(hbm_budget=cs.LMS_DDL_BUDGET)
    plan3 = _tp_plan(MESH_G1, G3_LAYERS, budget)
    need = 4 * plan3.host_bytes
    mem = _host_room("(g3)", need)
    g3 = spawn_ranks("_tp_g3_rank", timeout=TIMEOUT_S["g"])
    cfg3 = _tp_config(MESH_G1, G3_LAYERS).model
    res = {m: _tp_summary(g3, lambda r, m=m: r[m], cfg3, MESH_G1, line)
           for m in ("resident", "planned")}
    checks = {
        "plan_streams_params": plan3.residency.get("params") == "host",
        "planned_bitwise_resident_every_rank": all(
            [(x["loss"], x["grad_norm"]) for x in r["planned"]["rows"]]
            == [(x["loss"], x["grad_norm"]) for x in r["resident"]["rows"]]
            and r["planned"]["facts"]["checksums"] == r["resident"]["facts"]["checksums"]
            for r in g3),
        "finite": all(_finite(r[m]) for r in g3 for m in res)}
    emit({"phase": "g3_tp_planned", "arch": cs.ARCH, "backend": "nccl", "card": line,
          "hbm_budget": cs.LMS_DDL_BUDGET, **res, "plan_peak_bytes": plan3.peak_bytes,
          "plan_host_bytes": plan3.host_bytes,
          "peak_over_plan": [p / plan3.peak_bytes for p in res["planned"]["peak_bytes"]],
          "meminfo_before": mem, "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail("(g3)", checks)


# ---------------------------------------------------------------------------
# (h) serving on a model axis, and the MoE layer under expert parallelism
# ---------------------------------------------------------------------------

def _share(obj, mesh):
    """Rank 0's `obj` on every rank of the mesh's `model` group."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.groups["model"])
    return box[0]


def _serve_summary(run, line) -> dict:
    """An engine run's serving metrics (`cs._serve_on`'s facts)."""
    return {"card": line, "run_s": run["run_s"], "decode_tok_s": run["decode_tok_s"],
            "ticks": run["ticks"], "tick_s": run["decode_tokens"] / run["decode_tok_s"]
            / run["ticks"], "ttft_mean_s": run["ttft_mean_s"], "tpot_p50_s": run["tpot_p50_s"],
            "tpot_p95_s": run["tpot_p95_s"], "pool": run["pool"],
            "statuses": run["statuses"], "launches": {k: v for k, v in run["launches"].items()
                                                      if v}}


def _mesh_facts(run, mesh):
    """What every rank must hold alike: its tokens and the checksums of the
    gathered rows."""
    import torch
    return {"tokens": run["tokens"], "rows": cs._checksums(
        {str(k): torch.from_numpy(v) for k, v in sorted(run["rows"].items())})}


def _serve_h1_rank(rank: int, world: int, line):
    """(h1): qwen2-72b on MESH_H, first H_CHECK_LAYERS layers teacher-forced
    against one card (rank 0's), then all H1_LAYERS resident."""
    import dataclasses
    import gc
    import torch
    from repro_torch.config.base import LMSConfig, MeshSpec, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train.steps import init_params
    from repro_torch.tree import tree_leaves
    mesh = make_mesh(MeshSpec(MESH_H, cs.DDL_AXES))
    out = {"rank": rank}
    small = Model(dataclasses.replace(get_config(H1_ARCH), num_layers=H_CHECK_LAYERS))
    ref = None
    if rank == 0:
        full = small.init(cs.SEED, "cuda")
        ref = cs._serve_on(small, full, "model", None)
        del full
        gc.collect()
        torch.cuda.empty_cache()
    forced = _share(None if ref is None else ref["tokens"], mesh)
    blocks = init_params(small, cs.SEED, "cuda", mesh=mesh)
    run = cs._serve_on(small, blocks, "model", mesh, forced=forced)
    out["check"] = {"same": cs._same_on_all_ranks(_mesh_facts(run, mesh)),
                    "finite": run["finite"]}
    if ref is not None:
        out["check"]["against_one_card"] = cs._deviation(ref["rows"], run["rows"])
        out["check"]["one_card"] = _serve_summary(ref, line)
    del blocks, run, ref
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(H1_ARCH)
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    blocks = init_params(model, cs.SEED, "cuda", mesh=mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t0
    out["params_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(blocks))
    run = cs._serve_on(model, blocks, "model", mesh)
    plan = plan_lms(PlanRequest(cfg=cfg, shape=ShapeConfig("serve", "decode", cs.MAX_LEN,
                                                          cs.SLOTS),
                                mesh=MeshSpec(MESH_H, cs.DDL_AXES), lms=LMSConfig(enabled=False),
                                serve=True, slots=cs.SLOTS, backlog_slots=2 * cs.SLOTS,
                                page_size=cs.PAGE))
    out["resident"] = {**_serve_summary(run, line), "peak_bytes": run["peak_bytes"],
                       "plan_peak_bytes": plan.peak_bytes, "finite": run["finite"],
                       "same_on_all_ranks": cs._same_on_all_ranks(_mesh_facts(run, mesh))}
    return out


def _serve_h2_rank(rank: int, world: int, line):
    """(h2): qwen3-moe at H2_LAYERS layers on MESH_H, the experts over
    `model`: teacher-forced against one card (rank 0's), free-running, and
    with k = E against rank 0's one-card dense pass."""
    import gc
    import torch
    from repro_torch.config.base import MeshSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train.steps import init_params
    mesh = make_mesh(MeshSpec(MESH_H, cs.DDL_AXES))
    out = {"rank": rank}
    model = Model(cs._moe_cfg(H2_LAYERS))
    every = Model(cs._moe_cfg(H2_LAYERS, every=True))
    ref, full = None, None
    if rank == 0:
        full = model.init(cs.SEED, "cuda")
        ref = cs._serve_on(model, full, "model", None)
        out["one_card"] = _serve_summary(ref, line)
    forced = _share(None if ref is None else ref["tokens"], mesh)
    blocks = init_params(model, cs.SEED, "cuda", mesh=mesh)
    run = cs._serve_on(model, blocks, "model", mesh, forced=forced)
    out["forced"] = {"same": cs._same_on_all_ranks(_mesh_facts(run, mesh)),
                     "finite": run["finite"]}
    if ref is not None:
        out["forced"]["against_one_card"] = cs._deviation(ref["rows"], run["rows"])
    del run, ref
    free = cs._serve_on(model, blocks, "model", mesh)
    out["engine"] = {**_serve_summary(free, line), "peak_bytes": free["peak_bytes"],
                     "finite": free["finite"],
                     "same_on_all_ranks": cs._same_on_all_ranks(_mesh_facts(free, mesh))}
    del free
    # k = E: the same params (the router is E wide either way)
    erun = cs._serve_on(every, blocks, "model", mesh)
    out["every"] = {"same": cs._same_on_all_ranks(_mesh_facts(erun, mesh)),
                    "finite": erun["finite"], "statuses": erun["statuses"]}
    if full is not None:
        reqs = cs._mesh_requests(every.cfg, erun["tokens"])
        dense = {r.rid: cs._dense_rows(every, full, r) for r in reqs}
        out["every"]["against_dense"] = cs._deviation(dense, erun["rows"])
    del blocks, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_tp_config(mesh, lms=None, every: bool = False):
    """(h3): qwen3-moe at H3_LAYERS layers on `mesh`, as `_tp_config`;
    `every`: k = E (each token to every expert) at H3E_SEQ tokens a data
    rank."""
    import dataclasses
    from repro_torch.config.base import DDLConfig
    tcfg = cs._ddl_config(H3_LAYERS, mesh, ddl=DDLConfig(overlap_grads=True),
                          batch=mesh[0] * mesh[1], seq=H3E_SEQ if every else cs.TRAIN_SEQ,
                          log_every=1, arch=MOE)
    tcfg = dataclasses.replace(tcfg, model=cs._moe_cfg(H3_LAYERS, every=every),
                               learning_rate=cs.TRAIN_LR, warmup_steps=0, total_steps=G_STEPS)
    return tcfg if lms is None else dataclasses.replace(tcfg, lms=lms)


def _moe_dp_rank(rank: int, world: int, path: str, every: bool):
    """(h3)'s reference on MESH_G1_DP (each rank's replicated state does
    not fit the card at H3_LAYERS layers: under the plan of
    LMS_DDL_BUDGET, which the port runs bitwise resident)."""
    from repro_torch.config.base import LMSConfig
    return _tp_run(_moe_tp_config(MESH_G1_DP, LMSConfig(hbm_budget=cs.LMS_DDL_BUDGET), every),
                   masters_out=path)


def _moe_tp_rank(rank: int, world: int, path: str, every: bool):
    return _tp_run(_moe_tp_config(MESH_G1, every=every), masters_ref=path)


def _h3(line, rows_out, every: bool):
    """(h3), top-8 (the published routing) or k = E (`every`): 1x2x2 against
    1x2x1 on two cards. k = E is a continuous layer: every one of (g1)'s
    bounds is held. Top-8 moves whole token rows between experts where
    bf16 roundings part a near tie of the router's 8th and 9th choices
    (random init makes such ties common): loss and ce within 2e-3, the
    masters within 2 lr N, the leaves bitwise across ranks are held; the
    grad norm's distance and the masters' shares are reported."""
    import shutil
    import tempfile
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ddl_four_cards_h3_", dir=cs.CKPT_RAM_ROOT)
    try:
        path = os.path.join(tmp, "masters.pt")
        dp = spawn_ranks("_moe_dp_rank", path, every, timeout=TIMEOUT_S["h"], world=2)
        tp = spawn_ranks("_moe_tp_rank", path, every, timeout=TIMEOUT_S["h"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def rel(k):
        return max(abs(r["rows"][i][k] - dp[0]["rows"][i][k]) / abs(dp[0]["rows"][i][k])
                   for r in tp for i in range(G_STEPS))
    bounds = {"max_over_lr_n": 2.0, "share_over_0.01_lr_n": 0.5, "share_over_0.1_lr_n": 0.01}
    held_rel = ("loss", "ce", "grad_norm") if every else ("loss", "ce")
    held_masters = tuple(bounds) if every else ("max_over_lr_n",)
    cfg = _moe_tp_config(MESH_G1, every=every).model
    seq = H3E_SEQ if every else cs.TRAIN_SEQ
    checks = {
        **{f"{k}_within_2e-3": rel(k) <= 2e-3 for k in held_rel},
        **{f"masters_{k}": all(r["facts"]["masters"][k] <= bounds[k] for r in tp)
           for k in held_masters},
        "replicated_leaves_bitwise_across_model":
            all(r["facts"]["replicated_same_on_ranks"] for r in tp),
        "blocks_bitwise_across_data": all(r["facts"]["blocks_same_across_data"] for r in tp),
        "finite": all(_finite(r) for r in tp + dp)}
    name = "(h3e)" if every else "(h3)"
    emit({"phase": "h3e_moe_train_every_expert" if every else "h3_moe_train_expert_parallel",
          "arch": MOE, "layers": H3_LAYERS, "experts_per_token": cfg.experts_per_token,
          "seq": seq, "mesh": list(MESH_G1), "reference_mesh": list(MESH_G1_DP),
          "reference_hbm_budget": cs.LMS_DDL_BUDGET, "backend": "nccl", "card": line,
          "rel": {k: rel(k) for k in ("loss", "ce", "grad_norm")}, "bounds": bounds,
          "held": {"rel": list(held_rel), "masters": list(held_masters)},
          "masters": [r["facts"]["masters"] for r in tp],
          "tp": _tp_summary(tp, lambda r: r, cfg, MESH_G1, line, seq),
          "dp": _tp_summary(dp, lambda r: r, cfg, MESH_G1_DP, line, seq),
          "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail(name, checks)


def phase_h(line, rows_out):
    """(h) serving on a `model` axis across the cards, and the MoE layer
    under expert parallelism (the module docstring)."""
    t0 = time.monotonic()
    h1 = spawn_ranks("_serve_h1_rank", line, timeout=TIMEOUT_S["h"])
    r0 = h1[0]
    res = r0["resident"]
    tol = 2.0 ** -5
    checks = {"check_within_2**-5_of_one_card": r0["check"]["against_one_card"]["worst"] <= tol,
              "check_same_on_all_ranks": all(r["check"]["same"] for r in h1),
              "tokens_same_on_all_ranks": all(r["resident"]["same_on_all_ranks"] for r in h1),
              "finite": all(r["check"]["finite"] and r["resident"]["finite"] for r in h1),
              "all_ok": res["statuses"] == ["ok"] * cs.REQUESTS}
    emit({"phase": "h1_serve_qwen2_72b", "arch": H1_ARCH, "layers": H1_LAYERS,
          "mesh": list(MESH_H), "backend": "nccl", "card": line,
          "requests": cs.REQUESTS, "prompt": cs.PROMPT, "gen": cs.GEN, "slots": cs.SLOTS,
          "resident": res, "init_s": [r["init_s"] for r in h1],
          "params_bytes_a_rank": [r["params_bytes"] for r in h1],
          "peak_bytes": [r["resident"]["peak_bytes"] for r in h1],
          "peak_over_plan": [r["resident"]["peak_bytes"] / res["plan_peak_bytes"] for r in h1],
          "check": r0["check"], "check_layers": H_CHECK_LAYERS,
          "against_host_streamed": {"tick_s_pr27": PR27_TICK_S,
                                    "speedup": PR27_TICK_S / res["tick_s"]},
          "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail("(h1)", checks)

    t0 = time.monotonic()
    h2 = spawn_ranks("_serve_h2_rank", line, timeout=TIMEOUT_S["h"])
    r0 = h2[0]
    checks = {"every_within_2**-5_of_the_dense_pass":
                  r0["every"]["against_dense"]["worst"] <= tol,
              "same_on_all_ranks": all(r["forced"]["same"] and r["engine"]["same_on_all_ranks"]
                                       and r["every"]["same"] for r in h2),
              "finite": all(r["forced"]["finite"] and r["engine"]["finite"]
                            and r["every"]["finite"] for r in h2),
              "all_ok": r0["engine"]["statuses"] == ["ok"] * cs.REQUESTS
              and r0["every"]["statuses"] == ["ok"] * cs.REQUESTS}
    emit({"phase": "h2_serve_qwen3_moe_expert_parallel", "arch": MOE, "layers": H2_LAYERS,
          "mesh": list(MESH_H), "backend": "nccl", "card": line, "engine": r0["engine"],
          "one_card": r0["one_card"], "one_card_tok_s_pr30": PR30_MOE_TOK_S,
          "forced_against_one_card": r0["forced"]["against_one_card"],
          "every_against_dense": r0["every"]["against_dense"],
          "peak_bytes": [r["engine"]["peak_bytes"] for r in h2],
          "seconds": time.monotonic() - t0, "checks": checks}, rows_out)
    _fail("(h2)", checks)

    _h3(line, rows_out, every=False)
    _h3(line, rows_out, every=True)


def emit(row, rows_out):
    rows_out.append(row)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(rows_out, f, indent=1)
    print(json.dumps(row), flush=True)


def header():
    """The cards, the host and NCCL, printed raw and as one JSON row. ->
    the first card's nvidia-smi line."""
    import torch
    n = torch.cuda.device_count()
    if n < WORLD:
        raise SystemExit(f"ddl_four_cards.py needs {WORLD} cards, this machine has {n}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    for s in smi:
        print(s, flush=True)
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout
    mem = cs._mem_row()
    print(json.dumps({"phase": "host", "cards": smi, "count": n,
                      "mem_available": mem["MemAvailable"], "mem_total": mem["MemTotal"],
                      "nproc": os.cpu_count(), "nccl": str(torch.cuda.nccl.version()),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "topo": topo}), flush=True)
    return smi[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="a,b,c,d,e,f,g,h",
                    help="comma-separated subset of a,b,c,d,e,f,g,h (a and d run together), "
                    "or h3e: (h3)'s k = E run alone")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    known = {"a", "b", "c", "d", "e", "f", "g", "h", "h3e"}
    if not phases <= known:
        raise SystemExit(f"--phases: unknown {sorted(phases - known)}")
    import torch
    line = header()
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.extension()
    rows = []
    emit({"phase": "build", "seconds": time.monotonic() - t0}, rows)
    if phases & {"a", "d"}:
        phase_a_d(line, rows)
    if "b" in phases:
        phase_b(line, rows)
    if "e" in phases:
        phase_e(line, rows)
    if "c" in phases:
        phase_c(line, rows)
    if "f" in phases:
        phase_f(line, rows)
    if "g" in phases:
        phase_g(line, rows)
    if "h" in phases:
        phase_h(line, rows)
    elif "h3e" in phases:
        _h3(line, rows, every=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
