"""LMS memory planner — the analytic analogue of TFLMS's static graph
analysis. Given (model config, shape, mesh, HBM budget) it sizes every
tensor class on one device, models lifetimes across the layer schedule, and
assigns each class to {save, offload, remat} plus a residency (device/host)
for params, gradients, optimizer state and KV cache, so that the projected
per-device peak fits the budget.

Key deviation from TFLMS (documented in DESIGN.md §2): TFLMS always swapped;
on TPU the host link is ~25x slower than HBM, so the planner offloads only
when the swap is overlappable with a layer's compute
(swap_time <= layer_compute_time) and prefers remat otherwise.

Planner v2 (DESIGN.md §13): the unified entry point is
``plan(PlanRequest(...), profile=...)``. Without a profile it reproduces the
v1 static pricing exactly; with one (an ``obs_report.json`` path, its dict,
or a prebuilt `CostModel`) the remat-vs-swap-vs-resident choice, the
prefetch depth, the serve pool's staging depth and the DDL bucket size are
all re-derived from MEASURED bandwidth/overlap and the jaxpr auditor's
live-bytes margins. ``plan_memory`` / ``plan_serve_memory`` remain as thin
deprecated wrappers over the facade.

A copy of the JAX package's `core/lms/planner.py` over the port's
configs and hardware model (`hw.DEFAULT` is the H100, so an uncalibrated
plan is priced for the card); plans equal the JAX package's field by field
for the same inputs. The port's executor of a plan: the layer-streaming
decoder (`models/transformer.py`), the streamed optimizer sweep and the
state placement (`train/steps.py`), the activation policy
(`core/lms/policies.py`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch import hw as hwlib
from repro_torch.config.base import LMSConfig, MeshSpec, ModelConfig, ShapeConfig
from repro_torch.core.lms.costmodel import CostModel


@dataclass
class TensorClass:
    name: str
    bytes_dev: int            # per-device bytes per layer instance
    recompute_flops: float    # per-device FLOPs to rebuild one instance
    per_layer: bool = True


# Every residency class an executor stream exists for. Order is the
# canonical order of SwapSchedule.stream.
STREAM_CLASSES = ("params", "kvcache", "optimizer", "grads")

# The streamed optimizer sweep updates large UNSCANNED remainder leaves
# (embeddings, LM head) in this many flattened-view chunks (largest
# power-of-2 factor of the leaf's element count up to it — vocab*d_model is
# essentially always 16-divisible even when the vocab is odd), streamed
# in/out per chunk — bounding the remainder's optimizer working set to ~2
# chunks of state the same way the layer sweep bounds the decoder stacks to
# ~2 layers. Shared with the executor (train/steps.py imports it) so
# pricing and execution cannot drift.
OPT_REST_CHUNKS = 16

# Optimizer pricing per known optimizer: fp32 m+v+master (adamw) vs fp32
# momentum (sgdm) state bytes per parameter, and the per-step HBM
# read+write traffic multiplier hbm_traffic_model uses. Keyed by the SAME
# names optim.adamw.OPTIMIZERS dispatches on; validate_optimizer is the
# single gate so a typo'd name raises instead of silently getting momentum
# pricing (the old `== "adamw"` string compare).
OPT_STATE_MULT = {"adamw": 12, "sgdm": 4}
OPT_TRAFFIC_MULT = {"adamw": 24, "sgdm": 8}


def validate_optimizer(name: str) -> str:
    """Gate an optimizer name against the known set (mirrors
    kvquant.validate_kv_dtype): the planner's state/traffic pricing and the
    trainer's update dispatch must agree on what the name means."""
    if name not in OPT_STATE_MULT:
        raise ValueError(
            f"unknown optimizer {name!r}: expected one of "
            f"{sorted(OPT_STATE_MULT)} (see optim.adamw.OPTIMIZERS)")
    return name


@dataclass(frozen=True)
class SwapSchedule:
    """The planner→executor contract for host-resident tensor classes (see
    DESIGN.md §3/§6): WHICH classes stream per layer, HOW far ahead the
    executor prefetches, and the layer visitation order of each sweep. The
    executor (`models/transformer.py` streamed scans; the streamed optimizer
    sweep in `train/steps.py`) follows this; the planner's
    `swap_bytes_per_step` accounting assumes exactly one swap-in per layer
    per sweep listed here, itemised per class in `swap_bytes`.

    Stream classes beyond params/kvcache:

    * ``"optimizer"`` — the monolithic opt_update is replaced by a
      `lax.scan` over the stacked decoder layer axis that swaps one layer's
      optimizer-state slice into HBM, updates it, and swaps it back
      (double-buffered at `prefetch_depth`); the unscanned remainder
      (embeddings, norms) updates resident.
    * ``"grads"`` — the overlapped-backward hooks sink each layer's reduced
      cotangent to host as it is produced; the streamed optimizer sweep
      reads them back layer by layer.

    The current executors implement exactly the canonical orders
    make_swap_schedule emits — fwd `range(L)` via the scan, bwd
    `reversed(range(L))` via remat of the scan body, the optimizer sweep
    `range(L)` after the backward — so `fwd_order` / `bwd_order` DESCRIBE
    the executed sweeps (and whether a bwd sweep exists at all); arbitrary
    permutations are not supported and would be silently ignored. A plan
    wanting a different visitation order needs executor work, not just
    different tuples here."""
    prefetch_depth: int = 2             # layers in flight (2 = double buffer)
    stream: Tuple[str, ...] = ()        # subset of STREAM_CLASSES
    fwd_order: Tuple[int, ...] = ()     # layer indices, forward sweep
    bwd_order: Tuple[int, ...] = ()     # backward sweep ((), for inference)
    # DDL reduction issued per layer inside the bwd sweep (the reduced grad
    # is what streams out as the next layer's params stream in) vs one
    # post-hoc pass after the sweep. Descriptive copy of the plan's decision
    # for readers of the executor contract; `MemoryPlan.overlap_grads` is
    # the authoritative field the step builders resolve against (reduction
    # overlap applies whether or not anything streams).
    overlap_grads: bool = True
    # priced host<->device bytes per step, itemised per host-resident class
    # — placement-only classes included, so the pairs reconcile with
    # MemoryPlan.swap_bytes_per_step ((class, bytes); both directions
    # summed). Caveat: a plan whose ONLY host class is placement-only has
    # no schedule at all (None iff nothing streams), so its traffic is
    # reported solely through MemoryPlan.swap_bytes_per_step.
    swap_bytes: Tuple[Tuple[str, int], ...] = ()

    @property
    def streams_params(self) -> bool:
        return "params" in self.stream

    @property
    def streams_kvcache(self) -> bool:
        return "kvcache" in self.stream

    @property
    def streams_optimizer(self) -> bool:
        return "optimizer" in self.stream

    @property
    def streams_grads(self) -> bool:
        return "grads" in self.stream

    def bytes_for(self, cls: str) -> int:
        """Priced swap traffic of one host-resident class (0 if unpriced)."""
        return dict(self.swap_bytes).get(cls, 0)

    @property
    def sweeps_per_step(self) -> int:
        return (1 if self.fwd_order else 0) + (1 if self.bwd_order else 0)


@dataclass(frozen=True)
class KVPagingPlan:
    """Sizing of the paged, host-spilling KV pool (serve/kvpool.py) — the
    SERVING-side executor of the kvcache residency class. A page is
    `page_size` token-positions of the whole layer stack for one slot; the
    pool keeps active slots' pages in a SHARED device arena addressed
    through an int32[slots, max_pages] page table (true paged attention,
    DESIGN.md §9), spills prefilled-but-waiting requests' pages to pinned
    host, and maps them back with page-table pointer writes when a slot
    frees. `device_pages` are USABLE pages: the arena physically carries
    one extra null page (the free-slot target) and the table itself, both
    already charged by `price_kv_paging` — the budget converts directly
    into concurrency with no fragmentation slack, since the table makes
    page placement irrelevant. Admission control reserves a request's full
    page need up front against `device_pages` (no mid-decode preemption)."""
    page_size: int            # token-positions per page (whole layer stack)
    page_bytes: int           # per-device bytes of one page (paged leaves)
    state_bytes: int          # per-slot seq-independent cache bytes
    pages_per_slot: int       # pages a full-length slot occupies
    device_pages: int         # HBM page budget (active working set)
    host_pages: int           # host arena capacity (spilled backlog)
    # host STATE-arena capacity in requests (= the priced backlog depth).
    # Carried explicitly because seq-independent-cache families (ssm/rglru)
    # have host_pages == 0, so the pool could not derive it
    host_slots: int = 0
    # page storage width: "model" (full width) or "int8" (codes + per-row
    # f32 scales — ~half the bf16 page bytes, so ~2x device-resident
    # concurrency at a fixed byte budget). The engine reads this knob.
    kv_dtype: str = "model"

    @property
    def slot_budget(self) -> int:
        """Max concurrent full-length slots the device page budget admits."""
        if self.pages_per_slot <= 0:
            return self.device_pages
        return self.device_pages // self.pages_per_slot


@dataclass
class MemoryPlan:
    assignment: Dict[str, str]          # activation name -> save|offload|remat
    residency: Dict[str, str]           # params/grads/optimizer/kvcache -> device|host
    peak_bytes: int                     # projected per-device HBM peak
    host_bytes: int                     # projected per-device host usage
    swap_bytes_per_step: int            # host<->device traffic per step (both dirs)
    budget: int
    fits: bool
    notes: List[str] = field(default_factory=list)
    swap_schedule: Optional[SwapSchedule] = None  # set iff something streams
    # priced recommendation for train plans (None for inference / dp==1):
    # True iff per-layer in-scan reduction beats the post-hoc pass
    overlap_grads: Optional[bool] = None
    # residency classes executed by PLACEMENT alone (no per-layer stream),
    # by documented design — e.g. zero1's flat 1/|data| optimizer shard.
    # Every other host-resident class MUST appear in swap_schedule.stream
    # (check_schedule_invariant enforces this at plan time).
    placement_only: Tuple[str, ...] = ()
    # serve plans only: the paged-pool sizing that EXECUTES kvcache host
    # residency (required by check_schedule_invariant when serve=True)
    kv_paging: Optional[KVPagingPlan] = None
    # Planner v2: True iff a measured CostModel priced this plan (peak then
    # includes the audited live-bytes margin; tuned knobs below are set)
    calibrated: bool = False
    # calibrated DDL gradient-bucket size; None = leave DDLConfig's default.
    # Consumed by the step builders only when DDLConfig.bucket_mb is None
    # (auto) — an explicit user bucket always wins.
    tuned_bucket_mb: Optional[int] = None

    def summary(self) -> str:
        gb = 1024 ** 3
        lines = [f"LMS plan: peak {self.peak_bytes/gb:.2f} GiB / budget "
                 f"{self.budget/gb:.2f} GiB ({'fits' if self.fits else 'DOES NOT FIT'})",
                 f"  host: {self.host_bytes/gb:.2f} GiB, swap/step: "
                 f"{self.swap_bytes_per_step/gb:.2f} GiB",
                 f"  residency: {self.residency}",
                 f"  activations: {self.assignment}"]
        if self.swap_schedule is not None:
            s = self.swap_schedule
            lines.append(f"  swap schedule: stream={list(s.stream)} "
                         f"prefetch={s.prefetch_depth} sweeps={s.sweeps_per_step}")
        if self.placement_only:
            lines.append(f"  placement-only: {list(self.placement_only)}")
        if self.kv_paging is not None:
            kp = self.kv_paging
            lines.append(f"  kv paging: page={kp.page_size}tok "
                         f"dev={kp.device_pages}p host={kp.host_pages}p "
                         f"({kp.slot_budget} concurrent slots, "
                         f"{kp.kv_dtype} pages)")
        if self.overlap_grads is not None:
            lines.append(f"  grad reduction: "
                         f"{'overlapped' if self.overlap_grads else 'serialized'}")
        if self.calibrated:
            lines.append(f"  calibrated: yes"
                         + (f" (DDL bucket {self.tuned_bucket_mb} MiB)"
                            if self.tuned_bucket_mb else ""))
        lines += [f"  note: {n}" for n in self.notes]
        return "\n".join(lines)


def _axis_size(mesh: MeshSpec, name: str) -> int:
    return dict(zip(mesh.axes, mesh.shape)).get(name, 1)


def make_swap_schedule(residency: Dict[str, str], num_layers: int,
                       kind: str, prefetch_depth: int = 2,
                       overlap_grads: bool = True,
                       swap_bytes: Optional[Dict[str, int]] = None,
                       placement_only: Tuple[str, ...] = ()
                       ) -> Optional[SwapSchedule]:
    """Derive the executor schedule from a residency map: every host-resident
    streamable class streams once per sweep (params/kvcache inside the layer
    scans; optimizer/grads via the streamed optimizer sweep and the backward
    hooks' host sink); training plans sweep fwd then bwd (the remat of the
    layer body re-issues the swap-ins in reverse), inference plans sweep fwd
    only. Classes in `placement_only` are executed by placement alone and
    deliberately kept out of the stream list. None when nothing streams."""
    stream = tuple(k for k in STREAM_CLASSES
                   if residency.get(k) == "host" and k not in placement_only)
    if not stream:
        return None
    fwd = tuple(range(num_layers))
    bwd = tuple(reversed(fwd)) if kind == "train" else ()
    # itemise EVERY priced class, placement-only included, so the breakdown
    # reconciles with MemoryPlan.swap_bytes_per_step
    sb = tuple(sorted((k, int(v)) for k, v in (swap_bytes or {}).items()))
    return SwapSchedule(prefetch_depth=prefetch_depth, stream=stream,
                        fwd_order=fwd, bwd_order=bwd,
                        overlap_grads=overlap_grads and kind == "train",
                        swap_bytes=sb)


def check_schedule_invariant(residency: Dict[str, str],
                             schedule: Optional[SwapSchedule],
                             placement_only: Tuple[str, ...] = (), *,
                             serve: bool = False,
                             kv_paging: Optional[KVPagingPlan] = None,
                             step_fn=None, step_args: Tuple = (),
                             host_avals=(), expect_donation: bool = False,
                             step_name: str = "step") -> None:
    """Planner invariant (DESIGN.md §6/§7): every residency class priced into
    `host_bytes` must either appear in `SwapSchedule.stream` (an executor
    stream exists and will run) or be declared placement-only by documented
    design. A plan that promises host residency the executor never delivers
    would report peak/fits numbers that are fiction — fail at plan time, not
    at OOM time.

    serve=True (continuous-batching plans): the kvcache stream class is
    executed by the paged pool (serve/kvpool.py), not the per-layer decode
    stream — the slot-batched decode step needs every ACTIVE slot's pages in
    HBM, so the only thing that can deliver host residency is paging the
    backlog. Host kvcache residency in a serve plan therefore additionally
    requires a declared `kv_paging` sizing.

    step_fn (+ step_args, host_avals, expect_donation, step_name): in the
    JAX package, a jitted step its jaxpr auditor checks against the plan.
    The port has no auditor yet: giving step_fn raises NotImplementedError."""
    streams = set(schedule.stream) if schedule is not None else set()
    missing = sorted(c for c, r in residency.items()
                     if r == "host" and c not in streams
                     and c not in placement_only)
    if missing:
        raise AssertionError(
            f"MemoryPlan promises host residency for {missing} but no "
            f"executor stream exists (SwapSchedule.stream={sorted(streams)}, "
            f"placement_only={sorted(placement_only)}); the plan's peak/fits "
            "accounting would never be delivered at runtime")
    if serve and residency.get("kvcache") == "host" and kv_paging is None:
        raise AssertionError(
            "serve plan promises host residency for the KV cache but no "
            "paged-pool executor is declared (kv_paging=None): the "
            "slot-batched decode step keeps active slots' pages in HBM, so "
            "only the paging pool (serve/kvpool.py) can execute the "
            "spill/return traffic this plan prices")
    if step_fn is not None:
        raise NotImplementedError(
            "the step auditor (check_schedule_invariant(step_fn=...)) is not "
            "ported yet")


def _logical_factor(mesh: MeshSpec, logical: str, rules=None) -> int:
    from repro_torch.models.sharding import DEFAULT_RULES
    rules = rules or DEFAULT_RULES
    f = 1
    for a in rules.get(logical, ()):
        f *= _axis_size(mesh, a)
    return f


def activation_classes(cfg: ModelConfig, shape: ShapeConfig,
                       mesh: MeshSpec) -> List[TensorClass]:
    """Per-layer activation classes with per-device bytes (post-sharding)."""
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    tp = _axis_size(mesh, "model")
    b = max(shape.global_batch // dp, 1)
    s = shape.seq_len
    d, f = cfg.d_model, cfg.d_ff
    bs2 = b * s * 2  # bf16
    out: List[TensorClass] = []
    kinds = cfg.layer_kinds()
    has_attn = any(k in ("attn", "local_attn") for k in kinds)
    # residual stream + norms are unsharded across model
    out.append(TensorClass("resid", bs2 * d, 0.0))
    out.append(TensorClass("attn_norm" if has_attn else "ln_in", bs2 * d,
                           2.0 * b * s * d))
    if has_attn:
        hq = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        out.append(TensorClass("qkv", bs2 * hq // tp, 2.0 * b * s * d * hq / tp))
        out.append(TensorClass("attn_out", bs2 * hq // tp,
                               4.0 * b * s * s * cfg.head_dim * cfg.num_heads / tp))
    if cfg.family == "ssm":
        di = cfg.d_inner
        out.append(TensorClass("ssd_xz", bs2 * 2 * di // tp, 2.0 * b * s * d * 2 * di / tp))
        nstate = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
        nchunks = max(s // cfg.ssm_chunk, 1)
        out.append(TensorClass("ssd_state", b * nchunks * nstate * 4 // tp,
                               2.0 * b * s * di * cfg.ssm_state / tp))
    if cfg.family == "hybrid":
        w = cfg.lru_width or d
        out.append(TensorClass("lru_h", bs2 * w // tp, 4.0 * b * s * w * w / tp))
    if cfg.num_experts:
        cap_rows = int(b * s * cfg.experts_per_token * cfg.moe_capacity_factor)
        out.append(TensorClass("moe_hidden", cap_rows * f * 2 // tp,
                               2.0 * cap_rows * d * f / tp))
        out.append(TensorClass("router_probs", b * s * cfg.num_experts * 4,
                               2.0 * b * s * d * cfg.num_experts))
    elif cfg.family != "ssm":
        gated = cfg.mlp_act in ("swiglu", "geglu")
        mult = 3 if gated else 2  # g, u, h tagged together
        out.append(TensorClass("mlp_hidden", mult * bs2 * f // tp,
                               2.0 * mult * b * s * d * f / tp))
        out.append(TensorClass("mlp_norm", bs2 * d, 2.0 * b * s * d))
    return out


def layer_flops_dev(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec) -> float:
    """Approx fwd FLOPs of one layer on one device."""
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    tp = _axis_size(mesh, "model")
    tokens = max(shape.global_batch // dp, 1) * shape.seq_len
    active = cfg.active_param_count() / max(cfg.num_layers, 1)
    flops = 2.0 * tokens * active / tp
    if cfg.num_heads:
        w = cfg.window or shape.seq_len
        flops += 4.0 * tokens * min(w, shape.seq_len) * cfg.num_heads * cfg.head_dim / tp
    return flops


def price_grad_reduction(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                         hw: "hwlib.HardwareSpec" = None, *,
                         compress_dcn: bool = False,
                         microbatches: int = 1) -> Tuple[float, float]:
    """(serialized_s, overlapped_s): the post-hoc monolithic DDL reduce vs
    per-layer reduction issued inside the backward sweep.

    Serialized: one ddl_allreduce_time over the full f32 gradient volume,
    entirely exposed after the last layer's backward.  Overlapped: L
    collectives of 1/L the volume, each hidden behind one layer of backward
    compute (~2x the forward FLOPs); only the excess of a layer's reduction
    over its backward compute — plus the final layer's reduction, which has
    nothing left to hide behind — is exposed.  Per-layer collectives pay the
    ring latency L times, so tiny models on high-latency fabrics can price
    serialized cheaper; that is the point of pricing it.

    With gradient accumulation the asymmetry grows: the serialized path
    reduces ONCE after all microbatches, while the overlapped hooks
    reduce-scatter inside every microbatch's backward — `microbatches`x the
    fabric volume (each occurrence overlapped with that microbatch's
    compute). Fabric-bound configs with deep accumulation price serialized
    cheaper, and the planner should say so."""
    from repro_torch.core.ddl.topology import ddl_allreduce_time
    hw = hw or hwlib.DEFAULT
    data = _axis_size(mesh, "data")
    pods = _axis_size(mesh, "pod")
    if data * pods <= 1:
        return 0.0, 0.0
    tp = max(_axis_size(mesh, "model"), 1)
    gbytes = 4.0 * cfg.param_count() / tp          # reductions run in f32
    serialized = ddl_allreduce_time(gbytes, data, pods,
                                    compress_dcn=compress_dcn, hw=hw)
    L = max(cfg.num_layers, 1)
    m = max(microbatches, 1)
    t_layer = ddl_allreduce_time(gbytes / L, data, pods,
                                 compress_dcn=compress_dcn, hw=hw)
    mb_shape = dataclasses.replace(
        shape, global_batch=max(shape.global_batch // m, 1))
    bwd_layer = 2.0 * layer_flops_dev(cfg, mb_shape, mesh) / hw.peak_flops_bf16
    exposed_per_mb = (L - 1) * max(0.0, t_layer - bwd_layer) + t_layer
    return serialized, m * exposed_per_mb


def kv_cache_bytes_dev(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                       rules=None) -> int:
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    tp = _axis_size(mesh, "model")
    b = max(shape.global_batch // dp, 1)
    # kv-head sharding only helps when heads divide the axis; the kv_seq
    # rule (flash-decode split) shards the sequence dim instead
    kvh_f = tp if cfg.num_kv_heads % max(tp, 1) == 0 else 1
    seq_f = _logical_factor(mesh, "kv_seq", rules)
    f = max(kvh_f, seq_f)
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            total += 2 * b * shape.seq_len * cfg.num_kv_heads * cfg.head_dim * 2 // f
        elif kind == "local_attn":
            s = min(cfg.window, shape.seq_len)
            total += 2 * b * s * cfg.num_kv_heads * cfg.head_dim * 2 // f
        elif kind == "ssd":
            total += b * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4 // tp
            total += b * (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state) * 2
        elif kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            total += b * w * 4 // tp + b * 3 * w * 2
    if cfg.is_encdec:
        total += 2 * cfg.num_layers * max(shape.global_batch // dp, 1) * \
            cfg.encoder_seq * max(cfg.num_kv_heads // tp, 1) * cfg.head_dim * 2
    return total


def kv_token_bytes_dev(cfg: ModelConfig, mesh: MeshSpec, rules=None,
                       kv_dtype: str = "model") -> int:
    """Per-device bytes one token-position of the WHOLE layer stack adds to
    a single slot's pageable KV. Only full-history "attn" layers grow with
    the sequence; ring (local_attn) and recurrent (ssd/rglru) caches are
    seq-independent per-slot state, and the encoder-decoder cross cache is
    fixed at encoder_seq — all of those are state, not pages.

    kv_dtype="int8": pages hold int8 codes plus one f32 scale per
    token-position per kv head (k and v each), the serve pool's compact
    page format."""
    from repro_torch.models import kvquant
    tp = _axis_size(mesh, "model")
    kvh_f = tp if cfg.num_kv_heads % max(tp, 1) == 0 else 1
    seq_f = _logical_factor(mesh, "kv_seq", rules)
    f = max(kvh_f, seq_f)
    per = 0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            if kvquant.is_int8(kv_dtype):
                per += 2 * cfg.num_kv_heads * (cfg.head_dim * 1 + 4) // f
            else:
                per += 2 * cfg.num_kv_heads * cfg.head_dim * 2 // f
    return per


def price_kv_paging(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, *,
                    budget: int, page_size: int = 64,
                    slots: Optional[int] = None,
                    backlog_slots: Optional[int] = None,
                    rules=None, kv_dtype: str = "model") -> KVPagingPlan:
    """Size the paged KV pool for a serve plan: how many pages of decode KV
    fit the pool's HBM allotment after the per-slot recurrent state is
    charged — the device page budget the engine's admission control
    reserves against — plus a host arena sized for the
    prefilled-but-waiting backlog.

    `budget` is the HBM allotted to the KV pool on one device — the CALLER
    (plan_serve_memory) has already charged the weights' residency and the
    decode transients against the full budget. A page is `page_size`
    token-positions of every attn layer's k+v for one slot; requests
    reserve ceil(total_len / page_size) pages at admission."""
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    b = max(shape.global_batch // dp, 1)
    slots = slots or b
    backlog = backlog_slots if backlog_slots is not None else 2 * slots
    # the pool requires the page grid to tile the cache exactly; snap to
    # the largest dividing page size so plan and executor agree
    page_size = math.gcd(shape.seq_len, page_size)

    # page width follows kv_dtype; the STATE residual must be carved out of
    # the per-slot total at MODEL width (state never quantizes), or the
    # int8 savings would be double-counted as extra state
    token_bytes = kv_token_bytes_dev(cfg, mesh, rules, kv_dtype=kv_dtype)
    token_bytes_model = kv_token_bytes_dev(cfg, mesh, rules)
    shape1 = dataclasses.replace(shape, global_batch=dp)       # per-slot view
    per_slot_total = kv_cache_bytes_dev(cfg, shape1, mesh, rules=rules)
    state_bytes = max(per_slot_total - token_bytes_model * shape.seq_len, 0)
    pages_per_slot = -(-shape.seq_len // page_size) if token_bytes else 0
    page_bytes = token_bytes * page_size

    free = budget - slots * state_bytes
    if page_bytes:
        # arena overheads come off the top: the int32 page table (4 bytes
        # per slot-page entry) and the single null page free slots point at.
        # No fragmentation slack beyond that — under table indirection any
        # free page serves any slot, so the budget converts directly into
        # concurrency. At least one full-length slot must still fit or
        # serving cannot make progress; beyond slots*pages_per_slot extra
        # pages are unusable (no slot could ever map them)
        table_bytes = slots * pages_per_slot * 4
        device_pages = max((free - table_bytes) // page_bytes - 1,
                           pages_per_slot)
        device_pages = min(device_pages, slots * pages_per_slot)
    else:
        device_pages = 0
    return KVPagingPlan(page_size=page_size, page_bytes=int(page_bytes),
                        state_bytes=int(state_bytes),
                        pages_per_slot=int(pages_per_slot),
                        device_pages=int(device_pages),
                        host_pages=int(backlog * pages_per_slot),
                        host_slots=int(backlog), kv_dtype=kv_dtype)


@dataclass(frozen=True)
class PlanRequest:
    """One planning request — the whole kwarg surface of the legacy
    `plan_memory` / `plan_serve_memory` entry points as data, so callers
    build ONE object instead of threading nine positional kwargs.
    ``serve=True`` selects the continuous-batching serve plan (decode shape
    + paged-pool sizing); the serve-only fields are ignored otherwise."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: MeshSpec
    lms: LMSConfig = LMSConfig()
    hw: hwlib.HardwareSpec = hwlib.DEFAULT
    optimizer: str = "adamw"
    zero1: bool = False
    rules: Optional[dict] = None
    microbatches: int = 1
    serve: bool = False
    # serve-only sizing knobs
    slots: Optional[int] = None
    backlog_slots: Optional[int] = None
    page_size: int = 64
    kv_dtype: str = "model"


def _as_cost(profile, hw: hwlib.HardwareSpec) -> Optional[CostModel]:
    """Normalize the `profile` argument: None stays None (pure v1 pricing),
    a CostModel passes through, a dict is an in-memory obs_report, anything
    else is an obs_report.json path."""
    if profile is None:
        return None
    if isinstance(profile, CostModel):
        return profile
    if isinstance(profile, dict):
        return CostModel.from_reports(profile, hw=hw)
    return CostModel.load(str(profile), hw=hw)


def plan(request: PlanRequest,
         profile: Union[None, CostModel, dict, str] = None) -> MemoryPlan:
    """Unified planning facade (Planner v2, DESIGN.md §13): one entry point
    for train, inference and serve plans. `profile` optionally calibrates
    the pricing — a `CostModel`, an obs_report dict, or an obs_report.json
    path; None reproduces the v1 static-constant plan bit for bit."""
    cost = _as_cost(profile, request.hw)
    if request.serve:
        return _plan_serve(request, cost)
    return _plan_memory(request, cost)


def plan_serve_memory(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                      lms: LMSConfig = LMSConfig(),
                      hw: hwlib.HardwareSpec = hwlib.DEFAULT, *,
                      slots: Optional[int] = None,
                      backlog_slots: Optional[int] = None,
                      page_size: int = 64, rules=None,
                      kv_dtype: str = "model") -> MemoryPlan:
    """Deprecated wrapper: build a serve `PlanRequest` and call `plan`.
    Kept so existing callers/tests keep passing; new code uses the facade."""
    return plan(PlanRequest(cfg=cfg, shape=shape, mesh=mesh, lms=lms, hw=hw,
                            rules=rules, serve=True, slots=slots,
                            backlog_slots=backlog_slots, page_size=page_size,
                            kv_dtype=kv_dtype))


def _plan_serve(req: PlanRequest, cost: Optional[CostModel]) -> MemoryPlan:
    """Serving-engine plan (continuous batching over `slots` decode slots
    with a `backlog_slots`-deep admission queue): decode-shape residency
    PLUS the paged-pool sizing that executes kvcache host residency.

    Unlike the static decode plan — whose kvcache stream is executed per
    layer inside the decode scan — a serve plan's host KV residency means
    the AGGREGATE footprint (active slots + prefilled backlog) exceeds the
    device page budget, and the paged pool spills the backlog while the
    decode working set stays in HBM. check_schedule_invariant(serve=True)
    refuses the promise unless the pool sizing is attached."""
    cfg, shape, mesh, lms, hw = req.cfg, req.shape, req.mesh, req.lms, req.hw
    rules, page_size, kv_dtype = req.rules, req.page_size, req.kv_dtype
    if shape.kind != "decode":
        raise ValueError(f"serve plans are decode-shaped, got {shape.kind!r}")
    budget_full = (lms.hbm_budget or hw.hbm_bytes)
    budget_full = int(budget_full * (1.0 - lms.workspace_frac))
    cal = cost is not None and cost.calibrated
    # audited live-bytes feedback (JXA005): the margin the jaxpr auditor
    # measured past the plan's pricing tightens the working budget and is
    # charged back into the reported peak, so a calibrated plan's
    # plan_delta_bytes can only shrink
    margin = cost.live_margin("decode") if cal else 0
    budget = budget_full - margin
    tp = _axis_size(mesh, "model")
    dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
    b = max(shape.global_batch // dp, 1)
    slots = req.slots or b
    backlog = req.backlog_slots if req.backlog_slots is not None else 2 * slots
    L = cfg.num_layers
    notes: List[str] = []
    if cal:
        notes.append(cost.describe())
    if margin:
        notes.append(f"budget tightened by audited live-bytes margin "
                     f"{margin / 2**20:.1f} MiB (JXA005 plan_delta feedback)")
    class_swap: Dict[str, int] = {}
    residency = {"params": "device", "kvcache": "device"}

    params_dev = 2 * cfg.param_count() // tp
    act_shape = dataclasses.replace(shape, seq_len=1)
    acts = activation_classes(cfg, act_shape, mesh)
    transient = max((a.bytes_dev for a in acts), default=0) * 3
    shape1 = dataclasses.replace(shape, global_batch=dp)
    per_slot = kv_cache_bytes_dev(cfg, shape1, mesh, rules=rules)

    params_eff = params_dev
    host = 0
    if lms.enabled and lms.offload_params != "never" and \
            params_dev + slots * per_slot + transient > budget:
        params_eff = 2 * params_dev // max(L, 1)
        host += params_dev
        class_swap["params"] = params_dev          # one sweep per decode step
        residency["params"] = "host"
        notes.append("params host-resident, streamed per layer")

    paging = None
    demand = (slots + backlog) * per_slot          # trace working set
    if lms.enabled and params_eff + demand + transient > budget:
        paging = price_kv_paging(cfg, shape, mesh,
                                 budget=budget - params_eff - transient,
                                 page_size=page_size, slots=slots,
                                 backlog_slots=backlog, rules=rules,
                                 kv_dtype=kv_dtype)
        residency["kvcache"] = "host"
        # one request's lifecycle: prefill pages spill out, then return
        class_swap["kvcache"] = 2 * paging.pages_per_slot * paging.page_bytes
        host += paging.host_pages * paging.page_bytes + \
            backlog * paging.state_bytes
        # +1: the arena's null page; the table is int32 per slot-page entry
        kv_dev = (paging.device_pages + 1) * paging.page_bytes + \
            slots * paging.state_bytes + \
            slots * paging.pages_per_slot * 4
        notes.append(
            f"KV backlog host-resident via paged pool: {paging.device_pages} "
            f"device pages ({paging.slot_budget} concurrent slots), "
            f"{paging.host_pages} host pages")
    else:
        kv_dev = demand if not lms.enabled else slots * per_slot
        if lms.enabled:
            notes.append("aggregate KV fits: pool not required")

    peak = params_eff + kv_dev + transient
    swap_per_step = sum(class_swap.values())
    staging_depth = 2
    if cal and paging is not None and residency.get("kvcache") == "host":
        # calibrated pool staging: how many released-slot page returns the
        # engine keeps in flight, sized from the MEASURED kvcache bandwidth
        # against the mean decode tick instead of the fixed double-buffer
        slot_bytes = (paging.pages_per_slot * paging.page_bytes
                      + paging.state_bytes)
        staging_depth = cost.tune_staging_depth(slot_bytes)
        if staging_depth != 2:
            notes.append(
                f"pool staging depth tuned 2 -> {staging_depth} "
                f"(kvcache at {cost.bw('kvcache') / 1e9:.2f} GB/s measured "
                f"vs mean decode tick)")
    schedule = make_swap_schedule(residency, L, "decode",
                                  prefetch_depth=staging_depth,
                                  swap_bytes=class_swap)
    check_schedule_invariant(residency, schedule, serve=True,
                             kv_paging=paging)
    peak = int(peak) + margin
    return MemoryPlan({}, residency, int(peak), int(host), int(swap_per_step),
                      budget_full, peak <= budget_full, notes,
                      swap_schedule=schedule, kv_paging=paging,
                      calibrated=cal)


def plan_memory(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                lms: LMSConfig = LMSConfig(), hw: hwlib.HardwareSpec = hwlib.DEFAULT,
                optimizer: str = "adamw", zero1: bool = False,
                rules=None, microbatches: int = 1) -> MemoryPlan:
    """Deprecated wrapper: build a `PlanRequest` and call `plan`. Kept so
    existing callers/tests keep passing; new code uses the facade."""
    return plan(PlanRequest(cfg=cfg, shape=shape, mesh=mesh, lms=lms, hw=hw,
                            optimizer=optimizer, zero1=zero1, rules=rules,
                            microbatches=microbatches))


def _plan_memory(req: PlanRequest, cost: Optional[CostModel]) -> MemoryPlan:
    cfg, shape, mesh, lms, hw = req.cfg, req.shape, req.mesh, req.lms, req.hw
    optimizer, zero1, rules = req.optimizer, req.zero1, req.rules
    microbatches = req.microbatches
    budget_full = (lms.hbm_budget or hw.hbm_bytes)
    budget_full = int(budget_full * (1.0 - lms.workspace_frac))
    cal = cost is not None and cost.calibrated
    # audited live-bytes feedback (JXA005): tighten the working budget by
    # the margin the jaxpr auditor measured past this kind's plan pricing,
    # and charge it back into the reported peak — a calibrated plan's
    # plan_delta_bytes can only shrink vs the uncalibrated one
    margin = cost.live_margin(shape.kind) if cal else 0
    budget = budget_full - margin
    tp = _axis_size(mesh, "model")
    dp = _axis_size(mesh, "data")
    notes: List[str] = []
    if cal:
        notes.append(cost.describe())
    if margin:
        notes.append(f"budget tightened by audited live-bytes margin "
                     f"{margin / 2**20:.1f} MiB (JXA005 plan_delta feedback)")

    n_params = cfg.param_count()
    params_dev = 2 * n_params // tp                       # bf16, TP-sharded
    # fp32 m+v+master (adamw) / momentum (sgdm); raises on unknown names
    opt_mult = OPT_STATE_MULT[validate_optimizer(optimizer)]
    opt_dev = opt_mult * n_params // tp // (dp if zero1 else 1)
    grads_dev = 2 * n_params // tp
    residency = {"params": "device", "grads": "device",
                 "optimizer": "device", "kvcache": "device"}

    L = cfg.num_layers
    lflops = layer_flops_dev(cfg, shape, mesh)
    layer_time = lflops / hw.peak_flops_bf16
    swap_per_step = 0
    class_swap: Dict[str, int] = {}   # per-class priced bytes for the schedule

    if shape.kind in ("prefill", "decode"):
        # inference: no grads/optimizer; activations are transient.
        # decode processes ONE token — size its activations at seq=1
        act_shape = (dataclasses.replace(shape, seq_len=1)
                     if shape.kind == "decode" else shape)
        kv = kv_cache_bytes_dev(cfg, shape, mesh, rules=rules)
        acts = activation_classes(cfg, act_shape, mesh)
        transient = max((a.bytes_dev for a in acts), default=0) * 3
        peak = params_dev + kv + transient
        host = 0
        if not lms.enabled:
            peak += margin
            return MemoryPlan({}, residency, peak, 0, 0, budget_full,
                              peak <= budget_full, notes + ["LMS disabled"],
                              calibrated=cal)
        if peak > budget and lms.offload_params != "never":
            # stream params per layer: keep 2 layers resident
            resident = 2 * params_dev // max(L, 1)
            host += params_dev
            class_swap["params"] = params_dev  # one full sweep per token/prefill
            swap_per_step += class_swap["params"]
            peak = resident + kv + transient
            residency["params"] = "host"
            notes.append("params host-resident, streamed per layer")
        if peak > budget:
            # offload KV cache, keep the working window
            host += kv
            class_swap["kvcache"] = 2 * kv // max(L, 1)
            swap_per_step += class_swap["kvcache"]
            peak = peak - kv + kv // max(L, 1)
            residency["kvcache"] = "host"
            notes.append("KV cache host-resident, streamed per layer")
        schedule = make_swap_schedule(residency, L, shape.kind,
                                      swap_bytes=class_swap)
        check_schedule_invariant(residency, schedule)
        peak = int(peak) + margin
        return MemoryPlan({}, residency, int(peak), int(host),
                          int(swap_per_step), budget_full,
                          peak <= budget_full, notes,
                          swap_schedule=schedule, calibrated=cal)

    # ---- training -----------------------------------------------------------
    acts = activation_classes(cfg, shape, mesh)
    assignment = {a.name: "save" for a in acts}
    # resid is the scan carry: always materialized per layer
    saved_bytes = lambda: L * sum(a.bytes_dev for a in acts
                                  if assignment[a.name] == "save")
    offload_bytes = lambda: L * sum(a.bytes_dev for a in acts
                                    if assignment[a.name] == "offload")
    transient = max((a.bytes_dev for a in acts), default=0) * 4

    def fixed():
        return params_dev + grads_dev + opt_dev + transient

    # price the reduction-overlap decision FIRST: whether the backward runs
    # the per-layer in-scan reduction decides whether a per-layer gradient
    # host sink can exist at all, which gates the grads residency below
    overlap_grads: Optional[bool] = None
    if dp * _axis_size(mesh, "pod") > 1:
        t_ser, t_ovl = price_grad_reduction(cfg, shape, mesh, hw,
                                            microbatches=microbatches)
        overlap_grads = t_ovl <= t_ser
        notes.append(f"grad reduction priced: overlapped {t_ovl*1e3:.2f}ms vs "
                     f"serialized {t_ser*1e3:.2f}ms "
                     f"(microbatches={max(microbatches, 1)}) -> "
                     f"{'overlap' if overlap_grads else 'serialize'}")

    host = 0
    if lms.enabled:
        # 1) optimizer to host if params+opt alone crowd the budget
        if lms.offload_optimizer != "never" and \
                fixed() + saved_bytes() > budget and opt_dev > budget // 4:
            opt_host = opt_dev
            host += opt_host
            # the streamed optimizer sweep swaps the FULL state (mu+nu+master
            # for adamw, momentum for sgdm) in AND back out once per step;
            # zero1's flat shard moves wholesale (placement-only) at the same
            # per-device volume, already divided by |data|
            class_swap["optimizer"] = 2 * opt_host
            swap_per_step += class_swap["optimizer"]
            if zero1:
                # flat 1/|data| shard, transferred whole around its update
                opt_dev = 0
                notes.append("optimizer shard host-resident (zero1: flat "
                             "1/|data| state, placement-only transfer)")
            else:
                # resident during the sweep: 2 double-buffered layer slices
                # PLUS the unscanned remainder (embeddings, lm head, norms,
                # encoder), whose large leaves update in OPT_REST_CHUNKS
                # streamed flat chunks (2 in flight). Priced with the SAME
                # gcd/cutoff rule the executor's _rest_chunks applies —
                # norms one-shot (their leaves are tiny and below the 1M
                # cutoff), big components at 2 chunks — so a leaf the
                # executor cannot chunk is charged at its full state
                rest_dev = 0
                for name, n in cfg.param_breakdown():
                    if name not in ("embed", "lm_head", "norms", "encoder"):
                        continue
                    c = (math.gcd(n, OPT_REST_CHUNKS)
                         if name != "norms" and n >= (1 << 20) else 1)
                    rest_dev += opt_mult * ((2 * n // c) if c > 1 else n) // tp
                opt_dev = 2 * opt_host // max(L, 1) + rest_dev
                notes.append("optimizer state host-resident, streamed per "
                             "layer (ZeRO-Offload style sweep)")
            residency["optimizer"] = "host"
        # 2) params to host (streamed per layer) when params alone ~exceed budget
        if lms.offload_params != "never" and params_dev + grads_dev > budget // 2:
            resident = 4 * params_dev // max(L, 1)   # 2 layers fwd + bwd prefetch
            host += params_dev
            class_swap["params"] = 2 * params_dev    # fwd sweep + bwd sweep
            swap_per_step += class_swap["params"]
            params_dev_eff = resident
            residency["params"] = "host"
            notes.append("params host-resident, streamed per layer (LMS swap)")
            if zero1:
                # zero1 never materialises the grad tree past the backward:
                # the in-scan hooks keep reduce-scattered f32 shards
                # (1/|data|) plus ~2 layers of transient cotangents — no
                # host residency, no swap traffic to price
                grads_dev_eff = (2 * grads_dev // max(L, 1)
                                 + 4 * n_params // tp // max(dp, 1))
                notes.append("zero1 grads kept as in-step reduce-scattered "
                             "shards (no host sink)")
            elif max(microbatches, 1) == 1 and bool(overlap_grads) \
                    and residency.get("optimizer") == "host":
                # the per-layer host sink only exists when the overlapped
                # backward emits one reduced cotangent per layer (single
                # batch, keep="full") AND the streamed optimizer sweep is
                # there to consume it layer by layer — promising it in any
                # other configuration would be the fits=True fiction the
                # schedule invariant exists to prevent
                grads_host = grads_dev
                host += grads_host
                # bwd-sweep stream-out + the optimizer sweep's read-back
                class_swap["grads"] = 2 * grads_dev
                swap_per_step += class_swap["grads"]
                grads_dev_eff = 2 * grads_dev // max(L, 1)
                residency["grads"] = "host"
            else:
                # no executable sink: grads stay device at their honest
                # footprint — the f32 microbatch accumulator / all-gathered
                # mean tree for accumulation, the bf16 tree otherwise
                grads_dev_eff = (2 * grads_dev if max(microbatches, 1) > 1
                                 else grads_dev)
                notes.append("grads stay device (per-layer host sink needs "
                             "overlapped backward, microbatches=1, and the "
                             "streamed optimizer sweep)")
        else:
            params_dev_eff, grads_dev_eff = params_dev, grads_dev

        def peak_now():
            return params_dev_eff + grads_dev_eff + opt_dev + transient + saved_bytes()

        # 3) activations: greedy by bytes desc — offload if overlappable else
        # remat. `resid` (the layer-input residual / scan carry) goes LAST:
        # it cannot be rematerialized (rebuilding it means re-running every
        # earlier layer), so its only escape is the swap — the paper's
        # "first-layer tensors are the largest and longest-lived" case.
        if lms.offload_activations != "never":
            others = [a for a in acts if a.name != "resid"]
            for a in sorted(others, key=lambda a: -a.bytes_dev):
                if peak_now() <= budget:
                    break
                if cal:
                    # joint remat-vs-swap at MEASURED cost (Planner v2):
                    # the un-hidden swap remainder plus the dispatch tax
                    # (exactly the fig2b evaluator's expression) against
                    # the recompute time — take the cheaper escape instead
                    # of the v1 "offload iff fully overlappable" threshold
                    off_s = cost.exposed_swap_s(2 * a.bytes_dev,
                                                "activations", layer_time)
                    remat_s = (a.recompute_flops / hw.peak_flops_bf16
                               if lms.remat else float("inf"))
                    if off_s <= remat_s:
                        assignment[a.name] = "offload"
                        host += L * a.bytes_dev
                        swap_per_step += 2 * L * a.bytes_dev
                    else:
                        assignment[a.name] = "remat"
                    continue
                swap_time = 2 * a.bytes_dev / hw.host_bw
                if swap_time <= layer_time:
                    assignment[a.name] = "offload"
                    host += L * a.bytes_dev
                    swap_per_step += 2 * L * a.bytes_dev
                elif lms.remat:
                    assignment[a.name] = "remat"
            # still over: remat everything rematerializable
            if peak_now() > budget and lms.remat:
                for a in others:
                    if assignment[a.name] == "save":
                        assignment[a.name] = "remat"
            # last resort: swap the residual stream itself (LMS headline move)
            if peak_now() > budget:
                resid = next((a for a in acts if a.name == "resid"), None)
                if resid is not None:
                    assignment["resid"] = "offload"
                    host += L * resid.bytes_dev
                    swap_per_step += 2 * L * resid.bytes_dev
        peak = peak_now()
    else:
        peak = fixed() + saved_bytes()
        params_dev_eff = params_dev

    # ---- calibrated knob tuning (Planner v2) --------------------------------
    prefetch_depth = 2
    tuned_bucket_mb = None
    if cal and lms.enabled:
        streamed = [c for c in STREAM_CLASSES
                    if residency.get(c) == "host"
                    and not (zero1 and c == "optimizer")]
        if streamed:
            # depth so the slowest measured stream keeps up with compute;
            # the extra resident layer slices it costs are re-fit against
            # the budget (back off to smaller divisors of L if they spill)
            per_layer = {c: class_swap.get(c, 0) / max(2 * L, 1)
                         for c in streamed}
            worst = max(streamed, key=lambda c: per_layer[c] / cost.bw(c))
            want = cost.tune_prefetch_depth(L, per_layer[worst], layer_time,
                                            cls_name=worst)
            inc = {"params": 2 * params_dev // max(L, 1),
                   "optimizer": opt_mult * n_params // tp // max(L, 1),
                   "grads": grads_dev // max(L, 1),
                   "kvcache": 0}
            extra = sum(inc.get(c, 0) for c in streamed)
            for d in sorted((c for c in range(2, min(8, L) + 1)
                             if L % c == 0 and c <= want), reverse=True):
                if peak + (d - 2) * extra <= budget:
                    prefetch_depth = d
                    break
            if prefetch_depth != 2:
                peak += (prefetch_depth - 2) * extra
                notes.append(
                    f"prefetch depth tuned 2 -> {prefetch_depth} ({worst} "
                    f"stream at {cost.bw(worst) / 1e9:.2f} GB/s measured vs "
                    f"{layer_time * 1e3:.2f} ms/layer; "
                    f"+{(prefetch_depth - 2) * extra / 2**20:.0f} MiB "
                    f"resident)")
        if dp * _axis_size(mesh, "pod") > 1 and bool(overlap_grads):
            tuned_bucket_mb = cost.tune_bucket_mb(2.0 * layer_time)
            notes.append(f"DDL bucket tuned to {tuned_bucket_mb} MiB (one "
                         f"bucket's fabric time hides behind one backward "
                         f"layer at {layer_time * 1e3:.2f} ms/layer)")

    # zero1 executes optimizer-host residency as a flat P("data")-sharded
    # placement (the 1/|data| shard moves wholesale around its update) —
    # placement-only by design, see DESIGN.md §6. Everything else
    # host-resident must stream.
    placement_only = (("optimizer",)
                      if zero1 and residency.get("optimizer") == "host"
                      else ())
    schedule = make_swap_schedule(residency, L, shape.kind,
                                  prefetch_depth=prefetch_depth,
                                  overlap_grads=bool(overlap_grads),
                                  swap_bytes=class_swap,
                                  placement_only=placement_only)
    check_schedule_invariant(residency, schedule, placement_only)
    peak = int(peak) + margin
    return MemoryPlan(assignment, residency, int(peak), int(host),
                      int(swap_per_step), budget_full,
                      peak <= budget_full, notes,
                      swap_schedule=schedule,
                      overlap_grads=overlap_grads,
                      placement_only=placement_only,
                      calibrated=cal, tuned_bucket_mb=tuned_bucket_mb)


def hbm_traffic_model(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
                      plan: MemoryPlan, optimizer: str = "adamw",
                      rules=None) -> int:
    """Analytic per-device HBM bytes per step assuming TPU-grade fusion —
    the optimistic counterpart of the unfused-HLO `bytes accessed` number
    (XLA:CPU counts every elementwise op's operands; a fused TPU kernel
    streams each tensor once). Used as the fused-estimate memory term."""
    tp = _axis_size(mesh, "model")
    n = cfg.param_count()
    params_dev = 2 * n // tp
    if shape.kind == "train":
        acts = activation_classes(cfg, shape, mesh)
        L = cfg.num_layers
        saved = L * sum(a.bytes_dev for a in acts
                        if plan.assignment.get(a.name, "save") == "save")
        # params read (fwd+bwd+remat) + grads f32 rw + opt state rw + acts rw
        opt_mult = OPT_TRAFFIC_MULT[validate_optimizer(optimizer)]
        dp = _axis_size(mesh, "data") * _axis_size(mesh, "pod")
        b = max(shape.global_batch // dp, 1)
        logits = b * shape.seq_len * cfg.vocab_size // tp * 6
        return int(3 * params_dev + 8 * n // tp + opt_mult * n // tp
                   + 2 * saved + logits)
    kv = kv_cache_bytes_dev(cfg, shape, mesh, rules=rules)
    if shape.kind == "prefill":
        acts = activation_classes(cfg, shape, mesh)
        stream = cfg.num_layers * sum(a.bytes_dev for a in acts) * 2
        return int(params_dev + kv + stream)
    # decode: read every live parameter + the whole KV cache once
    active_dev = 2 * cfg.active_param_count() // tp
    return int(active_dev + kv)


def plan_to_policy(plan: MemoryPlan):
    """MemoryPlan -> the activation policy of the decoder layers
    (`policies.build_policy`), None when the plan assigns nothing."""
    from repro_torch.core.lms.policies import build_policy
    if not plan.assignment:
        return None
    return build_policy(plan.assignment)
