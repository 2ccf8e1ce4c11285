"""Continuous-batching serve engine.

One fixed-shape slot-batched decode step serves every tick: finished
requests leave and queued ones join by editing the page table (through the
paged pool) and the positions/active vectors. Prompts run through chunked
prefill on pure-attention stacks (whole-prompt prefill otherwise, a
Mamba-2 stack's among them); the pool spills prefilled-but-waiting
requests to pinned host memory and brings their pages and state back
(prefetched ahead of the decode tick) before they rejoin.

Failure is a handled state, never an exception out of `run()`: every
request ends in a terminal status (`ok` / `rejected` / `timeout` /
`cancelled` / `failed`). Unservable and load-shed requests are rejected at
submit, per-request deadlines are enforced at every scheduling boundary,
deadline-aware admission sheds requests whose budget the rolling TTFT/TPOT
percentiles say is unmeetable, a stall watchdog fails stuck requests, and
a deadline-risk request at the head of the queue may preempt the youngest
active slot: its pages spill back to the host arena through the pool and
it re-queues with its tokens, resuming bitwise when it is admitted again.
A `FaultInjector` (`runtime/inject.py`) drives tick faults, forced
preemptions and transient pool exhaustion at deterministic points.

Under a serve plan (`plan(PlanRequest(serve=True, ...))`) the plan's
`kv_paging` sets the page geometry, a calibrated plan's prefetch depth the
number of spilled requests staged ahead, and when the plan puts params on
the host they lie in pinned host memory (`train.steps.init_params`) and
every prefill and decode tick streams them in a layer at a time.

Token selection is host-side numpy: greedy argmax, or temperature/top-k
sampling with a per-request rng seeded by (engine seed, rid).

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`); without CUDA, the default raises.

On a tensor-parallel mesh (`mesh=`, a `model` axis above 1: one process a
mesh device) every rank runs this same engine on the same requests: the
params, the pool's arenas and the decode step are the rank's blocks, and
the logits come back whole and bitwise the same on every rank
(`sharding.gather_from_model`), so every rank selects the same tokens
(the per-request generators are seeded alike). Every other input of a
decision is made the same on every rank too: the page decisions read
only lengths, the fault injector counts the same calls, and the clock the
decisions read (the arrival stamp, the deadlines and shedding, the stall
watchdog) is rank 0's, sent to every rank over the mesh once a round
(`_clock`). The latency stamps are taken locally and replaced by rank 0's
once a run, before they reach the TTFT/TPOT windows (`_share_stamps`). A
`data` or `pod` axis above 1 raises (`check_serve_mesh`).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.base import ShapeConfig
from repro_torch.models import sharding as shd
from repro_torch.models.model import Model
from repro_torch.models.paging import PageArena
from repro_torch.obs import Obs
from repro_torch.runtime.inject import FaultInjector, InjectedFault
from repro_torch.serve.batching import host_batch, request_prefill_batch, request_prompt_len
from repro_torch.serve.kvpool import PagedKVPool
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.train.steps import (StepSpec, _serving_stream, build_slot_decode_step,
                                     init_params)


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to the card. Never falls back to the CPU: a CUDA
    device on a machine without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def check_serve_mesh(mesh) -> None:
    """Serving runs on a mesh whose `pod` and `data` axes are 1: one
    process a device over `model` (the JAX package also shards the slot
    batch over `data` against a replicated arena, which is not ported)."""
    if mesh is None:
        return
    sizes = shd.axis_sizes(mesh)
    if sizes.get("pod", 1) > 1 or sizes.get("data", 1) > 1:
        raise NotImplementedError(
            f"not ported yet: serving on a data or pod axis (mesh {sizes}); a mesh "
            "of 1xM or 1x1xM serves over `model`")


class ServeEngine:
    def __init__(self, model: Model, *, slots: int, max_len: int,
                 plan=None, page_size: int = 16,
                 device_pages: Optional[int] = None,
                 host_pages: Optional[int] = None, prefill_chunk: int = 0,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_id: Optional[int] = None, params=None,
                 kv_dtype: Optional[str] = None, max_queue: int = 0,
                 stall_rounds: int = 64, watchdog_s: Optional[float] = None,
                 preemption: bool = True,
                 injector: Optional[FaultInjector] = None,
                 obs: Optional[Obs] = None, device=None, mesh=None):
        cfg = model.cfg
        check_serve_mesh(mesh)
        self.device = resolve_device(device)
        self.mesh = shd.tp(mesh)
        self.model, self.cfg = model, cfg
        self.slots, self.max_len = slots, max_len
        self.temperature, self.top_k = temperature, top_k
        self.seed, self.eos_id = seed, eos_id
        # private metrics registry over the process-global span ring
        self.obs = obs if obs is not None else Obs()
        self.stall_rounds = stall_rounds
        self.watchdog_s = watchdog_s
        self.preemption = preemption
        self._inj = injector

        # kv_dtype: the argument > the plan's paged-pool width > model width
        spec = StepSpec(plan=plan, kv_dtype=kv_dtype)
        self.kv_dtype = spec.resolved_kv_dtype()
        paging = plan.kv_paging if plan is not None else None
        if paging is not None:
            page_size = paging.page_size
            device_pages = paging.device_pages if device_pages is None else device_pages
            host_pages = paging.host_pages if host_pages is None else host_pages
        # the page grid must tile the cache exactly: snap a non-dividing
        # request down to the largest page size that does
        page_size = math.gcd(max_len, page_size)
        max_pages = max(-(-max_len // page_size), 1)
        full = slots * max_pages
        device_pages = full if device_pages is None else device_pages
        host_pages = 2 * full if host_pages is None else host_pages
        # the spilled requests the host arena holds: the plan's priced
        # backlog when it has one
        host_slots = paging.host_slots if paging is not None and paging.host_slots else 2 * slots
        arena = PageArena(page_size=page_size, device_pages=device_pages,
                          slots=slots, max_pages=max_pages)

        shape = ShapeConfig("serve_slots", "decode", max_len, slots)
        self._decode_fn, cache_defs = build_slot_decode_step(
            model, shape, StepSpec(plan=plan, kv_dtype=self.kv_dtype, arena=arena),
            mesh=self.mesh)
        # spilled requests staged ahead of their attach: a calibrated plan
        # that streams the KV class tuned the depth; else one
        sched = plan.swap_schedule if plan is not None else None
        self._stage_depth = (max(1, sched.prefetch_depth)
                             if plan is not None and plan.calibrated and sched is not None
                             and "kvcache" in sched.stream else 1)
        self._stream = _serving_stream(plan)
        self.pool = PagedKVPool(model, slots=slots, max_len=max_len,
                                page_size=page_size,
                                device_pages=device_pages,
                                host_pages=host_pages, host_slots=host_slots,
                                device=self.device, cache_defs=cache_defs,
                                kv_dtype=self.kv_dtype, injector=injector, obs=self.obs,
                                mesh=self.mesh)
        self.params = (init_params(model, seed, self.device, plan, self.mesh)
                       if params is None else params)

        # chunked prefill needs absolute-position cache writes: pure
        # attention stacks only. A chunk is never wider than the cache.
        self._chunk = (min(prefill_chunk, max_len)
                       if prefill_chunk > 0
                       and all(k == "attn" for k in cfg.layer_kinds())
                       else 0)
        if self._chunk:
            self._scratch = model.init_cache(1, max_len, self.device, self.mesh)

        self.scheduler = Scheduler(slots, max_queue=max_queue,
                                   registry=self.obs.registry)
        self._rngs: Dict[int, np.random.Generator] = {}
        self._last_run: List[Request] = []
        reg = self.obs.registry
        self._c_ticks = reg.counter("engine.ticks")
        self._c_decode_tokens = reg.counter("engine.decode_tokens")
        self._c_decode_s = reg.counter("engine.decode_s")
        self._g_wall = reg.gauge("engine.wall_s")

    def _share(self, values: np.ndarray) -> np.ndarray:
        """f64 `values` as rank 0 holds them, on every rank of a tensor-
        parallel mesh (a sum over `model` to which the other ranks add
        zeros: exact); unchanged on one device."""
        if self.mesh is None:
            return values
        mine = values if self.mesh.index(shd.MODEL) == 0 else np.zeros_like(values)
        t = torch.from_numpy(np.ascontiguousarray(mine, np.float64)).to(self.device)
        return self.mesh.psum(t, shd.MODEL).cpu().numpy()

    def _clock(self) -> float:
        """The clock the scheduling decisions read (`time.monotonic`); on a
        mesh rank 0's reading, so the decisions are the same on every rank.
        `run` reads it once a round, at the same point on every rank."""
        return float(self._share(np.array([time.monotonic()]))[0])

    def _share_stamps(self, reqs: Sequence[Request]) -> None:
        """On a mesh, every rank takes rank 0's latency stamps of `reqs` (one
        sum for the run), so the TTFT/TPOT windows, and the shedding and
        preemption they feed, are the same on every rank."""
        if self.mesh is None or not reqs:
            return
        keys = ("ttft_s", "first_tok_mono", "done_mono")
        stamps = np.array([[np.nan if getattr(r, k) is None else getattr(r, k)
                            for k in keys] for r in reqs], np.float64)
        for r, row in zip(reqs, self._share(stamps)):
            for k, v in zip(keys, row):
                setattr(r, k, None if np.isnan(v) else float(v))

    # ---- token selection --------------------------------------------------
    def _select(self, req: Request, row: np.ndarray) -> int:
        t = self.temperature if req.temperature is None else req.temperature
        k = self.top_k if req.top_k is None else req.top_k
        if t <= 0:
            return int(np.argmax(row))
        logp = row.astype(np.float64) / t
        if k and k < logp.size:
            idx = np.argpartition(logp, -k)[-k:]
        else:
            idx = np.arange(logp.size)
        p = np.exp(logp[idx] - logp[idx].max())
        rng = self._rngs.setdefault(
            req.rid, np.random.default_rng((self.seed, req.rid)))
        return int(rng.choice(idx, p=p / p.sum()))

    @staticmethod
    def _row(logits) -> np.ndarray:
        """A logits row on the host, bf16 -> f32 (exact) first."""
        return logits.float().cpu().numpy()

    # ---- prefill ----------------------------------------------------------
    def _prefill(self, req: Request):
        """-> (B=1 cache holding the prompt's keys or state, last-prompt-
        token logits row). Chunked on attention stacks, whole-prompt
        otherwise."""
        plen = request_prompt_len(self.cfg, req)
        with self.obs.span("engine.prefill", rid=req.rid, tokens=plen,
                           chunked=bool(self._chunk)):
            if self._chunk:
                c = self._chunk
                row = None
                for lo in range(0, plen, c):
                    hi = min(lo + c, plen)
                    batch = request_prefill_batch(self.cfg, req, self.device,
                                                  lo, hi, pad_to=c)
                    logits, self._scratch = self.model.prefill_chunk(
                        self.params, self._scratch, batch, lo, hi, stream=self._stream,
                        mesh=self.mesh)
                    if hi == plen:
                        row = self._row(logits[0, plen - 1 - lo])
                return self._scratch, row
            batch = request_prefill_batch(self.cfg, req, self.device)
            logits, cache = self.model.prefill(self.params, batch,
                                               cache_len=self.max_len, stream=self._stream,
                                               mesh=self.mesh)
            return cache, self._row(logits[0])

    def _first_token(self, req: Request, row: np.ndarray, t0: float) -> None:
        req.tokens.append(self._select(req, row))
        req.prefilled = True
        now = time.monotonic()
        # TTFT from the request's own arrival when the trace carries one
        req.ttft_s = now - (t0 if req.arrival is None else req.arrival)
        req.first_tok_mono = now

    def _done(self, req: Request) -> bool:
        return (len(req.tokens) >= req.max_new
                or (self.eos_id is not None and req.tokens
                    and req.tokens[-1] == self.eos_id))

    # ---- lifecycle --------------------------------------------------------
    def _retire(self, req: Request, status: str, error=None) -> None:
        """Terminal transition: free whatever the pool holds for the request
        and record the outcome."""
        self.pool.drop(req.rid)
        if req.done_mono is None:
            req.done_mono = time.monotonic()
        self.scheduler.retire(req, status, error)

    def submit(self, req: Request, t0: Optional[float] = None) -> bool:
        """Admission control: unservable requests and load-shed submissions
        are rejected (a terminal status, not an exception)."""
        if req.arrival is None:
            req.arrival = self._clock() if t0 is None else t0
        total = request_prompt_len(self.cfg, req) + req.max_new
        if total > self.max_len:
            self._retire(req, "rejected",
                         f"unservable: prompt+max_new={total} exceeds "
                         f"max_len={self.max_len}")
            return False
        need = self.pool.pages_needed(total)
        if need > self.pool.device_pages:
            self._retire(req, "rejected",
                         f"unservable: needs {need} pages, device budget is "
                         f"{self.pool.device_pages}")
            return False
        if not self.scheduler.submit(req):
            self._retire(req, "rejected",
                         f"load shed: queue at max_queue="
                         f"{self.scheduler.max_queue}")
            return False
        return True

    def cancel(self, rid: int) -> bool:
        """Request cancellation; the request retires as "cancelled" at the
        next scheduling boundary."""
        for r in list(self.scheduler.queue) + list(
                self.scheduler.active.values()):
            if r.rid == rid:
                r.cancel()
                return True
        return False

    def _deadline(self, req: Request) -> Optional[float]:
        if req.deadline_s is None or req.arrival is None:
            return None
        return req.arrival + req.deadline_s

    def _est_remaining(self, req: Request) -> Optional[float]:
        """Pessimistic remaining service time from the rolling latency
        windows (p95 TTFT if not prefilled + p95 TPOT per remaining token);
        None until the windows have samples."""
        tpot = self.scheduler.tpot_p95()
        if tpot is None:
            return None
        rem = tpot * max(req.max_new - len(req.tokens), 0)
        if not req.prefilled:
            ttft = self.scheduler.ttft_p95()
            rem += ttft if ttft is not None else 0.0
        return rem

    def _sweep(self, now: float) -> None:
        """Cancellations and blown deadlines, in the queue and the slots."""
        sched = self.scheduler
        for r in list(sched.queue):
            dl = self._deadline(r)
            if r.cancel_requested:
                sched.queue.remove(r)
                self._retire(r, "cancelled", "cancel requested")
            elif dl is not None and now > dl:
                sched.queue.remove(r)
                self._retire(r, "timeout",
                             f"deadline_s={r.deadline_s} blown in queue")
        for slot, r in list(sched.active.items()):
            dl = self._deadline(r)
            if r.cancel_requested:
                sched.evict(slot)
                self._retire(r, "cancelled", "cancel requested")
            elif dl is not None and now > dl:
                sched.evict(slot)
                self._retire(r, "timeout",
                             f"deadline_s={r.deadline_s} blown mid-decode "
                             f"after {len(r.tokens)} tokens")

    def _shed_doomed(self, now: float) -> None:
        """Deadline-aware admission: a queued request whose budget cannot be
        met is rejected now instead of burning pages."""
        for r in list(self.scheduler.queue):
            dl = self._deadline(r)
            if dl is None:
                continue
            est = self._est_remaining(r)
            if est is not None and now + est > dl:
                self.scheduler.queue.remove(r)
                self._retire(r, "rejected",
                             f"deadline unmeetable: est {est:.3f}s remaining "
                             f"vs {dl - now:.3f}s budget left")

    # ---- preemption -------------------------------------------------------
    def _pick_victim(self, beneficiary: Optional[Request]) -> Optional[int]:
        """Youngest active slot (latest activation) whose deadline is no
        tighter than the beneficiary's and that has not been preempted
        before (which bounds preemption ping-pong)."""
        best_slot, best_seq = None, -1
        bdl = self._deadline(beneficiary) if beneficiary is not None else None
        for slot, r in self.scheduler.active.items():
            if r.preemptions >= 1:
                continue
            vdl = self._deadline(r)
            if bdl is not None and vdl is not None and vdl < bdl:
                continue
            if r.joined_seq > best_seq:
                best_slot, best_seq = slot, r.joined_seq
        return best_slot

    def _preempt_slot(self, slot: int) -> bool:
        """Spill-and-requeue: the victim's pages so far go back to the host
        arena (exact content, through the pool), its reservation frees,
        and it re-queues just behind the queue head with its tokens, so
        resuming later is bitwise as if it had never been preempted."""
        r = self.scheduler.active[slot]
        cur_len = request_prompt_len(self.cfg, r) + len(r.tokens) - 1
        if not self.pool.preempt(r.rid, cur_len):
            return False               # host arena full: the victim decodes on
        self.scheduler.evict(slot)
        self.scheduler.requeue(r, behind=1)
        self.obs.instant("engine.preempt", rid=r.rid, slot=slot, tokens=len(r.tokens))
        return True

    def _maybe_preempt(self, now: float) -> None:
        """A deadline-risk request at the head of the queue may reclaim a
        slot and its device pages from the youngest active slot."""
        if not self.preemption or not self.scheduler.queue:
            return
        head = self.scheduler.queue[0]
        dl = self._deadline(head)
        if dl is None:
            return
        need = self._reserve_need(head)
        staged = self.pool.status(head.rid) == "staged"
        if self.scheduler.free_slot() is not None and (staged or self.pool._has_dev(need)):
            return                     # admits this round anyway
        est = self._est_remaining(head)
        if est is None or now + est <= dl:
            return                     # no evidence of deadline risk yet
        victim = self._pick_victim(head)
        if victim is not None:
            self._preempt_slot(victim)

    # ---- scheduling -------------------------------------------------------
    def _reserve_need(self, req: Request) -> int:
        total = request_prompt_len(self.cfg, req) + req.max_new
        return self.pool.pages_needed(total)

    def _admit(self, t0: float) -> bool:
        """FIFO slot joins under the device page budget, then prefill-ahead
        spills into the host arena. -> True if anything progressed."""
        pool, sched = self.pool, self.scheduler
        progressed = False
        while sched.queue:
            head = sched.queue[0]
            need = self._reserve_need(head)
            slot = sched.free_slot()
            staged = pool.status(head.rid) == "staged"
            if slot is None or not (staged or pool.can_reserve(need)):
                break
            sched.queue.popleft()
            if head.prefilled:
                pool.attach(head.rid, slot)          # return from the spill
            else:
                cache1, row = self._prefill(head)
                self._first_token(head, row, t0)
                if self._done(head):
                    # finished on the prefill token: no slot or pages needed
                    head.done_mono = time.monotonic()
                    sched.retire(head, "ok")
                    progressed = True
                    continue
                pool.attach_fresh(head.rid, slot, cache1,
                                  request_prompt_len(self.cfg, head), need)
            sched.activate(head, slot)
            progressed = True
        # prefill-ahead: process waiting prompts into the host arena so
        # their pages are ready the moment a slot frees
        for req in list(sched.queue):
            if req.prefilled:
                continue
            plen = request_prompt_len(self.cfg, req)
            if not pool.can_spill(pool.pages_needed(plen)):
                break
            cache1, row = self._prefill(req)
            self._first_token(req, row, t0)
            if self._done(req):
                req.done_mono = time.monotonic()
                sched.queue.remove(req)
                sched.retire(req, "ok")
                progressed = True
                continue
            pool.spill(req.rid, cache1, plen, self._reserve_need(req))
            progressed = True
        return progressed

    def _prefetch_next(self) -> None:
        """Stage the next waiting requests' spilled pages back toward the
        device ahead of their attach: up to `_stage_depth` requests (1
        unless a calibrated plan tuned it); stops when the device budget
        refuses a claim."""
        staged = 0
        for req in self.scheduler.queue:
            if self.pool.status(req.rid) == "host":
                if not self.pool.prefetch(req.rid):
                    return
                staged += 1
                if staged >= self._stage_depth:
                    return

    # ---- decode -----------------------------------------------------------
    def _fail_active(self, reason: str) -> None:
        """A batch-level fault: every active request retires as "failed"
        (its pool entry freed) and serving goes on with the queue."""
        for slot, r in list(self.scheduler.active.items()):
            self.scheduler.evict(slot)
            self._retire(r, "failed", reason)

    def _tick(self) -> None:
        # injected tick faults fire before the step runs: "raise" fails the
        # active batch in place of ending run(); "preempt" forces a
        # spill-and-requeue of the youngest slot (the mid-decode drill)
        if self._inj is not None:
            try:
                ev = self._inj.check("engine.tick")
            except InjectedFault as e:
                self._fail_active(str(e))
                return
            if ev is not None and ev.kind == "preempt":
                victim = self._pick_victim(None)
                if victim is not None:
                    self._preempt_slot(victim)
        active = self.scheduler.active
        if not active:
            return
        b = self.slots
        toks = np.zeros((b, 1), np.int32)
        pos = np.zeros((b,), np.int32)
        act = np.zeros((b,), bool)
        for s, r in active.items():
            toks[s, 0] = r.tokens[-1]
            pos[s] = request_prompt_len(self.cfg, r) + len(r.tokens) - 1
            act[s] = True
        with self.obs.span("engine.tick", batch=len(active)):
            dev = self.device
            batch = host_batch(toks, dev)
            t0 = time.monotonic()
            # the pool's page copies (a side stream on the card) land first
            self.pool.wait_copies()
            logits, self.pool.cache = self._decode_fn(
                self.params, self.pool.cache, batch,
                torch.from_numpy(pos).to(dev), torch.from_numpy(act).to(dev))
            # the tick's one host sync: every slot's next-token row at once
            rows = self._row(logits)
            self._c_decode_s.inc(time.monotonic() - t0)
            released = False
            for s, r in active.items():
                r.tokens.append(self._select(r, rows[s]))
                if self._done(r):
                    r.done_mono = time.monotonic()
                    self.scheduler.finish(s)
                    self.pool.release(r.rid)
                    released = True
            if released:
                # a release frees budget: stage the next waiting request now
                self._prefetch_next()
        self._c_ticks.inc()
        self._c_decode_tokens.inc(len(active))

    # ---- run loop ---------------------------------------------------------
    def _fail_queued(self, reason: str) -> None:
        sched = self.scheduler
        while sched.queue:
            self._retire(sched.queue.popleft(), "failed", reason)

    @torch.no_grad()
    def run(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        """Serve a request trace to completion; -> {rid: generated token
        ids} for every terminal request (check `Request.status`). Never
        raises for a per-request failure."""
        t0 = self._clock()
        for r in requests:
            self.submit(r, t0)
        idle_rounds = 0
        last_progress = t0
        progressed = False
        while self.scheduler.has_work():
            # the round's one reading; progress in the round before is
            # stamped with it
            now = self._clock()
            if progressed:
                last_progress = now
            self._sweep(now)
            self._shed_doomed(now)
            self._maybe_preempt(now)
            progressed = self._admit(t0)
            if not self.scheduler.active:
                if progressed:
                    idle_rounds = 0
                    continue
                # stall watchdog: nothing active, nothing admits
                idle_rounds += 1
                stalled_wall = (self.watchdog_s is not None
                                and now - last_progress > self.watchdog_s)
                if idle_rounds > self.stall_rounds or stalled_wall:
                    self._fail_queued(
                        "stalled: queue non-empty but nothing admits "
                        "(host arena too small for one request?)")
                continue
            idle_rounds = 0
            self._prefetch_next()
            self._tick()
            progressed = True
        self._g_wall.set(self._clock() - t0)
        self._share_stamps(self.scheduler.finished)
        done = self.scheduler.drain()
        for r in done:
            self._rngs.pop(r.rid, None)
        self._last_run = done
        return {r.rid: np.asarray(r.tokens, np.int32) for r in done}

    def metrics(self) -> Dict[str, float]:
        """Registry-backed metrics; the key set is the JAX engine's."""
        sched = self.scheduler
        ticks = self._c_ticks.value
        dtok = self._c_decode_tokens.value
        decode_s = self._c_decode_s.value
        out = {
            "requests": float(sched.served_total),
            "ticks": float(ticks),
            "decode_tokens": float(dtok),
            "decode_tok_s": dtok / decode_s if decode_s else 0.0,
            "mean_concurrency": dtok / ticks if ticks else 0.0,
            "wall_s": self._g_wall.value,
        }
        for k, v in sched.counters.items():
            out[k] = float(v)
        ttft, tpot = sched._ttft, sched._tpot
        if ttft.window:
            out["ttft_mean_s"] = float(ttft.mean())
            out["ttft_p95_s"] = float(ttft.percentile(95))
        if tpot.window:
            out["tpot_p50_s"] = float(tpot.percentile(50))
            out["tpot_p95_s"] = float(tpot.percentile(95))
        out.update({f"pool_{k}": float(v) for k, v in self.pool.stats.items()})
        return out
