"""Training entry point (the `ddlrun` analogue of the JAX package's
launcher, whose flag names it keeps). Runs on the card unless
`--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
        --smoke --steps 20 --batch 8 --seq 128

LMS is on unless `--no-lms` is given, as in the JAX launcher: the trainer
plans the step's memory for the card (`--profile`: from a calibration
report instead of the hardware model), and the plan's summary is printed
when it streams a class from pinned host memory.

Data-parallel training runs one process per mesh device under torchrun,
which sets RANK, WORLD_SIZE and LOCAL_RANK; the mesh (`--mesh PxDxM`, as
the JAX launcher parses it) must have WORLD_SIZE devices:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2.5-14b --smoke \
        --mesh 2x1x1 --compress-dcn --steps 20 --batch 8 --seq 128

With LMS on (LMS + DDL) every rank plans the same step for its card and
reduces each layer's grads over the ranks while the backward goes on;
`--no-lms` trains resident. `--ddl-mode zero1` shards the AdamW state over
the data ranks; `--microbatches M` accumulates M microbatches a step (on a
mesh with the overlapped backward, as reduce-scattered shards):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2.5-14b --smoke \
        --mesh 1x2x1 --ddl-mode zero1 --steps 20 --batch 8 --seq 128

The process group is NCCL when every rank has a card of its own, gloo
otherwise (ranks on the CPU, or sharing a card). Only rank 0 prints.

Checkpoints, the Supervisor and its drills, heartbeats, loss-spike
telemetry and the trace and obs-report exports take the JAX launcher's
flags. The run checkpoints into `--ckpt-dir` (default /tmp/repro_ckpt,
as in JAX) every `--ckpt-every` steps and at the end, and resumes from
the newest committed step there: give each run a directory of its own.
`--supervise` restarts a failed run from its last committed checkpoint;
`--fault-step N` (or `--fault-seed S`) injects the failure, `--lost-devices`
makes it take devices, and the survivors reshard (under torchrun on a
fresh rendezvous next to the checkpoints):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
        --smoke --steps 8 --ckpt-dir build/ckpt --ckpt-every 2 \
        --supervise --fault-step 5

Tensor parallelism: a `model` axis above 1 splits the dense stacks' heads,
`ff` and vocab over its ranks (`models/sharding.py`), beside DDL over the
`pod` and `data` axes, resident or under LMS; zero1 and the Mamba-2 and
MoE stacks raise there (not ported yet):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch qwen2.5-14b --smoke --no-lms \
        --mesh 1x2x2 --steps 20 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch.distributed as dist

from repro_torch.config.base import DDLConfig, LMSConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import init_process_group as _init_process_group, parse_mesh
from repro_torch.models import transformer as tr
from repro_torch.models.sharding import model_size
from repro_torch.obs import (TelemetryLoop, configure, export_chrome_trace,
                             get_obs, write_obs_report)
from repro_torch.runtime import (FaultEvent, FaultInjector, FaultPlan,
                                 RestartPolicy, Supervisor)
from repro_torch.train.steps import ZERO1_TP
from repro_torch.train.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run here)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--mesh", default="1x1",
                   help="DxM or PxDxM; M (tensor parallelism) must be 1, and "
                        "the mesh must have WORLD_SIZE devices")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--ddl-mode", default="allreduce",
                   choices=["allreduce", "zero1", "none"])
    p.add_argument("--compress-dcn", action="store_true")
    p.add_argument("--no-lms", action="store_true",
                   help="train without LMS (everything resident)")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log", default="",
                   help="write the history rows to this JSON file")
    p.add_argument("--log-every", type=int, default=1,
                   help="flush device metrics to the host every N steps")
    p.add_argument("--obs-jsonl", default="",
                   help="stream span events to this JSONL file")
    p.add_argument("--trace", default="",
                   help="write a Chrome trace_event JSON (chrome://tracing / "
                        "Perfetto) at exit")
    p.add_argument("--obs-report", default="",
                   help="write the overlap/swap obs report JSON at exit (a "
                        "--profile input)")
    p.add_argument("--profile", default="",
                   help="Planner v2 calibration: plan from the measured "
                        "bandwidths/overlap in this obs_report.json instead "
                        "of the hardware model")
    p.add_argument("--spike-action", default="off",
                   choices=["off", "record", "stop"],
                   help="loss-spike telemetry: record alerts, or stop the "
                        "run early on a spike")
    p.add_argument("--supervise", action="store_true",
                   help="run under the Supervisor: on failure, restore the "
                        "last committed checkpoint, reshard onto surviving "
                        "devices, and resume")
    p.add_argument("--heartbeat-dir", default="",
                   help="heartbeat store directory (enables liveness beats)")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--fault-step", type=int, default=-1,
                   help="drill: inject a fatal fault before this 0-based "
                        "step (requires --supervise to survive it)")
    p.add_argument("--lost-devices", type=int, default=0,
                   help="drill: devices the injected fault takes down "
                        "(triggers an elastic reshard on restart)")
    p.add_argument("--fault-seed", type=int, default=-1,
                   help="drill: sample a random FaultPlan from this seed "
                        "instead of --fault-step")
    args = p.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if model_size(mesh) > 1:
        # what tensor parallelism does not run yet, before any rank starts
        if args.ddl_mode == "zero1":
            raise NotImplementedError(ZERO1_TP)
        tr._check_kinds(cfg, mesh)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != mesh.num_devices:
        raise ValueError(f"WORLD_SIZE {world} disagrees with --mesh {args.mesh} "
                         f"({mesh.num_devices} devices): run one process per device")
    if world > 1 and not dist.is_initialized():
        _init_process_group(args.device, world)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    tcfg = TrainConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", args.seq, args.batch),
        mesh=mesh,
        lms=LMSConfig(enabled=not args.no_lms),
        ddl=DDLConfig(mode=args.ddl_mode, compress_dcn=args.compress_dcn),
        learning_rate=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, microbatches=args.microbatches,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        log_every=max(1, args.log_every))

    configure(jsonl_path=args.obs_jsonl or None)
    obs = get_obs()
    telemetry = (TelemetryLoop(action=args.spike_action, obs=obs)
                 if args.spike_action != "off" else None)

    def log(step, m):
        if rank0:
            print(f"step {step:5d} | loss {m['loss']:.4f} | gnorm "
                  f"{m['grad_norm']:.3f} | lr {m['lr']:.2e} | "
                  f"{m['time_s']*1e3:.0f} ms")

    injector = None
    if args.fault_step >= 0:
        payload = {"lost_devices": args.lost_devices} if args.lost_devices else {}
        injector = FaultInjector(FaultPlan(
            [FaultEvent("trainer.step", at=args.fault_step, payload=payload)]))
    elif args.fault_seed >= 0:
        injector = FaultInjector(FaultPlan.sample(
            args.fault_seed, sites=("trainer.step", "ckpt.commit")))

    if args.supervise:
        sup = Supervisor(tcfg, device=args.device,
                         heartbeat_dir=args.heartbeat_dir or None,
                         policy=RestartPolicy(max_restarts=args.max_restarts,
                                              backoff_base=0.01, max_delay=1.0),
                         injector=injector, obs=obs, telemetry=telemetry,
                         rendezvous=_rendezvous(args.ckpt_dir),
                         profile=args.profile or None)
        res = sup.run(steps=args.steps, on_step=log)
        hist, registry = res.hist, sup.obs.registry
        rank0 = rank0 and not res.left
        if rank0:
            for note in res.notes:
                print(f"reshard: {note}")
            if res.restarts:
                print(f"recovered from {res.restarts} failure(s) "
                      f"in {res.attempts} attempts")
    else:
        trainer = Trainer(tcfg, device=args.device,
                          heartbeat_dir=args.heartbeat_dir or None,
                          injector=injector, obs=obs, telemetry=telemetry,
                          profile=args.profile or None)
        plan = trainer.plan
        if rank0 and plan is not None and (plan.swap_schedule is not None
                                           or plan.calibrated):
            print(plan.summary())
        _, hist = trainer.train(steps=args.steps, on_step=log)
        registry = trainer.obs.registry
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank0:
        if args.log:
            with open(args.log, "w") as f:
                json.dump(hist, f, indent=1)
        if telemetry is not None:
            for a in telemetry.alerts:
                print(f"telemetry alert: {a}")
        if hist:
            print(f"final loss: {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f})")
        if args.trace:
            export_chrome_trace(obs.ring.events(), args.trace)
            print(f"chrome trace: {args.trace}")
        if args.obs_report:
            write_obs_report(args.obs_report, obs=obs)
            print(f"obs report: {args.obs_report}")
        print("-- metrics --")
        for line in registry.summary_lines():
            print(line)
    return 0


def _rendezvous(ckpt_dir: str):
    """The survivors' rendezvous after a reshard under torchrun: a file
    next to the checkpoints, one a run (torchrun's port) and attempt."""
    run = os.environ.get("MASTER_PORT", "0")

    def init_method(attempt: int) -> str:
        return f"file://{os.path.abspath(ckpt_dir)}/.rendezvous_{run}_{attempt}"
    return init_method


if __name__ == "__main__":
    sys.exit(main())
