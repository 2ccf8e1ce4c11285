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
        -m repro_torch.launch.train --arch qwen2.5-14b --smoke --no-lms \
        --mesh 2x1x1 --compress-dcn --steps 20 --batch 8 --seq 128

(LMS on a mesh of several ranks is not ported yet: `--no-lms` there.)

The process group is NCCL when every rank has a card of its own, gloo
otherwise (ranks on the CPU, or sharing a card). Only rank 0 prints.

DDL's zero1 mode, tensor parallelism (a `model` axis above 1), LMS on a
mesh of several ranks, checkpoints, the Supervisor, fault drills,
heartbeats, loss-spike telemetry and the trace and obs-report exports are
not ported yet: their flags raise.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec,
                                     ShapeConfig, TrainConfig)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import local_device
from repro_torch.obs import configure, get_obs
from repro_torch.train.trainer import Trainer


def parse_mesh(s: str) -> MeshSpec:
    dims = tuple(int(x) for x in s.split("x"))
    if len(dims) == 3:
        return MeshSpec(dims, ("pod", "data", "model"))
    if len(dims) == 2:
        return MeshSpec(dims, ("data", "model"))
    return MeshSpec(dims, ("data",))


def _unported(args) -> list:
    """The flags given whose feature is not ported yet."""
    mesh = parse_mesh(args.mesh)
    given = {
        "--no-lms absent on a mesh of several ranks (LMS + DDL)":
            not args.no_lms and mesh.num_devices > 1,
        "--no-lms absent with --microbatches above 1 (LMS with microbatches)":
            not args.no_lms and args.microbatches > 1,
        "--ddl-mode zero1": args.ddl_mode == "zero1",
        "--mesh with a model axis above 1 (tensor parallelism)":
            dict(zip(mesh.axes, mesh.shape)).get("model", 1) > 1,
        "--microbatches above 1 with the overlapped backward on a mesh of "
        "several ranks": (args.microbatches > 1 and args.ddl_mode != "none"
                          and mesh.num_devices > 1),
        "--ckpt-dir": args.ckpt_dir is not None,
        "--ckpt-every": args.ckpt_every is not None,
        "--trace": bool(args.trace),
        "--obs-report": bool(args.obs_report),
        "--spike-action": args.spike_action != "off",
        "--supervise": args.supervise,
        "--heartbeat-dir": bool(args.heartbeat_dir),
        "--max-restarts": args.max_restarts is not None,
        "--fault-step": args.fault_step >= 0,
        "--lost-devices": args.lost_devices > 0,
        "--fault-seed": args.fault_seed >= 0,
    }
    return [flag for flag, on in given.items() if on]


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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=None)
    p.add_argument("--log", default="",
                   help="write the history rows to this JSON file")
    p.add_argument("--log-every", type=int, default=1,
                   help="flush device metrics to the host every N steps")
    p.add_argument("--obs-jsonl", default="",
                   help="stream span events to this JSONL file")
    p.add_argument("--trace", default="")
    p.add_argument("--obs-report", default="")
    p.add_argument("--profile", default="",
                   help="Planner v2 calibration: plan from the measured "
                        "bandwidths/overlap in this obs_report.json instead "
                        "of the hardware model")
    p.add_argument("--spike-action", default="off",
                   choices=["off", "record", "stop"])
    p.add_argument("--supervise", action="store_true")
    p.add_argument("--heartbeat-dir", default="")
    p.add_argument("--max-restarts", type=int, default=None)
    p.add_argument("--fault-step", type=int, default=-1)
    p.add_argument("--lost-devices", type=int, default=0)
    p.add_argument("--fault-seed", type=int, default=-1)
    args = p.parse_args(argv)
    unported = _unported(args)
    if unported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unported)} (the port trains without "
            "checkpoints)")
    mesh = parse_mesh(args.mesh)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != mesh.num_devices:
        raise ValueError(f"WORLD_SIZE {world} disagrees with --mesh {args.mesh} "
                         f"({mesh.num_devices} devices): run one process per device")
    if world > 1 and not dist.is_initialized():
        _init_process_group(args.device, world)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", args.seq, args.batch),
        mesh=mesh,
        lms=LMSConfig(enabled=not args.no_lms),
        ddl=DDLConfig(mode=args.ddl_mode, compress_dcn=args.compress_dcn),
        learning_rate=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, microbatches=args.microbatches,
        log_every=max(1, args.log_every))

    configure(jsonl_path=args.obs_jsonl or None)
    trainer = Trainer(tcfg, device=args.device, obs=get_obs(),
                      profile=args.profile or None)
    plan = trainer.plan
    if rank0 and plan is not None and (plan.swap_schedule is not None or plan.calibrated):
        print(plan.summary())

    def log(step, m):
        if rank0:
            print(f"step {step:5d} | loss {m['loss']:.4f} | gnorm "
                  f"{m['grad_norm']:.3f} | lr {m['lr']:.2e} | "
                  f"{m['time_s']*1e3:.0f} ms")

    _, hist = trainer.train(steps=args.steps, on_step=log)
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank0:
        if args.log:
            with open(args.log, "w") as f:
                json.dump(hist, f, indent=1)
        print(f"final loss: {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f})")
        print("-- metrics --")
        for line in trainer.obs.registry.summary_lines():
            print(line)
    return 0


def _init_process_group(device, world: int) -> None:
    """Join the torchrun world: NCCL when the ranks are on the card and each
    has a card of its own (`local_device`), gloo otherwise."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        torch.cuda.set_device(local_device())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10))


if __name__ == "__main__":
    sys.exit(main())
