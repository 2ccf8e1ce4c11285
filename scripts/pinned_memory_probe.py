#!/usr/bin/env python3
"""What the host does with pinned memory once it is freed: /proc/meminfo
read after each of these steps, in one process and the processes it
starts (spawn), each pinning `--gb` GB (default 8):

1. a child pins an anonymous buffer (`cudaHostRegister`, as
   `repro_torch.core.lms.offload.PinnedArena` does), touches it and exits;
2. a child takes a block from torch's pinned allocator (`cudaHostAlloc`)
   and exits;
3. the parent makes a shared-memory file (`memfd_create`) and zeroes it;
   two children in turn map it, pin their mapping, touch it and exit;
   then the parent pins its own mapping, unpins it and closes the file;
4. the parent pins an anonymous buffer, unpins it and frees it.

With `--tmpfs DIR` (a RAM filesystem such as /dev/shm) it probes files
there instead: a child writes a file of `--gb` GB and deletes it; a child
writes one and exits, and the parent deletes it; the parent writes one and
deletes it (MemAvailable read again after 5 s each time).

    python3 scripts/pinned_memory_probe.py [--gb 8] [--tmpfs /dev/shm]

Prints one JSON line a step ({"step", "meminfo": {key: bytes}}) and, as
the last line, {"steps": [...]} with MemFree and MemAvailable after each
step against the start. Needs the card.
"""
import argparse
import json
import mmap
import os
import sys

import torch
import torch.multiprocessing as mp

KEYS = ("MemTotal", "MemFree", "MemAvailable", "Cached", "Shmem", "AnonPages", "Mlocked")


def meminfo() -> dict:
    out = {}
    with open("/proc/meminfo") as f:
        for row in f:
            key, val = row.split(":", 1)
            parts = val.split()
            if key in KEYS:
                out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def register(t: torch.Tensor) -> None:
    err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), t.numel(), 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister failed: error {int(err)}")


def unregister(t: torch.Tensor) -> None:
    err = torch.cuda.cudart().cudaHostUnregister(t.data_ptr())
    if int(err) != 0:
        raise RuntimeError(f"cudaHostUnregister failed: error {int(err)}")


def touch_on_card(t: torch.Tensor) -> None:
    """Copy the pinned buffer's first GiB to the card and back."""
    n = min(t.numel(), 1 << 30)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    dev.copy_(t[:n], non_blocking=True)
    t[:n].copy_(dev, non_blocking=True)
    torch.cuda.synchronize()


def child_anonymous(_, nbytes):
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    register(buf)
    touch_on_card(buf)


def child_torch_pinned(_, nbytes):
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    buf.fill_(1)
    touch_on_card(buf)


def child_shared(_, path, nbytes):
    fd = os.open(path, os.O_RDWR)
    mm = mmap.mmap(fd, nbytes, mmap.MAP_SHARED, mmap.PROT_READ | mmap.PROT_WRITE)
    buf = torch.frombuffer(mm, dtype=torch.uint8)
    register(buf)
    buf[: 1 << 20].fill_(2)
    touch_on_card(buf)
    unregister(buf)
    del buf
    mm.close()
    os.close(fd)


def write_file(path: str, nbytes: int) -> None:
    chunk = b"\1" * (64 << 20)
    with open(path, "wb") as f:
        for lo in range(0, nbytes, len(chunk)):
            f.write(chunk[:min(len(chunk), nbytes - lo)])


def child_tmpfs(_, path, nbytes, delete):
    write_file(path, nbytes)
    if delete:
        os.remove(path)


def run_child(fn, *args):
    mp.start_processes(fn, args=args, nprocs=1, start_method="spawn", join=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--gb", type=float, default=8.0)
    p.add_argument("--tmpfs", default="",
                   help="probe files in this RAM filesystem instead of pinned memory")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs the card")
    nbytes = int(args.gb * 1e9)
    torch.cuda.init()
    steps = []

    def record(name):
        row = {"step": name, "meminfo": meminfo()}
        steps.append(row)
        print(json.dumps(row), flush=True)

    record("start")
    if args.tmpfs:
        import time
        path = os.path.join(args.tmpfs, "pinned_probe_file")

        def settled(name):
            record(name)
            time.sleep(5)
            record(name + ", 5 s later")
        run_child(child_tmpfs, path, nbytes, True)
        settled("child wrote a tmpfs file, deleted it and exited")
        run_child(child_tmpfs, path, nbytes, False)
        record("child wrote a tmpfs file and exited")
        os.remove(path)
        settled("parent deleted it")
        write_file(path, nbytes)
        record("parent wrote a tmpfs file")
        os.remove(path)
        settled("parent deleted it")
        return _summary(args.gb, steps)
    run_child(child_anonymous, nbytes)
    record("child pinned an anonymous buffer and exited")
    run_child(child_torch_pinned, nbytes)
    record("child took torch pinned memory and exited")
    fd = os.memfd_create("pinned_probe")
    os.ftruncate(fd, nbytes)
    mm = mmap.mmap(fd, nbytes, mmap.MAP_SHARED, mmap.PROT_READ | mmap.PROT_WRITE)
    shared = torch.frombuffer(mm, dtype=torch.uint8)
    shared.zero_()
    record("parent zeroed a shared file")
    path = f"/proc/{os.getpid()}/fd/{fd}"
    run_child(child_shared, path, nbytes)
    record("child 1 pinned the shared file and exited")
    run_child(child_shared, path, nbytes)
    record("child 2 pinned the shared file and exited")
    register(shared)
    touch_on_card(shared)
    record("parent pinned the shared file")
    unregister(shared)
    del shared
    mm.close()
    os.close(fd)
    record("parent unpinned and closed the shared file")
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    register(buf)
    touch_on_card(buf)
    record("parent pinned an anonymous buffer")
    unregister(buf)
    del buf
    record("parent unpinned and freed it")
    return _summary(args.gb, steps)


def _summary(gb, steps) -> int:
    start = steps[0]["meminfo"]
    print(json.dumps({"gb": gb, "steps": [
        {"step": s["step"],
         "mem_free_delta_gb": (s["meminfo"]["MemFree"] - start["MemFree"]) / 1e9,
         "mem_available_delta_gb": (s["meminfo"]["MemAvailable"] - start["MemAvailable"]) / 1e9}
        for s in steps]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
