"""Hardware model of the port's target: one NVIDIA H100 SXM card in an
8-card host, for the DDL topology model (`core/ddl/topology.py`).

The field names are the JAX package's (`repro/hw.py`), so a reader finds
each counterpart; the comment on each says what it is on this card. Every
value is a published figure (NVIDIA's H100 data sheet and the DGX H100
system's), not a measurement. One difference from the paper's IBM AC922:
an x86 H100 host reaches the card over PCIe, not over an NVLink CPU link,
so `host_bw` is the PCIe rate.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per card, dense bf16 on the tensor cores
    hbm_bytes: int              # device memory per card
    hbm_bw: float               # bytes/s per card
    ici_link_bw: float          # bytes/s per NVLink link (one direction)
    ici_links: int              # NVLink links per card
    dcn_bw: float               # bytes/s per card across hosts (InfiniBand)
    host_bw: float              # bytes/s host<->device (PCIe, one direction)
    host_bytes: int             # host DRAM per card
    vmem_bytes: int             # shared memory one block can use


H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,        # H100 SXM data sheet: 989 TFLOP/s dense bf16
    hbm_bytes=80 * 10**9,          # data sheet: 80 GB HBM3
    hbm_bw=3.35e12,                # data sheet: 3.35 TB/s
    ici_link_bw=25e9,              # NVLink 4: 25 GB/s a direction per link
    ici_links=18,                  # data sheet: 18 links, 900 GB/s both ways
    dcn_bw=50e9,                   # DGX H100: one 400 Gb/s InfiniBand NDR port per card
    host_bw=64e9,                  # PCIe Gen5 x16: 64 GB/s a direction
    host_bytes=256 * 10**9,        # DGX H100: 2 TB of host memory for 8 cards
    vmem_bytes=227 * 1024,         # CUDA guide: 227 KB of shared memory a block
)

DEFAULT = H100_SXM
