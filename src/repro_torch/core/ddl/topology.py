"""Fabric topology model: which mesh axis rides which interconnect, and the
analytic ring-collective time model (the paper's Fig. 1 DDL-vs-NCCL
comparison), over the port's H100 hardware model. A copy of the JAX
package's `core/ddl/topology.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch import hw as hwlib


@dataclass(frozen=True)
class Fabric:
    name: str      # "ici" | "dcn" | "host"
    bw: float      # bytes/s per card effective
    latency: float # per-hop seconds


def fabrics(hw: hwlib.HardwareSpec = hwlib.DEFAULT) -> Dict[str, Fabric]:
    return {
        "ici": Fabric("ici", hw.ici_link_bw * hw.ici_links, 1e-6),
        "dcn": Fabric("dcn", hw.dcn_bw, 10e-6),
        "host": Fabric("host", hw.host_bw, 5e-6),
    }


# mesh axis -> fabric tier, the paper's NVLink/InfiniBand split: "ici" is
# NVLink between the cards of one host, "dcn" InfiniBand between hosts
AXIS_FABRIC = {"data": "ici", "model": "ici", "pod": "dcn"}


def ring_reduce_scatter_time(nbytes: float, p: int, fab: Fabric) -> float:
    if p <= 1:
        return 0.0
    return (p - 1) * fab.latency + nbytes * (p - 1) / p / fab.bw


def ring_all_gather_time(nbytes: float, p: int, fab: Fabric) -> float:
    return ring_reduce_scatter_time(nbytes, p, fab)


def ring_all_reduce_time(nbytes: float, p: int, fab: Fabric) -> float:
    return 2.0 * ring_reduce_scatter_time(nbytes, p, fab)


def flat_allreduce_time(nbytes: float, sizes: Tuple[int, ...],
                        hw: hwlib.HardwareSpec = hwlib.DEFAULT) -> float:
    """NCCL-style single flat ring spanning every device: the ring crosses
    the slowest fabric, so the whole collective is InfiniBand-bound."""
    fabs = fabrics(hw)
    p = 1
    for s in sizes:
        p *= s
    slowest = fabs["dcn"] if len(sizes) > 1 else fabs["ici"]
    return ring_all_reduce_time(nbytes, p, slowest)


def ddl_allreduce_time(nbytes: float, data: int, pods: int = 1,
                       compress_dcn: bool = False,
                       hw: hwlib.HardwareSpec = hwlib.DEFAULT) -> float:
    """Topology-aware decomposition: RS over NVLink, AR over InfiniBand on
    the 1/data shard, AG over NVLink (the paper's reduce-scatter/all-gather
    schedule)."""
    fabs = fabrics(hw)
    t = ring_reduce_scatter_time(nbytes, data, fabs["ici"])
    shard = nbytes / max(data, 1)
    if pods > 1:
        if compress_dcn:
            shard = shard / 4 + shard / 1024  # int8 payload + fp32 scales
        t += ring_all_reduce_time(shard, pods, fabs["dcn"])
    t += ring_all_gather_time(nbytes, data, fabs["ici"])
    return t
