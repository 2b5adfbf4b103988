"""DiComm latency/throughput model (paper §3.2, Fig. 6/7, Table 3).

On TPU there are no NICs or RDMA verbs to drive, so DiComm's *runtime* role
is played by ``jax.lax.ppermute``/GSPMD collectives; what this module keeps
is DiComm's *decision* role: a calibrated model of the three cross-chip
transports the paper compares —

  * CPU-mediated TCP   (Gloo-style: device->host, TCP, host->device)
  * CPU-mediated RDMA  (host bounce but RDMA wire)
  * device-direct RDMA (DiComm's contribution: NIC DMA between device mems)

plus the NIC-affinity effect of Table 3.  ``HeteroAuto``'s update/P2P terms
and the Table 9 ablations consume these numbers.  Constants are calibrated
so the modeled device-direct speedup over TCP reproduces Fig. 7's average
(9.94×, range 1.79–16.0× over 64 KiB–256 MiB messages).

A copy of the JAX package's ``comm/latency.py``,
held equal to it by ``tests/test_torch_planning.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class Transport:
    name: str
    base_latency: float      # per-message setup (s)
    bandwidth: float         # steady-state wire B/s
    hop_latency: float = 0.0  # extra per-hop (device<->host staging)
    hop_bandwidth: float = float("inf")  # PCIe staging bandwidth


TRANSPORTS: Dict[str, Transport] = {
    # TCP through host memory: kernel stack setup dominates small messages;
    # staging is pipelined with the wire, so it shows up as reduced
    # steady-state bandwidth rather than extra serial hops
    "cpu_tcp": Transport("cpu_tcp", base_latency=360e-6, bandwidth=6.3e9),
    # host-bounced RDMA: cheap setup, PCIe-staging-limited bandwidth
    "cpu_rdma": Transport("cpu_rdma", base_latency=45e-6, bandwidth=9.5e9),
    # device-direct RDMA (DiComm): no hops, NIC line rate
    "device_rdma": Transport("device_rdma", base_latency=22.5e-6,
                             bandwidth=11.5e9),
}


def p2p_latency(transport: str, nbytes: float) -> float:
    t = TRANSPORTS[transport]
    lat = t.base_latency + nbytes / t.bandwidth
    if t.hop_latency:
        lat += 2 * (t.hop_latency + nbytes / t.hop_bandwidth)
    return lat


def fig7_message_sizes() -> List[int]:
    return [1 << p for p in range(10, 29)]   # 1 KiB .. 256 MiB


def fig7_speedups() -> Dict[int, float]:
    """Device-direct RDMA speedup over CPU-mediated TCP per message size."""
    return {n: p2p_latency("cpu_tcp", n) / p2p_latency("device_rdma", n)
            for n in fig7_message_sizes()}


def fig7_average_speedup() -> float:
    s = fig7_speedups()
    return sum(s.values()) / len(s)


# --------------------------- Table 3: NIC affinity -------------------------

@dataclasses.dataclass(frozen=True)
class NicTopology:
    """8 chips sharing 8 NICs through PCIe switches.  With affinity each
    chip uses the NIC behind its own switch; without, traffic crosses the
    inter-switch link and serializes."""
    nic_bw: float = 12.4e9          # per-NIC line rate (≈100GbE + overhead)
    switch_penalty: float = 0.45    # fraction of bw lost crossing switches
    contention: float = 0.80        # effective share under 8-way contention


def affinity_throughput(topo: NicTopology = NicTopology()) -> float:
    return topo.nic_bw * topo.contention


def non_affinity_throughput(topo: NicTopology = NicTopology()) -> float:
    return topo.nic_bw * topo.contention * (1 - topo.switch_penalty)
