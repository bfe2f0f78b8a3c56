"""Roofline analysis of a counted program — twin of
``repro.launch.roofline``, with one NVIDIA H100's constants.

Three terms per (architecture x shape x mesh) cell, in seconds a step on
the target card (NVIDIA H100 80GB HBM3, SXM5, at its 700 W limit):

    compute    = FLOPs_per_device            / 989.4e12
    memory     = bytes_per_device            / 3.35e12
    collective = collective_bytes_per_device / 50e9

The counts come from :mod:`repro_torch.launch.op_cost` (every aten op of
one eager run), not from a compiled HLO module: ``analyze`` takes a
:class:`~repro_torch.launch.op_cost.Cost`.  The reference's
``parse_collectives`` reads XLA's partitioned HLO text; the port compiles
no HLO and partitions nothing (one card holds every array), so it has no
counterpart: the dry-run models its collectives from the logical specs
instead (``repro_torch.launch.dryrun``).

The collective term is one bandwidth a card, as the reference's is one
ICI link's: the card's 400 Gb/s NDR network port (50 GB/s a direction),
because each production mesh axis of 16 spans two 8-card NVLink nodes and
a ring over it crosses the network.  NVLink 4 inside a node is 450 GB/s a
direction (NVIDIA H100 data sheet, SXM5: 900 GB/s both ways; NVIDIA H100
80GB HBM3 (SXM5), 700 W); this single term does not use it, as the
reference's single term does not model torus hops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# --- NVIDIA H100 80GB HBM3 (SXM5), 700 W: per-card constants ------------------
#: dense bf16 tensor-core peak, no sparsity (NVIDIA H100 data sheet, SXM5,
#: NVIDIA H100 80GB HBM3 (SXM5), 700 W)
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s
#: HBM3 bandwidth (NVIDIA H100 data sheet, SXM5; NVIDIA H100 80GB HBM3
#: (SXM5), 700 W)
HBM_BW = 3.35e12                # B/s
#: one 400 Gb/s NDR InfiniBand port a card, one direction (NVIDIA DGX H100
#: system: eight ConnectX-7 ports for eight NVIDIA H100 80GB HBM3 (SXM5),
#: 700 W): the link every 16-way axis of the production meshes crosses
COLLECTIVE_BW = 50e9            # B/s


@dataclasses.dataclass
class Roofline:
    flops: float                     # per device
    bytes_accessed: float            # per device (every op's reads+writes)
    collective_bytes: float          # per device
    collectives: Dict[str, int]
    model_flops: float = 0.0         # 6·N·D (active N for MoE), global
    chips: int = 1
    raw_flops: float = 0.0           # the counter's own, before any model
    raw_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / COLLECTIVE_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Roofline step time (s): max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted flops × chips): how much counted compute
        is 'useful' (catches remat/redundancy waste)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the roofline bound: the score.
        = (MODEL_FLOPS / chips / peak) / max-term."""
        if self.bound == 0:
            return 0.0
        t_useful = self.model_flops / self.chips / PEAK_FLOPS_BF16
        return t_useful / self.bound

    def to_dict(self) -> Dict:
        return {
            "raw_xla_flops_per_device": self.raw_flops,
            "raw_xla_bytes_per_device": self.raw_bytes,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "collective_counts": self.collectives,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, model_flops: float, chips: int) -> Roofline:
    """The roofline of a per-device :class:`op_cost.Cost`.  Eager PyTorch
    runs every loop iteration, so the count needs no trip-count
    correction and the ``raw_*`` fields (XLA's uncorrected numbers in the
    reference's records) hold the same count."""
    return Roofline(
        flops=cost.flops,
        bytes_accessed=cost.bytes,
        collective_bytes=cost.collective_bytes,
        collectives={k: int(v) for k, v in cost.collective_counts.items()},
        model_flops=model_flops,
        chips=chips,
        raw_flops=cost.flops,
        raw_bytes=cost.bytes,
    )


def model_flops_train(n_params_active: int, tokens: int) -> float:
    """6·N·D for a training step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * tokens


def model_flops_forward(n_params_active: int, tokens: int) -> float:
    return 2.0 * n_params_active * tokens
