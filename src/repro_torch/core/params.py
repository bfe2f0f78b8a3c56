"""Occamy machine parameters for the offload phase simulator.

Every constant is either stated verbatim in the paper or reconstructed so
that the paper's published aggregates emerge mechanistically from the
simulation.  The paper's anchors (1 GHz ⇒ cycles == ns):

  §5.5 B:  multicast wakeup costs 47 cycles: one host store (8) + 39 cycles
           of network propagation ("39 arise in the hardware as the write
           request exits CVA6's memory subsystem...").
  §5.5 E:  t_setup = 53 cycles (programming the x and y transfers),
           t_latency = 55 cycles round trip, bw = 64 B/cycle (512-bit NoC).
  §5.5 F:  t_init = 55 cycles; AXPY computes at 1.47 cycles/element over the
           8 compute cores of each cluster.
  §5.5 G:  t_setup = 21 cycles (single transfer), t_latency = 55 cycles.
  eq. 5:   t̂_axpy(n) = 400 + N/4 + 2.47·N/(8n).  Decomposition used here:
             [E+F+G constants] = (53+55) + 55 + (21+55) = 239
             [A+B+C+D+H+I]_mc = 24 + 47 + 10 + 0 + 60 + 20 = 161
             sum = 400  ✓ (verified in tests/test_model.py)
           A = host_info_base(12) + 2·(1 ptr + 5 AXPY arg words) = 24.
           H_unit = phase_sync(4) + arrival code(2) + CLINT travel(13) +
                    fire(2) + IPI propagation(39) = 60.
  §5.2:    average baseline offload overhead at 1 cluster ≈ 242 cycles:
             A(24) + B(47) + C(10) + D(0) + H_sw(141) + I(20) = 242  ✓
           H_sw(1) = phase_sync(4) + barrier code(73) + local travel(10) +
                     AMO(7) + IPI store(8) + propagation(39) = 141.
  fig. 7:  overhead grows with n, ≈1146 cycles max on a 32-cluster Matmul:
           CVA6's limited outstanding-write budget serializes baseline IPIs
           at host_store_next = 25 cycles apiece (§4.2: "CVA6's memory
           subsystem supports only a low number of outstanding write
           transactions"), giving B(32) = 8 + 31·25 + 39 = 822 and a total
           offload overhead within a few % of the paper's 1146
           (benchmarks/fig07_overhead.py).
  §5.4:    extension runtimes track ideal offset by ~185 cycles with σ=18;
           our reconstruction yields the model-consistent 161 (the paper's
           own closed-form constant also decomposes to 161 = 400 - 239; the
           24-cycle gap between their model and their measurement is within
           the <15 % error band they report, and we document the same gap).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OccamyParams:
    # --- topology -------------------------------------------------------------
    clusters_per_quadrant: int = 4
    num_quadrants: int = 8
    cores_per_cluster: int = 8          # compute cores (the DMA core is extra)

    # --- interconnect ---------------------------------------------------------
    wide_bw_bytes_per_cycle: int = 64   # 512-bit wide NoC / SPM port
    narrow_local: float = 10.0          # load from own-cluster TCDM
    narrow_same_quadrant: float = 25.0  # load from a cluster in same quadrant
    narrow_cross_quadrant: float = 40.0 # load from a cluster in another quadrant
    noc_propagation: float = 39.0       # CVA6 store -> core wakeup propagation

    # --- host (CVA6) ----------------------------------------------------------
    host_store_first: float = 8.0       # first posted write issues immediately
    host_store_next: float = 25.0       # subsequent writes: outstanding-txn limit
    host_info_base: float = 12.0        # phase A: prologue of the offload call
    host_info_per_word: float = 2.0     # phase A: per job-information word
    host_resume: float = 20.0           # phase I: take interrupt, clear, return

    # --- DMA ------------------------------------------------------------------
    dma_latency: float = 55.0           # AR->R->AW/W->B round trip (§5.5 E)
    dma_setup_two: float = 53.0         # programming two transfers (§5.5 E)
    dma_setup_one: float = 21.0         # programming one transfer (§5.5 G)
    dma_args_setup: float = 20.0        # phase D argument-transfer setup
    cluster0_port_occupancy: float = 30.0  # phase D serialization at cluster 0

    # --- synchronization ------------------------------------------------------
    phase_sync: float = 4.0             # DMA-core <-> compute-core handshake
    amo_service: float = 7.0            # one AMO increment at the TCDM counter
    sw_barrier_code: float = 73.0       # central-counter arrival routine (SW)
    unit_arrival_code: float = 2.0      # completion-unit arrival (posted store)
    unit_fire: float = 2.0              # completion unit compare + IPI fire
    clint_travel: float = 13.0          # cluster -> CLINT peripheral write

    # --- job execution --------------------------------------------------------
    f_init: float = 55.0                # phase F per-job init (§5.5 F)

    @property
    def num_clusters(self) -> int:
        return self.clusters_per_quadrant * self.num_quadrants

    @property
    def num_cores(self) -> int:
        # 8 compute + 1 DMA core per cluster, plus the CVA6 host.
        return self.num_clusters * (self.cores_per_cluster + 1) + 1

    def narrow_latency(self, src_cluster: int, dst_cluster: int) -> float:
        """Narrow-network access latency between two clusters (§5.5 C)."""
        if src_cluster == dst_cluster:
            return self.narrow_local
        if src_cluster // self.clusters_per_quadrant == dst_cluster // self.clusters_per_quadrant:
            return self.narrow_same_quadrant
        return self.narrow_cross_quadrant

    def dma_setup(self, num_transfers: int) -> float:
        """Cycles to program ``num_transfers`` DMA descriptors back-to-back.

        Anchored at the paper's two measured points: 53 cycles for two
        transfers (phase E of AXPY) and 21 for one (phase G); extrapolated
        linearly with the measured increment (53 - 21 = 32) beyond two.
        """
        if num_transfers <= 0:
            return 0.0
        if num_transfers == 1:
            return self.dma_setup_one
        return self.dma_setup_two + (num_transfers - 2) * (
            self.dma_setup_two - self.dma_setup_one
        )


DEFAULT_PARAMS = OccamyParams()
