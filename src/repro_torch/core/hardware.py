"""Simulated accelerator registry — the TPU analogue of the paper's Table VI.

11 variants across 4 "generations"; 6 are used for training the estimator and
5 are held out as *unseen hardware* (the paper's generalization split).
Real-generation entries use public TPU numbers; the hypothetical entries fill
the compute-to-memory-ratio spectrum the paper probes with H20 (low compute /
high bandwidth) vs H800 (the opposite).

The paper's per-GPU quantities map as: GPU -> inference slice, SM -> chip
(the parallel scheduling unit), pipelines -> MXU / VPU / XU(transcendental) /
HBM / VMEM / ICI. See DESIGN.md §2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    name: str
    generation: str
    num_chips: int  # chips in the modeled slice (the "SM count" analogue)
    clock_ghz: float
    mxu_flops_per_cycle: float  # bf16 flops / cycle / chip (MACs*2)
    vpu_ops_per_cycle: float  # fp32 vector lanes ops / cycle / chip
    xu_ops_per_cycle: float  # transcendental ops / cycle / chip
    hbm_gbps: float  # GB/s per chip
    vmem_mb: float
    vmem_gbps: float  # GB/s per chip (on-chip)
    ici_gbps: float  # GB/s per link
    ici_links: int
    launch_us: float  # per-kernel dispatch overhead
    seen: bool
    #: list price in $/chip-hour (the placement layer's cost axis; a slice
    #: costs ``usd_per_chip_hour * num_chips`` per hour). None = unpriced:
    #: cost objectives skip the entry with a warning (see
    #: ``repro_torch.predict.objective``). Deliberately NOT part of
    #: :meth:`as_vector` — price is a procurement fact, not a performance
    #: feature, so the estimator never sees it.
    usd_per_chip_hour: Optional[float] = None

    @property
    def peak_tflops(self) -> float:
        return self.mxu_flops_per_cycle * self.clock_ghz * 1e9 / 1e12

    @property
    def usd_per_slice_hour(self) -> Optional[float]:
        """Price of the whole modeled slice (all ``num_chips`` chips)."""
        if self.usd_per_chip_hour is None:
            return None
        return self.usd_per_chip_hour * self.num_chips

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_gbps * 1e9 / (self.clock_ghz * 1e9)

    @property
    def vmem_bytes_per_cycle(self) -> float:
        return self.vmem_gbps * 1e9 / (self.clock_ghz * 1e9)

    def as_vector(self):
        """Normalized spec descriptor fed to the estimator (hardware
        generalization input, paper Table II)."""
        import numpy as np

        return np.array(
            [
                self.num_chips / 16.0,
                self.clock_ghz,
                self.mxu_flops_per_cycle / 2**18,
                self.vpu_ops_per_cycle / 2**11,
                self.xu_ops_per_cycle / 2**8,
                self.hbm_gbps / 1000.0,
                self.vmem_mb / 128.0,
                self.vmem_gbps / 10000.0,
                self.ici_gbps / 100.0,
                self.peak_tflops / (self.hbm_gbps / 1000.0) / 500.0,  # ridge point
                self.launch_us / 10.0,
            ],
            dtype=np.float32,
        )


def _mk(name, gen, chips, clock, tflops, hbm, vmem_mb, seen, *, vpu=2048, xu=256,
        vmem_gbps=None, ici=50.0, links=4, launch=6.0, usd=None):
    return TPUSpec(
        name=name,
        generation=gen,
        num_chips=chips,
        clock_ghz=clock,
        mxu_flops_per_cycle=tflops * 1e12 / (clock * 1e9),
        vpu_ops_per_cycle=vpu,
        xu_ops_per_cycle=xu,
        hbm_gbps=hbm,
        vmem_mb=vmem_mb,
        vmem_gbps=vmem_gbps or hbm * 12.0,
        ici_gbps=ici,
        ici_links=links,
        launch_us=launch,
        seen=seen,
        usd_per_chip_hour=usd,
    )


# name, generation, chips, GHz, bf16 TFLOP/s/chip, HBM GB/s, VMEM MB.
# usd = $/chip-hour: real generations use public on-demand list prices,
# hypothetical entries interpolate within their generation by peak FLOPs.
REGISTRY: dict[str, TPUSpec] = {
    s.name: s
    for s in [
        # ----- seen (training hardware) --------------------------------
        _mk("tpu-v4", "v4", 8, 1.05, 275, 1228, 128, True, launch=8.0, usd=3.22),
        _mk("tpu-v5e", "v5e", 8, 0.94, 197, 819, 128, True, launch=6.0, usd=1.20),
        _mk("tpu-v5p", "v5p", 8, 1.75, 459, 2765, 128, True, links=6, launch=7.0, usd=4.20),
        _mk("tpu-v5e-lite", "v5e", 4, 0.94, 99, 819, 64, True, launch=6.0, usd=0.75),   # H20-like: compute-starved
        _mk("tpu-v6e-half", "v6e", 8, 1.45, 459, 1640, 160, True, launch=5.0, usd=1.70),
        _mk("tpu-v4i", "v4", 4, 1.05, 138, 614, 64, True, launch=8.0, usd=1.80),
        # ----- unseen (held-out hardware) -------------------------------
        _mk("tpu-v6e", "v6e", 8, 1.45, 918, 1640, 160, False, launch=5.0, usd=2.70),    # H800-like: bw-starved
        _mk("tpu-v5e-16", "v5e", 16, 0.94, 197, 819, 128, False, launch=6.0, usd=1.20),
        _mk("tpu-v4-turbo", "v4", 8, 1.30, 340, 1228, 128, False, launch=7.5, usd=3.80),
        _mk("tpu-v6e-lite", "v6e", 4, 1.45, 459, 820, 96, False, launch=5.5, usd=1.55),
        _mk("tpu-v7p", "v7", 8, 1.90, 1250, 3280, 256, False, links=6, launch=4.5, usd=6.80),  # extrapolation
    ]
}


def seen_hw() -> list[TPUSpec]:
    return [s for s in REGISTRY.values() if s.seen]


def unseen_hw() -> list[TPUSpec]:
    return [s for s in REGISTRY.values() if not s.seen]


def get_hw(name: str) -> TPUSpec:
    return REGISTRY[name]
