"""Per-kernel speed-of-light roofline accounting.

The north-star spec asks for roofline accounting per kernel
(BASELINE.json). For the tile-pair numeric step:

  useful FLOPs      = 2 * nnzCub                  (the reference's GFLOPS base)
  executed FLOPs    = 2 * num_pairs * tm * tk * tn  in f32, plus the same
                      again in bf16 for the occupancy pass
  bytes (min)       = pair-streamed A+B tiles + C tiles written once

Speed-of-light time = max(flop time at the peaks, bytes / peak bandwidth).
Peaks come from one table keyed by the device's `device_kind`; a device
that is not in it is an error, not a default.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_f32: float   # FLOP/s outside the tensor cores
    peak_flops_tf32: float  # FLOP/s, tensor cores, dense
    peak_flops_bf16: float  # FLOP/s, tensor cores, dense
    peak_hbm_bw: float      # bytes/s


# NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
# full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipSpec("NVIDIA H100 80GB HBM3", 67e12,
                                      495e12, 989e12, 3.35e12),
}


def chip_spec(device_kind: str) -> ChipSpec:
    """Published peaks of the device JAX reports as `device_kind`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak table entry for device kind {device_kind!r}; add "
            "its published rates to utils/roofline.py:PEAKS") from None


@dataclasses.dataclass
class RooflineReport:
    executed_flops: float
    useful_flops: float
    bytes_moved: float
    sol_time_ms: float        # speed-of-light
    attained_ms: float | None
    efficiency: float | None  # sol / attained

    def summary(self) -> str:
        s = (
            f"executed {self.executed_flops/1e9:.2f} GFLOP "
            f"(useful {self.useful_flops/1e9:.2f}), "
            f"{self.bytes_moved/1e6:.1f} MB, SoL {self.sol_time_ms:.3f} ms"
        )
        if self.attained_ms is not None:
            s += (
                f", attained {self.attained_ms:.3f} ms "
                f"({100*(self.efficiency or 0):.1f}% of SoL)"
            )
        return s


def numeric_step_roofline(
    num_pairs: int,
    tm: int,
    tk: int,
    tn: int,
    nnz_cub: int,
    nt_c: int,
    chip: ChipSpec,
    attained_ms: float | None = None,
    bytes_per_elem: int = 4,
    with_occupancy_pass: bool = True,
) -> RooflineReport:
    mults = num_pairs * tm * tk * tn
    executed = 2.0 * mults * (2 if with_occupancy_pass else 1)
    useful = 2.0 * nnz_cub
    # minimum traffic: every pair streams one A and one B tile (x2 with
    # the packed occupancy plane), C written + read once per accumulation
    a_b_bytes = num_pairs * (tm * tk + tk * tn) * bytes_per_elem
    if with_occupancy_pass:
        a_b_bytes *= 2
    c_bytes = 2 * nt_c * tm * tn * bytes_per_elem * (
        2 if with_occupancy_pass else 1
    )
    total_bytes = a_b_bytes + c_bytes
    flop_s = 2.0 * mults / chip.peak_flops_f32
    if with_occupancy_pass:
        flop_s += 2.0 * mults / chip.peak_flops_bf16
    sol_s = max(flop_s, total_bytes / chip.peak_hbm_bw)
    eff = None
    if attained_ms is not None and attained_ms > 0:
        eff = (sol_s * 1e3) / attained_ms
    return RooflineReport(
        executed_flops=executed,
        useful_flops=useful,
        bytes_moved=total_bytes,
        sol_time_ms=sol_s * 1e3,
        attained_ms=attained_ms,
        efficiency=eff,
    )
