"""Published peak device-memory bandwidth per device, and byte counts.

Every benchmark record reports achieved bytes/s and its share of the
card's published peak. The reference's implicit roofline is the RTX 3060
Ti's 448 GB/s (BASELINE.md: its best histogram hits ~277 GB/s ≈ 62% of
peak). A device missing from the table is an error, not a default: a
share against a guessed peak would read as a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax

# device_kind -> (peak device-memory GB/s, source)
PEAK_HBM_GBPS = {
    "NVIDIA H200": (4800.0, "NVIDIA H200 Tensor Core GPU data sheet, SXM"),
}


@dataclass(frozen=True)
class Roofline:
    device_kind: str
    hbm_gbps: float            # published peak
    source: str = ""

    def fraction(self, bytes_moved: int, seconds: float) -> float:
        """Fraction of the peak achieved by moving bytes_moved in seconds."""
        return (bytes_moved / seconds) / (self.hbm_gbps * 1e9)

    def light_speed_s(self, bytes_moved: int) -> float:
        """Minimum possible seconds to move bytes_moved at peak bandwidth."""
        return bytes_moved / (self.hbm_gbps * 1e9)


def lookup(device_kind: str) -> Roofline:
    """The table entry for `device_kind`; KeyError if it has none."""
    try:
        gbps, source = PEAK_HBM_GBPS[device_kind]
    except KeyError:
        raise KeyError(f"no published peak bandwidth for device kind "
                       f"{device_kind!r}; known: {sorted(PEAK_HBM_GBPS)}"
                       ) from None
    return Roofline(device_kind, gbps, source)


def detect(device=None) -> Roofline:
    """Roofline of `device` (default: the first JAX device)."""
    return lookup((device or jax.devices()[0]).device_kind)


def sort_pass_bytes(n: int, key_bytes: int = 4, value_bytes: int = 0) -> int:
    """Bytes one LSD radix pass must move at minimum: read keys(+values) for
    the histogram, read again for the scatter, write once."""
    row = key_bytes + value_bytes
    return n * (key_bytes + 2 * row)


def sort_bytes(n: int, r: int, key_bytes: int = 4, value_bytes: int = 0) -> int:
    """Light-speed total bytes for a full 32-bit LSD sort with r-bit digits."""
    passes = (32 + r - 1) // r
    return passes * sort_pass_bytes(n, key_bytes, value_bytes)
