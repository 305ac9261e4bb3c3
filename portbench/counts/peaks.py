"""Published peaks of the cards the benchmark runs on, and the roofline
arithmetic.

NVIDIA's H100 data sheet, dense rates without sparsity: the SXM part 989
TFLOP/s in bf16 and 3.35 TB/s of HBM3, the PCIe part 756 TFLOP/s and 2.0
TB/s. The rates assume the card's full power limit; the benchmark reports
the limit beside every share. No environment variable overrides the table.
"""

from __future__ import annotations

from typing import Optional, Tuple

# (substring of torch.cuda.get_device_name, lowercased; bf16 FLOP/s; bytes/s),
# most specific first
PEAKS = (
    ("h100 pcie", 756e12, 2.0e12),
    ("h100", 989e12, 3.35e12),
)


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, bytes/s) of the named card, or None if not in the table."""
    name = device_name.lower()
    for sub, flops, bw in PEAKS:
        if sub in name:
            return flops, bw
    return None


def bound_seconds(flops: float, nbytes: float, device_name: str) -> float:
    """The least time the card could take: the larger of operations over
    peak FLOP/s and bytes over peak bandwidth."""
    p = peaks(device_name)
    if p is None:
        raise ValueError(f"no published peak for {device_name!r}")
    return max(flops / p[0], nbytes / p[1])
