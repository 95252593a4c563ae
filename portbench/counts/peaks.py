"""Published peaks of one NVIDIA H100 SXM and the roofline arithmetic.

Dense rates without sparsity, from NVIDIA's data sheet; they assume the
full 700 W power limit. Copied from the repository's chip smoke
(``PEAK_BF16``, ``PEAK_F32``, ``PEAK_BYTES``, ``bound``).
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16 = 989e12   # bf16 FLOP/s on the tensor cores
PEAK_F32 = 67e12     # float32 FLOP/s outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound(flops: float, nbytes: float, peak_flops: float) -> Tuple[float, str]:
    """(least seconds, what bounds it) for ``flops`` at ``peak_flops`` and
    ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
