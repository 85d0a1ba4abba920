"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Copied from ``chip_smoke.py:262``
(HBM_BYTES_PER_S, BF16_FLOPS_PER_S, FP32_FLOPS_PER_S)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(flops: float, n_bytes: float,
                  flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time the card could take: the larger of the operation
    bound and the byte bound."""
    return max(flops / flops_per_s, n_bytes / HBM_BYTES_PER_S)
