"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A share of a roofline is stated
against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12          # HBM3
FP32_FLOP_PER_S = 67e12            # FP32 outside the tensor cores


def bound_s(moved_bytes: float, ops: float, ops_per_s: float) -> float:
    """The least time on the card: the larger of the bytes' and the
    operations' times."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / ops_per_s)
