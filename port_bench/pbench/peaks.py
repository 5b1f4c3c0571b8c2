"""Published peaks of the chips the benchmark runs on, and the operation
and byte counts of the kernels whose roofline share it reports."""

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates: HBM
# bandwidth in bytes/s.  At a power limit under 700 W the card runs
# slower under load; the share is stated against this peak all the same.
H100_HBM_BYTES_PER_S = 3.35e12


def k1_bytes(batch: int) -> int:
    """Bytes one launch of K1 (the fused 16x16 DCT + quantizer,
    ``fused_txq16``) must move at batch ``batch``: each block's int32
    residual read once (1,024 B) and its three int32 outputs written once
    (3,072 B), plus the two float32 16x16 matrices (2,048 B) and the ten
    int32 quantizer constants (40 B) read once."""
    return 4096 * int(batch) + 2088


def k1_bound_s(batch: int) -> float:
    """The least time a launch at ``batch`` can take: K1 is bound by
    memory (about 4 FLOP a byte against the card's 20 a byte in
    float32)."""
    return k1_bytes(batch) / H100_HBM_BYTES_PER_S
