"""NVIDIA H100 SXM peaks (data sheet, dense, at 700 W). Fixed here: a
yardstick that an environment variable could move is no yardstick."""

PEAK_TF32 = 495e12           # TF32 on the tensor cores, FLOP/s
PEAK_3XTF32 = PEAK_TF32 / 3  # float32 products as three TF32 ones
PEAK_BYTES = 3.35e12         # HBM3, bytes/s


def roofline_share(ops: float, nbytes: float, seconds: float) -> float:
    """The least time the work could take on the card (the larger of
    operations over the 3xTF32 peak and bytes over the HBM peak) over the
    time it took, in percent."""
    return 100.0 * max(ops / PEAK_3XTF32, nbytes / PEAK_BYTES) / seconds


def mfu(flops: float, seconds: float) -> float:
    """Counted operations over the time against the 3xTF32 peak, in
    percent."""
    return 100.0 * flops / seconds / PEAK_3XTF32
