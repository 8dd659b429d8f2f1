"""Published peaks of the card and the byte counts of the kernels whose
roofline share the benchmark reports."""

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth (dense peaks at 700 W).
HBM_BYTES_PER_S = 3.35e12

HAMMING_KERNEL = "hamming_mma_kernel"  # csrc/hamming.cu's __global__ function


def hamming_bytes(nq: int, nt: int) -> int:
    """Least bytes a (nq, nt) Hamming matrix moves: each 32-byte descriptor
    of both sets read once, the int32 matrix written once."""
    return 32 * (nq + nt) + 4 * nq * nt


def hamming_bound_s(nq: int, nt: int) -> float:
    """Byte-bound time of one (nq, nt) launch at the card's HBM peak (its
    operations, 256-bit XOR-popcounts on the tensor cores, bound it far
    less)."""
    return hamming_bytes(nq, nt) / HBM_BYTES_PER_S
