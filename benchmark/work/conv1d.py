"""Work of the vocoder's resblock convolution kernels (`kernels/conv1d.py`)
at (B, T, C), kernel size k, in bf16. A pair (`conv1d_fused_pair`: two
convolutions of k taps in one call) reads x and both weights and writes h
(kept for the backward) and y; a single convolution (`conv1d_fused`) reads
x, its weight and the residual where there is one and writes y."""

COUNTERS = ("conv1d_fused_pair", "conv1d_fused")


def pair(b: int, t: int, c: int, k: int) -> dict:
    return {"flops": 2 * 2 * b * t * c * c * k,
            "bytes": 2 * (3 * b * t * c + 2 * k * c * c + 2 * c), "exp2": 0}


def single(b: int, t: int, c: int, k: int, residual: bool) -> dict:
    return {"flops": 2 * b * t * c * c * k,
            "bytes": 2 * ((3 if residual else 2) * b * t * c + k * c * c + c), "exp2": 0}
