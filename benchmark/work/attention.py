"""Work of one launch of the flash attention kernel (`kernels/attention.py`)
over (B, T, heads, D): QK^T and PV, 4 B heads T^2 D operations; q, k, v read
and o written once in bf16; one exponential per logit."""

COUNTER = "flash_attention"


def work(b: int, t: int, heads: int, d: int) -> dict:
    return {"flops": 4 * b * heads * t * t * d, "bytes": 2 * 4 * b * t * heads * d,
            "exp2": b * heads * t * t}
