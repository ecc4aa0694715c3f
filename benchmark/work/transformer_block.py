"""Work of one launch of the fused transformer block kernel
(`kernels/transformer_block.py`, self-attention mode) at (B, T, C), head
width 8: what the kernel itself computes, since the wrapper projects K and
V with cuBLAS before it. Operations: the q projection, QK^T and PV, the
out-projection, the GEGLU feed-forward (C -> 8C, 4C -> C). Bytes: x, K and
V read, the output written, the projections' weights read once, in bf16.
Exponentials: one per logit, B * heads * T^2."""

COUNTER = "fused_transformer_block"


def work(b: int, t: int, c: int, head_dim: int = 8) -> dict:
    heads = c // head_dim
    flops = 2 * b * t * c * c * (1 + 1 + 8 + 4) + 4 * b * t * t * c
    nbytes = 2 * (4 * b * t * c + 14 * c * c + 12 * c)
    return {"flops": flops, "bytes": nbytes, "exp2": b * heads * t * t}
