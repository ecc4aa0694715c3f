"""Work of one launch of the vocoder's transposed-convolution kernel
(`kernels/upsampler.py::phase_convtranspose`) from (B, t_in, Cin) to (B,
t_out, Cout) with k taps: every input row meets every tap, 2 B t_in Cin
Cout k operations; x, the weight and the bias read and y written once in
bf16."""

COUNTER = "phase_convtranspose"


def work(b: int, t_in: int, t_out: int, cin: int, cout: int, k: int) -> dict:
    return {"flops": 2 * b * t_in * cin * cout * k,
            "bytes": 2 * (b * t_in * cin + b * t_out * cout + k * cin * cout + cout),
            "exp2": 0}
