"""CPU parity of the port's four kernel functions against the JAX package.

On the CPU both sides take their plain versions: the JAX functions reach
`_reference_block`, `_conv1d_reference`, `_pair_reference` and `_native_ct`
(with their custom VJPs), the port's wrappers their plain PyTorch versions
(with their autograd Functions). Inputs come from a numpy seed, in fp32.

Tolerances: forward 1e-5 of max |reference|. Input gradients 1e-4 against
JAX; the vocoder kernels' gradients are also held at 1e-6 against a float64
autograd oracle, because the JAX CPU dilated-conv adjoint is itself off at
halo edges under the 8-device CPU platform the test suite runs.

The kernels themselves run only on a card: `test_torch_port_cuda.py`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmusic_tpu.pallas import conv1d_kernel as jconv
from diffmusic_tpu.pallas import transformer_kernel as jtb
from diffmusic_tpu.pallas import upsampler_kernel as jup
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import conv1d as tconv
from diffmusic_tpu_torch.kernels import transformer_block as ttb
from diffmusic_tpu_torch.kernels import upsampler as tup

SLOPE = 0.1


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t64(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def block_params(rng, c):
    s = 1.0 / math.sqrt(c)
    return dict(ln1_scale=1 + arr(rng, c, scale=0.1), ln1_bias=arr(rng, c, scale=0.1),
                wq=arr(rng, c, c, scale=s), wk=arr(rng, c, c, scale=s),
                wv=arr(rng, c, c, scale=s), wo=arr(rng, c, c, scale=s),
                bo=arr(rng, c, scale=0.1), ln3_scale=1 + arr(rng, c, scale=0.1),
                ln3_bias=arr(rng, c, scale=0.1), wi=arr(rng, c, 8 * c, scale=s),
                bi=arr(rng, 8 * c, scale=0.1), wo2=arr(rng, 4 * c, c, scale=0.5 * s),
                bo2=arr(rng, c, scale=0.1))


@pytest.mark.parametrize("b,t,c", [(1, 520, 16), (2, 77, 32)])
def test_transformer_block_matches_jax(rng, b, t, c):
    heads = c // 8
    x = arr(rng, b, t, c)
    p = block_params(rng, c)
    g = arr(rng, b, t, c)
    jout, jvjp = jax.vjp(lambda x_: jtb.fused_transformer_block(
        x_, {k: jnp.asarray(v) for k, v in p.items()}, heads, 8), jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ttb.fused_transformer_block(xt, {k: torch.from_numpy(v) for k, v in p.items()},
                                      heads, 8)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert rel(out.detach(), jout) <= 1e-5
    assert rel(dx, jdx) <= 1e-4


def conv_oracle(x, w, b, dilation, residual, g):
    """float64 autograd of leaky -> 'same' conv1d [+ residual]: (y, dx)."""
    xx = t64(x).requires_grad_(True)
    y = tconv.conv1d_plain(xx, t64(w), t64(b), dilation, SLOPE,
                           None if residual is None else t64(residual))
    (dx,) = torch.autograd.grad(y, xx, t64(g))
    return y.detach(), dx


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_conv1d_fused_matches_jax(rng, k, dilation, with_residual):
    x = arr(rng, 2, 37, 16)
    w = arr(rng, k, 16, 24, scale=1.0 / math.sqrt(16 * k))
    b = arr(rng, 24, scale=0.1)
    r = arr(rng, 2, 37, 24) if with_residual else None
    g = arr(rng, 2, 37, 24)

    def jf(x_, r_):
        return jconv.conv1d_fused(x_, jnp.asarray(w), jnp.asarray(b), r_, dilation, SLOPE,
                                  with_residual)
    jy, jvjp = jax.vjp(jf, jnp.asarray(x), None if r is None else jnp.asarray(r))
    jdx = jvjp(jnp.asarray(g))[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = None if r is None else torch.from_numpy(r).requires_grad_(True)
    y = kernels.conv1d.conv1d_fused(xt, torch.from_numpy(w), torch.from_numpy(b), rt,
                                    dilation, SLOPE)
    grads = torch.autograd.grad(y, [xt] + ([rt] if rt is not None else []),
                                torch.from_numpy(g))
    assert rel(y.detach(), jy) <= 1e-5
    assert rel(grads[0], jdx) <= 1e-4
    oy, odx = conv_oracle(x, w, b, dilation, r, g)
    assert rel(y.detach(), oy) <= 1e-6
    assert rel(grads[0], odx) <= 1e-6
    if rt is not None:
        assert torch.equal(grads[1], torch.from_numpy(g))


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_conv1d_fused_pair_matches_jax(rng, k, dilation):
    c = 16
    x = arr(rng, 2, 41, c)
    w1 = arr(rng, k, c, c, scale=1.0 / math.sqrt(c * k))
    w2 = arr(rng, k, c, c, scale=1.0 / math.sqrt(c * k))
    b1, b2 = arr(rng, c, scale=0.1), arr(rng, c, scale=0.1)
    g = arr(rng, 2, 41, c)
    jy, jvjp = jax.vjp(lambda x_: jconv.conv1d_fused_pair(
        x_, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2), dilation,
        SLOPE), jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tconv.conv1d_fused_pair(xt, *map(torch.from_numpy, (w1, b1, w2, b2)), dilation, SLOPE)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert rel(y.detach(), jy) <= 1e-5
    assert rel(dx, jdx) <= 1e-4
    # float64 oracle: autograd through the two plain convs
    x64 = t64(x).requires_grad_(True)
    oy = tconv.conv1d_plain(tconv.conv1d_plain(x64, t64(w1), t64(b1), dilation, SLOPE),
                            t64(w2), t64(b2), 1, SLOPE, residual=x64)
    (odx,) = torch.autograd.grad(oy, x64, t64(g))
    assert rel(y.detach(), oy.detach()) <= 1e-6
    assert rel(dx, odx) <= 1e-6


@pytest.mark.parametrize("cin,cout,k,stride,t_in", [
    (32, 16, 16, 5, 13),      # ragged: the 1000 -> 5001 geometry, odd length
    (16, 8, 16, 4, 20),
    (16, 8, 8, 2, 21),
])
def test_phase_convtranspose_matches_jax(rng, cin, cout, k, stride, t_in):
    x = arr(rng, 2, t_in, cin)
    w = arr(rng, k, cin, cout, scale=1.0 / math.sqrt(cout * k))
    b = arr(rng, cout, scale=0.1)
    t_out = tup.output_length(t_in, stride, k)
    g = arr(rng, 2, t_out, cout)
    jy, jvjp = jax.vjp(lambda x_: jup.phase_convtranspose(
        x_, jnp.asarray(w), jnp.asarray(b), stride, k, t_out, slope=SLOPE), jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tup.phase_convtranspose(xt, torch.from_numpy(w), torch.from_numpy(b), stride, k,
                                t_out, SLOPE)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert y.shape == (2, t_out, cout) == jy.shape
    assert rel(y.detach(), jy) <= 1e-5
    assert rel(dx, jdx) <= 1e-4
    x64 = t64(x).requires_grad_(True)
    oy = tup.convtranspose_plain(torch.nn.functional.leaky_relu(x64, SLOPE), t64(w), t64(b),
                                 stride, k)
    (odx,) = torch.autograd.grad(oy, x64, t64(g))
    assert rel(dx, odx) <= 1e-6


def test_tap_range_covers_every_tap():
    """Every kernel tap j lands in exactly one phase at an offset inside the
    window [d_lo, d_hi] the CUDA kernel stages."""
    for k, s in ((16, 5), (16, 4), (8, 2), (4, 2)):
        p_ct = (k - s) // 2
        d_lo, d_hi = tup._tap_range(k, s)
        for j in range(k):
            rho = (j - p_ct) % s
            d, rem = divmod(rho + p_ct - j, s)
            assert rem == 0 and d_lo <= d <= d_hi


def test_routing_rules_match_jax():
    for k, c in ((3, 512), (7, 512), (11, 512), (11, 256), (11, 128), (3, 64)):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            itemsize = jnp.dtype(jdt).itemsize
            want = c % 128 == 0 and 2 * k * c * c * itemsize / 2 ** 20 <= 9.0
            assert tconv.pair_ok(k, c, c, dt) == want
    assert tconv.pair_ok(7, 512, 512, torch.bfloat16)
    assert not tconv.pair_ok(7, 512, 512, torch.float32)
    for cin, cout in ((1024, 512), (512, 256), (256, 128), (128, 64), (64, 32)):
        assert tup.phase_ct_ok(cin, cout) == (cout >= 128)


def test_plain_versions_do_not_count_launches(rng):
    kernels.reset_launch_counts()
    x = torch.from_numpy(arr(rng, 1, 9, 16))
    w = torch.from_numpy(arr(rng, 3, 16, 16))
    b = torch.zeros(16)
    tconv.conv1d_fused(x, w, b, None, 1, SLOPE)
    tconv.conv1d_fused_pair(x, w, b, w, b, 1, SLOPE)
    assert all(v == 0 for v in kernels.launch_counts().values())
    with pytest.raises(ValueError):
        tconv.conv1d_fused(x.to("meta"), w.to("meta"), b.to("meta"), None, 1, SLOPE)
