"""CPU parity of the VAE mid-block's flash route and of the two kernel
adjoint routes against the JAX package.

- `flash_attention` at the head widths 32-512 (its plain version on the CPU)
  against the JAX Pallas kernel in interpret mode (`_INTERPRET`), forward and
  gradient; T = 300 exercises JAX's padding to its 256-row query blocks.
  `emulate_wide` (`flash_wide_emulation.py`), a torch replica of the bf16
  kernel's key splits, chunks and log-sum-exp combine, against the plain
  attention and JAX's kernel, with short and empty splits; `wide_splits`
  against the host's rule. The
  `bwd="bf16"` backward (`attention_bwd_bf16`) against JAX's
  `_bwd_attention_bf16` on bf16 inputs.
- The tiny VAE (mid-block 32 channels) decoding latents (1, 8, 32, 16), so
  that the mid-block's T is 512 and D is 32: the port with
  `vae_mid_attn="flash"` against JAX under `DIFFMUSIC_TPU_VAE_MID_ATTN=flash`
  in interpret mode, the weights carried by `models/convert.py`, the output
  and the gradient of a scalar loss with respect to the latents, under each
  backward form (JAX's `DIFFMUSIC_TPU_FLASH_BWD`, which its module reads at
  import, is set on the module as `_BWD_IMPL` too).
- The conv2d adjoint route (`conv2d_bwd="kernel"`) against JAX under
  `DIFFMUSIC_TPU_CONV2D_BWD=pallas` at 128 -> 128 channels, (8, 64), and the
  conv1d adjoint route (`adjoint_kernel`) against JAX's with the
  pre-transposed kernel (`with_adjoint_weights`' `w_adj`) at 128 channels, T
  128, both in interpret mode.
- Planted faults and launch paths: with "plain" the VAE never calls
  `flash_attention`; on a tensor the wrappers take for a CUDA one (a stand-in
  library on the meta device) the adjoint backwards launch the kernels with
  the cached adjoint operands, once per weight, and a full-width VAE decode
  and vocoder give the launches `chip_smoke.py` expects of its turns.

Inputs come from a numpy seed, fp32 unless a test says otherwise. No JAX
pipeline is compiled. Tolerances, as a fraction of max |reference|: 1e-5
for the attention (the same fp32 sums in another order), 1e-4 for the VAE's
output and gradient (a chain of fp32 convs and GroupNorms in another order),
2e-2 for the bf16 backward (one bf16 rounding of P or dS moves a product by
~2^-8), 1e-5 for the adjoint convs.
"""

import contextlib
import dataclasses
import math
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import diffmusic_tpu.pallas.attention_kernel as jak
import test_torch_port_snapshot as snap
import diffmusic_tpu.pallas.conv1d_kernel as jck1
import diffmusic_tpu.pallas.conv2d_kernel as jck2
from diffmusic_tpu.models import configs as jcfg
from diffmusic_tpu.models.vae import AutoencoderKL as JVAE
from diffmusic_tpu_torch import kernels
from diffmusic_tpu_torch.kernels import attention as tattn
from diffmusic_tpu_torch.kernels import build
from diffmusic_tpu_torch.kernels import conv1d as tconv1d
from diffmusic_tpu_torch.kernels import conv2d as tconv2d
from diffmusic_tpu_torch.kernels import repack
from diffmusic_tpu_torch.models import configs as tcfg
from diffmusic_tpu_torch.models import layers as tlayers
from diffmusic_tpu_torch.models.convert import from_flax
from diffmusic_tpu_torch.models.hifigan import SpeechT5HifiGan
from diffmusic_tpu_torch.models.vae import AutoencoderKL
from diffmusic_tpu_torch.pipelines import MusicLDMPipeline
from flash_wide_emulation import H100_SMS, emulate_wide
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

SLOPE = 0.1
VAE = jcfg.tiny_vae_config()
LATENTS = (1, 8, 32, 16)   # the tiny VAE's mid-block: T = 32 * 16 = 512, D = 32


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ------------------------------------------------------------------ the kernel
@pytest.mark.parametrize("shape", [(1, 300, 1, 512), (1, 512, 1, 32)], ids=str)
def test_flash_wide_matches_jax_kernel(monkeypatch, rng, shape):
    monkeypatch.setattr(jak, "_INTERPRET", True)
    q, k, v, g = (arr(rng, *shape) for _ in range(4))
    jout, vjp = jax.vjp(jak.flash_attention, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    qkv = [t32(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention(*qkv)
    grads = torch.autograd.grad(out, qkv, t32(g))
    assert tattn.wide_ok(shape[-1])
    assert rel(out.detach(), jout) <= 1e-5
    for ours, theirs in zip(grads, jgrads):
        assert rel(ours, theirs) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 300, 1, 512), (2, 77, 2, 96)], ids=str)
def test_emulated_wide_kernel_matches_plain_and_jax(monkeypatch, rng, shape):
    """The kernel's tiling (key splits by `wide_splits`, 64-key chunks,
    ragged last chunk, the splits' log-sum-exp combine) with P in fp32
    against the plain attention (1e-5), and with P rounded to bf16 on
    bf16-rounded inputs against JAX's kernel in bf16 in interpret mode (2e-2:
    JAX rounds P against the full row's max)."""
    monkeypatch.setattr(jak, "_INTERPRET", True)
    q, k, v = (t32(arr(rng, *shape)).bfloat16().float() for _ in range(3))
    out = emulate_wide(q, k, v, p_bf16=False)
    assert rel(out, tattn.attention_plain(q, k, v)) <= 1e-5
    jq, jk, jv = (jnp.asarray(a.numpy(), jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jak.flash_attention(jq, jk, jv).astype(jnp.float32))
    assert rel(emulate_wide(q, k, v, p_bf16=True).bfloat16().float(), ref) <= 2e-2


@pytest.mark.parametrize("t,splits", [(40, 4), (20, 2), (65, 2), (40, 8)], ids=str)
def test_emulated_wide_kernel_short_and_empty_splits(rng, t, splits):
    """Splits that hold fewer keys than one chunk or none (m = -inf, l = 0):
    they weigh nothing and give no NaN; P in fp32 against the plain attention
    (1e-5), and P in bf16 finite."""
    chunks = -(-t // tattn.WIDE_KEY_CHUNK)
    sizes = [min(t, chunks * (s + 1) // splits * tattn.WIDE_KEY_CHUNK)
             - min(t, chunks * s // splits * tattn.WIDE_KEY_CHUNK) for s in range(splits)]
    assert min(sizes) < tattn.WIDE_KEY_CHUNK and sum(sizes) == t
    q, k, v = (t32(arr(rng, 1, t, 1, 64)).bfloat16().float() for _ in range(3))
    out = emulate_wide(q, k, v, p_bf16=False, splits=splits)
    assert torch.isfinite(out).all()
    assert rel(out, tattn.attention_plain(q, k, v)) <= 1e-5
    assert torch.isfinite(emulate_wide(q, k, v, p_bf16=True, splits=splits)).all()


def test_wide_splits_follow_the_host_rule():
    """`wide_splits` takes the SM count and gives what `wide::splits_for`
    gives on the host: at 132 SMs, T 4000 -> 63 tiles x 2 splits (126
    blocks; 4 would make 252), T 333 -> 6 tiles x 2 (6 chunks: 4 splits would
    keep fewer than two each), T 40 -> 1 (one chunk); fewer SMs split less,
    more split more. The constants are the C++ source's."""
    assert [tattn.wide_splits(1, t, 1, H100_SMS) for t in (4000, 333, 40)] == [2, 2, 1]
    assert tattn.wide_splits(1, 512, 1, H100_SMS) == 4
    assert tattn.wide_splits(1, 4000, 1, 64) == 1
    assert tattn.wide_splits(1, 4000, 1, 264) == 4
    src = (Path(tattn.__file__).parent / "csrc" / "flash_attention.cu").read_text()
    wide = src[src.index("namespace wide {"):]
    for name, value in (("ROWS", tattn.WIDE_ROWS), ("WKC", tattn.WIDE_KEY_CHUNK),
                        ("MIN_CHUNKS", tattn.WIDE_MIN_CHUNKS),
                        ("MAX_SPLITS", tattn.WIDE_MAX_SPLITS)):
        assert re.search(rf"constexpr int {name} = {value};", wide), name
    assert ("while (n < MAX_SPLITS && blocks * n * 2 <= sms && chunks >= MIN_CHUNKS * n * 2)"
            in wide)


def test_bf16_backward_form_matches_jax(rng):
    """`attention_bwd_bf16` against `_bwd_attention_bf16` on bf16 inputs: P
    and dS rounded to bf16 at the same places."""
    shape = (1, 300, 1, 64)
    q, k, v, g = (jnp.asarray(arr(rng, *shape), jnp.bfloat16) for _ in range(4))
    want = jak._bwd_attention_bf16(q, k, v, g, 1.0 / math.sqrt(shape[-1]))
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                      for a in (q, k, v, g))
    got = tattn.attention_bwd_bf16(tq, tk, tv, tg)
    for ours, theirs in zip(got, want):
        assert ours.dtype == torch.bfloat16
        assert rel(ours.float(), np.asarray(theirs.astype(jnp.float32))) <= 2e-2


def test_flash_rejects_unknown_backward_form(rng):
    q = t32(arr(rng, 1, 8, 1, 32))
    with pytest.raises(ValueError, match="bwd"):
        tattn.flash_attention(q, q, q, bwd="f16")


# ------------------------------------------------------------- the VAE's route
@pytest.fixture(scope="module")
def vae_params():
    return jax.jit(JVAE(VAE).init)(jax.random.key(3), jnp.zeros((1, 1, 64, 32)))


def port_vae(params, **routes):
    pcfg = tcfg.VAEConfig(**dataclasses.asdict(VAE))
    model = AutoencoderKL(pcfg, **routes)
    model.load_state_dict(from_flax(params, pcfg), strict=True)
    return model


@pytest.mark.parametrize("flash_bwd", ["f32", "bf16"])
def test_vae_decode_with_flash_mid_block_matches_jax(monkeypatch, rng, vae_params, flash_bwd):
    monkeypatch.setenv("DIFFMUSIC_TPU_VAE_MID_ATTN", "flash")
    monkeypatch.setenv("DIFFMUSIC_TPU_FLASH_BWD", flash_bwd)
    monkeypatch.setattr(jak, "_BWD_IMPL", flash_bwd)
    monkeypatch.setattr(jak, "_INTERPRET", True)
    jcalls = Counter()
    jfa = jak.flash_attention
    monkeypatch.setattr(jak, "flash_attention",
                        lambda *a: jcalls.update(["flash"]) or jfa(*a))
    z, probe = arr(rng, *LATENTS), arr(rng, 1, 1, 64, 32)
    jvae = JVAE(VAE)
    jy, vjp = jax.vjp(lambda z_: jvae.apply(vae_params, z_, method=JVAE.decode),
                      jnp.asarray(z))
    (jdz,) = vjp(jnp.asarray(probe))
    assert jcalls["flash"] > 0           # the JAX route reached its Pallas kernel

    calls = Counter()
    fa = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda *a, **kw: calls.update([a[-1]]) or fa(*a, **kw))
    vae = port_vae(vae_params, vae_mid_attn="flash", flash_bwd=flash_bwd)
    zt = t32(z).requires_grad_(True)
    y = vae.decode(zt)
    (dz,) = torch.autograd.grad(y, zt, t32(probe))
    assert calls == {flash_bwd: 1}
    assert rel(y.detach(), jy) <= 1e-4
    assert rel(dz, jdz) <= 1e-4


def test_flash_route_reaches_the_block(monkeypatch, rng, vae_params):
    """Planted fault: the flag must reach both mid-blocks. With "plain" the
    VAE never calls `flash_attention`; with "flash" its decode and its encode
    (mel (1, 1, 64, 32): the encoder's mid-block also sees T = 512) each call
    it once, and give the plain route's result."""
    calls = Counter()
    fa = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda *a, **kw: calls.update(["flash"]) or fa(*a, **kw))
    z, mel = t32(arr(rng, *LATENTS)), t32(arr(rng, 1, 1, 64, 32))
    out = {}
    for route in ("plain", "flash"):
        vae = port_vae(vae_params, vae_mid_attn=route)
        with torch.no_grad():
            out[route] = (vae.decode(z), vae.encode(mel))
        assert calls["flash"] == (0 if route == "plain" else 2), (route, calls)
    for a, b in zip(out["flash"], out["plain"]):
        assert rel(a, b) <= 1e-5
    with pytest.raises(ValueError, match="vae_mid_attn"):
        AutoencoderKL(tcfg.VAEConfig(**dataclasses.asdict(VAE)), vae_mid_attn="xla")


# ---------------------------------------------------------- the adjoint routes
def test_conv2d_adjoint_route_matches_jax(monkeypatch, rng):
    monkeypatch.setattr(jck2, "_INTERPRET", True)
    monkeypatch.setenv("DIFFMUSIC_TPU_CONV2D_BWD", "pallas")
    b, h, w, c = 1, 8, 64, 128
    x, g = arr(rng, b, h, w, c), arr(rng, b, h, w, c)
    wt = arr(rng, 3, 3, c, c, scale=1.0 / math.sqrt(9 * c))            # HWIO
    bias = arr(rng, c, scale=0.1)
    jy, vjp = jax.vjp(lambda x_: jck2.conv2d_same_fused(x_, jnp.asarray(wt), jnp.asarray(bias)),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    xt = nchw(x).requires_grad_(True)
    w_oihw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    y = tconv2d.conv2d_same(xt, w_oihw, t32(bias), bwd="kernel")
    (dx,) = torch.autograd.grad(y, xt, nchw(g))
    assert tconv2d.conv2d_ok(nchw(g), tconv2d.adjoint_weight(w_oihw))   # the route's rule
    assert rel(y.detach().permute(0, 2, 3, 1), jy) <= 1e-5
    assert rel(dx.permute(0, 2, 3, 1), jdx) <= 1e-5


def test_conv1d_adjoint_route_matches_jax(monkeypatch, rng):
    monkeypatch.setattr(jck1, "_INTERPRET", True)
    t, c, k, d = 128, 128, 3, 3
    x, g = arr(rng, 1, t, c), arr(rng, 1, t, c)
    wt = arr(rng, k, c, c, scale=1.0 / math.sqrt(k * c))
    bias = arr(rng, c, scale=0.1)
    w_adj = jnp.flip(jnp.asarray(wt), axis=0).swapaxes(1, 2)        # with_adjoint_weights
    jy, vjp = jax.vjp(lambda x_: jck1.conv1d_fused(x_, jnp.asarray(wt), jnp.asarray(bias), None,
                                                   d, SLOPE, False, w_adj=w_adj), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = t32(x).requires_grad_(True)
    y = tconv1d.conv1d_fused(xt, t32(wt), t32(bias), None, d, SLOPE, adjoint_kernel=True)
    (dx,) = torch.autograd.grad(y, xt, t32(g))
    assert rel(y.detach(), jy) <= 1e-5
    assert rel(dx, jdx) <= 1e-5


# ------------------------------------------------- the launch paths, on meta
class _FakeLibrary:
    """Stands in for the kernel library on the meta device: every launch
    succeeds and needs no shared memory."""

    def __getattr__(self, name):
        return lambda *a: 0


@contextlib.contextmanager
def meta_launches(monkeypatch):
    """The wrappers take their kernel paths on meta tensors (shape checks,
    counts, meta outputs); nothing runs. The conv1d plans see the meta
    tensors as on one CUDA device."""
    real_fused_plan = tconv1d.fused_plan
    cuda = torch.device("cuda", 0)
    with monkeypatch.context() as mp:
        mp.setattr(build, "library", lambda: _FakeLibrary())
        mp.setattr(build, "check_tensors", lambda *a: None)
        mp.setattr(build, "stream_ptr", lambda device: 0)
        mp.setattr(tconv1d, "fused_plan", lambda name, sh, st, dt, dev, *rest: real_fused_plan(
            name, sh, st, dt, (cuda,) * len(dev), *rest))
        for module in (tattn, tconv1d, tconv2d):
            mp.setattr(module, "use_plain", lambda x, name: False)
        yield


def test_adjoint_backwards_launch_the_kernels_once_per_weight(monkeypatch):
    """On the kernel path the conv2d backward launches the kernel on the
    cotangent with the cached adjoint operands (the flipped, channel-swapped
    weight, its tap-major copy and a zero bias: one entry per weight, made
    in the first backward only), and the conv1d backward the kernel's
    adjoint mode; "plain" launches neither."""
    seen = []
    real_launch = tconv2d._launch
    monkeypatch.setattr(tconv2d, "_launch", lambda *a: seen.append(a) or real_launch(*a))
    w2 = torch.empty(256, 128, 3, 3, device="meta", dtype=torch.bfloat16)
    b2 = torch.empty(256, device="meta", dtype=torch.bfloat16)
    w1 = torch.empty(3, 128, 256, device="meta", dtype=torch.bfloat16)
    with meta_launches(monkeypatch):
        for name in repack.REPACKS:
            repack.REPACKS[name] = 0
        kernels.reset_launch_counts()
        for bwd in ("kernel", "kernel", "plain"):
            x = torch.empty(1, 128, 16, 32, device="meta", dtype=torch.bfloat16,
                            requires_grad=True)
            torch.autograd.grad(tconv2d.conv2d_same(x, w2, b2, bwd=bwd).sum(), x)
        adj = [a for a in seen if len(a) == 5 and a[4] == "conv2d_same_adjoint"]
        assert len(adj) == 2 and adj[0][1] is adj[1][1]
        wa, zero, taps = adj[0][1:4]
        assert tuple(wa.shape) == (128, 256, 3, 3) and wa.is_contiguous()
        assert tuple(taps.shape) == (9, 128, 256) and tuple(zero.shape) == (128,)
        # one adjoint entry, and no tap-major copy of the adjoint weight
        # beside the forward weight's: the launch reads the entry's own
        assert repack.REPACKS["conv2d_adjoint"] == 1 and repack.REPACKS["conv2d_same"] == 1
        for adjoint_kernel in (True, False):
            x = torch.empty(1, 256, 128, device="meta", dtype=torch.bfloat16,
                            requires_grad=True)
            y = tconv1d.conv1d_fused(x, w1, None, None, 3, SLOPE, adjoint_kernel=adjoint_kernel)
            torch.autograd.grad(y.sum(), x)
        counts = kernels.launch_counts()
    assert counts["conv2d_same"] == 3 and counts["conv2d_same_adjoint"] == 2
    assert counts["conv1d_fused"] == 2 and counts["conv1d_fused_adjoint"] == 1
    assert repack.REPACKS["conv1d_adjoint"] == 1


def test_full_width_vae_route_launches(monkeypatch):
    """The full-width VAE decode at the slice's latents with the conv2d
    routes ("stats") and `vae_mid_attn="flash"`, forward and backward on the
    meta device: one flash launch at (1, 4000, 1, 512), the route's conv2d
    launches and, with `conv2d_bwd="kernel"`, as many adjoint launches, the
    counts `chip_smoke.py`'s turns expect."""
    want_conv = chip_smoke.ROUTE_LAUNCHES["vae"]["stats"]["conv2d_same"]
    shapes = []
    fa = tattn._launch
    monkeypatch.setattr(tattn, "_launch", lambda q, k, v: shapes.append(tuple(q.shape))
                        or fa(q, k, v))
    with torch.device("meta"):
        vae = AutoencoderKL(tcfg.VAEConfig(), conv2d_kernel=True, conv2d_bwd="kernel",
                            vae_mid_attn="flash").to(torch.bfloat16)
    with meta_launches(monkeypatch):
        kernels.reset_launch_counts()
        z = torch.empty(chip_smoke.LATENTS, device="meta", dtype=torch.bfloat16,
                        requires_grad=True)
        y = vae.decode(z)
        fwd = dict(kernels.launch_counts())
        torch.autograd.grad(y.sum(), z)
        both = kernels.launch_counts()
    assert shapes == [(1, 4000, 1, 512)]
    assert fwd["flash_attention"] == 1 and fwd["conv2d_same"] == want_conv
    assert both["conv2d_same_adjoint"] == want_conv == chip_smoke.VAE_ADJOINTS_PER_STEP
    assert both["flash_attention"] == 1        # the backward is plain


def test_vocoder_adjoint_flag_reaches_the_single_convs(monkeypatch):
    """`adjoint_kernel` reaches every ResidualBlock; at full width in bf16 the
    backward launches the adjoint for the 6 ch512 k=11 convs and no other."""
    with torch.device("meta"):
        voc = SpeechT5HifiGan(tcfg.HiFiGANConfig(), adjoint_kernel=True).to(torch.bfloat16)
    assert all(m.adjoint_kernel for n, m in voc.named_children() if n.startswith("resblocks"))
    assert chip_smoke.VOCODER_LAUNCHES["adjoint"][1] == {"conv1d_fused_adjoint": 6}


def test_snapshot_loader_and_random_take_the_new_route_flags(tmp_path):
    """`from_pretrained` and `random` hand the new flags to the models they
    build: the VAE's mid-block attention in both of its halves, its convs'
    backward and the vocoder's resblocks; the defaults stay off."""
    unet, vae, voc, txt = snap.tiny_configs()
    snap.write_snapshot(tmp_path, snap.musicldm_modules(unet, vae, voc, txt, seed=1))
    flags = dict(conv2d_kernel=True, conv2d_bwd="kernel", vae_mid_attn="flash",
                 adjoint_kernel=True)
    for pipe, on in ((MusicLDMPipeline.from_pretrained(tmp_path, device="cpu", **flags), True),
                     (MusicLDMPipeline.random(unet, vae, voc, device="cpu", **flags), True),
                     (MusicLDMPipeline.from_pretrained(tmp_path, device="cpu"), False)):
        blocks = (pipe.vae.decoder.mid_attn, pipe.vae.encoder.mid_attn)
        assert all(b.attention.kernel == ("auto" if on else "plain") for b in blocks)
        assert pipe.vae.decoder.conv_out.conv2d_bwd == ("kernel" if on else "plain")
        assert pipe.unet.conv_in.conv2d_bwd == ("kernel" if on else "plain")
        assert pipe.vocoder.resblocks_0.adjoint_kernel is on
