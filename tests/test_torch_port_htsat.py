"""CPU parity of the port's CLAP audio tower (HTSAT) and its features against
the JAX package: the bicubic resize, the tower's pooled and frame outputs,
the CLAP log-mel input, the style-guidance gram loss's gradient with respect
to the waveform, and the HF -> flax converter (fp32, weights carried over by
`from_flax`, inputs from a numpy seed).

Tolerances, as a fraction of max |reference|: the resize 1e-6 (one matmul
of 4 nonzero weights a row); the tower and the features 1e-5; the gradient
1e-4 (through the STFT, the dB, the Swin stages and the gram matrix); the
converter to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffmusic_tpu.inverse_problem import StyleGuidanceOperator as JStyle
from diffmusic_tpu.models import clap_features as jcf
from diffmusic_tpu.models import convert as jconvert
from diffmusic_tpu.models import htsat as jhtsat
from diffmusic_tpu_torch.inverse_problem import StyleGuidanceOperator
from diffmusic_tpu_torch.models import clap_features as tcf
from diffmusic_tpu_torch.models import convert
from diffmusic_tpu_torch.models import htsat
from diffmusic_tpu_torch.ops.mel import mel_filterbank
from diffmusic_tpu_torch.pipelines.musicldm import per_clip_loss
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

TINY = jhtsat.tiny_clap_audio_config()
# a 12 x 12 patch grid under an 8-wide window: stage 0 pads to 16 x 16 and
# its second block shifts by 4 under the -100/0 mask; stage 1 (6 x 6) clamps
# its window to 6 with no shift
SMALL = jhtsat.ClapAudioConfig(spec_size=48, num_mel_bins=16, window_size=8, depths=(2, 2),
                               num_attention_heads=(2, 4), patch_embeds_hidden_size=16,
                               projection_dim=16)
# the converter's geometry: transformers sizes every bias table by the
# config's window, JAX and the port by the clamped one; they agree where no
# stage is narrower than the window (laion/clap-htsat-unfused: 8 x 8 at 8)
CONVERTED = dataclasses.replace(SMALL, window_size=6)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def port_cfg(cfg):
    mod = htsat if isinstance(cfg, jhtsat.ClapAudioConfig) else tcf
    return getattr(mod, type(cfg).__name__)(**dataclasses.asdict(cfg))


def jax_tower(cfg, seed):
    """JAX variables with every leaf random: kernels over sqrt(fan-in), the
    rest 0.1-normal around flax's init, the running variance positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jhtsat.ClapAudioModelWithProjection(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 1, 8, cfg.num_mel_bins)))

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return jnp.asarray(x / np.sqrt(np.prod(s.shape[:-1])))
        if name in ("scale", "bn_scale", "bn_var"):
            return jnp.asarray(1.0 + 0.1 * np.abs(x))
        return jnp.asarray(0.1 * x)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_tower(cfg, variables):
    tower = htsat.ClapAudioModelWithProjection(port_cfg(cfg))
    tower.load_state_dict(convert.from_flax(variables, port_cfg(cfg)), strict=True)
    return tower.requires_grad_(False)


@pytest.fixture(scope="module")
def towers():
    out = {}
    for name, cfg, seed in (("tiny", TINY, 1), ("small", SMALL, 2)):
        variables = jax_tower(cfg, seed)
        out[name] = (cfg, variables, port_tower(cfg, variables))
    return out


@pytest.mark.parametrize("n_in, n_out", [(1001, 1024), (101, 256)])
def test_resize_matches_jax(rng, n_in, n_out):
    x = rng.standard_normal((2, 1, n_in, 16)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 1, n_out, 16), "bicubic"))
    out = htsat.bicubic_resize(torch.from_numpy(x), 2, n_out).numpy()
    assert out.shape == ref.shape
    assert rel(out, ref) <= 1e-6
    # F.interpolate's bicubic is another rule (a = -0.75, no edge renormalisation)
    plain = F.interpolate(torch.from_numpy(x), size=(n_out, 16), mode="bicubic").numpy()
    assert rel(plain, ref) > 1e-2


def test_small_geometry_takes_the_shifted_padded_and_clamped_windows():
    tower = htsat.ClapAudioModelWithProjection(port_cfg(SMALL))
    b0, b1, b2 = tower.stage_0_block_0, tower.stage_0_block_1, tower.stage_1_block_0
    assert (b0.window_size, b0.shift_size, b0.input_resolution) == (8, 0, (12, 12))
    assert (b1.window_size, b1.shift_size) == (8, 4)
    assert (b2.window_size, b2.shift_size, b2.input_resolution) == (6, 0, (6, 6))


@pytest.mark.parametrize("name", ["tiny", "small"])
@pytest.mark.parametrize("features", ["pooled", "frames"])
def test_tower_matches_jax(rng, towers, name, features):
    cfg, variables, tower = towers[name]
    x = (rng.standard_normal((2, 1, 101, cfg.num_mel_bins)) * 10 - 40).astype(np.float32)
    ref = np.asarray(jhtsat.ClapAudioModelWithProjection(cfg).apply(
        variables, jnp.asarray(x), features=features))
    with torch.no_grad():
        out = tower(torch.from_numpy(x), features=features).numpy()
    side = cfg.spec_size // 2 ** (len(cfg.depths) - 1) // cfg.patch_stride[0]
    want = (2, cfg.freq_ratio * side) if features == "frames" else (2,)
    assert out.shape == ref.shape == want + (cfg.projection_dim,)
    assert rel(out, ref) <= 1e-5


def features_oracle(wav48, cfg):
    """`clap_mel_features` in float64 numpy, of a waveform at cfg's rate."""
    n_fft, hop = cfg.fft_window_size, cfg.hop_length
    x = np.pad(np.asarray(wav48, np.float64), ((0, 0), (n_fft // 2, n_fft // 2)), "reflect")
    starts = np.arange(1 + wav48.shape[-1] // hop) * hop
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    power = np.abs(np.fft.rfft(x[:, starts[:, None] + np.arange(n_fft)] * hann, axis=-1)) ** 2
    fb = mel_filterbank(n_fft // 2 + 1, cfg.feature_size, cfg.sampling_rate,
                        cfg.frequency_min, cfg.frequency_max, "slaney", "slaney")
    db = 10 * np.log10(np.maximum(power @ fb.astype(np.float64), 1e-10))
    return np.maximum(db, db.max() - 80)[:, None]


@pytest.mark.parametrize("cfg, seconds", [(jcf.tiny_clap_feature_config(), 1.3),
                                          (jcf.ClapFeatureConfig(), 0.5)])
def test_clap_features_match_jax(rng, cfg, seconds):
    """The tiny config (truncation, no resampling) and the 48 kHz config on a
    0.5-s clip (the resampler and "repeatpad": 20 whole tiles). A 16-kHz clip
    has no power above 8 kHz: there the 48 kHz mel bins hold the resampler's
    stopband, ~125 dB below the peak, and each side's fp32 rounding noise.
    On the bins of the clip's band the port is held to JAX; on every bin,
    against a float64 oracle of the same resampled waveform, it is no
    further from it than twice JAX's error (plus the same 1e-5)."""
    wav = (rng.standard_normal((2, int(seconds * 16000))) * 0.3).astype(np.float32)
    pcfg = port_cfg(cfg)
    fb = mel_filterbank(cfg.fft_window_size // 2 + 1, cfg.feature_size, cfg.sampling_rate,
                        cfg.frequency_min, cfg.frequency_max, "slaney", "slaney")
    freqs = np.linspace(0, cfg.sampling_rate // 2, fb.shape[0])
    band = fb[freqs > 8000.0].sum(0) == 0
    for clip in (wav, wav * np.float32([[1.0], [1e-5]])):
        ref = np.asarray(jcf.prepare_clap_input(jnp.asarray(clip), cfg))
        out = tcf.prepare_clap_input(torch.from_numpy(clip), pcfg).numpy()
        assert out.shape == ref.shape == (2, 1, cfg.nb_max_samples // cfg.hop_length + 1,
                                          cfg.feature_size)
        assert rel(out[..., band], ref[..., band]) <= 1e-5
        wav48 = tcf.resample(torch.from_numpy(clip), 16000, cfg.sampling_rate)
        n = wav48.shape[-1]
        tiles = cfg.nb_max_samples // n
        wav48 = np.pad(np.tile(wav48.numpy(), (1, tiles)),
                       ((0, 0), (0, cfg.nb_max_samples - tiles * n)))[:, :cfg.nb_max_samples]
        exact = features_oracle(wav48, cfg)
        scale = np.abs(exact).max()
        assert np.all(np.abs(out - exact) <= 2 * np.abs(ref - exact) + 1e-5 * scale)
    # one clamp for the whole batch: the quiet clip sits at the loud one's top - 80
    assert out[1].min() == pytest.approx(out.max() - 80.0, abs=1e-3)


def test_style_loss_gradient_matches_jax(rng, towers):
    cfg, variables, tower = towers["tiny"]
    f_cfg = jcf.tiny_clap_feature_config()
    jop = JStyle(clap_embed=jcf.make_clap_frame_embed(
        jhtsat.ClapAudioModelWithProjection(cfg), variables, f_cfg))
    op = StyleGuidanceOperator(clap_embed=tcf.make_clap_frame_embed(tower, port_cfg(f_cfg)))
    target_wav, x = ((rng.standard_normal((2, 16000)) * 0.3).astype(np.float32)
                     for _ in range(2))
    jtarget = jop.transform(jnp.asarray(target_wav))

    def jloss(a):
        d = jtarget - jop.transform(a)
        return jnp.sum(jnp.sqrt(jnp.sum(d.reshape(d.shape[0], -1) ** 2, axis=1)))

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    with torch.no_grad():
        target = op.transform(torch.from_numpy(target_wav))
    assert rel(target, jtarget) <= 1e-5 and target.shape == (2, 16, 16)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = per_clip_loss(target, op, xt, "mel_spectrogram")
    (g,) = torch.autograd.grad(loss, xt)
    assert rel(loss.item(), float(jl)) <= 1e-5
    assert rel(g, jg) <= 1e-4
    assert op.forward(xt) is xt


def test_style_operator_needs_an_embed():
    with pytest.raises(ValueError, match="clap_embed"):
        StyleGuidanceOperator().transform(torch.zeros(1, 16000))


def clap_audio_sd(cfg, seed=3):
    """A tiny transformers ClapAudioModelWithProjection's state dict."""
    import transformers as tf
    acfg = tf.ClapAudioConfig(
        spec_size=cfg.spec_size, patch_size=cfg.patch_size, patch_stride=list(cfg.patch_stride),
        num_mel_bins=cfg.num_mel_bins, window_size=cfg.window_size, depths=list(cfg.depths),
        num_attention_heads=list(cfg.num_attention_heads),
        patch_embeds_hidden_size=cfg.patch_embeds_hidden_size, hidden_size=cfg.num_features,
        projection_dim=cfg.projection_dim, enable_fusion=False)
    torch.manual_seed(seed)
    model = tf.ClapAudioModelWithProjection(acfg)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("prefixed", [True, False])
def test_convert_clap_audio_matches_jax(prefixed):
    sd = clap_audio_sd(CONVERTED)
    if not prefixed:
        sd = {k.removeprefix("audio_model."): v for k, v in sd.items()}
    tree = convert.convert_clap_audio(sd, port_cfg(CONVERTED))
    jtree = jconvert.convert_clap_audio(sd, CONVERTED)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree, jtree))
    port_tower(CONVERTED, jtree)   # every leaf lands on a parameter or buffer
