"""The port's kernel launches of one step and of one clip's end, with the
work of each, worked out from a cell's configuration and traffic.

The routes are the port's defaults, restated here from its documented
rules so that the count stays the benchmark's: the UNet's transformer
blocks at T >= 512 tokens run the fused block kernel where they are
self-attention only (MusicLDM) and the flash attention kernel for their
self-attention where they have cross streams (AudioLDM2); the vocoder's
resblocks at 128-aligned widths run a pair kernel where the pair's bf16
weights take at most 9 MB and two single-conv launches an iteration
elsewhere; its upsamplers whose output width is 128 * 2^n from a
128-aligned input run the transposed-conv kernel. A guided step runs the
UNet on every row and the vocoder forward once in its loss (its backward
is plain); an unguided step the UNet alone; a clip's end decodes once. The
harness holds these counts against `diffmusic_tpu_torch.kernels.
launch_counts()` before it divides by them.
"""

from . import attention, conv1d, transformer_block, upsampler


def unet_levels(cfg: dict, h: int, w: int) -> list:
    """(tokens, channels) of each UNet level with attention."""
    out = []
    for i, ch in enumerate(cfg["block_out_channels"]):
        if cfg["has_attention"][i]:
            out.append((h * w, ch))
        h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1    # pad (0, 1), 3x3, stride 2
    return out


def unet_calls(cfg: dict, rows: int, h: int, w: int) -> list:
    hd, n = cfg["attention_head_dim"], 2 * cfg["layers_per_block"] + 1
    calls = []
    for t, c in unet_levels(cfg, h, w):
        if t < 512:
            continue
        if cfg["cross_attention_dims"]:
            calls += [(attention.COUNTER, attention.work(rows, t, c // hd, hd))] * n
        else:
            calls += [(transformer_block.COUNTER, transformer_block.work(rows, t, c, hd))] * n
    return calls


def vocoder_calls(cfg: dict, rows: int, frames: int) -> list:
    calls, t = [], frames
    uic = cfg["upsample_initial_channel"]
    for i, (rate, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        cin, ch = uic // 2 ** i, uic // 2 ** (i + 1)
        t_out = (t - 1) * rate + k - 2 * ((k - rate) // 2)
        n = ch // 128
        if cin % 128 == 0 and ch % 128 == 0 and n & (n - 1) == 0:
            calls.append((upsampler.COUNTER, upsampler.work(rows, t, t_out, cin, ch, k)))
        t = t_out
        if ch % 128:
            continue
        for rk, dils in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            for _ in dils:
                if 2 * rk * ch * ch * 2 / 2 ** 20 <= 9.0:
                    calls.append(("conv1d_fused_pair", conv1d.pair(rows, t, ch, rk)))
                else:
                    calls.append(("conv1d_fused", conv1d.single(rows, t, ch, rk, False)))
                    calls.append(("conv1d_fused", conv1d.single(rows, t, ch, rk, True)))
    return calls


def calls(config: dict, traffic: dict) -> dict:
    """{"per_step": [(counter, work)], "per_clip": [...]} of the cell."""
    b = traffic["candidates"]
    frames = int(config["audio_length_in_s"] * 100)          # hop 160 at 16 kHz
    s = 2 ** (len(config["vae"]["block_out_channels"]) - 1)   # the VAE's downsampling
    h, w = frames // s, config["vocoder"]["model_in_dim"] // s
    cfg_rows = 2 * b if traffic["prompts"] != [traffic["negative_prompt"] or ""] else b
    guided = traffic["sampler"]["name"] != "ddim"
    step = unet_calls(config["unet"], cfg_rows, h, w)
    if guided:
        step += vocoder_calls(config["vocoder"], b, frames)
    return {"per_step": step, "per_clip": vocoder_calls(config["vocoder"], b, frames)}
