"""Traffic drawn from the seed, the work functions against hand counts, the
launch counts they assume, and the FLOP count the step's MFU uses (CPU)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import manifest, traffic as T, work
from benchmark.work import attention, conv1d, transformer_block, upsampler

SEED = 2 ** 31 + 12345


def _file(kind, name):
    return manifest._json(manifest.ROOT / "benchmark" / kind / f"{name}.json")


@pytest.mark.parametrize("mix", ["inpaint-dps", "generate-cfg", "dereverb-diffmusic"])
def test_traffic_is_deterministic_from_the_seed(mix):
    tr = _file("traffic", mix)
    a, b = T.clips(tr, 10, 16000, SEED, 3), T.clips(tr, 10, 16000, SEED, 3)
    c = T.clips(tr, 10, 16000, SEED + 1, 3)
    for (pa, ga), (pb, gb), (_, gc) in zip(a, b, c):
        assert pa == pb
        if ga is None:
            assert gb is None and gc is None
            continue
        assert ga.shape == gc.shape == (1, 160000) and np.array_equal(ga, gb)
        assert not np.array_equal(ga, gc)
        assert np.abs(ga).max() == pytest.approx(tr["signal"]["level"])
    assert T.checked_steps(tr, SEED) == T.checked_steps(tr, SEED)
    assert T.checked_steps(tr, SEED)[0] == 0 and max(T.checked_steps(tr, SEED)) < tr["min_steps"]
    assert T.streams(SEED, 5) == T.streams(SEED, 5) and len(set(T.streams(SEED, 5))) == 5


def test_work_matches_hand_counts():
    b, t, c = 2, 4000, 128
    proj = 2 * b * t * c * c * 2 + 2 * b * t * c * 8 * c + 2 * b * t * 4 * c * c
    assert transformer_block.work(b, t, c) == {
        "flops": proj + 2 * (2 * b * t * t * c), "exp2": b * 16 * t * t,
        "bytes": 2 * (3 * b * t * c + b * t * c + (4 + 8 + 4 - 2) * c * c + 12 * c)}
    assert attention.work(16, 4000, 16, 8) == {"flops": 2 * 2 * 16 * 16 * 4000 * 4000 * 8,
                                               "bytes": 2 * 4 * 16 * 4000 * 16 * 8,
                                               "exp2": 16 * 16 * 4000 * 4000}
    assert conv1d.pair(3, 5001, 512, 7)["flops"] == 2 * (2 * 3 * 5001 * 512 * 512 * 7)
    assert conv1d.pair(3, 5001, 512, 7)["bytes"] == 2 * (3 * 3 * 5001 * 512 + 2 * 7 * 512 * 512
                                                         + 2 * 512)
    assert conv1d.single(3, 5001, 512, 11, True)["bytes"] == 2 * (
        3 * 3 * 5001 * 512 + 11 * 512 * 512 + 512)
    assert upsampler.work(3, 1000, 5001, 1024, 512, 16) == {
        "flops": 2 * 3 * 1000 * 1024 * 512 * 16,
        "bytes": 2 * (3 * 1000 * 1024 + 3 * 5001 * 512 + 16 * 1024 * 512 + 512), "exp2": 0}


def _counts(calls):
    out = {}
    for name, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


# configurations and mixes of the manifest's cells and of the ones kept for later
@pytest.mark.parametrize("config, mix, step, clip, rows", [
    ("musicldm", "inpaint-dps", {"fused_transformer_block": 10, "conv1d_fused_pair": 24,
                                 "conv1d_fused": 6, "phase_convtranspose": 3}, 33, 3),
    ("audioldm2-music", "generate-cfg", {"flash_attention": 10}, 33, 16),
    ("audioldm2-music", "inpaint-dps", {"flash_attention": 10, "conv1d_fused_pair": 24,
                                        "conv1d_fused": 6, "phase_convtranspose": 3}, 33, 3),
])
def test_launches_a_step_and_a_clip(config, mix, step, clip, rows):
    calls = work.calls(_file("configs", config), _file("traffic", mix))
    assert _counts(calls["per_step"]) == step
    assert len(calls["per_clip"]) == clip
    unet = [w for n, w in calls["per_step"] if n in ("flash_attention", "fused_transformer_block")]
    t0 = 4000
    first = (attention.work(rows, t0, 16, 8) if "flash_attention" in step
             else transformer_block.work(rows, t0, 128))
    assert unet[0] == first


def test_flop_counter_counts_forward_and_input_cotangents_only():
    torch.manual_seed(0)
    lin, conv = torch.nn.Linear(8, 4).requires_grad_(False), torch.nn.Conv2d(
        3, 5, 3, padding=1).requires_grad_(False)
    x = torch.randn(2, 8, requires_grad=True)
    y = torch.randn(1, 3, 6, 6, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        # the models take a tensor computed from the leaf, as x0 from x_t in the check
        loss = lin(x * 1.0).sum() + conv(y * 1.0).sum()
        torch.autograd.grad(loss, [x, y])
    linear = 2 * 2 * 8 * 4
    convolution = 2 * (6 * 6 * 5) * (3 * 3 * 3)
    assert fc.get_total_flops() == 2 * (linear + convolution)
