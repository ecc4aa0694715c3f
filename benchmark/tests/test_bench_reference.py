"""The frozen reference against `diffmusic_tpu_torch`'s plain path at tiny
widths, on the same weights, part by part (CPU, float32). The whole calls
are held together in `test_bench_faults.py`."""

import pytest
import torch

from benchmark import check, program, weights as W
from benchmark.reference import audio as RA, models as RM, sampler as RS, text as RT
from benchmark.reference.precision import FP32
from tiny import tiny_config, tiny_traffic

TOL = 1e-5   # float32 on both sides; the orders of summation differ in places


def rel(a, b):
    return check.rel(a.detach(), b.detach())


@pytest.fixture(scope="module", params=["musicldm", "audioldm2-music"])
def pair(request):
    cfg = tiny_config(request.param)
    tr = tiny_traffic("inpaint-dps")
    weights = W.make(program.model_shapes(cfg), 7, "cpu", torch.float32)
    pipe = program.build(cfg, tr, weights, 3)
    ref = check.Reference(cfg, tr, weights, FP32, "cpu", 3)
    return cfg, pipe, ref


@torch.no_grad()
def test_unet(pair):
    cfg, pipe, ref = pair
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 32, 32, generator=g)
    ts = torch.full((2,), 500)
    if cfg["pipeline"] == "musicldm":
        c = torch.randn(2, 32, generator=g)
        assert rel(pipe.unet(x, ts, class_labels=c), ref.m["unet"](x, ts, class_labels=c)) < TOL
    else:
        c0, c1 = torch.randn(2, 8, 32, generator=g), torch.randn(2, 12, 32, generator=g)
        mask = torch.tensor([[1] * 5 + [0] * 7, [1] * 12])
        out = pipe.unet(x, ts, encoder_hidden_states=c0, encoder_hidden_states_1=c1,
                        encoder_attention_mask_1=mask)
        assert rel(out, ref.m["unet"](x, ts, contexts=(c0, c1), masks=(None, mask))) < TOL


@torch.no_grad()
def test_decoder_and_vocoder(pair):
    _, pipe, ref = pair
    z = torch.randn(2, 8, 32, 32, generator=torch.Generator().manual_seed(1))
    mel = pipe.vae.decode(z)
    assert rel(mel, ref.m["vae"](z)) < TOL
    assert rel(pipe.vocoder(mel[:, 0]), ref.m["vocoder"](mel[:, 0])) < TOL


@torch.no_grad()
def test_text_stack(pair):
    cfg, pipe, ref = pair
    for text in ("", "upbeat funk bass"):
        if cfg["pipeline"] == "musicldm":
            assert rel(pipe._clap_text(text), ref.condition(text)[0]) < TOL
        else:
            gen, seq, mask = pipe._encode_one(text)
            want = ref.condition(text)
            assert rel(gen, want[0]) < TOL and rel(seq, want[1]) < TOL
            assert torch.equal(mask, want[2])


@pytest.mark.parametrize("task", [{"name": "music_inpainting", "start_frac": 0.4, "end_frac": 0.6},
                                  {"name": "music_dereverberation", "ir_length": 400,
                                   "decay": 0.99}])
def test_operator_and_mel_head(task):
    tr = dict(tiny_traffic("inpaint-dps"), task=task)
    op = program._operator(tr, 0.64, 11)
    ref = RA.Operator(task, 10240, 16000, 11, "cpu")
    audio = torch.randn(2, 10240, generator=torch.Generator().manual_seed(2)) * 0.3
    assert rel(op.forward(audio), ref.forward(audio)) < TOL
    assert rel(op.transform(op.forward(audio)), ref.transform(ref.forward(audio))) < TOL


@pytest.mark.parametrize("name, eta, rate", [("ddim", 0.0, 0.0), ("dps", 0.0, 0.0005),
                                             ("diffmusic", 1.0, 0.08)])
def test_sampler_steps(name, eta, rate):
    from diffmusic_tpu_torch.samplers import DiffusionSchedule, SamplerConfig, make_step_fn
    cfg = tiny_config("musicldm")
    sched, steps, t = RS.Schedule(cfg["scheduler"]), 500, 777
    port = make_step_fn(DiffusionSchedule(), SamplerConfig(name=name, eta=eta,
                                                           ip_guidance_rate=rate,
                                                           num_inference_steps=steps),
                        (lambda x0: (x0 ** 2).sum().sqrt() * 3.0) if name != "ddim" else None)
    g = torch.Generator().manual_seed(3)
    x, eps = torch.randn(2, 8, 4, 4, generator=g), torch.randn(2, 8, 4, 4, generator=g)
    state = g.get_state()
    prev = port(eps, t, x, g)[0]
    if name == "ddim":
        want = RS.ddim(sched, steps, eps, t, x)
    else:
        _, grad, x0 = RS.loss_and_grad(sched, eps, t, x,
                                       lambda x0: (x0 ** 2).sum().sqrt() * 3.0,
                                       RS.loss_scale(name))
        if name == "dps":
            want = RS.dps(sched, steps, eps, t, x, grad, x0, eta, rate)
        else:
            g.set_state(state)
            z = torch.randn(x.shape, generator=g)
            want = RS.diffmusic(sched, steps, eps, t, x, grad, x0, z, eta, rate)
    assert rel(prev, want) < TOL


def test_tokenizer_and_impulse_response():
    from diffmusic_tpu_torch.ops.filters import generate_impulse_response
    from diffmusic_tpu_torch.pipelines.base import byte_tokenizer
    texts = ["", "calm solo piano", "ümlaut"]
    assert all((a == b).all() for a, b in zip(byte_tokenizer(texts, 12),
                                              RT.byte_tokenizer(texts, 12)))
    assert torch.equal(generate_impulse_response(torch.Generator().manual_seed(5), 300, 0.9),
                       RA.impulse_response(5, 300, 0.9))
    assert RM.timestep_embedding(torch.tensor([3, 999]), 128).shape == (2, 128)
