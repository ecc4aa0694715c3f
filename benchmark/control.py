"""The control of the check: the reference put in the program's place and
computed one step below the precision the configuration states
(`reference/precision.py::CONTROL`), read by the same comparison as a run.

    python3 -m benchmark.control --workload musicldm.inpaint-dps --seeds 11 12 13

For each seed the control makes the run's weights and inputs, runs the
first `checks + 1` steps of a clip from the initial draw (and, for an
unguided mix, decodes the latents it ends with), and prints the numbers
the fp32 reference reads on them, one JSON line a seed. The smallest
reading of a number over the seeds is its upper reading: a limit lies
below it. The benchmark's runs never run it.
"""

import argparse
import json
import sys

import torch

from . import check, harness, manifest, traffic as T, weights as W
from .reference.precision import CONTROL, FP32
from .window import detached


def records(ctl: check.Reference, clips: list, shape: tuple, gen_seed: int, steps: int,
            device) -> tuple:
    """(records, clip starts, decoded, tapped) of `steps` control steps of
    clip 0, in the form `check.readings` takes from a run."""
    tr = ctl.traffic
    gen = torch.Generator(device).manual_seed(gen_seed)
    starts = {0: gen.get_state()}
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    prompt, gt = clips[0]
    n_streams = 1 if ctl.config["pipeline"] == "musicldm" else 2
    tapped = []
    if n_streams == 2:     # the text stack's stages, as a run keeps the program's
        m = ctl.m
        taps = {"clap": m["clap_text"], "t5": m["t5"], "projection": m["projection"],
                **{f"t5.block_{i}": getattr(m["t5"], f"block_{i}")
                   for i in range(ctl.config["t5"]["num_layers"])}}
        hooks = [mod.register_forward_hook(
            lambda _m, a, o, k=k: tapped.append((k, detached(a), detached(o))))
            for k, mod in taps.items()]
        with torch.no_grad():
            ctl.rows_condition(prompt, shape[0])
        for h in hooks:
            h.remove()
    out = {}
    for i, t in enumerate(ctl.sched.timesteps(tr["steps"])[:steps]):
        t, state = int(t), gen.get_state()
        with torch.no_grad():
            raw = ctl.unet(x, t, prompt)
        eps = ctl.combine(raw, prompt)
        if check.guided(tr):
            grad, x0 = ctl.loss_grad(eps, t, x, torch.as_tensor(gt, device=device))
            z = (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
                 if tr["sampler"]["name"] == "diffmusic" else None)
            prev = ctl.step(eps, t, x, grad, x0, z, tr["sampler"]["rate"])
        else:
            prev = ctl.step(eps, t, x, None, None, None, 0.0)
        out[i] = {"eps": raw, "cond": ctl.rows_condition(prompt, shape[0])[:n_streams],
                  "clip": 0, "i": i, "t": t, "prev": prev, "x_in": x, "gen_state": state}
        x = prev
    decoded = None
    if not check.guided(tr):
        decoded = {"clip": 0, "latents": x, "audio": ctl.decode(x).cpu().numpy()}
    return out, starts, decoded, tapped


def control_readings(spec: dict, seed: int, device: str) -> dict:
    config, tr = spec["config"], spec["traffic"]
    w_seed, gen_seed, tr_seed, ir_seed, _ = T.streams(seed, 5)
    from . import program
    weights = W.make(program.model_shapes(config), w_seed, device,
                     getattr(torch, config["weight_dtype"]))
    clips = T.clips(tr, config["audio_length_in_s"], harness.SAMPLE_RATE, tr_seed, 1)
    shape = harness.latent_shape(config, tr)
    ctl = check.Reference(config, tr, weights, CONTROL, device, ir_seed)
    with CONTROL.mode():
        recs, starts, decoded, tapped = records(ctl, clips, shape, gen_seed, tr["checks"] + 1,
                                                device)
    del ctl
    ref = check.Reference(config, tr, weights, FP32, device, ir_seed)
    with FP32.mode():
        numbers, details, _ = check.readings(ref, recs, clips, starts, decoded, shape,
                                             tapped=tapped)
    return {"seed": seed, "numbers": numbers, "details": details}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    spec = manifest.load(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(spec, seed, "cuda")), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
