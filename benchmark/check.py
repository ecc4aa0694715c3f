"""How `correct` is decided: the plain reference (`benchmark/reference/`),
fp32 with TF32 off, run after the window on what the timed path produced.

The guided chain is chaotic (a bf16 rounding grows through the dB-mel
loss from step to step), so the reference follows the program step by step
from the program's own state: for each compared step it takes the latents
that entered it (a clip's first step: the initial draw, redrawn from the
generator's state before the call) and the generator's state before it
(DiffMusic's draw), and works out again:

- `cond`: the UNet's conditioning, once a clip. MusicLDM's CLAP class label
  from the prompt's tokens, against what the program fed the UNet.
  AudioLDM2's text stack stage by stage from the program's own state (as
  random-weight flan-T5-large amplifies a bf16 rounding by its 24 blocks: a
  bf16 copy of the reference reads about as far from fp32 as the program
  does): the CLAP tower from the tokens, each T5 block from the program's
  hidden state entering it (over the block's own update), T5's final norm,
  the projection and GPT-2's generation from the program's inputs to them,
  and the streams the UNet got against what the text stack made;
- `eps`: the UNet's raw output on every row (both CFG halves) from the
  latents and the conditioning the program fed it, against the program's;
- `guide` (guided samplers): the step's output from the program's eps (the
  CFG combine, the sampler's algebra, the loss through the VAE decoder, the
  vocoder, the operator and the mel head, its gradient), as the distance of
  the program's output from it over the guidance term's own size (the
  distance between the reference's outputs at the traffic's rate and at
  rate 0);
- `step` (DDIM): the same distance over the step's own size (the distance
  of the output from its input);
- `decode`: the first clip that ended in the window: its audio from the
  program's final latents through the VAE decoder and the vocoder.

Each number is a relative L2 distance, the largest over the compared
answers. The reference runs in row blocks (the UNet) and clip blocks (the
loss, the decode), which is exact: the loss is a sum over clips.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import audio as RA
from .reference import models as RM
from .reference import sampler as RS
from .reference import text as RT
from .reference.precision import Precision

SAMPLE_RATE = 16000


def ratio(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a|| / ||b||, in float64."""
    return float(torch.linalg.vector_norm(a.double()) / torch.linalg.vector_norm(b.double()))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    return ratio(a.double() - b.double(), b)


class Reference:
    """The cell's models, loss and sampler in `prec` on `device`."""

    def __init__(self, config: dict, traffic: dict, weights: dict, prec: Precision, device,
                 ir_seed: int):
        self.config, self.traffic, self.p, self.device = config, traffic, prec, device
        with torch.device("meta"):
            m = {"unet": RM.UNet(config["unet"], prec), "vae": RM.Decoder(config["vae"], prec),
                 "vocoder": RM.Vocoder(config["vocoder"], prec),
                 "clap_text": RT.ClapText(config["clap_text"], prec)}
            if config["pipeline"] == "audioldm2":
                m.update(t5=RT.T5Encoder(config["t5"], prec), gpt2=RT.GPT2(config["gpt2"], prec),
                         projection=RT.Projection(config["projection"], prec))
        self.m = {k: RM.load(v, weights[k], "decoder." if k == "vae" else "")
                  for k, v in m.items()}
        self.sched = RS.Schedule(config["scheduler"])
        self.owl = int(config["audio_length_in_s"] * SAMPLE_RATE)
        self.op = RA.Operator(traffic["task"], self.owl, SAMPLE_RATE, ir_seed, device)
        self._cond = {}

    # ------------------------------------------------------------ conditioning
    def condition(self, prompt: str) -> tuple:
        """The UNet's conditioning of one prompt, one row per stream."""
        if prompt not in self._cond:
            maxlen = self.config["tokenizer_maxlen"]
            if self.config["pipeline"] == "musicldm":
                self._cond[prompt] = (RT.musicldm_condition(self.m["clap_text"], prompt,
                                                            maxlen, self.device),)
            else:
                self._cond[prompt] = RT.audioldm2_condition(
                    self.m, prompt, maxlen, self.config["generated_states"], self.device)
        return self._cond[prompt]

    def cfg(self, prompt: str) -> bool:
        """Whether the program runs both CFG halves: a guidance scale above 1
        and a prompt other than the negative one (else the halves are equal
        and it runs one)."""
        return (self.traffic["guidance_scale"] > 1.0
                and prompt != (self.traffic["negative_prompt"] or ""))

    def rows_condition(self, prompt: str, b: int) -> tuple:
        """Per stream, the conditioning of every UNet row: [uncond * b, cond
        * b] under CFG, cond * b otherwise (masks dropped)."""
        cond = self.condition(prompt)
        if not self.cfg(prompt):
            return tuple(c.expand(b, *c.shape[1:]) for c in cond)
        unc = self.condition(self.traffic["negative_prompt"] or "")
        return tuple(torch.cat([u.expand(b, *u.shape[1:]), c.expand(b, *c.shape[1:])])
                     for u, c in zip(unc, cond))

    # ------------------------------------------------------------------ UNet
    def unet(self, x: torch.Tensor, t: int, prompt: str, cond=None) -> torch.Tensor:
        """The raw output on every row, one row at a time; `cond` the rows'
        conditioning streams (default: the reference's own)."""
        rows = torch.cat([x, x]) if self.cfg(prompt) else x
        own = self.rows_condition(prompt, x.shape[0])
        cond = own if cond is None else tuple(cond) + own[len(cond):]
        out = []
        for r in range(rows.shape[0]):
            ts = torch.full((1,), t, device=self.device)
            c = tuple(s[r:r + 1] for s in cond)
            if self.config["pipeline"] == "musicldm":
                out.append(self.m["unet"](rows[r:r + 1], ts, class_labels=c[0]))
            else:
                out.append(self.m["unet"](rows[r:r + 1], ts, contexts=(c[0], c[1]),
                                          masks=(None, c[2])))
        return torch.cat(out)

    def combine(self, raw: torch.Tensor, prompt: str) -> torch.Tensor:
        if not self.cfg(prompt):
            return raw
        unc, txt = raw.chunk(2)
        return unc + self.traffic["guidance_scale"] * (txt - unc)

    # ------------------------------------------------------------------ loss
    def audio(self, latents: torch.Tensor) -> torch.Tensor:
        mel = self.m["vae"](latents / self.config["vae"]["scaling_factor"])
        return self.m["vocoder"](mel[:, 0])[:, :self.owl]

    def loss_grad(self, eps, t, x, gt: torch.Tensor):
        """(grad, x0) of the guided loss over the clips, one clip at a time,
        the loss scaled as the traffic's sampler scales it; `gt`: the clip's
        (1, L) ground truth, measured by the operator."""
        scale = RS.loss_scale(self.traffic["sampler"]["name"])
        target = self.op.transform(self.op.forward(gt))
        grads, x0s = [], []
        for c in range(x.shape[0]):
            def loss_fn(x0):
                return RA.per_clip_loss(target, self.op, self.audio(x0).float())
            _, g, x0 = RS.loss_and_grad(self.sched, eps[c:c + 1], t, x[c:c + 1], loss_fn, scale)
            grads.append(g)
            x0s.append(x0)
        return torch.cat(grads), torch.cat(x0s)

    def step(self, eps, t, x, grad, x0, z, rate):
        s, steps, dt = self.traffic["sampler"], self.traffic["steps"], self.p.algebra
        if s["name"] == "dps":
            return RS.dps(self.sched, steps, eps, t, x, grad, x0, s["eta"], rate, dt)
        if s["name"] == "diffmusic":
            return RS.diffmusic(self.sched, steps, eps, t, x, grad, x0, z, s["eta"], rate, dt)
        return RS.ddim(self.sched, steps, eps, t, x, dt)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.audio(latents[c:c + 1]) for c in range(latents.shape[0])])


def text_gaps(ref: Reference, tapped: list, rec: dict, prompt: str, b: int) -> list:
    """[(stage, gap)] of AudioLDM2's prompt encoding, from the `tapped`
    calls (name, args, output) of the clip's text stack."""
    calls = {}
    for name, args, out in tapped:
        calls.setdefault(name, []).append((args, out))
    tr, m = ref.traffic, ref.m
    texts = [prompt] + ([tr["negative_prompt"] or ""] if tr["guidance_scale"] > 1.0 else [])
    n_blocks = ref.config["t5"]["num_layers"]
    gaps = []
    for k, text in enumerate(texts[:len(calls["clap"])]):
        ids, mask = RT.tokens([text], ref.device, ref.config["tokenizer_maxlen"])
        emb = calls["clap"][k][1].float()
        gaps.append(("clap", rel(emb / emb.norm(dim=-1, keepdim=True), m["clap_text"](ids, mask))))
        bias, pos, worst = RM.mask_bias(mask), None, 0.0
        for i in range(n_blocks):
            args, out = calls[f"t5.block_{i}"][k]
            x = args[0].float()
            y, pos = getattr(m["t5"], f"block_{i}")(x, bias, pos)
            worst = max(worst, ratio(out[0].float() - y, y - x))
        gaps.append(("t5 blocks", worst))
        seq = calls["t5"][k][1].float()
        last = calls[f"t5.block_{n_blocks - 1}"][k][1][0].float()
        gaps.append(("t5 norm", rel(seq, m["t5"].final_layer_norm(last))))
        (h0, h1, m0, m1), (proj, pmask) = calls["projection"][k]
        gaps.append(("projection", rel(proj.float(), m["projection"](h0.float(), h1.float(),
                                                                     m0, m1)[0])))
        if k == 1 and not ref.cfg(prompt):
            continue                  # equal halves: the UNet got the first encoding only
        row = b if k == 0 and ref.cfg(prompt) else 0     # rows [uncond * b, cond * b]
        gen = m["gpt2"].generate(proj.float(), pmask, ref.config["generated_states"])
        gaps.append(("gpt2", rel(rec["cond"][0][row:row + 1].float(), gen)))
        gaps.append(("t5 to unet", rel(rec["cond"][1][row:row + 1].float(), seq)))
    return gaps


def draw(state, shape, device) -> tuple:
    """(normal draws of `shape`, the state after them) of a generator at
    `state`: the program's draws, redrawn."""
    g = torch.Generator(device)
    g.set_state(state)
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device), g.get_state()


def guided(traffic: dict) -> bool:
    return traffic["sampler"]["name"] != "ddim"


def readings(ref: Reference, records: dict, clips: list, clip_starts: dict, decoded,
             shape: tuple, count_flops: bool = False, tapped=()) -> tuple:
    """({number: largest reading}, per-answer details, one step's FLOPs);
    `tapped`: the text stack's calls in the first clip (AudioLDM2)."""
    tr, dev = ref.traffic, ref.device
    out, details, flops, seen = {}, [], None, set()

    def note(name, value, where):
        out[name] = max(out.get(name, 0.0), value) if value == value else float("nan")
        details.append((name, where, value))

    for j, rec in sorted(records.items()):
        if "prev" not in rec:
            continue
        prompt, gt = clips[rec["clip"]]
        t = rec["t"]
        if rec["i"] == 0:
            x_in, state = draw(clip_starts[rec["clip"]], shape, dev)
        elif "x_in" in rec:
            x_in, state = rec["x_in"].float(), rec["gen_state"]
        else:
            continue
        where = f"step {j} (t {t})"
        if rec["clip"] not in seen:
            seen.add(rec["clip"])
            with torch.no_grad():
                if ref.config["pipeline"] == "musicldm":
                    gaps = [("clap", rel(rec["cond"][0].float(),
                                         ref.rows_condition(prompt, shape[0])[0]))]
                elif rec["clip"] == 0 and tapped:
                    gaps = text_gaps(ref, tapped, rec, prompt, shape[0])
                else:
                    gaps = []
            if gaps:
                note("cond", max(g for _, g in gaps), f"clip {rec['clip']}: " + ", ".join(
                    f"{n} {g:.4g}" for n, g in gaps))
        counter = FlopCounterMode(display=False) if count_flops and flops is None else None
        with torch.no_grad():
            if counter is not None:
                counter.__enter__()
            raw_ref = ref.unet(x_in, t, prompt, [c.float() for c in rec["cond"]])
        note("eps", rel(rec["eps"].float(), raw_ref), where)
        eps = ref.combine(rec["eps"].float(), prompt)
        prev = rec["prev"].float()
        if guided(tr):
            grad, x0 = ref.loss_grad(eps, t, x_in, torch.as_tensor(gt, device=dev))
            z = draw(state, shape, dev)[0] if tr["sampler"]["name"] == "diffmusic" else None
            want = ref.step(eps, t, x_in, grad, x0, z, tr["sampler"]["rate"])
            base = ref.step(eps, t, x_in, grad, x0, z, 0.0)
            note("guide", ratio(prev - want, want - base), where)
        else:
            want = ref.step(eps, t, x_in, None, None, None, 0.0)
            note("step", ratio(prev - want, want - x_in), where)
        if counter is not None:
            counter.__exit__(None, None, None)
            flops = counter.get_total_flops()
    if decoded is not None and "audio" in decoded:
        audio_ref = ref.decode(decoded["latents"].float())
        note("decode", rel(torch.as_tensor(decoded["audio"], device=dev), audio_ref),
             f"clip {decoded['clip']}")
    return out, details, flops
