"""The one traffic generator: every mix is a data file of parameters
(`benchmark/traffic/<name>.json`) that this module reads.

A clip's inputs are its prompt, drawn from the mix's list, and its ground
truth: a seeded multi-note music signal (`signal`): `notes` notes, each a
fundamental from a MIDI range with harmonics falling off as 1/h, an attack
and an exponential decay, at onsets and lengths drawn uniformly, summed and
scaled to a peak `level`. Every seed draws the same number of notes over the
same clip length, so every seed gives the same shapes and the same work.
"""

import numpy as np


def streams(seed: int, n: int) -> list:
    """n independent 63-bit seeds derived from `seed` (any whole number)."""
    return [int(s.generate_state(1, np.uint64)[0] >> 1)
            for s in np.random.SeedSequence(seed).spawn(n)]


def signal(p: dict, seconds: float, sr: int, rng: np.random.Generator) -> np.ndarray:
    """(1, seconds * sr) float32 ground truth from the mix's `signal` group."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = np.zeros(n)
    for _ in range(p["notes"]):
        f0 = 440.0 * 2.0 ** ((rng.uniform(*p["midi"]) - 69.0) / 12.0)
        onset = rng.uniform(0.0, seconds)
        length = rng.uniform(*p["note_s"])
        amp = rng.uniform(0.3, 1.0)
        i0, i1 = int(onset * sr), min(n, int((onset + length) * sr))
        tt = t[i0:i1] - onset
        env = np.minimum(tt / p["attack_s"], 1.0) * np.exp(-tt / (0.4 * length))
        tone = sum(np.sin(2 * np.pi * f0 * h * t[i0:i1]) / h
                   for h in range(1, p["harmonics"] + 1) if f0 * h < sr / 2)
        out[i0:i1] += amp * env * tone
    return (out * (p["level"] / max(np.abs(out).max(), 1e-9)))[None].astype(np.float32)


def clips(traffic: dict, seconds: float, sr: int, seed: int, n: int) -> list:
    """The first n clips' (prompt, ground truth) of the mix, from `seed`; no
    ground truth for a mix without a `signal` group (generation)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = traffic["prompts"][int(rng.integers(len(traffic["prompts"])))]
        gt = signal(traffic["signal"], seconds, sr, rng) if "signal" in traffic else None
        out.append((prompt, gt))
    return out


def checked_steps(traffic: dict, seed: int) -> list:
    """The window's steps whose output is compared: step 0 (a clip's start,
    from the initial draw) and `checks` more drawn without replacement from
    1 .. min_steps - 1, the steps every window holds."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, traffic["min_steps"]), traffic["checks"], replace=False)
    return sorted({0, *(int(j) for j in rest)})
