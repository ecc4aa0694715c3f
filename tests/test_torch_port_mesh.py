"""CPU parity of the port's device mesh (`diffmusic_tpu_torch/parallel`)
against the JAX package's (`diffmusic_tpu/parallel/mesh.py`): JAX on the 8
virtual CPU devices of `conftest.py`, the port's ranks gloo processes that
`parallel.launch` spawns, each group with a time limit of its own
(`RANKS_TIMEOUT`), so that a hung collective fails rather than hangs.

- The mesh rules: `make_mesh` / `parse_mesh` against JAX's on the specs and
  automatic splits, the failed factorisation, a CUDA mesh larger than the
  card count, a batch that does not split, a many-rank mesh used outside
  its ranks.
- tp specs: `shard_params_tp` on the tiny MusicLDM's state dicts shards the
  tensors JAX's `shard_params_tp` shards on its parameter trees, on the axis
  the weight converter maps the flax last axis to.
- dp in the pipeline: the tiny MusicLDM of `test_torch_port_slice.py`, 2
  waveforms, 3 steps, the waveform loss (the dB-mel loss amplifies rounding
  ~1000x over two steps), dp=2 over two ranks, in one spawn: injected
  latents at eta 0 (audio, and the final latents), drawn latents at eta 1,
  one DiffMusic step (its norms and slerp sums over the whole batch; its
  chain amplifies rounding ~100x a step, so that 3 steps of batch 1 and of
  batch 2 already differ by 1.5e-4), a NaN planted in clip 1's latents
  (the retry), each against the one-process batch-2 run within DP_TOL of
  max; the injected run against JAX's batch-2 run at the slice tests'
  bounds (losses 1e-4 relative, final latents 1e-3 and audio 1e-2 of max)
  and against two batch-1 runs within DP_TOL; every rank holds the same
  result. dp=1,tp=2 equals the run without a mesh within DP_TOL.
- Planted faults, in the same spawn, each of which must miss DP_TOL tenfold
  (measured: 0.93, 0.42, 3.5e-4, 1.2 and 1.7e-4 in this order): per-rank
  seeds, draws at the local shape, a joint norm in place of the per-clip
  norm (planted in the one-process reference too), a NaN retry that each
  rank decides alone, DiffMusic's norms and slerp sums over each rank's
  rows.
- The eval: `diffmusic_tpu_torch.eval`'s rank function at dp=2, in the
  same spawn, on 3 equal-length files a side (the pad path): its caches
  within 1e-5 of max of the per-file caches and of JAX's mesh path on
  copies of the files, its scores equal to the per-file eval's within 1e-5.
- The CLI: `python -m diffmusic_tpu_torch.run --device cpu --tiny --mesh
  dp=2 -nw 2 --num_inference_steps 2` writes the files of the run without
  `--mesh` (the recon within 1e-5 of max), and prints once.
- Ranks behind rank 0: dp=2, tp=2 (four ranks, a dp group per tp index, the
  two groups sharing no collective) with rank 1 held back at each call until
  rank 0 has written what the call writes or waits for it in `Mesh.agree`:
  the engine's per-file path (a stand-in embedder without `batch_embed`),
  its batched path, and the run. Every rank must take rank 0's list of
  files, or a rank skips what the others embed and the ranks' collectives
  part ways (a hang, failed by the spawn's limit); the caches equal the
  per-file ones within 1e-5 and the run's files those of the run without
  `--mesh`.

JAX and its helpers are imported inside the tests: the ranks import this
module for the planted faults, and need no JAX.
"""

import contextlib
import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from diffmusic_tpu_torch import eval as teval
from diffmusic_tpu_torch import run as trun
from diffmusic_tpu_torch.data import read_wav, write_wav
from diffmusic_tpu_torch.fadtk.engine import _load_16k, cache_embedding_files
from diffmusic_tpu_torch.inverse_problem.noise import randn as plain_randn
from diffmusic_tpu_torch.metrics.embeddings import MFCCStackEmbedding
from diffmusic_tpu_torch.parallel import mesh as pmesh

REPO = Path(__file__).resolve().parent.parent
RANKS_TIMEOUT = 300.0   # seconds for a spawned group, and for each collective
RACE_TIMEOUT = 120.0    # the same for the spawn with a rank held back
DP_TOL = 1e-5           # a dp run against one process, max |err| / max |reference|
STEPS = 3
RATE = 0.5
LATENTS = (2, 8, 16, 32)
RECON = Path("outputs/musicldm/moises/dps/music_inpainting/wav_recon/track.wav")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -------------------------------------------------------- planted faults
def per_rank_generator(seed, device):
    """The fault: each rank seeds its own generator (seed + rank)."""
    return torch.Generator(device).manual_seed(seed + torch.distributed.get_rank())


def local_randn(shape, generator, dtype, device):
    """The fault: each rank draws at its own rows' shape."""
    return plain_randn(shape, generator, dtype, device)


def joint_norm_loss(target, op, audio, supervised_space):
    """The fault: one Frobenius norm over the batch for the per-clip sum."""
    pred = op.forward(audio)
    diff = target - (op.transform(pred) if supervised_space == "mel_spectrogram" else pred)
    return torch.linalg.vector_norm(diff)


def local_any(flag):
    """The fault: each rank decides its NaN retry alone."""
    return bool(flag)


def local_norm(x):
    """The fault (with `local_sum`): DiffMusic's reductions over each rank's
    rows only."""
    return torch.linalg.vector_norm(x)


def local_sum(x):
    return x


MESH = "diffmusic_tpu_torch.parallel.mesh"
FAULTS = {"per-rank seeds": ("drawn", [(MESH, "seeded_generator", per_rank_generator)]),
          "draws at the local shape": ("drawn", [(MESH, "batch_randn", local_randn)]),
          "joint norm": ("injected", [("diffmusic_tpu_torch.pipelines.musicldm",
                                       "per_clip_loss", joint_norm_loss)]),
          "NaN retry per rank": ("nan", [(MESH, "batch_any", local_any)]),
          "reductions per rank": ("diffmusic", [(MESH, "batch_norm", local_norm),
                                                (MESH, "batch_sum", local_sum)])}


# ------------------------------------------------------ the rank functions
@contextlib.contextmanager
def patched(patches):
    """Each (module name, attribute, value) of `patches` set for the block,
    restored after it."""
    saved = []
    try:
        for module, attr, value in patches:
            owner = importlib.import_module(module)
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, value)
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def pipeline_runs(mesh, pipe, runs) -> list:
    """This rank's part of `runs` on the CPU pipeline `pipe`. Each run is
    (seed, pipeline fields, call keyword arguments, patches): the pipeline
    with `fields` replaced and `mesh`, called with a generator of that seed
    under `patches` (a planted fault). Returns (audios, losses) per run, the
    whole batch's."""
    out = []
    for seed, fields, kwargs, patches in runs:
        with patched(patches):
            res, losses = dataclasses.replace(pipe, mesh=mesh, **fields)(
                generator=pmesh.seeded_generator(seed, "cpu"), return_losses=True, **kwargs)
        out.append((res.audios, losses))
    return out


def dp_rank(mesh, pipe, runs, eval_args):
    """A rank of the dp=2 spawn: the pipeline runs, then the eval of
    `eval_args` (its scores; rank 0 writes the caches)."""
    return pipeline_runs(mesh, pipe, runs), teval.eval_rank(mesh, eval_args)


class FileStats:
    """A stand-in embedder without `batch_embed`, as VGGish and the loaders
    of `fadtk/model_loader.py`: the engine embeds with it file by file, on
    rank 0 alone."""
    name = "file-stats"

    def __call__(self, wav):
        return np.array([[wav.mean(), wav.std(), wav.size]], np.float32)


@contextlib.contextmanager
def marking_waits(marker: Path):
    """On rank 0: `marker` made once a call of `Mesh.agree` has waited 0.5 s
    for the other ranks."""
    real = pmesh.Mesh.agree

    def agree(self, value):
        timer = threading.Timer(0.5, marker.touch)
        timer.start()
        try:
            return real(self, value)
        finally:
            timer.cancel()

    pmesh.Mesh.agree = agree
    try:
        yield
    finally:
        pmesh.Mesh.agree = real


def held_back(marker: Path, written: Path, limit: float = 60.0) -> None:
    """Rank 1's delay: until rank 0 has written `written`, or waits for the
    others in `Mesh.agree` (`marking_waits`)."""
    end = time.monotonic() + limit
    while not (written.exists() or marker.exists()):
        if time.monotonic() > end:
            raise TimeoutError(f"rank 0 neither wrote {written} nor waited in Mesh.agree")
        time.sleep(0.02)


def run_in(directory: Path, mesh, args) -> None:
    os.chdir(directory)
    trun.run_rank(mesh, args)


def race_rank(mesh, root: Path, run_args) -> list:
    """A rank of the dp=2, tp=2 spawn, rank 1 held back at each call until
    rank 0 has written the call's last file or waits for it: the engine's
    per-file path (`FileStats`) and batched path (mfcc-stack) on
    root/files, and the run of `run_args` in root/run. Returns the engine
    calls' counts."""
    files = root / "files"
    calls = [(files / "embeddings/file-stats/c2.npy",
              lambda: cache_embedding_files(files, FileStats(), mesh)),
             (files / "embeddings/mfcc-stack/c2.npy",
              lambda: cache_embedding_files(files, MFCCStackEmbedding("cpu"), mesh)),
             (root / "run" / RECON, lambda: run_in(root / "run", mesh, run_args))]
    out = []
    for i, (written, call) in enumerate(calls):
        marker = root / f"rank0_waits_{i}"
        if mesh.rank == 1:
            held_back(marker, written)
        with marking_waits(marker) if mesh.rank == 0 else contextlib.nullcontext():
            out.append(call())
    return out[:2]


def write_clips(directory: Path, lengths, seed: int) -> None:
    directory.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        write_wav(directory / f"c{i}.wav",
                  0.3 * rng.standard_normal((1, n)).astype(np.float32), 16000)


def output_tree(root: Path) -> dict:
    out = root / RECON.parent.parent
    return {str(p.relative_to(out)): p for p in out.rglob("*.*")}


def assert_same_outputs(root: Path, plain: Path) -> None:
    """The run's output tree under `root` against the one under `plain`: the
    same files, the waveforms within DP_TOL of max."""
    got, want = output_tree(root), output_tree(plain)
    assert sorted(got) == sorted(want) and len(want) == 6
    for name in ("wav_input", "wav_label", "wav_recon"):
        a, sr_a = read_wav(got[f"{name}/track.wav"])
        b, sr_b = read_wav(want[f"{name}/track.wav"])
        assert sr_a == sr_b and a.shape == b.shape == (1, 16000)
        assert rel(a, b) <= DP_TOL, (name, rel(a, b))


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread here, and so one in each rank (`launch` splits
    this process's threads): the test run's workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny():
    """The tiny MusicLDM (DPS, box inpainting) in both packages, the port's
    weights from the JAX package's, and its inputs: the measurement, the
    injected latents (2, 8, 16, 32) and the same with a NaN in clip 1."""
    import jax.numpy as jnp
    import test_torch_port_samplers as samplers_test
    import test_torch_port_slice as slice_test
    jop, top = slice_test.operators()
    jpipe, tpipe = samplers_test.tiny_pipelines(jop, top, "dps")
    owl = int(slice_test.AUDIO_S * 16000)
    meas = np.array(jpipe.operator.forward(
        jnp.asarray(samplers_test.harmonic(owl), jnp.float32)))
    lat = np.random.default_rng(5).standard_normal(LATENTS).astype(np.float32)
    nan_lat = lat.copy()
    nan_lat[1, 0, 0, 0] = np.nan
    return jpipe, tpipe, meas, lat, nan_lat


def call_kw(tiny, **kw) -> dict:
    _, _, meas, _, _ = tiny
    import test_torch_port_slice as slice_test
    base = dict(audio_length_in_s=slice_test.AUDIO_S, num_inference_steps=STEPS,
                guidance_scale=2.0, prompt_embeds=torch.zeros(2, 32),
                measurement=torch.from_numpy(meas), ip_guidance_rate=RATE,
                supervised_space="wav_form", num_waveforms_per_prompt=2)
    return {**base, **kw}


def scenarios(tiny) -> dict:
    """name -> (seed, pipeline fields, call kwargs) of the dp runs."""
    _, _, _, lat, nan_lat = tiny
    return {
        "injected": (0, {}, call_kw(tiny, latents=torch.from_numpy(lat), eta=0.0)),
        "injected latents": (0, {}, call_kw(tiny, latents=torch.from_numpy(lat), eta=0.0,
                                            output_type="latent")),
        "drawn": (3, {}, call_kw(tiny, eta=1.0)),
        "diffmusic": (4, {"scheduler_name": "diffmusic"},
                      call_kw(tiny, latents=torch.from_numpy(lat), eta=1.0,
                              ip_guidance_rate=0.08, num_inference_steps=1)),
        "nan": (6, {}, call_kw(tiny, latents=torch.from_numpy(nan_lat), eta=0.0)),
    }


def one_process(tpipe, seed, fields, kw):
    """The run without a mesh: (audios, losses)."""
    out, losses = dataclasses.replace(tpipe, **fields)(
        generator=torch.Generator().manual_seed(seed), return_losses=True, **kw)
    return out.audios, losses


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """3 equal-length files a side under mesh/{gt,recon}, and copies of them
    under plain/ and jax/."""
    root = tmp_path_factory.mktemp("eval")
    for seed, d in enumerate(("gt", "recon")):
        write_clips(root / "mesh" / d, (24000,) * 3, seed)
    for copy in ("plain", "jax"):
        shutil.copytree(root / "mesh", root / copy)
    return root


def eval_argv(root: Path, side: str) -> list:
    return ["-gt", str(root / side / "gt"), "-r", str(root / side / "recon"), "--device", "cpu"]


@pytest.fixture(scope="module")
def dp_spawn(tiny, eval_root, one_thread):
    """Every scenario and planted fault on dp=2, and the eval of
    eval_root/mesh, in one spawn: ({name: [(audios, losses) of rank 0, of
    rank 1]}, rank 0's scores)."""
    _, tpipe, _, _, _ = tiny
    runs = {name: (seed, fields, kw, []) for name, (seed, fields, kw) in scenarios(tiny).items()}
    for fault, (base, patches) in FAULTS.items():
        seed, fields, kw, _ = runs[base]
        runs[fault] = (seed, fields, kw, patches)
    names = list(runs)
    mesh = pmesh.make_mesh(2, dp=2, device="cpu")
    eval_args = teval.parse_arguments(eval_argv(eval_root, "mesh") + ["--mesh", "dp=2"])
    ranks = pmesh.launch(mesh, dp_rank, tpipe, [runs[n] for n in names], eval_args,
                         timeout=RANKS_TIMEOUT)
    return {n: [r[0][i] for r in ranks] for i, n in enumerate(names)}, ranks[0][1]


@pytest.fixture(scope="module")
def dp_runs(dp_spawn):
    return dp_spawn[0]


@pytest.fixture(scope="module")
def cli_plain(tmp_path_factory):
    """A clip, the tiny run's argv on it, and that run without --mesh in
    plain/: (root, argv)."""
    root = tmp_path_factory.mktemp("cli")
    (root / "clips").mkdir()
    t = np.arange(16000 * 16) / 16000
    write_wav(root / "clips" / "track.wav",
              (0.3 * np.sin(2 * np.pi * 220 * t))[None].astype(np.float32), 16000)
    argv = ["--device", "cpu", "--tiny", "-c", "dps", "-m", "musicldm", "-nw", "2",
            "--num_inference_steps", "2", "-o", f"data.root={root / 'clips'}",
            "-o", "model.pipe.audio_length_in_s=1", "-o", "data.start_inpainting_s=10.3",
            "-o", "data.end_inpainting_s=10.6"]
    (root / "plain").mkdir()
    cwd = Path.cwd()
    os.chdir(root / "plain")
    try:
        trun.main(argv)
    finally:
        os.chdir(cwd)
    return root, argv


# --------------------------------------------------------------- the rules
@pytest.mark.parametrize("spec", [None, "", "dp=8", "dp=2,tp=4", "tp=2", "dp=4"])
def test_parse_mesh_matches_jax(spec):
    import run as jrun
    jm, tm = jrun.parse_mesh(spec), pmesh.parse_mesh(spec, "cpu")
    if not spec:
        assert jm is None and tm is None
        return
    assert tm.shape == dict(jm.shape)
    assert (tm.rank, tm.dp_index, tm.tp_index, tm.device) == (0, 0, 0, torch.device("cpu"))


@pytest.mark.parametrize("n,dp,tp", [(8, None, None), (6, None, None), (4, None, None),
                                     (2, None, None), (1, None, None), (8, 4, None),
                                     (8, None, 2), (8, 2, 4)])
def test_make_mesh_matches_jax(n, dp, tp):
    from diffmusic_tpu.parallel import make_mesh as jmake_mesh
    assert pmesh.make_mesh(n, dp, tp, device="cpu").shape == dict(
        jmake_mesh(n, dp, tp).shape)


def test_bad_factorisation_asserts_in_both():
    from diffmusic_tpu.parallel import make_mesh as jmake_mesh
    with pytest.raises(AssertionError):
        jmake_mesh(8, dp=3, tp=2)
    with pytest.raises(AssertionError, match=r"dp\(3\) \* tp\(2\) != devices\(8\)"):
        pmesh.make_mesh(8, dp=3, tp=2, device="cpu")


def test_cuda_mesh_larger_than_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices but CUDA exposes only 1"):
        pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        pmesh.parse_mesh("dp=2,tp=2")
    one = pmesh.make_mesh()
    assert one.shape == {"dp": 1, "tp": 1} and one.device == torch.device("cuda", 0)


def test_batch_split_and_ranks_outside_launch():
    mesh = pmesh.Mesh(2, 1, "cpu", rank=1)
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(pmesh.shard_batch_dp(mesh, x), x[2:])
    with pytest.raises(ValueError, match="a batch of 3 does not split over dp=2"):
        pmesh.shard_batch_dp(mesh, x[:3])
    with pytest.raises(RuntimeError, match="joined none"):
        mesh.gather(x)
    solo = pmesh.make_mesh(1, device="cpu")
    with pmesh.sharded_batch(solo):   # dp 1: the batch functions act on x as it is
        assert torch.equal(pmesh.batch_norm(x), torch.linalg.vector_norm(x))
        assert pmesh.batch_numel(x) == 8 and not pmesh.batch_any(torch.tensor(False))
    assert torch.equal(pmesh.data_parallel_map(torch.tanh, solo)(x), torch.tanh(x))


def test_replicate_matches_jax():
    """JAX's `replicate` puts the whole array on every device of the mesh;
    the port's puts the whole tensor on each rank's device."""
    import jax
    from diffmusic_tpu.parallel import make_mesh as jmake_mesh
    from diffmusic_tpu.parallel import replicate as jreplicate
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    shards = jax.device_put(x, jreplicate(jmake_mesh(8, dp=2, tp=4))).addressable_shards
    assert len(shards) == 8 and all(np.array_equal(np.asarray(s.data), x) for s in shards)
    for rank in range(8):
        got = pmesh.replicate(pmesh.Mesh(2, 4, "cpu", rank), torch.from_numpy(x))
        assert got.device == torch.device("cpu") and np.array_equal(got.numpy(), x)


def test_shard_params_tp_matches_jax(tiny):
    """A marker tree through the converter: each flax leaf JAX shards holds
    1..n along its last axis (zeros where JAX replicates), so the port's
    state dict shows on which axis the converter put it."""
    import jax
    from diffmusic_tpu.parallel import make_mesh as jmake_mesh
    from diffmusic_tpu.parallel import shard_params_tp as jshard_params_tp
    from diffmusic_tpu_torch.models.convert import from_flax
    jpipe, tpipe, _, _, _ = tiny
    jmesh, tmesh = jmake_mesh(8, dp=2, tp=4), pmesh.make_mesh(8, dp=2, tp=4, device="cpu")
    sharded_total = 0
    for params, model in ((jpipe.unet_params, tpipe.unet), (jpipe.vae_params, tpipe.vae),
                          (jpipe.vocoder_params, tpipe.vocoder)):
        specs = jshard_params_tp(params, jmesh)

        def marker(leaf, spec):
            shape = np.shape(leaf)
            if spec.spec == jax.sharding.PartitionSpec():
                return np.zeros(shape, np.float32)
            return np.broadcast_to(np.arange(1, shape[-1] + 1, dtype=np.float32), shape)

        markers = from_flax(jax.tree.map(marker, params, specs), model.cfg)
        want = {}
        for key, m in markers.items():
            varies = [a for a in range(m.ndim) if m.shape[a] > 1
                      and not torch.equal(m.narrow(a, 0, 1), m.narrow(a, 1, 1))]
            want[key] = varies[0] if varies else None
        got = pmesh.shard_params_tp(model.state_dict(), tmesh, model.cfg)
        assert got == want, type(model).__name__
        sharded_total += sum(v is not None for v in got.values())
    assert sharded_total > 20


# ------------------------------------------------------ dp in the pipeline
def test_dp_matches_one_process_and_jax(tiny, dp_runs):
    import jax.numpy as jnp
    jpipe, tpipe, meas, lat, _ = tiny
    for name, (seed, fields, kw) in scenarios(tiny).items():
        ranks = dp_runs[name]
        assert all(np.array_equal(r[0], ranks[0][0]) and np.array_equal(r[1], ranks[0][1])
                   for r in ranks), f"{name}: the ranks disagree"
        audios, losses = ranks[0]
        ref_audios, ref_losses = one_process(tpipe, seed, fields, kw)
        assert audios.shape == ref_audios.shape and audios.shape[0] == 2, name
        assert np.isfinite(audios).all() and np.isfinite(losses).all(), name
        assert rel(audios, ref_audios) <= DP_TOL, f"{name}: {rel(audios, ref_audios):.2e}"
        assert rel(losses, ref_losses) <= DP_TOL, f"{name}: {rel(losses, ref_losses):.2e}"
    # the NaN planted in clip 1 was redrawn: the output differs from a clean run
    assert rel(dp_runs["nan"][0][0], dp_runs["injected"][0][0]) > 1e-3

    # the injected run against JAX's batch-2 run and two batch-1 runs
    seed, fields, kw = scenarios(tiny)["injected"]
    jlat = {}
    jkw = {k: v for k, v in kw.items() if k not in ("prompt_embeds", "measurement", "latents")}
    jout, jlosses = jpipe(prompt_embeds=jnp.zeros((2, 32)), measurement=jnp.asarray(meas),
                          latents=jnp.asarray(lat), return_losses=True,
                          callback=lambda i, t, x: jlat.__setitem__(i, np.asarray(x)), **jkw)
    audios, losses = dp_runs["injected"][0]
    final = dp_runs["injected latents"][0][0]
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-4)
    assert rel(final, jlat[STEPS - 1]) <= 1e-3
    assert rel(audios, jout.audios) <= 1e-2
    for i in range(2):
        one = one_process(tpipe, seed, fields,
                          {**kw, "latents": torch.from_numpy(lat[i:i + 1]),
                           "num_waveforms_per_prompt": 1})
        assert rel(audios[i:i + 1], one[0]) <= DP_TOL, f"clip {i}: {rel(audios[i:i + 1], one[0])}"


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_dp_run(tiny, dp_runs, monkeypatch, fault):
    _, tpipe, _, _, _ = tiny
    base, patches = FAULTS[fault]
    seed, fields, kw = scenarios(tiny)[base]
    with patched([p for p in patches if p[2] is joint_norm_loss]):
        ref = one_process(tpipe, seed, fields, kw)[0]
    err = rel(dp_runs[fault][0][0], ref)
    assert err > 10 * DP_TOL, f"{fault}: {err:.2e} does not break the dp run"


def test_tp_replicates_the_run(tiny, one_thread):
    """dp=1, tp=2: both ranks run the whole batch, equal to no mesh."""
    _, tpipe, _, _, _ = tiny
    runs = [scenarios(tiny)[n] for n in ("injected", "drawn")]
    mesh = pmesh.make_mesh(2, dp=1, tp=2, device="cpu")
    ranks = pmesh.launch(mesh, pipeline_runs, tpipe, [(s, f, kw, []) for s, f, kw in runs],
                         timeout=RANKS_TIMEOUT)
    for i, (seed, fields, kw) in enumerate(runs):
        ref = one_process(tpipe, seed, fields, kw)
        for rank in ranks:
            assert rel(rank[i][0], ref[0]) <= DP_TOL and rel(rank[i][1], ref[1]) <= DP_TOL


# --------------------------------------------------------------- the eval
def test_eval_mesh_caches_match_per_file_and_jax(eval_root, dp_spawn, one_thread):
    """3 equal-length files a side on dp=2 (the dp spawn): the batch of 3
    pads to 4."""
    from diffmusic_tpu.fadtk import FADEngine as JEngine
    from diffmusic_tpu.fadtk.engine import cache_embedding_files as jcache
    from diffmusic_tpu.parallel import make_mesh as jmake_mesh
    scores = dp_spawn[1]
    plain = teval.main(eval_argv(eval_root, "plain"))
    assert list(scores) == list(plain)
    for k in plain:
        assert abs(scores[k] - plain[k]) <= 1e-5 * max(abs(plain[k]), 1e-30), k
    jcache(eval_root / "jax" / "gt", JEngine(model_name="mfcc-stack").model,
           mesh=jmake_mesh(8, dp=2, tp=4))
    cache = "embeddings/mfcc-stack"
    for i in range(3):
        got = np.load(eval_root / "mesh/gt" / cache / f"c{i}.npy")
        for ref in ("plain", "jax"):
            want = np.load(eval_root / ref / "gt" / cache / f"c{i}.npy")
            assert got.shape == want.shape and rel(got, want) <= 1e-5, (ref, i, rel(got, want))
    # the engine's mesh path, here a mesh of one rank: nothing left to embed
    assert cache_embedding_files(eval_root / "mesh/gt", MFCCStackEmbedding("cpu"),
                                 mesh=pmesh.make_mesh(1, device="cpu")) == 0


def test_eval_mesh_launches_the_mel_kernel_once_per_group(tmp_path, monkeypatch, one_thread):
    """--mesh dp=1 (one rank, in this process): the mfcc-stack caches embed
    each equal-length group of a directory in one call, KL still each clip;
    counted by the real wrapper around a stand-in for the kernel, the
    number chip_smoke.py's mesh phase checks its eval against."""
    import chip_smoke
    from diffmusic_tpu_torch import kernels
    from diffmusic_tpu_torch.kernels import mel as tmel
    rng = np.random.default_rng(1)
    for d in ("gt", "recon"):
        (tmp_path / d).mkdir()
        for i, n in enumerate((24000, 24000, 16000)):
            write_wav(tmp_path / d / f"c{i}.wav", 0.3 * rng.standard_normal((1, n)).astype(
                np.float32), 16000)
    monkeypatch.setattr(tmel, "use_plain", lambda x, name: False)
    monkeypatch.setattr(tmel, "_run_kernel", lambda xb, geom: tmel.fused_mel_plain(xb, *geom))
    kernels.reset_launch_counts()
    scores = teval.main(["-gt", str(tmp_path / "gt"), "-r", str(tmp_path / "recon"),
                         "--device", "cpu", "--mesh", "dp=1"])
    counts = kernels.launch_counts()
    assert counts["fused_mel_spectrogram"] == chip_smoke.eval_mel_launches(3, (2, 2)) == 2 + 2 + 6
    assert list(scores) == ["FAD (mfcc-stack)", "KL", "LSD", "MSE"]
    assert all(np.isfinite(v) for v in scores.values())


# ---------------------------------------------------------------- the CLI
def test_cli_mesh_writes_the_run_without_mesh_once(tmp_path, cli_plain, one_thread):
    root, argv = cli_plain
    proc = subprocess.run([sys.executable, "-m", "diffmusic_tpu_torch.run", *argv,
                           "--mesh", "dp=2"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=RANKS_TIMEOUT,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for line in ("| Model ", "| Mesh              : {'dp': 2, 'tp': 1}",
                 "=====> Inference for audio 1", "CLAP re-ranking similarities"):
        assert proc.stdout.count(line) == 1, (line, proc.stdout)
    assert_same_outputs(tmp_path, root / "plain")


def test_ranks_behind_rank0_take_its_decisions(tmp_path, cli_plain, one_thread):
    """dp=2, tp=2 with rank 1 held back at each call (`race_rank`): every
    rank embeds and runs what rank 0 decided, and the results are those of
    one process."""
    root, argv = cli_plain
    write_clips(tmp_path / "files", (24000,) * 3, 2)
    shutil.copytree(tmp_path / "files", tmp_path / "per_file")
    (tmp_path / "run").mkdir()
    run_args = trun.parse_arguments(argv + ["--mesh", "dp=2,tp=2"])
    ranks = pmesh.launch(pmesh.make_mesh(4, dp=2, tp=2, device="cpu"), race_rank, tmp_path,
                         run_args, timeout=RACE_TIMEOUT)
    assert ranks == [[3, 3]] * 4
    cache_embedding_files(tmp_path / "per_file", MFCCStackEmbedding("cpu"))
    for i in range(3):
        stats = np.load(tmp_path / "files/embeddings/file-stats" / f"c{i}.npy")
        assert np.array_equal(stats, FileStats()(_load_16k(tmp_path / "files" / f"c{i}.wav")))
        got, want = (np.load(tmp_path / d / "embeddings/mfcc-stack" / f"c{i}.npy")
                     for d in ("files", "per_file"))
        assert got.shape == want.shape and rel(got, want) <= 1e-5, (i, rel(got, want))
    assert_same_outputs(tmp_path / "run", root / "plain")
