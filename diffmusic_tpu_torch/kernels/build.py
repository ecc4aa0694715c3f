"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all at once,
and the objects are linked into one shared library with a plain C interface,
loaded with `ctypes`. The build happens at
first use, into `_build/<hash>/` beside this file (git-ignored); the hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Nothing here runs at import time, and the
module is imported lazily by the kernel wrappers, so the CPU tests never need
`nvcc`.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                     "-lineinfo")
LIB_NAME = "libdiffmusic_kernels.so"

_P, _I, _F, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
# C entry points: name -> (argtypes, restype)
SIGNATURES = {
    "dm_conv1d_fused": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                         _P], _I),
    "dm_conv1d_pair": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    "dm_conv1d_fused_smem": ([_I, _I, _I], _S),
    "dm_conv1d_pair_smem": ([_I, _I, _I, _I], _S),
    "dm_phase_convtranspose": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "dm_phase_convtranspose_smem": ([_I, _I, _I], _S),
    "dm_transformer_block": ([_I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P], _I),
    "dm_transformer_block_smem": ([_I, _I], _S),
    "dm_flash_attention": ([_I, _P, _P, _P, _P, _I, _I, _I, _F, _P], _I),
    "dm_flash_attention_smem": ([_I, _I], _S),
    "dm_group_norm": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P], _I),
    "dm_group_norm_smem": ([_I], _S),
    "dm_channel_moments": ([_I, _P, _P, _I, _I, _I, _P], _I),
    "dm_conv2d_same": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "dm_conv2d_same_smem": ([_I], _S),
    "dm_leaky_mask": ([_I, _P, _P, _P, _P, _S, _F, _P], _I),
    "dm_stage_bwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P], _I),
    "dm_stage_bwd_smem": ([_I], _S),
    "dm_fused_mel": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "dm_fused_mel_smem": ([_I, _I, _I], _S),
}

# bytes of dynamic shared memory one block may use on the H100 (227 KB)
MAX_SMEM = 232448


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the library if this source hash has not been built; returns its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj, log = out_dir / (src.stem + ".o"), out_dir / (src.stem + ".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as f:
            jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    failed = [(cmd, log) for cmd, _, log, proc in jobs if proc.wait() != 0]
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
        tmp_path = tmp.name
    link = [nvcc, *ARCH, "-shared", "-o", tmp_path, *(str(obj) for _, obj, _, _ in jobs)]
    proc = subprocess.run(link, capture_output=True, text=True) if not failed else None
    report = "".join(f"$ {' '.join(cmd)}\n{log.read_text()}\n" for cmd, _, log, _ in jobs)
    if proc is not None:
        report += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}\n"
    rc = 1 if failed else proc.returncode
    (out_dir / "build.log").write_text(f"# {time.time() - t0:.1f} s, rc {rc}\n{report}")
    if rc != 0:
        os.unlink(tmp_path)
        raise RuntimeError(f"nvcc failed (rc {rc}):\n{report[-4000:]}")
    os.replace(tmp_path, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def dtype_code(dtype) -> int:
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"kernels take bfloat16 or float32, not {dtype}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensors(name: str, *tensors) -> None:
    """The kernels take contiguous tensors of one dtype on one CUDA device,
    16-byte aligned (they load rows 16 bytes at a time)."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must start 16-byte aligned")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: kernels take bfloat16 or float32, not {first.dtype}")


def check_smem(name: str, nbytes: int) -> None:
    if nbytes > MAX_SMEM:
        raise ValueError(f"{name}: needs {nbytes} bytes of shared memory per block, "
                         f"more than the {MAX_SMEM} a block may use")
