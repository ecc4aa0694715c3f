"""Device mesh (dp x tp) over `torch.distributed` (port of
`diffmusic_tpu/parallel/mesh.py`).

JAX lays one (dp, tp) mesh over the devices of one process and GSPMD
partitions one program over it. Here each device is a process, a rank of
`launch`: rank r has dp index r // tp and tp index r % tp (JAX's
`devices.reshape(dp, tp)`), its device is `cuda:{r}` under NCCL or the CPU
under gloo, and the ranks meet through a `FileStore` in a temporary
directory. A mesh of one rank makes no process group: every collective is
then the identity, as a one-device JAX mesh compiles none.

What the JAX package does with its mesh, the port does alike:
- dp shards the waveform batch (`shard_batch_dp`). Each rank computes its
  rows; the ranks of one tp group compute the same rows. Inside
  `sharded_batch(mesh)` the `batch_*` functions act on the whole batch, as
  GSPMD's collectives do: `batch_randn` draws the whole batch's values from
  a generator seeded alike on every rank and keeps this rank's rows,
  `batch_sum` / `batch_norm` / `batch_max` reduce over the dp axis, and
  `batch_any` decides a NaN retry for the whole batch.
- tp replicates the work: the run path shards no weight. `shard_params_tp`
  gives JAX's tp rule for a state dict, which only the tests read, as in
  JAX.
- `data_parallel_map` splits a batch over dp and gathers the result, for
  the eval's batched embeddings.
"""

import contextlib
import os
import tempfile
import time
from contextvars import ContextVar
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..inverse_problem.noise import randn


class Mesh:
    """A (dp, tp) grid of ranks on `device_type` ("cuda" or "cpu"), seen from
    rank `rank`. `shape` is {"dp": dp, "tp": tp}, as a JAX mesh's."""

    def __init__(self, dp: int, tp: int, device_type: str = "cuda", rank: int = 0):
        self.shape = {"dp": dp, "tp": tp}
        self.device_type = device_type
        self.rank = rank
        self.dp_group = None   # this rank's dp axis once joined (None: the world)

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["tp"]

    @property
    def dp_index(self) -> int:
        return self.rank // self.shape["tp"]

    @property
    def tp_index(self) -> int:
        return self.rank % self.shape["tp"]

    @property
    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", self.rank)
        return torch.device("cpu")

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"{self.device_type}, rank={self.rank})")

    def join(self, store_path, timeout: Optional[float] = None) -> None:
        """Join the process group of the mesh's ranks as this rank: NCCL on
        the card, gloo on the CPU, rendezvous through a FileStore; then the
        dp groups, one per tp index, where both axes exceed 1."""
        if self.device_type == "cuda":
            torch.cuda.set_device(self.device)
        kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        dist.init_process_group("nccl" if self.device_type == "cuda" else "gloo",
                                store=dist.FileStore(str(store_path), self.size),
                                rank=self.rank, world_size=self.size, **kw)
        dp, tp = self.shape["dp"], self.shape["tp"]
        if dp > 1 and tp > 1:
            for t in range(tp):   # every rank makes every group, in one order
                group = dist.new_group([d * tp + t for d in range(dp)])
                if t == self.tp_index:
                    self.dp_group = group

    def _check_joined(self) -> None:
        if not dist.is_initialized():
            raise RuntimeError(f"{self} has {self.size} ranks but this process joined none: "
                               f"run it through parallel.launch")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The dp ranks' x (equal shapes) concatenated along axis 0, in dp
        order, on every rank."""
        if self.shape["dp"] == 1:
            return x
        self._check_joined()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape["dp"])]
        dist.all_gather(parts, x, group=self.dp_group)
        return torch.cat(parts)

    def reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """x reduced over the dp ranks (a new tensor)."""
        if self.shape["dp"] == 1:
            return x
        self._check_joined()
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.dp_group)
        return out

    def agree(self, value):
        """Rank 0's `value` on every rank of the mesh (a picklable object):
        one decision for all ranks where each could see a different state,
        such as files that rank 0 writes while another rank is behind."""
        if self.size == 1:
            return value
        self._check_joined()
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.size > 1:
            self._check_joined()
            dist.barrier(**({"device_ids": [self.rank]} if self.device_type == "cuda" else {}))


def _mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> tuple:
    """(dp, tp) for n devices by JAX's `make_mesh` rule: with neither given,
    tp doubles, up to 4, while it divides n, and dp takes the rest."""
    if dp is None and tp is None:
        tp = 1
        while tp * 2 <= n and n % (tp * 2) == 0 and tp < 4:
            tp *= 2
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:   # JAX asserts; raised so that it holds under -O too
        raise AssertionError(f"dp({dp}) * tp({tp}) != devices({n})")
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device="cuda") -> Mesh:
    """A (dp, tp) mesh of n_devices ranks (on "cuda", every visible card by
    default; more than are visible raises). On "cpu" the ranks are gloo
    processes, any number of them (one by default): the counterpart of
    JAX's virtual CPU devices. The mesh is rank 0's view; `launch` runs a
    function on every rank."""
    device_type = torch.device(device).type
    if device_type == "cuda":
        have = torch.cuda.device_count()
        n = n_devices or have
        if have < n:
            raise ValueError(f"make_mesh needs {n} devices but CUDA exposes only {have}. "
                             f"For a CPU mesh of gloo processes, pass device='cpu' "
                             f"(--device cpu)")
    else:
        n = n_devices or 1
    return Mesh(*_mesh_shape(n, dp, tp), device_type)


def parse_mesh(spec: Optional[str], device="cuda") -> Optional[Mesh]:
    """'dp=2,tp=4' -> a Mesh, as the JAX package's `run.parse_mesh`."""
    if not spec:
        return None
    kv = dict(part.split("=") for part in spec.split(","))
    dp, tp = int(kv.get("dp", 0)) or None, int(kv.get("tp", 0)) or None
    return make_mesh(n_devices=(dp or 1) * (tp or 1), dp=dp, tp=tp, device=device)


def _rank_main(rank: int, dp: int, tp: int, device_type: str, tmp: str, threads: int,
               timeout, fn, args) -> None:
    """A spawned rank: join the mesh, run fn, save its result for the parent."""
    if device_type == "cpu":
        torch.set_num_threads(threads)   # the ranks share the host's cores
    mesh = Mesh(dp, tp, device_type, rank)
    mesh.join(Path(tmp) / "store", timeout)
    try:
        result = fn(mesh, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(tmp) / f"rank{rank}.pt")


def launch(mesh: Mesh, fn, *args, timeout: Optional[float] = None) -> list:
    """fn(mesh as seen from each rank, *args) on every rank of `mesh`; returns
    the ranks' results in rank order. One rank runs in this process; more
    are spawned (`torch.multiprocessing.spawn`), so fn and args are pickled
    and fn must be importable by name. A rank that raises makes this raise
    (the others are ended); past `timeout` seconds (also each collective's
    limit) every rank is ended and TimeoutError raised."""
    if mesh.size == 1:
        return [fn(mesh, *args)]
    threads = max(1, torch.get_num_threads() // mesh.size)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        ctx = mp.spawn(_rank_main, args=(mesh.shape["dp"], mesh.shape["tp"], mesh.device_type,
                                         tmp, threads, timeout, fn, args),
                       nprocs=mesh.size, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None
                               else max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"{mesh}: the ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        # written by the ranks above, from this program's own results
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(mesh.size)]


def leads(mesh: Optional[Mesh]) -> bool:
    """Whether this process prints and writes: it runs alone, or is rank 0."""
    return mesh is None or mesh.rank == 0


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x whole on this rank's device: every rank holds all of it."""
    return x.to(mesh.device)


def shard_batch_dp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the batch x (axis 0 over 'dp'); the batch must
    divide by dp, as JAX's `device_put` requires."""
    dp = mesh.shape["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split over dp={dp}")
    rows = x.shape[0] // dp
    return x[mesh.dp_index * rows:(mesh.dp_index + 1) * rows]


def shard_params_tp(state_dict: dict, mesh: Mesh, cfg) -> dict:
    """JAX's tp rule for a model's state dict: key -> the axis sharded over
    'tp', or None. JAX shards the last axis of a flax leaf when it divides
    by tp and is at least tp * 8; that axis is found in the port's layout
    through the weight converter (`models.convert.flax_axes`): dim 0 of a
    Conv1d / Conv2d weight, the last of a `Dense` kernel, kept (in, out)."""
    from ..models.convert import flax_axes
    tp = mesh.shape["tp"]
    specs = {}
    for key, value in state_dict.items():
        if value.ndim == 0:
            specs[key] = None
            continue
        axis = flax_axes(key, value.ndim, cfg).index(value.ndim - 1)
        n = value.shape[axis]
        specs[key] = axis if n % tp == 0 and n >= tp * 8 else None
    return specs


def data_parallel_map(fn, mesh: Mesh):
    """batch -> fn over this rank's dp rows, gathered: the whole batch's
    result on every rank (the batch must divide by dp)."""
    def wrapper(batch: torch.Tensor) -> torch.Tensor:
        return mesh.gather(fn(shard_batch_dp(mesh, batch)))
    return wrapper


# ----------------------------------------------------- the sharded batch
_SHARDED: ContextVar = ContextVar("sharded_batch", default=None)


@contextlib.contextmanager
def sharded_batch(mesh: Optional[Mesh]):
    """Within: axis 0 of the batch tensors this rank computes on is its dp
    shard of the mesh's batch, and the `batch_*` functions act on the whole
    batch. With no mesh, or dp 1, they act on the tensors as they are."""
    token = _SHARDED.set(mesh if mesh is not None and mesh.shape["dp"] > 1 else None)
    try:
        yield
    finally:
        _SHARDED.reset(token)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A rank's generator: seeded alike on every rank, so that each draws
    the whole batch's values (`batch_randn`) and keeps its own rows."""
    return torch.Generator(device).manual_seed(seed)


def batch_randn(shape, generator: Optional[torch.Generator], dtype, device) -> torch.Tensor:
    """Normal draws of this rank's `shape`: the whole batch's draw (axis 0
    times dp) from `generator`, this rank's rows of it."""
    mesh = _SHARDED.get()
    if mesh is None:
        return randn(shape, generator, dtype, device)
    whole = randn((shape[0] * mesh.shape["dp"], *shape[1:]), generator, dtype, device)
    return shard_batch_dp(mesh, whole)


def batch_numel(x: torch.Tensor) -> int:
    """The whole batch's element count of a tensor whose rows are this rank's."""
    mesh = _SHARDED.get()
    return x.numel() * (1 if mesh is None else mesh.shape["dp"])


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the dp ranks of a partial computed from this rank's rows
    (not differentiable)."""
    mesh = _SHARDED.get()
    return x if mesh is None else mesh.reduce(x)


def batch_norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm of the whole batch of which x holds this rank's rows."""
    if _SHARDED.get() is None:
        return torch.linalg.vector_norm(x)
    return batch_sum(x.square().sum()).sqrt()


class _BatchMax(torch.autograd.Function):
    """max over the dp ranks of each rank's max; its gradient, summed over
    the ranks, goes to the rank that holds the maximum (the first on a tie)."""

    @staticmethod
    def forward(ctx, local_max, mesh):
        maxes = mesh.gather(local_max.reshape(1))
        ctx.mesh = mesh
        ctx.mine = torch.argmax(maxes) == mesh.dp_index
        return maxes.max()

    @staticmethod
    def backward(ctx, grad):
        total = ctx.mesh.reduce(grad.contiguous())
        return torch.where(ctx.mine, total, torch.zeros_like(total)), None


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum of the whole batch of which x holds this rank's rows,
    differentiable as `x.max()` is."""
    mesh = _SHARDED.get()
    return x.max() if mesh is None else _BatchMax.apply(x.max(), mesh)


def batch_any(flag: torch.Tensor) -> bool:
    """Whether the flag holds on any rank: one decision for the whole batch
    (a NaN in one rank's clip makes every rank retry, as in JAX, whose test
    reads the whole batch)."""
    mesh = _SHARDED.get()
    if mesh is None:
        return bool(flag)
    return bool(mesh.reduce(flag.to(torch.float32).reshape(1), dist.ReduceOp.MAX))
