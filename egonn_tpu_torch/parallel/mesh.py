"""Data parallelism over `torch.distributed` ranks (port of
`egonn_tpu/parallel/mesh.py`).

The JAX package shards the batch axis over a 1-D ('data',) device mesh and
replicates the parameters, the optimizer state and the (B, B) positive /
negative masks; XLA inserts the collectives, so the sharded step computes the
same function as the unsharded one.  Here the mesh is N processes, one rank
each, and the collectives are explicit:

* each rank holds its rows of the batch (`row_slice`);
* `all_gather_rows` concatenates every rank's rows (the batch-hard miner
  sees the global batch); its backward sums the gradient over the ranks and
  keeps the rank's rows;
* `all_reduce_sum` sums over the ranks, its backward too (BatchNorm's
  statistics and the local loss's global mean);
* `all_reduce_grads` sums every gradient in one collective over one flat
  buffer, `broadcast_module` copies rank 0's parameters and buffers.

Gradient rule: each rank's loss is its share L_r of the global loss L, with
sum_r L_r = L, so one SUM of the gradients gives exactly grad L (a loss that
every rank computes whole from gathered rows is L / world on each).

With `group` None every collective is the identity: a single process runs
the same code.  Backends: NCCL on the card, rank r on cuda:r; gloo on the
CPU, and on a card only when the caller names it (several ranks sharing one
card).  gloo's collectives on CUDA tensors are staged through host memory
here, explicitly.  `run_ranks` runs a function on N ranks: the calling
process is rank 0 and spawns the others.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import shutil
import tempfile
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a rank waits in init_process_group or in a collective, and the
# parent for a spawned rank to end, before it raises (read at each
# run_ranks call that names none)
DEFAULT_TIMEOUT_S = 600.0

# collectives issued since reset_collectives(): name -> [calls, bytes]
_COLLECTIVES: Dict[str, List[int]] = {}


def reset_collectives() -> None:
    _COLLECTIVES.clear()


def collective_counts() -> Dict[str, Dict[str, int]]:
    """{name: {"calls": n, "bytes": b}}: this rank's collectives since
    `reset_collectives`, each tensor's bytes counted once."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(_COLLECTIVES.items())}


def _count(name: str, t: torch.Tensor) -> None:
    entry = _COLLECTIVES.setdefault(name, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the mesh option, backends and groups
# ---------------------------------------------------------------------------

def resolve_mesh(mesh_opt, device) -> int:
    """The [TRAIN] mesh option as a number of ranks: None, "off", 0 and 1
    are one process; "auto" is every visible card on CUDA and one process
    on the CPU (ask for N explicitly there); an integer is that many."""
    if mesh_opt in (None, "off", "0", "1", 0, 1):
        return 1
    if mesh_opt == "auto":
        device = torch.device(device)
        return max(1, torch.cuda.device_count()) if device.type == "cuda" else 1
    n = int(mesh_opt)
    if n < 1:
        raise ValueError(f"mesh {mesh_opt!r}: expected auto, off or a positive integer")
    return n


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, group) -> torch.device:
    """The device this rank of `group` runs on: cuda:<rank> under NCCL (one
    card per rank), else `device` itself (gloo ranks share it; no group)."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", dist.get_rank(group))
    return torch.device(device)


def check_backend(device, backend: str, world: int) -> None:
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA devices")
        if world > torch.cuda.device_count():
            raise RuntimeError(f"NCCL with {world} ranks needs {world} cards, "
                               f"{torch.cuda.device_count()} visible (name backend 'gloo' "
                               "to share one card between ranks)")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")


def init_group(rank: int, world: int, init_method: str, backend: str, device,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group as `rank` of `world` and return it
    (`dist.group.WORLD`); under NCCL the rank's card becomes the current
    device first."""
    check_backend(device, backend, world)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def row_slice(n_rows: int, group) -> slice:
    """The rank's rows of a batch of n_rows (a multiple of the world size)."""
    world, rank = world_size(group), rank_of(group)
    if n_rows % world:
        raise ValueError(f"{n_rows} rows do not divide over {world} ranks")
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def pad_batch_to_devices(arrs, n_devices: int):
    """Pad axis 0 of every array of a (nested dict / list / tuple) tree to a
    multiple of n_devices by repeating the last row; callers mask the
    padding rows out of losses."""
    if isinstance(arrs, dict):
        return {k: pad_batch_to_devices(v, n_devices) for k, v in arrs.items()}
    if isinstance(arrs, (list, tuple)):
        return type(arrs)(pad_batch_to_devices(v, n_devices) for v in arrs)
    x = np.asarray(arrs)
    rem = (-x.shape[0]) % n_devices
    if rem == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _staged(group, t: torch.Tensor):
    """(tensor the collective runs on, copy back needed): gloo's CUDA
    tensors go through host memory."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t, False


def _all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM, name: str = "all_reduce"
                 ) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor."""
    _count(name, t)
    buf, back = _staged(group, t)
    dist.all_reduce(buf, op=op, group=group)
    if back:
        t.copy_(buf)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t concatenated along axis 0, in rank order."""
    _count("all_gather", t)
    buf, back = _staged(group, t.contiguous())
    parts = [torch.empty_like(buf) for _ in range(world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if back else out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = row_slice(x.shape[0] * world_size(group), group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group)
        return g[ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order (each rank holds
    the same number).  Backward: the gradient summed over the ranks, then
    this rank's rows."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return _all_gather(x.to(torch.uint8), group).to(torch.bool)
    return _AllGatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor); backward: the gradient
    summed over the ranks."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the ranks (no gradient)."""
    if group is None:
        return x
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), group,
                        dist.ReduceOp.MAX)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group) -> None:
    """Sum every parameter's gradient over the ranks with one all-reduce of
    one flat buffer (a missing gradient counts as zeros and is set)."""
    if group is None:
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    _all_reduce_(flat, group, name="all_reduce_grads")
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).clone()
        offset += n


def broadcast_module(module: torch.nn.Module, group) -> None:
    """Copy rank 0's parameters and buffers to every rank, in place."""
    if group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            _count("broadcast", t)
            buf, back = _staged(group, t.data.contiguous())
            dist.broadcast(buf, src=0, group=group)
            if back or buf.data_ptr() != t.data.data_ptr():
                t.data.copy_(buf)


def set_process_group(module: torch.nn.Module, group) -> None:
    """Hand `group` to every submodule that computes batch statistics (its
    `process_group` attribute): their train-mode statistics become those of
    the global batch."""
    for m in module.modules():
        if hasattr(m, "process_group"):
            m.process_group = group


# ---------------------------------------------------------------------------
# running a function on N ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, init_method, backend, device, timeout_s, num_threads, args,
               result_path):
    """A spawned rank: join the group, run fn, save its result (or the
    traceback) for the parent."""
    torch.set_num_threads(num_threads)
    try:
        group = init_group(rank, world, init_method, backend, device, timeout_s)
        try:
            out = ("ok", fn(group, *args))
        finally:
            destroy_group()
    except BaseException:
        out = ("error", traceback.format_exc())
    torch.save(out, result_path)
    if out[0] != "ok":
        raise SystemExit(1)


def run_ranks(fn, world: int, args: tuple = (), *, device="cpu", backend: Optional[str] = None,
              init_method: Optional[str] = None, timeout_s: Optional[float] = None,
              rank0_kwargs: Optional[dict] = None) -> list:
    """Run fn(group, *args) on `world` ranks and return their results in
    rank order.  This process is rank 0 (with `rank0_kwargs` added: what
    only rank 0 takes, such as a callback); ranks 1.. are `spawn`ed
    processes (fn, args and their results must pickle), which set as many
    intra-op threads as this process has.  init_method defaults to a file
    in a new temporary directory, timeout_s to DEFAULT_TIMEOUT_S.  A rank
    that fails raises here with its traceback; one that does not end within
    timeout_s of rank 0's end is killed, and raises too."""
    backend = backend or default_backend(device)
    timeout_s = timeout_s or DEFAULT_TIMEOUT_S
    check_backend(device, backend, world)
    tmp = tempfile.mkdtemp(prefix="egonn_ranks_")
    init_method = init_method or f"file://{os.path.join(tmp, 'init')}"
    ctx = multiprocessing.get_context("spawn")
    procs = []
    try:
        for rank in range(1, world):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(fn, rank, world, init_method, backend, device, timeout_s,
                                  torch.get_num_threads(), args,
                                  os.path.join(tmp, f"rank{rank}.pt")))
            p.start()
            procs.append(p)
        group = init_group(0, world, init_method, backend, device, timeout_s)
        try:
            results = [fn(group, *args, **(rank0_kwargs or {}))]
        finally:
            destroy_group()
        for rank, p in enumerate(procs, start=1):
            p.join(timeout_s)
            if p.is_alive():
                raise TimeoutError(f"rank {rank} did not end within {timeout_s} s")
            path = os.path.join(tmp, f"rank{rank}.pt")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {rank} exited with code {p.exitcode} and no result")
            status, value = torch.load(path, weights_only=False)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results.append(value)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def quiet_unless_rank0(group):
    """Silence stdout on every rank but 0 (rank 0 alone prints)."""
    if rank_of(group) == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield
