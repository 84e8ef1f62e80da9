"""The process group, the rank helpers and the collectives of data-parallel
training: the gradients' average, the run directory's broadcast and the
validation metrics' sums. Counterpart of ``sgmse_tpu/parallel/mesh.py`` and of the
multi-host parts of ``sgmse_tpu/train.py`` and ``cli/train.py``.

One process is one rank and holds one device. The group is started from the
JAX CLI's bootstrap flags (``--coordinator_address host:port
--num_processes P --process_id p``), from torchrun's or SLURM's environment
(``--distributed auto``), or by :func:`spawn`, which starts the ranks of one
host itself (``--devices N``). The backend is NCCL for CUDA devices and gloo
for the CPU; :func:`init_process_group` takes another only when a caller names
it (two ranks on one card cannot share it under NCCL, so the on-card check of
two ranks names gloo).

Without a group every helper answers for a world of one: rank 0, which is
the main process.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(init_method: str, world_size: int, rank: int, device,
                       backend: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Join the group as ``rank`` of ``world_size`` at ``init_method``
    (``tcp://host:port`` or ``file://path``), on ``device``: NCCL for a CUDA
    device, gloo for the CPU, unless ``backend`` names one. ``timeout``
    (seconds) bounds the wait in a collective, PyTorch's default otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    extra = {} if timeout is None else dict(timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend or backend_for(device), init_method=init_method,
                            world_size=world_size, rank=rank, **extra)


def comm_device() -> torch.device:
    """Where the tensors of a collective live: the current CUDA device under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def bootstrap(coordinator_address: Optional[str], num_processes: Optional[int],
              process_id: Optional[int], distributed: str = "none") -> Optional[dict]:
    """``init_method``, ``world_size``, ``rank`` and ``local_rank`` (or None:
    pick the device from the rank) of the bootstrap flags, as ``cli/train.py``
    takes them: the explicit three, or with ``distributed="auto"`` torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``,
    ``SLURM_LOCALID``, with ``MASTER_ADDR``/``MASTER_PORT`` set by the job).
    None when the process runs alone."""
    env = os.environ
    if coordinator_address or num_processes is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("--coordinator_address, --num_processes and --process_id go "
                             "together")
        return dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                    rank=int(process_id), local_rank=None)
    if distributed == "auto":
        if "RANK" in env and "WORLD_SIZE" in env:
            r, w, local = int(env["RANK"]), int(env["WORLD_SIZE"]), env.get("LOCAL_RANK")
        elif "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
            r, w, local = (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                           env.get("SLURM_LOCALID"))
        else:
            raise RuntimeError("--distributed auto: neither torchrun's environment (RANK, "
                               "WORLD_SIZE) nor SLURM's (SLURM_PROCID, SLURM_NTASKS) is set")
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("--distributed auto needs MASTER_ADDR and MASTER_PORT")
        return dict(init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                    world_size=w, rank=r, local_rank=None if local is None else int(local))
    if int(env.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("WORLD_SIZE > 1 in the environment (torchrun?): pass "
                           "--distributed auto, or every process trains alone")
    return None


def rank_device(device_type: str, rank: int, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (the rank modulo the visible
    cards where no local rank is known), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    index = local_rank if local_rank is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def broadcast_str(s: str, size: int = 64) -> str:
    """Rank 0's ``s`` (at most ``size`` bytes) on every rank: the run
    directory's version, which every rank must agree on
    (``sgmse_tpu/train.py:186-196``)."""
    if world() == 1:
        return s
    buf = torch.zeros(size, dtype=torch.uint8)
    if rank() == 0:
        enc = s.encode()[:size]
        buf[:len(enc)] = torch.tensor(list(enc), dtype=torch.uint8)
    buf = buf.to(comm_device())
    dist.broadcast(buf, 0)
    return bytes(buf.cpu().tolist()).rstrip(b"\0").decode()


def average_(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced in place by its mean over the ranks of the group (NCCL
    averages in the collective; gloo sums, then ``t`` is divided by the
    world size); without a group, ``t``."""
    if initialized():
        if dist.get_backend() == "nccl":
            dist.all_reduce(t, op=dist.ReduceOp.AVG)
        else:
            dist.all_reduce(t)
            t.div_(world())
    return t


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements in the order they lie in memory, as a 1-D view where
    ``t`` is dense in any layout (a channels-last gradient too), else a copy."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda d: d[1]):
        if size != 1 and stride != expected:
            return t.reshape(-1)
        expected *= size
    return t.as_strided((t.numel(),), (1,))


def average_all_(tensors: List[torch.Tensor]) -> None:
    """Every tensor of the list (one dtype, one device) replaced in place by
    its mean over the ranks, in one all-reduce of their concatenation (a
    group of one runs it too, so that its cost shows); without a group,
    nothing. The tensors are taken in their memory order, so an elementwise
    mean needs no copy to or from another layout, and they go into the flat
    buffer and back by two ``_foreach_copy_`` calls (``torch.cat`` of the
    flagship's 646 gradients ran at a quarter of the card's memory rate)."""
    if not initialized() or not tensors:
        return
    views = [_memory_order(t) for t in tensors]
    flat = torch.empty(sum(v.numel() for v in views), dtype=views[0].dtype,
                       device=views[0].device)
    parts = list(flat.split([v.numel() for v in views]))
    torch._foreach_copy_(parts, views)
    average_(flat)
    torch._foreach_copy_(views, parts)
    for t, v in zip(tensors, views):
        if v.data_ptr() != t.data_ptr():  # a copy, not a view: write it back
            t.copy_(v.view(t.shape))


def reduce_sums(sums: Dict[str, Tuple[float, float]]) -> Dict[str, Tuple[float, float]]:
    """Every rank's ``{metric: (sum, count)}`` summed over the ranks, in one
    ``all_gather`` (``sgmse_tpu/train.py:409-423``); every rank gets the same
    totals, added in rank order."""
    if world() == 1:
        return sums
    names = sorted(sums)
    local = torch.tensor([[sums[k][0] for k in names], [sums[k][1] for k in names]],
                         dtype=torch.float64, device=comm_device())
    gathered = [torch.empty_like(local) for _ in range(world())]
    dist.all_gather(gathered, local)
    totals = torch.stack(gathered).sum(0).cpu()
    return {k: (float(totals[0, i]), float(totals[1, i])) for i, k in enumerate(names)}


def _rank_entry(target: Callable, rank: int, world_size: int, init_method: str, inbox,
                results) -> None:
    try:
        value = target(rank, world_size, init_method, *inbox.get())
    except BaseException:  # noqa: BLE001 - the launcher raises it; this rank exits non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if initialized():
            dist.destroy_process_group()
    results.put((rank, True, value))


def spawn(target: Callable, world_size: int, args: tuple = (),
          timeout: Optional[float] = None) -> List:
    """Run ``target(rank, world_size, init_method, *args)`` in ``world_size``
    new processes (the ``spawn`` start method) and return their results by
    rank. ``target`` is a module-level function, and it joins the group at
    ``init_method`` (a ``file://`` rendezvous in a fresh temporary directory).
    A rank that raises or dies ends the others, and so does ``timeout``
    seconds passing; either raises here. ``args`` go through a queue once the
    ranks run, not through the start: a child that dies before it has read
    its start-up data leaves its parent blocked in ``Process.start`` once that
    data outgrows the pipe's buffer."""
    ctx = mp.get_context("spawn")
    rendezvous = tempfile.mkdtemp(prefix="sgmse_rendezvous_")
    init_method = "file://" + os.path.join(rendezvous, "store")
    results = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(world_size)]
    procs = [ctx.Process(target=_rank_entry, name=f"sgmse-rank-{r}", daemon=True,
                         args=(target, r, world_size, init_method, inboxes[r], results))
             for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        for p, inbox in zip(procs, inboxes):
            p.start()
            inbox.put(args)
        while len(out) < world_size:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(p.name, p.exitcode) for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited without a result: {dead}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks ran past {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out[r] = value
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if len(out) < world_size and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        for q in (results, *inboxes):
            q.cancel_join_thread()  # what a dead rank never read is dropped
            q.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [out[r] for r in range(world_size)]
