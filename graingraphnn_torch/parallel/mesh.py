"""Process groups of D ranks, one per stripe, and the three collectives the
partitioned rollout needs, on torch.distributed.

`launch(fn, D, ...)` spawns D ranks from one call, as one controller
drives D devices in the JAX package; each rank runs fn(mesh, *args) and
the call returns every rank's result. A `Mesh` is one rank's view of the
group: its rank, the group size D, its device and backend, and

  exchange(x)    the neighbour exchange of periodic stripes (JAX's two
                 ppermutes): (the left neighbour's x, the right one's);
  all_reduce(x)  sum or max over the ranks;
  all_gather(x)  every rank's x on a new leading axis [D, ...].

Backend rule, by where the ranks run: NCCL when each rank has a card of
its own; gloo on the CPU, and for several ranks that share one card.
gloo takes no CUDA tensors for these calls, so on a shared card every
collective stages its tensor through a host buffer and back; the first
line each rank prints names its backend and that transport. A failed
init or launch raises: there is no retry on another backend.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_MESH = None   # this process's Mesh, in a rank that launch started


@dataclasses.dataclass
class Mesh:
    """One rank's view of a process group of D ranks."""

    D: int
    rank: int
    backend: str            # "nccl" or "gloo"
    device: torch.device
    bytes_exchanged: int = 0   # sent by exchange() on this rank
    exchanges: int = 0

    @property
    def staged(self) -> bool:
        """Do collectives stage CUDA tensors through the host?"""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        if self.backend == "nccl":
            return "device buffers over NCCL"
        return ("host-staged buffers over gloo" if self.staged
                else "host buffers over gloo")

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.staged else x

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staged else x

    def exchange(self, x: torch.Tensor):
        """(from_left, from_right): rank r receives rank r-1's x and rank
        r+1's x, periodically. One rank is its own neighbour: over NCCL it
        sends to itself; gloo has no send to self, so there x comes back
        as it is."""
        if self.D == 1 and self.backend == "gloo":
            return x, x
        send = self._out(x)
        left, right = torch.empty_like(send), torch.empty_like(send)
        lo, hi = (self.rank - 1) % self.D, (self.rank + 1) % self.D
        ops = [dist.P2POp(dist.isend, send, hi),
               dist.P2POp(dist.isend, send, lo),
               dist.P2POp(dist.irecv, left, lo),
               dist.P2POp(dist.irecv, right, hi)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.bytes_exchanged += 2 * send.numel() * send.element_size()
        self.exchanges += 1
        return self._in(left), self._in(right)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum ("sum") or max ("max") of x over the ranks; bool x is
        reduced as int32 (max is or)."""
        kind = x.dtype
        buf = self._out(x.to(torch.int32) if kind == torch.bool else x)
        buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op])
        out = self._in(buf)
        return out > 0 if kind == torch.bool else out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x, stacked in rank order: [D, *x.shape]."""
        kind = x.dtype
        buf = self._out(x.to(torch.int32) if kind == torch.bool else x)
        parts = [torch.empty_like(buf) for _ in range(self.D)]
        dist.all_gather(parts, buf)
        out = self._in(torch.stack(parts))
        return out > 0 if kind == torch.bool else out

    def barrier(self):
        dist.barrier()


def choose_backend(D: int, device: str) -> str:
    """NCCL when each of the D ranks can have a card of its own; gloo on
    the CPU and for ranks that share a card."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= D else "gloo"


def _rank_device(rank: int, backend: str, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    # NCCL: a card per rank; gloo: the ranks share the first card
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _rank_entry(rank, D, backend, device, store, fn, args, results,
                threads):
    global _MESH
    out = None
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=D)
        mesh = _MESH = Mesh(D=D, rank=rank, backend=backend, device=dev)
        print(f"rank {rank}/{D}: backend {backend}, {mesh.transport}, "
              f"device {dev}", flush=True)
        out = ("ok", fn(mesh, *args))
    except BaseException:   # reported to the launcher, which raises
        out = ("error", traceback.format_exc())
    finally:
        # plain pickle: the queue's own would share tensors' memory with
        # this process, which ends before the launcher reads them
        results.put((rank, out[0], pickle.dumps(out[1])))
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, D: int, *args, device: str = "cuda",
           store_dir: Optional[str] = None,
           threads: int = 0, timeout: float = 3600.0) -> List:
    """Run fn(mesh, *args) on D ranks spawned together and return their
    results in rank order. fn and args must pickle (fn a module-level
    function). The ranks meet through a FileStore in store_dir (a fresh
    temporary directory when None), over choose_backend's backend.
    threads > 0 sets each
    rank's CPU threads. Raises RuntimeError with a failed rank's
    traceback; every rank process has ended when this returns or
    raises."""
    backend = choose_backend(D, device)
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="ggnn_store_")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, D, backend, device, store, fn, args,
                               results, threads), daemon=False)
             for r in range(D)]
    got, failed = {}, []
    t_end = time.time() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < D:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that crashed posts nothing
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failed.append(f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode}")
                    break
                if time.time() > t_end:
                    failed.append(f"timed out after {timeout} s")
                    break
                continue
            got[rank] = value = pickle.loads(value)
            if status != "ok":
                failed.append(f"rank {rank}:\n{value}")
                break
        if not failed:
            for p in procs:
                p.join(timeout=max(1.0, t_end - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if failed:
        raise RuntimeError("partitioned run failed: " + failed[0])
    return [got[r] for r in range(D)]


def current(D: int) -> Mesh:
    """This rank's Mesh, in a rank that launch started. Raises ValueError
    in a process outside a launch, or in a group of another size."""
    if _MESH is None or not dist.is_initialized():
        raise ValueError(
            f"a partitioned run of {D} ranks runs on the ranks of "
            "parallel.mesh.launch (this process is not one)")
    if _MESH.D != D:
        raise ValueError(f"partition={D}, but this rank's group has "
                         f"{_MESH.D} ranks")
    return _MESH
