"""Process groups of D ranks, laid out on named axes, and the collectives
the partitioned rollout and the distributed train steps need, on
torch.distributed.

`launch(fn, D, ...)` spawns D ranks from one call, as one controller
drives D devices in the JAX package; each rank runs fn(mesh, *args) and
the call returns every rank's result. A `Mesh` is one rank's view of the
group: its rank, the group size D, its device and backend, its named axes
(row-major, as JAX's make_mesh places devices: on axes (("dp", 2),
("gp", 2)) rank r sits at dp r // 2, gp r % 2; no axes is one axis over
all D ranks), and

  exchange(x, axis)    the neighbour exchange of periodic stripes (JAX's
                       two ppermutes): (the left neighbour's x, the right
                       one's) along the axis;
  all_reduce(x, op, axis)  sum or max over the axis's ranks;
  all_gather(x, axis)  every axis rank's x on a new leading axis [n, ...].

axis=None is the whole group. exchange and all_gather are differentiable
(torch.autograd.Function): the exchange's backward sends each cotangent
back to the neighbour it came from, the gather's sums the cotangents over
the axis and keeps this rank's slice (a reduce-scatter; gloo has none, so
an all-reduce and a slice). The backward moves its tensors by the
forward's transport. all_reduce stays outside autograd: its result has no
gradient.

Backend rule, by where the ranks run: NCCL when each rank has a card of
its own; gloo on the CPU, and for several ranks that share one card.
gloo takes no CUDA tensors for these calls, so on a shared card every
collective stages its tensor through a host buffer and back; the first
line each rank prints names its backend and that transport. A failed
init or launch raises: there is no retry on another backend.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_MESH = None   # this process's Mesh, in a rank that launch started

Axes = Tuple[Tuple[str, int], ...]


@dataclasses.dataclass
class Mesh:
    """One rank's view of a process group of D ranks."""

    D: int
    rank: int
    backend: str            # "nccl" or "gloo"
    device: torch.device
    axes: Axes = ()         # (name, size) row-major; () is one axis of D
    bytes_exchanged: int = 0   # sent by exchange() on this rank, both ways
    exchanges: int = 0         # exchange() calls (forward)
    bytes_gathered: int = 0    # sent by all_gather(), and its backward
    bytes_reduced: int = 0     # given to all_reduce()
    groups: Dict[str, object] = dataclasses.field(default_factory=dict,
                                                  repr=False)

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

    def size(self, axis: Optional[str] = None) -> int:
        """Ranks along `axis` (None: the whole group)."""
        return self.D if axis is None else dict(self.axes)[axis]

    def index(self, axis: Optional[str] = None) -> int:
        """This rank's coordinate along `axis` (None: its rank)."""
        if axis is None:
            return self.rank
        return _coords(self.rank, self.axes)[_axis_pos(self.axes, axis)]

    def peers(self, axis: Optional[str] = None) -> List[int]:
        """The global ranks of this rank's group along `axis`, in axis
        order."""
        if axis is None:
            return list(range(self.D))
        return _line(self.rank, self.axes, _axis_pos(self.axes, axis))

    def _group(self, axis):
        if axis is None or self.size(axis) == self.D:
            return None
        return self.groups[axis]

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.staged else x

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staged else x

    def _p2p(self, to_lo, to_hi, axis):
        """Send to_lo to the left neighbour along `axis` and to_hi to the
        right one; returns (from_lo, from_hi). With two ranks both
        neighbours are one rank, and the two messages match by order."""
        peers = self.peers(axis)
        n, i = len(peers), peers.index(self.rank)
        lo, hi = peers[(i - 1) % n], peers[(i + 1) % n]
        group = self._group(axis)
        s_lo = self._out(to_lo)
        s_hi = s_lo if to_hi is to_lo else self._out(to_hi)
        r_lo, r_hi = torch.empty_like(s_hi), torch.empty_like(s_lo)
        ops = [dist.P2POp(dist.isend, s_hi, hi, group),
               dist.P2POp(dist.isend, s_lo, lo, group),
               dist.P2POp(dist.irecv, r_lo, lo, group),
               dist.P2POp(dist.irecv, r_hi, hi, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.bytes_exchanged += (s_lo.numel() * s_lo.element_size()
                                 + s_hi.numel() * s_hi.element_size())
        return self._in(r_lo), self._in(r_hi)

    def exchange(self, x: torch.Tensor, axis: Optional[str] = None):
        """(from_left, from_right): the rank before this one along `axis`
        sends its x, and the rank after it, periodically. Differentiable.
        One rank is its own neighbour: over NCCL it sends to itself; gloo
        has no send to self, so there x comes back as it is."""
        if self.size(axis) == 1 and self.backend == "gloo":
            return x, x
        self.exchanges += 1
        return _Exchange.apply(x, self, axis)

    def all_reduce(self, x: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """Sum ("sum") or max ("max") of x over the ranks along `axis`;
        bool x is reduced as int32 (max is or). No gradient flows through
        it."""
        x = x.detach()
        kind = x.dtype
        buf = self._out(x.to(torch.int32) if kind == torch.bool else x)
        buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
        self.bytes_reduced += buf.numel() * buf.element_size()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self._group(axis))
        out = self._in(buf)
        return out > 0 if kind == torch.bool else out

    def _gather(self, x, axis):
        kind = x.dtype
        buf = self._out(x.to(torch.int32) if kind == torch.bool else x)
        parts = [torch.empty_like(buf) for _ in range(self.size(axis))]
        self.bytes_gathered += buf.numel() * buf.element_size()
        dist.all_gather(parts, buf, group=self._group(axis))
        out = self._in(torch.stack(parts))
        return out > 0 if kind == torch.bool else out

    def all_gather(self, x: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Every axis rank's x, stacked in axis order: [n, *x.shape].
        Differentiable in x (float x)."""
        if x.dtype.is_floating_point:
            return _AllGather.apply(x, self, axis)
        return self._gather(x, axis)

    def barrier(self):
        dist.barrier()


class _Exchange(torch.autograd.Function):
    """exchange as an autograd function: the backward returns the
    cotangent of from_left to the left neighbour and that of from_right
    to the right one; each rank sums what it receives into its x's
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._p2p(x, x, axis)

    @staticmethod
    def backward(ctx, g_left, g_right):
        from_lo, from_hi = ctx.mesh._p2p(g_left, g_right, ctx.axis)
        return from_lo + from_hi, None, None


class _AllGather(torch.autograd.Function):
    """all_gather as an autograd function; its backward is a
    reduce-scatter: the cotangents summed over the axis, this rank's
    slice kept."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        buf = mesh._out(g)
        buf = buf.clone() if buf.data_ptr() == g.data_ptr() else buf
        mesh.bytes_gathered += buf.numel() * buf.element_size()
        dist.all_reduce(buf, group=mesh._group(ctx.axis))
        return mesh._in(buf)[mesh.index(ctx.axis)], None, None


def _axis_pos(axes: Axes, axis: str) -> int:
    names = [a for a, _ in axes]
    if axis not in names:
        raise ValueError(f"no axis {axis!r} in the mesh's axes {axes}")
    return names.index(axis)


def _coords(rank: int, axes: Axes) -> List[int]:
    """The row-major coordinates of `rank` on `axes`."""
    out = []
    for _, n in reversed(axes):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def _line(rank: int, axes: Axes, pos: int) -> List[int]:
    """The global ranks that share every coordinate of `rank` but the
    pos-th, in the order of that coordinate."""
    stride = math.prod(n for _, n in axes[pos + 1:])
    base = rank - _coords(rank, axes)[pos] * stride
    return [base + k * stride for k in range(axes[pos][1])]


def check_axes(D: int, axes: Optional[Sequence[Tuple[str, int]]]) -> Axes:
    """axes as a tuple of (name, size) whose sizes multiply to D."""
    axes = tuple((str(a), int(n)) for a, n in (axes or ()))
    if axes and math.prod(n for _, n in axes) != D:
        raise ValueError(f"mesh axes {axes} do not multiply to {D} ranks")
    if len({a for a, _ in axes}) != len(axes):
        raise ValueError(f"repeated axis name in {axes}")
    return axes


def _make_groups(D: int, axes: Axes) -> Dict[str, object]:
    """This rank's process group along each axis that is not the whole
    group. Every rank creates every group, in one order, as
    torch.distributed requires."""
    rank = dist.get_rank()
    groups = {}
    for pos, (name, n) in enumerate(axes):
        if n == D:
            continue
        # one group per line of the axis, named by its first rank
        for r in range(D):
            if _coords(r, axes)[pos] == 0:
                line = _line(r, axes, pos)
                g = dist.new_group(line)
                if rank in line:
                    groups[name] = g
    return groups


def make_mesh(D: int, rank: int, backend: str, device: torch.device,
              axes: Optional[Sequence[Tuple[str, int]]] = None) -> Mesh:
    """The Mesh of this rank, in an initialised process group of D ranks;
    builds the axes' sub-groups (every rank must call it)."""
    axes = check_axes(D, axes)
    return Mesh(D=D, rank=rank, backend=backend, device=device, axes=axes,
                groups=_make_groups(D, axes))


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
                threads, axes):
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
        mesh = _MESH = make_mesh(D, rank, backend, dev, axes)
        print(f"rank {rank}/{D}: backend {backend}, {mesh.transport}, "
              f"device {dev}" + (f", axes {axes}" if axes else ""),
              flush=True)
        out = ("ok", fn(mesh, *pickle.loads(args)))
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
           threads: int = 0, timeout: float = 3600.0,
           axes: Optional[Sequence[Tuple[str, int]]] = None) -> List:
    """Run fn(mesh, *args) on D ranks spawned together and return their
    results in rank order. fn and args must pickle (fn a module-level
    function); each rank gets a copy of args of its own. The ranks meet through a FileStore in store_dir (a fresh
    temporary directory when None), over choose_backend's backend, and
    lie on `axes` ((name, size), ..., row-major; None: one axis).
    threads > 0 sets each
    rank's CPU threads. Raises RuntimeError with a failed rank's
    traceback; every rank process has ended when this returns or
    raises."""
    axes = check_axes(D, axes)
    backend = choose_backend(D, device)
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="ggnn_store_")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # plain pickle: torch.multiprocessing's would share the tensors'
    # memory among the launcher and the ranks, so a rank that trains a
    # model it was given would step every rank's copy at once
    payload = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, D, backend, device, store, fn, payload,
                               results, threads, axes), daemon=False)
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


def init_from_env(device: str = "cuda",
                  axes: Optional[Sequence[Tuple[str, int]]] = None) -> Mesh:
    """This process as one rank of a group set up from the environment
    (init_method "env://": MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE;
    LOCAL_RANK picks the card), the counterpart of
    jax.distributed.initialize(). Returns its Mesh."""
    global _MESH
    D = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    dev = torch.device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=D)
    _MESH = make_mesh(D, rank, backend, dev, axes)
    return _MESH
