"""Process groups for multi-device runs (counterpart of
s_volsdf_tpu/parallel/mesh.py).

One process a card, launched by torchrun, each rank bound to
cuda:LOCAL_RANK (`init_process_group`). What the JAX package does over a
host's devices, the port does over the node's ranks:

  JAX                          port
  a host's jax.devices()       the node's ranks (LOCAL_RANK of
                               LOCAL_WORLD_SIZE; the node is GROUP_RANK)
  Mesh(shape, axes)            `RankMesh` (`make_group`): the node's
                               first prod(shape) ranks arranged as shape,
                               with a process group along each axis
  eval_mesh(cfg, chunk)        `eval_group(cfg, chunk)`, the same gates
  lax.pmean of the gradients   `Group.mean_flat`: one all_reduce of the
                               tensors flattened into one buffer
  a sharded output             `Group.gather_rows`: an all_reduce of
                               zero-filled buffers in which each rank
                               writes its own rows

Gloo has only all_reduce and broadcast for CUDA tensors, so the gathers
are all_reduces and every collective here works on both backends: NCCL
on "cuda", gloo on "cpu" (a `backend=` argument of
`init_process_group` overrides the choice: the smoke run puts gloo ranks
on one card, which NCCL refuses).

Without a process group (no WORLD_SIZE, or WORLD_SIZE=1 and nothing set
up) every helper here returns None and the callers run as one process.
A collective that fails raises; nothing falls back to one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place: its rank of `world`, its rank on its node
    (`local_rank` of `local_world`), and its node of `nodes`."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    node: int = 0
    nodes: int = 1

    @property
    def node_ranks(self) -> Tuple[int, ...]:
        first = self.node * self.local_world
        return tuple(range(first, first + self.local_world))


class _State:
    """The process group this process set up: its topology, its card (or
    the CPU) and the groups made since, by their ranks. torch.distributed
    itself is per process, and so is this."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.topology: Optional[Topology] = None
        self.device: Optional[torch.device] = None
        self.groups: Dict[Tuple[int, ...], Any] = {}


_STATE = _State()


def split_rows(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows [start, stop) of part `index` of n rows in `parts` contiguous
    parts whose sizes differ by at most one (numpy's array_split)."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


class Group:
    """Ranks that run one layout together: `ranks` (global ranks, in the
    layout's order), `size`, `index` (this rank's place in `ranks`) and
    the process group `pg` its collectives go through."""

    def __init__(self, ranks: Sequence[int], pg):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.pg = pg

    @property
    def first(self) -> bool:
        return self.index == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's rows [start, stop) of n (`split_rows`)."""
        return split_rows(n, self.size, self.index)

    def mean_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the group of each tensor (one dtype), through one
        all_reduce of them all flattened into one buffer, divided by the
        group's size (lax.pmean). With one rank it returns the values
        bit for bit."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.pg)
        flat.div_(self.size)
        return [x.view_as(t) for x, t in
                zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of the ranks' scalar x."""
        y = x.detach().reshape(1).clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.pg)
        return y[0]

    def gather_rows(self, local: torch.Tensor, start: int, n: int
                    ) -> torch.Tensor:
        """The (n, ...) tensor whose rows [start, start + len(local)) are
        this rank's `local`, each rank writing its own rows: an all_reduce
        of zero-filled buffers (gloo has no all_gather for CUDA tensors).
        Adding zeros leaves every value as it is."""
        buf = local.new_zeros((n,) + tuple(local.shape[1:]))
        buf[start:start + local.shape[0]] = local
        dist.all_reduce(buf, group=self.pg)
        return buf

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int) -> None:
        """Each tensor, in place, from the rank at place `src`."""
        for t in tensors:
            dist.broadcast(t, src=self.ranks[src], group=self.pg)

    def broadcast_object(self, obj: Any, src: int) -> Any:
        """A picklable object from the rank at place `src`."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[src], group=self.pg)
        return box[0]

    def share(self, tree: Any, src: int) -> Any:
        """A tree (dicts, lists, tuples; tensor leaves, other leaves
        pickled) from the rank at place `src`, on every rank: its layout
        broadcast first, then each tensor into a buffer of its shape,
        dtype and device. The source rank gets its own tree back."""
        leaves: List[torch.Tensor] = []
        spec = _spec(tree, leaves) if self.index == src else None
        spec = self.broadcast_object(spec, src)
        if self.index == src:
            self.broadcast([t.contiguous() for t in leaves], src)
            return tree
        dev = _STATE.device or torch.device("cpu")
        bufs = []
        out = _build(spec, lambda shape, dtype: bufs.append(
            torch.empty(shape, dtype=dtype, device=dev)) or bufs[-1])
        self.broadcast(bufs, src)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def _spec(tree: Any, leaves: List[torch.Tensor]):
    """The layout of a tree for `Group.share`, its tensors appended to
    `leaves` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return ("dict", [(k, _spec(v, leaves)) for k, v in tree.items()])
    if type(tree) in (list, tuple):
        return (type(tree).__name__, [_spec(v, leaves) for v in tree])
    return ("value", tree)


def _build(spec, new: Callable) -> Any:
    kind, body = spec[0], spec[1]
    if kind == "tensor":
        return new(body, spec[2])
    if kind == "dict":
        return {k: _build(v, new) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_build(v, new) for v in body]
        return items if kind == "list" else tuple(items)
    return body


def _env_int(env, name: str, default: int) -> int:
    return int(env.get(name, default))


def init_process_group(device="cuda", *, backend: Optional[str] = None,
                       init_method: str = "env://", env=None) -> Topology:
    """Set up the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK; MASTER_ADDR and
    MASTER_PORT for the default `init_method`) and bind the rank to its
    device: "cuda" is cuda:LOCAL_RANK (`torch.cuda.set_device` before
    anything is allocated), "cuda:<k>" that card, "cpu" the CPU. The
    backend is NCCL on a card and gloo on the CPU unless `backend` names
    one. A rank without its card raises, and so does a failed set-up:
    nothing carries on as one process. Returns the topology."""
    if dist.is_initialized():
        raise RuntimeError("init_process_group: a process group is "
                           "already set up in this process")
    env = os.environ if env is None else env
    world = _env_int(env, "WORLD_SIZE", 1)
    rank = _env_int(env, "RANK", 0)
    local_rank = _env_int(env, "LOCAL_RANK", rank)
    local_world = _env_int(env, "LOCAL_WORLD_SIZE", world)
    if world % local_world:
        raise ValueError(f"WORLD_SIZE={world} is not a whole number of "
                         f"nodes of LOCAL_WORLD_SIZE={local_world}")
    topo = Topology(rank=rank, world=world, local_rank=local_rank,
                    local_world=local_world,
                    node=_env_int(env, "GROUP_RANK", rank // local_world),
                    nodes=world // local_world)
    dev = torch.device(device)
    if dev.type == "cuda":
        index = local_rank if dev.index is None else dev.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: no CUDA device cuda:{index} (LOCAL_RANK "
                f"{local_rank}; {torch.cuda.device_count()} visible)")
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _STATE.topology, _STATE.device = topo, dev
    # Every rank makes every node's group, in one order (new_group is a
    # collective of the whole world); each keeps its own.
    for n in range(topo.nodes):
        ranks = tuple(range(n * local_world, (n + 1) * local_world))
        pg = dist.group.WORLD if topo.nodes == 1 else dist.new_group(ranks)
        if n == topo.node:
            _STATE.groups[ranks] = pg
    return topo


@contextlib.contextmanager
def launched(device=None):
    """The command lines' set-up: under torchrun with WORLD_SIZE > 1 (and
    no group yet) the process group on `device` ("cuda" when None), torn
    down on exit; yields the device the command runs on: this rank's
    under a group, else `device` as given."""
    mine = (not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if mine:
        init_process_group("cuda" if device is None else device)
    try:
        yield rank_device() if dist.is_initialized() else device
    finally:
        if mine:
            shutdown()


def shutdown() -> None:
    """Tear the process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.reset()


def topology() -> Topology:
    """This process's topology; one rank of one without a process
    group."""
    return _STATE.topology or Topology()


def rank_device() -> Optional[torch.device]:
    """The device `init_process_group` bound this rank to, or None."""
    return _STATE.device


def is_writer() -> bool:
    """Whether this rank writes the node's files (checkpoints, plots,
    depth maps, point clouds): its first rank, or a single process."""
    return topology().local_rank == 0


def _group(ranks: Sequence[int]) -> Optional[Group]:
    """The Group of `ranks` (global ranks of this node, this one among
    them), its process group made once: only its members make it
    (`use_local_synchronization`), in the order they all follow."""
    ranks = tuple(int(r) for r in ranks)
    if dist.get_rank() not in ranks:
        return None
    if ranks not in _STATE.groups:
        if sorted(ranks) == list(range(dist.get_world_size())):
            _STATE.groups[ranks] = dist.group.WORLD
        else:
            _STATE.groups[ranks] = dist.new_group(
                sorted(ranks), use_local_synchronization=True)
    return Group(ranks, _STATE.groups[ranks])


def node_group() -> Optional[Group]:
    """The ranks of this node, or None without a process group."""
    if not dist.is_initialized():
        return None
    return _group(topology().node_ranks)


class RankMesh:
    """The counterpart of a jax Mesh over the node's ranks: `ranks` (the
    global ranks, an int array of the mesh's shape), `axis_names`,
    `shape` ({axis: size}) and this rank's `coords` in it (None for a
    rank outside it)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.ranks = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        hit = np.argwhere(ranks == dist.get_rank())
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axis: str) -> Optional[Group]:
        """The ranks that share this rank's coordinates on every other
        axis, in order along `axis` (None for a rank outside the
        mesh)."""
        if self.coords is None:
            return None
        idx = list(self.coords)
        idx[self.axis_names.index(axis)] = slice(None)
        return _group(self.ranks[tuple(idx)].reshape(-1))


def make_group(shape: Sequence[int] = (-1,),
               axis_names: Sequence[str] = ("rays",),
               ranks: Optional[Sequence[int]] = None) -> Optional[RankMesh]:
    """The node's ranks (or `ranks`) as a RankMesh of `shape`; -1 absorbs
    the ranks left (counterpart of make_mesh). None without a process
    group."""
    if not dist.is_initialized():
        return None
    ranks = list(ranks) if ranks is not None else list(topology().node_ranks)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = len(ranks) // known
    total = int(np.prod(shape))
    if total > len(ranks) or total < 1:
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} ranks; "
                         f"the node has {len(ranks)}")
    return RankMesh(np.asarray(ranks[:total]).reshape(shape), axis_names)


def eval_group(parallel_cfg, chunk: int) -> Optional[Group]:
    """The group that shards a full-image render's (or an SDF grid's)
    chunks, or None to run it on this rank alone (counterpart of
    eval_mesh, with its gates): parallel.shard_eval, more than one rank,
    a chunk that the group's size divides. A flat group over the node's
    ranks whatever the training mesh's shape, bounded by a mesh_shape
    sized below them. A rank outside that bound gets None and runs the
    whole render itself."""
    if not dist.is_initialized():
        return None
    node = topology().node_ranks
    n = len(node)
    shape = getattr(parallel_cfg, "mesh_shape", None)
    if shape and -1 not in shape:
        n = min(n, int(np.prod(shape)))
    if not getattr(parallel_cfg, "shard_eval", False) or n <= 1:
        return None
    if chunk % n != 0:
        return None
    return _group(node[:n])


# --------------------------------------------------------------------------
# Ranks on one machine: the CPU tests, the dry run and the smoke run.
# --------------------------------------------------------------------------

def _rank_main(fn, rank: int, n: int, workdir: str, device: str,
               backend: Optional[str], args: tuple) -> None:
    env = {"RANK": rank, "WORLD_SIZE": n, "LOCAL_RANK": rank,
           "LOCAL_WORLD_SIZE": n, "GROUP_RANK": 0}
    os.environ.update({k: str(v) for k, v in env.items()})
    torch.set_num_threads(1)
    init_process_group(device, backend=backend,
                       init_method="file://" + os.path.join(workdir, "store"))
    try:
        result = fn(*args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        shutdown()
    with open(os.path.join(workdir, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_local_ranks(fn: Callable, n: int, *args, device: str = "cpu",
                    backend: Optional[str] = None, timeout: float = 600.0
                    ) -> List[Any]:
    """fn(*args) in n spawned ranks of one process group on this machine
    (a FileStore in a temporary directory, so no port is fixed), each
    with one torch thread, bound to `device` ("cpu", or "cuda:<k>" for
    ranks sharing one card); returns each rank's result (pickled back).
    `fn` must be importable by name (module level). A rank that raises,
    exits non-zero or outlives `timeout` seconds makes this raise, and
    every rank still running is killed."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, workdir, device, backend, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung or failed:
            raise RuntimeError(
                f"{getattr(fn, '__name__', fn)} on {n} ranks: "
                + (f"ranks {hung} still running after {timeout:.0f} s; "
                   if hung else "")
                + (f"(rank, exit code) {failed}" if failed else ""))
        out = []
        for r in range(n):
            with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
