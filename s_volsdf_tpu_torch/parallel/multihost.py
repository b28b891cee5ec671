"""Scenes over nodes, and the host process pool of fusion (counterpart of
s_volsdf_tpu/parallel/multihost.py).

Scenes share no state, so each node takes a round-robin slice of the
scan list and runs the whole per-scene pipeline (cascade, VolSDF,
fusion) on its own ranks; nothing crosses nodes but the files the
outputs land in. One node is the identity partition.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

from s_volsdf_tpu_torch.parallel.mesh import topology

T = TypeVar("T")


def partition_scenes(testlist: Sequence[T],
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[T]:
    """The round-robin slice of the scan list that this node owns (its
    node index of the node count by default; the JAX package's host
    index of the host count). The slices are disjoint and their union
    is `testlist`."""
    topo = topology()
    pi = topo.node if process_index is None else process_index
    pc = topo.nodes if process_count is None else process_count
    return list(testlist[pi::pc])


def map_scenes_host_pool(fn: Callable[[T], object], scenes: Sequence[T],
                         num_workers: int = 1) -> List[object]:
    """fn over the scenes in a pool of `num_workers` processes (the
    reference's mp.Pool of fusion); serial for num_workers <= 1 or one
    scene. The workers start by `spawn`, each with its own CUDA context
    (a forked child cannot use its parent's), so `fn` and its arguments
    must be picklable (module level) and name their device."""
    scenes = list(scenes)
    if num_workers <= 1 or len(scenes) <= 1:
        return [fn(s) for s in scenes]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(num_workers, len(scenes)),
                             mp_context=ctx) as pool:
        return list(pool.map(fn, scenes))
