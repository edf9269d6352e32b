"""Several processes, on one host or many, in one distributed solve.

Port of `hfvo_tpu.parallel.multihost` on `torch.distributed`. The JAX
package joins the `jax.distributed` runtime so that every host's chips form
one global mesh; here every process is one rank of the default process
group, joined over TCP, and the distributed solvers run unchanged over its
`parallel.mesh.make_mesh()` (collectives over NVLink / the network through
NCCL, or gloo on the CPU).

The host-side problem (keyframe window, edge tables) is replicated: each
process builds the same blocked problem and `globalize_sharded_ba` keeps its
own blocks, after checking that the ranks' problems are identical. That
mirrors how the tracker drives local BA: the map state is host-resident and
cheap next to the solve.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.batch import resolve_device
from .dist_ba import EDGE_FIELDS, REPL_FIELDS, ShardedBA
from .mesh import Mesh, init_process_group, take_blocks


def initialize(coordinator: str, num_processes: int, process_id: int, device="cuda",
               backend: Optional[str] = None) -> None:
    """Join the default process group at `coordinator` ("host:port", the
    rank-0 process listens there) as rank `process_id` of `num_processes`
    (hfvo_tpu/parallel/multihost.py:27-33); the backend follows `device`
    unless named (NCCL for the card, gloo for the CPU)."""
    init_process_group(f"tcp://{coordinator}", num_processes, process_id, device, backend)


def globalize_sharded_ba(sp: ShardedBA, mesh: Mesh, device="cuda") -> ShardedBA:
    """This rank's part of the blocked problem `sp`, which every rank built
    from the same host data: its block of each edge and landmark table and
    the replicated pose and anchor tables whole, as tensors on `device`
    (hfvo_tpu/parallel/multihost.py:37-68). Raises, on every rank, naming the
    fields, if the ranks' problems differ."""
    device = resolve_device(device)
    blocks = take_blocks(mesh, {f: getattr(sp, f) for f in EDGE_FIELDS + REPL_FIELDS}, EDGE_FIELDS)
    return sp._replace(**{k: torch.as_tensor(v).to(device) for k, v in blocks.items()})
