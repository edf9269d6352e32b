"""The process-group layout of the distributed solvers: a ('seq', 'edge') mesh.

Port of `hfvo_tpu.parallel.mesh` on `torch.distributed`. The JAX package is
one controller over a device `Mesh` whose `shard_map` bodies reduce with
`psum` / `pmin` / `all_gather`. Here every rank is a process that runs the
same program (SPMD), and the mesh is this rank's place in a grid of the
process group's ranks, laid out as the JAX package's
`devs.reshape(n_seq, n_edge)` (hfvo_tpu/parallel/mesh.py:16-22): rank
`seq * n_edge + edge`. Its `edge` sub-group is its row (the ranks that share
one edge-sharded solve), its `seq` sub-group its column (the ranks that split
independent sequences).

The solvers' collectives live here, one for one with the JAX package's:
`psum` -> `all_reduce(SUM)`, `pmin` -> `all_reduce(MIN)`, tiled `all_gather`
-> `all_gather_into_tensor` over equal blocks, plus a broadcast from the
group's first rank; `device_put` to `P("edge")` becomes `block`, this rank's
block of a replicated host array. A collective over an axis of size 1 is the
identity and launches nothing. `counts` counts the collectives launched, by
name.

The backend follows the device: NCCL for `cuda`, gloo for `cpu`. A caller
may name gloo for CUDA tensors (several ranks on one GPU, which NCCL
refuses); gloo has no CUDA path for some collectives, so with gloo every
collective of a CUDA tensor goes through host memory. Every process group
gets a timeout (`TIMEOUT_S`): a rank that waits on a collective that another
rank skipped fails instead of hanging.
"""
from __future__ import annotations

import collections
import datetime
import hashlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.batch import resolve_device

TIMEOUT_S = 60


def init_process_group(init_method: str, world_size: int, rank: int, device="cuda",
                       backend: Optional[str] = None, timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group (`tcp://host:port` or `file://path`);
    the backend follows `device` unless named. A failure raises: nothing
    falls back to a single process."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """This rank's place in the ('seq', 'edge') grid and its collectives.

    `shape` is {"seq": n_seq, "edge": n_edge}; `coords[axis]` this rank's
    coordinate on an axis; `groups[axis]` the sub-group of an axis of more
    than one rank."""

    def __init__(self, n_seq: int, n_edge: int, coords: Dict[str, int], groups: Dict[str, object],
                 backend: Optional[str]):
        self.shape = {"seq": n_seq, "edge": n_edge}
        self.coords = coords
        self.groups = groups
        self.backend = backend
        self.counts = collections.Counter()

    @property
    def size(self) -> int:
        return self.shape["seq"] * self.shape["edge"]

    # ---- sharding of replicated host arrays --------------------------------

    def block_range(self, n: int, axis: str = "edge") -> slice:
        """This rank's rows of a leading axis of `n` rows split over `axis`."""
        k = self.shape[axis]
        if n % k:
            raise ValueError(f"a leading axis of {n} rows does not split over the {k} ranks of '{axis}'")
        b = n // k
        i = self.coords[axis]
        return slice(i * b, (i + 1) * b)

    def block(self, a, axis: str = "edge"):
        """This rank's block of the leading axis of `a` (the JAX package's
        `device_put` to `P(axis)`)."""
        return a[self.block_range(a.shape[0], axis)]

    def check_identical(self, fields: Mapping[str, object], axis: str = "edge") -> None:
        """Raise, on every rank of `axis`, if the ranks do not hold the same
        host arrays `fields` (the premise of an edge-sharded solve: every rank
        builds the same host problem and keeps its own block). One broadcast
        of per-field digests and one sum of the mismatches."""
        if self.shape[axis] == 1:
            return
        names = list(fields)
        # NCCL reduces CUDA tensors only.
        dev = torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" else "cpu"
        digest = torch.tensor([_digest(fields[n]) for n in names], dtype=torch.int64, device=dev)
        ref = self.broadcast(digest.clone(), axis)
        bad = self.psum((digest != ref).to(torch.int64), axis)
        if bool(bad.any()):
            which = [n for n, b in zip(names, bad.tolist()) if b]
            raise RuntimeError(f"the ranks of '{axis}' hold different host problems: fields {which} differ")

    # ---- collectives ----------------------------------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def psum(self, x: torch.Tensor, axis: str = "edge") -> torch.Tensor:
        """Sum of `x` over the ranks of `axis` (`jax.lax.psum`)."""
        return self._all_reduce(x, dist.ReduceOp.SUM, axis, "psum")

    def psum_all(self, *xs: torch.Tensor, axis: str = "edge") -> list:
        """`psum` of several tensors of one dtype with one all-reduce."""
        if self.shape[axis] == 1:
            return list(xs)
        flat = self.psum(torch.cat([x.reshape(-1) for x in xs]), axis)
        return [f.reshape(x.shape) for f, x in zip(flat.split([x.numel() for x in xs]), xs)]

    def pmin(self, x: torch.Tensor, axis: str = "edge") -> torch.Tensor:
        """Minimum of `x` over the ranks of `axis` (`jax.lax.pmin`); a bool
        reduces as its int."""
        if x.dtype == torch.bool:
            return self._all_reduce(x.to(torch.int32), dist.ReduceOp.MIN, axis, "pmin") > 0
        return self._all_reduce(x, dist.ReduceOp.MIN, axis, "pmin")

    def _all_reduce(self, x, op, axis, name):
        if self.shape[axis] == 1:
            return x
        self.counts[name] += 1
        buf = x.detach().to("cpu", copy=True) if self._staged(x) else x.detach().clone()
        dist.all_reduce(buf, op=op, group=self.groups[axis])
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str = "edge") -> torch.Tensor:
        """Blocks of the ranks of `axis`, concatenated in rank order along the
        leading axis (`jax.lax.all_gather(..., tiled=True)`); every rank's
        block has the same shape."""
        k = self.shape[axis]
        if k == 1:
            return x
        self.counts["all_gather"] += 1
        src = x.detach().to("cpu") if self._staged(x) else x.detach()
        src = src.contiguous()
        out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
        _all_gather_single(out, src, group=self.groups[axis])
        return out.to(x.device)

    def broadcast(self, x: torch.Tensor, axis: str = "edge") -> torch.Tensor:
        """The first rank of `axis`'s `x` on every rank of it."""
        if self.shape[axis] == 1:
            return x
        self.counts["broadcast"] += 1
        g = self.groups[axis]
        buf = x.detach().to("cpu", copy=True) if self._staged(x) else x.detach().clone()
        dist.broadcast(buf, src=dist.get_process_group_ranks(g)[0], group=g)
        return buf.to(x.device)


# `all_gather_into_tensor` was renamed `all_gather_single`; same arguments.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _digest(a) -> int:
    """A 56-bit digest of an array's dtype, shape and bytes."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    h = hashlib.blake2b(digest_size=7)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little")


def make_mesh(n_edge: Optional[int] = None, n_seq: int = 1, group=None) -> Mesh:
    """This rank's ('seq', 'edge') mesh over the ranks of `group` (the default
    group when None): `n_seq` rows of `n_edge` ranks (every rank of the group
    when `n_edge` is None). Without an initialized process group it is the
    1-rank mesh. Every rank of the default group must call it with the same
    arguments: it creates the sub-groups that do not span `group`
    (`dist.new_group`, collective over the default group), in one order."""
    if not dist.is_initialized():
        if (n_edge or 1) * n_seq != 1:
            raise RuntimeError(f"a {n_seq} x {n_edge} mesh needs an initialized process group")
        return Mesh(1, 1, {"seq": 0, "edge": 0}, {}, None)
    group = group or dist.group.WORLD
    ranks = dist.get_process_group_ranks(group)
    world = len(ranks)
    if n_edge is None:
        n_edge = world // n_seq
    if n_seq * n_edge != world:
        raise ValueError(f"a {n_seq} x {n_edge} mesh does not cover the group's {world} ranks")
    me = dist.get_rank()
    grid = np.asarray(ranks).reshape(n_seq, n_edge)
    s, e = (int(v[0]) for v in np.nonzero(grid == me))
    groups = {}
    for axis, lines in (("edge", grid), ("seq", grid.T)):
        if lines.shape[1] == 1:
            continue
        for line in lines:
            line = [int(r) for r in line]
            if len(line) == world:
                g = group
            else:
                g = dist.new_group(line, timeout=datetime.timedelta(seconds=TIMEOUT_S))
            if me in line:
                groups[axis] = g
    return Mesh(n_seq, n_edge, {"seq": s, "edge": e}, groups, dist.get_backend(group))


def edge_sharding(mesh: Mesh, a):
    """This rank's block of the leading (edge or landmark) axis of `a`."""
    return mesh.block(a, "edge")


def replicated(mesh: Mesh, a):
    """`a` whole: every rank holds all of it."""
    return a


def take_blocks(mesh: Mesh, fields: Mapping[str, object], edge_fields: Sequence[str]) -> dict:
    """Check that the ranks of 'edge' hold the same host `fields`, then keep
    this rank's block of each of `edge_fields` and the others whole."""
    mesh.check_identical(fields)
    return {k: edge_sharding(mesh, v) if k in edge_fields else replicated(mesh, v) for k, v in fields.items()}
