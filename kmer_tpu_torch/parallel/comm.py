"""Every collective of the mesh, in one place.

Two modes, chosen by the mesh:

- in one process (no process group): a collective is tensor indexing,
  concatenation and .to(device) between the positions' tensors;
- with a process group: each process packs its positions' block and
  calls torch.distributed, NCCL for CUDA tensors and gloo for CPU
  tensors, even at world size 1 (a one-rank NCCL group still runs
  all_to_all_single).  Where gloo lacks what a call needs (CUDA tensors
  in an all-to-all, reduce-scatter), the call runs on CPU copies or as an
  all-reduce and a slice; nothing outside this module knows.

Routed rows travel at their exact sizes: the per-destination row counts
cross first (one small all-to-all), then the payload with those split
sizes.  A destination can take any number of rows, so nothing overflows
and nothing retries (kmer_tpu's static (n_dev, capacity) buffers, their
overflow flag and capacity doubling are XLA static-shape workarounds).
The one host read of the split sizes a step is the step's only
synchronisation.

A process that cannot read its batch must not leave the others waiting
in a collective: it sets mesh.fault and runs the step on an empty batch,
and the size exchange carries the flag, so every process raises there
together, with no collective of its own (check_fault, once a count, for
a dense count, whose steps exchange nothing).  The flag covers batch
reading only: a step that fails in one process alone (a device fault)
still leaves the others waiting until the group's timeout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import stagetime
from .mesh import Mesh


def _dist():
    import torch.distributed as dist
    return dist


def _gloo_cpu(t: torch.Tensor) -> bool:
    """A CUDA tensor in a gloo group: the call runs on a CPU copy."""
    return t.is_cuda and "nccl" not in str(_dist().get_backend())


def _call(fn, out: torch.Tensor, *inputs, **kw) -> None:
    """fn(out, *inputs, **kw) through the group, on CPU copies where
    gloo cannot take the tensors; the result lands in `out`."""
    if not _gloo_cpu(out):
        fn(out, *inputs, **kw)
        return
    host = out.cpu()
    fn(host, *(t.cpu() for t in inputs), **kw)
    out.copy_(host)


def _raise_fault(mesh: Mesh, anywhere: bool) -> None:
    """Raise, on every process, when any flagged a fault: this process's
    own error, or a RuntimeError for another's."""
    if anywhere:
        fault, mesh.fault = mesh.fault, None
        raise fault or RuntimeError("another process failed to read its "
                                    "batch")


def _sizes(mesh: Mesh, sizes: list[torch.Tensor]
           ) -> tuple[np.ndarray, np.ndarray | None]:
    """The (n_local, n_dev) rows each local source sends each position,
    and with a group the (world, n_local, n_local) rows each process's
    sources send this process's positions: one host read.  Each process
    appends its fault flag to what it sends every other; any flag raises
    (_raise_fault)."""
    S = torch.stack([s.to(mesh.devices[0]) for s in sizes])
    if mesh.group is None:
        return S.cpu().numpy(), None
    nl, world = mesh.n_local, mesh.world
    T = S.view(nl, world, nl).permute(1, 0, 2).reshape(world, nl * nl)
    flag = torch.full((world, 1), int(mesh.fault is not None),
                      dtype=torch.int64, device=T.device)
    T = torch.cat([T, flag], 1)
    R = torch.empty_like(T)
    _call(_dist().all_to_all_single, R, T)
    both = torch.cat([S.reshape(-1), R.reshape(-1)]).cpu().numpy()
    R = both[S.numel():].reshape(world, nl * nl + 1)
    _raise_fault(mesh, bool(R[:, -1].any()))
    return (both[:S.numel()].reshape(nl, mesh.n_dev),
            R[:, :-1].reshape(world, nl, nl))


def all_to_all(mesh: Mesh, planes: list[list[torch.Tensor]],
               sizes: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Route rows to their owners.  planes[i]: local position i's C int64
    1-D planes, rows grouped by destination position in order (a dead
    tail after them is not shipped); sizes[i]: (n_dev,) int64, the rows
    for each destination.  Returns, for each local position, the C planes
    of the rows it owns, by source position in mesh order."""
    with stagetime.stage("route_sync"):
        S, R = _sizes(mesh, sizes)
    C = len(planes[0])
    nl = mesh.n_local
    starts = (np.cumsum(S, axis=1) - S).tolist()
    S = S.tolist()
    with stagetime.stage("exchange"):
        if mesh.group is None:
            out = []
            for j, dev in enumerate(mesh.devices):
                cols = []
                for c in range(C):
                    parts = [planes[i][c][starts[i][j]:starts[i][j] + S[i][j]]
                             .to(dev) for i in range(nl)]
                    cols.append(torch.cat(parts))
                out.append(cols)
        else:
            out = _all_to_all_group(mesh, planes, S, R, starts)
    rows = sum(map(sum, S))
    own = sum(S[i][pos] for i, pos in enumerate(mesh.local))
    mesh.stats["exchange_bytes"] += rows * C * 8
    mesh.stats["exchange_cross_bytes"] += (rows - own) * C * 8
    for j, pos in enumerate(mesh.local):
        mesh.stats["owner_rows"][pos] += out[j][0].numel()
    return out


def _all_to_all_group(mesh, planes, S, R, starts):
    """all_to_all through the process group: one (rows, C) int64 block a
    process, rows ordered by (destination, source)."""
    dist = _dist()
    dev, nl, C = mesh.devices[0], mesh.n_local, len(planes[0])
    mats = [torch.stack(p, 1) for p in planes]
    pieces, in_split = [], []
    for q in range(mesh.world):
        n_q = 0
        for j in range(q * nl, (q + 1) * nl):
            for i in range(nl):
                if S[i][j]:
                    pieces.append(mats[i][starts[i][j]:starts[i][j] + S[i][j]])
                    n_q += S[i][j]
        in_split.append(n_q)
    send = (torch.cat(pieces) if pieces
            else torch.empty((0, C), dtype=torch.int64, device=dev))
    out_split = [int(R[p].sum()) for p in range(mesh.world)]
    recv = torch.empty((sum(out_split), C), dtype=torch.int64, device=dev)
    _call(dist.all_to_all_single, recv, send, output_split_sizes=out_split,
          input_split_sizes=in_split)
    per_dst = [[] for _ in range(nl)]
    off = 0
    for p in range(mesh.world):
        for j in range(nl):
            n = int(R[p, :, j].sum())
            per_dst[j].append(recv[off:off + n])
            off += n
    return [[m[:, c].contiguous() for c in range(C)]
            for m in (torch.cat(blocks) for blocks in per_dst)]


def _local_sum(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The sum of this process's positions' tensors, on the first one's
    device."""
    total = tensors[0].clone()
    for t in tensors[1:]:
        total += t.to(total.device)
    return total


def all_reduce(mesh: Mesh, tensors: list[torch.Tensor]) -> torch.Tensor:
    """The sum over every position of its tensor (one a local position),
    on the first local position's device."""
    with stagetime.stage("exchange"):
        total = _local_sum(tensors)
        if mesh.group is not None:
            _call(_dist().all_reduce, total)
    return total


def check_fault(mesh: Mesh) -> None:
    """Raise on every process when any set mesh.fault: one all-reduce,
    for a count whose steps exchange no sizes."""
    if mesh.group is None:
        _raise_fault(mesh, mesh.fault is not None)
        return
    t = torch.tensor([int(mesh.fault is not None)], dtype=torch.int64,
                     device=mesh.devices[0])
    _call(_dist().all_reduce, t, op=_dist().ReduceOp.MAX)
    _raise_fault(mesh, bool(t.item()))


def reduce_scatter(mesh: Mesh, tensors: list[torch.Tensor]
                   ) -> list[torch.Tensor]:
    """The sum over every position, cut in n_dev equal shards: local
    position i (mesh position p) gets shard p, on its device."""
    n = tensors[0].numel()
    if n % mesh.n_dev:
        raise ValueError(f"{n} rows do not cut into {mesh.n_dev} shards")
    shard = n // mesh.n_dev
    with stagetime.stage("exchange"):
        total = _local_sum(tensors)
        if mesh.group is not None:
            dist = _dist()
            if "nccl" in str(dist.get_backend()):
                block = torch.empty(n // mesh.world, dtype=total.dtype,
                                    device=total.device)
                dist.reduce_scatter_tensor(block, total)
                total = block
            else:
                # gloo has no reduce-scatter: all-reduce, keep this block
                _call(dist.all_reduce, total)
                size = shard * mesh.n_local
                total = total[mesh.rank * size:(mesh.rank + 1) * size]
        return [total[i * shard:(i + 1) * shard].to(dev)
                for i, dev in enumerate(mesh.devices)]


def ring_shift(mesh: Mesh, blocks: list[torch.Tensor], hop: int
               ) -> list[torch.Tensor]:
    """For each local position, the block of the position `hop` steps to
    its right along the seq ring of its data row, on its own device.  A
    process holds whole data rows, so the ring never leaves it."""
    out = []
    for i, b in enumerate(blocks):
        d, s = divmod(i, mesh.n_seq)
        src = blocks[d * mesh.n_seq + (s + hop) % mesh.n_seq]
        out.append(src.to(b.device))
    return out


def _host_group(mesh: Mesh):
    """A gloo group over the mesh's processes for host arrays: the mesh's
    own group under gloo, else a side group made on first use (every
    process gathers at the same point, so all make it together)."""
    dist = _dist()
    if "gloo" in str(dist.get_backend(mesh.group)):
        return mesh.group
    if mesh.host_group is None:
        mesh.host_group = dist.new_group(backend="gloo")
    return mesh.host_group


def all_gather_host(mesh: Mesh, arr: np.ndarray) -> list[np.ndarray]:
    """Every process's (m, C) int64 host array, in process order; through
    a gloo group on the host, so no device holds the gathered arrays
    (sizes first, then the arrays padded to the largest)."""
    if mesh.group is None:
        return [arr]
    dist = _dist()
    group = _host_group(mesh)
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    with stagetime.stage("gather"):
        ns = [torch.empty(1, dtype=torch.int64) for _ in range(mesh.world)]
        dist.all_gather(ns, torch.tensor([len(arr)]), group=group)
        sizes = [int(n) for n in ns]
        pad = torch.zeros((max(sizes), arr.shape[1]), dtype=torch.int64)
        pad[:len(arr)] = torch.from_numpy(arr)
        got = [torch.empty_like(pad) for _ in range(mesh.world)]
        dist.all_gather(got, pad, group=group)
    return [g[:n].numpy() for g, n in zip(got, sizes)]
