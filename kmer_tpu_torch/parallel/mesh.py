"""The port's device mesh: an (n_data, n_seq) grid of positions.

Counterpart of kmer_tpu/parallel/mesh.py.  Positions are numbered row
major, as the jax mesh flattens them: position d * n_seq + s is row d of
the data axis (reads) and column s of the seq axis (a read's bases).  A
routed key's owner is a position number (parallel/distributed.route_dest).

Each position has a torch.device.  One process runs the positions of
its own: all of them without a process group (make_mesh(4, 1,
devices=["cuda:0"] * 4) puts four positions on one card; ["cpu"] * 8 is
the counterpart of kmer_tpu's eight virtual devices), or, inside a
torch.distributed group, an equal block of them, process r the positions
[r * n_local, (r + 1) * n_local).  A process holds whole rows of the
data axis, so a seq shard's neighbours are its own, and all its
positions on one device, where the group's collectives take its
tensors.

split_batch cuts a process's batch over its positions: rows over the
data axis, columns over the seq axis (whole packed words, 16 bases
each); it replaces kmer_tpu's batch_sharding and row_sharding.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def _group_active() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_device(device="cuda") -> torch.device:
    """This process's device: "cuda" is cuda:LOCAL_RANK when the launcher
    set it, else cuda:(rank % device count) inside a process group, else
    the current CUDA device; a device with an index, or "cpu", is itself.
    Raises when CUDA is asked for and absent."""
    from ..pipeline.count import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        if local is not None:
            index = int(local)
        elif _group_active():
            import torch.distributed as dist
            index = dist.get_rank() % torch.cuda.device_count()
        else:
            index = torch.cuda.current_device()
        dev = torch.device("cuda", index)
    return dev


class Mesh:
    """An (n_data, n_seq) grid of positions; `devices` are this process's
    positions' devices, in position order.  `stats` gathers what the
    collectives moved (comm): the bytes of routed rows (all, and those
    that changed position), the halo's bytes, and the rows each owner
    received.  `fault` is this process's batch-reading error, which the
    next collective raises on every process (comm)."""

    def __init__(self, n_data: int, n_seq: int, devices, group=None):
        self.n_data, self.n_seq = int(n_data), int(n_seq)
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        if group is not None:
            import torch.distributed as dist
            self.world, self.rank = dist.get_world_size(), dist.get_rank()
        else:
            self.world, self.rank = 1, 0
        if self.n_data < 1 or self.n_seq < 1:
            raise ValueError(f"mesh shape ({n_data}, {n_seq}) needs both "
                             "axes >= 1")
        if len(self.devices) * self.world != self.n_data * self.n_seq:
            raise ValueError(f"{len(self.devices)} positions a process x "
                             f"{self.world} processes != a ({n_data}, "
                             f"{n_seq}) mesh")
        if len(self.devices) % self.n_seq:
            raise ValueError(f"a process holds {len(self.devices)} "
                             "positions: not whole rows of a seq axis of "
                             f"{n_seq}")
        if group is not None:
            if len(set(self.devices)) != 1:
                raise ValueError("inside a process group every position of "
                                 "a process lies on one device, got "
                                 f"{self.devices}")
            import torch.distributed as dist
            if (self.devices[0].type == "cpu"
                    and "gloo" not in str(dist.get_backend())):
                raise ValueError(f"CPU positions need a gloo group, not "
                                 f"{dist.get_backend()}")
        self.fault: BaseException | None = None
        self.host_group = None          # comm's gloo group for host arrays
        self.stats = {"exchange_bytes": 0, "exchange_cross_bytes": 0,
                      "halo_bytes": 0,
                      "owner_rows": np.zeros(self.n_dev, np.int64)}

    @property
    def n_dev(self) -> int:
        return self.n_data * self.n_seq

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """This process's positions."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    @property
    def shape(self) -> dict:
        """{DATA_AXIS: n_data, SEQ_AXIS: n_seq}, as a jax mesh's shape."""
        return {DATA_AXIS: self.n_data, SEQ_AXIS: self.n_seq}

    def __repr__(self) -> str:
        return (f"Mesh({self.n_data}, {self.n_seq}, devices={self.devices}, "
                f"world={self.world}, rank={self.rank})")


def make_mesh(n_data: int | None = None, n_seq: int = 1,
              devices=None) -> Mesh:
    """An (n_data, n_seq) mesh.  devices: this process's positions'
    devices (default: one position on process_device()); n_data defaults
    to every position over n_seq.  Without a process group the first
    n_data * n_seq devices are used, as kmer_tpu's make_mesh does; inside
    one, each process passes its own block and the mesh spans the
    group."""
    devices = [process_device()] if devices is None else list(devices)
    group = None
    world = 1
    if _group_active():
        import torch.distributed as dist
        group, world = dist.group.WORLD, dist.get_world_size()
        # every process must hold as many positions: [n, -n] max-reduced
        # is [max, -min]
        on = (devices[0] if "nccl" in str(dist.get_backend()) else "cpu")
        n = torch.tensor([len(devices), -len(devices)], device=on)
        dist.all_reduce(n, op=dist.ReduceOp.MAX)
        if int(n[0]) != -int(n[1]):
            raise ValueError(f"processes hold {-int(n[1])} to {int(n[0])} "
                             "positions; every process must hold as many")
    if n_data is None:
        n_data = len(devices) * world // n_seq
    if group is None:
        devices = devices[:n_data * n_seq]
    return Mesh(n_data, n_seq, devices, group)


@dataclass
class ShardedBatch:
    """One batch cut over a process's positions: each position's codes
    (its rows, and on a seq mesh its columns), lengths and limits (its
    rows: global read lengths and window-start limits), on its device.
    width: a shard's row width in bases; packed: the codes are 2-bit
    packed int32 words, 16 bases each."""
    codes: list
    lengths: list
    limits: list
    width: int
    packed: bool


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x


def split_batch(mesh: Mesh, codes, lengths, limits,
                packed_width: int = 0) -> ShardedBatch:
    """This process's batch rows (tensors on any device, or numpy) cut
    over its positions: rows over the data axis, columns over the seq
    axis.  codes: (B, L) uint8, or with packed_width = L the (B,
    ceil(L/16)) int32 packed rows.  B must divide over the process's data
    rows, and L over the seq axis in whole words (L % (16 n_seq) == 0)
    or bases (u8 rows)."""
    codes, lengths, limits = _tensor(codes), _tensor(lengths), _tensor(limits)
    B = codes.shape[0]
    L = packed_width or codes.shape[1]
    rows = mesh.n_local // mesh.n_seq
    if B % rows:
        raise ValueError(f"{B} batch rows do not split over {rows} data "
                         "rows of this process")
    unit = 16 if packed_width else 1
    if mesh.n_seq > 1 and L % (unit * mesh.n_seq):
        raise ValueError(f"row width {L} does not split over the seq axis "
                         f"({mesh.n_seq}) in whole "
                         f"{'16-base words' if packed_width else 'bases'}")
    b, cols = B // rows, codes.shape[1] // mesh.n_seq
    out = ShardedBatch([], [], [], L // mesh.n_seq, bool(packed_width))
    for i, dev in enumerate(mesh.devices):
        d, s = divmod(i, mesh.n_seq)
        r = slice(d * b, (d + 1) * b)
        out.codes.append(codes[r, s * cols:(s + 1) * cols].to(dev)
                         .contiguous())
        out.lengths.append(lengths[r].to(dev).contiguous())
        out.limits.append(limits[r].to(dev).contiguous())
    return out


def pad_columns(codes: torch.Tensor, packed_width: int, n_seq: int
                ) -> tuple[torch.Tensor, int]:
    """A batch's rows padded with zero columns to a width that split_batch
    cuts over n_seq: (codes, packed_width).  The padding lies past every
    read's length, so no window reads it, and the batches themselves
    (their rows and widths) stay those of a run with no mesh."""
    unit = 16 if packed_width else 1
    L = packed_width or codes.shape[1]
    pad_to = -(-L // (unit * n_seq)) * unit * n_seq
    if n_seq == 1 or pad_to == L:
        return codes, packed_width
    out = codes.new_zeros((codes.shape[0], pad_to // unit))
    out[:, :codes.shape[1]] = codes
    return out, (pad_to if packed_width else 0)
