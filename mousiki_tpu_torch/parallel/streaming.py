"""Batched streaming over several devices: the stream axis split across a
mesh. Port of mousiki_tpu/parallel/streaming.py.

The codec couples no two streams, so the parallelism is pure data
parallelism over streams. The reference shards the stream state and the
frame descriptors on axis 0 of a `jax.sharding.Mesh`, replicates the
constants, and `shard_map` runs the single-chip step on every shard with
S / n streams and no collectives. Here a `StreamMesh` is a list of torch
devices; shard i owns streams [i * S/n, (i + 1) * S/n), keeps their state
on its device, and runs the port's single-device ops on them. The only
traffic between shards is the gather of their PCM onto one device.

A device may appear more than once in a mesh: two shards on one card, or
eight on the CPU in the tests. Each shard still issues its own launches
from the calling thread, so a step of n shards costs about n times the
host time of one shard's step whether the shards share a card or not.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .._device import require_cuda
from ..ops.band_exec import plan_synthesis_step_plc
from ..ops.plc import init_plc_state
from ..ops.synthesis import synthesis_step


def _canonical(device) -> torch.device:
    """torch.device with the index filled in ('cuda' -> 'cuda:N', the
    current device), so that devices compare by where they are."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StreamMesh:
    """The devices the stream axis is split over: the counterpart of
    `jax.sharding.Mesh(devices, ("streams",))`."""

    def __init__(self, devices):
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"StreamMesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None) -> StreamMesh:
    """A mesh of the first `n_devices` CUDA devices (all of them by
    default). Raises without a GPU: a mesh never falls back to the CPU
    (tests build `StreamMesh(["cpu"] * 8)` themselves)."""
    require_cuda()
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f"{n_devices} devices asked, {len(devs)} present")
        devs = devs[:n_devices]
    return StreamMesh(devs)


def shard_bounds(mesh: StreamMesh, n_streams: int) -> list:
    """(lo, hi) of the streams each shard owns, in mesh order."""
    if n_streams % mesh.size:
        raise ValueError("n_streams must divide the mesh size")
    n = n_streams // mesh.size
    return [(i * n, (i + 1) * n) for i in range(mesh.size)]


def output_device(mesh: StreamMesh, device) -> torch.device:
    """`device` as the place the gathered PCM lands: one of the mesh's."""
    dev = _canonical(device)
    if dev not in mesh.devices:
        raise ValueError(f"device {dev} is not in the mesh {mesh}")
    return dev


def shard(mesh: StreamMesh, x) -> list:
    """Split a stream-axis tensor (or a NamedTuple of them, such as a
    StreamState or a FrameDesc) into one part per shard, each on its
    shard's device: the counterpart of `shard_state` / `shard_desc`."""
    if isinstance(x, tuple):
        fields = [shard(mesh, v) for v in x]
        return [type(x)(*parts) for parts in zip(*fields)]
    return [x[lo:hi].to(dev, copy=True) for (lo, hi), dev in
            zip(shard_bounds(mesh, x.shape[0]), mesh.devices)]


def replicate(mesh: StreamMesh, make) -> list:
    """`make(device)` once per distinct device of the mesh; returns one
    entry per shard, shards on one device sharing theirs: the counterpart
    of `replicate` / `replicate_consts`."""
    built = {}
    return [built[d] if d in built else built.setdefault(d, make(d))
            for d in mesh.devices]


def gather(parts: list, device: torch.device) -> torch.Tensor:
    """The per-shard (S / n, ...) results as one (S, ...) tensor on
    `device`: the counterpart of `make_global_sharded`. Parts on another
    device are copied with non_blocking=True, ordered after the work that
    made them by the copy's own stream synchronisation."""
    with record_function("mesh.gather"):
        moved = [p if p.device == device else p.to(device, non_blocking=True)
                 for p in parts]
        return torch.cat(moved)


def sharded_synthesis_step(mesh: StreamMesh, channels: int = 2,
                           frame: int = 960):
    """The non-plan synthesis step on every shard. Returns
    step(consts, states, descs) -> (pcms, states), each a list with one
    entry per shard (consts from `replicate`, states and descs from
    `shard`)."""
    def step(consts, states, descs):
        outs = [synthesis_step(c, s, d, n=frame)
                for c, s, d in zip(consts, states, descs)]
        return [o[0] for o in outs], [o[1] for o in outs]

    return step


def sharded_plan_step_plc(mesh: StreamMesh, channels: int = 2,
                          frame: int = 960, n_streams: int | None = None):
    """The plan step with device concealment on every shard, each on its
    own arena (the arena layout is per shard: S / n streams) and its own
    host flag `any_lost`, read from that shard's lost8 plane on the host.
    Returns step(consts, plc_consts, states, plc_states, backings,
    x_directs, mats, any_lost) -> (pcms, states, plc_states), lists with
    one entry per shard."""
    if n_streams is None:
        raise ValueError("n_streams is required")
    bounds = shard_bounds(mesh, n_streams)
    s_loc = bounds[0][1]

    def step(consts, plc_consts, states, plc_states, backings, x_directs,
             mats, any_lost):
        outs = [plan_synthesis_step_plc(
            *args, any_lost=lost, channels=channels, frame=frame,
            n_streams=s_loc)
            for *args, lost in zip(consts, plc_consts, states, plc_states,
                                   backings, x_directs, mats, any_lost)]
        return tuple(list(o) for o in zip(*outs))

    return step


def sharded_plan_step(mesh: StreamMesh, channels: int = 2, frame: int = 960,
                      n_streams: int | None = None):
    """The plan step without concealment on every shard (the lost8 plane
    is not read). Returns step(consts, states, backings, x_directs, mats)
    -> (pcms, states), lists with one entry per shard."""
    plc_step = sharded_plan_step_plc(mesh, channels, frame, n_streams)
    s_loc = n_streams // mesh.size

    def step(consts, states, backings, x_directs, mats):
        # the concealment state is only threaded through, never read
        plc = replicate(mesh, lambda d: init_plc_state(s_loc, channels, d))
        pcms, states, _ = plc_step(consts, [None] * mesh.size, states, plc,
                                   backings, x_directs, mats,
                                   [False] * mesh.size)
        return pcms, states

    return step
