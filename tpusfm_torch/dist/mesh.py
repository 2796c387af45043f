"""The mesh of ranks and the runtime's bring-up, on ``torch.distributed``.

Counterpart of ``tpusfm/dist/mesh.py``. JAX gives one process a mesh over
all of its devices; here each rank is one process driving one device, so
the mesh is the process group itself: its world size stands where tpusfm
reads ``mesh.devices.size``, and the axis name is kept for
``mesh_from_config``. The backend is NCCL on CUDA devices and gloo on the
CPU unless the caller names one (``initialize_distributed(backend=)``).
``spawn`` starts the processes of one group on this machine the way
``torchrun`` does (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` in their environment; ``spawned_coordinates`` reads them).

gloo takes CUDA tensors for ``all_reduce``, ``broadcast`` and ``barrier``
only; the other collectives of this package (``all_gather``, the ring's
send and receive) go through host tensors when, and only when, the group's
backend is gloo and the tensor lives on a CUDA device. ``Mesh.staged``
counts those collectives by name.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=120)   # every collective of a group fails after it


@dataclasses.dataclass
class Mesh:
    """A 1-D mesh: ``size`` ranks of ``group``, this process being ``rank``,
    computing on ``device``."""

    group: dist.ProcessGroup
    size: int
    rank: int
    axis: str
    device: torch.device
    staged: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    def _on_host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == dist.Backend.GLOO

    def all_gather(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the first axis, in rank order."""
        host = self._on_host(t)
        src = t.cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        if host:
            self.staged[name] += 1
            return torch.cat(parts).to(t.device)
        return torch.cat(parts)

    def shift(self, tensors: list, name: str) -> list:
        """Each rank's ``tensors`` passed to rank + 1 (the ring's ``ppermute``):
        returns what rank - 1 sent. A mesh of one rank keeps its own."""
        if self.size == 1:
            return tensors
        host = any(self._on_host(t) for t in tensors)
        send = [t.cpu() if host else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prev = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        ops = ([dist.P2POp(dist.isend, t, nxt, self.group) for t in send]
               + [dist.P2POp(dist.irecv, t, prev, self.group) for t in recv])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if host:
            self.staged[name] += 1
            return [r.to(t.device) for r, t in zip(recv, tensors)]
        return recv


def _default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: int | None = None, axis: str = "devices", *, device=None) -> Mesh:
    """A 1-D mesh over the ranks of the default process group, computing on
    ``device`` (``cuda:<local rank>`` unless the caller asks for the CPU).

    Outside an initialised process group this first makes a world of one
    (NCCL for a CUDA device, gloo for the CPU, on a free local port), as a
    test or a single-process caller needs. ``n_devices``, where given, must
    be the world size: one rank drives one device."""
    device = torch.device(device if device is not None else "cuda")
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(device),
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0, timeout=TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of {world} ranks: "
                         "each rank drives one device, so the mesh spans the world")
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    return Mesh(group=dist.group.WORLD, size=world, rank=rank, axis=axis, device=device)


def mesh_from_config(config, n_devices: int | None = None, *, device=None) -> Mesh:
    """Mesh named by the config's ``mesh_axis`` knob (SfMConfig.mesh_axis)."""
    return make_mesh(n_devices, axis=config.mesh_axis, device=device)


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, backend: str | None = None,
                           device=None) -> None:
    """Multi-process bring-up: one call per process, before ``make_mesh``.
    No-op when ``coordinator`` ("host:port" of rank 0's store) is None.
    ``backend`` defaults to NCCL for a CUDA ``device`` (the default) and gloo
    for the CPU; every collective times out after ``TIMEOUT``, so a rank that
    fails does not leave the others waiting for ever."""
    if coordinator is None:
        return
    dist.init_process_group(backend or _default_backend(device if device is not None else "cuda"),
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)


def spawned_coordinates():
    """(coordinator "host:port", world size, rank) of a process that ``spawn``
    (or ``torchrun``) started."""
    env = os.environ
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
            int(env["RANK"]))


def spawn(argv: list, world: int, *, timeout: float, cwd=None) -> list:
    """Run ``world`` copies of the command ``argv`` as the ranks of one process
    group on a free local port and return what each printed (stdout and
    stderr). Raises if a rank exits non-zero or the ranks outlast
    ``timeout`` seconds; no rank outlives the call."""
    port = _free_port()
    deadline = time.monotonic() + timeout
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append(tempfile.TemporaryFile(mode="w+"))
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(argv, stdout=logs[-1], stderr=subprocess.STDOUT,
                                          env=env, cwd=cwd, text=True))
        late = None
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                late = p
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late is not None or failed:
        why = f"outlasted {timeout} s" if late is not None else f"rank(s) {failed} failed"
        raise RuntimeError(f"{' '.join(map(str, argv))}: {why}\n"
                           + "\n".join(f"--- rank {r}:\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs
