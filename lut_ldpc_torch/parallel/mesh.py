"""Data-parallel slots for Monte-Carlo and design sweeps (counterpart of
lut_ldpc_tpu/parallel/mesh.py).

The JAX package shards a batch axis over a ('dp',) device mesh with
shard_map and gathers the counters in the program.  Here a mesh is an
ordered tuple of slots, each one (rank, torch.device):

- within a process the slots run one after another, and a slot list may
  repeat a device (``["cpu"] * 8`` stands in for the JAX tests' eight
  virtual CPU devices, ``["cuda:0"] * 2`` for two chips on one card);
- across processes (``torch.distributed`` initialized) the mesh spans the
  world: rank r owns its local slots, and the slot order is (rank, local
  index).  What the slots computed is gathered with ``dist.all_gather``
  over CPU tensors on a gloo group: the host needs the counters anyway to
  apply the sequential stop rules (7 integers a batch), and NCCL refuses
  two ranks on one card.

Nothing here shrinks a mesh to the devices that exist: asking for more
cards than the host has raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["DPMesh", "Slot", "dp_mesh", "dp_mesh_2d", "make_dp_step",
           "make_dp_step_2d", "multihost_init"]


@dataclass(frozen=True)
class Slot:
    rank: int
    device: torch.device


class DPMesh:
    """An ordered tuple of slots (all ranks'), laid out as `rows` rows of
    len(slots) // rows columns (one row for a 1-D mesh)."""

    def __init__(self, slots, rank: int = 0, group=None, rows: int = 1):
        self.slots = tuple(slots)
        self.rank = int(rank)
        self.group = group
        if rows < 1 or len(self.slots) % rows:
            raise ValueError(f"{len(self.slots)} slots not divisible into {rows} rows")
        self.rows = int(rows)
        self.local = tuple(i for i, s in enumerate(self.slots) if s.rank == self.rank)
        if not self.local:
            raise ValueError(f"rank {self.rank} owns no slot")
        self._counts = [sum(s.rank == r for s in self.slots) for r in range(self.world)]

    def __len__(self) -> int:
        return len(self.slots)

    @property
    def world(self) -> int:
        return max(s.rank for s in self.slots) + 1

    @property
    def shape(self) -> tuple[int, int]:
        return self.rows, len(self.slots) // self.rows

    @property
    def devices(self) -> tuple:
        """This rank's distinct devices, in the order of their first slot."""
        return tuple(dict.fromkeys(self.slots[i].device for i in self.local))

    def gather(self, rows) -> np.ndarray:
        """One equal-shaped array per local slot (in local order) -> one per
        slot of the mesh, stacked in slot order; across processes through
        an all_gather on the gloo group."""
        local = np.stack([np.asarray(r) for r in rows])
        if len(local) != len(self.local):
            raise ValueError(f"{len(local)} rows for {len(self.local)} local slots")
        if self.world == 1:
            return local
        dtype = local.dtype
        if dtype == np.bool_:  # gloo reduces no bool tensors: carry bytes
            local = local.view(np.uint8)
        width = max(self._counts)
        pad = np.zeros((width - len(local), *local.shape[1:]), local.dtype)
        mine = torch.from_numpy(np.ascontiguousarray(np.concatenate([local, pad])))
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine, group=self.group)
        out = np.concatenate([p.numpy()[:c] for p, c in zip(parts, self._counts)])
        return out.view(dtype) if dtype == np.bool_ else out


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices(n, device, devices, world, rank):
    if devices is not None:
        if n is not None:
            raise ValueError("give the slot count or the slot list, not both")
        local = [resolve_device(d) for d in devices]
        if not local:
            raise ValueError("an empty slot list")
        return local
    if n is None or int(n) < 1:
        raise ValueError(f"a mesh needs at least one slot, not {n}")
    n = int(n)
    if n % world:
        raise ValueError(f"{n} slots do not divide over {world} processes")
    k = n // world
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * k
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r}")
    if dev.index is not None:
        raise ValueError("dp_mesh(n, 'cuda') takes cards from 0; name others with devices=")
    resolve_device("cuda")  # raises where there is no CUDA at all
    first = int(os.environ.get("LOCAL_RANK", rank)) * k
    have = torch.cuda.device_count()
    if first + k > have:
        raise RuntimeError(f"{k} slots from cuda:{first} need {first + k} cards; "
                           f"this host has {have}")
    return [torch.device("cuda", first + j) for j in range(k)]


def dp_mesh(n: int | None = None, device="cuda", *, devices=None,
            rows: int = 1) -> DPMesh:
    """A mesh of n slots, or of the slots `devices` names.

    n: slots in all (across processes, n / world per rank): n CPU slots for
    "cpu", cards cuda:0 .. cuda:n-1 for "cuda" (rank r of a world on one
    host takes the k = n / world cards from LOCAL_RANK * k); raises where
    fewer cards exist.  devices: this process's slots, explicitly (may
    repeat a device); the mesh then spans every rank's list.  Every rank
    of an initialized process group must call this (it gathers the slot
    lists and makes the gloo group)."""
    rank, world = _world()
    local = _local_devices(n, device, devices, world, rank)
    if world == 1:
        return DPMesh([Slot(0, d) for d in local], rows=rows)
    group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    lists = [None] * world
    dist.all_gather_object(lists, [str(d) for d in local], group=group)
    slots = [Slot(r, torch.device(d)) for r, names in enumerate(lists) for d in names]
    return DPMesh(slots, rank=rank, group=group, rows=rows)


def dp_mesh_2d(n_snr: int, n: int | None = None, device="cuda", *,
               devices=None) -> DPMesh:
    """A 2-D (snr x dp) mesh: SNR points on its rows, batches data-parallel
    along its columns (the slots in row-major order)."""
    return dp_mesh(n, device, devices=devices, rows=n_snr)


def _run_slots(mesh: DPMesh, step_fn, jobs) -> dict:
    """Run step_fn(device, *jobs[i]) for every local slot i, read the
    counters once all have been launched, and gather them: a dict of
    (len(mesh),) int64 arrays in slot order."""
    outs = [step_fn(mesh.slots[i].device, *jobs[i]) for i in mesh.local]
    names = list(outs[0])
    rows = []
    for c in outs:
        vals = [c[k] for k in names]
        on_dev = [v for v in vals if isinstance(v, torch.Tensor)]
        read = iter(torch.stack([v.reshape(()).to(torch.int64) for v in on_dev]).tolist()
                    if on_dev else [])
        rows.append(np.array([next(read) if isinstance(v, torch.Tensor) else int(v)
                              for v in vals], np.int64))
    allc = mesh.gather(rows)
    return {k: allc[:, j] for j, k in enumerate(names)}


def make_dp_step(step_fn, mesh: DPMesh):
    """Data-parallel wrapper of a per-batch Monte-Carlo step, keyed by the
    GLOBAL batch index.

    step_fn(device, seed, ss, gb, sigma) -> dict of scalar counters (ints
    or 0-d tensors on `device`).  The wrapped function has signature
    (seed, ss, sigma, gb0): slot i runs global batch gb0 + i with the
    generator that batch has in a single-device run (the simulator's
    batch_seed(seed, ss, gb)), so counters do not depend on the mesh size.
    Counters come back UN-reduced, as (len(mesh),) vectors in global-batch
    order: the host applies the sequential stop rules exactly as a
    single-device run would."""
    if mesh.rows != 1:
        raise ValueError("make_dp_step takes a 1-D mesh; use make_dp_step_2d")

    def wrapped(seed, ss, sigma, gb0):
        jobs = [(seed, ss, int(gb0) + i, sigma) for i in range(len(mesh))]
        return _run_slots(mesh, step_fn, jobs)

    wrapped.n_devices = len(mesh)
    return wrapped


def make_dp_step_2d(step_fn, mesh: DPMesh):
    """Monte-Carlo step over a 2-D (snr, dp) mesh.

    step_fn as for make_dp_step.  The wrapped function has signature
    (seed, sigmas, gb0): row r takes SNR index r (as BERSim.run numbers
    its points) and sigmas[r], and column j of a row runs global batch
    gb0 + j with the single-device generator.  Counters are summed over
    the dp axis only: shape (n_snr,) per counter."""
    n_snr, cols = mesh.shape

    def wrapped(seed, sigmas, gb0):
        sigmas = [float(s) for s in np.asarray(sigmas, np.float64).reshape(-1)]
        if len(sigmas) != n_snr:
            raise ValueError(f"{len(sigmas)} sigmas for {n_snr} mesh rows")
        jobs = [(seed, r, int(gb0) + j, sigmas[r]) for r in range(n_snr) for j in range(cols)]
        out = _run_slots(mesh, step_fn, jobs)
        return {k: v.reshape(n_snr, cols).sum(axis=1) for k, v in out.items()}

    return wrapped


def multihost_init() -> bool:
    """Initialize torch.distributed (gloo) under a launcher that sets
    RANK, WORLD_SIZE and MASTER_ADDR (torchrun); no-op returning False in
    a single-process run."""
    if dist.is_initialized():
        return True
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group("gloo")
        return True
    return False
