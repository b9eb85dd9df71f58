"""Multi-process runtime initialization (counterpart of
dynamic_tuning_tpu/parallel/multihost.py; reference
``misc.init_distributed_mode``, misc.py:217-249).

Discover this process's rank and world from the launcher's environment and
start a ``torch.distributed`` process group: one process per card, NCCL on
CUDA, gloo on the CPU.  After it, the loaders shard by
``process_index()``/``process_count()`` (``data/loader.py``), the losses
and BatchNorm reduce over the global batch and the engine all-reduces the
gradients (``parallel/mesh.py``), and evaluations gather on the host.

Discovery order (the launchers the reference supports, misc.py:218-233),
the JAX package's:
  1. explicit:             COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID
  2. torchrun/env://:      MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
  3. OpenMPI:              OMPI_COMM_WORLD_SIZE / _RANK (+ MASTER_ADDR)
  4. SLURM:                SLURM_NTASKS / SLURM_PROCID (+ SLURM_STEP_NODELIST
                           first node or MASTER_ADDR)
and the card: ``LOCAL_RANK`` (torchrun), else OMPI_COMM_WORLD_LOCAL_RANK
or SLURM_LOCALID, else 0.

    torchrun --nproc_per_node=N -m dynamic_tuning_tpu_torch.main_image ...

Every entry point calls ``maybe_initialize_distributed`` first.  Nothing
tells a program of its cluster: the launcher's variables are the only
source, and without them the run is one process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist ('n[1-4],m2' -> 'n1')."""
    head = nodelist.split(",")[0]
    if "[" in head:
        prefix, rng = head.split("[", 1)
        first = rng.rstrip("]").split(",")[0].split("-")[0]
        return prefix + first
    return head


def discover(env: Optional[dict] = None) -> Optional[Tuple[str, int, int]]:
    """-> (coordinator address 'host:port', world size, rank), or None when
    no multi-process launcher environment is present."""
    e = os.environ if env is None else env

    if "COORDINATOR_ADDRESS" in e:
        return (e["COORDINATOR_ADDRESS"], int(e.get("NUM_PROCESSES", 1)),
                int(e.get("PROCESS_ID", 0)))
    if "RANK" in e and "WORLD_SIZE" in e:          # torchrun / env:// style
        addr = e.get("MASTER_ADDR", "127.0.0.1")
        port = e.get("MASTER_PORT", "29500")
        return (f"{addr}:{port}", int(e["WORLD_SIZE"]), int(e["RANK"]))
    if "OMPI_COMM_WORLD_SIZE" in e:                # OpenMPI (misc.py:223-227)
        addr = e.get("MASTER_ADDR", "127.0.0.1")
        port = e.get("MASTER_PORT", "29500")
        return (f"{addr}:{port}", int(e["OMPI_COMM_WORLD_SIZE"]),
                int(e["OMPI_COMM_WORLD_RANK"]))
    if "SLURM_NTASKS" in e and int(e["SLURM_NTASKS"]) > 1:  # misc.py:228-233
        addr = e.get("MASTER_ADDR")
        for var in ("SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST",
                    "SLURM_NODELIST"):
            if addr is None and var in e:
                addr = _first_slurm_node(e[var])
        if addr is None:
            raise RuntimeError(
                "SLURM multi-task job but no coordinator address: set "
                "MASTER_ADDR or run under srun (no SLURM_*_NODELIST found)")
        port = e.get("MASTER_PORT", "29500")
        return (f"{addr}:{port}", int(e["SLURM_NTASKS"]),
                int(e["SLURM_PROCID"]))
    return None


def local_rank(env: Optional[dict] = None) -> int:
    """The card index of this process on its host (0 without a launcher)."""
    e = os.environ if env is None else env
    for var in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID"):
        if var in e:
            return int(e[var])
    return 0


def local_device(name=None) -> torch.device:
    """``name`` (default cuda) as a device; CUDA becomes this process's
    card, ``cuda:LOCAL_RANK`` (raises when that card does not exist)."""
    dev = torch.device(name or "cuda")
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not any(v in os.environ for v in ("LOCAL_RANK",
                                         "OMPI_COMM_WORLD_LOCAL_RANK",
                                         "SLURM_LOCALID")):
        return dev
    i = local_rank()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if i >= n:
        raise RuntimeError(f"LOCAL_RANK {i}: this host has {n} CUDA "
                           "device(s)")
    return torch.device("cuda", i)


def initialize(address: str, world: int, rank: int, *, device=None,
               backend: Optional[str] = None) -> torch.device:
    """Start the process group of ``world`` processes at ``address``
    ('host:port') as ``rank``; returns this process's device.  The backend
    is NCCL on CUDA and gloo on the CPU unless ``backend`` is given (gloo
    on CUDA tensors serves two ranks on one card, which NCCL refuses)."""
    dev = local_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    return dev


def maybe_initialize_distributed(device=None,
                                 backend: Optional[str] = None) -> bool:
    """Start the process group from the launcher's environment; a no-op
    (False) for a plain single-process run.  Idempotent."""
    if dist.is_available() and dist.is_initialized():
        return True
    found = discover()
    if found is None:
        return False
    addr, world, rank = found
    if world <= 1:
        return False
    initialize(addr, world, rank, device=device, backend=backend)
    return True


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def shutdown() -> None:
    """End the process group, if one is running."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
