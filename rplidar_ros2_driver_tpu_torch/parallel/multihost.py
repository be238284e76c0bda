"""Multi-process bring-up for the sharded service.

The PyTorch counterpart of the JAX package's ``parallel/multihost.py``:
N processes, one device each, joined into one ``torch.distributed``
process group, over which :func:`make_global_mesh` lays the ``(stream,
beam)`` mesh (parallel/sharding.py).

Usage (one call per process, before building a mesh):

    from rplidar_ros2_driver_tpu_torch.parallel import multihost
    multihost.initialize()            # no-op when single-process
    mesh = multihost.make_global_mesh(stream=...)

The topology comes from the same three variables the JAX package reads
(``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
so one launch script configures either package, or from explicit
arguments.  The group joins with ``init_process_group(init_method=
"tcp://<address>")``; its backend is ``nccl`` when the process sees a card
and ``gloo`` otherwise, or the one the caller names (two processes that
share one card need ``gloo``: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from rplidar_ros2_driver_tpu_torch.parallel.sharding import Mesh, make_mesh

log = logging.getLogger("rplidar_tpu.multihost")

_COORD_ENV = "JAX_COORDINATOR_ADDRESS"
_NPROC_ENV = "JAX_NUM_PROCESSES"
_PID_ENV = "JAX_PROCESS_ID"


def is_configured() -> bool:
    """True when the environment declares a multi-process topology."""
    return bool(os.environ.get(_COORD_ENV))


def _env_int(name: str) -> int:
    env = os.environ.get(name)
    if env is None:
        # a coordinator with no topology is a misconfiguration, not a
        # 1-process job: defaulting would make every host coordinator of
        # its own disjoint group with no error pointing at the cause
        raise ValueError(
            f"{_COORD_ENV} is set but {name} is not; "
            "a multi-process topology needs all three variables"
        )
    return int(env)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group when a topology is configured.

    Returns True when the group was initialized (or already was), False
    for the single-process case.  Idempotent; safe to call from every
    entry point."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(_COORD_ENV)
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = _env_int(_NPROC_ENV)
    if process_id is None:
        process_id = _env_int(_PID_ENV)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    log.info(
        "joined process group: %d/%d via %s (%s)",
        process_id, num_processes, coordinator_address, backend,
    )
    return True


def make_global_mesh(stream: Optional[int] = None, device=None) -> Mesh:
    """The ``(stream, beam)`` mesh over every process of the job (one
    device each; ``device`` defaults to this process's card).

    Single-process: ``make_mesh()``.  Keep the stream axis aligned with
    process boundaries when each host owns its lidars (the stream-major
    layout :meth:`ShardedFilterService.submit_local` needs)."""
    return make_mesh(stream=stream, device=device)


def local_stream_slice(streams: int) -> slice:
    """Which of the service's ``streams`` this process should feed.

    With S streams spread over P processes (stream-major, matching the
    mesh's stream axis when built by :func:`make_global_mesh` with a beam
    extent of 1), process p owns the contiguous block [p*S/P, (p+1)*S/P).
    Single-process: the full range."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return slice(0, streams)
    p, n = dist.get_rank(), dist.get_world_size()
    if streams % n:
        raise ValueError(f"{streams} streams do not divide over {n} processes")
    per = streams // n
    return slice(p * per, (p + 1) * per)
