"""Sharded checkpoint/resume with ``torch.distributed.checkpoint``.

The port's counterpart of the JAX package's ``utils/checkpoint_orbax.py``.
The npz checkpointer (utils/checkpoint.py) is the single-stream default:
host snapshot, one atomic file.  At fleet scale the service's state is
sharded over the ``(stream, beam)`` mesh (parallel/sharding.py), and
gathering it to one host buffer defeats the sharding; this backend writes
each process's own block with ``torch.distributed.checkpoint`` (DCP).  In a
mesh that spans processes every block rides a ``DTensor`` over the mesh's
``DeviceMesh``, so DCP writes each block once (replicated blocks
deduplicated) and a restore onto another mesh shape reshards, as long as
the global shapes match.  In one process the state is saved as plain
tensors.

Durability is the npz path's old-or-new contract: the save lands in a
sibling ``.saving`` directory and is rotated in with two renames (previous
→ ``.old``, new → final) by rank 0 only, bracketed by barriers over the
default process group (free when none is initialised).  A crash between
the renames leaves the previous checkpoint at ``.old``, which
:func:`restore_sharded` falls back to.

Geometry safety matches the npz path too: :func:`restore_sharded` reads the
checkpoint's metadata and compares every key's global shape and dtype with
the template *before* any load (DCP would load a float32 tensor into an
int32 target by conversion, and refuses a size mismatch only midway), so a
checkpoint of another window, beam count or grid is rejected with the
caller's state untouched.

A state is a mapping ``name -> tensor`` (or a dataclass of tensors such as
``FilterState`` or ``MapState``; ``None`` fields are skipped).  ``specs``
names each tensor's dimensions along the mesh (``"stream"``, ``"beam"`` or
``None`` per dimension, parallel/sharding.STATE_SPEC); without a mesh that
spans processes it is not needed.

The fused fleet ingest (driver/ingest.FleetFusedIngest.save_sharded) writes
its whole state in its snapshot's global layout, put together from the
engine's stream rows in stream order, so it loads onto an engine over any
mesh shape.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import warnings
from typing import Mapping, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("rplidar_torch.checkpoint")

_SAVING_SUFFIX = ".saving"
_OLD_SUFFIX = ".old"


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _primary() -> bool:
    return not _in_group() or dist.get_rank() == 0


def _dcp_call(fn, *args, **kwargs):
    """A DCP save or load; alone (no process group) it runs with
    ``no_dist`` and without DCP's single-process warning."""
    if _in_group():
        return fn(*args, **kwargs)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        return fn(*args, no_dist=True, **kwargs)


def _barrier() -> None:
    """Cross-process sync point; free when single-process."""
    if _in_group() and dist.get_world_size() > 1:
        dist.barrier()


def as_tensor_dict(state) -> dict[str, torch.Tensor]:
    """A state's tensors by name: a mapping as given, a dataclass by field
    (``None`` fields, such as the derived ``median_sorted``, skipped)."""
    if dataclasses.is_dataclass(state):
        items = ((f.name, getattr(state, f.name)) for f in dataclasses.fields(state))
    else:
        items = state.items()
    return {k: v for k, v in items if v is not None}


def _spans(mesh) -> bool:
    return mesh is not None and getattr(mesh, "device_mesh", None) is not None


def _placements(mesh, spec):
    """DTensor placements of a tensor whose dimensions ``spec`` names,
    one per mesh dimension (stream, beam)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in ("stream", "beam"):
        dims = [d for d, a in enumerate(spec) if a == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _global_shape(mesh, local_shape, spec) -> tuple:
    n = {"stream": mesh.shape["stream"], "beam": mesh.shape["beam"]}
    return tuple(s * n[a] if a in n else s for s, a in zip(local_shape, spec))


def _local_shape(mesh, global_shape, spec) -> tuple:
    n = {"stream": mesh.shape["stream"], "beam": mesh.shape["beam"]}
    return tuple(s // n[a] if a in n else s for s, a in zip(global_shape, spec))


def _dtensor(local: torch.Tensor, mesh, spec, global_shape: tuple):
    """``local`` as this process's block of a DTensor over the mesh."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for s in reversed(global_shape):
        stride.insert(0, acc)
        acc *= s
    return DTensor.from_local(local, mesh.device_mesh, _placements(mesh, spec), run_check=False,
                              shape=torch.Size(global_shape), stride=tuple(stride))


def save_sharded(path: str, state, *, mesh=None, specs: Optional[Mapping] = None) -> None:
    """Write a state (this process's blocks) under ``path``: a
    FilterState, a stream-stacked MapState (mapping/mapper.FleetMapper's
    checkpoint), or any mapping of tensors; the save/rotate machinery is
    schema-agnostic.

    Blocks until the write is finished and rotated in, so on return the
    checkpoint at ``path`` is durable and a reader finds either the
    previous checkpoint or the new one.  In a process group every process
    calls this (DCP's save is collective: each writes its blocks); the
    rotation is performed by rank 0 only, bracketed by barriers.
    """
    path = os.path.abspath(path)
    tmp, old = path + _SAVING_SUFFIX, path + _OLD_SUFFIX
    tensors = as_tensor_dict(state)
    if _spans(mesh):
        tensors = {
            k: _dtensor(v, mesh, specs[k], _global_shape(mesh, v.shape, specs[k]))
            for k, v in tensors.items()
        }
    if _primary():
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    import torch.distributed.checkpoint as dcp

    _dcp_call(dcp.save, tensors, storage_writer=dcp.FileSystemWriter(tmp))
    _barrier()
    if _primary():
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier()


def saved_geometry(path: str) -> dict[str, tuple[tuple, torch.dtype]]:
    """Each saved tensor's global shape and dtype, from the checkpoint's
    metadata alone (nothing is loaded)."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata()
    return {
        k: (tuple(m.size), m.properties.dtype)
        for k, m in meta.state_dict_metadata.items()
        if hasattr(m, "size")
    }


def restore_sharded(path: str, like, *, mesh=None, specs: Optional[Mapping] = None,
                    device=None) -> Optional[dict[str, torch.Tensor]]:
    """Restore the tensors of a state shaped like ``like`` (the same
    schema-agnostic contract as :func:`save_sharded`).

    ``like`` gives each tensor's GLOBAL shape and dtype: pass
    parallel/sharding.abstract_sharded_state (meta tensors, no allocation)
    or a concrete state.  The result holds this process's blocks on
    ``mesh.device`` (or ``device``, default the template's device; a meta
    template needs one).  Returns None when the checkpoint is absent or
    its geometry does not match — the caller keeps its current state.
    When ``path`` is missing but a rotation crash left ``path.old``, that
    previous checkpoint is restored instead.
    """
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        old = path + _OLD_SUFFIX
        if not os.path.isdir(old):
            return None
        log.warning("checkpoint %s missing; recovering previous from %s", path, old)
        path = old
    template = as_tensor_dict(like)
    try:
        if not _metadata_matches(path, template):
            return None
        import torch.distributed.checkpoint as dcp

        if _spans(mesh):
            targets = {
                k: _dtensor(torch.empty(_local_shape(mesh, t.shape, specs[k]), dtype=t.dtype,
                                        device=mesh.device), mesh, specs[k], tuple(t.shape))
                for k, t in template.items()
            }
        else:
            dev = mesh.device if mesh is not None else device
            targets = {
                k: torch.empty(t.shape, dtype=t.dtype,
                               device=dev if dev is not None else t.device)
                for k, t in template.items()
            }
        _dcp_call(dcp.load, targets, storage_reader=dcp.FileSystemReader(path))
    except (ValueError, KeyError, FileNotFoundError) as e:
        log.warning("rejecting sharded checkpoint %s: %s", path, e)
        return None
    return {k: (v.to_local() if hasattr(v, "to_local") else v) for k, v in targets.items()}


def _metadata_matches(path: str, template: dict) -> bool:
    """Saved-against-template geometry, key set included, read from the
    checkpoint's metadata: reject on any drift, keeping the caller's state
    untouched (the npz path's reject-don't-crash contract)."""
    got = saved_geometry(path)
    want = {k: (tuple(t.shape), t.dtype) for k, t in template.items()}
    if set(want) != set(got):
        log.warning(
            "rejecting sharded checkpoint %s: leaf set %s != %s",
            path, sorted(got), sorted(want),
        )
        return False
    for name, (shape, dtype) in want.items():
        s_shape, s_dtype = got[name]
        if shape != s_shape or dtype != s_dtype:
            log.warning(
                "rejecting sharded checkpoint %s: leaf %s saved as %s/%s, "
                "want %s/%s", path, name, s_shape, s_dtype, shape, dtype,
            )
            return False
    return True
