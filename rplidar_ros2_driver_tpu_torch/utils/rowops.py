"""One stream's rows of a stream-batched state: gather and scatter.

The per-stream checkpoint surfaces (FleetFusedIngest's ``snapshot_stream``
/ ``restore_stream`` and the carried map's ``map_*_stream``, the health
supervisor's quarantine transport) move one stream's rows of a state whose
every tensor has a leading stream axis: a dataclass of tensors, nested
dataclasses (the ingest state's FilterState) and None planes (options that
are off).  The JAX package compiles a dynamic-index gather/scatter pair for
this (its ``utils/rowops.make_row_ops``); here the state lives in place on
its device, so a gather is plain indexing and a scatter is ``copy_`` into
the row: row-sized traffic, every other stream untouched.

On a mesh of several stream rows the fused fleet engine keeps one such
state a row (parallel/sharding.place_fleet_ingest_state): :func:`lane_of`
resolves global stream ``i`` to its row and its lane in that row's state,
and :func:`map_state` / :func:`zip_states` split a global state into rows
and put the rows back together.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def lane_of(rows, i: int) -> tuple:
    """``(row index, lane)`` of global stream ``i`` among ``rows`` (each
    with a ``lanes`` slice of the global streams, in stream order)."""
    for r, row in enumerate(rows):
        if row.lanes.start <= i < row.lanes.stop:
            return r, i - row.lanes.start
    raise IndexError(f"stream {i} is in no row")


def map_state(state, fn):
    """``state`` with ``fn`` applied to every tensor (nested dataclasses
    included, None planes kept)."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        kw[f.name] = (map_state(v, fn) if dataclasses.is_dataclass(v)
                      else None if v is None else fn(v))
    return type(state)(**kw)


def zip_states(states: list, fn):
    """One state of the type of ``states[0]`` whose every tensor is ``fn``
    of the list of the matching tensors of ``states`` (None planes kept)."""
    kw = {}
    for f in dataclasses.fields(states[0]):
        vs = [getattr(st, f.name) for st in states]
        kw[f.name] = (zip_states(vs, fn) if dataclasses.is_dataclass(vs[0])
                      else None if vs[0] is None else fn(vs))
    return type(states[0])(**kw)


def gather_row(state, i: int):
    """Stream ``i``'s rows of ``state`` as a dataclass of the same type,
    every tensor a copy on the state's device (None planes stay None)."""
    return map_state(state, lambda v: v[i].clone())


def row_to_numpy(row) -> dict:
    """A gathered row's tensors on the host, keyed by field name (nested
    dataclasses as nested dicts, None planes left out)."""
    out = {}
    for f in dataclasses.fields(row):
        v = getattr(row, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = row_to_numpy(v)
        elif v is not None:
            out[f.name] = v.cpu().numpy()
    return out


def scatter_row(state, rows: dict, i: int) -> None:
    """Write ``rows`` (field name -> array of one stream's row shape, numpy
    or tensor) into stream ``i`` of ``state``'s tensors, in place.  Fields
    not named keep their values; the caller has checked the shapes."""
    for name, r in rows.items():
        dst = getattr(state, name)[i]
        # np.array copies: a snapshot's arrays may be read-only views
        src = r if isinstance(r, torch.Tensor) else torch.from_numpy(np.array(r))
        dst.copy_(src.reshape(dst.shape))
