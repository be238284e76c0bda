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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def gather_row(state, i: int):
    """Stream ``i``'s rows of ``state`` as a dataclass of the same type,
    every tensor a copy on the state's device (None planes stay None)."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = gather_row(v, i)
        else:
            kw[f.name] = None if v is None else v[i].clone()
    return type(state)(**kw)


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
