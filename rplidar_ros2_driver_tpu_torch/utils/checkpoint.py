"""Durable checkpoint/resume for the filter-chain state.

The reference is stateless streaming — its only "resume" surface is the
lifecycle state machine (SURVEY.md §5).  In this framework the rolling
scan window and voxel accumulator are real device-resident state, so they
get a real checkpoint format: an atomically-written ``.npz`` of the host
snapshot plus a JSON sidecar fingerprinting the chain geometry
(window/beams/grid), so a restore into a reconfigured chain is detected
and refused instead of crashing the compiled step.

Kept dependency-light (numpy only): the snapshots are a few MB at most,
and a single-file atomic rename is exactly the durability contract needed.
For multi-host meshes, each host saves its addressable shards under its
process index.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import zipfile
import zlib
from typing import Any, Optional

import numpy as np

log = logging.getLogger("rplidar_tpu.checkpoint")

FORMAT_VERSION = 1


def _array_crc(v: np.ndarray) -> int:
    """CRC32 of an array's raw bytes (C-order contiguous view, so the
    checksum is layout-independent of how the caller built it)."""
    return zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF


def _fingerprint(snap: dict[str, np.ndarray]) -> dict[str, Any]:
    return {
        "version": FORMAT_VERSION,
        # shape/dtype pre-validate the restore; crc32 detects torn or
        # bit-flipped payloads that still parse (a truncated zip fails
        # earlier, but a corrupt-but-well-formed npz would otherwise
        # restore silent garbage into a compiled step)
        "arrays": {
            k: {
                "shape": list(v.shape),
                "dtype": str(v.dtype),
                "crc32": _array_crc(np.asarray(v)),
            }
            for k, v in snap.items()
        },
    }


def save_checkpoint(path: str, snap: dict[str, np.ndarray], extra: Optional[dict] = None) -> None:
    """Atomically write ``snap`` to ``path`` (an .npz file).

    Write-to-temp + rename in the destination directory, so a crash
    mid-save never leaves a torn checkpoint, and a concurrent reader sees
    either the old file or the new one.
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    meta = _fingerprint(snap)
    if extra:
        meta["extra"] = extra
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **snap)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename is
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives power loss —
        # best-effort: by now the checkpoint IS at its final path, so a
        # platform that can't fsync a directory must not fail the save
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str) -> Optional[tuple[dict[str, np.ndarray], dict]]:
    """Read a checkpoint; None when absent, unreadable, torn, or failing
    its own CRC manifest — every rejection is a logged clean refusal,
    never a crash or a silent garbage restore."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            raw_meta = z["__meta__"].tobytes()
            meta = json.loads(raw_meta)
            if meta.get("version") != FORMAT_VERSION:
                log.warning(
                    "rejecting checkpoint %s: format version %s (want %d)",
                    path, meta.get("version"), FORMAT_VERSION,
                )
                return None
            snap = {k: z[k] for k in z.files if k != "__meta__"}
    except (OSError, EOFError, ValueError, KeyError, json.JSONDecodeError, zipfile.BadZipFile) as e:
        # EOFError: a zero-length / headerless torn file (np.load raises
        # it before the zip machinery ever sees the bytes)
        log.warning("rejecting unreadable/torn checkpoint %s: %s", path, e)
        return None
    # verify the payload matches its own manifest: shape/dtype (a
    # truncation guard) AND the per-array CRC32 (a corruption guard —
    # a bit-flipped npz can still unzip and parse).  Checkpoints
    # written before the crc32 field simply lack it and skip that leg.
    want = meta.get("arrays", {})
    for k, spec in want.items():
        if k not in snap or list(snap[k].shape) != spec["shape"] or str(snap[k].dtype) != spec["dtype"]:
            log.warning(
                "rejecting checkpoint %s: array %r missing or "
                "shape/dtype drifted from its manifest", path, k,
            )
            return None
        crc = spec.get("crc32")
        if crc is not None and _array_crc(snap[k]) != crc:
            log.warning(
                "rejecting checkpoint %s: array %r failed its CRC32 "
                "(torn or bit-flipped payload)", path, k,
            )
            return None
    return snap, meta
