"""CRC32 for HQ capsules (a copy of the JAX package's ``protocol/crc.py``).

The device uses the standard reflected CRC-32 (poly 0x04C11DB7, init/xorout
0xFFFFFFFF) over the capsule bytes zero-padded to a multiple of 4
(reference behavior: src/sdk/src/sl_crc.cpp:38-101,
handler_hqnode.cpp:124-141).  Host-side numpy: the CRC guards frame
integrity and never runs on the card.
"""

from __future__ import annotations

import numpy as np

_POLY_REFLECTED = 0xEDB88320  # bit-reversed 0x04C11DB7


def _make_table() -> np.ndarray:
    table = np.empty(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY_REFLECTED if (c & 1) else (c >> 1)
        table[i] = c
    return table


_TABLE = _make_table()


def crc32_padded(data: bytes | np.ndarray) -> int:
    """CRC32 with zero padding of ``4 - (len & 3)`` bytes.

    The device convention appends a full 4 zero bytes when the input is
    already 4-aligned (sl_crc.cpp:76 computes ``leftBytes = 4 - (len & 3)``,
    which is never 0), and frames must match it.
    """
    buf = np.frombuffer(bytes(data), np.uint8)
    pad = 4 - (len(buf) & 3)
    buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    crc = np.uint32(0xFFFFFFFF)
    for b in buf:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def frame_crc_ok(payload: bytes) -> bool:
    """Whole-frame HQ-capsule CRC verdict: the trailing little-endian u32
    against :func:`crc32_padded` over everything before it — the one wire
    CRC check of the host decoder and both fused ingest engines."""
    return crc32_padded(payload[:-4]) == int.from_bytes(payload[-4:], "little")
