"""Request/response framing codec (a copy of the JAX package's
``protocol/codec.py``).

Re-implements the behavioral contract of the reference codec
(src/sdk/src/sl_lidarprotocol_codec.cpp):

  * requests: ``A5 | cmd [| size | payload... | xor-checksum]`` — checksum
    covers every preceding byte including sync (codec onEncodeData
    :78-130);
  * responses: ``A5 5A | u32le size(30b)+subtype(2b) | type | payload`` with
    *loop mode*: when subtype bit0 is set the codec keeps re-emitting
    fixed-``size`` payloads without new headers until reset (:205-228).

Unlike the reference's byte-at-a-time switch statement, this decoder works
on whole buffers with ``bytes.find`` / slicing — the Python hot path hands
off entire capsule streams at once, and the per-byte scan-sync hunting lives
in the vectorized unpackers (ops/unpack.py) or the C++ runtime (native/).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    ANS_HEADER_LEN,
    ANS_HEADER_SIZE_MASK,
    ANS_HEADER_SUBTYPE_SHIFT,
    ANS_PKTFLAG_LOOP,
    ANS_SYNC_BYTE1,
    ANS_SYNC_BYTE2,
    CMD_SYNC_BYTE,
    CMDFLAG_HAS_PAYLOAD,
)


def encode_command(cmd: int, payload: bytes = b"") -> bytes:
    """Build a request packet.

    Commands without the HAS_PAYLOAD flag are 2 bytes; with it, the size
    byte and trailing XOR checksum are appended (checksum folds in the sync
    and cmd bytes too, matching RPLidarProtocolCodec::onEncodeData).
    """
    if cmd & CMDFLAG_HAS_PAYLOAD:
        if len(payload) > 0xFF:
            raise ValueError("payload too large for 1-byte size field")
        body = bytes([CMD_SYNC_BYTE, cmd & 0xFF, len(payload)]) + payload
        checksum = 0
        for b in body:
            checksum ^= b
        return body + bytes([checksum])
    if payload:
        raise ValueError(f"cmd {cmd:#x} does not carry a payload")
    return bytes([CMD_SYNC_BYTE, cmd & 0xFF])


@dataclasses.dataclass(frozen=True)
class AnsHeader:
    """Decoded response descriptor."""

    ans_type: int
    payload_len: int
    is_loop: bool

    def encode(self) -> bytes:
        word = (self.payload_len & ANS_HEADER_SIZE_MASK) | (
            (ANS_PKTFLAG_LOOP if self.is_loop else 0) << ANS_HEADER_SUBTYPE_SHIFT
        )
        return bytes([ANS_SYNC_BYTE1, ANS_SYNC_BYTE2]) + word.to_bytes(4, "little") + bytes(
            [self.ans_type & 0xFF]
        )


# message callback: (ans_type, payload bytes, is_loop)
MessageListener = Callable[[int, bytes, bool], None]

# Largest real payload is the HQ capsule (777 bytes); anything near the
# 30-bit field limit is a corrupted header (e.g. wrong-baud noise that
# happened to contain A5 5A) and must trigger a resync instead of
# swallowing the stream into a giant pending payload.  Matches the native
# codec's kMaxSanePayload (native/src/codec.cc).
MAX_SANE_PAYLOAD = 8192


class ResponseDecoder:
    """Streaming response decoder with loop-mode support.

    Feed arbitrary chunks via :meth:`feed`; complete messages are delivered
    to the listener.  In loop mode every subsequent ``payload_len`` bytes is
    one message with the same header until :meth:`exit_loop_mode` (the
    equivalent of the reference's exitLoopMode decode reset).
    """

    def __init__(self, listener: Optional[MessageListener] = None) -> None:
        self._listener = listener
        self._buf = bytearray()
        self._header: Optional[AnsHeader] = None
        self._in_loop = False
        self.messages: list[tuple[int, bytes, bool]] = []  # kept if no listener

    def set_listener(self, listener: MessageListener) -> None:
        self._listener = listener

    def reset(self) -> None:
        self._buf.clear()
        self._header = None
        self._in_loop = False

    # exitLoopMode == decode reset (sl_lidarprotocol_codec.cpp:66-68)
    exit_loop_mode = reset

    def _emit(self, payload: bytes) -> None:
        assert self._header is not None
        msg = (self._header.ans_type, payload, self._header.is_loop)
        if self._listener is not None:
            self._listener(*msg)
        else:
            self.messages.append(msg)

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)
        while True:
            if self._header is None:
                # hunt for the A5 5A sync pair
                idx = self._buf.find(bytes([ANS_SYNC_BYTE1, ANS_SYNC_BYTE2]))
                if idx < 0:
                    # keep a trailing lone A5 in case 5A arrives next chunk
                    if self._buf and self._buf[-1] == ANS_SYNC_BYTE1:
                        del self._buf[:-1]
                    else:
                        self._buf.clear()
                    return
                if len(self._buf) - idx < ANS_HEADER_LEN:
                    del self._buf[:idx]
                    return
                word = int.from_bytes(self._buf[idx + 2 : idx + 6], "little")
                payload_len = word & ANS_HEADER_SIZE_MASK
                if payload_len > MAX_SANE_PAYLOAD:
                    # corrupted header: skip the false sync byte and rescan.
                    # Both codecs REJECT such frames (codec.cc resyncs on
                    # implausible sizes too); recovery differs benignly —
                    # the byte-at-a-time native decoder has already consumed
                    # the 7 header bytes, while this buffered decoder can
                    # rescan from sync+1 and so recovers a real packet that
                    # starts inside the corrupt header.
                    del self._buf[: idx + 1]
                    continue
                self._header = AnsHeader(
                    ans_type=self._buf[idx + 6],
                    payload_len=payload_len,
                    is_loop=bool((word >> ANS_HEADER_SUBTYPE_SHIFT) & ANS_PKTFLAG_LOOP),
                )
                del self._buf[: idx + ANS_HEADER_LEN]
                self._in_loop = self._header.is_loop
                if self._header.payload_len == 0:
                    # zero-payload packet: header-only (codec :196-199)
                    self._emit(b"")
                    self._header = None
                    continue
            # collecting payload(s)
            n = self._header.payload_len
            if len(self._buf) < n:
                return
            payload = bytes(self._buf[:n])
            del self._buf[:n]
            self._emit(payload)
            if not self._in_loop:
                self._header = None

    def drain_loop_payloads(self, data: bytes) -> list[bytes]:
        """Convenience: feed data, return payloads accumulated (no listener)."""
        self.feed(data)
        out = [p for (_, p, _) in self.messages]
        self.messages.clear()
        return out
