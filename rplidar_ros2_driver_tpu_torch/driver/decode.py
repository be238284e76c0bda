"""Live batched decode: measurement frames -> vectorized unpack kernels.

The PyTorch counterpart of the JAX package's ``driver/decode.py``: the host
ingest path's decode engine and the golden reference the fused device
ingest (ops/ingest.py + driver/ingest.FusedIngest) is held against.  Each
run of frames becomes ONE call of the batch decoders of ops/unpack.py on a
CPU tensor (the JAX class pins its decode to the CPU backend the same
way), so no per-scan transfer ever reaches the card.

Streaming state carried across runs, mirroring the reference handlers:

  * the previous frame of each paired capsule format — prepended so every
    new frame forms a (prev, cur) pair;
  * the dense/ultra-dense sync-edge filter output;
  * the ultra-dense ±2 mm smoothing carry (previous smoothed distance).

Batches are padded to the JAX class's buckets (zero frames, whose
checksums fail and whose pairs are therefore masked), so both packages
decode the same arrays.  Per-node timestamps follow the reference's
per-sample delay model (protocol/timing.py).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.driver.assembly import RawNodeHolder, ScanAssembler
from rplidar_ros2_driver_tpu_torch.protocol import crc as crcmod
from rplidar_ros2_driver_tpu_torch.protocol import timing as timingmod
from rplidar_ros2_driver_tpu_torch.protocol.constants import ANS_PAYLOAD_BYTES, Ans

# Frames (unpaired formats) / pairs (paired formats) per padded batch.
_BUCKETS = (1, 4, 16, 64)

_PAIRED_NODES = {
    Ans.MEASUREMENT_CAPSULED: 32,
    Ans.MEASUREMENT_CAPSULED_ULTRA: 96,
    Ans.MEASUREMENT_DENSE_CAPSULED: 40,
    Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: 64,
}
# formats whose decoders thread the sync-edge / smoothing carries
_CARRY_SYNC = (Ans.MEASUREMENT_DENSE_CAPSULED, Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class BatchScanDecoder:
    """Routes measurement-frame runs to the right batch decoder and pushes
    decoded nodes (with exact per-node timestamps) into the assembler.
    Auto-selects on answer-type change with a full state reset, carries
    decode state across runs, and tees frames to an optional recorder."""

    def __init__(
        self, assembler: ScanAssembler, raw_holder: Optional[RawNodeHolder] = None
    ) -> None:
        self._assembler = assembler
        self._raw_holder = raw_holder
        self._active_ans: Optional[int] = None
        self.timing = timingmod.TimingDesc()
        self.recorder = None
        self._prev: Optional[tuple[bytes, float]] = None
        self._sync_carry = 0
        self._dist_carry = 0
        self.frames_decoded = 0
        self.nodes_decoded = 0
        self.kernel_dispatches = 0

    def reset(self) -> None:
        self._active_ans = None
        self._prev = None
        self._sync_carry = 0
        self._dist_carry = 0

    # -- ingest --------------------------------------------------------------

    def on_measurement(self, ans_type: int, payload: bytes) -> None:
        """Single-frame compatibility shim (tests / non-batching engines)."""
        self.on_measurement_batch(ans_type, [(payload, time.monotonic())])

    def on_measurement_batch(self, ans_type: int, items: list) -> None:
        """Decode a run of ``(payload, rx_monotonic_ts)`` frames of one type."""
        rec = self.recorder
        if rec is not None:
            for data, ts in items:
                rec.write(ans_type, data, ts)
        if ans_type != self._active_ans:
            # answer type changed: new scan mode — reset decode state
            self._active_ans = ans_type
            self._prev = None
            self._sync_carry = 0
            self._dist_carry = 0
            self._assembler.reset()
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        if expect is None:
            return
        items = [it for it in items if len(it[0]) == expect]
        if not items:
            return
        self.frames_decoded += len(items)
        # the carries make slicing exact, so runs of any length decode
        cap = _BUCKETS[-1]
        for i in range(0, len(items), cap):
            chunk = items[i : i + cap]
            if ans_type in _PAIRED_NODES:
                self._decode_paired(ans_type, expect, chunk)
            else:
                self._decode_unpaired(ans_type, expect, chunk)

    def precompile(self, ans_type: int) -> None:
        """Run this format's decoder once per bucket on zero frames with the
        active timing desc, before streaming starts (the driver calls it
        during motor warm-up, where the JAX class warms its jit cache).
        The decoders run eagerly on CPU tensors, so nothing compiles: this
        only takes the first call's allocations off the pump thread.  The
        carries are read, never written."""
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        kern = None if expect is None else self._kernel_for(ans_type)
        if kern is None:
            return
        for b in _BUCKETS:
            rows = b + 1 if ans_type in _PAIRED_NODES else b
            arr = torch.zeros((rows, expect), dtype=torch.uint8)
            if ans_type == Ans.MEASUREMENT_HQ:
                kern(arr, torch.zeros(rows, dtype=torch.bool))
            else:
                kern(arr)

    def _kernel_for(self, ans_type: int):
        """Decoder closure with carries/static args bound to current state."""
        from rplidar_ros2_driver_tpu_torch.ops import unpack

        dur = self.timing.sample_duration_int_us
        if ans_type == Ans.MEASUREMENT:
            return unpack.unpack_normal_nodes
        if ans_type == Ans.MEASUREMENT_HQ:
            return lambda arr, crc_ok=None: unpack.unpack_hq_capsules(arr, crc_ok)
        if ans_type == Ans.MEASUREMENT_CAPSULED:
            return unpack.unpack_capsules
        if ans_type == Ans.MEASUREMENT_CAPSULED_ULTRA:
            return unpack.unpack_ultra_capsules
        if ans_type == Ans.MEASUREMENT_DENSE_CAPSULED:
            return lambda arr: unpack.unpack_dense_capsules(
                arr, self._sync_carry, sample_duration_us=dur
            )
        if ans_type == Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED:
            return lambda arr: unpack.unpack_ultra_dense_capsules(
                arr, self._sync_carry, self._dist_carry, sample_duration_us=dur
            )
        return None

    # -- decode paths --------------------------------------------------------

    def _decode_unpaired(self, ans_type: int, expect: int, items: list) -> None:
        """Normal nodes / HQ capsules: every frame decodes independently."""
        from rplidar_ros2_driver_tpu_torch.ops import unpack

        frames = [d for d, _ in items]
        rx = np.array([t for _, t in items], np.float64)
        m = len(frames)
        mb = _bucket(m)
        arr = np.zeros((mb, expect), np.uint8)
        arr[:m] = np.frombuffer(b"".join(frames), np.uint8).reshape(m, expect)
        self.kernel_dispatches += 1
        if ans_type == Ans.MEASUREMENT_HQ:
            crc_ok = np.zeros(mb, bool)
            crc_ok[:m] = [crcmod.frame_crc_ok(f) for f in frames]
            dec = unpack.unpack_hq_capsules(torch.from_numpy(arr), torch.from_numpy(crc_ok))
        else:
            dec = unpack.unpack_normal_nodes(torch.from_numpy(arr))
        npts = dec.angle_q14.shape[1]
        # no grouping delay for these formats: all samples of a frame share
        # its back-dated stamp
        ts_arr = timingmod.frame_sample_times(ans_type, self.timing, rx, npts)
        self._emit(dec, m, ts_arr)

    def _decode_paired(self, ans_type: int, expect: int, items: list) -> None:
        """Capsule formats: (prev, cur) pairs through the batch decoders,
        carrying the previous frame / sync edge / smoothing state."""
        chain = ([self._prev] if self._prev is not None else []) + items
        self._prev = items[-1]
        if len(chain) < 2:
            return  # first frame of a stream: nothing to pair yet
        frames = [d for d, _ in chain]
        rx = np.array([t for _, t in chain], np.float64)
        n = len(frames)
        npairs = n - 1
        mb = _bucket(npairs) + 1
        arr = np.zeros((mb, expect), np.uint8)
        arr[:n] = np.frombuffer(b"".join(frames), np.uint8).reshape(n, expect)
        self.kernel_dispatches += 1
        dec = self._kernel_for(ans_type)(torch.from_numpy(arr))
        valid = dec.node_valid.numpy()[:npairs]
        if ans_type in _CARRY_SYNC and npairs:
            # the edge filter's output at the stream's last sample position
            self._sync_carry = int(dec.flag[npairs - 1, -1]) & 1
        if ans_type == Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED and npairs:
            # smoothing carry = last non-skipped sample's smoothed distance
            d_flat = dec.dist_q2.numpy()[:npairs].reshape(-1)
            nz = np.flatnonzero(valid.reshape(-1))
            if nz.size:
                self._dist_carry = int(d_flat[nz[-1]])
        # nodes of pair (i, i+1) publish when frame i+1 completes: anchor
        # each pair at the CUR frame's rx time, back-date per sample index
        npts = _PAIRED_NODES[ans_type]
        ts_arr = timingmod.frame_sample_times(ans_type, self.timing, rx[1:], npts)
        self._emit(dec, npairs, ts_arr, valid=valid)

    def _emit(self, dec, rows: int, ts_arr: np.ndarray, valid=None) -> None:
        if rows <= 0:
            return
        if valid is None:
            valid = dec.node_valid.numpy()[:rows]
        v = valid.reshape(-1)
        if not v.any():
            return
        angle, dist, quality, flag = (
            getattr(dec, k).numpy()[:rows].reshape(-1)[v]
            for k in ("angle_q14", "dist_q2", "quality", "flag")
        )
        ts = np.asarray(ts_arr).reshape(-1)[v]
        self.nodes_decoded += int(angle.shape[0])
        self._assembler.push_nodes(angle, dist, quality, flag, ts=ts)
        if self._raw_holder is not None:
            self._raw_holder.push(np.stack([angle, dist, quality, flag], axis=1))
