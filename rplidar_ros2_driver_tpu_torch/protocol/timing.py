"""Timestamp back-dating — the reference's per-sample delay models (a copy
of the JAX package's ``protocol/timing.py``; numpy only).

The reference stamps every decoded node with ``rx_time − delay(idx)`` where
``delay`` models how long sample ``idx`` of the frame took to reach the
host (handler_normalnode.cpp:51-68, handler_capsules.cpp:55-76, 272-293,
586-607, 796-817, handler_hqnode.cpp:54-73):

    delay(idx) = sample_filter_delay            # 1 sample duration
               + sample_delay                   # dur >> 1 (sample center)
               + transmission_delay             # frame bytes on the UART at
                                                #   the device's NATIVE baud,
                                                #   or a fixed 100 us dummy
                                                #   for ethernet links
               + linkage_delay                  # device-provided; the
                                                #   reference sets 0
                                                #   (_updateTimingDesc,
                                                #   sl_lidar_driver.cpp:1547)
               + grouping_delay(idx)            # (N-1-idx) * dur for the
                                                #   capsule formats; 0 for
                                                #   normal/HQ nodes

All arithmetic is integer microseconds, exactly like the reference's _u64
math (sample_duration is rounded once, ``+ 0.5``, sl_lidar_driver.cpp:1543).
Within one frame the delay is linear in ``idx`` with slope ``-dur``, so a
whole frame's back-dated timestamps are ``first + idx*dur`` — but *across*
frames the anchor is each frame's own arrival time, which is what keeps
node timestamps exact during RPM transients.

The per-mode sample duration arrives via a timing descriptor the driver
pushes into the decoder on scan start (``_updateTimingDesc``,
sl_lidar_driver.cpp:1538-1554).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    ANS_PAYLOAD_BYTES,
    Ans,
)

# Fallback native baud per wire format when the device's native baud is
# unknown — the reference's per-handler "guess channel baudrate" defaults
# (handler_normalnode.cpp:53, handler_capsules.cpp:60,277,592,802).
_FORMAT_DEFAULT_BAUD = {
    Ans.MEASUREMENT: 115200,
    Ans.MEASUREMENT_CAPSULED: 115200,
    Ans.MEASUREMENT_CAPSULED_ULTRA: 256000,
    Ans.MEASUREMENT_DENSE_CAPSULED: 256000,
    Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: 1000000,
    Ans.MEASUREMENT_HQ: 1000000,
}

# Fixed transmission-delay stand-in for non-serial links (the reference's
# "100; //dummy value" ethernet branch in every handler).
ETHERNET_DUMMY_TRANSMISSION_US = 100

# Samples carried per frame of each streaming format (sl_lidar_cmd.h wire
# structs; SURVEY.md §2.2 handler table).
SAMPLES_PER_FRAME = {
    Ans.MEASUREMENT: 1,
    Ans.MEASUREMENT_CAPSULED: 32,
    Ans.MEASUREMENT_CAPSULED_ULTRA: 96,
    Ans.MEASUREMENT_DENSE_CAPSULED: 40,
    Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: 64,
    Ans.MEASUREMENT_HQ: 96,
}

# Formats whose delay model HAS a per-sample grouping term.  Normal nodes
# carry one sample; HQ capsules are pre-formatted device-side and the
# reference applies no grouping delay to them (handler_hqnode.cpp:54-73).
_GROUPED_FORMATS = frozenset(
    {
        Ans.MEASUREMENT_CAPSULED,
        Ans.MEASUREMENT_CAPSULED_ULTRA,
        Ans.MEASUREMENT_DENSE_CAPSULED,
        Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED,
    }
)

LEGACY_SAMPLE_DURATION_US = 476.0  # old A-series (sl_lidar_driver.cpp:1559)


@dataclasses.dataclass(frozen=True)
class TimingDesc:
    """What the driver knows about the active link + scan mode.

    Mirrors the reference's ``SlamtecLidarTimingDesc``: the *native* baud
    of the device model (not necessarily the negotiated link baud) drives
    the transmission-delay estimate, and ``linkage_delay_us`` is a
    device-provided hook the reference currently always sets to 0.
    """

    sample_duration_us: float = LEGACY_SAMPLE_DURATION_US
    native_baudrate: int = 0   # 0: unknown -> per-format default baud
    is_serial: bool = True     # False: ethernet dummy transmission delay
    linkage_delay_us: int = 0  # ref: _timing_desc.linkage_delay_uS = 0

    @property
    def sample_duration_int_us(self) -> int:
        """Rounded integer duration, as the reference stores it
        (``(_u64)(selectedSampleDuration + 0.5f)``, sl_lidar_driver.cpp:1543)."""
        return int(self.sample_duration_us + 0.5)

    def transmission_us(self, ans_type: int) -> int:
        """UART time for one frame of this format: 10 bits/byte (8N1) at
        the device's native baud; fixed dummy for network links."""
        if not self.is_serial:
            return ETHERNET_DUMMY_TRANSMISSION_US
        try:
            at = Ans(ans_type)
        except ValueError:
            return 0
        frame_bytes = ANS_PAYLOAD_BYTES.get(at)
        if frame_bytes is None:
            return 0
        baud = self.native_baudrate or _FORMAT_DEFAULT_BAUD.get(at, 115200)
        return frame_bytes * 10 * 1_000_000 // baud


def sample_delay_us(ans_type: int, timing: TimingDesc, sample_idx: int = 0) -> int:
    """Reference-exact age (integer µs) of sample ``sample_idx`` of a frame
    at the moment the frame is fully received."""
    try:
        at = Ans(ans_type)
    except ValueError:
        return 0
    n = SAMPLES_PER_FRAME.get(at)
    if n is None:
        return 0
    dur = timing.sample_duration_int_us
    grouping = (n - 1 - sample_idx) * dur if at in _GROUPED_FORMATS else 0
    return dur + (dur >> 1) + timing.transmission_us(at) + timing.linkage_delay_us + grouping


def frame_rx_delay_us(ans_type: int, timing: TimingDesc) -> float:
    """Age of the frame's FIRST sample at frame-receive time (the scalar
    per-frame approximation used where per-node stamps are not needed)."""
    return float(sample_delay_us(ans_type, timing, 0))


def frame_sample_times(
    ans_type: int, timing: TimingDesc, rx_ts, n_samples: int | None = None
) -> np.ndarray:
    """Back-dated measurement times (seconds, float64) of every sample of a
    frame received at ``rx_ts``: ``rx_ts − delay(idx)`` for each idx.

    Delay is linear in idx with slope −sample_duration, so this is
    ``(rx_ts − delay(0)) + idx*dur`` — bit-identical to evaluating
    :func:`sample_delay_us` per index (all terms are integer µs).

    ``rx_ts`` may be a scalar (one frame, returns ``(n_samples,)``) or an
    ``(m,)`` array of per-frame anchors (returns ``(m, n_samples)``) — the
    one timestamp formula for both the live decoder and the tests.
    """
    if n_samples is None:
        try:
            n_samples = SAMPLES_PER_FRAME[Ans(ans_type)]
        except (ValueError, KeyError):
            n_samples = 1
    rx = np.asarray(rx_ts, np.float64)
    first = rx - 1e-6 * sample_delay_us(ans_type, timing, 0)
    try:
        grouped = Ans(ans_type) in _GROUPED_FORMATS
    except ValueError:
        grouped = False
    step = 1e-6 * timing.sample_duration_int_us if grouped else 0.0
    return first[..., None] + step * np.arange(n_samples, dtype=np.float64)
