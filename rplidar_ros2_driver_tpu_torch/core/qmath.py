"""Fixed-point Q-format helpers on int32 tensors.

The Slamtec wire formats speak in Q2/Q3/Q6/Q8/Q14/Q16 fixed point
(e.g. handler_capsules.cpp:206-266).  These helpers centralize the exact
int32 semantics so the tensor paths, the numpy reference implementations
and the C++ arithmetic agree bit for bit: ``<<`` wraps in int32, ``>>`` is
arithmetic, and the division floors (the JAX package's ``//``), which is
C's truncating division on the non-negative angles the handlers feed it.
The float helpers compute in float32: a Python float scalar is rounded to
float32 before it multiplies a float32 tensor, as JAX's weak-typed
constant is.
"""

from __future__ import annotations

import math

import torch

FULL_TURN_Q6 = 360 << 6
FULL_TURN_Q8 = 360 << 8
FULL_TURN_Q16 = 360 << 16


def angle_q6_to_q14(angle_q6: torch.Tensor) -> torch.Tensor:
    """(angle_q6 << 8) / 90 with C integer division semantics (non-negative)."""
    return torch.div(angle_q6 << 8, 90, rounding_mode="floor")


def wrap_angle_q6(angle_q6: torch.Tensor) -> torch.Tensor:
    """Wrap into [0, 360<<6) the way the handlers do (single add/sub)."""
    a = torch.where(angle_q6 < 0, angle_q6 + FULL_TURN_Q6, angle_q6)
    return torch.where(a >= FULL_TURN_Q6, a - FULL_TURN_Q6, a)


def diff_start_angle_q8(prev_q6: torch.Tensor, cur_q6: torch.Tensor) -> torch.Tensor:
    """Angular distance between consecutive capsule start angles in Q8.

    Matches handler_capsules.cpp:210-217: mask the sync bit, promote Q6→Q8,
    and add a full turn when the angle wrapped.
    """
    cur_q8 = (cur_q6 & 0x7FFF) << 2
    prev_q8 = (prev_q6 & 0x7FFF) << 2
    diff = cur_q8 - prev_q8
    return torch.where(prev_q8 > cur_q8, diff + FULL_TURN_Q8, diff)


def angle_q14_to_rad(angle_q14: torch.Tensor) -> torch.Tensor:
    """Q14 z-angle → radians (float32). 16384 == 90 deg."""
    deg = angle_q14.to(torch.float32) * (90.0 / 16384.0)
    return deg * (math.pi / 180.0)


def dist_q2_to_m(dist_q2: torch.Tensor) -> torch.Tensor:
    """Quarter-millimetres → metres (float32)."""
    return dist_q2.to(torch.float32) * (1.0 / 4000.0)
