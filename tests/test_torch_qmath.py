"""core/qmath of the PyTorch package against the JAX package's, exactly.

Seeded int32 inputs made with numpy — the full int32 range (so ``<< 8``
and ``<< 2`` wrap), the handlers' angle ranges, negatives, and the wrap
edges of a full turn in Q6/Q8 — go through both modules; every output
must be byte-equal (the float helpers too: float32 constants, one
multiply each)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core import qmath as jq
from rplidar_ros2_driver_tpu_torch.core import qmath as tq
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_EDGES = np.array(
    [
        0, 1, -1, 2, -2, 89, 90, 91,
        23039, 23040, 23041, -23039, -23040, -23041, 46079, 46080, 46081,
        92160, 92161, 0x7FFF, 0x8000, 0x8001, 0xFFFF, 0x10000,
        (1 << 23) - 1, 1 << 23, (1 << 24) - 1, 1 << 24, -(1 << 24),
        2**31 - 1, -(2**31), -(2**31) + 1, 2**31 - 91,
    ],
    np.int64,
).astype(np.int32)


def _inputs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-(2**31), 2**31, size=2048, dtype=np.int64).astype(np.int32),
        rng.integers(-3 * 23040, 3 * 23040, size=2048).astype(np.int32),
        rng.integers(0, 1 << 16, size=1024).astype(np.int32),
        _EDGES,
    ])


def _jax(fn, *arrays) -> np.ndarray:
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays)))


def _port(fn, *arrays) -> np.ndarray:
    return fn(*(torch.from_numpy(a.copy()) for a in arrays)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 20261018])
@pytest.mark.parametrize(
    "name", ["angle_q6_to_q14", "wrap_angle_q6", "angle_q14_to_rad", "dist_q2_to_m"]
)
def test_unary_helpers_equal_jax(name, seed):
    x = _inputs(seed)
    want = _jax(getattr(jq, name), x)
    got = _port(getattr(tq, name), x)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 20261018])
@pytest.mark.parametrize("shift", [0, 1, 17])
def test_diff_start_angle_equals_jax(seed, shift):
    prev = _inputs(seed)
    cur = np.roll(prev, shift)
    want = _jax(jq.diff_start_angle_q8, prev, cur)
    got = _port(tq.diff_start_angle_q8, prev, cur)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_constants_equal_jax():
    for name in ("FULL_TURN_Q6", "FULL_TURN_Q8", "FULL_TURN_Q16"):
        assert getattr(tq, name) == getattr(jq, name)


def test_wrap_edges_by_hand():
    """The handlers' single add/sub: one turn either side maps into
    [0, 360 << 6); two turns out stays out (the handlers never see it)."""
    x = torch.tensor([-1, 0, 23039, 23040, -23040, 46080], dtype=torch.int32)
    assert tq.wrap_angle_q6(x).tolist() == [23039, 0, 23039, 0, 0, 23040]
    # a sync-bit-masked wrap: prev near the end of the turn, cur past 0
    prev = torch.tensor([23000 | 0x8000], dtype=torch.int32)
    cur = torch.tensor([40], dtype=torch.int32)
    assert tq.diff_start_angle_q8(prev, cur).tolist() == [(40 - 23000) * 4 + (360 << 8)]


def test_module_imports_no_jax():
    """qmath of the port stands alone: importing it in a fresh process
    pulls in neither jax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys; import rplidar_ros2_driver_tpu_torch.core.qmath; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'rplidar_ros2_driver_tpu' or m.startswith('rplidar_ros2_driver_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
