"""The temporal-median kernels' plain versions against the JAX package.

B1 (temporal_median_kernel), B2 (sorted_replace_kernel) and B3
(sliding_median_kernel) launch CUDA kernels for CUDA tensors; for CPU
tensors their wrappers run the plain PyTorch versions, which are what
these tests hold to the JAX package's Pallas kernels (interpret mode on
the CPU, as tests/test_pallas_median.py runs them) and jnp formulations —
bit-exact.  The CUDA kernels themselves
are held to the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops.filters import median_from_sorted, sorted_replace, temporal_median
from rplidar_ros2_driver_tpu.ops.pallas_kernels import (
    sliding_median_pallas,
    sorted_replace_pallas,
    temporal_median_pallas,
)
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.utils import cuda_build
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def rand_window(rng, w, b, inf_frac=0.3):
    win = rng.uniform(0.1, 40.0, (w, b)).astype(np.float32)
    win[rng.uniform(size=(w, b)) < inf_frac] = np.inf
    return win


FIXTURES = ["random_inf", "ties_1mm", "heavy_ties", "all_finite"]


def fixture(rng, w, b, kind):
    if kind == "all_finite":
        return rand_window(rng, w, b, inf_frac=0.0)
    win = rand_window(rng, w, b)
    win[:, 0] = np.inf  # an all-missing beam stays +inf
    if kind == "ties_1mm":
        win = (np.round(win * 1000.0) / 1000.0).astype(np.float32)
    elif kind == "heavy_ties":
        win = np.round(win, 0).astype(np.float32)
    return win


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize(
    "w,b", [(1, 5), (2, 128), (4, 16), (7, 100), (16, 640), (64, 2048), (33, 257)]
)
def test_b1_plain_matches_pallas_and_jnp(w, b, kind):
    rng = np.random.default_rng(w * 1000 + b)
    win = fixture(rng, w, b, kind)
    got = mk.temporal_median_kernel(torch.from_numpy(win)).numpy()
    np.testing.assert_array_equal(got, np.asarray(temporal_median(jnp.asarray(win))))
    np.testing.assert_array_equal(got, np.asarray(temporal_median_pallas(jnp.asarray(win))))


def test_b1_all_finite_is_exact_lower_median():
    rng = np.random.default_rng(7)
    win = rand_window(rng, 8, 64, inf_frac=0.0)
    got = mk.temporal_median_kernel(torch.from_numpy(win)).numpy()
    np.testing.assert_array_equal(got, np.sort(win, axis=0)[(8 - 1) // 2])


@pytest.mark.parametrize(
    "w,b",
    [(4, 16), (8, 64), (16, 640), (7, 100), (33, 257), (64, 130),
     (1, 5), (31, 40), (32, 33), (96, 20)],
)
def test_b2_plain_matches_pallas_and_jnp_over_ring_steps(w, b):
    """Successive ring steps (unfilled window, then wraparound) with +inf
    and ties, odd W and a ragged beam count; W around the CUDA kernel's
    32-row ballots (1, 31, 32, 33, 96)."""
    rng = np.random.default_rng(w * 77 + b)
    ring = np.full((w, b), np.inf, np.float32)
    sor = ring.copy()
    cursor = 0
    for step in range(2 * w + 5):
        new = rng.uniform(0.1, 40.0, b).astype(np.float32)
        new[rng.random(b) < 0.3] = np.inf
        if step % 5 == 0:
            new[:] = new[0]
        if step % 3 == 0:
            new = np.round(new, 0).astype(np.float32)
        old = ring[cursor].copy()
        got, got_med = mk.sorted_replace_kernel(
            torch.from_numpy(sor), torch.from_numpy(old), torch.from_numpy(new)
        )
        ref = np.array(sorted_replace(jnp.asarray(sor), jnp.asarray(old), jnp.asarray(new)))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got_med.numpy(), np.asarray(median_from_sorted(jnp.asarray(ref))))
        if step % 4 == 0:  # the interpret-mode kernel is slow: every 4th step
            p_out, p_med = sorted_replace_pallas(jnp.asarray(sor), jnp.asarray(old), jnp.asarray(new))
            np.testing.assert_array_equal(got.numpy(), np.asarray(p_out))
            np.testing.assert_array_equal(got_med.numpy(), np.asarray(p_med))
        sor = ref
        ring[cursor] = new
        cursor = (cursor + 1) % w
    np.testing.assert_array_equal(sor, np.sort(ring, axis=0))


def b2_edge_fixtures(rng, w, b):
    """B2's one-step edge cases (chip_smoke.py holds the CUDA kernel to the
    plain version on the same kinds): name -> (ascending (W, B) window,
    old (B,), new (B,))."""
    base = np.sort(fixture(rng, w, b, "random_inf"), axis=0)
    old = base[rng.integers(0, w, b), np.arange(b)]
    new = rand_window(rng, 1, b)[0]
    inf = np.full(b, np.inf, np.float32)
    all_inf = np.full((w, b), np.inf, np.float32)
    equal = np.full((w, b), 7.25, np.float32)
    between = np.asarray([7.0, 7.25, 7.5], np.float32)[np.arange(b) % 3]
    finite = np.sort(rand_window(rng, w, b, inf_frac=0.0), axis=0)
    return {
        "random": (base, old, new),
        "old_inf": (base, inf, new),
        "new_inf": (base, old, inf),
        "all_inf": (all_inf, inf, new),
        "all_inf_new_inf": (all_inf, inf, inf),
        "all_equal": (equal, equal[0].copy(), between),
        "old_absent": (base, np.full(b, -1.0, np.float32), new),
        "old_absent_above": (finite, np.full(b, 50.0, np.float32), new),
    }


B2_EDGE_KINDS = ["random", "old_inf", "new_inf", "all_inf", "all_inf_new_inf", "all_equal",
                 "old_absent", "old_absent_above"]


@pytest.mark.parametrize("kind", B2_EDGE_KINDS)
@pytest.mark.parametrize("w,b", [(1, 20), (31, 40), (32, 33), (33, 17), (64, 130), (96, 20),
                                 (1533, 3), (1536, 3), (1537, 3)])
def test_b2_plain_matches_pallas_and_jnp_on_edge_fixtures(w, b, kind):
    """One step on B2's edge fixtures: the plain version equals JAX's
    sorted_replace + median_from_sorted on every column (old absent too:
    d = 0, as argmax gives), and sorted_replace_pallas in interpret mode on
    the columns that hold ``old`` (the contract the Pallas kernel keeps;
    off it, its delete slot points past the rows)."""
    sor, old, new = b2_edge_fixtures(np.random.default_rng(w * 31 + b), w, b)[kind]
    got, got_med = mk.sorted_replace_kernel(*map(torch.from_numpy, (sor, old, new)))
    ref = np.asarray(sorted_replace(jnp.asarray(sor), jnp.asarray(old), jnp.asarray(new)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got_med.numpy(), np.asarray(median_from_sorted(jnp.asarray(ref))))
    held = (sor == old[None, :]).any(axis=0)
    if kind.startswith("old_absent"):
        assert not held.any()
    p_out, p_med = sorted_replace_pallas(jnp.asarray(sor), jnp.asarray(old), jnp.asarray(new))
    np.testing.assert_array_equal(got.numpy()[:, held], np.asarray(p_out)[:, held])
    np.testing.assert_array_equal(got_med.numpy()[held], np.asarray(p_med)[held])


def test_plain_versions_are_the_filter_functions():
    rng = np.random.default_rng(3)
    win = torch.from_numpy(rand_window(rng, 9, 33))
    assert torch.equal(mk.temporal_median_plain(win), mk.temporal_median_kernel(win))
    s = torch.sort(win, dim=0).values
    out, med = mk.sorted_replace_plain(s, win[2].clone(), win[4].clone())
    out2, med2 = mk.sorted_replace_kernel(s, win[2].clone(), win[4].clone())
    assert torch.equal(out, out2) and torch.equal(med, med2)


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        mk.temporal_median_kernel(x.double())
    with pytest.raises(ValueError):
        mk.temporal_median_kernel(torch.zeros(8))
    with pytest.raises(ValueError):
        mk.temporal_median_kernel(torch.zeros(0, 8))
    with pytest.raises(ValueError):
        mk.temporal_median_kernel(torch.zeros(8, 4).T)  # not contiguous
    with pytest.raises(ValueError):
        mk.sorted_replace_kernel(x, torch.zeros(7), torch.zeros(8))
    with pytest.raises(TypeError):
        mk.sorted_replace_kernel(x, torch.zeros(8, dtype=torch.int32), torch.zeros(8))
    with pytest.raises(ValueError):
        mk.sorted_replace_kernel(x, torch.zeros(8).expand(2, 8)[0], torch.zeros(16)[::2])


def test_wrappers_raise_on_a_device_without_a_kernel():
    """Only a CPU tensor takes the plain version: any other device launches
    the kernel or raises, never falls back."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(RuntimeError):
        mk.temporal_median_kernel(x)
    with pytest.raises(RuntimeError):
        mk.sorted_replace_kernel(x, torch.zeros(8, device="meta"), torch.zeros(8, device="meta"))


def test_cpu_tensors_count_no_launch():
    mk.reset_launch_counts()
    win = torch.full((4, 8), 1.0)
    mk.temporal_median_kernel(win)
    mk.sorted_replace_kernel(win, win[0].clone(), win[1].clone())
    mk.sliding_median_kernel(torch.full((6, 8), 1.0), 4)
    assert mk.launch_counts == {"temporal_median": 0, "sorted_replace": 0, "sliding_median": 0}


def test_build_is_keyed_on_the_source_and_needs_nvcc(monkeypatch, tmp_path):
    path = cuda_build.library_path("median")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libmedian_")
    assert cuda_build.library_path("median") == path  # stable for the same source
    assert (cuda_build.CSRC_DIR / cuda_build.SOURCES["median"]).exists()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_cuda_source_exports_both_kernels():
    src = (cuda_build.CSRC_DIR / "median.cu").read_text()
    assert 'extern "C" int temporal_median_f32(' in src
    assert 'extern "C" int sorted_replace_f32(' in src
    assert "cudaGetLastError()" in src
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# B3: the sliding median of the fused K-scan path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize(
    "w,k,b", [(4, 8, 64), (6, 8, 100), (7, 16, 257), (8, 3, 128), (16, 24, 640), (1, 8, 32)]
)
def test_b3_plain_matches_pallas_and_successive_windows(w, k, b, kind):
    """The grid of tests/test_pallas_median.py: non-power-of-two W, K not
    a multiple of 8, W=1, a ragged beam count."""
    rng = np.random.default_rng(w * 100 + k * 10 + b)
    ext = fixture(rng, w + k, b, kind)
    got = mk.sliding_median_kernel(torch.from_numpy(ext), w).numpy()
    assert got.shape == (k, b) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(sliding_median_pallas(jnp.asarray(ext), w)))
    want = np.stack([np.asarray(temporal_median(jnp.asarray(ext[i + 1 : i + 1 + w])))
                     for i in range(k)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mk.sliding_median_plain(torch.from_numpy(ext), w).numpy(), got)


def test_b3_rows_are_b1_on_the_advancing_window():
    rng = np.random.default_rng(12)
    ext = torch.from_numpy(fixture(rng, 9 + 11, 70, "heavy_ties"))
    got = mk.sliding_median_kernel(ext, 9)
    for i in range(11):
        assert torch.equal(got[i], mk.temporal_median_kernel(ext[i + 1 : i + 10].contiguous()))


def test_b3_no_steps_gives_an_empty_result():
    ext = torch.full((5, 16), 2.0)
    out = mk.sliding_median_kernel(ext, 5)
    assert out.shape == (0, 16)


def test_b3_wrapper_checks_its_inputs():
    ext = torch.zeros(10, 8)
    with pytest.raises(TypeError):
        mk.sliding_median_kernel(ext.double(), 4)
    with pytest.raises(ValueError):
        mk.sliding_median_kernel(torch.zeros(10), 4)  # not 2-D
    with pytest.raises(ValueError):
        mk.sliding_median_kernel(ext, 11)  # window taller than the stripe
    with pytest.raises(ValueError):
        mk.sliding_median_kernel(ext, 0)
    with pytest.raises(ValueError):
        mk.sliding_median_kernel(ext, 2.5)
    with pytest.raises(ValueError):
        mk.sliding_median_kernel(torch.zeros(8, 10).T, 4)  # not contiguous
    with pytest.raises(RuntimeError):
        mk.sliding_median_kernel(torch.zeros(10, 8, device="meta"), 4)


def test_cuda_source_exports_the_sliding_median_kernel():
    assert cuda_build.SOURCES["sliding_median"] == "sliding_median.cu"
    src = (cuda_build.CSRC_DIR / "sliding_median.cu").read_text()
    assert 'extern "C" int sliding_median_f32(' in src
    assert "cudaGetLastError()" in src
    assert "sliding_median_pallas" in src  # the note names the TPU kernel it replaces
    path = cuda_build.library_path("sliding_median")
    assert path.name.startswith("libsliding_median_") and path != cuda_build.library_path("median")


# ---------------------------------------------------------------------------
# B3's redesign: edge shapes, the launch plan, the selection rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", FIXTURES)
@pytest.mark.parametrize("w,k,b", [(9, 1, 40), (5, 1, 7), (20, 3, 33), (40, 5, 17), (64, 1, 130)])
def test_b3_plain_matches_pallas_with_one_step_and_windows_taller_than_k(w, k, b, kind):
    """K = 1 and W > K: the windows start in the previous ring."""
    rng = np.random.default_rng(w * 1000 + k * 10 + b)
    ext = fixture(rng, w + k, b, kind)
    got = mk.sliding_median_kernel(torch.from_numpy(ext), w).numpy()
    np.testing.assert_array_equal(got, np.asarray(sliding_median_pallas(jnp.asarray(ext), w)))
    want = np.stack([np.asarray(temporal_median(jnp.asarray(ext[i + 1 : i + 1 + w])))
                     for i in range(k)])
    np.testing.assert_array_equal(got, want)


def _block_rows(w, k, warps, j0):
    """The rows a B3 block whose first candidate row is j0 stages (the
    kernel's lo .. hi)."""
    r = mk.SLIDING_Q * warps
    lo = max(j0 - w, 0) + 1
    hi = min(j0 + r - 2, k - 1) + w
    return hi - lo + 1


def test_b3_plan_at_the_replay_path():
    # W=64: 8 warps, R = 48 candidate rows and 174 rows (22 KB) a block; the
    # tail chunk's K=7 stripe has 70 rows in all
    assert mk.sliding_plan(64, 512) == (8, 174)
    assert mk.sliding_plan(64, 7) == (8, 70)


@pytest.mark.parametrize("w,k,plan", [
    (169, 300, (8, 384)), (170, 300, (4, 362)), (181, 300, (4, 384)), (182, 300, (2, 374)),
    (187, 300, (2, 384)), (188, 300, (1, 380)), (190, 300, (1, 384)), (191, 300, (8, 0)),
    (1536, 7, (8, 0)), (300, 2, (8, 301)), (1, 1, (8, 1)), (1, 600, (8, 48)),
])
def test_b3_plan_takes_fewer_warps_then_the_unstaged_route(w, k, plan):
    assert mk.sliding_plan(w, k) == plan


@pytest.mark.parametrize("w", [1, 2, 3, 7, 33, 64, 100, 150, 169, 170, 181, 182, 187, 188, 190, 191,
                               400])
def test_b3_plan_stages_every_block_in_its_budget(w):
    """Each staged plan fits the shared-memory budget and holds the rows of
    every block of the grid; the unstaged route only when one warp's
    block would not fit."""
    for k in (1, 2, 5, 7, 64, 193, 512):
        warps, rows = mk.sliding_plan(w, k)
        r = mk.SLIDING_Q * warps
        if rows == 0:
            assert min(mk.SLIDING_Q + 2 * w - 2, w + k - 1) * mk.SLIDING_BEAMS * 4 > \
                mk.SLIDING_STAGE_BYTES
            continue
        assert rows * mk.SLIDING_BEAMS * 4 <= mk.SLIDING_STAGE_BYTES
        assert 1 <= warps <= mk.SLIDING_MAX_WARPS
        for j0 in range(1, w + k, r):
            assert _block_rows(w, k, warps, j0) <= rows


def test_b3_plan_constants_are_the_sources():
    import re

    src = (cuda_build.CSRC_DIR / "sliding_median.cu").read_text()
    assert int(re.search(r"kBeams = (\d+);", src)[1]) == mk.SLIDING_BEAMS
    assert int(re.search(r"kQ = (\d+);", src)[1]) == mk.SLIDING_Q
    assert int(re.search(r"kMaxWarps = (\d+);", src)[1]) == mk.SLIDING_MAX_WARPS
    assert int(re.search(r"kStageBytes = (\d+) \* 1024;", src)[1]) * 1024 == mk.SLIDING_STAGE_BYTES


def _b3_rule(ext, w, q):
    """csrc/sliding_median.cu's selection replayed in numpy, one thread at
    a time: each owns q candidate rows of a beam, ranks them with ties
    broken by row (rows before a candidate count u <= v, rows after it
    u < v), slides the ranks window by window (the general rule where its
    own rows move or a candidate is outside the window, the plain slide
    between) and writes v where its rank is max((nvalid - 1) >> 1, 0).
    Returns the output and how many times each entry was written."""

    def before(u, r, v, jd):
        return int(u <= v) if r < jd else int(r > jd and u < v)

    k = ext.shape[0] - w
    last_row = w + k - 1
    out = np.full((k, ext.shape[1]), np.nan, np.float32)
    writes = np.zeros(out.shape, int)
    for b in range(ext.shape[1]):
        col = ext[:, b]
        for j in range(1, last_row + 1, q):
            v = [col[j + d] if j + d <= last_row else np.inf for d in range(q)]
            cnt = [0] * q
            first, last = max(j - w, 0), min(j + q - 2, k - 1)
            top = first + w
            nvalid = int(np.isfinite(col[first + 1 : top + 1]).sum())
            for r in range(first + 1, top + 1):
                for d in range(q):
                    cnt[d] += before(col[r], r, v[d], j + d)

            def emit(i, all_in):
                kk = max((nvalid - 1) >> 1, 0)
                for d in range(q):
                    if (all_in or j + d - w <= i <= j + d - 1) and cnt[d] == kk:
                        out[i, b] = v[d] if nvalid > 0 else np.inf
                        writes[i, b] += 1

            emit(first, False)
            for i in range(first + 1, last + 1):
                gone, came = col[i], col[i + w]
                nvalid += int(np.isfinite(came)) - int(np.isfinite(gone))
                plain = j + q - w <= i <= j - 1
                for d in range(q):
                    if plain:
                        cnt[d] += int(came < v[d]) - int(gone <= v[d])
                    else:
                        cnt[d] += before(came, i + w, v[d], j + d) - before(gone, i, v[d], j + d)
                emit(i, plain)
    return out, writes


@pytest.mark.parametrize("w,k,b", [(1, 1, 3), (1, 5, 4), (2, 1, 3), (3, 2, 5), (5, 1, 4), (7, 3, 5),
                                   (20, 3, 4), (6, 20, 3), (3, 30, 3), (9, 9, 2)])
def test_b3_kernel_rule_writes_each_median_once(w, k, b):
    """The kernel's rule (kQ = 6 candidate rows a thread, and 1 and 3)
    against the plain version, with ties, +inf, all-+inf beams and -inf:
    every output written exactly once, with the sort's bits."""
    rng = np.random.default_rng(w * 100 + k)
    ext = rng.uniform(0.1, 40.0, (w + k, b)).astype(np.float32)
    ext[rng.random(ext.shape) < 0.4] = np.inf
    ext = np.round(ext, 0).astype(np.float32)
    ext[:, 0] = np.inf
    ext[rng.random(ext.shape) < 0.1] = -np.inf
    want = mk.sliding_median_plain(torch.from_numpy(ext), w).numpy()
    for q in (mk.SLIDING_Q, 1, 3):
        got, writes = _b3_rule(ext, w, q)
        assert (writes == 1).all(), q
        np.testing.assert_array_equal(got, want)
