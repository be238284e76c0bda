"""The PyTorch package's mesh across real processes: gloo groups on the CPU.

One device per process: each worker joins the group through
``parallel.multihost`` (the JAX package's three coordinator variables),
builds the global ``(stream, beam)`` mesh and holds its block of the
result to the one-process ``(1, 1)`` port run on the same inputs in the
same worker, bit for bit:

  * (1, 2) and (1, 4) meshes: the batched step and the fused fleet scan
    with the ``psum`` and ``ring`` voxel all-reduce, on the B1/B2/B3
    plain versions (``pallas``, ``inc``).  The beam axis spans the
    processes, so the accumulator equals the one-process one only if the
    all-reduce delivered every peer's partial counts;
    The last state is then saved as a sharded checkpoint (each process
    its block, utils/checkpoint_sharded.py) and restored onto a
    (2, nproc / 2) mesh of the same group and whole onto one process;
  * a (2, 1) mesh: ``ShardedFilterService.submit_local`` (and its
    pipelined form) equal to ``submit`` on the whole fleet, the
    single-controller surfaces refusing the spanning mesh.

Three groups in all, each under its own time limit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMMON = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch

    port, pid, nproc, stream = (int(a) for a in sys.argv[1:5])
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = str(nproc)
    os.environ["JAX_PROCESS_ID"] = str(pid)

    from rplidar_ros2_driver_tpu_torch.ops import filters as tf
    from rplidar_ros2_driver_tpu_torch.parallel import multihost
    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

    assert multihost.is_configured()
    assert multihost.initialize(backend="gloo")
    assert multihost.initialize()  # idempotent
    W, B, G, CELL, S, CAP = 8, 512, 64, 0.25, 4, 400
    rng = np.random.default_rng(0)  # identical data on every process

    def rand_scan(n):
        dist = rng.integers(0, 60_000, n).astype(np.int32)
        dist[rng.random(n) < 0.1] = 0
        return {"angle_q14": rng.integers(0, 1 << 16, n).astype(np.int32),
                "dist_q2": dist, "quality": rng.integers(0, 256, n).astype(np.int32),
                "flag": None}

    def ticks(k):
        return [[None if (s == 1 and t % 3 == 2) else rand_scan(int(rng.integers(150, CAP)))
                 for s in range(S)] for t in range(k)]

    def packed(row):
        seq = np.zeros((S, 3, CAP), np.uint16)
        counts = np.zeros((S,), np.int32)
        for i, sc in enumerate(row):
            if sc is not None:
                seq[i], counts[i] = tf.pack_host_scan_compact(
                    sc["angle_q14"], sc["dist_q2"], sc["quality"], None, CAP)
        return seq, counts

    def batch(seq, counts):
        return tf._unpack_compact(torch.from_numpy(seq.view(np.int16)), torch.from_numpy(counts))

    def eq(a, b, what):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), what)
    """
)

_MESH_WORKER = _COMMON + textwrap.dedent(
    """
    mesh = multihost.make_global_mesh(stream=stream, device="cpu")
    assert mesh.shape == {"stream": stream, "beam": nproc // stream}, mesh
    assert mesh.spans_processes and mesh.beam_group is not None
    local = ts.make_mesh(1, device="cpu")  # this process's own (1, 1) mesh
    rows, cols = mesh.local_streams(S), mesh.local_beams(B)
    data = ticks(10)
    for reduce in ("psum", "ring"):
        for median in ("pallas", "inc"):
            what = f"{reduce}/{median}"
            cfg = tf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL,
                                  median_backend=median, voxel_reduce=reduce)
            gstep, lstep = ts.build_sharded_step(mesh, cfg), ts.build_sharded_step(local, cfg)
            gs, ls = ts.create_sharded_state(mesh, cfg, S), ts.create_sharded_state(local, cfg, S)
            assert tuple(gs.range_window.shape) == (S // stream, W, B // mesh.shape["beam"])
            for t, row in enumerate(data[:6]):
                b = batch(*packed(row))
                gs, go = gstep(gs, ts.shard_batch(mesh, b))
                ls, lo = lstep(ls, b)
                eq(go.ranges, lo.ranges[rows][:, cols], f"{what} step {t} ranges")
                eq(go.points_xy, lo.points_xy[rows][:, cols], f"{what} step {t} xy")
                eq(go.voxel, lo.voxel[rows], f"{what} step {t} voxel")
            assert (gs.median_sorted is None) == (median != "inc")
            for name in ("range_window", "inten_window") + (("median_sorted",) * (median == "inc")):
                eq(getattr(gs, name), getattr(ls, name)[rows][..., cols], f"{what} {name}")
            for name in ("hit_window", "voxel_acc", "cursor", "filled"):
                eq(getattr(gs, name), getattr(ls, name)[rows], f"{what} {name}")
            gscan, lscan = ts.build_sharded_scan(mesh, cfg), ts.build_sharded_scan(local, cfg)
            gs, ls = ts.create_sharded_state(mesh, cfg, S), ts.create_sharded_state(local, cfg, S)
            for lo_k, hi_k in ((0, 3), (3, 10)):
                seqs, counts = zip(*(packed(r) for r in data[lo_k:hi_k]))
                seq = np.stack(seqs, axis=1)
                cnt = np.stack(counts, axis=1)
                gs, gr = gscan(gs, seq[rows], cnt[rows])
                ls, lr = lscan(ls, seq, cnt)
                eq(gr, lr[rows][..., cols], f"{what} scan {lo_k}:{hi_k}")
            eq(gs.voxel_acc, ls.voxel_acc[rows], f"{what} scan voxel_acc")
            eq(gs.hit_window, ls.hit_window[rows], f"{what} scan hit_window")
    # the sharded checkpoint of the last state: each process writes its
    # block of this (1, nproc) mesh; restored onto a (2, nproc / 2) mesh of
    # the same group and whole onto one process, bit-equal to the
    # one-process run
    import shutil
    import tempfile
    import torch.distributed as dist
    from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded as cs

    path = os.path.join(tempfile.gettempdir(), f"rpl_ckpt_{port}")
    core = {k: v for k, v in cs.as_tensor_dict(gs).items() if k != "median_sorted"}
    cs.save_sharded(path, core, mesh=mesh, specs=ts.STATE_SPEC)
    tmpl = ts.abstract_sharded_state(mesh, cfg, S)
    other = multihost.make_global_mesh(stream=2, device="cpu")
    back = cs.restore_sharded(path, tmpl, mesh=other, specs=ts.STATE_SPEC)
    rows2, cols2 = other.local_streams(S), other.local_beams(B)
    assert back is not None and set(back) == set(core)
    for name, v in back.items():
        want = getattr(ls, name)[rows2]
        eq(v, want[..., cols2] if "beam" in ts.STATE_SPEC[name] else want, f"restore {name}")
    whole = cs.restore_sharded(path, tmpl, device="cpu")
    for name, v in whole.items():
        eq(v, getattr(ls, name), f"one-process restore {name}")
    dist.barrier()
    if pid == 0:
        shutil.rmtree(path, ignore_errors=True)
    print(f"proc {pid}: checkpoint of {mesh.shape} restored on {other.shape} and whole",
          flush=True)
    print(f"proc {pid}: mesh {mesh.shape} bit-exact, ring host hops {ts.ring_host_hops}",
          flush=True)
    """
)

_SERVICE_WORKER = _COMMON + textwrap.dedent(
    """
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    params = DriverParams(filter_backend="cpu", filter_window=W, voxel_grid_size=G,
                          filter_chain=("clip", "median", "voxel"))
    mesh = multihost.make_global_mesh(stream=stream, device="cpu")
    assert mesh.shape == {"stream": nproc, "beam": 1}
    svc = ShardedFilterService(params, S, mesh=mesh, beams=B, capacity=CAP)
    pipe = ShardedFilterService(params, S, mesh=mesh, beams=B, capacity=CAP)
    ref = ShardedFilterService(params, S, mesh=ts.make_mesh(1, device="cpu"),
                               beams=B, capacity=CAP)
    slc = multihost.local_stream_slice(S)
    assert slc == mesh.local_streams(S) and slc.stop - slc.start == S // nproc
    svc.precompile()
    wants, shifted = [], []
    for t, row in enumerate(ticks(6)):
        got = svc.submit_local(row[slc])
        shifted.append(pipe.submit_local_pipelined(row[slc]))
        want = ref.submit(row)[slc]
        wants.append(want)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                for name in ("ranges", "intensities", "points_xy", "point_mask", "voxel"):
                    eq(getattr(a, name), getattr(b, name), f"tick {t} {name}")
    assert shifted[0] == [None] * len(wants[0])
    for t in range(1, len(wants)):
        for a, b in zip(shifted[t], wants[t - 1]):
            assert (a is None) == (b is None)
            if a is not None:
                eq(a.voxel, b.voxel, f"pipelined tick {t}")
    tail = pipe.flush_pipelined()
    eq(tail[0].ranges, wants[-1][0].ranges, "pipelined flush")
    for call in (lambda: svc.submit([None] * S), lambda: svc.snapshot(),
                 lambda: svc.submit_pipelined([None] * S)):
        try:
            call()
            raise AssertionError("a spanning mesh must refuse single-controller calls")
        except RuntimeError as e:
            assert "submit_local" in str(e), e
    try:
        from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest
        FleetFusedIngest(params, S, mesh=mesh, beams=B)
        raise AssertionError("the fleet-fused ingest runs on a one-process mesh")
    except ValueError as e:
        assert "submit_local" in str(e), e
    # a restore on the spanning mesh places each process's block
    assert svc.restore(ref.snapshot())
    row = ticks(1)[0]
    got, want = svc.submit_local(row[slc]), ref.submit(row)[slc]
    eq(got[0].voxel, want[0].voxel, "after restore")
    print(f"proc {pid}: submit_local == submit", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(worker: str, nproc: int, stream: int, timeout_s: float = 150.0) -> list[str]:
    """Start the group and wait for every rank.  Each rank writes to a file
    of its own, so no rank can block on a full pipe while its peers wait
    for it inside a collective."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("LOCAL_RANK", None)
    logs = [tempfile.TemporaryFile("w+") for _ in range(nproc)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker, str(port), str(pid), str(nproc), str(stream)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True,
        )
        for pid, log in enumerate(logs)
    ]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outs


@pytest.mark.parametrize("nproc", [2, 4])
def test_beam_axis_across_processes_matches_one_process(nproc):
    outs = _run_group(_MESH_WORKER, nproc, stream=1)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: mesh" in out and "bit-exact" in out, out
        assert f"proc {pid}: checkpoint of" in out and "restored on" in out, out
        assert "ring host hops 0" in out  # host tensors: the ring stages nothing


def test_submit_local_across_processes_matches_submit():
    outs = _run_group(_SERVICE_WORKER, 2, stream=2)
    for pid, out in enumerate(outs):
        assert f"proc {pid}: submit_local == submit" in out, out
