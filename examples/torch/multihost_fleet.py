"""Multi-controller fleet: N processes, one ``(stream, beam)`` mesh.

Two modes, one worker code path:

* **Demo (default)**: self-launches two worker processes on this machine
  (the parent is only a launcher), each owning one lidar stream: gloo on
  the host with ``--cpu``; on cards NCCL, one card a process, when there
  are two, else gloo over the one card (NCCL refuses two ranks on one
  device).

* **Pod runbook (--worker)**: the one command each host of a real pod
  runs.  Set the coordinator variables and start the same command on every
  host — the worker joins the process group via
  ``parallel.multihost.initialize``, builds the global stream-major mesh
  and ticks the fleet:

      JAX_COORDINATOR_ADDRESS=host0:8476 \\
      JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=<this host's id> \\
      python examples/torch/multihost_fleet.py --worker --ticks 100

  Each process uploads ONLY its own streams' revolutions
  (``submit_local`` — ingest never crosses hosts) and reads back only its
  own output rows; the beam-axis all-reduce runs over the process group.
  Swap the DummyLidarDriver for ``RealLidarDriver`` per stream to feed
  real sensors.

    python examples/torch/multihost_fleet.py [--cpu] [--ticks 5]
"""

import argparse
import os
import socket
import subprocess
import sys

# the runbook invokes this file directly from any cwd: python only adds
# examples/torch/ to sys.path, so the package root must be added explicitly
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _REPO)


def run_worker(ticks: int, streams_per_host: int = 1, window: int = 4, cpu: bool = False,
               backend=None, allow_single: bool = False) -> int:
    """The per-process fleet worker — the pod runbook entry point.  The
    topology comes from the coordinator variables (module docstring)."""
    import torch.distributed as dist

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
    from rplidar_ros2_driver_tpu_torch.parallel import multihost
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    if not multihost.initialize(backend=backend or ("gloo" if cpu else None)):
        # a pod worker with no coordinator must FAIL here, not degrade:
        # this host would tick its own 1-process mesh and exit 0 looking
        # healthy while every peer waits for it
        if not allow_single:
            print("error: no multi-process topology configured "
                  f"({multihost._COORD_ENV} unset); a pod worker must not "
                  "silently run alone — pass --single-process for a deliberate "
                  "1-process smoke run", file=sys.stderr, flush=True)
            return 2
        print("single-process smoke run (--single-process)", flush=True)
    grouped = dist.is_initialized()
    pid = dist.get_rank() if grouped else 0
    nproc = dist.get_world_size() if grouped else 1
    streams = nproc * streams_per_host
    mesh = multihost.make_global_mesh(stream=streams, device="cpu" if cpu else None)
    print(f"proc {pid}: joined, mesh {dict(mesh.shape)} over {nproc} processes "
          f"on {mesh.device}", flush=True)

    params = DriverParams(filter_window=window, filter_chain=("clip", "median", "voxel"),
                          voxel_grid_size=32, filter_backend="cpu" if cpu else "cuda")
    svc = ShardedFilterService(params, streams=streams, mesh=mesh, beams=256, capacity=1024)
    # this host's OWN sensors — on a real rig, one RealLidarDriver a stream
    lidars = []
    for _ in range(streams_per_host):
        lidar = DummyLidarDriver()
        lidar.connect("dummy", 0, False)
        lidar.start_motor("", 600)
        lidars.append(lidar)

    def grab_local():
        # a grab timeout degrades to an idle row (None) — raising here would
        # abort this process AHEAD of the collective while every peer blocks
        grabs = [lidar.grab_scan_host(2.0) for lidar in lidars]
        return [g[0] if g is not None else None for g in grabs]

    for tick in range(ticks):
        outs = svc.submit_local(grab_local())  # collective: all processes tick
        label = f"voxel occ {int(outs[0].voxel.sum())}" if outs[0] is not None else "(idle)"
        print(f"proc {pid} tick {tick}: {label}", flush=True)
    # pipelined ticks: publish tick N-1 while N computes (ALL processes use
    # the pipelined variant together)
    for tick in range(ticks):
        prev = svc.submit_local_pipelined(grab_local())
        label = f"{int(prev[0].voxel.sum())}" if prev[0] is not None else "(warming)"
        print(f"proc {pid} pipelined tick {tick}: prev-tick occ {label}", flush=True)
    tail = svc.flush_pipelined()
    if tail is not None and tail[0] is not None:
        print(f"proc {pid}: drained final tick occ {int(tail[0].voxel.sum())}", flush=True)
    for lidar in lidars:
        lidar.stop_motor()
        lidar.disconnect()
    if grouped:
        dist.barrier()
        dist.destroy_process_group()
    print(f"proc {pid}: done", flush=True)
    return 0


def demo_backend(cpu: bool) -> str:
    """gloo on the host; NCCL when every worker has a card of its own,
    else gloo over the one card."""
    if cpu:
        return "gloo"
    import torch

    return "nccl" if torch.cuda.device_count() >= 2 else "gloo"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--worker", action="store_true",
                    help="run as ONE fleet process (the pod runbook command — topology "
                    "from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)")
    ap.add_argument("--streams-per-host", type=int, default=1)
    ap.add_argument("--window", type=int, default=4,
                    help="rolling temporal-median window per stream")
    ap.add_argument("--single-process", action="store_true",
                    help="with --worker: deliberately run a 1-process fleet without a "
                    "coordinator (smoke runs only)")
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)  # the launcher's
    ap.add_argument("--cpu", action="store_true", help="run the workers on the host (gloo)")
    args = ap.parse_args(argv)

    if args.worker:
        return run_worker(args.ticks, args.streams_per_host, window=args.window,
                          cpu=args.cpu, backend=args.backend,
                          allow_single=args.single_process)

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    backend = demo_backend(args.cpu)

    def launch_once(port: int):
        procs = []
        for i in range(2):
            env = dict(
                os.environ,
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES="2",
                JAX_PROCESS_ID=str(i),
                PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            )
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--ticks", str(args.ticks), "--streams-per-host", str(args.streams_per_host),
                 "--window", str(args.window), "--backend", backend,
                 *(["--cpu"] if args.cpu else [])],
                cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        # a hung worker takes its sibling down with it (a lone survivor
        # would orphan holding the coordinator port)
        outs = ["", ""]
        try:
            for i, p in enumerate(procs):
                try:
                    outs[i], _ = p.communicate(timeout=180)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    outs[i], _ = p.communicate()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return procs, outs

    # the free-port probe races other processes binding it: one retry with a
    # fresh port, only when the failure looks like a bind problem
    port_errors = ("Address already in use", "Failed to bind", "EADDRINUSE")
    for attempt in range(2):
        procs, outs = launch_once(free_port())
        if all(p.returncode == 0 for p in procs):
            break
        if attempt == 0 and not any(e in out for e in port_errors for out in outs):
            break
    ok = True
    for i, p in enumerate(procs):
        print(f"--- worker {i} (rc={p.returncode}, {backend}) ---")
        print(outs[i].strip())
        ok = ok and p.returncode == 0 and "done" in outs[i]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
