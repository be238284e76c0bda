"""Fleet gateway: N lidars through ONE sharded step on the card.

Each simulated device gets its own driver stack (native channel -> decode ->
assembly); every tick stacks the newest revolution per stream into a single
counted upload and runs the ``(stream, beam)``-sharded chain step — one
median kernel launch for the whole fleet.  Replays the same revolutions
offline through ``replay_fleet``, then finishes with a sharded checkpoint of
the service's state (torch.distributed.checkpoint: each process writes its
own block, no host gather), a restore into a fresh service, and the next
tick run on both, byte-equal.

    python examples/torch/fleet_gateway.py [--cpu] [--streams 2] [--ticks 5]
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run the fleet on the host")
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    sims = [SimulatedDevice().start() for _ in range(args.streams)]
    drvs = []
    ok = False
    try:
        for sim in sims:
            d = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1",
                                tcp_port=sim.port, motor_warmup_s=0.0)
            assert d.connect("sim", 0, False)
            d.detect_and_init_strategy()
            assert d.start_motor("DenseBoost", 600)
            drvs.append(d)

        params = DriverParams(filter_backend="cpu" if args.cpu else "cuda",
                              filter_window=4,
                              filter_chain=("clip", "median", "voxel"),
                              voxel_grid_size=64)
        svc = ShardedFilterService(params, streams=args.streams, beams=256, capacity=4096)
        captures = [[] for _ in drvs]
        for tick in range(args.ticks):
            scans = []
            for s, d in enumerate(drvs):
                got = d.grab_scan_host(2.0)
                scans.append(got[0] if got else None)
                if got:
                    captures[s].append(got[0])
            # pipelined fleet tick: collect the PREVIOUS tick's outputs
            # while this tick computes (one tick of declared staleness)
            outs = svc.submit_pipelined(scans)
            live = sum(o is not None for o in outs)
            occ = [int(np.asarray(o.voxel).sum()) if o else 0 for o in outs]
            print(f"tick {tick}: {live}/{args.streams} streams (prev tick), "
                  f"voxel occ {occ}", flush=True)
        tail = svc.flush_pipelined()
        if tail is not None:
            live = sum(o is not None for o in tail)
            print(f"drained final tick: {live}/{args.streams} streams")

        # the same revolutions again, offline: the fleet replay over the
        # service's mesh — one sliding-median launch a chunk for the fleet
        if all(len(c) >= 1 for c in captures):
            from rplidar_ros2_driver_tpu_torch.replay import replay_fleet

            ranges, _ = replay_fleet(captures, params, mesh=svc.mesh, beams=256,
                                     capacity=4096, chunk=8)
            print(f"fleet replay: {ranges.shape[1]} revs/stream re-filtered "
                  f"offline -> ranges {tuple(ranges.shape)}")

        tmp = tempfile.mkdtemp(prefix="fleet_ckpt_")
        ckpt_dir = os.path.join(tmp, "ckpt")
        try:
            svc.save_sharded(ckpt_dir)
            svc2 = ShardedFilterService(params, streams=args.streams, beams=256,
                                        capacity=4096)
            ok = svc2.load_sharded(ckpt_dir)
            # the restored service continues exactly as the saved one
            last = [c[-1] if c else None for c in captures]
            a, b = svc.submit(last), svc2.submit(last)
            same = all((x is None and y is None) or (
                x is not None and y is not None
                and np.array_equal(np.asarray(x.ranges), np.asarray(y.ranges))
                and np.array_equal(np.asarray(x.voxel), np.asarray(y.voxel)))
                for x, y in zip(a, b))
            ok = ok and same
            print(f"sharded checkpoint restore into a fresh service: "
                  f"{'ok' if ok else 'FAILED'} (next tick equal: {same})")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        for d in drvs:
            try:
                d.stop_motor()
                d.disconnect()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        for s in sims:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
