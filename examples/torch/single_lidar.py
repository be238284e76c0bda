"""Single lidar, full pipeline: lifecycle node + the filter chain on the card.

The everyday deployment: one device (here the protocol-accurate simulator
standing in over TCP), the 5-state fault-tolerant FSM, and the filter chain
(the temporal median in the hand-written CUDA kernel) publishing ranges and
a rolling voxel occupancy grid.  Also shows the checkpoint surface: the
rolling window survives a deactivate/activate cycle.

    python examples/torch/single_lidar.py [--cpu] [--seconds 5]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def wait_for(pred, deadline_s: float) -> bool:
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(0.05)
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run the filter chain on the host")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice
    from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode

    sim = SimulatedDevice().start()
    params = DriverParams(
        channel_type="tcp",
        scan_mode="DenseBoost",
        filter_backend="cpu" if args.cpu else "cuda",
        filter_chain=("clip", "median", "voxel"),
        filter_window=8,
        voxel_grid_size=128,
    )
    node = RPlidarNode(
        params,
        driver_factory=lambda: RealLidarDriver(
            channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
            motor_warmup_s=0.0,
        ),
    )
    ok = False
    try:
        assert node.configure() and node.activate()
        # wait on the OUTCOME (first published scan), not a fixed clock:
        # the kernels' first build and the FSM warm-up have no fixed bound
        assert wait_for(lambda: node.publisher.scan_count >= 1, 120.0), (
            "no scan published within 120 s"
        )
        t_end = time.monotonic() + args.seconds
        while time.monotonic() < t_end:
            time.sleep(1.0)
            pub = node.publisher
            occ = int(pub.clouds[-1].voxel.sum()) if pub.clouds else 0
            print(f"scans={pub.scan_count} voxel_occupancy={occ} "
                  f"diag={node.diagnostics.last.message}", flush=True)
        # checkpoint across a lifecycle bounce: the window survives
        with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
            ckpt = f.name
        try:
            node.save_checkpoint(ckpt)
            before = node.publisher.scan_count
            node.deactivate()
            node.activate()
            restored = node.load_checkpoint(ckpt)
            # the reactivated FSM re-runs connect/warm-up: wait on the outcome
            wait_for(lambda: node.publisher.scan_count > before, 60.0)
            after = node.publisher.scan_count
            print(f"resumed: restore={restored} scans {before} -> {after}")
            ok = restored and after > before
        finally:
            os.unlink(ckpt)
    finally:
        node.shutdown()
        sim.stop()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
