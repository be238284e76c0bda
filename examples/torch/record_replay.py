"""Record wire frames live, then batch-decode and re-filter offline.

The capture tee sits at the decoder (every measurement frame and its
arrival time, before any lossy processing), so a recording replays
bit-exactly: the offline decode runs whole frame runs through the batched
unpack, and ``replay_through_chain`` pushes the recovered revolutions
through the fused multi-scan chain (the sliding-median kernel on the card),
hundreds of revolutions a chunk.

    python examples/torch/record_replay.py [--cpu] [--seconds 3]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="decode and filter on the host")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice
    from rplidar_ros2_driver_tpu_torch.replay import decode_recording, replay_through_chain

    device = "cpu" if args.cpu else "cuda"
    with tempfile.NamedTemporaryFile(suffix=".rpl", delete=False) as f:
        path = f.name
    sim = SimulatedDevice().start()
    try:
        drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1",
                              tcp_port=sim.port, motor_warmup_s=0.0)
        assert drv.connect("sim", 0, False)
        drv.detect_and_init_strategy()
        assert drv.start_motor("DenseBoost", 600)
        drv.start_recording(path)
        # run for --seconds, but gate on the OUTCOME: at least 3 grabbed
        # revolutions (with a generous ceiling), so a loaded box cannot
        # produce an empty recording
        t_end = time.monotonic() + args.seconds
        t_giveup = time.monotonic() + max(args.seconds, 60.0)
        grabbed = 0
        while time.monotonic() < t_end or (grabbed < 3 and time.monotonic() < t_giveup):
            if drv.grab_scan_host(2.0) is not None:
                grabbed += 1
        frames = drv.stop_recording()
        drv.stop_motor()
        drv.disconnect()
        print(f"live: {grabbed} revolutions grabbed, {frames} frames captured")
    finally:
        sim.stop()

    try:
        rec = decode_recording(path, device=device)
        revs = rec.revolutions()
        print(f"offline decode: {rec.num_nodes} nodes in {len(rec.runs)} runs "
              f"-> {len(revs)} complete revolutions")
        params = DriverParams(filter_backend="cpu" if args.cpu else "cuda",
                              filter_window=4,
                              filter_chain=("clip", "median", "voxel"),
                              voxel_grid_size=64)
        ranges, final_state = replay_through_chain(revs, params, beams=256, chunk=64)
        print(f"chain replay: per-rev range images {tuple(ranges.shape)}, "
              f"final voxel occupancy {int(final_state.voxel_acc.sum())}")
    finally:
        os.unlink(path)
    return 0 if len(revs) > 0 and ranges.shape[0] == len(revs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
