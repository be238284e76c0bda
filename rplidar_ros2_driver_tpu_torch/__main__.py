"""Standalone entry point — equivalent of src/standalone_main.cpp.

The reference's main is rclcpp::init -> RPlidarNode -> executor spin
(src/standalone_main.cpp:6-17).  Here:

    python -m rplidar_ros2_driver_tpu_torch run [--params FILE] [--dummy] [--duration S] [--cpu]

The filter chain runs on the CUDA card unless ``filter_backend: cpu`` (or
``--cpu``) keeps it on the host.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def _cmd_run(args) -> int:
    from rplidar_ros2_driver_tpu_torch.launch import launch_lifecycle
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState

    overrides = {}
    if args.dummy:
        overrides["dummy_mode"] = True
    if args.cpu:
        overrides["filter_backend"] = "cpu"
    node = launch_lifecycle(args.params, overrides=overrides or None)
    if node.lifecycle_state is not LifecycleState.ACTIVE:
        print("bringup failed (see log)", file=sys.stderr)
        return 1
    pub = node.publisher
    deadline = time.monotonic() + args.duration if args.duration else None
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(1.0)
            node._update_diagnostics()
            diag = pub.diagnostics[-1] if getattr(pub, "diagnostics", None) else None
            scans = getattr(pub, "scan_count", 0)
            state = diag.message if diag else "?"
            print(f"[{node.name}] scans={scans} state={state}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if node.lifecycle_state is LifecycleState.ACTIVE:
            node.deactivate()
        if node.lifecycle_state is LifecycleState.INACTIVE:
            node.cleanup()
        node.shutdown()
    if args.stats:
        import json

        print(json.dumps(node.tracer.summary(), indent=2))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(prog="rplidar_ros2_driver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd")

    run = sub.add_parser("run", help="bring up the lifecycle node and spin")
    run.add_argument("--params", default=None, help="parameter YAML (default: param/rplidar.yaml)")
    run.add_argument("--dummy", action="store_true", help="force the synthetic backend")
    run.add_argument("--duration", type=float, default=0.0, help="seconds to run (0 = forever)")
    run.add_argument("--cpu", action="store_true", help="run the filter chain on the host")
    run.add_argument("--stats", action="store_true",
                     help="print per-stage latency percentiles (JSON) at exit")

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
