"""Standalone entry point — equivalent of src/standalone_main.cpp.

The reference's main is rclcpp::init -> RPlidarNode -> executor spin
(src/standalone_main.cpp:6-17).  Here:

    python -m rplidar_ros2_driver_tpu_torch run [--params FILE] [--dummy] [--duration S] [--cpu]
    python -m rplidar_ros2_driver_tpu_torch replay CAP.rplr [--chain] [--fused] [--map]
        [--loop-close] [--map-backend auto|host|fused] [--map-pgm PATH] [--cpu]
    python -m rplidar_ros2_driver_tpu_torch view [--scans N] [--pgm PATH] [--cpu]
    python -m rplidar_ros2_driver_tpu_torch udev [--install]
    python -m rplidar_ros2_driver_tpu_torch doctor [--port DEV] [--cpu]

``run`` drives the real driver (driver/real.RealLidarDriver over the
native serial, TCP or UDP channel that ``channel_type`` names) unless
``--dummy`` or ``dummy_mode`` picks the synthetic backend; with
``ingest_backend: fused`` the raw frames decode and filter on the device.
The filter chain, the node's fused ingest, the replay's decode, its fused
device ingest (``--fused``: the raw capture bytes through
replay.replay_raw_fused, held to the host chain), the SLAM front-end mapper (``--map``; with
``map_enable`` in the node) and the SLAM back-end (``--loop-close``:
loop closure and the pose graph, replay.replay_with_loop_closure; with
``loop_enable`` in the node) run on the CUDA card unless ``filter_backend:
cpu`` (or ``--cpu``) keeps them on the host.  ``--chain`` of several
captures runs them as a fleet, one stream each (replay.replay_fleet).
``view`` renders a dummy node's newest scan (tools/viz.py; the chain on the
card unless ``--cpu``), ``udev`` prints or installs the udev rules
(tools/udev.py), and ``doctor`` checks the environment row by row (the
torch backend probe of utils/backend.py, the native I/O library, a
protocol round trip through the simulator and ``RealLidarDriver``, the
serial port); its exit code is 1 only on a FAIL.
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


def _view_defaults(path=None) -> dict:
    """Load config/rplidar_view.yaml (the rviz-config analog); CLI flags win."""
    import os

    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    path = path or os.path.join(os.path.dirname(here), "config", "rplidar_view.yaml")
    defaults = {"size_px": 256, "view_range_m": 4.0, "ascii_width": 64, "point_weight": 255}
    try:
        with open(path) as f:
            doc = yaml.safe_load(f)
        view = doc.get("view") if isinstance(doc, dict) else None
        if isinstance(view, dict):
            defaults.update(view)
        elif doc is not None:
            print(f"warning: ignoring malformed view config {path}", file=sys.stderr)
    except OSError:
        pass
    except yaml.YAMLError as e:
        print(f"warning: unreadable view config {path}: {e}", file=sys.stderr)
    return defaults


def _cmd_view(args) -> int:
    """Capture dummy scans through the node (the chain on the card unless
    ``--cpu``) and render the newest one top-down."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode
    from rplidar_ros2_driver_tpu_torch.tools.viz import ascii_preview, save_pgm, scan_to_image

    view_cfg = _view_defaults(args.view_config)
    params = DriverParams(dummy_mode=True, **({"filter_backend": "cpu"} if args.cpu else {}))
    node = RPlidarNode(params)
    node.configure()
    node.activate()
    pub = node.publisher
    try:
        t0 = time.monotonic()
        while pub.scan_count < args.scans and time.monotonic() - t0 < 30:
            time.sleep(0.05)
    finally:
        node.deactivate()
        node.cleanup()
        node.shutdown()
    if not pub.scans:
        print("no scans captured", file=sys.stderr)
        return 1
    img = scan_to_image(
        pub.scans[-1],
        size_px=int(view_cfg["size_px"]),
        view_range_m=args.range_m if args.range_m is not None else float(view_cfg["view_range_m"]),
        point_weight=int(view_cfg["point_weight"]),
    )
    if args.pgm:
        save_pgm(img, args.pgm)
        print(f"wrote {args.pgm}")
    else:
        print(ascii_preview(img, width=int(view_cfg["ascii_width"])))
    return 0


def _cmd_replay(args) -> int:
    """Batch-decode capture(s) and, with ``--chain``, run the revolutions
    through the fused multi-scan chain — on the card unless ``--cpu``.
    The report lines are the JAX package's ``replay`` subcommand's."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.filters.chain import pick_device
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
    from rplidar_ros2_driver_tpu_torch.replay import decode_recording

    backend = "cpu" if args.cpu else "cuda"
    device = pick_device(backend)
    per_stream = []
    runs_per_path = []
    for path in args.recordings:
        dec = decode_recording(path, device=device)
        revs = dec.revolutions()
        per_stream.append(revs)
        runs_per_path.append(len(dec.runs))
        print(f"{path}: {dec.num_nodes} nodes, {len(revs)} complete revolutions")
        for ans_type, n_frames, n_nodes in dec.runs:
            try:
                name = Ans(ans_type).name
            except ValueError:
                name = f"0x{ans_type:02x}"
            print(f"  run: {name:34s} {n_frames:6d} frames -> {n_nodes:7d} nodes")
        if revs:
            pts = [len(r["angle_q14"]) for r in revs]
            print(f"  points/rev: min={min(pts)} median={sorted(pts)[len(pts)//2]} max={max(pts)}")
    if args.chain and not all(per_stream):
        empty = [p for p, revs in zip(args.recordings, per_stream) if not revs]
        print(f"  --chain skipped: no complete revolutions in {', '.join(empty)}")
    elif args.chain:
        from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

        params = DriverParams(filter_backend=backend, filter_chain=("clip", "median", "voxel"))
        t0 = time.perf_counter()
        if len(per_stream) == 1:
            from rplidar_ros2_driver_tpu_torch.replay import replay_through_chain

            ranges, state = replay_through_chain(per_stream[0], params)
            what = "fused multi-scan step"
        else:
            # N captures = N streams through the (stream, beam) mesh
            from rplidar_ros2_driver_tpu_torch.replay import replay_fleet

            k_min = min(len(r) for r in per_stream)
            if any(len(r) != k_min for r in per_stream):
                print(
                    f"  note: recordings differ in length — fleet replay "
                    f"truncates every stream to {k_min} revolutions"
                )
            ranges, state = replay_fleet(per_stream, params)
            what = f"sharded fleet replay ({len(per_stream)} streams)"
        dt = time.perf_counter() - t0
        occupancy = int(state.voxel_acc.sum())
        n_scans = int(np.prod(ranges.shape[:-1]))
        finite = np.isfinite(ranges)
        print(
            f"  chain: {n_scans} scans through the {what} in "
            f"{dt:.2f} s ({n_scans / dt:.0f} scans/s); "
            f"median range {np.median(ranges[finite]):.2f} m, "
            f"voxel occupancy {occupancy}"
        )
    if args.fused:
        _replay_fused_report(args, per_stream, runs_per_path, backend)
    if args.map or args.loop_close:
        # --loop-close implies the map report (the back-end is the map and
        # trajectory pipeline plus the correction)
        _replay_map_report(args, per_stream, backend)
    return 0


def _replay_fused_report(args, per_stream, runs_per_path, backend: str) -> None:
    """The ``replay --fused`` arm: each capture's raw bytes through the
    fused device ingest (replay.replay_raw_fused) against the host chain
    over the revolutions already decoded, with the JAX CLI's report line.
    A capture that switches scan modes legitimately diverges (the fused
    replay uses the live engine's reset semantics), so its parity is
    reported as skipped; any other mismatch fails the command."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.replay import replay_raw_fused, replay_through_chain

    params = DriverParams(filter_backend=backend, filter_chain=("clip", "median", "voxel"))
    for path, revs, n_runs in zip(args.recordings, per_stream, runs_per_path):
        t0 = time.perf_counter()
        ranges_h, state_h = replay_through_chain(revs, params)
        dt_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranges_f, state_f, stats = replay_raw_fused(path, params)
        dt_fused = time.perf_counter() - t0
        n = ranges_f.shape[0]
        host_sps = n / dt_host if dt_host > 0 else float("inf")
        fused_sps = n / dt_fused if dt_fused > 0 else float("inf")
        if n_runs > 1:
            verdict = f"parity skipped (capture switches modes: {n_runs} runs)"
            parity = True
        else:
            parity = (
                ranges_f.shape == ranges_h.shape
                and np.array_equal(ranges_f, ranges_h)
                and np.array_equal(state_f.voxel_acc.numpy(), state_h.voxel_acc.numpy())
            )
            verdict = f"parity {'OK' if parity else 'MISMATCH'}"
        print(
            f"{path}: fused raw replay {n} scans in {dt_fused:.2f} s "
            f"({fused_sps:.0f} scans/s, {stats['dispatches']} dispatches "
            f"for {stats['ticks']} ticks at T={stats['super_tick']}); "
            f"host chain {dt_host:.2f} s ({host_sps:.0f} scans/s); "
            f"{verdict}"
        )
        if not parity:
            raise SystemExit(f"{path}: fused raw replay diverged from the host path")


def _replay_map_report(args, per_stream, backend: str) -> None:
    """The ``replay --map`` arm: each capture's revolutions through the
    chain and the SLAM front-end (replay.replay_with_map; with
    ``--loop-close`` the back-end too, replay.replay_with_loop_closure),
    reported with the JAX CLI's lines: a summary, the loop-closure line,
    then an ASCII preview or a PGM (raw trajectory 200, corrected 255)."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.replay import replay_with_loop_closure, replay_with_map
    from rplidar_ros2_driver_tpu_torch.tools.viz import (
        ascii_preview,
        draw_trajectory,
        map_to_image,
        save_pgm,
    )

    params = DriverParams(
        filter_backend=backend,
        filter_chain=("clip", "median", "voxel"),
        map_enable=True,
        map_backend=args.map_backend,
        loop_enable=bool(args.loop_close),
    )
    for i, (path, revs) in enumerate(zip(args.recordings, per_stream)):
        if not revs:
            print(f"{path}: --map skipped (no complete revolutions)")
            continue
        corrected = engine = None
        if args.loop_close:
            traj, corrected, scores, mapper, engine = replay_with_loop_closure(revs, params)
        else:
            traj, scores, mapper = replay_with_map(revs, params)
        snap = mapper.snapshot()
        occupied = int(np.sum(snap["log_odds"][0] > 0))
        matched = int(np.sum(scores > 0))
        x, y, th = traj[-1]
        print(
            f"{path}: mapped {len(revs)} revolutions "
            f"({mapper.backend} backend): {matched} matched, "
            f"{occupied} occupied cells, final pose "
            f"({x:+.3f} m, {y:+.3f} m, {np.degrees(th):+.2f} deg)"
        )
        img = draw_trajectory(
            map_to_image(snap["log_odds"][0], mapper.cfg.clamp_q), traj[:, :2], mapper.cfg.cell_m,
            value=200 if corrected is not None else 255,
        )
        if corrected is not None:
            st = engine.status()
            cx, cy, cth = corrected[-1]
            print(
                f"  loop closure ({engine.backend} backend): "
                f"{st['accepted']} accepted / {st['rejected']} rejected, "
                f"{st['submaps'][0]} submaps, corrected final pose "
                f"({cx:+.3f} m, {cy:+.3f} m, {np.degrees(cth):+.2f} deg)"
            )
            # the corrected trajectory over the raw one, brighter
            img = draw_trajectory(img, corrected[:, :2], mapper.cfg.cell_m, value=255)
        if args.map_pgm:
            out = args.map_pgm if len(per_stream) == 1 else f"{args.map_pgm}.{i}"
            save_pgm(img, out)
            print(f"  wrote {out}")
        else:
            # occupied evidence past half clamp (or the trajectory) as '#'
            print(ascii_preview((img >= 192).astype(np.uint8), width=64))


def _cmd_doctor(args) -> int:
    """Environment self-check: every row prints PASS/WARN/FAIL + detail.

    Exit code is 1 only on FAIL (WARN covers degraded-but-working states
    like the pure-Python transport fallback)."""
    results: list[tuple[str, str, str]] = []

    def check(name: str, fn) -> None:
        try:
            level, detail = fn()
        except Exception as e:  # noqa: BLE001 - a crashed probe IS the finding
            level, detail = "FAIL", f"{type(e).__name__}: {e}"
        results.append((name, level, detail))

    def deps():
        # informational: a genuinely MISSING torch/numpy fails at package
        # import, before this subcommand runs — this row reports what is
        # installed, it cannot catch absence
        import numpy
        import torch

        return "PASS", f"torch {torch.__version__}, numpy {numpy.__version__}"

    def native_lib():
        from rplidar_ros2_driver_tpu_torch import native

        if native.available():
            return "PASS", "librpl_native.so loaded (C++ I/O plane active)"
        return "WARN", ("native library unavailable — pure-Python transport "
                        "fallback will be used (no SCHED_RR rx elevation)")

    def torch_backend():
        from rplidar_ros2_driver_tpu_torch.utils.backend import (
            probe_torch_backend,
            probe_torch_backend_subprocess,
        )

        if args.cpu:
            ok, detail = probe_torch_backend(args.device_timeout, device="cpu")
        else:
            # two-stage guard: a throwaway child takes the wedge risk first,
            # then THIS process's CUDA init runs under the in-process hang
            # guard (the card can drop between the child's exit and it)
            ok, detail = probe_torch_backend_subprocess(args.device_timeout)
            if ok:
                ok, detail = probe_torch_backend(args.device_timeout)
        return ("PASS" if ok else "FAIL"), detail

    def sim_roundtrip():
        import time as _time

        from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
        from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice
        from rplidar_ros2_driver_tpu_torch.node.diagnostics import rx_scheduling_label

        sim = SimulatedDevice().start()
        try:
            drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1",
                                  tcp_port=sim.port, motor_warmup_s=0.0)
            if not drv.connect("sim", 0, False):
                return "FAIL", "connect to loopback simulator failed"
            drv.detect_and_init_strategy()
            if not drv.start_motor("", 600):
                return "FAIL", "scan start failed"
            t0 = _time.monotonic()
            got = None
            while got is None and _time.monotonic() - t0 < 10:
                got = drv.grab_scan_host(2.0)
            sched = rx_scheduling_label(drv.rx_scheduling_class())
            drv.stop_motor()
            drv.disconnect()
            if got is None:
                return "FAIL", "no revolution within 10 s"
            return "PASS", (f"full protocol round-trip: {len(got[0]['angle_q14'])} "
                            f"nodes/rev through channel->codec->decode->assembly; "
                            f"rx thread at {sched}")
        finally:
            sim.stop()

    def serial_port():
        import os

        port = args.port
        if os.path.exists(port):
            ok = os.access(port, os.R_OK | os.W_OK)
            return ("PASS" if ok else "WARN",
                    f"{port} present{'' if ok else ' but not read/writable (udev rules? dialout group?)'}")
        return "WARN", f"{port} not present (no device attached, or udev rule missing — see `udev` subcommand)"

    check("python deps", deps)
    check("native I/O library", native_lib)
    check("torch backend", torch_backend)
    if results[-1][1] == "PASS":
        check("loopback protocol round-trip", sim_roundtrip)
    else:
        # the CLI's other paths need the backend the flag selects: with the
        # card down, re-run with --cpu to test the rest of the stack
        results.append(("loopback protocol round-trip", "SKIP",
                        "skipped: torch backend unavailable; "
                        "re-run with --cpu to test the rest of the stack"))
    check("serial port", serial_port)

    worst = 0
    for name, level, detail in results:
        print(f"[{level:4s}] {name}: {detail}")
        worst = max(worst, {"PASS": 0, "WARN": 0, "SKIP": 0, "FAIL": 1}[level])
    return worst


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(prog="rplidar_ros2_driver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd")

    run = sub.add_parser("run", help="bring up the lifecycle node and spin")
    run.add_argument("--params", default=None, help="parameter YAML (default: param/rplidar.yaml)")
    run.add_argument("--dummy", action="store_true",
                     help="force the synthetic backend (default: the real driver on the "
                     "params' channel)")
    run.add_argument("--duration", type=float, default=0.0, help="seconds to run (0 = forever)")
    run.add_argument("--cpu", action="store_true", help="run the filter chain on the host")
    run.add_argument("--stats", action="store_true",
                     help="print per-stage latency percentiles (JSON) at exit")

    view = sub.add_parser("view", help="capture dummy scans and render a top-down view")
    view.add_argument("--scans", type=int, default=3)
    view.add_argument("--range-m", type=float, default=None, help="overrides view config")
    view.add_argument("--pgm", default=None, help="write image here instead of ASCII preview")
    view.add_argument(
        "--view-config", default=None, help="view YAML (default: config/rplidar_view.yaml)"
    )
    view.add_argument("--cpu", action="store_true", help="run the filter chain on the host")

    udev = sub.add_parser("udev", help="generate/install udev rules")
    udev.add_argument("--install", action="store_true")

    doctor = sub.add_parser("doctor", help="environment self-check (deps, native lib, "
                            "torch backend, protocol round-trip, port)")
    doctor.add_argument("--cpu", action="store_true",
                        help="probe the host backend instead of the card")
    doctor.add_argument("--port", default="/dev/rplidar", help="serial port to probe")
    doctor.add_argument("--device-timeout", type=float, default=60.0,
                        help="seconds to wait for the card's init before declaring it down")

    replay = sub.add_parser("replay", help="batch-decode frame recording(s)")
    replay.add_argument("recordings", nargs="+", help="capture file(s) (.rplr)")
    replay.add_argument("--cpu", action="store_true",
                        help="decode and run the chain on the host instead of the card")
    replay.add_argument(
        "--chain",
        action="store_true",
        help="also run the decoded revolutions through the filter chain "
        "(fused multi-scan step)",
    )
    replay.add_argument(
        "--fused",
        action="store_true",
        help="also replay the RAW capture bytes through the fused device ingest "
        "(replay_raw_fused: T-tick super-steps) and report scans/s against the "
        "host chain, parity-checked",
    )
    replay.add_argument(
        "--map",
        action="store_true",
        help="also run the decoded revolutions through the SLAM front-end "
        "(correlative scan-to-map matching + log-odds map, "
        "replay.replay_with_map): prints trajectory + map summary and an "
        "ASCII map preview",
    )
    replay.add_argument(
        "--loop-close",
        action="store_true",
        help="with --map: run the SLAM back-end too (submap library, loop-closure "
        "candidate matching, fixed-point pose-graph relaxation, "
        "replay.replay_with_loop_closure) and draw the corrected trajectory next "
        "to the raw one (raw 200, corrected 255)",
    )
    replay.add_argument(
        "--map-pgm",
        default=None,
        metavar="PATH",
        help="write the --map log-odds map (trajectory overlaid) as a PGM "
        "instead of the ASCII preview",
    )
    replay.add_argument(
        "--map-backend",
        choices=("auto", "host", "fused"),
        default="auto",
        help="mapper backend for --map (auto: fused on the card, host with "
        "--cpu; host is the NumPy golden reference)",
    )

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "view":
        return _cmd_view(args)
    if args.cmd == "replay":
        return _cmd_replay(args)
    if args.cmd == "doctor":
        return _cmd_doctor(args)
    if args.cmd == "udev":
        from rplidar_ros2_driver_tpu_torch.tools import udev as udev_mod

        return udev_mod.main(["--install"] if args.install else [])
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
