"""The PyTorch package, its examples and chip_smoke.py stand alone: no JAX, no JAX package.

The check reads the source (an AST scan of every import, top level and
nested), not ``sys.modules``: this environment imports JAX at interpreter
start-up, so a module-table check would prove nothing.
"""

import ast
import os

import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rplidar_ros2_driver_tpu_torch")
JAX_PACKAGE = "rplidar_ros2_driver_tpu"


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for top in (PORT, os.path.join(REPO, "examples", "torch")):
        for root, _dirs, files in os.walk(top):
            out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == JAX_PACKAGE


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    rel = {os.path.relpath(p, PORT) for p in port_sources()}
    for module in (
        "core/config.py", "core/types.py", "ops/filters.py", "ops/median_kernels.py",
        "filters/chain.py", "driver/dummy.py", "node/node.py", "launch/lifecycle_launch.py",
        "__main__.py", "protocol/constants.py", "protocol/crc.py", "ops/unpack.py",
        "ops/wire.py", "replay.py", "ops/scan_match.py", "ops/scan_match_kernels.py",
        "ops/scan_match_ref.py", "mapping/mapper.py", "tools/viz.py",
        "protocol/timing.py", "driver/assembly.py", "driver/decode.py", "driver/ingest.py",
        "ops/deskew.py", "ops/deskew_kernels.py", "ops/deskew_ref.py", "ops/ingest.py",
        "utils/cuda_build.py", "utils/launch.py",
        # the live wire path
        "protocol/codec.py", "protocol/conf.py", "protocol/engine.py",
        "protocol/pytransport.py", "native/__init__.py", "native/runtime.py",
        "ops/unpack_ref.py", "driver/sim_device.py", "driver/chaos.py", "driver/real.py",
        # the SLAM back-end and the world map
        "slam/__init__.py", "slam/loop.py", "ops/pose_graph.py", "ops/pose_graph_ref.py",
        "ops/loop_close.py", "ops/loop_close_ref.py", "ops/tile_quant.py",
        "mapping/submap.py", "mapping/tiles.py", "mapping/worldmap.py", "tools/loop_drift.py",
        # the mesh and the sharded fleet service
        "parallel/__init__.py", "parallel/sharding.py", "parallel/multihost.py",
        "parallel/service.py",
        # the carried map's row surface and the health supervisor
        "utils/rowops.py", "driver/health.py",
        # the sharded checkpoints, the scenario foundry and matrix, the tooling
        "utils/checkpoint_sharded.py", "utils/backend.py", "scenarios/__init__.py",
        "scenarios/foundry.py", "scenarios/metrics.py", "scenarios/trajectory.py",
        "tools/scenario_matrix.py", "tools/udev.py", "tools/ros_bridge.py",
        "launch/bus.py", "launch/container.py", "compat.py",
        # the examples
        "../examples/torch/single_lidar.py", "../examples/torch/fleet_gateway.py",
        "../examples/torch/record_replay.py", "../examples/torch/multihost_fleet.py",
    ):
        assert module in rel
    for source in ("median.cu", "sliding_median.cu", "scan_match.cu", "deskew.cu",
                   "device_guard.cuh"):
        assert os.path.exists(os.path.join(PORT, "csrc", source))


def test_scan_reads_the_live_paths_nested_imports():
    """The live path's, the SLAM back-end's and the fleet service's lazy
    imports (inside functions) are in the scan and point at this
    package."""
    for rel, module in (
        ("driver/real.py", "rplidar_ros2_driver_tpu_torch.native.runtime"),
        ("driver/real.py", "rplidar_ros2_driver_tpu_torch.protocol.pytransport"),
        ("driver/real.py", "rplidar_ros2_driver_tpu_torch.ops.ascend"),
        ("driver/real.py", "rplidar_ros2_driver_tpu_torch.replay"),
        ("protocol/engine.py", "rplidar_ros2_driver_tpu_torch.native.runtime"),
        ("protocol/pytransport.py", "rplidar_ros2_driver_tpu_torch.native.runtime"),
        ("driver/sim_device.py", "rplidar_ros2_driver_tpu_torch.driver.chaos"),
        ("driver/chaos.py", "rplidar_ros2_driver_tpu_torch.native.runtime"),
        ("node/node.py", "rplidar_ros2_driver_tpu_torch.driver.real"),
        ("node/node.py", "rplidar_ros2_driver_tpu_torch.slam.loop"),
        ("replay.py", "rplidar_ros2_driver_tpu_torch.slam.loop"),
        ("slam/loop.py", "rplidar_ros2_driver_tpu_torch.ops.loop_close_ref"),
        ("slam/loop.py", "rplidar_ros2_driver_tpu_torch.filters.chain"),
        ("mapping/worldmap.py", "rplidar_ros2_driver_tpu_torch.filters.chain"),
        ("parallel/service.py", "rplidar_ros2_driver_tpu_torch.driver.ingest"),
        ("parallel/service.py", "rplidar_ros2_driver_tpu_torch.mapping.mapper"),
        ("parallel/service.py", "rplidar_ros2_driver_tpu_torch.slam.loop"),
        ("parallel/service.py", "rplidar_ros2_driver_tpu_torch.mapping.worldmap"),
        ("parallel/service.py", "rplidar_ros2_driver_tpu_torch.driver.decode"),
        ("parallel/sharding.py", "torch.distributed.device_mesh"),
        ("replay.py", "rplidar_ros2_driver_tpu_torch.parallel.sharding"),
        ("__main__.py", "rplidar_ros2_driver_tpu_torch.replay"),
    ):
        assert module in set(imported_modules(os.path.join(PORT, rel))), (rel, module)


def test_detector_catches_jax_imports():
    src = "import jax\nfrom rplidar_ros2_driver_tpu.ops import filters\nimport rplidar_ros2_driver_tpu_torch\n"
    tree_mods = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tree_mods.append(node.module)
    assert [m for m in tree_mods if forbidden(m)] == ["jax", "rplidar_ros2_driver_tpu.ops"]


def test_kernels_are_hand_written_not_compiled_torch():
    """No torch.compile or library-kernel builder stands in for a kernel."""
    for path in port_sources():
        text = open(path).read()
        assert "torch.compile" not in text, path
        assert "cpp_extension" not in text, path


def test_port_console_command_is_its_main():
    """pyproject.toml installs ``rplidar-tpu-torch`` for the port's CLI,
    and that entry answers ``--help`` with exit 0."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["rplidar-tpu-torch"] == "rplidar_ros2_driver_tpu_torch.__main__:main"
    module, func = scripts["rplidar-tpu-torch"].split(":")
    main = getattr(importlib.import_module(module), func)
    from rplidar_ros2_driver_tpu_torch.__main__ import main as port_main

    assert main is port_main
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0


def test_every_port_test_file_takes_one_torch_thread():
    """Each ``tests/test_torch_*.py`` imports the ``one_torch_thread``
    fixture of ``tests/torch_threads.py`` (read from the source's AST)."""
    tests = os.path.join(REPO, "tests")
    files = sorted(f for f in os.listdir(tests) if f.startswith("test_torch_") and f.endswith(".py"))
    assert files
    missing = []
    for name in files:
        tree = ast.parse(open(os.path.join(tests, name)).read(), filename=name)
        if not any(isinstance(node, ast.ImportFrom) and node.module == "torch_threads"
                   and any(a.name == "one_torch_thread" for a in node.names)
                   for node in ast.walk(tree)):
            missing.append(name)
    assert not missing, f"without one_torch_thread: {missing}"
