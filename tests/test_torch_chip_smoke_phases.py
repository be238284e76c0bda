"""``chip_smoke.py``'s structure, checked without a card.

The script is the port's proof on the H100: it must time every phase
(``seconds`` and ``cpu_seconds`` on each phase line), list all eight
kernels in its kernels line, and keep every launch check it has made
since the CUDA kernels landed.  These tests read the script with ``ast``
and import it (its module level imports only the standard library), run
its phase clock and its CPU references here, and hold the scene
builders the script and the port's tests share
(``rplidar_ros2_driver_tpu_torch/tools/scenes.py``) to the bytes the
script's own builders made before they moved there.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rplidar_ros2_driver_tpu_torch.tools import graded as gr  # noqa: E402
from rplidar_ros2_driver_tpu_torch.tools import scenes  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread)

SOURCE = open(os.path.join(ROOT, "chip_smoke.py")).read()
TREE = ast.parse(SOURCE)

# the eight kernels of the kernels line: name -> the Pallas site it replaces
KERNELS = {
    "temporal_median": "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:396",
    "sorted_replace": "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:337",
    "sliding_median": "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:215",
    "coarse_scores": "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:154",
    "fine_scores": "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:248",
    "log_odds_update": "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:369",
    "beam_min": "rplidar_ros2_driver_tpu/ops/pallas_deskew.py:104",
    "shift_sad": "rplidar_ros2_driver_tpu/ops/pallas_deskew.py:198",
}

# every check on kernel launches the script made before its phases were
# timed and its CPU references moved to worker processes: (condition,
# message), as ast.unparse writes them
LAUNCH_CHECKS = (
    ("all((row['configs'][n]['launches'].get('temporal_median', 0) > 0 for n in (19, 20, 21, 22)))",
     "'scheduled: B1 never launched on a config'"),
    ("all((v > 0 for v in launched.values()))",
     "f'map node did not launch every matcher kernel: {launched}'"),
    ("c_card['launches'][k] > 0",
     "f'failover carried arm: {k} never launched'"),
    ("card['launches']['all_arms']['temporal_median'] > 0",
     "'graded 13: no B1 launch'"),
    ("card['launches'][arm]['temporal_median'] > 0",
     "f'graded 11: no B1 launch on the {arm} arm'"),
    ("device.type != 'cuda' or launched['sliding_median'] == chunks",
     "f\"replay_fleet launched B3 {launched['sliding_median']} times for {chunks} chunks\""),
    ("fused['launches']['log_odds_update'] == 0",
     "'the loop arm launched B8'"),
    ("fused['launches'][name] == ticks",
     "f\"{name} launched {fused['launches'][name]} times for {ticks} check ticks\""),
    ("k['failover_launches'] > 0",
     "f\"kernel {k['name']} never launched on the failover path\""),
    ("k['fleet_launches'] > 0",
     "f\"kernel {k['name']} never launched on the fleet path\""),
    ("k['fused_mapping_launches'] > 0",
     "f\"kernel {k['name']} never launched on the fused mapping path\""),
    ("k['graded_launches'] > 0",
     "f\"kernel {k['name']} never launched on the graded path\""),
    ("k['launches'] > 0",
     "f\"kernel {k['name']} never launched on the main path\""),
    ("k['mesh_blocks_launches'] > 0",
     "f\"kernel {k['name']} never launched on the mesh blocks path\""),
    ("k['scheduled_launches'] > 0",
     "f\"kernel {k['name']} never launched on the scheduled path\""),
    ("launched['coarse_scores'] == want_launches and launched['fine_scores'] == want_launches",
     "f'node B6/B7 launches {launched} != {revs} mapper ticks + {eng.dispatch_count} checks + 2 warm-ups'"),
    ("launched['sliding_median'] == -(-k // REPLAY['chunk'])",
     "'B3 launches on the map replay'"),
    ("launched['sliding_median'] == n_chunks",
     "f\"B3 launched {launched['sliding_median']} times for {n_chunks} chunks\""),
    ("launched['temporal_median'] == 0 and launched['sorted_replace'] == 0",
     "f'graded {c}: the median kernels launched with the median off: {launched}'"),
    ("launched['temporal_median'] == k",
     "f\"{name}: B1 launched {launched['temporal_median']} times for {k} revolutions\""),
    ("launched['temporal_median'] == ticks",
     "f\"the SLAM service's ticks launched B1 {launched['temporal_median']} times for {ticks} ticks\""),
    ("launched[kernel] == len(revs)",
     "f'{median}: {launched[kernel]} launches for {len(revs)} steps'"),
    ("launched[name] == k",
     "f'{name} launched {launched[name]} times for {k} scans'"),
    ("launched[name] == k + eng.dispatch_count + 1",
     "f'{name} launched {launched[name]} times for {k} scans and {eng.dispatch_count} checks'"),
    ("launched[name] >= ticks",
     "f'the SLAM service never launched {name} a tick'"),
    ("launches.get(k, 0) > 0",
     "f'checkpoints: {k} never launched'"),
    ("launches.get(k, 0) > 0",
     "f'scenarios: {k} never launched'"),
    ("launches['beam_min'] > 0 and launches['shift_sad'] > 0",
     "f'e2e {name}: B4/B5 never launched ({launches})'"),
    ("launches['temporal_median'] > 0",
     "f'e2e {name}: B1 never launched'"),
    ("mk.launch_counts['temporal_median'] > 0",
     "'node never launched B1'"),
    ("off['launches']['beam_min'] == 0 and off['launches']['shift_sad'] == 0",
     "'de-skew kernels launched with de-skew off'"),
    ("on['launches']['beam_min'] == slots + ticks_done",
     "f\"B4 launched {on['launches']['beam_min']} times for {slots} tick slots and {ticks_done} ticks that completed a revolution\""),
    ("row['configs'][22]['launches'].get(k, 0) > 0",
     "f\"scheduled: {k} never launched on config 22's path\""),
    ("row['launches'].get(k, 0) > 0",
     "f'tooling: {k} never launched'"),
    ("stats['launches']['beam_min'] > 0 and stats['launches']['shift_sad'] > 0",
     "f'config 10 {name}: B4/B5 never launched'"),
    ("stats['launches']['temporal_median'] == stats['revolutions']",
     "f'config 10 {name}: B1 launches != completed revolutions'"),
    ("stats[f'{key}_launches_per_tick'] == 1.0",
     "f\"config 10 {name}: {stats[f'{key}_launches_per_tick']} median launches per dispatched tick, not one for the fleet\""),
    ("total.get('temporal_median', 0) == ref['launches'].get('temporal_median', 0) > 0",
     "f\"mesh rows: {what}: B1 launched {total.get('temporal_median', 0)} times, the one row {ref['launches'].get('temporal_median', 0)}\""),
)


def _function(name: str) -> ast.FunctionDef:
    return next(n for n in TREE.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _is_phase(name: str) -> bool:
    return (name.startswith("phase_") or name.endswith("_profile")) and name != "phase_clock"


def _timed_calls(fn: ast.FunctionDef) -> list:
    """``_timed(clock, phase, ...)`` calls in ``fn``: (clock, phase name)."""
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "_timed":
            clock, target = n.args[0], n.args[1]
            out.append((clock.value if isinstance(clock, ast.Constant) else None,
                        target.id if isinstance(target, ast.Name) else ast.unparse(target)))
    return out


def _phase_names_emitted() -> set:
    """Every "phase": <name> string constant of a dict in the script."""
    names = set()
    for n in ast.walk(TREE):
        if isinstance(n, ast.Dict):
            for k, v in zip(n.keys, n.values):
                if (isinstance(k, ast.Constant) and k.value == "phase"
                        and isinstance(v, ast.Constant)):
                    names.add(v.value)
    return names


def test_every_phase_of_the_default_run_is_timed():
    run = _function("_default_run")
    direct = [n.func.id for n in ast.walk(run) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name) and _is_phase(n.func.id)]
    assert direct == [], f"phases called outside their clock: {direct}"
    timed = _timed_calls(run)
    phases = {p for _c, p in timed}
    defined = {n.name for n in TREE.body if isinstance(n, ast.FunctionDef) and _is_phase(n.name)}
    # every phase of the script runs in the default run, but the ones
    # that exist only for --pod-cards
    assert defined - phases == {"phase_device", "phase_build", "phase_pod_cards",
                                "phase_pod_cards_mesh"}
    emitted = _phase_names_emitted()
    for clock, _phase in timed:
        assert clock in emitted, f"no phase line named {clock!r} carries its clock"


def test_device_build_and_one_phase_runs_are_timed():
    main = _function("main")
    timed = _timed_calls(main)
    assert ("device", "phase_device") in timed and ("build", "phase_build") in timed
    assert any(p == "ONE_PHASE[name]" and c is None for c, p in timed), timed
    emitted = _phase_names_emitted()
    for name in cs.ONE_PHASE:
        assert name in emitted, f"--phase {name} prints no line of its name"


def _lines(run) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_a_phase_line_carries_its_clock():
    def run():
        with cs.phase_clock("alpha"):
            with cs.cpu_reference():
                with cs.cpu_reference():      # nested: counted once
                    pass
            cs.emit({"phase": "alpha", "x": 1})
            cs.emit({"phase": "inner_line"})  # no clock of its own: alpha's
        with cs.phase_clock("alpha"):         # a second half adds to the first
            cs.emit({"phase": "alpha"})
        cs.emit({"phase": "outside"})
        cs.emit({"kernels": []})

    first, inner, second, outside, kernels = _lines(run)
    assert first["x"] == 1 and first["seconds"] >= first["cpu_seconds"] >= 0.0
    assert inner["seconds"] >= first["seconds"]
    assert second["seconds"] >= inner["seconds"]
    assert second["cpu_seconds"] >= first["cpu_seconds"]
    assert "seconds" not in outside and "cpu_seconds" not in outside
    assert kernels == {"kernels": []}


def test_cpu_reference_time_lands_on_the_phase():
    import time

    def run():
        with cs.phase_clock("beta"):
            with cs.cpu_reference():
                time.sleep(0.05)
            cs.emit({"phase": "beta"})

    (line,) = _lines(run)
    assert line["cpu_seconds"] >= 0.05 and line["seconds"] >= line["cpu_seconds"]


def test_the_kernels_line_lists_all_eight_kernels():
    run = ast.get_source_segment(SOURCE, _function("_default_run"))
    for name, replaces in KERNELS.items():
        assert f'"{name}"' in run and f'"{replaces}"' in run, name
        path, line = replaces.split(":")
        with open(os.path.join(ROOT, path)) as f:
            src = f.read().splitlines()
        assert int(line) <= len(src), replaces
        assert "pallas_call" in "\n".join(src), path


def test_every_launch_check_of_the_script_is_still_made():
    got = collections.Counter()
    for n in ast.walk(TREE):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "check"
                and n.args):
            got[(ast.unparse(n.args[0]), ast.unparse(n.args[1]))] += 1
    want = collections.Counter(LAUNCH_CHECKS)
    missing = [k for k, v in want.items() if got[k] < v]
    assert missing == []


def test_every_cpu_reference_of_a_phase_is_planned():
    """Each reference a phase asks for through ``_ref`` is in the run's plan,
    so the workers compute it; and every planned one is asked for."""
    asked = {n.args[1].id for n in ast.walk(TREE) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "_ref"}
    plan = [job for jobs in cs.ref_plan(0).values() for job in jobs]
    planned = {fn.__name__ for fn, *_a in plan}
    assert asked == planned
    # each planned once: a worker computes each key once
    keys = [cs._ref_key(fn.__name__, tuple(args)) for fn, *args in plan]
    assert len(keys) == len(set(keys))
    assert all(name.startswith("ref_") for name in planned)


def test_a_reference_key_is_its_function_and_its_arguments():
    key = cs._ref_key("ref_mapping", ("host",))
    assert key == cs._ref_key("ref_mapping", ("host",))
    assert key != cs._ref_key("ref_mapping", ("cpu_torch",))
    assert key != cs._ref_key("ref_loop_arm", ("host",))
    # a geometry passed as an argument is part of the key, by its items
    g16 = dict(gr.GEOMETRY["full"][16])
    assert cs._ref_key("ref_graded", ("16", g16)) == cs._ref_key(
        "ref_graded", ("16", dict(reversed(list(g16.items())))))
    assert cs._ref_key("ref_graded", ("16", g16)) != cs._ref_key(
        "ref_graded", ("16", {**g16, "revs": g16["revs"] + 1}))


def test_a_reference_no_worker_was_handed_is_computed_here():
    refs = cs._References()
    before = cs._CPU_REF["seconds"]
    got = refs.get(cs._ref_key("make_revolutions", (3, 2, 40)),
                   lambda: cs.make_revolutions(3, 2, 40))
    assert cs._CPU_REF["seconds"] > before
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(got, cs.make_revolutions(3, 2, 40))
               for k in a)
    assert refs.worker_seconds == {} and refs.running() == 0


def test_a_layouts_dict_keeps_each_reference_once():
    """``--pod-cards``' two layouts hand ``_ref`` one dict: the second asks
    for the same reference and gets the first's, computed here once."""
    calls = []

    def count(fn):
        def run(*args):
            calls.append(args)
            return fn(*args)
        run.__name__ = fn.__name__
        return run

    cpu: dict = {}
    fn = count(cs.make_revolutions)
    first = cs._ref(cpu, fn, 3, 2, 40)
    assert cs._ref(cpu, fn, 3, 2, 40) is first
    assert cs._ref(cpu, fn, 4, 2, 40) is not first
    assert calls == [(3, 2, 40), (4, 2, 40)]
    assert list(cpu) == [cs._ref_key("make_revolutions", (3, 2, 40)),
                         cs._ref_key("make_revolutions", (4, 2, 40))]


@pytest.mark.parametrize("cores,want", [(8, [4, 5, 6, 7]), (16, [12, 13, 14, 15]),
                                        (3, [2]), (2, [1]), (1, [])])
def test_the_workers_take_the_upper_half_of_the_cores(monkeypatch, cores, want):
    monkeypatch.setattr(cs.os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert cs._worker_cpus() == want


def test_a_worker_computes_a_reference_and_reports_its_failure(monkeypatch):
    monkeypatch.setattr(cs, "REF_WORKERS", 1)
    refs = cs._References()
    refs.start()
    try:
        assert refs.cpus == [max(os.sched_getaffinity(0))]
        refs.submit(cs.make_revolutions, 3, 2, 40)
        refs.submit(cs.make_revolutions, 3, -1, "forty")
        got = refs.get(cs._ref_key("make_revolutions", (3, 2, 40)), lambda: None)
        assert all(np.array_equal(a[k], b[k])
                   for a, b in zip(got, cs.make_revolutions(3, 2, 40)) for k in a)
        with pytest.raises(SystemExit):
            refs.get(cs._ref_key("make_revolutions", (3, -1, "forty")), lambda: None)
        # the worker that ran them sits on its core, at the lowest priority
        (worker,) = refs.pool._pool
        assert os.sched_getaffinity(worker.pid) == set(refs.cpus)
        assert os.getpriority(os.PRIO_PROCESS, worker.pid) == 19
        # the result came through a file, read and removed by get()
        results = refs.dir
        assert os.listdir(results) == []
    finally:
        refs.close()
    assert not os.path.exists(results)


def test_a_phase_line_counts_the_references_still_pending(monkeypatch):
    class Job:
        def __init__(self, done):
            self.done = done

        def ready(self):
            return self.done

    monkeypatch.setattr(cs.REFS, "pending", {k: (Job(done), f"{k}.pkl")
                                             for k, done in (("a", False), ("b", True),
                                                             ("c", False))})

    def run():
        with cs.phase_clock("gamma"):
            cs.emit({"phase": "gamma"})

    (line,) = _lines(run)
    assert line["refs_pending"] == 2


def test_a_scenario_cell_holds_the_card_to_the_reference_as_to_its_host_arm():
    """The scenarios phase hands ``matrix_cell`` its host arm from a worker
    (``ref_scenario_cell``, pickled across): the same cell as the host arm
    computed in place."""
    import pickle

    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    g = smx.geometry(smoke=True)
    args = ("rooms", "faulty", 2, smx.SEED, g["n_revs"], g["grid"], g["cell"], g["beams"])
    asked = []

    def host(kind, chaos, fleet, base_seed, n_revs, grid, cell, beams):
        asked.append((kind, chaos, fleet, base_seed, n_revs, grid, cell, beams))
        return pickle.loads(pickle.dumps(
            cs.ref_scenario_cell(kind, chaos, fleet, n_revs, grid, cell, beams)))

    timing = ("scans_per_sec", "fused_ticks_per_sec", "clamped", "_dt_s")
    got = smx.matrix_cell(*args, host=host)
    want = smx.matrix_cell(*args)
    assert asked == [args]
    assert got["fused_equal"] and want["fused_equal"]
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})


def test_the_phase_table_spans_each_phase_from_the_line_before():
    from rplidar_ros2_driver_tpu_torch.tools.smoke_phases import phase_table

    stamped = [
        (1.0, '{"phase": "device", "seconds": 0.5, "cpu_seconds": 0.0, "refs_pending": 0}\n'),
        (1.5, "[Dummy] Virtual RPLIDAR device ready.\n"),
        (4.0, '{"phase": "e2e", "arm": "host"}\n'),
        (6.0, '{"phase": "e2e", "seconds": 5.0, "cpu_seconds": 1.0, "refs_pending": 3}\n'),
        (7.0, '{"phase": "tooling"}\n'),
        (9.5, '{"phase": "e2e"}\n'),
        (10.0, '{"kernels": [], "seconds": 9.0}\n'),
        (10.25, "NVIDIA H100 80GB HBM3, 700.00 W\n"),
        (10.5, '{"ok": true, "device": {"platform": "gpu"}}\n'),
    ]
    script_s, table = phase_table(stamped)
    assert script_s == 9.0
    assert table == {
        "device": {"span_s": 1.0, "seconds": 0.5, "cpu_seconds": 0.0, "refs_pending": 0},
        "e2e": {"span_s": 7.5, "seconds": 5.0, "cpu_seconds": 1.0, "refs_pending": 3},
        "tooling": {"span_s": 1.0},
        "kernels_line": {"span_s": 0.5},
    }


def test_the_plan_names_the_phases_of_the_default_run():
    run = _function("_default_run")
    starts = [n for n in ast.walk(run) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name) and n.func.id == "_start_references"]
    assert len(starts) == 1
    phases = ast.literal_eval(starts[0].args[0])
    assert set(phases) == set(cs.ref_plan(0))
    assert "e2e" not in phases and "launch" not in phases


# ---------------------------------------------------------------------------
# the shared scenes: the bytes the script's builders made before they moved
# ---------------------------------------------------------------------------


def _digest(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, bytes):
            h.update(p)
        else:
            a = np.ascontiguousarray(np.asarray(p))
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


SCENE_DIGESTS = {
    "denseboost_frames": "defc150b245acb9f88305d4c27487754f33bbf4a88b493958ea7eaed7f8fa851",
    "denseboost_frames_full": "b8ac93b7bb995a20b253c1ff94af24598cc12e204d0e72ec69d6f750ac91d88e",
    "wire_frames": "d77bd069cf2bb85b6b14916aad7f916d37c6afc29fbc138d81fa9553e0e21abc",
    "room_scan": "60f2dc17ba9a118ef9d718a8c2353c54dab8d02a856d995fd9028b2a338713a2",
    "room_ticks": "bc7676d71dc03f509e512353ac8687c59f87860e09ffd112ff8e8f4a4e771949",
    "make_revolutions": "649f55ecf06012f3e980fcfb5053cfc6aee7a710debfa052e6e3e2201b86d2b9",
    "host_scans": "8ad0a0d5a84eb571eeafae315c6e39734205cd5c3eafc4283bc344d69ab1e1fc",
    "paced_fleet_ticks": "cc48119313f23f8f5258e545700f611e14d829b4d5b532b61bcbbf184a6469b1",
}


def _scene(name: str, mod) -> str:
    if name == "denseboost_frames":
        return _digest(mod.denseboost_frames(7, 3, 400))
    if name == "denseboost_frames_full":
        return _digest(mod.denseboost_frames(0, 2, 3200))
    if name == "wire_frames":
        return _digest(mod.wire_frames(3, 400))
    if name == "room_scan":
        scans = [mod.room_scan(s, k, 64) for s in range(3) for k in range(4)]
        assert all(r["flag"] is None for r in scans)
        return _digest([r[f] for r in scans for f in ("angle_q14", "dist_q2", "quality")])
    if name == "room_ticks":
        return _digest(mod.room_ticks(3, 64, 4))
    if name == "make_revolutions":
        revs = mod.make_revolutions(5, 3, 400)
        return _digest([r[f] for r in revs for f in ("angle_q14", "dist_q2", "quality", "flag")])
    if name == "host_scans":
        return _digest([r[f] for r in mod.host_scans(3, 400)
                        for f in ("angle_q14", "dist_q2", "quality")])
    ticks = mod.paced_fleet_ticks(mod.wire_frames(2, 400), 5, 3)
    return _digest([repr([(a, [(f.hex(), ts) for f, ts in b]) for a, b in tick]).encode()
                    for tick in ticks])


@pytest.mark.parametrize("name", sorted(SCENE_DIGESTS))
def test_shared_scene_bytes(name):
    assert _scene(name, scenes) == SCENE_DIGESTS[name]


@pytest.mark.parametrize("name", ["denseboost_frames", "make_revolutions"])
def test_the_script_builds_its_scenes_with_the_shared_module(name):
    assert _scene(name, cs) == SCENE_DIGESTS[name]


def test_the_script_takes_the_room_from_the_shared_module():
    ticks, pose = cs.room_fleet_ticks(3, 64, 4)
    assert _digest(ticks) == SCENE_DIGESTS["room_ticks"]
    assert pose is scenes.room_pose


def test_graded_takes_its_scenes_from_the_shared_module():
    for name in ("wire_frames", "paced_fleet_ticks", "host_scans", "room_ticks"):
        assert getattr(gr, name) is getattr(scenes, name)
