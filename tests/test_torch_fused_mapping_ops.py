"""The fused mapping route's ops level: the PyTorch package's super-step
with the carried map against the JAX package's and the host golden route.

The ops-level cases of the JAX package's tests/test_fused_mapping.py
(tests/test_torch_fused_mapping.py holds the service-level ones), at its
geometry, both packages on the CPU from the same seeded bytes: the
T-tick super-step with ``cfg.mapping`` at T = 1, 2, 8 x fleets of 1, 3, 8
x both matcher backends, the single-stream step, and the carried planes
across a decode reset.  Byte-equal throughout; the JAX ``pallas`` matcher
runs in interpret mode, as its own tests run it.
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.filters.chain import config_from_params as jconfig_from_params
from rplidar_ros2_driver_tpu.mapping.mapper import map_config_from_params as jmap_config
from rplidar_ros2_driver_tpu.ops import ingest as ji
from rplidar_ros2_driver_tpu.ops.deskew import deskew_config_from_params as jdeskew_config
from rplidar_ros2_driver_tpu.protocol import timing as jtiming
from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params as tconfig_from_params
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.ops import ingest as ti
from rplidar_ros2_driver_tpu_torch.ops.deskew import deskew_config_from_params as tdeskew_config
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import map_match_step_np
from rplidar_ros2_driver_tpu_torch.protocol import timing as ttiming

from test_torch_fused_mapping import (
    BEAMS,
    DENSE,
    MAP_KEYS,
    _params,
    assert_outputs_equal,
    dense_frames,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _ops_configs(pkg: str, match_backend: str):
    params = _params(pkg, match_backend=match_backend)
    if pkg == "jax":
        fcfg = jconfig_from_params(params, BEAMS, platform="cpu")
        dsk = jdeskew_config(params, BEAMS)
        mcfg = jmap_config(params, BEAMS)
        cfg = ji.fleet_ingest_config_for((DENSE,), jtiming.TimingDesc(), fcfg, max_nodes=1024,
                                         deskew=dsk, mapping=mcfg)
    else:
        fcfg = tconfig_from_params(params, BEAMS, platform="cpu")
        dsk = tdeskew_config(params, BEAMS, platform="cpu")
        mcfg = tmapper.map_config_from_params(params, BEAMS, platform="cpu")
        cfg = ti.fleet_ingest_config_for((DENSE,), ttiming.TimingDesc(), fcfg, max_nodes=1024,
                                         deskew=dsk, mapping=mcfg)
    return cfg, mcfg


def _staged_groups(frames, fleet: int, T: int, run: int = 4):
    """The (T, fleet, run, 84) byte planes and aux planes of every T-tick
    group, idle ticks padding the chunk list to a T multiple."""
    chunks = [frames[i : i + run] for i in range(0, len(frames), run)]
    while len(chunks) % T:
        chunks.append([])
    prev_base = [None] * fleet
    t_clock = [100.0 + 5 * s for s in range(fleet)]
    groups = []
    for g in range(0, len(chunks), T):
        buf = np.zeros((T, fleet, run, 84), np.uint8)
        aux = np.zeros((T, fleet, ti.fleet_aux_len(run)), np.float32)
        for t, ch in enumerate(chunks[g : g + T]):
            m = len(ch)
            for s in range(fleet):
                if not m:
                    continue
                buf[t, s, :m] = np.frombuffer(b"".join(ch), np.uint8).reshape(m, -1)
                stamps = [t_clock[s] + 1.25e-3 * (j + 1) for j in range(m)]
                base = stamps[0]
                aux[t, s, :m] = [x - base for x in stamps]
                aux[t, s, 2 * run] = 0.0 if prev_base[s] is None else prev_base[s] - base
                aux[t, s, 2 * run + 1] = m
                prev_base[s] = base
                t_clock[s] = stamps[-1]
        groups.append((buf, aux))
    return groups


@functools.lru_cache(maxsize=None)
def _jax_reference(fleet: int, match_backend: str) -> tuple:
    """The JAX package's super-step (T = 8, its config-18 depth) with the
    carried map over the fleet's frames: per tick, per stream, the map
    wire, the completed count and the outputs; and the final MapState.
    The super-step is exact against per-tick steps (the JAX package's own
    tests), so one JAX run per (fleet, backend) is the reference for every
    T the port runs."""
    groups = _staged_groups(dense_frames(3, seed=fleet), fleet, 8)
    cfg, _ = _ops_configs("jax", match_backend)
    st = ji.create_fleet_ingest_state(cfg, fleet)
    rows = []
    for buf, aux in groups:
        st, *res = ji.super_fleet_ingest_step(st, jnp.asarray(buf), jnp.asarray(aux), cfg=cfg)
        rows += ji.unpack_super_fleet_ingest_result(res, cfg)
    final = {k: np.asarray(getattr(st, f"map_{k}")) for k in MAP_KEYS}
    return rows, final


@pytest.mark.parametrize("match_backend", ["xla", "pallas"])
@pytest.mark.parametrize("fleet", [1, 3, 8])
@pytest.mark.parametrize("T", [1, 2, 8])
def test_ops_super_tick_mapping_vs_host_golden(T, fleet, match_backend):
    """A T-tick super-step with cfg.mapping lands the JAX package's map
    wires, revolution outputs and final MapState, byte for byte, and the
    same wires as the golden route: T per-tick steps without mapping whose
    reconstructed sweeps feed the NumPy mapper tick by tick."""
    groups = _staged_groups(dense_frames(3, seed=fleet), fleet, T)
    tcfg, _ = _ops_configs("torch", match_backend)
    j_rows, j_final = _jax_reference(fleet, match_backend)

    tst = ti.create_fleet_ingest_state(tcfg, fleet)
    t_rows = []
    for buf, aux in groups:
        tst, *tres = ti.super_fleet_ingest_step(tst, torch.from_numpy(buf), aux, tcfg)
        t_rows += ti.unpack_super_fleet_ingest_result(tres, tcfg)
    # 8 chunks of 4 frames: no pad tick at T = 1, 2 or 8
    assert len(j_rows) == len(t_rows) == 8
    for t, (jr, tr) in enumerate(zip(j_rows, t_rows)):
        for s in range(fleet):
            np.testing.assert_array_equal(tr[s].map_wire, jr[s].map_wire, err_msg=f"t={t} s={s}")
            assert tr[s].map_wire.dtype == np.int32
            assert tr[s].n_completed == jr[s].n_completed
            for k in range(jr[s].n_completed):
                assert_outputs_equal(jr[s].outputs[k], tr[s].outputs[k], f"t={t} s={s} k={k}")
    for k in MAP_KEYS:
        np.testing.assert_array_equal(getattr(tst, f"map_{k}").numpy(), j_final[k], err_msg=k)

    golden, host = _golden_route(T, fleet)
    for t, (tr, hr) in enumerate(zip(t_rows, golden)):
        for s in range(fleet):
            np.testing.assert_array_equal(tr[s].map_wire, hr[s], err_msg=f"golden t={t} s={s}")
    for i in range(fleet):
        np.testing.assert_array_equal(tst.map_log_odds[i].numpy(), host[i]["log_odds"])
        np.testing.assert_array_equal(tst.map_pose[i].numpy(), host[i]["pose"])


@functools.lru_cache(maxsize=None)
def _golden_route(T: int, fleet: int) -> tuple:
    """The golden route at one (T, fleet): the same T-grouped staging
    through the step without mapping, its reconstructed sweeps into the
    NumPy mapper tick by tick.  Per tick, per stream, the map wire the
    carried route must emit; and the final host MapStates.  (Neither the
    step without mapping nor the NumPy mapper reads the match backend.)"""
    tcfg, mcfg = _ops_configs("torch", "xla")
    plain = dataclasses.replace(tcfg, mapping=None)
    st = ti.create_fleet_ingest_state(plain, fleet)
    g = mcfg.grid
    host = [{"log_odds": np.zeros((g, g), np.int32), "pose": np.zeros(3, np.int32),
             "origin_xy": np.zeros(2, np.float32), "revision": np.zeros((), np.int32)}
            for _ in range(fleet)]
    golden = []
    for buf, aux in _staged_groups(dense_frames(3, seed=fleet), fleet, T):
        st, *res = ti.super_fleet_ingest_step(st, torch.from_numpy(buf), aux, plain)
        for tick_rows in ti.unpack_super_fleet_ingest_result(res, plain):
            row = []
            for i, r in enumerate(tick_rows):
                live = int(r.recon_pushed)
                if live:
                    host[i], w5 = map_match_step_np(host[i], r.recon_pts[:, :2].astype(np.float32),
                                                    r.recon_pts[:, 2] > 0.5, 1, mcfg)
                else:
                    w5 = np.concatenate([host[i]["pose"], [0, 0]]).astype(np.int32)
                row.append(np.concatenate([[live], w5, [host[i]["revision"]]]).astype(np.int32))
            golden.append(row)
    return golden, host


def test_single_stream_step_carries_the_map():
    """The single-stream step with cfg.mapping: map wires and the carried
    MapState equal the JAX package's single-stream step's."""
    jfleet, _ = _ops_configs("jax", "xla")
    tfleet, _ = _ops_configs("torch", "xla")
    fields = ("max_nodes", "max_revs", "deskew", "mapping")
    jcfg = ji.ingest_config_for(DENSE, jtiming.TimingDesc(), jfleet.filter,
                                **{k: getattr(jfleet, k) for k in fields})
    tcfg = ti.ingest_config_for(DENSE, ttiming.TimingDesc(), tfleet.filter,
                                **{k: getattr(tfleet, k) for k in fields})
    jst, tst = ji.create_ingest_state(jcfg), ti.create_ingest_state(tcfg)
    groups = _staged_groups(dense_frames(3, seed=7), 1, 1)
    live = 0
    for buf, aux in groups:
        m = int(aux[0, 0, 9])
        # the single-stream aux layout: rx offsets, CRC verdicts, then
        # [prev base - this base, m]
        a = np.zeros(2 * 4 + 2, np.float32)
        a[:4] = aux[0, 0, :4]
        a[-2], a[-1] = aux[0, 0, 8], m
        jst, *jres = ji.fused_ingest_step(jst, jnp.asarray(buf[0, 0]), jnp.asarray(a), cfg=jcfg)
        tst, *tres = ti.fused_ingest_step(tst, torch.from_numpy(buf[0, 0]), a, tcfg)
        jr, tr = ji.unpack_ingest_result(jres, jcfg), ti.unpack_ingest_result(tres, tcfg)
        np.testing.assert_array_equal(tr.map_wire, jr.map_wire)
        live += int(tr.map_wire[0])
    assert live > 0
    for k in MAP_KEYS:
        np.testing.assert_array_equal(getattr(tst, f"map_{k}").numpy(),
                                      np.asarray(getattr(jst, f"map_{k}")), err_msg=k)


def test_format_switch_reset_keeps_the_carried_map():
    """The decode reset of a format switch clears the decode planes and
    the sub-sweep ring, never the carried map planes."""
    tcfg, _ = _ops_configs("torch", "xla")
    st = ti.create_fleet_ingest_state(tcfg, 2)
    st.map_log_odds.fill_(7)
    st.map_pose.fill_(3)
    st.map_revision.fill_(5)
    out = ti._reset_stream_decode(st, torch.tensor([True, False]))
    assert out.map_log_odds is st.map_log_odds and out.map_pose is st.map_pose
    assert int(out.map_log_odds.min()) == 7 and int(out.map_revision.min()) == 5
    assert int(out.recon_pos[0]) == 0
