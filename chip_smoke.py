#!/usr/bin/env python3
"""Smoke run of the PyTorch package on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N] [--revs N] [--trace-dir DIR]
    python3 chip_smoke.py --phase NAME       # build, then one phase alone
    python3 chip_smoke.py --mesh-check N     # N cards: only the NCCL mesh check
    python3 chip_smoke.py --pod-cards N      # N cards: the pod and the meshes over them

Run from the root of a checkout.  Every phase's JSON line carries
``seconds``, its wall time so far (a phase run as a timed pass and a
profiled half adds both), and ``cpu_seconds``, the part of it this process
spent on CPU references: computing one, or waiting for a worker's; and
``refs_pending``, the planned references no worker had finished when the
line was printed (the phase's own figures were taken beside them).  The
CPU references the card is held to (the phases' CPU arms and host
references, :func:`ref_plan`) are computed once a run, each keyed by its
function and its arguments; after the e2e phase, spawned processes
without the card compute them on cores of their own (the upper half of
the host's, at most REF_WORKERS, at the lowest priority) while this
process drives the card, and the ``references`` line gives their cores
and each reference's seconds in its worker.  The default
run's order (:func:`_default_run`): device, build, launch, e2e, then
checkpoints and tooling (no CPU reference: the workers start meanwhile),
fused_mapping, failover, scheduled, scenarios, graded, fleet, mesh_blocks,
the profiled halves, kernels, chain, profile, ab, node, replay,
mapkernels, mapping, replay_map, loop, deskew_kernels, replay_fused,
references, before, kernels.  The phases, each printing one JSON line:

  1. device   — the card (nvidia-smi name and power limit), torch version,
                compute capability (must be 9.0);
  2. build    — nvcc builds every CUDA kernel of the package from csrc/;
  3. launch   — the slim launch path's cost per call (B1, B4 at their
                path's shapes beside their library calls, and B5 beside
                B4, in alternating rounds: events ms and host µs), before
                any profiler session in the process;
  4. e2e      — the live wire path (bench.py config 6 through the node):
                the package's simulator at 800 DenseBoost frames/s (3200
                points a turn) over loopback TCP -> the native channel
                and transceiver -> RealLidarDriver -> RPlidarNode
                (launch, pipelined publish, W=64, 2048 beams, 256x256 grid
                at 0.25 m) in three arms of 6 s: the host ingest (the
                chain, B1), the fused ingest (B1) and the fused ingest
                with de-skew (B1, B4, B5); each arm records its stream
                with start_recording and holds every published revolution
                bit-equal (ranges, intensities, voxel grid, points) to the
                CPU replay of the recording, and prints scans/s, publish
                p50/p99 ms from the end of revolution N, the host arm's
                collect wait and upload/dispatch, the fused arms' frames
                per dispatch, dispatches/s and drops, the kernels'
                launches, the FSM states and each thread's CPU share;
                it runs on the native transceiver or fails;
  5. fused_mapping — this slice's path (ROADMAP A.7b): bench.py config 18
                (bench_fused_mapping) at full width — 4 streams,
                DenseBoost 3200 points a revolution, 12 revolutions, 16
                frames a tick, W=64, 2048 beams, 256x256 at 0.25 m, de-skew
                over 4 sub-sweeps (B4, B5), a 128x128 map at 0.1 m — in
                drains of T = 8 ticks (one warm, the arms alternating which
                goes first): the fused arm (the map carried in the fused
                ingest state: one step a drain, B6/B7/B8 once a tick for
                the fleet, no mapper step) against the host route (one
                ingest step a tick, the fused FleetMapper once a mapping
                tick), every revolution's ranges, the drain-boundary poses
                and the final maps equal between the arms and to the CPU
                run of each arm; B1 = revolutions, B4 = ticks + ticks
                completing revolutions, B5 = the latter; then the loop
                engine on both routes over 40 ticks (installs, checks and
                re-anchored poses equal) and a quarantine cycle (stream 1's
                frames 160-480 corrupted, seed 3, under the health
                supervisor: the snapshot carries ingest.map_*, every
                output, pose, transition and map equal to the CPU service
                under the same chaos); drains/s and ticks/s of each arm.
                Its profiled half runs after the fleet phase: B6/B7/B8 at
                this path's tick (N = 4, G = 128) against their plain
                versions, and device operations a drain and the idle share
                of each arm; its line carries the card's name and limit;
 5b. failover — the failover pod (ROADMAP A.10a): bench.py config 15
                (bench_failover) at full geometry — 8 streams over 4
                shards of 3 lanes (ElasticFleetService, one card a
                shard: on one card every shard on cuda:0), W=64, 2048
                beams, 256x256 at 0.25 m, one 3200-point revolution a
                stream a tick, the fused
                FleetMapper on a 256x256 map at 0.05 m, snapshots every 4
                ticks, shard 1 killed over ticks 10-12 on a fake clock of
                0.1 s a tick — as a baseline pod and a chaos pod advancing
                tick-paired in alternating order, the 30 post-warm ticks
                under utils/guards.steady_state (nothing built, no new
                device segment, no undeclared synchronisation); the chaos
                pod's outputs, events, replay plan and final map rows
                equal to its CPU run, the survivors' outputs to the
                baseline pod's, 1 evacuation, 1 re-admission, 4
                migrations, every shard UP, one dispatch a tick on every
                surviving shard, every loss a chaos one; then the carried
                map arm (config 18's route over 2 shards, killed after its
                second snapshot: the map rows ride the v3 ingest snapshot,
                the victims' revisions advance after migrating, equal to
                the CPU run; B4/B5 launched); then the sentinels' negative
                controls on the card; ticks/s of both pods, the paired-
                median and total tick ratios, the evacuation's snapshot
                pull, restore scatter and first tick ms.  Its profiled
                half (device operations and busy ms a pod tick, idle
                share) runs after the fleet phase;
 5c. scheduled — scheduled serving (ROADMAP A.10b): bench.py configs 19-22
                at full geometry (W=64, 2048 beams, 256x256 at 0.25 m,
                3200-point DenseBoost revolutions), two ElasticFleetService
                pods a config (one card a shard: on one card every shard
                on cuda:0) offered the same wall ticks and drained
                tick-paired in alternating order, every wall tick after
                the warm ones under
                utils/guards.steady_state: config 19 (8 streams over 4
                shards, the reconnect-storm trace, admission cap 8, shard 1
                killed near the end) rung 1 only against the ladder (1, 2,
                4, 8); config 20 (the storm, an occupancy collapse,
                recovery) the single-buffered static bucket against the
                double buffer with the bucket ladder (4, 16); config 21 (8
                streams over 4 shards on 2 hosts: skewed bursts, idle,
                resume) the static pod against work stealing and the
                autoscaler; config 22 (6 streams over 3 shards, the fused
                FleetMapper on 256x256 at 0.05 m) per-stream map pulls
                against the pod world map.  Each config's arms byte-equal
                to each other and each arm to its CPU run over the first 12
                wall ticks, and the bench's identities: per-rung counters
                sum to the dispatch count, the static arm at rung 1 only,
                the ladder reaching its top rung with fewer dispatches,
                sheds equal to a shadow admission, staging overlap with
                the double buffer only, bucket switches both ways, a seeded
                latency model, steals and a whole scale cycle, the world's
                merges, evictions and tiles with no added dispatch.  Pod
                ticks/s, drain p50/p99 and dispatches a pod drain of each
                arm, reads of config 22; one profiled drain of each config
                (device operations, busy ms, idle share) after the fleet
                phase;
 5d. checkpoints — the sharded checkpoints
                (utils/checkpoint_sharded.py, torch.distributed.checkpoint):
                config 10's ShardedFilterService at full geometry (8
                streams, W=64, 2048 beams, 256x256 at 0.25 m, 20 ticks of
                seeded 3200-point revolutions) with the sort (B1) and inc
                (B2) medians, and config 12's fused FleetMapper (4 streams,
                256x256 at 0.05 m, 2048 beams, 20 ticks of the room; B6-B8):
                each saved after tick 10, loaded into a fresh one (the
                restored state byte-equal to the saved one) and both
                continued byte-equal to the end; then a checkpoint of
                another window (another grid for the mapper) refused with
                the live state untouched, an absent one refused, the .old
                fallback of the rotation's crash window, and an overwrite
                in place keeping the newest; save and load ms and the bytes
                on disk;
 5e. scenarios — bench.py config 23 (bench_scenarios) at its full geometry
                through tools/scenario_matrix: 128x128 at 0.05 m, 384 beams,
                seed 20260807, 3 scenes x 2 chaos columns x fleets (2, 4),
                24 revolutions (128 on the loop ring), the loop probes 64 on
                4 streams; each cell's scenes built once and fed to the
                host matcher and to one fused FleetMapper fleet on the card
                (B6-B8), held equal pose for pose and map for map in all 12
                cells; the de-skew probe's B4/B5 estimate equal to the host
                estimator; each loop probe's fused engine on the card, under
                the whole guards.steady_state, equal to the same probe on
                the CPU; the five claims asserted;
                each cell's end-pose error and map F1 printed beside the
                committed JAX CPU figures (artifacts/scenario_matrix_cpu.json,
                a recorded comparison, not a gate);
 5f. tooling — the CLI's doctor on the card (every row PASS but the
                serial port's WARN, the torch backend probe on cuda:0),
                view --pgm, udev (the JAX package's text, by digest); the
                composable-node container's two dummy nodes publishing over
                the intra-process bus with the chain on the card; compat's
                force scan against the simulator; the four examples/torch/
                scripts on the card in process at the JAX suite's lengths
                (multihost_fleet's two workers over gloo on the one card);
 5g. graded   — bench.py's remaining graded configurations through
                rplidar_ros2_driver_tpu_torch/tools/graded.py at their full
                widths (depth cut as its GEOMETRY["full"] lists), each on
                the card and on the CPU with every output byte-equal and
                every count equal: config 1 (to_laserscan on 360-node
                batches), configs 2-3 (the chain at W = 1, median and voxel
                off, 3200 and 920 points: no B1/B2 launch), config 4 (800
                points, W = 16, voxel off: B1 a revolution, and B2 on the
                inc arm), config 9 (one DenseBoost byte stream through the
                host ingest and FusedIngest: one dispatch a frame run, the
                arms byte-equal, B1 a revolution on each), config 11 (a
                backlog per tick against super-steps of T = 8: ticks
                against ceil(ticks/8) dispatches, two staged transfers a
                dispatch, the same revolutions), config 13 (K = 0, 1, 3 of
                8 streams fed chaos_ticks under the health supervisor, under
                the whole guards.steady_state: one dispatch a tick, the
                faulty streams quarantined and rejoined, the healthy
                streams byte-identical across K), config 16 (the
                reconstruct arm against the plain fused fleet, each with a
                host-reference FleetMapper, under guards.steady_state: the
                same dispatches, >= 2 mapper updates a revolution, the
                zero-motion identity, stream 0 equal to DeskewHostTwin + a
                golden chain; B4/B5 on the reconstruct arm only) and config
                12's room on a 1024x1024 map at 0.05 m (B6/B7/B8 a tick,
                update_plan's remote route and coarse_plan printed); one
                line a configuration with its rates beside the card's name
                and power limit.  Its profiled half (B6/B7/B8 at the 1024^2
                tick against their plain versions, events and device ms,
                bounds) runs after the fleet phase;
  6. fleet    — the mesh and the sharded fleet service (ROADMAP A.7a):
                (a) config 10 (bench.py bench_fleet_ingest)
                at full geometry — W=64, 2048 beams, 256x256 at 0.25 m,
                3200-point DenseBoost frames, 20 revolutions — through
                both ShardedFilterService.submit_bytes arms at N = 2 and 8
                (the host arm's lockstep tick: one B1 launch a tick for
                the whole fleet; the fused arm: B1 once per revolution),
                plus at N = 2 the inc median (B2) and the fused arm with
                de-skew (B4, B5), every published output equal to the CPU
                service's same arm; ticks/s, p50/p99 ms and, profiled
                last, device operations a tick; (b) config 8 (bench.py
                bench_fleet): replay_fleet of 4 streams x 8192 revolutions
                cycled from 32 seeded ones, chunk 256 — one B3 launch a
                chunk over the 4 streams' stripes side by side —, each
                stream equal to its one-stream replay on the card and the
                first chunk to the CPU; (c) the service with attach_mapper,
                attach_loop_closure and attach_world_map on config 12's
                room (4 streams, 24 ticks; B1, B6, B7, B8): poses, loop
                statuses, corrected poses and the world accumulation
                byte-equal to the CPU service; (d) the SLAM service's and
                the fused engine's snapshots at tick 10 restored into
                fresh ones and continued, equal to the uninterrupted runs;
                (e) two gloo processes on cuda:0 (a (1, 2) mesh: step and
                scan with psum and ring, each equal to one process); then
                B1 at (64, N*2048) and B3 at (64, 256, 4*2048) timed with
                their bounds;
 6b. mesh_blocks — the mesh held in one process (parallel/sharding.Mesh
                over several blocks): a (2, 2) mesh whose four blocks all
                sit on cuda:0 (make_mesh(devices=[cuda:0] * 4)); config 8
                at full width (8 streams, W=64, 2048 beams, 256x256 at
                0.25 m, 3200 points, 2 chunks of 256 scans) with the sort
                (B3 once a block a chunk) and inc medians, and config 10's
                host arm at N = 8 for 16 ticks (sort with psum and with
                ring, B1 once a block a dispatched tick; inc, B2), the
                ticks after two under guards.steady_state; every chunk's
                ranges and state, every published output and the final
                snapshot byte-equal to the (1, 1) card mesh and to the CPU
                (config 8's first chunk);
  7. kernels  — each kernel (B1, B2, B3) against its plain PyTorch version
                on the card (exact equality; +inf equals +inf; B1 also at
                W = 1, 31, 32, 33, 96, 1536 and 1537 — the last past its
                shared-memory staging —, B off the block's 8 columns, the
                fleet's stripes (64, 2*2048) and (64, 8*2048), all
                +inf, all equal, heavy ties and an offset view; B2 over
                successive ring steps and one-step edge fixtures at W = 1,
                31, 32, 33, 64, 96 and 1533 to 1537 (the last staged W
                and the four past it), ragged B, old or new +inf,
                all-+inf and all-equal columns, old absent and an offset
                view; B3 over the test grid, the replay's stripe, the
                fleet replay's (W, K, B) = (64, 256, 4*2048) and its
                launch plans' edges: K = 1, W far above a block's rows,
                W = 1, B = 257 and 2050, the largest W staged with 4, 2
                and 1 warps, W = 191 and 1536 unstaged, all-+inf and
                all-equal stripes, an offset view), then timed beside the
                plain version and a library yardstick (B1: events ms,
                device ms and host µs per call; B3 also its K=7 tail);
  8. chain    — the main path: ScanFilterChain at the headline geometry
                (W=64, 2048 beams, 256x256 grid at 0.25 m and 0.1 m, wire
                capacity 4096) over seeded 3200-point revolutions, through
                process_raw and process_raw_pipelined with each kernel
                backend, every output held equal to the package's own CPU
                chain; the launch counts are read around this phase;
  9. profile  — where a revolution's time goes (torch.profiler);
 10. ab       — B1 against B2 end to end, in alternating order;
 11. node     — launch_lifecycle in dummy mode on the card (filter chain,
                raw and map_enable paths), deactivate/activate, shutdown;
 12. replay   — the offline replay path at config 7's geometry (W=64, 2048
                beams, 256x256 grid at 0.25 m, chunk 512, capacity 4096): a
                seeded 3200-point DenseBoost capture written with the
                package's FrameRecorder, decoded on the card, run through the
                fused K-scan chain (kernel B3), held equal to the package's
                CPU replay and to K streaming steps on the card; its launch
                counts are read around the card's replay;
 13. mapkernels — the matcher kernels B6, B7, B8 against their plain
                PyTorch versions on the card (exact) over edge fixtures,
                grids 8/24/44/64/92/256/1024 and fleets of 1, 3 and 4 streams,
                B6/B7's routes (cluster splits with B off the per-block
                share and B below the cluster, r and w off the register
                path, the int16 pooled map at its edge, the direct
                route), B8's stripe edges (endpoints and samples on the
                first and last rows of its blocks' stripes, off the map on
                each side, hit and free in one cell, free_samples 0, 1, 3,
                4, a map saturated at ±clamp_q) on both of its routes
                and every cluster size up to 16 (G = 9 and 18 put stripe
                ends off the 16-byte words), offset views, and the loop
                check's shapes (the derived match config: quant_shift 0,
                w = 4, T = 17; N = 8, G = 128, B = 1024 and N = 2, G = 256,
                B = 2048), then timed at config 12's fleet tick (N=4,
                G=256, B=2048) and at the map replay's one-stream tick
                (N=1);
 14. mapping  — config 12 (bench.py bench_mapping): 4 streams, 256x256 map
                at 0.05 m, 2048 beams, map_match_window 0.4; one warm tick,
                then 20 ticks of the drifting-room scene through FleetMapper
                fused on the card (B6/B7/B8), every pose and snapshot key held
                equal to the package's host reference and its CPU torch arm,
                the drift tracked; its launch counts are read around the 20
                ticks; then a profiled pass;
 15. replay_map — the config-7 capture through replay_with_map on the card
                (the chain with B3, then the fused mapper with B6/B7/B8), held
                equal to the CPU replay with the host reference mapper;
 16. loop     — config 17 (bench.py bench_loop_close) at its full geometry:
                4 streams, 128x128 map at 0.05 m, 1024 beams, 48
                revolutions of the return-to-start trace with SUB/4 of
                drift a revolution (tools/loop_drift.py), submaps every 4,
                checks every 2, 16 submaps, 2 candidates, weight 8, 32
                loop constraints, 256 sweeps; three arms on identical
                inputs: off, host (numpy) and fused on the card, the
                fused arm under the whole guards.steady_state, then the
                fused arm again without the guard, byte-equal to it (the
                guard's cost; each arm's garbage-collector pauses). (a) host
                and fused wires, corrected poses and final LoopState
                byte-equal; (b) corrected end error <= 2 cells, the
                baseline's > 4; (c) one check call and one B6 and one B7
                launch per check tick; (d) a WorldMap on the engine's
                on_install tap whose accumulation on the card equals
                fuse_planes_np of its members and whose publication equals
                publish_tiles of that sum; (e) the node with map_enable +
                loop_enable at its default widths on the card, a
                checkpoint with loop.* keys saved and restored; (f)
                replay_with_loop_closure over 64 revolutions of the
                config-7 capture on the card, equal to the CPU host
                replay. Prints the check's wall ms (p50/p99) guarded and
                not, B6/B7 at the
                check's shape (N = 8) and the solver's share of a check;
 17. deskew_kernels — the de-skew kernels B4, B5 against their plain
                PyTorch versions on the card (exact) over the JAX suite's
                four geometries, degenerate inputs, the featureless tie and
                the fused ingest's shapes (B4 also at nbeams 1 and 8192,
                beams out of range, rows off the 16-byte loads, offset
                views, no nodes, 16 x 4096 rows; B5 also at D = 1, 3, 37,
                100, 250 and 6144, shifts of 0, ±(D-1), ±D, beyond and the
                int32 extremes, C = 40 and 100, one row, an all-EMPTY row,
                offset views, counts at min_valid and one short), then
                timed there (B4 beside one scatter_reduce_ "amin" call,
                host µs too);
 18. replay_fused — the config-7 capture through replay_raw_fused (the
                fused device ingest: 64 frames per tick, T=8, max_revs 8):
                de-skew off held equal to the card's host-path replay and
                the CPU fused replay; de-skew on (B4/B5) held equal to the
                CPU fused replay and to DeskewHostTwin + the CPU chain,
                with a nonzero motion estimate; B1/B4/B5 launches counted
                around the card's runs; host syncs per tick and one
                profiled super-step per arm; the CLI's replay --fused line;
 19. before   — every kernel's figures before its redesign, constants
                copied from PERF.md (not measured in this run);
 20. kernels  — one line listing every kernel with its launches and the
                times measured in this run; B1, B4 and B5 also carry
                host_us, B3 its plan and K=7 tail, B6, B7 and B8 their
                times at the map replay's shape, B6 and B7 theirs at the
                loop check's (``loop_close_shape``), each redesigned
                kernel whether each of its goals was met, every kernel its
                launches on the fleet phase's paths (``fleet_launches``)
                and on config 18's (``fused_mapping_launches``), the
                failover phase's (``failover_launches``), the
                scheduled phase's (``scheduled_launches``) and the
                checkpoints, scenarios and tooling phases'
                (``checkpoints_launches``, ``scenarios_launches``,
                ``tooling_launches``), the graded phase's
                (``graded_launches``), B1, B2 and B3 theirs on the
                mesh_blocks phase's (``mesh_blocks_launches``), B6, B7 and
                B8 theirs at the 1024^2 mapper's tick (``graded_map1024_tick``), B1 and
                B3 their times at the fleet's widths (``fleet_shapes``),
                B6, B7 and B8 theirs at config 18's tick
                (``fused_mapping_tick``).

``--phase NAME`` (e2e, fused_mapping, failover, scheduled, checkpoints,
scenarios, tooling, graded, fleet, mesh_blocks, loop — the last after the
replay phase
that makes its capture) builds the kernels and runs that phase alone, its
profiled half included, then the same last two lines: a long phase's line
then fits the end of the output.  Given more than once, the phases run in
the order given in one process.

``--mesh-check N`` runs only the fleet's multi-process check on N cards:
N NCCL processes, rank r on cuda:r, on the (1, N) and (2, N/2) meshes,
each process's step and scan (psum and ring) held to its own one-process
run, and the (1, N) mesh's state saved as a sharded checkpoint and
restored onto the (2, N/2) mesh and whole onto one process, bit-equal; it
prints the card's name and power limit last.

``--pod-cards N`` runs only the N cards in one process (phase_pod_cards):
each pair's peer access; every kernel bit-equal to its plain version on
each card; configs 15 and 19-22 as the failover and scheduled phases run
them, once over the cards (the pod's groups, parallel/sharding.pod_groups:
one card a shard for 3-4 shards, the carried arm's 2 shards on cards 0-1
and 2-3, its engines on each group's lead card) and once with every shard
on cuda:0, the two byte-equal (outputs, events, replay plans, stored
snapshots, map rows, logs) and equal to the one CPU run, each lead card
launching its path's kernels; both layouts' ticks/s, p50/p99 and per-card
busy ms and idle share side by side; a shard's checkpoint saved on one
card and loaded onto another.  Then the one-process meshes over the cards
(phase_pod_cards_mesh): config 8 and config 10's host arm as mesh_blocks
runs them over (2, N/2) and (1, N) meshes of the cards, byte-equal to the
(1, 1) card run and the CPU, each card launching its blocks' kernels and
no other card any; config 15's traffic on pods of 2 shards of N/2 cards
(shard 1 killed over ticks 10-12) and 1 shard of N cards (each shard on
its group's lead card, the group's other cards without work), each equal
to the same pod on cuda:0 under the guard; a (2, N/2)
mesh's checkpoint loaded onto a (1, 1) card mesh and continued
byte-equal; each layout's profiled config-8 chunk and config-10 tick
(per-card busy ms, idle share, scans/s) beside the (1, 1) card's.  It shows the pod only the first N cards
(CUDA_VISIBLE_DEVICES, when unset) and exits non-zero with fewer; then
the card's name and power limit and the usual last line.

The wrapper's host time split piece by piece is
rplidar_ros2_driver_tpu_torch/tools/launch_cost.py.  Then the card's name
and power limit, then {"ok": true, "device": ...}.
Any mismatch or error exits non-zero.  Without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# H100 SXM int32: 64 INT32 lanes per SM against 128 FP32 lanes (Hopper
# white paper), so half the float32 rate, a multiply-add counted as two
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
GEOMETRY = dict(window=64, beams=2048, grid=256, capacity=4096, points=3200)
# bench.py GRADED[7]: the offline replay of a DenseBoost capture through
# the fused K-scan chain; 520 turns give a full 512-scan chunk and a
# ragged tail chunk shorter than the window
REPLAY = dict(window=64, beams=2048, grid=256, cell_m=0.25, chunk=512, capacity=4096,
              points=3200, revs=520)
# bench.py GRADED[6] (bench_e2e) through the node: the simulator at 1x pace
# (800 DenseBoost frames/s = 3200 points a turn at 10 Hz) streaming over
# loopback TCP for ``seconds`` an arm after the first publish; the chain at
# config 6's widths (the node's wire capacity is its own, 8192 nodes)
E2E = dict(points=3200, frame_rate_hz=800.0, seconds=6.0, window=64, beams=2048, grid=256,
           cell_m=0.25, min_scans=30)
# bench.py GRADED[12] (bench_mapping): the SLAM front-end fleet tick
MAPPING = dict(streams=4, grid=256, cell_m=0.05, beams=2048, window_m=0.4, ticks=20)
# bench.py GRADED[17] (bench_loop_close) at its full geometry: the SLAM
# back-end on the return-to-start drift trace (SUB/4 of drift a revolution),
# plus the config-7 replay prefix run with loop_enable
LOOP = dict(grid=128, cell_m=0.05, beams=1024, streams=4, revs=48, submap_revs=4, check_revs=2,
            max_submaps=16, candidates=2, weight=8, constraints=32, iters=256, replay_revs=64)
# replay_raw_fused's defaults: the config-7 capture through the fused
# device ingest, 64 frames per tick, T=8 ticks per super-step
FUSED = dict(frames_per_tick=64, super_ticks=8, max_revs=8)
# the fleet (ROADMAP A.7a): bench.py GRADED[10] (bench_fleet_ingest) at its
# full geometry — W=64, 2048 beams, 256x256 at 0.25 m, 3200-point
# DenseBoost frames, 20 revolutions, fleets of 2 and 8 —, GRADED[8]
# (bench_fleet: 4 streams, chunk 256, 8192 revolutions each cycled from 32
# seeded ones), config 12's room through the service's SLAM seams (4
# streams, 24 ticks, filter window 4 so the poses follow the drift), the
# snapshot tick, and the two-process gloo mesh's streams and ticks
FLEET = dict(window=64, beams=2048, grid=256, cell_m=0.25, points=3200, revs=20, capacity=4096,
             fleets=(2, 8), seed=21, replay_streams=4, replay_chunk=256, replay_revs=8192,
             replay_seed_revs=32, slam_streams=4, slam_ticks=24, slam_window=4,
             snapshot_tick=10, mp_streams=4, mp_ticks=8, mp_timeout_s=300)
# the map carried in the fused ingest state (ROADMAP A.7b): bench.py
# GRADED[18] (bench_fused_mapping, the non-smoke branch) at its full
# width — 4 streams, DenseBoost 3200 points a revolution, 12 revolutions
# (cut from 24: the CPU arms' drains were ~100 s of the script), 16
# frames a tick, drains of T = 8 ticks (one warm), W=64,
# 2048 beams, 256x256 at 0.25 m, capacity 4096, de-skew over 4 sub-sweeps
# with 128 profile beams and shift window 4, a 128x128 map at 0.1 m —; the
# loop leg with tests/test_fused_mapping.py's loop settings over its first
# ticks; the quarantine cycle: stream 1's frames 160-480 corrupted (seed 3)
# under the health supervisor, 60 ticks
FUSED_MAPPING = dict(window=64, beams=2048, grid=256, cell_m=0.25, points=3200, revs=12,
                     capacity=4096, streams=4, run=16, T=8, warm=1, map_grid=128, map_cell_m=0.1,
                     recon_window=4, profile_beams=128, shift_window=4, loop_ticks=40,
                     chaos_ticks=60, chaos_frames=(160, 480), profile_groups=3)
# the failover pod (ROADMAP A.10a): bench.py GRADED[15] (bench_failover, the
# non-smoke branch) at its full geometry — 8 streams over 4 shards, lanes
# auto (3), W=64, 2048 beams, 256x256 at 0.25 m, capacity 4096, DenseBoost
# 3200 points, 32 revolutions at one revolution (80 frames) a stream a tick,
# buckets (80,), the map on (the fused FleetMapper, 256x256 at 0.05 m, match
# window 0.4 m), snapshots every 4 ticks, backoff 0.45 s without jitter,
# probation 2, a fake clock of 0.1 s a tick, shard 1 killed over ticks
# 10-12, 2 warm ticks; the carried-map arm: config 18's geometry
# (FUSED_MAPPING, one tick a dispatch) over 2 shards, shard 1 killed over
# ticks 9-11 (after the snapshots at ticks 3 and 7)
FAILOVER = dict(streams=8, shards=4, window=64, beams=2048, grid=256, cell_m=0.25, points=3200,
                revs=32, capacity=4096, map_grid=256, map_cell_m=0.05, match_window_m=0.4,
                snapshot_ticks=4, backoff_s=0.45, probation=2, kill=(1, 10, 12), warm=2, dt=0.1,
                carried_shards=2, carried_revs=6, carried_kill=(1, 9, 11), profile_ticks=6)
# bench.py configs 19-22 (the scheduled phase) at full geometry; the CPU
# runs they are held to are cut in length only, to cpu_wall_ticks
SCHEDULED = {
    "window": 64, "beams": 2048, "grid": 256, "cell_m": 0.25, "points": 3200, "capacity": 4096,
    "snapshot_ticks": 4, "dt": 0.1, "cpu_wall_ticks": {19: 12, 20: 12, 21: 12, 22: 24},
    19: dict(streams=8, shards=4, run=16, revs=16, rungs=(1, 2, 4, 8), cap=8, stall_period=9,
             stall_frames=6, storm_len=10, warm=2),
    20: dict(streams=8, shards=4, run=16, rungs=(1, 2, 4, 8), cap=8, stall_period=9,
             stall_frames=6, storm_len=10, ticks_a=20, collapse_len=10, recovery_len=12,
             warm=2),
    21: dict(streams=8, shards=4, hosts=2, run=16, rungs=(1, 2, 4), cap=10, burst=4,
             skew_len=10, idle_len=12, resume_len=18, warm=2),
    22: dict(streams=6, shards=3, run=8, map_grid=256, map_cell_m=0.05, world_cap=8,
             merge_revs=1, publish_ticks=4, tile_cells=8, wall_len=40, warm=4),
}
# the mesh held in one process over several blocks (parallel/sharding.Mesh):
# config 8 (bench.py GRADED[8], bench_fleet) at full width — 8 streams, W=64,
# 2048 beams, 256x256 at 0.25 m, 3200-point revolutions cycled from 32 seeded
# ones, 2 chunks of 256 scans — and config 10's host arm at N = 8 for 16
# ticks; a (2, 2) mesh of four blocks on cuda:0 in the default run, (2, 2)
# and (1, 4) meshes of cards 0-3 with --pod-cards 4 (and the (2, 2) mesh's
# checkpoint, saved after tick 8, loaded onto a (1, 1) card mesh); the
# fused byte ingest over the meshes' stream rows (each row's streams on its
# lead block): config 10's fused arm at N = 8 (6 ticks, 2 warm) and config
# 18's carried-map route (FUSED_MAPPING: 4 streams, drains of T = 8, 2
# drains, 1 warm; the scheduled drains take 3), over the (2, 2) mesh on cuda:0 in the default run and
# over (2, 2) and (4, 1) meshes of cards 0-3 with --pod-cards 4, where the
# (2, 2) carried route also runs the quarantine cycle on stream 2 (row 1;
# 60 ticks) and scheduled drains at rungs (1, 2, 8)
MESH_BLOCKS = dict(streams=8, chunk=256, chunks=2, seed_revs=32, ticks=16, ckpt_save=8,
                   fused_ticks=6, carried_groups=2, carried_chaos_ticks=60,
                   sched_rungs=(1, 2, 8), profile_ticks=4)
# the sharded checkpoints (utils/checkpoint_sharded.py): config 10's service
# (FLEET's widths, N = 8) over 20 ticks of seeded 3200-point revolutions,
# saved after tick 10; config 12's fused mapper (MAPPING) saved after its
# tick 10 of 20
CHECKPOINTS = dict(streams=8, ticks=20, save_tick=10, map_save_tick=10, seed=15)
# the doctor's rows, in the JAX package's order with the torch backend in
# place of the JAX one
DOCTOR_ROWS = ["python deps", "native I/O library", "torch backend",
               "loopback protocol round-trip", "serial port"]
# sha256 of the JAX package's udev rules text (tools/udev.udev_rules_text();
# tests/test_torch_tooling.py holds this digest to the JAX package's text)
UDEV_SHA256 = "69a18bf3b9d0550da97d45dc3cfbbcfd228a43182b33f5d5969c4cca8e876c09"
# the four examples/torch/ scripts at the lengths of the JAX suite's
# tests/test_examples.py, and a line each must print
EXAMPLES = (
    ("single_lidar.py", ["--seconds", "3"], "resumed: restore=True"),
    ("fleet_gateway.py", ["--ticks", "3"],
     "sharded checkpoint restore into a fresh service: ok (next tick equal: True)"),
    ("record_replay.py", ["--seconds", "2"], "chain replay: per-rev range images"),
    ("multihost_fleet.py", ["--ticks", "2"], "proc 1: done"),
)
# B1's and B4's figures before their redesign, constants copied from
# PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700.00 W) and printed on a
# line of their own, never in the kernels line: B1 as first written (commit
# f6c749c), B4 as first written (commit aeedd51); the B4 profile_* figures
# are at the profiles' shape
BEFORE = {
    "temporal_median": {"commit": "f6c749c", "run": "chip run 4 of that commit",
                        "ms": 0.0254, "device_ms": 0.0121, "library_ms": 0.0180},
    "beam_min": {"commit": "aeedd51", "run": "chip run 3 of that commit",
                 "ms": 0.0244, "device_ms": 0.00412, "library_ms": 0.0121,
                 "library_device_ms": 0.00654, "profile_ms": 0.0190,
                 "profile_device_ms": 0.00568},
}
# B6's and B7's figures before their redesign (the kernels as first written
# in commit 8b4efb4, on the slim launch path of 3b32873 and 5200b70): at
# config 12's tick from PERF.md's kernel table (chip run 8 of 3b32873), at
# the map replay's one-stream tick from tools/fleet_ab.py with 5200b70 as
# its baseline (NVIDIA H100 80GB HBM3, 700.00 W)
BEFORE.update({
    "coarse_scores": {"commit": "5200b70", "run": "chip run 8 of 3b32873",
                      "ms": 0.0923, "device_ms": 0.0896,
                      "replay_map_run": "tools/fleet_ab.py, baseline 5200b70",
                      "replay_map_ms": 0.09240, "replay_map_device_ms": 0.09103},
    "fine_scores": {"commit": "5200b70", "run": "chip run 8 of 3b32873",
                    "ms": 0.1455, "device_ms": 0.1418,
                    "replay_map_run": "tools/fleet_ab.py, baseline 5200b70",
                    "replay_map_ms": 0.14497, "replay_map_device_ms": 0.14386},
})
# B2's and B8's figures before their redesign (the kernels as first written
# in commit 8b4efb4 for B8 and f6c749c for B2, on the slim launch path of
# 3b32873, unchanged through 165d17b): at their path's shapes from PERF.md's
# kernel table (chip run 8 of 3b32873); B8 at the map replay's one-stream
# tick, never measured before, from tools/fleet_ab.py with 165d17b as its
# baseline (NVIDIA H100 80GB HBM3, 700.00 W)
BEFORE.update({
    "sorted_replace": {"commit": "165d17b", "run": "chip run 8 of 3b32873",
                       "ms": 0.0196, "device_ms": 0.0182},
    "log_odds_update": {"commit": "165d17b", "run": "chip run 8 of 3b32873",
                        "ms": 0.0164, "device_ms": 0.0151,
                        "replay_map_run": "tools/fleet_ab.py, baseline 165d17b",
                        "replay_map_ms": 0.02732, "replay_map_device_ms": 0.01499},
})
# B3's and B5's figures before their redesign (B3 as first written in
# commit 88dad5c, B5 in aeedd51, both on the slim launch path of
# 3b32873, unchanged through c836eb8): at their path's shapes from PERF.md's
# kernel table, events ms from chip run 8 of 3b32873, device ms from chip
# run 11 of c836eb8 (NVIDIA H100 80GB HBM3, 700.00 W)
BEFORE.update({
    "sliding_median": {"commit": "c836eb8", "run": "chip run 8 of 3b32873 (ms), "
                       "chip run 11 of c836eb8 (device_ms)", "ms": 0.1789, "device_ms": 0.17800},
    "shift_sad": {"commit": "c836eb8", "run": "chip run 8 of 3b32873 (ms), "
                  "chip run 11 of c836eb8 (device_ms)", "ms": 0.0141, "device_ms": 0.00178},
})
# the redesign's goals: device ms at the path's shapes, and events ms at or
# below the library call's in the same run (B1, B4); B2 at W=64, B=2048; B6,
# B7 and B8 at config 12's tick, and at the map replay's at most a third of
# the old kernel's; B3 at W=64, K=512, B=2048; B5 at 8 x 17 x 256, its
# events ms and host µs within GOAL_B5_GAP_US of B4's in the same rounds
GOAL_DEVICE_MS = {"temporal_median": 0.005, "beam_min": 0.003,
                  "coarse_scores": 0.020, "fine_scores": 0.030,
                  "sorted_replace": 0.005, "log_odds_update": 0.006,
                  "sliding_median": 0.060, "shift_sad": 0.0015}
GOAL_HOST_US = 8.0  # host time per call of the slim launch path
GOAL_B5_GAP_US = 1.0
# the processes that compute the CPU references beside the card's driving,
# one core each (at most; a host gets at most half its cores' worth)
REF_WORKERS = 4
# what a phase returns for the script's own use and leaves out of its line:
# launch totals gathered into the kernels line, the layouts' records and
# per-card launches that --pod-cards compares, pods and profiled inputs
_INTERNAL = ("failover_launches", "scheduled_launches", "records", "card_launches", "pods",
             "profile_items")


# the run's phase clocks: per phase name, the wall seconds and the seconds
# spent building CPU reference arms so far (a phase run in two halves adds
# both); the clocks open now, outermost first; the CPU reference seconds
# of the whole run, counted by the outermost open cpu_reference()
_CLOCKS: dict = {}
_OPEN: list = []
_CPU_REF = {"seconds": 0.0, "depth": 0}


@contextlib.contextmanager
def phase_clock(name: str):
    """Time the phase ``name``: every JSON line of that phase printed
    inside it (or, for a line of no clocked phase, of the innermost open
    one) carries ``seconds`` and ``cpu_seconds`` so far."""
    _OPEN.append((name, time.perf_counter(), _CPU_REF["seconds"]))
    try:
        yield
    finally:
        _name, t0, c0 = _OPEN.pop()
        got = _CLOCKS.setdefault(name, [0.0, 0.0])
        got[0] += time.perf_counter() - t0
        got[1] += _CPU_REF["seconds"] - c0


@contextlib.contextmanager
def cpu_reference():
    """Count the enclosed time as building a CPU reference arm or a host
    reference (nested ones once)."""
    _CPU_REF["depth"] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CPU_REF["depth"] -= 1
        if _CPU_REF["depth"] == 0:
            _CPU_REF["seconds"] += time.perf_counter() - t0


def _phase_seconds(name: str) -> dict | None:
    """``seconds`` and ``cpu_seconds`` of phase ``name`` so far (the
    innermost open clock's when ``name`` has none); None outside every
    clock."""
    if name not in _CLOCKS and all(n != name for n, _t, _c in _OPEN):
        if not _OPEN:
            return None
        name = _OPEN[-1][0]
    wall, cpu = _CLOCKS.get(name, (0.0, 0.0))
    now = time.perf_counter()
    for n, t0, c0 in _OPEN:
        if n == name:
            wall += now - t0
            cpu += _CPU_REF["seconds"] - c0
    return {"seconds": wall, "cpu_seconds": cpu}


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries its clock's figures and
    how many planned CPU references were still being computed."""
    if isinstance(obj, dict) and "phase" in obj:
        clock = _phase_seconds(obj["phase"])
        if clock is not None:
            obj = {**obj, **clock, "refs_pending": REFS.running()}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def exact(a, b) -> tuple[bool, float]:
    """(equal, max |a-b| over entries that differ); +inf == +inf.  Compared
    in float64, exact for float32 and int32 alike."""
    import torch

    a, b = a.double(), b.double().to(a.device)
    if a.shape != b.shape:
        return False, math.inf
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    err = 0.0 if bool(same.all()) else float((a - b).abs()[~same].max())
    return bool(same.all()), err


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Milliseconds per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200, warmup: int = 20) -> float:
    """Host microseconds per call: ``iters`` calls timed with perf_counter
    and no synchronisation between them (the synchronise after them is
    outside the timing) — what a caller's thread spends issuing one."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_ms(fn, iters: int = 50, tries: int = 3):
    """Device (kernel) milliseconds per call from torch.profiler, summed
    over every CUDA kernel the call launches; None when the profiler
    records no device time in ``tries`` sessions.  Host activity is traced
    too: without it the profiler has been seen to keep only some of a
    run's kernels, and a session has been seen to keep none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def bound(nbytes: int, ops: int, int32: bool = False) -> tuple[float, str]:
    """The least time (ms) of a kernel that moves ``nbytes`` and does
    ``ops`` float32 operations (int32 ones with ``int32``), and which of the
    two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (INT32_OPS_PER_S if int32 else FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    smi = lines[0]
    cap = torch.cuda.get_device_capability(0)
    info = {
        "phase": "device", "nvidia_smi": smi, "nvidia_smi_cards": lines,
        "torch": torch.__version__,
        "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
        "capability": list(cap), "count": torch.cuda.device_count(),
    }
    emit(info)
    check(tuple(cap) == (9, 0), f"compute capability {cap} is not (9, 0)")
    return info


def phase_build() -> None:
    from rplidar_ros2_driver_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    per_lib = cuda_build.build_libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_library_s": per_lib,
          "nvcc": cuda_build.find_nvcc()})


def phase_launch(device, rng, rounds: int = 9, iters: int = 200) -> dict:
    """The slim launch path's cost per call, before any torch.profiler
    session in this process (once the profiler has run, CUPTI's callbacks
    stay attached and every CUDA call's host cost grows): B1 at the main
    path's shape and B4 at both of its path's shapes, each beside its
    library call.  The host's clock moves by tens of percent within a run
    (a one-card machine shares its host's cores), so kernel and library
    alternate over ``rounds`` rounds, the first arm alternating too, and
    each figure is the median over the rounds, with the rounds the kernel
    won.  ``iters`` stays well under the depth of the card's launch queue
    (a library call slower on the device than on the host would otherwise
    fill it and time the device).  The kernels are held to their plain
    versions in the kernels and deskew_kernels phases."""
    import statistics

    import torch

    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    w, b = GEOMETRY["window"], GEOMETRY["beams"]
    win = torch.from_numpy(_median_fixtures(rng, w, b)["random_inf"]).to(device)
    nan_win = torch.where(torch.isinf(win), torch.full_like(win, math.nan), win)
    cases = {"temporal_median": (
        lambda: mk.temporal_median_kernel(win), lambda: torch.nanmedian(nan_win, dim=0), [w, b])}
    for name, (bb, vv, nb) in _b4_path_inputs(rng, device).items():
        cases[f"beam_min_{name}"] = (lambda bb=bb, vv=vv, nb=nb: dk.beam_min_kernel(bb, vv, nb),
                                     _scatter_min(bb, vv, nb), [*bb.shape, nb])
    rows = {}
    for name, (kern, lib, shape) in cases.items():
        got = {"kernel": [], "library": []}
        for r in range(rounds):
            for arm in (("kernel", "library") if r % 2 == 0 else ("library", "kernel")):
                fn = kern if arm == "kernel" else lib
                got[arm].append((cuda_ms(fn, iters), host_us(fn, iters)))
        k, lb = got["kernel"], got["library"]
        rows[name] = {
            "ms": statistics.median(x[0] for x in k),
            "library_ms": statistics.median(x[0] for x in lb),
            "host_us": statistics.median(x[1] for x in k),
            "library_host_us": statistics.median(x[1] for x in lb),
            "rounds": rounds,
            "kernel_won_events": sum(a[0] < c[0] for a, c in zip(k, lb)),
            "kernel_won_host": sum(a[1] < c[1] for a, c in zip(k, lb)),
            "shape": shape,
        }
    # B5 beside B4 at the de-skew path's shapes (the shift search, 8 slots x
    # 17 shifts x 256 beams; the rasterizer), the pair alternating likewise
    prev, cur, cands = _b5_path_inputs(rng, device)
    rb, rv, nb = _b4_path_inputs(rng, device)["raster"]
    pair = {"shift_sad": lambda: dk.shift_sad_kernel(prev, cur, cands, 16, 2048),
            "beam_min_raster": lambda: dk.beam_min_kernel(rb, rv, nb)}
    got = {name: [] for name in pair}
    for r in range(rounds):
        for name in (pair if r % 2 == 0 else reversed(list(pair))):
            got[name].append((cuda_ms(pair[name], iters), host_us(pair[name], iters)))
    b5, b4 = got["shift_sad"], got["beam_min_raster"]
    rows["shift_sad"] = {
        "ms": statistics.median(x[0] for x in b5),
        "host_us": statistics.median(x[1] for x in b5),
        "beside": "beam_min_raster",
        "beside_ms": statistics.median(x[0] for x in b4),
        "beside_host_us": statistics.median(x[1] for x in b4),
        "rounds": rounds,
        "rounds_within_1us_events": sum(abs(a[0] - c[0]) * 1e3 <= 1.0 for a, c in zip(b5, b4)),
        "rounds_within_1us_host": sum(abs(a[1] - c[1]) <= 1.0 for a, c in zip(b5, b4)),
        "shape": [*prev.shape[:1], len(cands), prev.shape[1]],
    }
    emit({"phase": "launch", "times": rows})
    return rows


def _median_fixtures(rng, w: int, b: int):
    import numpy as np

    base = rng.uniform(0.1, 40.0, (w, b)).astype(np.float32)
    holes = base.copy()
    holes[rng.random((w, b)) < 0.3] = np.inf
    holes[:, : max(1, b // 100)] = np.inf  # all-inf beams
    ties = (np.round(holes * 1000.0) / 1000.0).astype(np.float32)  # 1 mm quantization
    coarse = np.round(holes, 0).astype(np.float32)                 # heavy ties
    return {"random_inf": holes, "ties_1mm": ties, "heavy_ties": coarse, "all_finite": base}


def _b2_fixtures(rng, w: int, b: int):
    """B2's one-step edge cases at (W, B): name -> (ascending (W, B)
    window, old (B,), new (B,)) as float32 numpy arrays."""
    import numpy as np

    def sort(x):
        return np.sort(x, axis=0).astype(np.float32)  # +inf sorts last

    base = sort(_median_fixtures(rng, w, b)["random_inf"])
    rows = rng.integers(0, w, b)
    cols = np.arange(b)
    old = base[rows, cols]                          # present: a row of the column
    new = rng.uniform(0.1, 40.0, b).astype(np.float32)
    new[rng.random(b) < 0.3] = np.inf
    inf = np.full(b, np.inf, np.float32)
    equal = np.full((w, b), 7.25, np.float32)
    between = np.where(np.arange(b) % 3 == 0, 7.0, np.where(np.arange(b) % 3 == 1, 7.25, 7.5))
    return {
        "random": (base, old, new),
        # +inf evicted (absent from all-finite columns) and +inf inserted
        "old_inf": (base, inf, new),
        "new_inf": (base, old, inf),
        "all_inf": (np.full((w, b), np.inf, np.float32), inf, new),
        "all_inf_new_inf": (np.full((w, b), np.inf, np.float32), inf, inf),
        # every row holds `old`: the first is deleted; new below, equal, above
        "all_equal": (equal, equal[0].copy(), between.astype(np.float32)),
        # `old` in no row: d = 0, as the plain version's argmax gives
        "old_absent": (base, np.full(b, -1.0, np.float32), new),
        "old_absent_above": (sort(rng.uniform(0.1, 40.0, (w, b)).astype(np.float32)),
                             np.full(b, 50.0, np.float32), new),
    }


def check_median_kernels(device, rng) -> dict:
    """B1, B2 and B3 against their plain versions on ``device`` (exact)
    over their fixtures and plan edges: the kernels phase's checks, which
    ``--pod-cards`` also runs on every card.  Returns the largest errors
    and what was checked."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    max_err = {"temporal_median": 0.0, "sorted_replace": 0.0}
    checked = 0

    def b1(x, what):
        nonlocal checked
        ok, err = exact(mk.temporal_median_kernel(x), mk.temporal_median_plain(x))
        max_err["temporal_median"] = max(max_err["temporal_median"], err)
        check(ok, f"B1 differs from its plain version ({what}): {err}")
        checked += 1

    def b2(sor, old, new, what):
        for got, want, part in zip(mk.sorted_replace_kernel(sor, old, new),
                                   mk.sorted_replace_plain(sor, old, new), ("window", "median")):
            ok, err = exact(got, want)
            max_err["sorted_replace"] = max(max_err["sorted_replace"], err)
            check(ok, f"B2 {part} differs from its plain version ({what}): {err}")

    # W around the warp's 32 rows and its two-candidate pass (1, 31, 32,
    # 33, 64, 96), B off the block's 8 columns and off 16-byte rows; W up
    # to 1536 is staged in shared memory, 1537 reads device memory directly
    # and the fleet's stripes: config 10's host tick at N = 2 and 8 streams
    for w, b in [(64, 2048), (16, 2048), (7, 1000), (33, 2050), (400, 300), (1, 2048),
                 (31, 1001), (32, 2047), (96, 2048), (1536, 100), (1537, 100),
                 (64, 2 * 2048), (64, 8 * 2048)]:
        fixtures = _median_fixtures(rng, w, b)
        fixtures["all_inf"] = np.full((w, b), np.inf, np.float32)
        fixtures["all_equal"] = np.full((w, b), 7.25, np.float32)
        for name, win in fixtures.items():
            b1(torch.from_numpy(win).to(device), f"(W, B)=({w}, {b}) {name}")
    # a contiguous view 4 bytes off a 16-byte boundary: the staging's
    # scalar path at the main path's shape
    w, b = GEOMETRY["window"], GEOMETRY["beams"]
    flat = torch.from_numpy(_median_fixtures(rng, w, b + 1)["random_inf"]).to(device).view(-1)
    b1(flat[1 : 1 + w * b].view(w, b), f"(W, B)=({w}, {b}) offset view")

    # B2 over successive ring steps: the sorted window evolves by the
    # kernel's own output and must stay equal to the plain evolution
    b2_steps = 0
    for w, b, steps in [(GEOMETRY["window"], GEOMETRY["beams"], 300), (7, 1000, 40),
                        (33, 2050, 80), (400, 300, 820)]:
        ring = torch.full((w, b), math.inf, device=device)
        sor_k = ring.clone()
        sor_p = ring.clone()
        for step in range(steps):
            new = rng.uniform(0.1, 40.0, b).astype(np.float32)
            new[rng.random(b) < 0.3] = np.inf
            if step % 3 == 0:
                new = np.round(new, 0).astype(np.float32)  # ties with the window
            if step % 7 == 0:
                new[: b // 2] = new[0]
            new_t = torch.from_numpy(new).to(device)
            old = ring[step % w].clone()
            out_k, med_k = mk.sorted_replace_kernel(sor_k, old, new_t)
            out_p, med_p = mk.sorted_replace_plain(sor_p, old, new_t)
            for got, want, what in ((out_k, out_p, "window"), (med_k, med_p, "median")):
                ok, err = exact(got, want)
                max_err["sorted_replace"] = max(max_err["sorted_replace"], err)
                check(ok, f"B2 {what} differs from its plain version at (W, B)=({w}, {b}) "
                          f"step {step}: {err}")
            sor_k, sor_p = out_k, out_p
            ring[step % w] = new_t
        ok, _ = exact(sor_k, torch.sort(ring, dim=0).values)
        check(ok, f"B2's carried window is not the sorted ring after {steps} steps")
        b2_steps += steps

    # B2's edge fixtures, one step each: W around the warp's 32 rows, the
    # staging's edge (its slab and slots fit 48 KiB up to W = 1533; 1534 to
    # 1537 read device memory), ragged B, +inf old/new/columns, all-equal
    # columns, `old` absent (the plain version's d = 0) and an offset view
    b2_fixtures = 0
    for w, b in [(1, 2048), (31, 1001), (32, 2047), (33, 2050), (96, 2048), (1533, 100),
                 (1534, 100), (1535, 100), (1536, 100), (1537, 100),
                 (GEOMETRY["window"], GEOMETRY["beams"])]:
        for name, (sor, old, new) in _b2_fixtures(rng, w, b).items():
            b2(*(torch.from_numpy(x).to(device) for x in (sor, old, new)),
               f"(W, B)=({w}, {b}) {name}")
            b2_fixtures += 1
    w, b = GEOMETRY["window"], GEOMETRY["beams"]
    sor, old, new = (torch.from_numpy(x).to(device) for x in _b2_fixtures(rng, w, b)["random"])
    buf = torch.empty(w * b + 1, device=device)
    buf[1:].copy_(sor.view(-1))
    b2(buf[1:].view(w, b), old, new, f"(W, B)=({w}, {b}) offset view")
    b2_fixtures += 1

    # B3 over the test grid (odd W, K not a multiple of 8, W=1, ragged
    # beams) and the replay path's stripe (W=64, K=512, B=2048), then its
    # launch plans' edges (mk.sliding_plan): K = 1; W > K with W far above a
    # block's R candidate rows; W = 1 down to one step; B = 257 and 2050
    # (rows off the 16-byte copies); W = 181, 187 and 190, the largest W
    # staged with 4, 2 and 1 warps a block; W = 191 and 1536, unstaged;
    # each with all-+inf and all-equal stripes too; then an offset view
    max_err["sliding_median"] = 0.0
    b3_checked = 0
    b3_plans = {}

    def b3(x, w3, what):
        nonlocal b3_checked
        ok, err = exact(mk.sliding_median_kernel(x, w3), mk.sliding_median_plain(x, w3))
        max_err["sliding_median"] = max(max_err["sliding_median"], err)
        check(ok, f"B3 differs from its plain version ({what}): {err}")
        b3_checked += 1

    b3_shapes = [(4, 8, 64), (6, 8, 100), (7, 16, 257), (8, 3, 128), (16, 24, 640), (1, 8, 32),
                 (REPLAY["window"], REPLAY["chunk"], REPLAY["beams"]),
                 # config 8's fleet chunk: 4 streams' stripes side by side
                 (FLEET["window"], FLEET["replay_chunk"], FLEET["replay_streams"] * FLEET["beams"])]
    b3_edges = [(REPLAY["window"], 1, REPLAY["beams"]), (9, 1, 100), (150, 40, 100),
                (300, 2, 70), (1, 1, 64), (1, 600, 300), (REPLAY["window"], 100, 257),
                (33, 50, 2050), (181, 300, 64), (187, 300, 64), (190, 300, 64),
                (191, 300, 64), (1536, 7, 100), (REPLAY["window"], 7, REPLAY["beams"])]
    for w3, k3, bb in b3_shapes + b3_edges:
        b3_plans[f"{w3},{k3},{bb}"] = list(mk.sliding_plan(w3, k3))
        fixtures = _median_fixtures(rng, w3 + k3, bb)
        if (w3, k3, bb) in b3_edges:
            fixtures["all_inf"] = np.full((w3 + k3, bb), np.inf, np.float32)
            fixtures["all_equal"] = np.full((w3 + k3, bb), 7.25, np.float32)
        for name, ext in fixtures.items():
            b3(torch.from_numpy(ext).to(device), w3, f"(W, K, B)=({w3}, {k3}, {bb}) {name}")
    # a contiguous view 4 bytes off a 16-byte boundary: the 4-byte copies
    # at the replay path's shape
    w3, k3, b3w = REPLAY["window"], REPLAY["chunk"], REPLAY["beams"]
    flat = torch.from_numpy(_median_fixtures(rng, w3 + k3, b3w + 1)["ties_1mm"]).to(device)
    flat = flat.view(-1)
    b3(flat[1 : 1 + (w3 + k3) * b3w].view(w3 + k3, b3w), w3,
       f"(W, K, B)=({w3}, {k3}, {b3w}) offset view")
    return {"checked_b1_fixtures": checked, "b2_steps": b2_steps,
            "checked_b2_fixtures": b2_fixtures, "checked_b3_fixtures": b3_checked,
            "b3_plans": b3_plans, "max_abs_err": max_err}


def phase_kernels(device, rng) -> dict:
    """Each kernel against its plain version on the card, then timed."""
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    checks = check_median_kernels(device, rng)
    # timing at the main path's shape, on a filled ring
    w, b = GEOMETRY["window"], GEOMETRY["beams"]
    win = torch.from_numpy(_median_fixtures(rng, w, b)["random_inf"]).to(device)
    nan_win = torch.where(torch.isinf(win), torch.full_like(win, math.nan), win)
    sor = torch.sort(win, dim=0).values
    old = win[5].clone()
    new_t = win[9].clone()
    times = {
        "temporal_median": {
            "ms": cuda_ms(lambda: mk.temporal_median_kernel(win)),
            "plain_ms": cuda_ms(lambda: mk.temporal_median_plain(win)),
            "library_ms": cuda_ms(lambda: torch.nanmedian(nan_win, dim=0)),
            "device_ms": device_ms(lambda: mk.temporal_median_kernel(win)),
            "plain_device_ms": device_ms(lambda: mk.temporal_median_plain(win)),
            "library_device_ms": device_ms(lambda: torch.nanmedian(nan_win, dim=0)),
            # after the profiler has run (the launch phase has the cost before)
            "host_us": host_us(lambda: mk.temporal_median_kernel(win)),
            "library_host_us": host_us(lambda: torch.nanmedian(nan_win, dim=0)),
        },
        "sorted_replace": {
            "ms": cuda_ms(lambda: mk.sorted_replace_kernel(sor, old, new_t)),
            "plain_ms": cuda_ms(lambda: mk.sorted_replace_plain(sor, old, new_t)),
            # no single PyTorch call computes the delete/insert; the median
            # part's yardstick is the same nanmedian as B1's
            "library_ms": None,
            "yardstick_nanmedian_ms": cuda_ms(lambda: torch.nanmedian(nan_win, dim=0)),
            "device_ms": device_ms(lambda: mk.sorted_replace_kernel(sor, old, new_t)),
            "plain_device_ms": device_ms(lambda: mk.sorted_replace_plain(sor, old, new_t)),
        },
    }
    w3, k3, b3w = REPLAY["window"], REPLAY["chunk"], REPLAY["beams"]
    ext = torch.from_numpy(_median_fixtures(rng, w3 + k3, b3w)["ties_1mm"]).to(device)
    nan_ext = torch.where(torch.isinf(ext), torch.full_like(ext, math.nan), ext)
    # the replay's tail chunk: 520 turns give 519 revolutions, 512 + 7
    tail = torch.from_numpy(_median_fixtures(rng, w3 + 7, b3w)["ties_1mm"]).to(device)
    times["sliding_median"] = {
        "ms": cuda_ms(lambda: mk.sliding_median_kernel(ext, w3), iters=50),
        "plain_ms": cuda_ms(lambda: mk.sliding_median_plain(ext, w3), iters=10, warmup=2),
        # the same K windows' lower medians in one PyTorch call (NaN for +inf)
        "library_ms": cuda_ms(
            lambda: torch.nanmedian(nan_ext.unfold(0, w3, 1)[1 : k3 + 1], dim=-1), iters=10,
            warmup=2),
        "device_ms": device_ms(lambda: mk.sliding_median_kernel(ext, w3), iters=20),
        "plain_device_ms": device_ms(lambda: mk.sliding_median_plain(ext, w3), iters=5),
        "plan": list(mk.sliding_plan(w3, k3)),
        "tail_k7": {"ms": cuda_ms(lambda: mk.sliding_median_kernel(tail, w3), iters=50),
                    "device_ms": device_ms(lambda: mk.sliding_median_kernel(tail, w3), iters=20),
                    "plan": list(mk.sliding_plan(w3, 7))},
    }
    emit({"phase": "kernels", **checks, "times_ms": times, "shape": [w, b],
          "b3_shape": [w3, k3, b3w]})
    return {"max_abs_err": checks["max_abs_err"], "times": times}


def make_revolutions(seed: int, n: int, points: int):
    """Seeded DenseBoost-shaped revolutions (tools/scenes.make_revolutions)."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import make_revolutions as revolutions

    return revolutions(seed, n, points)


def _chain(backend: str, median: str, cell_m: float):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain

    params = DriverParams(
        filter_backend=backend, filter_chain=("clip", "polar", "median", "voxel"),
        filter_window=GEOMETRY["window"], voxel_grid_size=GEOMETRY["grid"],
        voxel_cell_m=cell_m, median_backend=median,
    )
    return ScanFilterChain(params, GEOMETRY["beams"], capacity=GEOMETRY["capacity"])


def _run_chain(chain, revs, pipelined: bool):
    """Drive ``revs`` through one chain; returns (outputs, per-call
    seconds, wall seconds).  The pipelined seam's outputs lag one call,
    and the flush collects the last."""
    outs, lat = [], []
    t_all = time.perf_counter()
    for r in revs:
        t0 = time.perf_counter()
        if pipelined:
            out = chain.process_raw_pipelined(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"])
        else:
            out = chain.process_raw(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"])
        lat.append(time.perf_counter() - t0)
        if out is not None:
            outs.append(out)
    if pipelined:
        outs.append(chain.flush_pipelined())
    return outs, lat, time.perf_counter() - t_all


def _same_output(a, b) -> bool:
    import numpy as np

    return all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("ranges", "intensities", "points_xy", "point_mask", "voxel")
    )


def phase_chain(device, revs) -> dict:
    """The main path at the headline geometry, every output held equal to
    the package's own CPU chain on the same revolutions."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    arms = []
    counts = {k: 0 for k in mk.launch_counts}
    for cell_m in (0.25, 0.1):
        ref, _, ref_wall = _run_chain(_chain("cpu", "pallas", cell_m), revs, False)
        for median in ("pallas", "inc_pallas"):
            for pipelined in (False, True):
                chain = _chain(device.type, median, cell_m)
                check(chain.device == device, "chain did not land on the card")
                mk.reset_launch_counts()
                outs, lat, wall = _run_chain(chain, revs, pipelined)
                launched = dict(mk.launch_counts)
                for k in counts:
                    counts[k] += launched[k]
                kernel = "temporal_median" if median == "pallas" else "sorted_replace"
                check(launched[kernel] == len(revs),
                      f"{median}: {launched[kernel]} launches for {len(revs)} steps")
                check(len(outs) == len(ref), f"{median}: {len(outs)} outputs for {len(ref)}")
                for k, (a, b) in enumerate(zip(outs, ref)):
                    check(_same_output(a, b),
                          f"{median} cell {cell_m} pipelined={pipelined}: revolution {k} "
                          "differs from the CPU chain")
                last = outs[-1]
                fin = np.isfinite(last.ranges)
                check(fin.sum() > 0.9 * GEOMETRY["beams"], "too few finite ranges")
                check(float(np.abs(last.ranges[fin] - 2.0).max()) < 0.6,
                      "ranges off the 2 m +/- 0.5 m ring")
                check(int(last.voxel.sum()) > 0, "empty voxel grid")
                lat_ms = np.asarray(lat) * 1e3
                arm = {
                    "median_backend": median, "cell_m": cell_m,
                    "seam": "pipelined" if pipelined else "sync",
                    "revolutions": len(revs), "scans_per_s": len(revs) / wall,
                    "p50_ms": float(np.percentile(lat_ms, 50)),
                    "p99_ms": float(np.percentile(lat_ms, 99)),
                    "max_ms": float(lat_ms.max()),
                    "launches": launched, "cpu_reference_scans_per_s": len(revs) / ref_wall,
                }
                arms.append(arm)
                emit({"phase": "chain", **arm})
    return {"arms": arms, "launches": counts}


def phase_profile(device, revs, trace_dir=None) -> list:
    """Where a revolution's time goes: host wall per revolution beside
    the device time of every kernel and copy it launched (torch.profiler,
    20 revolutions after 10 of warm-up, per kernel backend).  The
    profiler's own overhead inflates the host side of this window."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for median in ("pallas", "inc_pallas"):
        chain = _chain(device.type, median, 0.25)
        _run_chain(chain, revs[:10], False)
        window = revs[10:30]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, lat, wall = _run_chain(chain, window, False)
        n = len(window)
        dev_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        busy_us = sum(ev.time_range.elapsed_us() for ev in dev_events)
        by_kernel = {}
        for ev in dev_events:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        top_device = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        host_ops = sorted(
            (ev for ev in prof.key_averages() if ev.self_cpu_time_total > 0),
            key=lambda ev: -ev.self_cpu_time_total,
        )[:8]
        row = {
            "phase": "profile", "median_backend": median, "revolutions": n,
            "wall_ms_per_rev": wall / n * 1e3,
            "p50_ms": float(np.percentile(np.asarray(lat) * 1e3, 50)),
            "device_busy_ms_per_rev": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_ops_per_rev": len(dev_events) / n,
            "top_device_ms_per_rev": [[k[:80], v / n / 1e3] for k, v in top_device],
            "top_host_self_ms_per_rev": [
                [ev.key[:80], ev.self_cpu_time_total / n / 1e3] for ev in host_ops
            ],
        }
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"chain_{median}.json"))
        rows.append(row)
        emit(row)
    return rows


def phase_ab(device, revs, rounds: int = 10, per_arm: int = 100) -> dict:
    """B1 against B2 end to end: the sync seam at config 5 (0.25 m), two
    warmed chains, the backends in alternating order (AB, BA, ...) so
    neither always runs first, ``per_arm`` revolutions per arm and round.
    Outputs are not compared here: the chain phase held both arms to the
    CPU chain."""
    import numpy as np

    arms = ("pallas", "inc_pallas")
    chains = {m: _chain(device.type, m, 0.25) for m in arms}
    for chain in chains.values():
        _run_chain(chain, revs[:20], False)
    window = revs[20 : 20 + per_arm]
    rates = {m: [] for m in arms}
    p99 = {m: [] for m in arms}
    for r in range(rounds):
        for m in (arms if r % 2 == 0 else arms[::-1]):
            _, lat, wall = _run_chain(chains[m], window, False)
            rates[m].append(len(window) / wall)
            p99[m].append(float(np.percentile(np.asarray(lat) * 1e3, 99)))
    row = {
        "phase": "ab", "rounds": rounds, "revolutions_per_arm": len(window),
        "scans_per_s": rates, "p99_ms": p99,
        "median_scans_per_s": {m: float(np.median(v)) for m, v in rates.items()},
        "median_p99_ms": {m: float(np.median(v)) for m, v in p99.items()},
        "pallas_wins": int(sum(a > b for a, b in zip(rates["pallas"], rates["inc_pallas"]))),
    }
    emit(row)
    return row


def denseboost_frames(seed: int, revs: int, points: int) -> list[bytes]:
    """Seeded DenseBoost capture of the noisy ring (tools/scenes.denseboost_frames)."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import denseboost_frames as frames

    return frames(seed, revs, points)


def _replay_params(backend: str, **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    return DriverParams(
        filter_backend=backend, filter_chain=("clip", "median", "voxel"),
        filter_window=REPLAY["window"], voxel_grid_size=REPLAY["grid"],
        voxel_cell_m=REPLAY["cell_m"], median_backend="pallas", **over,
    )


def _same_state(a, b) -> bool:
    import numpy as np

    sa, sb = a.to_numpy(), b.to_numpy()
    return sa.keys() == sb.keys() and all(np.array_equal(sa[k], sb[k]) for k in sa)


def write_capture(path: str, frames) -> None:
    """A one-format DenseBoost capture of ``frames``, 1 ms apart, written
    with the package's FrameRecorder."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
    from rplidar_ros2_driver_tpu_torch.replay import FrameRecorder

    with FrameRecorder(path) as rec:
        for i, fr in enumerate(frames):
            rec.write(int(Ans.MEASUREMENT_DENSE_CAPSULED), fr, i * 1e-3)


def phase_replay(device, seed: int) -> dict:
    """The offline replay path at config 7's geometry: a seeded DenseBoost
    capture written with the package's FrameRecorder, decoded on the card,
    split into revolutions, and run through the fused K-scan chain with
    B3 — every result held equal to the package's CPU replay, and the
    card's fused chain to K streaming steps on the card."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params
    from rplidar_ros2_driver_tpu_torch.ops import filters as tf
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.replay import decode_recording, replay_through_chain

    t0 = time.perf_counter()
    frames = denseboost_frames(seed, REPLAY["revs"], REPLAY["points"])
    encode_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "denseboost.rplr")
        write_capture(path, frames)
        decode_recording(path, device)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = decode_recording(path, device)
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dec_cpu = decode_recording(path, "cpu")
        decode_cpu_ms = (time.perf_counter() - t0) * 1e3
    check(dec.runs == dec_cpu.runs, f"decode runs differ: {dec.runs} vs {dec_cpu.runs}")
    for key in ("angle_q14", "dist_q2", "quality", "flag"):
        check(np.array_equal(getattr(dec, key), getattr(dec_cpu, key)),
              f"card decode differs from the CPU decode in {key}")
    revs, revs_cpu = dec.revolutions(), dec_cpu.revolutions()
    check(len(revs) == len(revs_cpu) == REPLAY["revs"] - 1,
          f"{len(revs)} / {len(revs_cpu)} revolutions for {REPLAY['revs']} turns")
    check(all(np.array_equal(a[k], b[k]) for a, b in zip(revs, revs_cpu) for k in a),
          "revolutions differ between the card and CPU decodes")

    kw = dict(beams=REPLAY["beams"], capacity=REPLAY["capacity"], chunk=REPLAY["chunk"])
    n_chunks = -(-len(revs) // REPLAY["chunk"])
    replay_through_chain(revs[: REPLAY["chunk"]], _replay_params("cuda"), **kw)  # warm-up
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    ranges, state = replay_through_chain(revs, _replay_params("cuda"), **kw)
    wall = time.perf_counter() - t0
    launched = dict(mk.launch_counts)
    check(launched["sliding_median"] == n_chunks,
          f"B3 launched {launched['sliding_median']} times for {n_chunks} chunks")

    t0 = time.perf_counter()
    ranges_cpu, state_cpu = replay_through_chain(revs, _replay_params("cpu"), **kw)
    cpu_wall = time.perf_counter() - t0
    check(ranges.shape == (len(revs), REPLAY["beams"]), f"ranges shape {ranges.shape}")
    ok, err = exact(torch.from_numpy(ranges), torch.from_numpy(ranges_cpu))
    check(ok, f"card replay ranges differ from the CPU replay: {err}")
    check(_same_state(state, state_cpu), "card replay's final state differs from the CPU's")
    check(state.median_sorted is None and state_cpu.median_sorted is None, "unexpected sorted state")

    # the fused chain on the card equals K streaming steps on the card
    cfg = config_from_params(_replay_params("cuda"), REPLAY["beams"], platform="cuda")
    seq, counts = tf.pack_host_scans_compact(revs, REPLAY["capacity"])
    seq_state, seq_ranges = tf._compact_filter_scan_sequential(
        tf.FilterState.for_config(cfg, device=device),
        torch.from_numpy(seq.view(np.int16)).to(device), torch.from_numpy(counts).to(device), cfg,
    )
    ok, err = exact(seq_ranges.cpu(), torch.from_numpy(ranges))
    check(ok, f"fused replay differs from {len(revs)} streaming steps on the card: {err}")
    check(_same_state(seq_state.to("cpu"), state), "fused final state differs from the steps'")

    fin = np.isfinite(ranges[-1])
    check(fin.sum() > 0.9 * REPLAY["beams"], "too few finite replay ranges")
    check(float(np.abs(ranges[-1][fin] - 2.0).max()) < 0.6, "replay ranges off the ring")
    check(int(state.voxel_acc.sum()) > 0, "empty replay voxel grid")

    # where a replay's time goes: host packing of one chunk, then the
    # device's share of one whole replay under the profiler
    t0 = time.perf_counter()
    tf.pack_host_scans_compact(revs[: REPLAY["chunk"]], REPLAY["capacity"])
    pack_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay_through_chain(revs, _replay_params("cuda"), **kw)
        prof_wall = time.perf_counter() - t0
    dev_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy_us = sum(ev.time_range.elapsed_us() for ev in dev_events)
    by_kernel = {}
    for ev in dev_events:
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    b3_us = sum(v for k, v in by_kernel.items() if "sliding_median" in k)
    row = {
        "phase": "replay", "turns": REPLAY["revs"], "frames": len(frames),
        "nodes": dec.num_nodes, "revolutions": len(revs), "chunks": n_chunks,
        "encode_s": encode_s, "decode_ms": decode_ms, "decode_cpu_ms": decode_cpu_ms,
        "chain_scans_per_s": len(revs) / wall, "chain_ms_per_chunk": wall / n_chunks * 1e3,
        "cpu_chain_scans_per_s": len(revs) / cpu_wall, "pack_ms_per_chunk": pack_ms,
        "launches": launched,
        "profiled_wall_ms": prof_wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "device_ops": len(dev_events), "b3_device_ms_per_chunk": b3_us / n_chunks / 1e3,
        "top_device_ms": [[k[:80], v / 1e3]
                          for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]],
    }
    emit(row)
    return row, revs, frames


def _stamped_publisher(probe):
    """A CollectingPublisher that keeps every message, each scan's publish
    time and, through ``probe``, what the publishing seam recorded for it.
    (Defined in a function: the package is imported only once the script
    knows it runs in a checkout.)"""
    from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

    class Stamped(CollectingPublisher):
        def __init__(self):
            super().__init__(reliable=True)
            self.published_at = []
            self.probes = []

        def publish_scan(self, msg):
            self.published_at.append(time.monotonic())
            self.probes.append(probe())
            super().publish_scan(msg)

    return Stamped()


class _E2eTap:
    """What the node did on the live path, recorded as it ran, so that the
    replay does the same: every revolution the driver's assembler completed,
    in order; every host grab the FSM handed to ``_on_scan`` as (its index
    among those revolutions, ts0, duration, the stamp handed on); every
    frame run the fused engine was handed, as (answer type, frames).  A
    revolution whose frames came in one read lasts 0 s, and the FSM hands it
    on under its grab clock (node/fsm.py, tests/test_torch_live_stamps.py)."""

    def __init__(self) -> None:
        self.completed, self.grabs, self.fed = [], [], []

    @property
    def restamped(self) -> int:
        """Grabs handed on under another stamp than their ts0 (the fused
        RUNNING step hands on the engine's stamps: none there)."""
        return sum(stamp != ts0 for _k, ts0, _d, stamp in self.grabs)

    def grab(self, scan: dict, stamp: float) -> None:
        k = next((i for i in range(len(self.completed) - 1, -1, -1)
                  if self.completed[i] is scan), -1)
        self.grabs.append((k, scan["ts0"], scan["duration"], stamp))

    def feed(self, handed):
        """``handed`` (an engine's ``on_measurement_batch``), each run counted."""

        def record_run(ans_type, items):
            self.fed.append((ans_type, len(items)))
            return handed(ans_type, items)

        return record_run


def _e2e_node_class(tap: _E2eTap):
    """RPlidarNode that keeps the FSM states it passes through and tells
    ``tap`` what it ran."""
    from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode

    class StateLoggingNode(RPlidarNode):
        def _on_fsm_state(self, state) -> None:
            self.states_seen.append(state.name)
            super()._on_fsm_state(state)

        def configure(self) -> bool:
            ok = super().configure()
            if ok and self.fused_ingest is not None:
                # the driver binds the engine's callback at connect, after this
                eng = self.fused_ingest
                eng.on_measurement_batch = tap.feed(eng.on_measurement_batch)
            return ok

        def _on_scan(self, scan: dict, start_time: float, duration: float) -> None:
            tap.grab(scan, start_time)
            super()._on_scan(scan, start_time, duration)

    return StateLoggingNode


def _recording_factory(port: int, path: str, tap: _E2eTap):
    """RealLidarDrivers on the simulator's TCP port that start recording the
    moment they connect (before any measurement frame) and hand every
    revolution their assembler completes to ``tap``."""
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver

    class RecordingDriver(RealLidarDriver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._assembler._on_complete = tap.completed.append

        def connect(self, *a, **kw):
            ok = super().connect(*a, **kw)
            if ok and self._scan_decoder.recorder is None:
                self.start_recording(path)
            return ok

    made = []

    def factory():
        made.append(RecordingDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=port,
                                    motor_warmup_s=0.0))
        return made[-1]

    return factory, made


def _e2e_params(backend: str, port: int, ingest: str, deskew: bool):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    over = dict(deskew_enable=True) if deskew else {}
    return DriverParams(
        filter_backend=backend, filter_chain=("clip", "median", "voxel"),
        filter_window=E2E["window"], voxel_grid_size=E2E["grid"], voxel_cell_m=E2E["cell_m"],
        pipelined_publish=True, channel_type="tcp", tcp_host="127.0.0.1", tcp_port=port,
        scan_mode="DenseBoost", ingest_backend=ingest, **over,
    )


def _capture_runs(path: str, run: int = 64) -> list:
    """The capture's frames as ``(ans_type, [(payload, ts), ...])`` runs of
    one type, at most ``run`` frames each (the engine's largest run)."""
    from rplidar_ros2_driver_tpu_torch.replay import read_frames

    runs = []
    for ans, ts, payload in read_frames(path):
        if not runs or runs[-1][0] != ans or len(runs[-1][1]) >= run:
            runs.append((ans, []))
        runs[-1][1].append((payload, ts))
    return runs


def _e2e_replay(arm: str, path: str, timing, tap: _E2eTap, deskew: bool) -> tuple:
    """The capture through the package's CPU arm of the same path, as the
    node ran it: ``([(FilterOutput, stamp), ...] in order, the start stamp
    of every revolution in the capture)``.  Host: the host
    decoder and assembler, then the CPU chain over the revolutions the FSM
    grabbed, in its order, each under the stamp it handed on (the pipelined
    seam publishes every revolution it runs, its last at the deactivate
    drain; one the FSM never grabbed stays out).  Fused: the CPU FusedIngest
    fed the runs the node's engine was handed (the fused window advances on
    every revolution, published or not).  Both with the live stream's
    timing."""
    from rplidar_ros2_driver_tpu_torch.driver.assembly import ScanAssembler
    from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder
    from rplidar_ros2_driver_tpu_torch.driver.ingest import FusedIngest
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain
    from rplidar_ros2_driver_tpu_torch.replay import read_frames

    params = _e2e_params("cpu", 0, arm, deskew)
    if arm == "host":
        revs = []
        dec = BatchScanDecoder(ScanAssembler(on_complete=revs.append))
        dec.timing = timing
        for ans, items in _capture_runs(path):
            dec.on_measurement_batch(ans, items)
        chain = ScanFilterChain(params)
        outs = []
        for k, ts0, duration, stamp in tap.grabs:
            r = revs[k] if 0 <= k < len(revs) else None
            check(r is not None and (r["ts0"], r["duration"]) == (ts0, duration),
                  f"e2e host: grabbed revolution {k} (ts0 {ts0}, duration {duration}) is not "
                  f"the replay's ({len(revs)} replayed, {tap.restamped} restamped)")
            # the FSM's clock fallback (node/fsm.py): a revolution goes out
            # under another stamp than its ts0 only when it lasted <= 0 s
            check(stamp == ts0 or r["duration"] <= 0,
                  f"e2e host: revolution {k} (ts0 {ts0}, duration {r['duration']}) handed on "
                  f"at {stamp} ({tap.restamped} restamped)")
            outs.append((chain.process_raw(r["angle_q14"], r["dist_q2"], r["quality"],
                                           r["flag"]), stamp))
        return outs, [r["ts0"] for r in revs]
    eng = FusedIngest(params, max_queue=1 << 30)
    eng.timing = timing
    frames = [(ans, (payload, ts)) for ans, ts, payload in read_frames(path)]
    off = 0
    for ans, n in tap.fed:
        run = frames[off : off + n]
        if len(run) < n:
            break  # handed over after the recording stopped
        check(all(a == ans for a, _f in run), f"e2e {arm}: the recording is not the runs fed")
        eng.on_measurement_batch(ans, [f for _a, f in run])
        off += n
    outs = [(o, ts0) for o, ts0, _d in eng.flush()]
    return outs, [ts0 for _o, ts0 in outs]


def _bits_equal(a, b) -> bool:
    import numpy as np

    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _thread_cpu() -> dict:
    """CPU seconds each thread of this process has used so far, by name:
    Python threads by their own names (the simulator's ``sim_stream`` and
    ``sim_accept``, the engine's ``rpl_pump``, the FSM's ``scan_loop``),
    every other thread (the native transceiver's, PyTorch's pools) by its
    kernel name, summed per name."""
    import threading

    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out: dict = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:
            continue  # the thread ended meanwhile
        fields = stat[stat.rindex(")") + 2 :].split()
        name = names.get(int(tid), stat[stat.index("(") + 1 : stat.rindex(")")])
        out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    return out


def _pcts(values) -> dict:
    import numpy as np

    v = np.asarray(values, np.float64)
    if v.size == 0:
        return {"n": 0}
    return {"n": int(v.size), "p50_ms": float(np.percentile(v, 50) * 1e3),
            "p99_ms": float(np.percentile(v, 99) * 1e3), "max_ms": float(v.max() * 1e3)}


def _e2e_arm(device, arm: str, deskew: bool, tmp: str) -> dict:
    """One arm: the simulator at 1x pace streams DenseBoost to the node's
    RealLidarDriver over loopback TCP for E2E["seconds"] after the first
    publish; the node runs the chain (host) or the fused ingest on
    ``device``; the live stream is recorded and every published revolution
    held equal to the CPU replay of the recording."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimConfig, SimulatedDevice
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.node.node import launch
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    name = arm + ("_deskew" if deskew else "")
    path = os.path.join(tmp, f"{name}.rplr")
    backend = "cuda" if device.type == "cuda" else "cpu"
    sim = SimulatedDevice(SimConfig(points_per_rev=E2E["points"],
                                    frame_rate_hz=E2E["frame_rate_hz"])).start()
    node = None
    try:
        tap = _E2eTap()
        factory, made = _recording_factory(sim.port, path, tap)
        holder = {}

        def probe():
            ch = holder["node"].chain
            return (ch.last_collect_wait_s, ch.last_upload_dispatch_s) if ch is not None else None

        pub = _stamped_publisher(probe)
        node = _e2e_node_class(tap)(_e2e_params(backend, sim.port, arm, deskew), pub,
                                 driver_factory=factory)
        node.states_seen = []
        holder["node"] = node
        mk.reset_launch_counts()
        dk.reset_launch_counts()
        t_launch = time.monotonic()
        launch(node)
        check(node.lifecycle_state is LifecycleState.ACTIVE, f"e2e {name}: node not ACTIVE")
        if arm == "fused":
            eng = node.fused_ingest
            check(eng is not None and node.chain is None, f"e2e {name}: no fused seam")
            check(eng.device == device, f"e2e {name}: fused ingest not on {device}")
        else:
            eng = None
            check(node.chain is not None and node.chain.device == device,
                  f"e2e {name}: chain not on {device}")
            if device.type == "cuda":
                check(node.chain.cfg.median_backend == "pallas", "auto did not resolve to B1")
        deadline = time.monotonic() + 60.0
        while pub.scan_count == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(pub.scan_count > 0, f"e2e {name}: nothing published within 60 s")
        t0 = time.monotonic()
        n0 = pub.scan_count
        d0 = (eng.dispatch_count, eng.frames_decoded, eng.dispatch_s) if eng else None
        cpu0 = _thread_cpu()
        time.sleep(E2E["seconds"])
        t1 = time.monotonic()
        n1 = pub.scan_count
        d1 = (eng.dispatch_count, eng.frames_decoded, eng.dispatch_s) if eng else None
        cpu1 = _thread_cpu()
        drv = made[-1]
        tx = drv._engine._tx if drv._engine is not None else None
        rx_priority = drv.rx_scheduling_class()
        check(type(tx).__name__ == "NativeTransceiver",
              f"e2e {name}: the driver runs on {type(tx).__name__}, not the native channel")
        check(rx_priority is not None and rx_priority != -1,
              f"e2e {name}: rx priority {rx_priority} (not the native transceiver)")
        check(node.deactivate(), f"e2e {name}: deactivate failed")
        launches = {"temporal_median": mk.launch_counts["temporal_median"],
                    "beam_min": dk.launch_counts["beam_min"],
                    "shift_sad": dk.launch_counts["shift_sad"]}
        timing = drv._scan_decoder.timing
        frames_recorded = drv.stop_recording()
        resets = node.fsm.reset_count
        stats = {}
        if eng is not None:
            stats = {"wires_dropped": eng.wires_dropped, "revs_dropped": eng.revs_dropped,
                     "dispatches": eng.dispatch_count, "frames": eng.frames_decoded}
    finally:
        if node is not None:
            node.shutdown()
        sim.stop()
    check(resets == 0, f"e2e {name}: the FSM reset {resets} times")
    if device.type == "cuda":  # a CPU tensor takes the plain versions
        check(launches["temporal_median"] > 0, f"e2e {name}: B1 never launched")
        if deskew:
            check(launches["beam_min"] > 0 and launches["shift_sad"] > 0,
                  f"e2e {name}: B4/B5 never launched ({launches})")
    scans = n1 - n0
    check(scans >= E2E["min_scans"], f"e2e {name}: {scans} scans in {t1 - t0:.1f} s")

    # publish latency: from the end of the revolution whose completion
    # triggered the publish (host: the NEXT revolution, the pipelined
    # seam's one of declared staleness; fused: the revolution itself) to
    # the publish call; the deactivate drain's last publish is not one
    msgs, clouds, at = list(pub.scans), list(pub.clouds), pub.published_at
    if arm == "host":
        trigger = msgs[1:]
    else:
        trigger = msgs
    lat = [t - (m.stamp + m.scan_time) for t, m in zip(at, trigger)]
    window = [x for x, t in zip(lat, at) if t0 <= t <= t1]
    result = {
        "scans": scans, "seconds": t1 - t0, "scans_per_s": scans / (t1 - t0),
        "publish": _pcts(window), "published_total": len(msgs),
        "launches": launches, "states_seen": node.states_seen,
        "transceiver": type(tx).__name__, "rx_priority": rx_priority,
        "frames_recorded": frames_recorded, "launch_to_first_publish_s": t0 - t_launch,
        # each thread's share of one core over the window
        "thread_cpu_share": {k: (v - cpu0.get(k, 0.0)) / (t1 - t0) for k, v in cpu1.items()
                             if v - cpu0.get(k, 0.0) > 0},
    }
    if arm == "host":
        probes = [p for p, t in zip(pub.probes, at) if t0 <= t <= t1 and p is not None]
        result["collect_wait"] = _pcts([p[0] for p in probes])
        result["upload_dispatch"] = _pcts([p[1] for p in probes])
    else:
        nd, nf, ds = (d1[0] - d0[0]), (d1[1] - d0[1]), (d1[2] - d0[2])
        result.update(stats)
        result.update({"frames_per_dispatch": nf / max(nd, 1), "dispatches_per_s": nd / (t1 - t0),
                       "pump_busy_share": ds / (t1 - t0)})

    # every published revolution against the CPU replay of the recording
    t_replay = time.perf_counter()
    stamps = {m.stamp for m in msgs}
    replay, every_rev = _e2e_replay(arm, path, timing, tap, deskew)
    rts = np.array([stamp for _o, stamp in replay])
    check(rts.size > 0, f"e2e {name}: the replay completed no revolution")
    # host stamps are the same float64 sums live and replayed, or the FSM's
    # clock for a revolution of duration <= 0; fused ones are float32
    # offsets from each dispatch's base, the node's bases since the replay
    # is fed the node's runs.  Matched in order: the fused arm hands on a
    # revolution read at once and the next one under one stamp
    check(len(clouds) == len(msgs), f"e2e {name}: {len(msgs)} scans but {len(clouds)} clouds")
    k = -1
    for msg, cloud in zip(msgs, clouds):
        after = np.flatnonzero(rts[k + 1 :] == msg.stamp)
        check(after.size > 0,
              f"e2e {name}: published revolution at {msg.stamp} is not in the replay after its "
              f"revolution {k}: nearest {rts[int(np.argmin(np.abs(rts - msg.stamp)))]}, "
              f"{len(rts)} replayed for {len(msgs)} published, {tap.restamped} restamped")
        k += 1 + int(after[0])
        o = replay[k][0]
        for field, got, want in (
            ("ranges", msg.ranges, o.ranges), ("intensities", msg.intensities, o.intensities),
            ("voxel", cloud.voxel, o.voxel),
            ("points_xy", cloud.points_xy, o.points_xy[o.point_mask]),
        ):
            check(_bits_equal(got, want),
                  f"e2e {name}: revolution at {msg.stamp}: {field} differs from the CPU replay")
    # revolutions completed between the first and the last publish that
    # were never published (host: never grabbed by the FSM; fused: a
    # dropped result), counted and printed
    if arm == "host":
        grabbed = sorted({i for i, _t, _d, _s in tap.grabs})
        dropped_live = grabbed[-1] - grabbed[0] + 1 - len(grabbed) if grabbed else 0
    else:
        lo, hi = min(stamps), max(stamps)
        dropped_live = sum(1 for ts0 in every_rev if lo <= ts0 <= hi and ts0 not in stamps)
    result.update({"matched_replay": len(msgs), "restamped": tap.restamped,
                   "dropped_live": dropped_live,
                   "replay_revolutions": len(every_rev),
                   "replay_s": time.perf_counter() - t_replay})
    return result


def phase_e2e(device) -> dict:
    """bench.py config 6 through the node, on the live wire path: the
    package's SimulatedDevice at 1x pace (800 DenseBoost frames/s, 3200
    points a turn) -> loopback TCP -> the native channel and transceiver ->
    the protocol engine -> RealLidarDriver -> RPlidarNode (launch,
    pipelined publish) with the host ingest (the chain, B1), the fused
    ingest (B1) and the fused ingest with de-skew (B1, B4, B5).  Runs
    before any profiler session (CUPTI would inflate the host times)."""
    result = {"phase": "e2e", "geometry": E2E}
    with tempfile.TemporaryDirectory() as tmp:
        for arm, deskew in (("host", False), ("fused", False), ("fused", True)):
            result[arm + ("_deskew" if deskew else "")] = _e2e_arm(device, arm, deskew, tmp)
    emit(result)
    return result


def phase_node(device) -> dict:
    """The user's entry point: launch_lifecycle in dummy mode on the card."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.driver.dummy import synth_scan
    from rplidar_ros2_driver_tpu_torch.launch import launch_lifecycle
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.ops.ascend import apply_angle_compensation
    from rplidar_ros2_driver_tpu_torch.ops.laserscan import to_laserscan

    result = {"phase": "node"}
    map_yaml = "    map_enable: true\n    map_grid: 256\n    map_cell_m: 0.05\n"
    with tempfile.TemporaryDirectory() as tmp:
        for name, chain_yaml, extra in (("chain", "[clip, polar, median, voxel]", ""),
                                        ("raw", "[]", ""),
                                        ("map", "[clip, polar, median, voxel]", map_yaml)):
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                f.write(
                    "rplidar_node:\n  ros__parameters:\n"
                    "    dummy_mode: true\n"
                    f"    filter_chain: {chain_yaml}\n"
                    "    filter_window: 64\n"
                    # the default filter_backend is the card
                    + ("" if device.type == "cuda" else "    filter_backend: cpu\n")
                    + extra
                )
            mk.reset_launch_counts()
            smk.reset_launch_counts()
            node = launch_lifecycle(path)
            try:
                check(node.lifecycle_state is LifecycleState.ACTIVE, f"{name} node not ACTIVE")
                if name == "map":
                    check(node.mapper.backend == "fused" and node.mapper.device == device,
                          "node mapper is not the fused mapper on the card")
                    check(node.mapper.cfg.match_backend == "pallas",
                          "auto did not resolve to the matcher kernels")
                if name != "raw":
                    check(node.chain.device == device, "node chain is not on the card")
                    check(node.chain.cfg.median_backend == "pallas", "auto did not resolve to B1")
                else:
                    check(node.raw_device == device, "raw path is not on the card")
                time.sleep(3.0 if name == "chain" else 1.5)
                node._update_diagnostics()
                pub = node.publisher
                n1 = pub.scan_count
                check(n1 > 0, f"{name} node published no scans")
                check(node.diagnostics.last.message == "Scanning",
                      f"{name} diagnostics say {node.diagnostics.last.message!r}")
                ranges = pub.scans[-1].ranges
                fin = np.isfinite(ranges)
                check(fin.any() and float(np.abs(ranges[fin] - 2.0).max()) < 0.6,
                      f"{name} node ranges off the dummy's 2 m +/- 0.5 m ring")
                info = {"scans": n1}
                if name == "chain":
                    check(mk.launch_counts["temporal_median"] > 0, "node never launched B1")
                    check(int(pub.clouds[-1].voxel.sum()) > 0, "node voxel grid empty")
                    info["b1_launches"] = mk.launch_counts["temporal_median"]
                    filled = int(node.chain.state.filled)
                    check(node.deactivate() and node.activate(), "deactivate/activate failed")
                    time.sleep(1.0)
                    check(pub.scan_count > n1, "no scans after re-activation")
                    check(int(node.chain.state.filled) >= filled, "window lost on re-activation")
                    info["scans_after_reactivate"] = pub.scan_count
                    info["filter_p99_ms"] = node.tracer.percentile("filter", 99.0) * 1e3
                if name == "map":
                    check(len(pub.poses) > 0, "map node published no poses")
                    last = pub.poses[-1]
                    check(last.matched_points > 0, "map node poses matched no points")
                    launched = dict(smk.launch_counts)
                    check(all(v > 0 for v in launched.values()),
                          f"map node did not launch every matcher kernel: {launched}")
                    rev = int(node.mapper.snapshot()["revision"][0])
                    check(node.deactivate() and node.activate(), "deactivate/activate failed")
                    time.sleep(1.0)
                    rev2 = int(node.mapper.snapshot()["revision"][0])
                    check(rev2 > rev and pub.poses[-1].map_revision > rev,
                          f"map revision did not grow across re-activation ({rev} -> {rev2})")
                    info.update(poses=len(pub.poses), revision_before=rev, revision_after=rev2,
                                matcher_launches=launched,
                                map_p99_ms=node.tracer.percentile("map", 99.0) * 1e3)
                result[name] = info
            finally:
                node.shutdown()
            check(node.lifecycle_state is LifecycleState.FINALIZED, f"{name} node not FINALIZED")

    # the raw path's conversion on the card equals the CPU's
    scan = synth_scan(0.3)
    for sp in (False, True):
        ls = [
            to_laserscan(apply_angle_compensation(scan.to(dev), True), 0.1, 40.0,
                         scan_processing=sp)
            for dev in (device, torch.device("cpu"))
        ]
        for f in ("ranges", "intensities", "beam_count", "angle_increment", "time_increment"):
            ok, _ = exact(getattr(ls[0], f).cpu(), getattr(ls[1], f))
            check(ok, f"raw to_laserscan {f} differs between card and CPU (mode A={sp})")
    emit(result)
    return result


def room_fleet_ticks(streams: int, beams: int, n_ticks: int):
    """The config-12/14 scene (bench.py _room_fleet_ticks): a 5x5 m square
    room seen from per-stream drifting poses, B rays cast to the walls in
    the sensor frame, one (N, B, 2) float32 plane per tick; drift is one to
    two cells per tick.  Returns (ticks, truth_pose)."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import room_pose, room_ticks

    return room_ticks(streams, beams, n_ticks), room_pose


def _map_params(backend: str, map_backend: str = "fused", **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    kw = dict(filter_backend=backend, filter_chain=("clip", "median", "voxel"), map_enable=True,
              map_backend=map_backend, map_grid=MAPPING["grid"], map_cell_m=MAPPING["cell_m"],
              map_match_window=MAPPING["window_m"])
    kw.update(over)
    return DriverParams(**kw)


def _map_fixtures(rng):
    """(name, MapConfig, log_odds (N, G, G), pose (N, 3), pq (N, B, 2), ok
    (N, B)) of the kernels' edge cases and the grid range, fleets of 1, 3
    and 4 streams (the JAX suite's fixtures, stacked over streams)."""
    import dataclasses

    import numpy as np

    from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
        PQ_LIMIT,
        SUB,
        MapConfig,
        min_quant_shift,
    )

    def cfg_of(grid, beams, clamp_q=8192, **kw):
        kw.setdefault("quant_shift", min_quant_shift(clamp_q, beams))
        return MapConfig(grid=grid, cell_m=0.1, beams=beams, clamp_q=clamp_q, **kw)

    def rand(cfg, n, beams):
        g = cfg.grid
        lo = rng.integers(-cfg.clamp_q, cfg.clamp_q + 1, (n, g, g), np.int32)
        for i in range(n):
            lo[i, rng.integers(0, g, g), rng.integers(0, g, g)] = cfg.clamp_q
        lim = cfg.t_limit_sub
        pose = np.stack([rng.integers(-lim // 2, lim // 2, n), rng.integers(-lim // 2, lim // 2, n),
                         rng.integers(0, cfg.theta_divisions, n)], 1).astype(np.int32)
        span = min((g // 2) * SUB, PQ_LIMIT)
        pq = rng.integers(-span, span + 1, (n, beams, 2)).astype(np.int32)
        ok = rng.uniform(size=(n, beams)) > 0.15
        return lo, pose, pq, ok

    out = []
    for grid, n, beams in ((8, 1, 192), (64, 3, 192), (256, 4, 2048), (1024, 1, 2048), (92, 3, 192),
                           (44, 4, 192), (24, 3, 192), (1024, 4, 2048)):
        cfg = cfg_of(grid, beams)
        out.append((f"random_g{grid}_n{n}", cfg, *rand(cfg, n, beams)))
    cfg = cfg_of(64, 192)
    lo, pose, pq, ok = rand(cfg, 3, 192)
    out.append(("all_invalid", cfg, lo, pose, pq, np.zeros_like(ok)))
    one = np.zeros_like(ok)
    one[:, 0] = True
    out.append(("single_valid_beam", cfg, lo, pose, pq, one))
    cfg1 = cfg_of(64, 1)
    out.append(("one_beam_config", cfg1, *rand(cfg1, 4, 1)))
    far = np.asarray([[PQ_LIMIT, PQ_LIMIT], [-PQ_LIMIT, PQ_LIMIT], [PQ_LIMIT, -PQ_LIMIT],
                      [-PQ_LIMIT, -PQ_LIMIT], [PQ_LIMIT, 0], [0, -PQ_LIMIT]] + [[0, 0]] * 186,
                     np.int32)
    out.append(("far_points", cfg, rng.integers(0, 8193, (3, 64, 64)).astype(np.int32),
                np.asarray([[0, 0, 0], [0, 0, 137], [0, 0, 359]], np.int32),
                np.repeat(far[None], 3, 0), np.ones((3, 192), bool)))
    center_beam = np.zeros((1, 192), bool)
    center_beam[0, 0] = True
    out.append(("uniform_map_tie", cfg, np.full((1, 64, 64), 4096, np.int32),
                np.zeros((1, 3), np.int32), np.zeros((1, 192, 2), np.int32), center_beam))
    pair = np.zeros((1, 64, 64), np.int32)
    for d in (2, 6):
        pair[0, 32 - d, 32] = pair[0, 32 + d, 32] = 4096
    out.append(("two_way_tie", cfg, pair, np.zeros((1, 3), np.int32),
                np.zeros((1, 192, 2), np.int32), center_beam))
    sat = MapConfig(grid=64, cell_m=0.1, beams=2048, clamp_q=16384,
                    quant_shift=min_quant_shift(16384, 2048))
    out.append(("saturated_min_quant_shift", sat, np.full((4, 64, 64), 16384, np.int32),
                np.zeros((4, 3), np.int32), np.zeros((4, 2048, 2), np.int32),
                np.ones((4, 2048), bool)))
    for name, over in (("free_samples_0", dict(free_samples=0)),
                       ("other_increments", dict(hit_q=300, miss_q=-1000, free_samples=7,
                                                 window_cells=3, fine_radius=2,
                                                 theta_window=3))):
        c2 = dataclasses.replace(cfg, **over)
        out.append((name, c2, *rand(c2, 3, 192)))
    # B6/B7's cluster splits: B off the per-block share, B below the cluster
    for name, grid, n, beams in (("share_ragged_n4", 256, 4, 2047),
                                 ("share_ragged_n1", 256, 1, 1001),
                                 ("beams_below_cluster", 64, 1, 5)):
        c2 = cfg_of(grid, beams)
        out.append((name, c2, *rand(c2, n, beams)))
    # r and w off the register path's instantiations (the shared-memory
    # accumulators; 12 and 20 walk their candidate rows in chunks)
    for name, over in (("radius_1_window_1", dict(window_cells=1, fine_radius=1)),
                       ("radius_3_window_5", dict(window_cells=5, fine_radius=3)),
                       ("radius_0_window_0", dict(window_cells=0, fine_radius=0)),
                       ("radius_20_window_12", dict(window_cells=12, fine_radius=20))):
        c2 = dataclasses.replace(cfg, **over)
        out.append((name, c2, *rand(c2, 3, 192)))
    # the pooled map's routes: staged as int16 up to mq = 32767, the direct
    # route above and where the pooled map does not fit in shared memory
    for name, grid, coarse, clamp_q, beams in (("int16_edge", 256, 4, 32767, 63),
                                               ("direct_edge", 256, 4, 32768, 63),
                                               ("direct_g1024", 1024, 4, 65536, 31),
                                               ("direct_coarse_2_g1024", 1024, 2, 8192, 2048)):
        c2 = cfg_of(grid, beams, clamp_q=clamp_q, coarse=coarse)
        lo, pose, pq, ok = rand(c2, 2, beams)
        lo[0, : grid // 2] = clamp_q                    # a saturated half
        out.append((name, c2, lo, pose, pq, ok))
    # the loop closure's candidate scoring: the derived match config
    # (quant_shift 0, the clamp at the stored plane's ceiling, w = 4 — B6's
    # shared-memory sums with the int16 pooled map — and T = 17) at config
    # 17's check (4 streams x 2 candidates, 128² map, 1024 beams; B7's plan
    # a cluster of 1) and at the node's (1 x 2, 256², 2048 beams); stored
    # planes hold [0, ceiling], one of them saturated
    for name, grid, n, beams in (("loop_config17", 128, 8, 1024), ("loop_node", 256, 2, 2048)):
        c2 = loop_match_config(grid, beams)
        lo, pose, pq, ok = rand(c2, n, beams)
        lo = np.clip(lo, 0, c2.clamp_q).astype(np.int32)
        lo[-1] = c2.clamp_q
        out.append((name, c2, lo, pose, pq, ok))
    return out


def _map_kernel_args(cfg, lo, pose, pq, ok, device):
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, rotation_table

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    posec = (pose[:, :2] + (cfg.grid // 2) * SUB).astype(np.int32)
    trig = rotation_table(cfg.theta_divisions)[pose[:, 2]]
    return t(lo), t(pq), t(ok), t(posec), t(trig), t(pose)


def match_tick(device, n: int):
    """The matcher's inputs at a fleet tick of ``n`` streams (config 12's
    mapper: 256x256 at 0.05 m, 2048 beams, window 0.4 m): the map of 5
    ticks of the room scene, the scan of the next tick, the state's pose.
    n=4 is config 12's tick, n=1 the map replay's (replay --map runs the
    same mapper geometry, one stream).  Returns (cfg, args of B6, args of
    B7 but ``mq``, ``mq``) on the card."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    b = MAPPING["beams"]
    ticks, _truth = room_fleet_ticks(n, b, 6)
    mapper = FleetMapper(_map_params("cuda"), n, beams=b, device=device)
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    for pts in ticks[:5]:
        mapper.submit_points(pts, masks, live)
    cfg = mapper.cfg
    snap = mapper.snapshot()
    pq, okm = tsm.quantize_points(torch.from_numpy(ticks[5]).to(device),
                                  torch.from_numpy(masks).to(device), cfg)
    lo_t, _, _, posec, trig, pose_t = _map_kernel_args(
        cfg, snap["log_odds"], snap["pose"], pq.cpu().numpy(), okm.cpu().numpy(), device)
    cos_q, sin_q = tsm._theta_trig(pose_t, cfg)
    coarse = (lo_t, pq, okm, posec, trig)
    mq, _sc = smk.coarse_scores_plain(*coarse, cfg)
    uv = torch.zeros((n, 2), dtype=torch.int32, device=device)
    return cfg, coarse, (pq, okm, posec, cos_q, sin_q, uv), mq


def fine_cells(fine, cfg) -> int:
    """The distinct in-map cells of ``mq`` that B7 reads at its inputs
    ``fine`` (its arguments but ``mq``): the four bilinear corners of every
    valid beam at every θ candidate and fine offset, counted once a stream
    — the least of ``mq`` that B7 must move (it gathers, it does not scan)."""
    import torch

    from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, SUB_BITS, rotate_rows

    pq, ok, posec, cos_q, sin_q, uv = fine
    g, r, csub = cfg.grid, cfg.fine_radius, cfg.coarse * SUB
    rx, ry = rotate_rows(pq[:, None, :, 0], pq[:, None, :, 1], cos_q[..., None], sin_q[..., None])
    cx = (rx + (posec[:, 0] + uv[:, 0] * csub)[:, None, None]) >> SUB_BITS    # (N, T, B)
    cy = (ry + (posec[:, 1] + uv[:, 1] * csub)[:, None, None]) >> SUB_BITS
    # the offsets -r..r and each one's upper corner: -r..r+1 on both axes
    sh = torch.arange(-r, r + 2, dtype=torch.int32, device=pq.device)
    cells = 0
    for i in range(pq.shape[0]):
        x, y = torch.broadcast_tensors(cx[i][:, ok[i]][..., None, None] + sh[:, None],
                                       cy[i][:, ok[i]][..., None, None] + sh[None, :])
        x, y = x.reshape(-1), y.reshape(-1)
        inside = (x >= 0) & (x < g) & (y >= 0) & (y < g)
        cells += int(torch.unique(x[inside].long() * g + y[inside]).numel())
    return cells


def match_bounds(cfg, n: int, nvalid: int, fine) -> dict:
    """(ms, by) of B6, B7, B8 at a tick of ``n`` streams with ``nvalid``
    valid beams, ``fine`` B7's arguments but ``mq``: bytes over HBM, int32
    operations over the int32 rate."""
    b, g, u = cfg.beams, cfg.grid, 2 * cfg.window_cells + 1
    t, f = 2 * cfg.theta_window + 1, 2 * cfg.fine_radius + 1
    scan_bytes = n * b * 9 + n * 16                    # pq, ok, posec, trig
    return {
        # read the map and the scan once, write mq and the (U, V) plane;
        # clip/shift/pool each cell, 8 int32 ops per corner per candidate
        "coarse_scores": bound(2 * n * g * g * 4 + scan_bytes + n * u * u * 4,
                               3 * n * g * g + 8 * u * u * nvalid, int32=True),
        # read the cells of mq the scan's candidates gather and the scan,
        # write the (T, F, F) volume; 8 int32 ops per corner per candidate
        "fine_scores": bound(fine_cells(fine, cfg) * 4 + scan_bytes + 8 * n * t
                             + n * t * f * f * 4, 8 * t * f * f * nvalid, int32=True),
        # read and write the map once; mark 1 + S cells per valid beam,
        # 3 ops per cell for delta and clamp
        "log_odds_update": bound(2 * n * g * g * 4 + scan_bytes,
                                 4 * (1 + cfg.free_samples) * nvalid + 3 * n * g * g,
                                 int32=True),
    }


def _map_tick_calls(cfg, coarse, fine, mq) -> dict:
    """B6, B7 and B8 at one ``match_tick``'s inputs: name -> (kernel call,
    plain call)."""
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    return {
        "coarse_scores": (lambda: smk.coarse_scores_kernel(*coarse, cfg),
                          lambda: smk.coarse_scores_plain(*coarse, cfg)),
        "fine_scores": (lambda: smk.fine_scores_kernel(mq, *fine, cfg),
                        lambda: smk.fine_scores_plain(mq, *fine, cfg)),
        "log_odds_update": (lambda: smk.log_odds_update_kernel(*coarse, cfg),
                            lambda: smk.log_odds_update_plain(*coarse, cfg)),
    }


def check_map_kernels(device, rng) -> dict:
    """B6, B7 and B8 against their plain versions on ``device`` (exact)
    over the fixtures (B8 also over its stripe edges, on both routes and
    every cluster size), an offset view and config 12's and the map
    replay's ticks: the mapkernels phase's checks, which ``--pod-cards``
    also runs on every card (B6-B8 set up their cluster launches once per
    card).  Returns the largest errors, what was checked and the two
    ticks' inputs (``shapes``: N -> (cfg, coarse, fine, mq))."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.tools import update_plans as up

    names = ("coarse_scores", "fine_scores", "log_odds_update")
    max_err = {k: 0.0 for k in names}

    def same(name, got, want, what):
        ok, err = exact(got, want)
        max_err[name] = max(max_err[name], err)
        check(ok, f"{name} differs from its plain version on {what}: {err}")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    checked, plans = [], {}
    # B8's stripe edges on the card's own plans, free_samples 0, 1, 3 and 4
    edge_fixtures = [
        up.stripe_edge_fixture(rng, g, n, smk.update_plan(n, g, sms)[3], samples, samples == 4)
        for g, n in ((24, 3), (256, 4), (1024, 1)) for samples in (0, 1, 3, 4)]
    for name, cfg, lo, pose, pq, okm in _map_fixtures(rng) + edge_fixtures:
        lo_t, pq_t, ok_t, posec, trig, pose_t = _map_kernel_args(cfg, lo, pose, pq, okm, device)
        mq_k, sc_k = smk.coarse_scores_kernel(lo_t, pq_t, ok_t, posec, trig, cfg)
        mq_p, sc_p = smk.coarse_scores_plain(lo_t, pq_t, ok_t, posec, trig, cfg)
        same("coarse_scores", mq_k, mq_p, f"{name} (mq)")
        same("coarse_scores", sc_k, sc_p, f"{name} (scores)")
        cos_q, sin_q = tsm._theta_trig(pose_t, cfg)
        w = cfg.window_cells
        kbest = torch.argmax(sc_p.reshape(lo.shape[0], -1), dim=1).to(torch.int32)
        uv_best = torch.stack([kbest // (2 * w + 1) - w, kbest % (2 * w + 1) - w], 1)
        uv_rand = torch.from_numpy(rng.integers(-w, w + 1, (lo.shape[0], 2)).astype(np.int32))
        for uv in (uv_best, uv_rand.to(device)):
            same("fine_scores", smk.fine_scores_kernel(mq_k, pq_t, ok_t, posec, cos_q, sin_q, uv, cfg),
                 smk.fine_scores_plain(mq_p, pq_t, ok_t, posec, cos_q, sin_q, uv, cfg), name)
        same("log_odds_update", smk.log_odds_update_kernel(lo_t, pq_t, ok_t, posec, trig, cfg),
             smk.log_odds_update_plain(lo_t, pq_t, ok_t, posec, trig, cfg), name)
        n = lo.shape[0]
        t = 2 * cfg.theta_window + 1
        plans[name] = {
            "coarse": smk.coarse_plan(n, cfg.grid, cfg.coarse, w, cfg.clamp_q, cfg.quant_shift,
                                      sms),
            "fine": smk.fine_plan(n, t, cfg.fine_radius, sms),
            "update": smk.update_plan(n, cfg.grid, sms)}
        checked.append(f"{name}:N{n}")
    # B8 on both routes and every cluster size it is prepared for, stripes
    # of ceil(G / K) rows: grids that are not a multiple of 4 give stripes
    # whose ends are off the 16-byte words and off the bitmap's words (G=9,
    # coarse 1; G=18, coarse 2)
    swept = []
    for g, n, coarse in ((9, 2, 1), (18, 3, 2), (24, 1, 4), (256, 4, 4)):
        for local in (1, 0):
            k = 1
            while k <= smk.UPDATE_MAX_CLUSTER:
                plan = up.plan_for(local, k, g)
                name, cfg, lo, pose, pq, okm = up.stripe_edge_fixture(rng, g, n, plan[3], 4,
                                                                      k == 2, coarse)
                lo_t, pq_t, ok_t, posec, trig, _ = _map_kernel_args(cfg, lo, pose, pq, okm, device)
                out = torch.empty_like(lo_t)
                up.launch_update(lo_t, pq_t, ok_t, posec, trig, out, cfg, plan)
                same("log_odds_update", out,
                     smk.log_odds_update_plain(lo_t, pq_t, ok_t, posec, trig, cfg),
                     f"{name} route {local} cluster {k}")
                swept.append(f"{name}:route{local}:K{k}")
                k *= 2
    torch.cuda.synchronize(device)

    shapes = {}
    for n in (MAPPING["streams"], 1):
        cfg, coarse, fine, mq = match_tick(device, n)
        shapes[n] = (cfg, coarse, fine, mq)
    # config 12's tick, and the same map read through offset views: B6's
    # 16-byte loads give way to plain ones, B7 reads mq at any address
    cfg, coarse, fine, mq = shapes[MAPPING["streams"]]
    lo_t = coarse[0]
    buf = torch.empty(lo_t.numel() + 1, dtype=torch.int32, device=device)
    buf[1:].copy_(lo_t.reshape(-1))
    lo_off = buf[1:].view(lo_t.shape)
    check(lo_off.data_ptr() % 16 != 0 and lo_off.is_contiguous(), "offset view is aligned")
    for what, lo_in in (("the config-12 tick", lo_t), ("an offset view", lo_off)):
        mq_k, sc_k = smk.coarse_scores_kernel(lo_in, *coarse[1:], cfg)
        mq_p, sc_p = smk.coarse_scores_plain(lo_t, *coarse[1:], cfg)
        same("coarse_scores", mq_k, mq_p, f"{what} (mq)")
        same("coarse_scores", sc_k, sc_p, f"{what} (scores)")
        mq_in = mq_k
        if lo_in is lo_off:
            mq_in = torch.empty_like(buf)[1:].view(mq_k.shape)
            mq_in.copy_(mq_k)
        same("fine_scores", smk.fine_scores_kernel(mq_in, *fine, cfg),
             smk.fine_scores_plain(mq_p, *fine, cfg), what)
        same("log_odds_update", smk.log_odds_update_kernel(lo_in, *coarse[1:], cfg),
             smk.log_odds_update_plain(lo_t, *coarse[1:], cfg), what)

    for n, (cfg, coarse, fine, mq) in shapes.items():
        for name, (kern, plain) in _map_tick_calls(cfg, coarse, fine, mq).items():
            got, want = kern(), plain()
            for a, c in zip(got if name == "coarse_scores" else (got,),
                            want if name == "coarse_scores" else (want,)):
                same(name, a, c, f"the N={n} tick")
    return {"fixtures": checked, "update_plan_sweep": swept, "plans": plans,
            "max_abs_err": max_err, "shapes": shapes}


def phase_mapkernels(device, rng) -> dict:
    """B6, B7 and B8 against their plain versions on the card (exact),
    :func:`check_map_kernels`, then timed at config 12's fleet tick (N=4)
    and at the map replay's one-stream tick (N=1)."""
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    checks = check_map_kernels(device, rng)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    times, bounds, shape_of = {}, {}, {}
    for n, (cfg, coarse, fine, mq) in checks["shapes"].items():
        calls = _map_tick_calls(cfg, coarse, fine, mq)
        nvalid = int(coarse[2].sum())
        key = "config12" if n == MAPPING["streams"] else "replay_map"
        times[key] = {
            name: {
                "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=20, warmup=3),
                # no single PyTorch call computes a bilinear correlation
                # volume or the hit/free-space log-odds update
                "library_ms": None,
                "device_ms": device_ms(kern), "plain_device_ms": device_ms(plain, iters=10),
            }
            for name, (kern, plain) in calls.items()
        }
        bounds[key] = match_bounds(cfg, n, nvalid, fine)
        shape_of[key] = {"N": n, "G": cfg.grid, "B": cfg.beams, "U": 2 * cfg.window_cells + 1,
                         "T": 2 * cfg.theta_window + 1, "F": 2 * cfg.fine_radius + 1,
                         "valid_beams": nvalid,
                         "coarse_plan": smk.coarse_plan(n, cfg.grid, cfg.coarse, cfg.window_cells,
                                                        cfg.clamp_q, cfg.quant_shift, sms),
                         "fine_plan": smk.fine_plan(n, 2 * cfg.theta_window + 1,
                                                    cfg.fine_radius, sms),
                         "update_plan": smk.update_plan(n, cfg.grid, sms)}
    row = {"phase": "mapkernels", "fixtures": checks["fixtures"],
           "update_plan_sweep": checks["update_plan_sweep"], "plans": checks["plans"],
           "max_abs_err": checks["max_abs_err"], "times_ms": times, "shapes": shape_of,
           "bounds_ms": {s: {k: {"ms": v[0], "by": v[1]} for k, v in b.items()}
                         for s, b in bounds.items()}}
    emit(row)
    return {"max_abs_err": checks["max_abs_err"], "times": times, "bounds": bounds}


def phase_mapping(device) -> dict:
    """Config 12 on the card: FleetMapper fused with B6/B7/B8, 4 streams,
    one warm tick, then 20 ticks of the room scene; held equal to the host
    reference and the CPU torch arm; the drift must be tracked."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB

    n, b, k_ticks = MAPPING["streams"], MAPPING["beams"], MAPPING["ticks"]
    ticks, truth_pose = room_fleet_ticks(n, b, k_ticks)
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)

    def run(mapper, timed=False):
        traj = np.zeros((k_ticks, n, 3), np.int32)
        scores = np.zeros((k_ticks, n), np.int32)
        lat = []
        for k, pts in enumerate(ticks):
            t0 = time.perf_counter()
            ests = mapper.submit_points(pts, masks, live)
            lat.append(time.perf_counter() - t0)
            for s, est in enumerate(ests):
                traj[k, s], scores[k, s] = est.pose_q, est.score
        return traj, scores, mapper.snapshot(), lat

    card = FleetMapper(_map_params("cuda"), n, beams=b)
    check(card.backend == "fused" and card.device == device and card.cfg.match_backend == "pallas",
          "config 12 did not resolve to the fused mapper with the matcher kernels on the card")
    card.precompile()                                   # the warm tick
    torch.cuda.synchronize()
    smk.reset_launch_counts()
    t0 = time.perf_counter()
    traj, scores, snap, lat = run(card)
    wall = time.perf_counter() - t0
    launched = dict(smk.launch_counts)
    for name, count in launched.items():
        check(count == k_ticks, f"{name} launched {count} times for {k_ticks} fleet ticks")

    refs = {}
    for name in ("host", "cpu_torch"):
        r_traj, r_scores, r_snap, refs[name] = _ref(None, ref_mapping, name)
        check(np.array_equal(traj, r_traj) and np.array_equal(scores, r_scores),
              f"config-12 trajectory on the card differs from the {name} arm")
        for key in r_snap:
            check(r_snap[key].dtype == snap[key].dtype
                  and r_snap[key].tobytes() == snap[key].tobytes(),
                  f"config-12 snapshot key {key!r} differs from the {name} arm")

    # the plain arm on the card, end to end (same poses)
    plain = FleetMapper(_map_params("cuda", match_backend="xla"), n, beams=b)
    plain.precompile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_traj, _, _, p_lat = run(plain)
    plain_wall = time.perf_counter() - t0
    check(np.array_equal(p_traj, traj), "the plain arm on the card tracks other poses")

    cell = MAPPING["cell_m"]
    errs = []
    for s in range(n):
        x0, y0, _ = truth_pose(s, k_ticks - 1)
        got = traj[-1, s].astype(np.float64)
        errs += [abs(got[0] / SUB - x0 / cell), abs(got[1] / SUB - y0 / cell)]
    err_cells = float(np.mean(errs))
    check(err_cells < 2.0 * card.cfg.coarse,
          f"matcher lost the drift: mean |pose error| {err_cells:.2f} cells")
    check(int(scores[1:].min()) > 0, "a config-12 match was rejected after the first tick")

    # device busy per tick: a fresh warmed mapper, 20 ticks under the profiler
    prof_mapper = FleetMapper(_map_params("cuda"), n, beams=b)
    prof_mapper.precompile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(prof_mapper)
        prof_wall = time.perf_counter() - t0
    dev_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy_us = sum(ev.time_range.elapsed_us() for ev in dev_events)
    by_kernel = {}
    for ev in dev_events:
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    lat_ms = np.asarray(lat) * 1e3
    row = {
        "phase": "mapping", "streams": n, "grid": MAPPING["grid"], "beams": b, "ticks": k_ticks,
        "fleet_ticks_per_s": k_ticks / wall, "scans_per_s": k_ticks * n / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
        "max_ms": float(lat_ms.max()), "launches": launched,
        "launches_per_tick": {k: v / k_ticks for k, v in launched.items()},
        "plain_arm_ticks_per_s": k_ticks / plain_wall,
        "plain_arm_p50_ms": float(np.percentile(np.asarray(p_lat) * 1e3, 50)),
        "host_reference_ticks_per_s": k_ticks / refs["host"],
        "cpu_torch_ticks_per_s": k_ticks / refs["cpu_torch"],
        "pose_error_cells": err_cells, "matched": int((scores > 0).sum()),
        "profiled_wall_ms_per_tick": prof_wall / k_ticks * 1e3,
        "device_busy_ms_per_tick": busy_us / k_ticks / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "device_ops_per_tick": len(dev_events) / k_ticks,
        "top_device_ms_per_tick": [[k[:80], v / k_ticks / 1e3]
                                   for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]],
    }
    emit(row)
    return row


def ref_mapping(name: str) -> tuple:
    """The CPU reference of config 12's mapper: the ``host`` reference or
    the ``cpu_torch`` arm over the room's ticks — (trajectory, scores,
    snapshot, seconds)."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

    n, b, k_ticks = MAPPING["streams"], MAPPING["beams"], MAPPING["ticks"]
    params = (_map_params("cpu", "host") if name == "host"
              else _map_params("cpu", "fused", match_backend="pallas"))
    mapper = FleetMapper(params, n, beams=b)
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    traj = np.zeros((k_ticks, n, 3), np.int32)
    scores = np.zeros((k_ticks, n), np.int32)
    t0 = time.perf_counter()
    for k, pts in enumerate(room_fleet_ticks(n, b, k_ticks)[0]):
        for s, est in enumerate(mapper.submit_points(pts, masks, live)):
            traj[k, s], scores[k, s] = est.pose_q, est.score
    return traj, scores, mapper.snapshot(), time.perf_counter() - t0


@functools.cache
def replay_capture(seed: int) -> tuple:
    """Config 7's capture, built once a process (the references of the
    replay phases share it): the seeded DenseBoost frames and their
    revolutions, written with FrameRecorder and decoded on the host (the
    replay phase holds the card's decode of the same capture equal to
    it)."""
    from rplidar_ros2_driver_tpu_torch.replay import decode_recording

    frames = denseboost_frames(seed, REPLAY["revs"], REPLAY["points"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "denseboost.rplr")
        write_capture(path, frames)
        return frames, decode_recording(path, "cpu").revolutions()


def replay_revolutions(seed: int) -> list:
    """Config 7's revolutions, decoded on the host (:func:`replay_capture`)."""
    return replay_capture(seed)[1]


def _replay_map_params(backend: str):
    # replay --map's mapper: the defaults (256x256 at 0.05 m), auto backend
    return _replay_params(backend, map_enable=True, map_backend="auto")


def ref_replay_map(seed: int) -> tuple:
    """The CPU reference of the map replay: config 7's revolutions through
    replay_with_map on the host (the host reference mapper) — trajectory,
    scores, snapshot, the mapper's backend and the seconds."""
    from rplidar_ros2_driver_tpu_torch.replay import replay_with_map

    revs = replay_revolutions(seed)
    t0 = time.perf_counter()
    traj, scores, mapper = replay_with_map(revs, _replay_map_params("cpu"), beams=REPLAY["beams"],
                                           capacity=REPLAY["capacity"], chunk=REPLAY["chunk"])
    return traj, scores, mapper.snapshot(), mapper.backend, time.perf_counter() - t0


def phase_replay_map(device, revs, seed: int) -> dict:
    """The config-7 capture's revolutions through replay_with_map on the
    card (chain with B3, fused mapper with B6/B7/B8), held equal to the CPU
    replay with the host reference mapper."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.replay import replay_through_chain, replay_with_map

    kw = dict(beams=REPLAY["beams"], capacity=REPLAY["capacity"], chunk=REPLAY["chunk"])
    params = _replay_map_params
    replay_with_map(revs[:8], params("cuda"), **kw)     # warm-up: builds, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay_through_chain(revs, params("cuda"), **kw)
    chain_wall = time.perf_counter() - t0
    mk.reset_launch_counts()
    smk.reset_launch_counts()
    t0 = time.perf_counter()
    traj, scores, mapper = replay_with_map(revs, params("cuda"), **kw)
    wall = time.perf_counter() - t0
    launched = {**mk.launch_counts, **smk.launch_counts}
    k = len(revs)
    check(mapper.backend == "fused" and mapper.cfg.match_backend == "pallas",
          "replay --map did not run the fused mapper with the matcher kernels")
    for name in ("coarse_scores", "fine_scores", "log_odds_update"):
        check(launched[name] == k, f"{name} launched {launched[name]} times for {k} scans")
    check(launched["sliding_median"] == -(-k // REPLAY["chunk"]), "B3 launches on the map replay")

    c_traj, c_scores, c_snap, c_backend, cpu_wall = _ref(None, ref_replay_map, seed)
    check(c_backend == "host", "the CPU replay did not use the host reference")
    check(traj.tobytes() == c_traj.tobytes(), "card map replay trajectory differs from the CPU's")
    check(np.array_equal(scores, c_scores), "card map replay scores differ from the CPU's")
    snap = mapper.snapshot()
    for key in c_snap:
        check(snap[key].tobytes() == c_snap[key].tobytes(),
              f"card map replay snapshot key {key!r} differs from the CPU's")
    check(int((scores > 0).sum()) > k // 2, "most map replay scans were not matched")
    check(int((snap["log_odds"][0] > 0).sum()) > 0, "empty map after the replay")
    row = {
        "phase": "replay_map", "scans": k, "map_grid": mapper.cfg.grid, "beams": REPLAY["beams"],
        "wall_s": wall, "scans_per_s": k / wall, "chain_scans_per_s": k / chain_wall,
        # derived: the whole replay's wall less a chain-only replay's
        "mapper_scans_per_s": k / max(wall - chain_wall, 1e-9),
        "cpu_host_replay_scans_per_s": k / cpu_wall, "launches": launched,
        "matched": int((scores > 0).sum()), "occupied_cells": int((snap["log_odds"][0] > 0).sum()),
        "final_pose_m": [float(v) for v in traj[-1]],
    }
    emit(row)
    return row

# ---------------------------------------------------------------------------
# the SLAM back-end: loop closure, pose graph, world map
# ---------------------------------------------------------------------------


def _loop_params(backend: str, loop_backend: str, **over):
    """bench.py bench_loop_close's parameters at its full geometry."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    kw = dict(filter_backend=backend, filter_chain=("clip", "median", "voxel"), map_enable=True,
              map_backend="host", map_grid=LOOP["grid"], map_cell_m=LOOP["cell_m"],
              loop_enable=True, loop_backend=loop_backend, loop_submap_revs=LOOP["submap_revs"],
              loop_check_revs=LOOP["check_revs"], loop_max_submaps=LOOP["max_submaps"],
              loop_candidates=LOOP["candidates"], loop_weight=LOOP["weight"],
              pose_graph_max_constraints=LOOP["constraints"], pose_graph_iters=LOOP["iters"],
              world_map_enable=True)
    kw.update(over)
    return DriverParams(**kw)


def loop_match_config(grid: int, beams: int, cell_m: float = 0.05):
    """The loop engine's candidate-match MapConfig at a map geometry (the
    derived config: quant_shift 0, the clamp at the stored plane's ceiling,
    window 4, θ window 8), as the engine on the card resolves it."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
    from rplidar_ros2_driver_tpu_torch.slam.loop import loop_config_from_params

    p = DriverParams(filter_backend="cpu", filter_chain=("clip",), map_enable=True,
                     map_grid=grid, map_cell_m=cell_m, loop_enable=True)
    return loop_config_from_params(p, map_config_from_params(p, beams), "cuda").match


def _loop_arm(device, arm: str, trace, masks, world=None, guard: bool = True):
    """One arm of config 17: the scripted drifting front-end alone ("off")
    or with a LoopClosureEngine ("host", or "fused" on ``device``).  The
    fused arm times each check call, counts B6/B7 launches around the run
    (after precompile) and runs under ``guards.steady_state`` unless
    ``guard`` is False; every arm records the garbage collector's pauses."""
    import gc

    import torch

    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine
    from rplidar_ros2_driver_tpu_torch.tools.loop_drift import DriftingFrontEnd
    from rplidar_ros2_driver_tpu_torch.utils import guards

    backend = "cuda" if arm == "fused" else "cpu"
    p = _loop_params(backend, "host" if arm == "off" else arm)
    fe = DriftingFrontEnd(p, LOOP["streams"], LOOP["beams"], LOOP["submap_revs"])
    eng, check_ms = None, []
    if arm != "off":
        eng = LoopClosureEngine(p, fe)
        check(eng.backend == arm, f"loop engine resolved {eng.backend}, not {arm}")
        eng.precompile()
        if arm == "fused":
            check(eng.device == device and eng.cfg.match.match_backend == "pallas",
                  "the fused loop engine is not on the card with B6/B7")
            torch.cuda.synchronize()
            dispatch = eng._dispatch_check

            def timed(*args):
                t0 = time.perf_counter()
                out = dispatch(*args)          # ends in its one device->host copy
                check_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            eng._dispatch_check = timed
            if world is not None:
                eng.on_install = world.ingest_submap
    smk.reset_launch_counts()
    log, check_ticks = [], 0
    # the fused arm runs under the whole guards.steady_state, as bench.py
    # holds JAX's (nothing built, no new device segment, no undeclared
    # synchronisation: every blocking transfer of a check is declared)
    scope = (guards.steady_state(tag="loop phase fused arm") if arm == "fused" and guard
             else contextlib.nullcontext())
    gc_pauses, gc_start = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_start.append(time.perf_counter())
        elif gc_start:
            gc_pauses.append((info["generation"], (time.perf_counter() - gc_start.pop()) * 1e3))

    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        with scope:
            for pts, drifted in trace:
                ests = fe.submit(pts, masks, drifted)
                if eng is None:
                    continue
                sts = eng.observe(ests)
                check_ticks += any(s is not None for s in sts)
                log.append([None if s is None else (s.accepted, s.candidate, s.score,
                                                    s.matched_points,
                                                    tuple(int(v) for v in s.corrected_q),
                                                    s.constraints, s.dropped) for s in sts])
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t0
    gc_row = {"collections": [sum(1 for g, _ in gc_pauses if g == k) for k in range(3)],
              "pause_ms": sum(ms for _, ms in gc_pauses),
              "gen2_pause_ms": sum(ms for g, ms in gc_pauses if g == 2),
              "tracked_objects": len(gc.get_objects())}
    return {"engine": eng, "fe": fe, "log": log, "check_ticks": check_ticks, "wall_s": wall,
            "check_ms": check_ms, "launches": dict(smk.launch_counts), "gc": gc_row,
            "snap": None if eng is None else eng.snapshot()}


def _loop_kernel_inputs(eng, fe, trace, masks, device):
    """A real check's B6/B7 inputs at config 17's shape: the fused engine's
    final library, each stream's candidates at its final pose and the last
    revolution's scan, gathered as the check gathers them (N = streams x
    candidates).  Returns (cfg, B6's args, B7's args but mq, mq)."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.mapping.submap import select_candidates
    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    cfg = eng.cfg.match
    s, kc = eng.streams, eng.cfg.candidates
    snap = eng.snapshot()
    cand = np.stack([select_candidates(snap["anchors"][i], snap["valid"][i],
                                       int(snap["count"][i]), fe.pose[i], eng.cfg)
                     for i in range(s)])
    planes = snap["planes"][np.arange(s)[:, None], np.clip(cand, 0, None)].reshape(
        s * kc, cfg.grid, cfg.grid)
    pts = np.repeat(trace[-1][0], kc, axis=0)
    pose = np.repeat(fe.pose, kc, axis=0).astype(np.int32)
    pq, okm = tsm.quantize_points(torch.from_numpy(pts).to(device),
                                  torch.from_numpy(np.repeat(masks, kc, axis=0)).to(device), cfg)
    lo_t, _, _, posec, trig, pose_t = _map_kernel_args(cfg, planes, pose, pq.cpu().numpy(),
                                                       okm.cpu().numpy(), device)
    cos_q, sin_q = tsm._theta_trig(pose_t, cfg)
    coarse = (lo_t, pq, okm, posec, trig)
    mq, sc = smk.coarse_scores_plain(*coarse, cfg)
    w = cfg.window_cells
    kbest = torch.argmax(sc.reshape(s * kc, -1), dim=1).to(torch.int32)
    uv = torch.stack([kbest // (2 * w + 1) - w, kbest % (2 * w + 1) - w], 1)
    return cfg, coarse, (pq, okm, posec, cos_q, sin_q, uv), mq


def _loop_node(device) -> dict:
    """(e) The node with map_enable + loop_enable at its default widths on
    the card (256² map, 2048 beams, W=64), a dummy lidar at 50 revolutions
    a second: closure checks run through B6/B7, a checkpoint with its
    ``loop.*`` keys is saved and restored into a fresh node."""
    from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
    from rplidar_ros2_driver_tpu_torch.launch import launch_lifecycle
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop.yaml")
        with open(path, "w") as f:
            f.write("rplidar_node:\n  ros__parameters:\n    dummy_mode: true\n"
                    "    filter_chain: [clip, polar, median, voxel]\n    filter_window: 64\n"
                    "    map_enable: true\n    loop_enable: true\n")

        def factory():
            return DummyLidarDriver(scan_rate_hz=50.0)

        smk.reset_launch_counts()
        node = launch_lifecycle(path, driver_factory=factory)
        try:
            check(node.lifecycle_state is LifecycleState.ACTIVE, "loop node not ACTIVE")
            eng = node.loop
            check(eng is not None and eng.backend == "fused" and eng.device == device
                  and eng.cfg.match.match_backend == "pallas",
                  "node loop engine is not the fused engine on the card with B6/B7")
            t0 = time.perf_counter()
            while eng.checks < 2 and time.perf_counter() - t0 < 30.0:
                time.sleep(0.1)
            check(eng.checks >= 2, f"the loop node ran {eng.checks} closure checks in 30 s")
            check(node.deactivate(), "loop node deactivate failed")
            node._update_diagnostics()
            values = node.diagnostics.last.values
            check("Loop Closures" in values and "Loop Submaps" in values,
                  "the loop group is missing from /diagnostics")
            launched = dict(smk.launch_counts)
            revs = int(node.mapper.snapshot()["revision"][0])
            # B6/B7: one each a mapper tick and a check, and one each in
            # the mapper's and the engine's precompile
            want_launches = revs + eng.dispatch_count + 2
            check(launched["coarse_scores"] == want_launches
                  and launched["fine_scores"] == want_launches,
                  f"node B6/B7 launches {launched} != {revs} mapper ticks + "
                  f"{eng.dispatch_count} checks + 2 warm-ups")
            ckpt = os.path.join(tmp, "node.npz")
            check(node.save_checkpoint(ckpt), "loop node checkpoint not saved")
            saved, _meta = load_checkpoint(ckpt)
            check(any(k.startswith("loop.") for k in saved), "no loop.* keys in the checkpoint")
            want = eng.snapshot()
            info = {"checks": eng.checks, "dispatches": eng.dispatch_count,
                    "installs": eng.installs, "revolutions": revs,
                    "accepted": int(eng.closures_accepted.sum()),
                    "rejected": int(eng.closures_rejected.sum()), "launches": launched,
                    "diagnostics": {k: values[k] for k in ("Loop Closures", "Loop Submaps")},
                    "map_p99_ms": node.tracer.percentile("map", 99.0) * 1e3}
        finally:
            node.shutdown()
        fresh = launch_lifecycle(path, auto_activate=False, driver_factory=factory)
        try:
            check(fresh.load_checkpoint(ckpt), "the loop checkpoint did not load")
            got = fresh.loop.snapshot()
            check(all(got[k].tobytes() == want[k].tobytes() for k in want),
                  "the restored node's loop state differs from the saved one")
            info["restored_submaps"] = int(got["count"][0])
        finally:
            fresh.shutdown()
    return info


def _loop_replay_params(backend: str):
    return _replay_params(backend, map_enable=True, loop_enable=True)


def ref_loop_replay(seed: int) -> dict:
    """The CPU reference of the loop replay: replay_with_loop_closure over
    the config-7 capture's prefix on the host (the host references)."""
    from rplidar_ros2_driver_tpu_torch.replay import replay_with_loop_closure

    prefix = replay_revolutions(seed)[: LOOP["replay_revs"]]
    t0 = time.perf_counter()
    traj, corr, scores, mapper, eng = replay_with_loop_closure(
        prefix, _loop_replay_params("cpu"), beams=REPLAY["beams"], capacity=REPLAY["capacity"],
        chunk=REPLAY["chunk"])
    return {"traj": traj, "corr": corr, "scores": scores, "status": eng.status(),
            "snap": eng.snapshot(), "backends": (eng.backend, mapper.backend),
            "wall_s": time.perf_counter() - t0}


def _loop_replay(device, revs, seed: int) -> dict:
    """(f) replay_with_loop_closure over a prefix of the config-7 capture on
    the card (the chain with B3, the fused mapper, the fused loop engine),
    held equal to the CPU replay with the host references."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.replay import replay_with_loop_closure

    kw = dict(beams=REPLAY["beams"], capacity=REPLAY["capacity"], chunk=REPLAY["chunk"])
    prefix = revs[:LOOP["replay_revs"]]
    smk.reset_launch_counts()
    t0 = time.perf_counter()
    traj, corr, scores, mapper, eng = replay_with_loop_closure(prefix, _loop_replay_params("cuda"),
                                                               **kw)
    wall = time.perf_counter() - t0
    launched = dict(smk.launch_counts)
    check(eng.backend == "fused" and mapper.backend == "fused",
          "the card's loop replay did not run the fused mapper and engine")
    k = len(prefix)
    # one B6/B7 each a scan for the mapper, one each a check tick for the
    # engine (plus the engine's precompile)
    for name in ("coarse_scores", "fine_scores"):
        check(launched[name] == k + eng.dispatch_count + 1,
              f"{name} launched {launched[name]} times for {k} scans and "
              f"{eng.dispatch_count} checks")
    check(eng.checks > 0, "the loop replay ran no closure check")
    cpu = _ref(None, ref_loop_replay, seed)
    check(cpu["backends"] == ("host", "host"),
          "the CPU loop replay did not use the host references")
    check(traj.tobytes() == cpu["traj"].tobytes(), "loop replay trajectory differs from the CPU's")
    check(corr.tobytes() == cpu["corr"].tobytes(), "loop replay corrected trajectory differs")
    check(np.array_equal(scores, cpu["scores"]), "loop replay scores differ from the CPU's")
    check({**eng.status(), "backend": "host"} == cpu["status"],
          f"loop replay engine status differs: {eng.status()} != {cpu['status']}")
    snap, c_snap = eng.snapshot(), cpu["snap"]
    check(all(snap[key].tobytes() == c_snap[key].tobytes() for key in c_snap),
          "loop replay LoopState differs from the CPU's")
    return {"scans": k, "wall_s": wall, "scans_per_s": k / wall, "cpu_wall_s": cpu["wall_s"],
            "checks": eng.checks, "dispatches": eng.dispatch_count, "launches": launched,
            "status": eng.status(), "corrected_final_pose_m": [float(v) for v in corr[-1]]}


def _loop_trace() -> tuple:
    """Config 17's return-to-start drift trace: (trace, masks, true end)."""
    from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB
    from rplidar_ros2_driver_tpu_torch.tools.loop_drift import loop_drift_trace

    return loop_drift_trace(LOOP["streams"], LOOP["beams"], LOOP["revs"], SUB // 4,
                            LOOP["cell_m"])


def ref_loop_arm(arm: str) -> dict:
    """The CPU reference of config 17's ``off`` or ``host`` arm: its record
    with the front-end's end poses, the engine's corrected end poses and
    its device calls in place of the objects."""
    import numpy as np
    import torch

    trace, masks, _true_end = _loop_trace()
    got = _loop_arm(torch.device("cpu"), arm, trace, masks)
    eng, fe = got.pop("engine"), got.pop("fe")
    got["pose"] = np.array(fe.pose)
    got["corrected"] = None if eng is None else [eng.corrected_pose_q(i, fe.pose[i])
                                                 for i in range(LOOP["streams"])]
    got["dispatch_count"] = None if eng is None else eng.dispatch_count
    return got


def phase_loop(device, replay_revs, seed: int) -> dict:
    """Config 17 (bench.py bench_loop_close) at its full geometry on the
    card — 4 streams, 128² map at 0.05 m, 1024 beams, 48 revolutions of the
    return-to-start trace with SUB/4 of drift a revolution, submaps every 4,
    checks every 2, 16 submaps, 2 candidates, weight 8, 32 loop
    constraints, 256 sweeps — in three arms on identical inputs (off, host,
    fused on the card), then the node and the config-7 replay with
    loop_enable.  Checks (a)–(f) of the phase (module docstring)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
    from rplidar_ros2_driver_tpu_torch.mapping.tiles import publish_tiles
    from rplidar_ros2_driver_tpu_torch.mapping.worldmap import WorldMap, world_config_from_params
    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.ops.loop_close import LoopState, fleet_loop_close_step
    from rplidar_ros2_driver_tpu_torch.ops.pose_graph import fleet_solve_pose_graph
    from rplidar_ros2_driver_tpu_torch.ops.tile_quant import fuse_planes_np
    from rplidar_ros2_driver_tpu_torch.tools.loop_drift import end_error_cells

    s = LOOP["streams"]
    trace, masks, true_end = _loop_trace()
    p_world = _loop_params("cuda", "fused")
    map_cfg = map_config_from_params(p_world, LOOP["beams"])
    world = WorldMap(world_config_from_params(p_world, map_cfg), device=device)
    world.precompile()
    threads = sorted(t.name for t in threading.enumerate())
    arms = {arm: _ref(None, ref_loop_arm, arm) for arm in ("off", "host")}
    arms["fused"] = _loop_arm(device, "fused", trace, masks, world)
    # the same fused run without the guard, right after the guarded one:
    # what the guard itself costs a check, at this point of the script
    arms["fused_unguarded"] = _loop_arm(device, "fused", trace, masks, guard=False)
    off, host, fused = arms["off"], arms["host"], arms["fused"]
    eng = fused["engine"]
    bare = arms["fused_unguarded"]
    check(bare["log"] == fused["log"]
          and all(bare["snap"][k].tobytes() == fused["snap"][k].tobytes() for k in bare["snap"]),
          "the unguarded fused arm differs from the guarded one")

    # (a) host and fused: the same wires, corrected poses and final state
    check(host["log"] == fused["log"], "host and fused loop wires differ")
    check(all(host["snap"][k].tobytes() == fused["snap"][k].tobytes() for k in host["snap"]),
          "host and fused final LoopState differ")
    cor_h = host["corrected"]
    cor_f = [eng.corrected_pose_q(i, fused["fe"].pose[i]) for i in range(s)]
    check(all(np.array_equal(a, b) for a, b in zip(cor_h, cor_f)),
          "host and fused corrected end poses differ")
    # (b) drift bounded: corrected end error <= 2 cells, the baseline > 4
    base_err = max(end_error_cells(off["pose"][i], true_end[i]) for i in range(s))
    corr_err = max(end_error_cells(c, true_end[i]) for i, c in enumerate(cor_f))
    check(corr_err <= 2.0, f"corrected end error {corr_err:.3f} cells > 2")
    check(base_err > 4.0, f"baseline end error {base_err:.3f} cells is not > 4")
    check(int(eng.closures_accepted.sum()) > 0, "no closure accepted on the drift trace")
    # (c) one check call a check tick, one B6 and one B7 launch each
    ticks = fused["check_ticks"]
    check(eng.dispatch_count == ticks, f"{eng.dispatch_count} check calls for {ticks} check ticks")
    check(host["dispatch_count"] == 0, "the host arm made device calls")
    for name in ("coarse_scores", "fine_scores"):
        check(fused["launches"][name] == ticks,
              f"{name} launched {fused['launches'][name]} times for {ticks} check ticks")
    check(fused["launches"]["log_odds_update"] == 0, "the loop arm launched B8")
    # (d) the world map on the on_install tap: the card's accumulation is
    # the sum of its members' (aligned) planes; one publication equals
    # publish_tiles on the host sum
    members = [m.plane for m in world._members]
    acc = world.accumulation()
    host_sum = fuse_planes_np(members)
    check(world.merges == eng.installs, f"world merged {world.merges} of {eng.installs} installs")
    check(world._acc.device == device and acc.tobytes() == host_sum.tobytes(),
          "the card's world accumulation differs from fuse_planes_np of its members")
    snap_w = world.publish()
    want_w = publish_tiles(host_sum, world.cfg.tile, snap_w.version)
    check(all(np.array_equal(getattr(snap_w, f), getattr(want_w, f))
              for f in ("tile_ids", "values", "runs", "tile_nruns"))
          and snap_w.payload_bytes == want_w.payload_bytes,
          "the world publication differs from publish_tiles on the host sum")

    # the cost of a check: scoring (B6 + B7 through match_scan_volumes at
    # N = S x candidates) against the solver (256 sweeps for all streams)
    cfg_k, coarse, fine, mq = _loop_kernel_inputs(eng, fused["fe"], trace, masks, device)
    n_k = coarse[0].shape[0]
    for name, kern, plain in (
            ("coarse_scores", lambda: smk.coarse_scores_kernel(*coarse, cfg_k),
             lambda: smk.coarse_scores_plain(*coarse, cfg_k)),
            ("fine_scores", lambda: smk.fine_scores_kernel(mq, *fine, cfg_k),
             lambda: smk.fine_scores_plain(mq, *fine, cfg_k))):
        got, want = kern(), plain()
        for a, b in zip(got if name == "coarse_scores" else (got,),
                        want if name == "coarse_scores" else (want,)):
            ok, err = exact(a, b)
            check(ok, f"{name} differs from its plain version at the loop shape: {err}")
    nvalid = int(coarse[2].sum())
    bounds = match_bounds(cfg_k, n_k, nvalid, fine)
    shape = {"N": n_k, "G": cfg_k.grid, "B": cfg_k.beams, "U": 2 * cfg_k.window_cells + 1,
             "T": 2 * cfg_k.theta_window + 1, "F": 2 * cfg_k.fine_radius + 1,
             "valid_beams": nvalid, "clamp_q": cfg_k.clamp_q, "quant_shift": cfg_k.quant_shift}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shape["coarse_plan"] = smk.coarse_plan(n_k, cfg_k.grid, cfg_k.coarse, cfg_k.window_cells,
                                           cfg_k.clamp_q, cfg_k.quant_shift, sms)
    shape["fine_plan"] = smk.fine_plan(n_k, shape["T"], cfg_k.fine_radius, sms)
    kernel_times = {}
    for name, kern, plain in (
            ("coarse_scores", lambda: smk.coarse_scores_kernel(*coarse, cfg_k),
             lambda: smk.coarse_scores_plain(*coarse, cfg_k)),
            ("fine_scores", lambda: smk.fine_scores_kernel(mq, *fine, cfg_k),
             lambda: smk.fine_scores_plain(mq, *fine, cfg_k))):
        kernel_times[name] = {
            **shape, "ms": cuda_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": cuda_ms(plain, iters=20, warmup=3), "library_ms": None,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "launches": fused["launches"][name]}

    # one check of the final state (a copy) and its solver alone: events ms
    # (host-bound: eager operations) and device operations counted
    st = LoopState.from_numpy(fused["snap"], device)
    pts_t = torch.from_numpy(trace[-1][0]).to(device)
    masks_t = torch.from_numpy(masks).to(device)
    poses_t = torch.from_numpy(fused["fe"].pose.astype(np.int32)).to(device)
    cand_t = torch.zeros((s, LOOP["candidates"]), dtype=torch.int32, device=device)
    cand_t[:, 1] = 1
    check_t = torch.ones((s,), dtype=torch.int32, device=device)
    ks = torch.arange(eng.cfg.max_submaps, dtype=torch.int32, device=device)
    odom_rows = torch.stack([(ks - 1).clamp_min(0).expand(s, -1), ks.expand(s, -1),
                             st.odom[..., 0], st.odom[..., 1], st.odom[..., 2],
                             ((ks >= 1) & (ks < st.count[:, None])).to(torch.int32)], dim=2)
    all_cons = torch.cat([odom_rows, st.cons], dim=1)

    st_check = LoopState.from_numpy(fused["snap"], device)    # updated in place
    pose_k = torch.from_numpy(
        np.repeat(fused["fe"].pose, LOOP["candidates"], 0).astype(np.int32)).to(device)

    def one_check():
        fleet_loop_close_step(st_check, pts_t, masks_t, poses_t, cand_t, check_t, eng.cfg)

    def one_solve():
        fleet_solve_pose_graph(st.anchors, all_cons, eng.cfg.graph)

    def one_score():
        tsm.match_scan_volumes(coarse[0], pose_k, coarse[1], coarse[2], cfg_k)

    # host-bound calls: their times move between calls, so check and solver
    # alternate over 5 rounds and the split reads the rounds' medians
    rounds = {"check_ms": [], "solver_ms": [], "scoring_ms": []}
    for _ in range(5):
        rounds["check_ms"].append(cuda_ms(one_check, iters=3, warmup=1))
        rounds["solver_ms"].append(cuda_ms(one_solve, iters=3, warmup=1))
        rounds["scoring_ms"].append(cuda_ms(one_score, iters=20, warmup=3))
    split = {k: float(np.median(v)) for k, v in rounds.items()}
    split["rounds"] = rounds
    for name, fn in (("check", one_check), ("solver", one_solve), ("scoring", one_score)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # the named ranges (ops/loop_close.py) also appear on the device's
        # timeline as annotations spanning their kernels: not operations
        named = ("loop_close.solve", "loop_close.score")
        evs = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and ev.name not in named]
        split[f"{name}_device_ops"] = len(evs)
        split[f"{name}_device_ms"] = sum(ev.time_range.elapsed_us() for ev in evs) / 1e3
        if name == "check":
            # one check's host time by its named ranges, under the
            # profiler: the solver's and the scoring's shares
            ranges = {ev.name: ev.cpu_time_total for ev in prof.events()
                      if ev.device_type == DeviceType.CPU and ev.name in named}
            check(set(ranges) == set(named), f"the profiler lost a named range: {ranges}")
            split["profiled_check_wall_ms"] = wall_us / 1e3
            split["solver_host_share"] = ranges.get("loop_close.solve", 0.0) / wall_us
            split["scoring_host_share"] = ranges.get("loop_close.score", 0.0) / wall_us
    # the events of separate calls (host-bound, noisy), for scale only
    split["solver_share"] = split["solver_ms"] / split["check_ms"]
    check(split["check_device_ms"] > 0, "the profiler recorded no device time for a check")
    busy = max(split["check_device_ms"], 1e-9)
    split["solver_device_share"] = split["solver_device_ms"] / busy
    split["device_idle_share"] = 1.0 - busy / split["check_ms"]

    node = _loop_node(device)
    replay = _loop_replay(device, replay_revs, seed)

    def wall_ms(a):
        ms = np.asarray(a["check_ms"])
        return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)),
                "max": float(ms.max()), "n": int(ms.size)}

    row = {
        "phase": "loop", "streams": s, "grid": LOOP["grid"], "beams": LOOP["beams"],
        "revs": LOOP["revs"], "check_ticks": ticks, "dispatches": eng.dispatch_count,
        "checks": eng.checks, "installs": eng.installs,
        "accepted": int(eng.closures_accepted.sum()), "rejected": int(eng.closures_rejected.sum()),
        "baseline_end_err_cells": base_err, "corrected_end_err_cells": corr_err,
        "launches": fused["launches"],
        "check_wall_ms": wall_ms(fused), "check_wall_ms_unguarded": wall_ms(bare),
        "arm_wall_s": {a: arms[a]["wall_s"] for a in arms},
        "arm_gc": {a: arms[a]["gc"] for a in arms}, "threads_at_start": threads,
        "cost_split": split, "kernels_at_loop_shape": kernel_times,
        "world": world.status(), "node": node, "replay": replay,
    }
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the fused device ingest with de-skew (B4, B5)
# ---------------------------------------------------------------------------


def _deskew_rows(rng, rows: int, n: int):
    """Seeded node rows (the JAX kernel suite's distribution): angles,
    18-bit distances with 10% no-returns, qualities, 90% valid."""
    import numpy as np

    angle = rng.integers(0, 65536, (rows, n)).astype(np.int32)
    dist = rng.integers(0, 0x3FFFF, (rows, n)).astype(np.int32)
    dist[rng.random((rows, n)) < 0.1] = 0
    quality = rng.integers(0, 256, (rows, n)).astype(np.int32)
    valid = rng.random((rows, n)) < 0.9
    return angle, dist, quality, valid


def _beams_of(angle, nb: int):
    """The beam of each node angle (Q16 turn) among ``nb`` beams."""
    import numpy as np

    return np.clip((angle.astype(np.int64) * nb) // 65536, 0, nb - 1).astype(np.int32)


def _b4_path_inputs(rng, device):
    """B4's two shapes on the fused ingest path at config 7: the rasterizer
    (1 stream x 64 frames x 40 samples -> 2048 beams, packed range and
    quality) and the profiles (8 revolution slots x 4096 nodes -> 256
    beams, ranges); {name: (beam, values, nbeams)} on ``device``."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops.deskew import RECON_EMPTY as empty

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    a, d, q, v = _deskew_rows(rng, 1, 2560)
    raster = np.where(v & (d > 0), (d << 8) | q, empty).astype(np.int32)
    a2, d2, _q2, v2 = _deskew_rows(rng, 8, 4096)
    profile = np.where(v2 & (d2 > 0), d2, empty).astype(np.int32)
    return {"raster": (t(_beams_of(a, 2048)), t(raster), 2048),
            "profile": (t(_beams_of(a2, 256)), t(profile), 256)}


def _b5_path_inputs(rng, device):
    """B5's shape on the fused ingest path at config 7: 8 revolution slots'
    256-beam range profiles (B4's plain version over seeded nodes), the
    current ones the previous rolled by 3 beams with every 7th beam
    EMPTY, and the 17 shift candidates of shift window 8; (prev, cur,
    shifts) on ``device``."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import deskew as tdsk
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk

    a, d, _q, v = _deskew_rows(rng, 8, 4096)
    beam = torch.from_numpy(_beams_of(a, 256)).to(device)
    vals = torch.from_numpy(np.where(v & (d > 0), d, tdsk.RECON_EMPTY).astype(np.int32)).to(device)
    prev = dk.beam_min_plain(beam, vals, 256)
    cur = torch.roll(prev, 3, dims=1)
    cur[:, ::7] = tdsk.RECON_EMPTY
    cands = tdsk.shift_candidates(tdsk.DeskewConfig(recon_beams=256))
    return prev, cur.contiguous(), torch.from_numpy(cands).to(device)


def _scatter_min(beam, vals, nb: int):
    """One PyTorch call computing B4's per-beam min (scatter_reduce_ "amin"
    into a RECON_EMPTY-filled row), as a closure over its own buffers."""
    import torch

    from rplidar_ros2_driver_tpu_torch.ops.deskew import RECON_EMPTY

    shape = (vals.shape[0], nb)
    out = torch.full(shape, RECON_EMPTY, dtype=torch.int32, device=vals.device)
    idx = beam.long()
    return lambda: out.scatter_reduce_(1, idx, vals, reduce="amin", include_self=True)


def check_deskew_kernels(device, rng) -> dict:
    """B4 and B5 against their plain versions on ``device`` (exact) over
    the JAX kernel suite's geometries, degenerate inputs, the featureless
    tie, the redesigned kernels' edges and the fused ingest's own shapes:
    the deskew_kernels phase's checks, which ``--pod-cards`` also runs on
    every card.  Returns the largest errors, what was checked and the
    path's inputs on ``device`` (``path``: the rasterizer's and the
    profiles' (beam, values, nbeams) and B5's (prev, cur, shifts))."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import deskew as tdsk
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk

    empty = tdsk.RECON_EMPTY
    max_err = {"beam_min": 0.0, "shift_sad": 0.0}
    checked = {"beam_min": 0, "shift_sad": 0}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def b4(beam, vals, nb, what):
        b4t(t(beam), t(vals), nb, what)

    def b4t(b, v, nb, what):
        ok, err = exact(dk.beam_min_kernel(b, v, nb), dk.beam_min_plain(b, v, nb))
        max_err["beam_min"] = max(max_err["beam_min"], err)
        check(ok, f"B4 differs from its plain version ({what}): {err}")
        checked["beam_min"] += 1

    def b5(prev, cur, shifts, what, min_valid=16, max_trans=2048):
        p, c, sh = t(prev), t(cur), t(shifts)
        ok, err = exact(dk.shift_sad_kernel(p, c, sh, min_valid, max_trans),
                        dk.shift_sad_plain(p, c, sh, min_valid, max_trans))
        max_err["shift_sad"] = max(max_err["shift_sad"], err)
        check(ok, f"B5 differs from its plain version ({what}): {err}")
        checked["shift_sad"] += 1

    def packed(dist, quality, valid):
        return np.where(valid & (dist > 0), (dist << 8) | quality, empty).astype(np.int32)

    def profiles(angle, dist, valid, d):
        return dk.beam_min_plain(t(_beams_of(angle, d)),
                                 t(np.where(valid & (dist > 0), dist, empty).astype(np.int32)),
                                 d).cpu().numpy()

    # the four (recon_beams, profile_beams) geometries of the JAX suite
    for beams, prof in [(256, 64), (2048, 256), (100, 128), (8, 1024)]:
        cfg = tdsk.DeskewConfig(recon_beams=beams, profile_beams=prof,
                                shift_window=min(8, prof // 8))
        a, d, q, v = _deskew_rows(rng, 3, 600)
        b4(_beams_of(a, beams), packed(d, q, v), beams, f"rasterizer {beams}")
        b4(_beams_of(a, prof), np.where(v & (d > 0), d, empty).astype(np.int32), prof,
           f"profile {prof}")
        a2, d2, _q2, v2 = _deskew_rows(rng, 3, 600)
        b5(profiles(a, d, v, prof), profiles(a2, d2, v2, prof), tdsk.shift_candidates(cfg),
           f"D={prof}")
    # degenerate inputs: all EMPTY, one node, every node in one beam, node
    # counts off any block size, an empty row set
    b4(rng.integers(0, 256, (2, 77)).astype(np.int32), np.full((2, 77), empty, np.int32), 256,
       "all EMPTY")
    b4(np.asarray([[5]], np.int32), np.asarray([[1234]], np.int32), 256, "single node")
    b4(np.full((1, 513), 9, np.int32), rng.integers(0, 1 << 26, (1, 513)).astype(np.int32),
       256, "one beam")
    for n in (1, 255, 257, 1000, 4097):
        b4(rng.integers(0, 2048, (2, n)).astype(np.int32),
           rng.integers(0, 1 << 26, (2, n)).astype(np.int32), 2048, f"n={n}")
    b4(np.zeros((0, 16), np.int32), np.zeros((0, 16), np.int32), 16, "no rows")
    # the redesigned B4's edges: one beam and the most beams the wrapper
    # takes, beams out of range on both sides, rows whose length is off the
    # 16-byte loads (each row after the first starts off a boundary), views
    # that start off a boundary (beam and values at the same phase, and at
    # different phases), no node at all, and 16 rows
    b4(rng.integers(-2, 3, (3, 1000)).astype(np.int32),
       rng.integers(-(1 << 30), 1 << 30, (3, 1000)).astype(np.int32), 1, "nbeams=1")
    b4(rng.integers(0, 8192, (2, 9000)).astype(np.int32),
       rng.integers(0, 1 << 26, (2, 9000)).astype(np.int32), 8192, "nbeams=8192")
    b4(rng.integers(-300, 2348, (4, 2560)).astype(np.int32),
       rng.integers(0, 1 << 26, (4, 2560)).astype(np.int32), 2048, "beams out of range")
    for n in (2, 3, 5, 6, 7, 2561):
        b4(rng.integers(0, 256, (3, n)).astype(np.int32),
           rng.integers(0, 1 << 26, (3, n)).astype(np.int32), 256, f"3 rows of n={n}")
    for ob, ov in ((1, 1), (2, 2), (3, 3), (1, 2), (0, 3)):
        fb = t(rng.integers(0, 2048, 2 * 2560 + 4).astype(np.int32))
        fv = t(rng.integers(0, 1 << 26, 2 * 2560 + 4).astype(np.int32))
        b4t(fb[ob : ob + 2 * 2560].view(2, 2560), fv[ov : ov + 2 * 2560].view(2, 2560), 2048,
            f"views at element offsets beam {ob}, values {ov}")
    b4(np.zeros((2, 0), np.int32), np.zeros((2, 0), np.int32), 256, "no nodes")
    for nb in (256, 2048):
        b4(rng.integers(0, nb, (16, 4096)).astype(np.int32),
           rng.integers(0, 1 << 26, (16, 4096)).astype(np.int32), nb, f"16x4096 -> {nb}")
    cands = tdsk.shift_candidates(tdsk.DeskewConfig(recon_beams=256))
    flat = np.full((2, 256), 3000, np.int32)
    b5(flat, flat, cands, "featureless tie")
    b5(np.full((1, 64), empty, np.int32), np.full((1, 64), empty, np.int32), cands[:9],
       "all EMPTY")
    # the fused ingest's shapes at config 7: the rasterizer (1 stream x 64
    # frames x 40 samples -> 2048 beams), the profiles (8 revolution slots
    # x 4096 nodes -> 256 beams), the shift search (8 slots, C=17, D=256)
    a, d, q, v = _deskew_rows(rng, 1, 2560)
    r_beam, r_val = t(_beams_of(a, 2048)), t(packed(d, q, v))
    b4(r_beam.cpu().numpy(), r_val.cpu().numpy(), 2048, "rasterizer 1x2560x2048")
    a, d, _q, v = _deskew_rows(rng, 8, 4096)
    p_beam = t(_beams_of(a, 256))
    p_val = t(np.where(v & (d > 0), d, empty).astype(np.int32))
    b4(p_beam.cpu().numpy(), p_val.cpu().numpy(), 256, "profiles 8x4096x256")
    prev = profiles(a, d, v, 256)
    cur = np.roll(prev, 3, axis=1)
    cur[:, ::7] = empty
    b5(prev, cur, cands, "8 slots C=17 D=256")
    # the redesigned B5's edges: D off the 16-byte copies and off a warp's
    # 32 lanes (1, 3, 37, 100, 250) and the most the wrapper takes (6144);
    # shifts of 0, ±1, ±(D-1), ±D, ±(D+1), far beyond and the int32
    # extremes; C = 40 and 100, above a block's warps; one row; an
    # all-EMPTY row among others; views off a 16-byte boundary, prev and
    # cur at different phases; counts exactly at min_valid (and one short)
    b5_edges = 0
    for rows, d in ((1, 1), (3, 3), (2, 37), (5, 100), (1, 250), (8, 256), (2, 6144)):
        ep = rng.integers(0, 6000, (rows, d)).astype(np.int32)
        ec = rng.integers(0, 6000, (rows, d)).astype(np.int32)
        ep[rng.random((rows, d)) < 0.2] = empty
        ec[rng.random((rows, d)) < 0.2] = empty
        if rows > 2:
            ep[1] = empty
        far = [0, 1, -1, d - 1, -(d - 1), d, -d, d + 1, -(d + 1), 3 * d + 5, -7 * d - 3,
               2**31 - 1, -(2**31)]
        for name, sh in (("far shifts", np.asarray(far, np.int32)),
                         ("C=40", rng.integers(-3 * d, 3 * d + 1, 40).astype(np.int32)),
                         ("C=100", np.arange(-50, 50, dtype=np.int32))):
            b5(ep, ec, sh, f"rows={rows} D={d} {name}", min_valid=min(16, d), max_trans=1500)
            b5_edges += 1
    for op, oc in ((1, 1), (1, 2), (3, 0), (2, 3)):
        fp = t(rng.integers(0, 6000, 3 * 256 + 4).astype(np.int32))
        fc = t(rng.integers(0, 6000, 3 * 256 + 4).astype(np.int32))
        pv, cv = fp[op : op + 3 * 256].view(3, 256), fc[oc : oc + 3 * 256].view(3, 256)
        sh = t(cands)
        ok, err = exact(dk.shift_sad_kernel(pv, cv, sh, 16, 2048),
                        dk.shift_sad_plain(pv, cv, sh, 16, 2048))
        check(ok, f"B5 differs from its plain version (views at offsets {op}, {oc}): {err}")
        checked["shift_sad"] += 1
        b5_edges += 1
    for n_valid in (16, 37):
        ep = np.full((2, 256), empty, np.int32)
        ec = np.full((2, 256), empty, np.int32)
        ep[:, :n_valid] = rng.integers(0, 6000, (2, n_valid))
        ec[:, :n_valid] = rng.integers(0, 6000, (2, n_valid))
        for mv in (n_valid, n_valid + 1):
            b5(ep, ec, np.asarray([0, 1, -1, 256], np.int32), f"{n_valid} valid, min_valid {mv}",
               min_valid=mv)
            b5_edges += 1
    return {"checked": checked, "b5_edge_fixtures": b5_edges, "max_abs_err": max_err,
            "path": {"raster": (r_beam, r_val, 2048), "profile": (p_beam, p_val, 256),
                     "shift_sad": (t(prev), t(cur), t(cands))}}


def phase_deskew_kernels(device, rng) -> dict:
    """B4 and B5 against their plain versions on the card (exact),
    :func:`check_deskew_kernels`; then timed at the fused ingest's
    shapes."""
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk

    checks = check_deskew_kernels(device, rng)
    path = checks["path"]
    s_prev, s_cur, s_sh = path["shift_sad"]
    times = {}
    for name in ("raster", "profile"):
        bb, vv, nb = path[name]
        times[f"beam_min_{name}"] = {
            "ms": cuda_ms(lambda: dk.beam_min_kernel(bb, vv, nb)),
            "plain_ms": cuda_ms(lambda: dk.beam_min_plain(bb, vv, nb), iters=50),
            # one PyTorch call computing the same per-beam min
            "library_ms": cuda_ms(_scatter_min(bb, vv, nb)),
            "library_device_ms": device_ms(_scatter_min(bb, vv, nb)),
            "device_ms": device_ms(lambda: dk.beam_min_kernel(bb, vv, nb)),
            "plain_device_ms": device_ms(lambda: dk.beam_min_plain(bb, vv, nb), iters=20),
            "host_us": host_us(lambda: dk.beam_min_kernel(bb, vv, nb)),
            "library_host_us": host_us(_scatter_min(bb, vv, nb)),
            "bound": bound(bb.numel() * 8 + bb.shape[0] * nb * 4, bb.numel(), int32=True),
            "shape": [bb.shape[0], bb.shape[1], nb],
        }
    c, dd = s_sh.shape[0], s_prev.shape[1]
    times["shift_sad"] = {
        "ms": cuda_ms(lambda: dk.shift_sad_kernel(s_prev, s_cur, s_sh, 16, 2048)),
        "plain_ms": cuda_ms(lambda: dk.shift_sad_plain(s_prev, s_cur, s_sh, 16, 2048), iters=50),
        "library_ms": None,
        "device_ms": device_ms(lambda: dk.shift_sad_kernel(s_prev, s_cur, s_sh, 16, 2048)),
        "plain_device_ms": device_ms(lambda: dk.shift_sad_plain(s_prev, s_cur, s_sh, 16, 2048),
                                     iters=20),
        # after the profiler has run (the launch phase has the cost before)
        "host_us": host_us(lambda: dk.shift_sad_kernel(s_prev, s_cur, s_sh, 16, 2048)),
        # each profile read once, the scores written once; per (row, shift,
        # beam) two compares, a subtract, a clamp, an abs and two adds
        "bound": bound(2 * s_prev.numel() * 4 + c * 4 + s_prev.shape[0] * c * 4,
                       7 * s_prev.shape[0] * c * dd, int32=True),
        "shape": [s_prev.shape[0], c, dd],
    }
    row = {"phase": "deskew_kernels", "checked": checks["checked"],
           "b5_edge_fixtures": checks["b5_edge_fixtures"], "max_abs_err": checks["max_abs_err"],
           "times_ms": times}
    emit(row)
    return row


def _tick_items(frames, ans: int, per_tick: int):
    """replay_raw_fused's tick grouping of a one-format capture recorded at
    1 ms per frame: ``per_tick`` (payload, ts) pairs per tick."""
    items = [(fr, i * 1e-3) for i, fr in enumerate(frames)]
    return [items[i : i + per_tick] for i in range(0, len(items), per_tick)]


def _replay_fused_deskew() -> dict:
    return dict(deskew_enable=True, deskew_backend="auto")


def ref_replay_fused(seed: int, deskew: bool) -> tuple:
    """The CPU reference of the fused replay: config 7's capture through
    replay_raw_fused on the host, de-skew off or on — ((ranges, state,
    stats), seconds)."""
    from rplidar_ros2_driver_tpu_torch.replay import replay_raw_fused

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "denseboost.rplr")
        write_capture(path, replay_capture(seed)[0])
        t0 = time.perf_counter()
        out = replay_raw_fused(path, _replay_params("cpu", **(_replay_fused_deskew() if deskew
                                                              else {})),
                               beams=REPLAY["beams"], capacity=REPLAY["capacity"], **FUSED)
        return out, time.perf_counter() - t0


def ref_deskew_twin(seed: int) -> tuple:
    """The de-skewed replay's host twin: DeskewHostTwin + the CPU chain over
    the capture's ticks — (swept planes, ranges, revolutions with motion,
    seconds)."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain
    from rplidar_ros2_driver_tpu_torch.ops.deskew import deskew_config_from_params
    from rplidar_ros2_driver_tpu_torch.ops.deskew_ref import DeskewHostTwin
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    ans = int(Ans.MEASUREMENT_DENSE_CAPSULED)
    frames = replay_capture(seed)[0]
    cpu_params = _replay_params("cpu", **_replay_fused_deskew())
    twin = DeskewHostTwin(deskew_config_from_params(cpu_params, REPLAY["beams"], "cpu"),
                          max_nodes=REPLAY["capacity"])
    chain = ScanFilterChain(cpu_params, beams=REPLAY["beams"], warmup=False,
                            capacity=REPLAY["capacity"])
    t0 = time.perf_counter()
    twin_recons, twin_ranges, moved = [], [], 0
    for items in _tick_items(frames, ans, FUSED["frames_per_tick"]):
        combined, pushed, tw_revs = twin.tick(ans, items)
        if pushed:
            twin_recons.append(combined)
        for a2, d2, scan in tw_revs:
            twin_ranges.append(chain.process_raw(a2, d2, scan["quality"], scan["flag"]).ranges)
            moved += int((twin.stream.motion != 0).any())
    return twin_recons, twin_ranges, moved, time.perf_counter() - t0


def phase_replay_fused(device, frames, revs, seed: int, trace_dir=None) -> dict:
    """Config 7 through the fused device ingest (replay_raw_fused: 64
    frames per tick, T=8, max_revs 8, capacity 4096): de-skew off held
    equal to the card's host-path replay and to the CPU fused replay;
    de-skew on (auto: B4/B5) held equal to the CPU fused replay and to
    DeskewHostTwin + the CPU chain; the B1/B4/B5 launches counted; scans/s,
    dispatches and host syncs per tick for each arm; one profiled
    super-step window; the CLI's ``replay --fused`` line."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rplidar_ros2_driver_tpu_torch.__main__ import main as cli_main
    from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
    from rplidar_ros2_driver_tpu_torch.replay import replay_raw_fused, replay_through_chain

    ans = int(Ans.MEASUREMENT_DENSE_CAPSULED)
    kw = dict(beams=REPLAY["beams"], capacity=REPLAY["capacity"], **FUSED)
    deskew_on = _replay_fused_deskew()
    row = {"phase": "replay_fused", "turns": REPLAY["revs"], "frames": len(frames), **FUSED}

    def counts():
        return {**mk.launch_counts, **dk.launch_counts}

    def reset_counts():
        mk.reset_launch_counts()
        dk.reset_launch_counts()

    def timed(params, path):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = replay_raw_fused(path, params, **kw)
        if params.filter_backend != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "denseboost.rplr")
        write_capture(path, frames)
        warm = os.path.join(tmp, "warm.rplr")
        write_capture(warm, frames[:1200])
        for over in ({}, deskew_on):  # warm-up: builds, allocator
            replay_raw_fused(warm, _replay_params("cuda", **over), **kw)

        arms = {}
        for name, over in (("deskew_off", {}), ("deskew_on", deskew_on)):
            (ranges, state, stats), wall, launched = timed(_replay_params("cuda", **over), path)
            (c_ranges, c_state, c_stats), c_wall = _ref(None, ref_replay_fused, seed, bool(over))
            k = stats["scans"]
            check(k == len(revs), f"{name}: fused replay gave {k} scans for {len(revs)} revolutions")
            ok, err = exact(torch.from_numpy(ranges), torch.from_numpy(c_ranges))
            check(ok, f"{name}: card fused replay ranges differ from the CPU fused replay: {err}")
            check(_same_state(state, c_state), f"{name}: card fused state differs from the CPU's")
            check(launched["temporal_median"] == k,
                  f"{name}: B1 launched {launched['temporal_median']} times for {k} revolutions")
            arms[name] = dict(
                ranges=ranges, state=state, stats=stats, launches=launched,
                row={"scans": k, "ticks": stats["ticks"], "dispatches": stats["dispatches"],
                     "super_dispatches": stats["super_dispatches"], "wall_s": wall,
                     "scans_per_s": k / wall, "cpu_wall_s": c_wall, "cpu_scans_per_s": k / c_wall,
                     "launches": launched},
            )
            if name == "deskew_on":
                hist, c_hist = stats["recon_history"], c_stats["recon_history"]
                check(len(hist) == len(c_hist) == stats["ticks"],
                      f"recon sweeps {len(hist)} / {len(c_hist)} for {stats['ticks']} ticks")
                for i, ((p, pts), (cp, cpts)) in enumerate(zip(hist, c_hist)):
                    check(np.array_equal(p, cp), f"recon plane {i} differs from the CPU's")
                    check(np.array_equal(pts[:, 2], cpts[:, 2]), f"recon mask {i} differs")
                    check(np.array_equal(pts, cpts), f"recon points {i} differ from the CPU's")

        # de-skew off: the card's host-path replay over the decoded revolutions
        off = arms["deskew_off"]
        h_ranges, h_state = replay_through_chain(
            revs, _replay_params("cuda"), beams=REPLAY["beams"], capacity=REPLAY["capacity"],
            chunk=REPLAY["chunk"])
        ok, err = exact(torch.from_numpy(off["ranges"]), torch.from_numpy(h_ranges))
        check(ok, f"fused replay ranges differ from the host-path replay: {err}")
        check(_same_state(off["state"], h_state), "fused final state differs from the host path's")
        check(off["launches"]["beam_min"] == 0 and off["launches"]["shift_sad"] == 0,
              "de-skew kernels launched with de-skew off")

        # de-skew on: DeskewHostTwin + the CPU chain over the same ticks
        on = arms["deskew_on"]
        twin_recons, twin_ranges, moved, twin_wall = _ref(None, ref_deskew_twin, seed)
        hist = on["stats"]["recon_history"]
        check(len(twin_recons) == len(hist), f"{len(twin_recons)} twin sweeps vs {len(hist)}")
        for i, ((p, _pts), tp) in enumerate(zip(hist, twin_recons)):
            check(np.array_equal(p, tp), f"recon plane {i} differs from DeskewHostTwin's")
        check(len(twin_ranges) == len(on["ranges"]), "twin revolution count differs")
        ok, err = exact(torch.from_numpy(on["ranges"]), torch.from_numpy(np.stack(twin_ranges)))
        check(ok, f"de-skewed ranges differ from DeskewHostTwin + chain: {err}")
        check(moved > 0, "no revolution had a nonzero motion estimate")
        # B5 once per tick that completed a revolution; B4 that once more
        # (the profiles) plus the rasterizer once per tick slot, the idle
        # pad ticks of the last super-step included
        st = on["stats"]
        slots = st["super_dispatches"] * FUSED["super_ticks"] + st["dispatches"] - st[
            "super_dispatches"]
        ticks_done = on["launches"]["shift_sad"]
        check(0 < ticks_done <= st["ticks"], f"B5 launched {ticks_done} times")
        check(on["launches"]["beam_min"] == slots + ticks_done,
              f"B4 launched {on['launches']['beam_min']} times for {slots} tick slots "
              f"and {ticks_done} ticks that completed a revolution")

        # host syncs per tick and one profiled super-step window, per arm
        tick_items = _tick_items(frames, ans, FUSED["frames_per_tick"])
        t_depth = FUSED["super_ticks"]
        for name, over in (("deskew_off", {}), ("deskew_on", deskew_on)):
            params = _replay_params("cuda", **over)

            def engine():
                eng = FleetFusedIngest(params, 1, beams=REPLAY["beams"],
                                       capacity=REPLAY["capacity"], max_revs=FUSED["max_revs"],
                                       max_queue=1 << 30, buckets=(FUSED["frames_per_tick"],),
                                       super_tick_max=t_depth)
                eng.submit_backlog([[(ans, it)] for it in tick_items[: 4 * t_depth]])
                return eng

            window = [[(ans, it)] for it in tick_items[4 * t_depth : 5 * t_depth]]
            eng = engine()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng.submit_backlog(window)
            torch.cuda.set_sync_debug_mode("default")
            sites = {}
            for w in caught:
                if "synchroniz" in str(w.message):
                    site = f"{os.path.relpath(w.filename)}:{w.lineno}"
                    sites[site] = sites.get(site, 0) + 1
            syncs = sum(sites.values())
            eng = engine()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.submit_backlog(window)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            if trace_dir:
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir, f"replay_fused_{name}.json"))
            dev_events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            busy_us = sum(ev.time_range.elapsed_us() for ev in dev_events)
            by_kernel = {}
            for ev in dev_events:
                by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            arm = arms[name]["row"]
            arm.update({
                "host_syncs_per_tick": syncs / t_depth, "sync_sites": sites,
                "window_ticks": t_depth, "window_wall_ms": prof_wall * 1e3,
                "window_device_busy_ms": busy_us / 1e3,
                "window_device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
                "window_device_ops": len(dev_events),
                "window_top_device_ms": [[k[:60], v / 1e3] for k, v in
                                         sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]],
            })

        # the CLI line, on the capture's first 15 turns
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["replay", warm, "--fused"])
        line = [ln for ln in out.getvalue().splitlines() if "fused raw replay" in ln]
        check(rc == 0 and len(line) == 1 and line[0].endswith("parity OK"),
              f"replay --fused: {out.getvalue()[-400:]}")

    row.update({
        "deskew_off": arms["deskew_off"]["row"], "deskew_on": arms["deskew_on"]["row"],
        "twin_wall_s": twin_wall, "revolutions_with_motion": moved,
        "cli": line[0].split(": ", 1)[1],
    })
    emit(row)
    return row



# ---------------------------------------------------------------------------
# the fleet: the mesh and the sharded fleet service (ROADMAP A.7a)
# ---------------------------------------------------------------------------


def fleet_byte_ticks(frames, streams: int, run: int, ans: int) -> list:
    """bench.py ``bench_fleet_ingest``'s ``make_ticks``: per tick ``run``
    frames (one revolution) per stream, every stream carrying the same
    frames on its own timestamp lane (7 s apart, 1.25 ms a frame)."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import paced_fleet_ticks

    return paced_fleet_ticks(frames, run, streams, ans)


def _fleet_params(backend: str, ingest: str = "host", **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    kw = dict(filter_backend=backend, filter_chain=("clip", "median", "voxel"),
              filter_window=FLEET["window"], voxel_grid_size=FLEET["grid"],
              voxel_cell_m=FLEET["cell_m"], fleet_ingest_backend=ingest)
    kw.update(over)
    return DriverParams(**kw)


def _fleet_service(backend: str, ingest: str, n: int, run: int, mesh=None, **over):
    """A warmed service of config 10 (both kernels built and loaded) on
    ``mesh`` (None: the service's default)."""
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    svc = ShardedFilterService(
        _fleet_params(backend, ingest, **over), n, beams=FLEET["beams"],
        capacity=FLEET["capacity"],
        fleet_ingest_buckets=(run,) if ingest == "fused" else None,
        mesh=mesh,
    )
    svc._ensure_byte_ingest()
    if ingest == "fused":
        svc.fleet_ingest.precompile([int(Ans.MEASUREMENT_DENSE_CAPSULED)])
    else:
        svc.precompile()
    return svc


def _published(per_tick_outs, streams: int) -> list:
    """Per stream, the published outputs in order."""
    return [[o[s] for o in per_tick_outs if o[s] is not None] for s in range(streams)]


def _same_published(a, b) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(_same_output(u, v) for u, v in zip(x, y)) for x, y in zip(a, b))


def _counts() -> dict:
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    return {**mk.launch_counts, **dk.launch_counts, **smk.launch_counts}


def _card_counts() -> dict:
    """The launches since the last :func:`_reset_counts` by card: {card
    index: {kernel name: launches}}."""
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    out: dict = {}
    for counts in (mk.card_launches, dk.card_launches, smk.card_launches):
        for (name, card), n in counts.items():
            out.setdefault(card, {})[name] = n
    return dict(sorted(out.items()))


def _reset_counts() -> None:
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    mk.reset_launch_counts()
    dk.reset_launch_counts()
    smk.reset_launch_counts()


def _sync(device) -> None:
    """Wait for every card when ``device`` is one (a pod's shards may run
    on several)."""
    import torch

    if device.type == "cuda":
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def _memo(cpu, key, run):
    """``run()``, kept in ``cpu`` under ``key`` when ``cpu`` is a dict: an
    input that two card layouts are both fed is built once."""
    if cpu is None:
        return run()
    if key not in cpu:
        cpu[key] = run()
    return cpu[key]


def _ref(cpu, fn, *args):
    """The CPU reference ``fn(*args)`` (a function of this module whose
    result pickles), under its key (:func:`_ref_key`): kept in ``cpu`` when
    it is a dict (the card layouts of ``--pod-cards`` and ``--mesh-check``
    share theirs), else taken from the run's :data:`REFS`, where a worker
    process may have computed it."""
    key = _ref_key(fn.__name__, args)
    if cpu is None:
        return REFS.get(key, lambda: fn(*args))
    if key not in cpu:
        with cpu_reference():
            cpu[key] = fn(*args)
    return cpu[key]


def _ref_key(name: str, args: tuple) -> tuple:
    """A reference's key: its function and its arguments (a geometry
    passed as a dict compares by its items)."""
    return (name, json.dumps(args, sort_keys=True, default=repr))


def _worker_cpus() -> list:
    """The cores the reference workers run on: the upper half of this
    process's cores, at most REF_WORKERS of them; the lower half stays the
    card driver's alone.  Empty on a host of one core."""
    cpus = sorted(os.sched_getaffinity(0))
    return cpus[len(cpus) - min(REF_WORKERS, len(cpus) // 2):]


def _ref_worker_init(cpus: list) -> None:
    """A reference worker: no card (CUDA_VISIBLE_DEVICES empty before torch
    is imported), on ``cpus`` only, at the lowest priority, one torch
    thread, anything it prints on stderr."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.sched_setaffinity(0, cpus)
    os.nice(19)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    import torch

    torch.set_num_threads(1)


def _ref_job(name: str, args: tuple, path: str) -> tuple:
    """Run the reference ``name(*args)`` in a worker and pickle its result
    to ``path``: (None, seconds), or (the error, seconds) — a failed check
    (SystemExit) included, which would otherwise end the worker and leave
    its result never set.  The result goes through a file so that the
    parent unpickles it when a phase asks for it: the pool's own result
    thread would unpickle it at once, holding the interpreter lock (and
    running the collector) inside the card's timed windows."""
    import pickle
    import traceback

    t0 = time.perf_counter()
    try:
        got = globals()[name](*args)
        with open(path, "wb") as f:
            pickle.dump(got, f, protocol=pickle.HIGHEST_PROTOCOL)
        return None, time.perf_counter() - t0
    except (Exception, SystemExit) as e:  # the parent reports it and fails the run
        return f"{type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}", \
            time.perf_counter() - t0


class _References:
    """The run's CPU references.  With :meth:`start`, worker processes on
    cores of their own (:func:`_worker_cpus`) compute the references
    :meth:`submit` plans while this process drives the card; :meth:`get`
    waits for a planned one (the wait counts as CPU reference time) and
    computes any other here."""

    def __init__(self) -> None:
        self.pending: dict = {}
        self.worker_seconds: dict = {}
        self.pool = None
        self.cpus: list = []
        self.dir = None
        self.submitted = 0

    def start(self) -> None:
        import multiprocessing

        self.cpus = _worker_cpus()
        if self.cpus:
            self.dir = tempfile.mkdtemp(prefix="chip_smoke_refs_")
            self.pool = multiprocessing.get_context("spawn").Pool(
                len(self.cpus), _ref_worker_init, (self.cpus,))

    def submit(self, fn, *args) -> None:
        if self.pool is not None:
            self.submitted += 1
            path = os.path.join(self.dir, f"{self.submitted}.pkl")
            self.pending[_ref_key(fn.__name__, args)] = (
                self.pool.apply_async(_ref_job, (fn.__name__, args, path)), path)

    def running(self) -> int:
        """Planned references not computed yet."""
        return sum(not job.ready() for job, _path in self.pending.values())

    def get(self, key, run):
        import gc
        import pickle

        with cpu_reference():
            job = self.pending.pop(key, None)
            if job is None:
                return run()
            err, secs = job[0].get(timeout=600)
            self.worker_seconds[f"{key[0]}{key[1]}"] = secs
            check(err is None, f"CPU reference {key[0]}{key[1]} failed in a worker: {err}")
            collecting = gc.isenabled()
            gc.disable()  # unpickling only allocates: no collection pass mid-way
            try:
                with open(job[1], "rb") as f:
                    got = pickle.load(f)
            finally:
                if collecting:
                    gc.enable()
            os.remove(job[1])
        return got

    def close(self) -> None:
        import shutil

        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


REFS = _References()


def _digest(arrays) -> str:
    """Arrays' bytes, in order, as one short hash."""
    import hashlib

    import numpy as np

    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _bytes_arm(device, ingest: str, n: int, ticks, run: int, **over) -> tuple:
    """One config-10 arm: submit_bytes over every tick (pipelined on the
    fused arm, as bench.py drives it), the flush last.  Returns (published
    outputs per stream, stats)."""
    import numpy as np

    backend = "cuda" if device.type == "cuda" else "cpu"
    svc = _fleet_service(backend, ingest, n, run, **over)
    _sync(device)
    _reset_counts()
    lat, outs, dispatched = [], [], 0
    t0 = time.perf_counter()
    for tick in ticks:
        tb = time.perf_counter()
        res = svc.submit_bytes(tick, pipelined=ingest == "fused")
        _sync(device)
        lat.append(time.perf_counter() - tb)
        outs.append(res)
        dispatched += any(r is not None for r in res)
    if ingest == "fused":
        outs.append([o[-1][0] if o else None for o in svc.fleet_ingest.flush()])
    _sync(device)
    wall = time.perf_counter() - t0
    launched = _counts()
    pub = _published(outs, n)
    stats = {"ticks": len(ticks), "ticks_per_s": len(ticks) / wall,
             "published": sum(len(p) for p in pub), **_pcts(lat), "launches": launched}
    if ingest == "host":
        stats["dispatched_ticks"] = dispatched
        stats["b1_launches_per_tick"] = launched["temporal_median"] / max(dispatched, 1)
        stats["b2_launches_per_tick"] = launched["sorted_replace"] / max(dispatched, 1)
    else:
        stats["revolutions"] = svc.fleet_ingest.scans_completed
        stats["dispatches"] = svc.fleet_ingest.dispatch_count
        stats["b1_launches_per_tick"] = launched["temporal_median"] / len(ticks)
    return pub, stats, np.asarray(lat)


def _device_ops_per_tick(device, ingest: str, n: int, ticks, run: int, **over) -> dict:
    """A fresh warmed service's first ``len(ticks)`` ticks under the
    profiler: device operations (kernels, copies, fills) and busy ms per
    tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    svc = _fleet_service("cuda", ingest, n, run, **over)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tick in ticks:
            svc.submit_bytes(tick, pipelined=ingest == "fused")
        _sync(device)
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ev)
    return {"device_ops_per_tick": len(ev) / len(ticks),
            "device_busy_ms_per_tick": busy_us / len(ticks) / 1e3,
            "profiled_wall_ms_per_tick": wall / len(ticks) * 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall}


# config 10's byte arms: name -> (ingest, parameter overrides); the last
# two at the smaller fleet only
FLEET_ARMS = {"host": ("host", {}), "fused": ("fused", {}),
              "host_inc": ("host", {"median_backend": "inc"}),
              "fused_deskew": ("fused", {"deskew_enable": True, "sweep_reconstruct_window": 6})}


def _fleet_arms(n: int) -> list:
    return list(FLEET_ARMS)[: 4 if n == FLEET["fleets"][0] else 2]


def _fleet_byte_ticks(n: int) -> list:
    """Config 10's byte ticks at N = ``n``: one seeded 3200-point DenseBoost
    revolution a stream a tick."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    frames = denseboost_frames(FLEET["seed"], FLEET["revs"], FLEET["points"])
    return fleet_byte_ticks(frames, n, FLEET["points"] // 40, int(Ans.MEASUREMENT_DENSE_CAPSULED))


def ref_fleet_bytes(n: int, arm: str) -> tuple:
    """The CPU reference of one config-10 byte arm: (published outputs,
    stats)."""
    import torch

    ingest, over = FLEET_ARMS[arm]
    pub, stats, _ = _bytes_arm(torch.device("cpu"), ingest, n, _fleet_byte_ticks(n),
                               FLEET["points"] // 40, **over)
    return pub, stats


def _fleet_config10(device) -> dict:
    """(a) config 10 at full geometry: both submit_bytes arms at each
    fleet size on the card, every published output equal to the CPU
    service's same arm; B2 (the ``inc`` median) and B4/B5 (the fused arm
    with de-skew) at the smaller fleet."""
    run = FLEET["points"] // 40
    out, launches = {}, {}
    for n in FLEET["fleets"]:
        ticks = _fleet_byte_ticks(n)
        for arm in _fleet_arms(n):
            ingest, over = FLEET_ARMS[arm]
            name = f"{arm}_n{n}"
            pub, stats, _ = _bytes_arm(device, ingest, n, ticks, run, **over)
            ref, ref_stats = _ref(None, ref_fleet_bytes, n, arm)
            check(stats["published"] > 0, f"config 10 {name}: nothing published")
            check(_same_published(pub, ref), f"config 10 {name}: the card differs from the CPU")
            if device.type == "cuda" and ingest == "host":
                key = "b2" if over.get("median_backend") == "inc" else "b1"
                check(stats[f"{key}_launches_per_tick"] == 1.0,
                      f"config 10 {name}: {stats[f'{key}_launches_per_tick']} median launches "
                      "per dispatched tick, not one for the fleet")
            elif device.type == "cuda":
                check(stats["launches"]["temporal_median"] == stats["revolutions"],
                      f"config 10 {name}: B1 launches != completed revolutions")
            if over.get("deskew_enable") and device.type == "cuda":
                check(stats["launches"]["beam_min"] > 0 and stats["launches"]["shift_sad"] > 0,
                      f"config 10 {name}: B4/B5 never launched")
            stats["cpu_ticks_per_s"] = ref_stats["ticks_per_s"]
            out[name] = stats
            for k, v in stats["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return {"arms": out, "launches": launches}


def _fleet_replay_streams(seed: int) -> list:
    """Config 8's streams: each cycled from seeded revolutions as bench.py
    bench_fleet does."""
    s_n, k_n = FLEET["replay_streams"], FLEET["replay_revs"]
    scans = make_revolutions(seed, FLEET["replay_seed_revs"], FLEET["points"])
    return [[scans[(i + 7 * s) % len(scans)] for i in range(k_n)] for s in range(s_n)]


def ref_fleet_replay_chunk(seed: int):
    """The CPU reference of config 8's first chunk: replay_fleet's ranges."""
    from rplidar_ros2_driver_tpu_torch.replay import replay_fleet

    chunk = FLEET["replay_chunk"]
    ranges, _state = replay_fleet([f[:chunk] for f in _fleet_replay_streams(seed)],
                                  _fleet_params("cpu", median_backend="pallas"),
                                  beams=FLEET["beams"], capacity=FLEET["capacity"], chunk=chunk)
    return ranges


def _fleet_replay(device, seed: int) -> dict:
    """(b) config 8: replay_fleet of 4 streams, chunk 256, each stream
    cycled from 32 seeded revolutions as bench.py bench_fleet does; each
    stream held to the one-stream fused chain on the card, the first chunk
    to the CPU; B3 launches = chunks."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.replay import replay_fleet, replay_through_chain

    s_n, k_n, chunk = FLEET["replay_streams"], FLEET["replay_revs"], FLEET["replay_chunk"]
    fleet = _fleet_replay_streams(seed)
    kw = dict(beams=FLEET["beams"], capacity=FLEET["capacity"], chunk=chunk)
    backend = "cuda" if device.type == "cuda" else "cpu"
    params = _fleet_params(backend, median_backend="pallas")
    replay_fleet([f[:chunk] for f in fleet], params, **kw)  # warm
    _sync(device)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    ranges, state = replay_fleet(fleet, params, **kw)
    wall = time.perf_counter() - t0
    launched = dict(mk.launch_counts)
    chunks = -(-k_n // chunk)
    check(device.type != "cuda" or launched["sliding_median"] == chunks,
          f"replay_fleet launched B3 {launched['sliding_median']} times for {chunks} chunks")
    check(ranges.shape == (s_n, k_n, FLEET["beams"]), f"replay_fleet ranges {ranges.shape}")
    for s in range(s_n):
        r_s, st_s = replay_through_chain(fleet[s], params, **kw)
        check(np.array_equal(ranges[s], r_s), f"replay_fleet stream {s} != its one-stream replay")
        for name, v in st_s.to_numpy().items():
            check(np.array_equal(getattr(state, name)[s].numpy(), v),
                  f"replay_fleet stream {s} final {name} != its one-stream replay")
    cpu_r = _ref(None, ref_fleet_replay_chunk, seed)
    check(np.array_equal(ranges[:, :chunk], cpu_r), "replay_fleet's first chunk != the CPU's")
    row = {"streams": s_n, "revs_per_stream": k_n, "chunk": chunk, "chunks": chunks,
           "scans_per_s": s_n * k_n / wall, "wall_s": wall, "launches": launched}
    if device.type == "cuda":
        # the device-side rate: the scan over one uploaded chunk, looped
        from rplidar_ros2_driver_tpu_torch.ops.filters import pack_host_scans_compact
        from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

        from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params

        mesh = ts.make_mesh(device=device)

        cfg = config_from_params(params, FLEET["beams"], platform="cuda")
        seqs, counts = zip(*[pack_host_scans_compact(f[:chunk], FLEET["capacity"]) for f in fleet])
        seq = torch.from_numpy(np.stack(seqs).view(np.int16)).to(device)
        cnt = torch.from_numpy(np.stack(counts).astype(np.int32)).to(device)
        scan = ts.build_sharded_scan(mesh, cfg)
        st = ts.create_sharded_state(mesh, cfg, s_n)
        scan(st, seq, cnt)
        _sync(device)
        reps = 8
        t0 = time.perf_counter()
        for _ in range(reps):
            st, _r = scan(st, seq, cnt)
        _sync(device)
        row["device_loop_scans_per_s"] = s_n * chunk * reps / (time.perf_counter() - t0)
    return row


def _slam_params(backend: str, **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    kw = dict(filter_backend=backend, filter_chain=("clip", "median", "voxel"),
              filter_window=FLEET["slam_window"], voxel_grid_size=FLEET["grid"],
              voxel_cell_m=FLEET["cell_m"], map_enable=True, map_grid=MAPPING["grid"],
              map_cell_m=MAPPING["cell_m"], map_match_window=MAPPING["window_m"],
              loop_enable=True, loop_submap_revs=LOOP["submap_revs"],
              loop_check_revs=LOOP["check_revs"], loop_max_submaps=LOOP["max_submaps"],
              world_map_enable=True)
    kw.update(over)
    return DriverParams(**kw)


def _slam_service(backend: str):
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    svc = ShardedFilterService(_slam_params(backend), FLEET["slam_streams"],
                               beams=MAPPING["beams"], capacity=FLEET["capacity"])
    svc.precompile()
    svc.attach_mapper()
    svc.attach_loop_closure()
    svc.attach_world_map()
    return svc


def _slam_tick_record(svc, outs) -> tuple:
    import numpy as np

    poses = [None if p is None else (p.pose_q.tobytes(), p.score, p.matched_points, p.revision)
             for p in svc.last_poses]
    loops = [None if st is None else tuple(
        np.asarray(getattr(st, f)).tobytes() for f in
        ("accepted", "candidate", "score", "matched_points", "corrected_q", "correction_q",
         "constraints", "dropped")) for st in svc.last_loop]
    corr = [None if c is None else np.asarray(c).tobytes() for c in svc.last_corrected_poses]
    return outs, poses, loops, corr


def _slam_scans() -> list:
    """Config 12's room as the SLAM service's ticks of wire nodes."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import room_scan

    n, beams = FLEET["slam_streams"], MAPPING["beams"]
    return [[room_scan(s, k, beams) for s in range(n)] for k in range(FLEET["slam_ticks"])]


def ref_fleet_slam() -> dict:
    """The CPU reference of the fleet phase's SLAM seams: the service with
    the host references over the same ticks — every tick's record, the
    world's accumulation and merges."""
    host = _slam_service("cpu")
    records = [_slam_tick_record(host, host.submit(row)) for row in _slam_scans()]
    return {"records": records, "accumulation": host.world.accumulation(),
            "merges": host.world.status()["merges"]}


def _fleet_slam(device) -> dict:
    """(c) the service with attach_mapper, attach_loop_closure and
    attach_world_map on config 12's room, 4 streams, 24 ticks (fused
    mapper B6/B7/B8 and fused loop check B6/B7 on the card, the host
    references on the CPU): poses, loop statuses, corrected poses and the
    world accumulation byte-equal.  (d) the card service's snapshot at
    tick 10 (filter, mapper, loop, world) restored into a fresh service
    and continued: outputs and front-end poses equal to the uninterrupted
    run."""
    import numpy as np

    n, ticks, beams = FLEET["slam_streams"], FLEET["slam_ticks"], MAPPING["beams"]
    scans = _slam_scans()
    backend = "cuda" if device.type == "cuda" else "cpu"
    card = _slam_service(backend)
    if device.type == "cuda":
        check(card.mapper.backend == "fused" and card.loop.backend == "fused",
              "the card service did not resolve the fused mapper and loop engine")
    _sync(device)
    _reset_counts()
    recs, lat, snaps = [], [], None
    t0 = time.perf_counter()
    for k, row in enumerate(scans):
        if k == FLEET["snapshot_tick"]:
            snaps = (card.snapshot(), card.mapper.snapshot(), card.loop.snapshot(),
                     card.world.save_state())
        tb = time.perf_counter()
        outs = card.submit(row)
        lat.append(time.perf_counter() - tb)
        recs.append(_slam_tick_record(card, outs))
    _sync(device)
    wall = time.perf_counter() - t0
    launched = _counts()
    acc = card.world.accumulation()
    host = _ref(None, ref_fleet_slam)
    checks = 0
    for k, (r_outs, r_poses, r_loops, r_corr) in enumerate(host["records"]):
        c_outs, c_poses, c_loops, c_corr = recs[k]
        check(all(_same_output(a, b) for a, b in zip(c_outs, r_outs)),
              f"SLAM service tick {k}: filter outputs differ from the CPU")
        check(c_poses == r_poses, f"SLAM service tick {k}: poses differ from the CPU")
        check(c_loops == r_loops, f"SLAM service tick {k}: loop statuses differ from the CPU")
        check(c_corr == r_corr, f"SLAM service tick {k}: corrected poses differ from the CPU")
        checks += sum(st is not None for st in c_loops)
    check(checks > 0, "no loop check ran in the SLAM service's 24 ticks")
    check(len(host["records"]) == len(recs), "the SLAM service's CPU run has other ticks")
    check(_bits_equal(acc, host["accumulation"]), "world accumulation differs from the CPU")
    check(card.world.status()["merges"] == host["merges"] > 0,
          "the world merged no submap, or other ones than the CPU")
    if device.type == "cuda":
        check(launched["temporal_median"] == ticks, "the SLAM service's ticks launched B1 "
              f"{launched['temporal_median']} times for {ticks} ticks")
        for name in ("coarse_scores", "fine_scores", "log_odds_update"):
            check(launched[name] >= ticks, f"the SLAM service never launched {name} a tick")
    # (d): restore the tick-10 snapshot into a fresh service and continue
    fresh = _slam_service(backend)
    f_snap, m_snap, l_snap, w_state = snaps
    check(fresh.restore(f_snap) and fresh.mapper.restore(m_snap) and fresh.loop.restore(l_snap),
          "the tick-10 snapshot was refused")
    fresh.world.load_state(w_state)
    for k in range(FLEET["snapshot_tick"], ticks):
        outs = fresh.submit(scans[k])
        got_outs, got_poses, _, _ = _slam_tick_record(fresh, outs)
        want_outs, want_poses, _, _ = recs[k]
        check(all(_same_output(a, b) for a, b in zip(got_outs, want_outs)),
              f"restored service tick {k}: outputs differ from the uninterrupted run")
        check(got_poses == want_poses, f"restored service tick {k}: poses differ")
    lat_ms = np.asarray(lat) * 1e3
    slowest = np.argsort(-lat_ms)[:5]
    return {"streams": n, "ticks": ticks, "beams": beams, "map_grid": MAPPING["grid"],
            "ticks_per_s": ticks / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            # (tick, ms): checks run at revolutions 8, 10, ..., finalizations
            # (each a host world alignment) at 4, 8, ...
            "slowest_ticks": [[int(k), float(lat_ms[k])] for k in slowest],
            "check_calls": card.loop.dispatch_count, "loop_checks": checks,
            "submaps": card.loop_status()["submaps"], "world_merges": card.world.status()["merges"],
            "launches": launched, "restored_from_tick": FLEET["snapshot_tick"]}


def _fleet_engine_snapshot(device) -> dict:
    """(d) the fused engine's whole-fleet snapshot at tick 10 of config 10
    (N = the smaller fleet) restored into a fresh service's engine and
    continued: every output equal to the uninterrupted run."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    n = FLEET["fleets"][0]
    run = FLEET["points"] // 40
    frames = denseboost_frames(FLEET["seed"], FLEET["revs"], FLEET["points"])
    ticks = fleet_byte_ticks(frames, n, run, int(Ans.MEASUREMENT_DENSE_CAPSULED))
    backend = "cuda" if device.type == "cuda" else "cpu"
    whole = _fleet_service(backend, "fused", n, run)
    want = [whole.submit_bytes(t) for t in ticks]
    first = _fleet_service(backend, "fused", n, run)
    for t in ticks[: FLEET["snapshot_tick"]]:
        first.submit_bytes(t)
    snap = first.fleet_ingest.snapshot()
    second = _fleet_service(backend, "fused", n, run)
    check(second.fleet_ingest.restore(snap), "the fleet engine refused its own snapshot")
    got = [second.submit_bytes(t) for t in ticks[FLEET["snapshot_tick"]:]]
    same = all((a is None) == (b is None) and (a is None or _same_output(a, b))
               for g, w in zip(got, want[FLEET["snapshot_tick"]:]) for a, b in zip(g, w))
    check(same, "the restored fleet engine's outputs differ from the uninterrupted run")
    return {"streams": n, "restored_from_tick": FLEET["snapshot_tick"],
            "snapshot_keys": len(snap), "continued_ticks": len(got)}


def fleet_mp_worker(rank: int, port: int, world: int = 2, stream: int = 1,
                    backend: str = "gloo", device_name: str = "cuda:0") -> int:
    """One process of the fleet's multi-process check: the (stream,
    world/stream) mesh's step and scan with ``psum`` and ``ring``
    (B1/B2/B3), each held to this process's one-process (1, 1) run;
    prints one JSON line.  (e) runs two gloo processes on ``cuda:0``;
    ``--mesh-check N`` runs N NCCL processes, one card each."""
    import numpy as np
    import torch

    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = str(world)
    os.environ["JAX_PROCESS_ID"] = str(rank)
    from rplidar_ros2_driver_tpu_torch.ops import filters as tf
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.parallel import multihost
    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before NCCL binds its communicator
    multihost.initialize(backend=backend)
    mesh = multihost.make_global_mesh(stream=stream, device=device)
    check(mesh.shape == {"stream": stream, "beam": world // stream}, f"mesh {mesh.shape}")
    local = ts.make_mesh(1, device=device)
    s_n, w, b, g = FLEET["mp_streams"], FLEET["window"], FLEET["beams"], FLEET["grid"]
    rows, cols = mesh.local_streams(s_n), mesh.local_beams(b)
    revs = make_revolutions(11, FLEET["mp_ticks"] + 40, FLEET["points"])
    packed = [tf.pack_host_scans_compact(revs[k : k + s_n], FLEET["capacity"])
              for k in range(FLEET["mp_ticks"] + 32)]
    mk.reset_launch_counts()
    compared = 0
    for reduce in ("psum", "ring"):
        for median in ("pallas", "inc"):
            cfg = tf.FilterConfig(window=w, beams=b, grid=g, cell_m=FLEET["cell_m"],
                                  median_backend=median, voxel_reduce=reduce)
            gstep, lstep = ts.build_sharded_step(mesh, cfg), ts.build_sharded_step(local, cfg)
            gs, ls = ts.create_sharded_state(mesh, cfg, s_n), ts.create_sharded_state(local, cfg, s_n)
            for seq, counts in packed[: FLEET["mp_ticks"]]:
                batch = tf._unpack_compact(torch.from_numpy(seq.view(np.int16)).to(device),
                                           torch.from_numpy(counts).to(device))
                gs, go = gstep(gs, ts.shard_batch(mesh, batch))
                ls, lo = lstep(ls, batch)
                for got, want in ((go.ranges, lo.ranges[rows][:, cols]),
                                  (go.voxel, lo.voxel[rows])):
                    check(exact(got, want)[0], f"mp step {reduce}/{median} differs")
                compared += 1
            for k0, k1 in ((0, 16), (16, 32)):
                gscan = ts.build_sharded_scan(mesh, cfg)
                lscan = ts.build_sharded_scan(local, cfg)
                seqs = np.stack([np.stack([p[0][s] for p in packed[k0:k1]]) for s in range(s_n)])
                cnts = np.stack([np.stack([p[1][s] for p in packed[k0:k1]]) for s in range(s_n)])
                gs, gr = gscan(gs, seqs[rows], cnts[rows])
                ls, lr = lscan(ls, seqs, cnts)
                check(exact(gr, lr[rows][..., cols])[0], f"mp scan {reduce}/{median} differs")
                check(exact(gs.voxel_acc, ls.voxel_acc[rows])[0],
                      f"mp scan voxel {reduce}/{median} differs")
                compared += 1
    _sync(device)
    import torch.distributed as dist

    ckpt = None
    if stream == 1 and world % 2 == 0:
        # the sharded checkpoint: each rank writes its block of the (1, N)
        # mesh; restored onto the (2, N/2) mesh of the same group and whole
        # onto one process, each bit-equal to the one-process run
        import shutil

        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded as cs

        path = os.path.join(tempfile.gettempdir(), f"rpl_mesh_ckpt_{port}")
        core = {k: v for k, v in cs.as_tensor_dict(gs).items() if k != "median_sorted"}
        t0 = time.perf_counter()
        cs.save_sharded(path, core, mesh=mesh, specs=ts.STATE_SPEC)
        save_ms = (time.perf_counter() - t0) * 1e3
        tmpl = ts.abstract_sharded_state(mesh, cfg, s_n)
        other = multihost.make_global_mesh(stream=2, device=device)
        back = cs.restore_sharded(path, tmpl, mesh=other, specs=ts.STATE_SPEC)
        check(back is not None, "mp checkpoint: the (2, N/2) restore refused")
        r2, c2 = other.local_streams(s_n), other.local_beams(b)
        for name, v in back.items():
            want = getattr(ls, name)[r2]
            want = want[..., c2] if "beam" in ts.STATE_SPEC[name] else want
            check(exact(v, want)[0], f"mp checkpoint: {name} on {other.shape} differs")
        whole = cs.restore_sharded(path, tmpl, device=device)
        for name, v in whole.items():
            check(exact(v, getattr(ls, name))[0], f"mp checkpoint: whole {name} differs")
        dist.barrier()
        if rank == 0:
            shutil.rmtree(path, ignore_errors=True)
        ckpt = {"saved_on": mesh.shape, "restored_on": [other.shape, "one process"],
                "save_ms": save_ms, "equal": True}
    print(json.dumps({"rank": rank, "backend": backend, "device": str(device),
                      "mesh": mesh.shape, "coords": list(mesh.coords),
                      "compared": compared, "ring_host_hops": ts.ring_host_hops,
                      "launches": dict(mk.launch_counts), "checkpoint": ckpt}), flush=True)

    dist.destroy_process_group()
    return 0


def _fleet_multiprocess(world: int = 2, stream: int = 1, backend: str = "gloo",
                        one_card: bool = True) -> dict:
    """(e) two gloo processes on cuda:0 (NCCL refuses two ranks on one
    device): beam extent 2, step and scan with psum and ring, each equal
    to the one-process run.  With ``one_card`` False, rank r on cuda:r."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    # each worker writes to files of its own: a worker blocked on a full
    # pipe while its peer waits for it in a collective would hang the group
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, here, "--fleet-mp-worker", str(r), str(port), str(world), str(stream),
         backend, "cuda:0" if one_card else f"cuda:{r}"],
        cwd=os.path.dirname(here), stdout=logs[r][0], stderr=logs[r][1], text=True,
    ) for r in range(world)]
    deadline = time.monotonic() + FLEET["mp_timeout_s"]
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outs = []
    for p, files in zip(procs, logs):
        texts = []
        for f in files:
            f.seek(0)
            texts.append(f.read())
            f.close()
        outs.append((p.returncode, *texts))
    rows = []
    for r, (rc, out, err) in enumerate(outs):
        check(rc == 0, f"fleet worker {r} failed (rc {rc}): {err[-3000:]}")
        rows.append(json.loads(out.strip().splitlines()[-1]))
    check(all(r["compared"] > 0 for r in rows), "a fleet worker compared nothing")
    if stream == 1 and world % 2 == 0:
        check(all(r["checkpoint"] and r["checkpoint"]["equal"] for r in rows),
              "a fleet worker's sharded checkpoint was not restored across meshes")
    return {"workers": rows}


def _fleet_shapes(device, rng) -> dict:
    """B1 at config 10's host-arm stripe (W, N*B) and B3 at config 8's
    chunk stripe (W + K, S*B), held to their plain versions and timed
    beside them and beside one nanmedian call, with their bounds."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk

    w, b = FLEET["window"], FLEET["beams"]
    out = {}
    for n in FLEET["fleets"]:
        win = torch.from_numpy(_median_fixtures(rng, w, n * b)["random_inf"]).to(device)
        ok, err = exact(mk.temporal_median_kernel(win), mk.temporal_median_plain(win))
        check(ok, f"B1 at (W, B)=({w}, {n * b}) differs from its plain version: {err}")
        nan_win = torch.where(torch.isinf(win), torch.full_like(win, math.nan), win)
        bnd = bound(w * n * b * 4 + n * b * 4, 2 * w * n * b)
        out[f"temporal_median_n{n}"] = {
            "shape": [w, n * b], "ms": cuda_ms(lambda: mk.temporal_median_kernel(win)),
            "device_ms": device_ms(lambda: mk.temporal_median_kernel(win)),
            "plain_ms": cuda_ms(lambda: mk.temporal_median_plain(win)),
            "library_ms": cuda_ms(lambda: torch.nanmedian(nan_win, dim=0)),
            "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}
    s_n, k = FLEET["replay_streams"], FLEET["replay_chunk"]
    ext = torch.from_numpy(_median_fixtures(rng, w + k, s_n * b)["ties_1mm"]).to(device)
    ok, err = exact(mk.sliding_median_kernel(ext, w), mk.sliding_median_plain(ext, w))
    check(ok, f"B3 at (W, K, B)=({w}, {k}, {s_n * b}) differs from its plain version: {err}")
    nan_ext = torch.where(torch.isinf(ext), torch.full_like(ext, math.nan), ext)
    bnd = bound((w + 2 * k) * s_n * b * 4, 2 * w * k * s_n * b)
    out["sliding_median_config8"] = {
        "shape": [w, k, s_n * b], "plan": list(mk.sliding_plan(w, k)),
        "ms": cuda_ms(lambda: mk.sliding_median_kernel(ext, w), iters=50),
        "device_ms": device_ms(lambda: mk.sliding_median_kernel(ext, w), iters=20),
        "plain_ms": cuda_ms(lambda: mk.sliding_median_plain(ext, w), iters=5, warmup=1),
        "library_ms": cuda_ms(
            lambda: torch.nanmedian(nan_ext.unfold(0, w, 1)[1 : k + 1], dim=-1), iters=5, warmup=1),
        "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}
    return out


def phase_fleet(device, seed: int) -> dict:
    """The fleet on the card: (a) config 10's byte arms, (b) config 8's
    fleet replay, (c) the SLAM seams, (d) snapshots restored and continued,
    (e) the two-process gloo mesh; then B1/B3 at the fleet's widths."""
    import numpy as np

    row = {"phase": "fleet", "config10": _fleet_config10(device)}
    row["config8"] = _fleet_replay(device, seed)
    row["slam"] = _fleet_slam(device)
    row["engine_snapshot"] = _fleet_engine_snapshot(device)
    if device.type == "cuda":
        row["multiprocess"] = _fleet_multiprocess()
        row["shapes"] = _fleet_shapes(device, np.random.default_rng(seed + 5))
        # last: once torch.profiler has run, every CUDA call's host cost grows
        from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

        run = FLEET["points"] // 40
        frames = denseboost_frames(FLEET["seed"], 6, FLEET["points"])
        for n in FLEET["fleets"]:
            ticks = fleet_byte_ticks(frames, n, run, int(Ans.MEASUREMENT_DENSE_CAPSULED))
            for ingest in ("host", "fused"):
                row["config10"]["arms"][f"{ingest}_n{n}"].update(
                    _device_ops_per_tick(device, ingest, n, ticks, run))
    launches = dict(row["config10"]["launches"])
    for part in ("config8", "slam"):
        for k, v in row[part]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    row["launches"] = launches
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the map carried in the fused ingest state (config 18)
# ---------------------------------------------------------------------------


def ring_frames(revs: int, points: int) -> list[bytes]:
    """bench.py ``_denseboost_wire_frames``: the static 2 m +/- 0.5 m ring
    in dense capsules of 40 samples, ``revs`` revolutions."""
    from rplidar_ros2_driver_tpu_torch.tools.scenes import wire_frames

    return wire_frames(revs, points)


def _fm_service(backend: str, route: str, mesh=None, scheduled: bool = False, **over):
    """One arm of config 18: ``route`` 'fused' (the map carried in the
    ingest state, T-tick super-steps) or 'host' (the fused FleetMapper fed
    each tick's reconstructed sweeps, one ingest step a tick), warmed, on
    ``mesh`` (None: the service's default); ``scheduled`` attaches the
    traffic shaper before the warm-up."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm = FUSED_MAPPING
    params = DriverParams(
        filter_backend=backend, filter_chain=("clip", "median", "voxel"),
        filter_window=fm["window"], voxel_grid_size=fm["grid"], voxel_cell_m=fm["cell_m"],
        fleet_ingest_backend="fused", super_tick_max=fm["T"] if route == "fused" else 1,
        deskew_enable=True, sweep_reconstruct_window=fm["recon_window"],
        deskew_profile_beams=fm["profile_beams"], deskew_shift_window=fm["shift_window"],
        map_enable=True, map_backend="fused" if route == "host" else "host",
        fused_mapping_backend=route, map_grid=fm["map_grid"], map_cell_m=fm["map_cell_m"],
        **over,
    )
    svc = ShardedFilterService(params, fm["streams"], beams=fm["beams"], capacity=fm["capacity"],
                               fleet_ingest_buckets=(fm["run"],), mesh=mesh)
    svc._ensure_byte_ingest()
    if scheduled:
        svc.attach_scheduler()
    svc.fleet_ingest.precompile([int(Ans.MEASUREMENT_DENSE_CAPSULED)])
    svc.attach_mapper()
    return svc


def _fm_pose_row(svc) -> list:
    return [None if p is None else (tuple(int(v) for v in p.pose_q), p.score, p.revision)
            for p in svc.last_poses]


def _fm_map_equal(a: dict, b: dict) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in ("log_odds", "pose", "origin_xy", "revision"))


def _fm_drains(device, groups, arms=("fused", "host")) -> dict:
    """The ``arms`` of config 18 (both by default) over the same drains on
    ``device``, the first ``warm`` drains untimed, the arms alternating
    which goes first.  Returns each arm's per-stream ranges, drain-boundary
    poses, final map, drain seconds, dispatch and launch counts, and with
    the fused arm its last carried map and sweep (the kernels' inputs at
    this path's tick)."""
    import numpy as np

    fm = FUSED_MAPPING
    svcs = {name: _fm_service(device.type, name) for name in arms}
    out = {name: {"ranges": [[] for _ in range(fm["streams"])], "poses": [], "seconds": [],
                  "launches": {}} for name in svcs}
    rev_ticks = 0

    def advance(name, group):
        nonlocal rev_ticks
        svc, rec = svcs[name], out[name]
        if name == "host":
            for tick in group:
                res = svc.submit_bytes(tick)
                rev_ticks += any(r is not None for r in res)
                for i, r in enumerate(res):
                    if r is not None:
                        rec["ranges"][i].append(np.asarray(r.ranges).copy())
        else:
            for i, s in enumerate(svc.submit_bytes_backlog(group)):
                rec["ranges"][i] += [np.asarray(o.ranges).copy() for o in s]
        rec["poses"].append(_fm_pose_row(svc))

    for group in groups[: fm["warm"]]:
        for name in svcs:
            advance(name, group)
    for rec in out.values():
        rec.update(ranges=[[] for _ in range(fm["streams"])], poses=[])
    rev_ticks = 0
    base = {name: dict(dispatches=svc.fleet_ingest.dispatch_count,
                       mapper=svc.mapper.dispatch_count, mapper_ticks=svc.mapper.ticks,
                       revs=svc.fleet_ingest.scans_completed) for name, svc in svcs.items()}
    _sync(device)
    _reset_counts()
    for g, group in enumerate(groups[fm["warm"]:]):
        for name in (arms if g % 2 == 0 else arms[::-1]):
            before = _counts()
            t0 = time.perf_counter()
            advance(name, group)
            _sync(device)
            out[name]["seconds"].append(time.perf_counter() - t0)
            for k, v in _counts().items():
                out[name]["launches"][k] = out[name]["launches"].get(k, 0) + v - before.get(k, 0)
    launches = _counts()
    for name, svc in svcs.items():
        rec = out[name]
        rec["dispatches"] = svc.fleet_ingest.dispatch_count - base[name]["dispatches"]
        rec["mapper_dispatches"] = svc.mapper.dispatch_count - base[name]["mapper"]
        rec["mapper_ticks"] = svc.mapper.ticks - base[name]["mapper_ticks"]
        rec["revolutions"] = svc.fleet_ingest.scans_completed - base[name]["revs"]
        rec["map"] = svc.mapper.snapshot()
    if "fused" in svcs:
        eng = svcs["fused"].fleet_ingest
        out["kernel_inputs"] = (svcs["fused"].mapper.cfg, eng._state.map_log_odds.clone(),
                                eng._state.map_pose.clone(),
                                np.stack([r[1] for r in eng.last_recon]))
    out["rev_ticks"] = rev_ticks
    out["launches"] = launches
    return out


def _fm_same(a: dict, b: dict) -> bool:
    """Two runs' per-stream ranges (bitwise), drain poses and maps equal."""
    import numpy as np

    return (a["poses"] == b["poses"] and _fm_map_equal(a["map"], b["map"])
            and all(len(x) == len(y) and all(np.array_equal(u.view(np.int32), v.view(np.int32))
                                             for u, v in zip(x, y))
                    for x, y in zip(a["ranges"], b["ranges"])))


def _fm_loop_leg(device, ticks) -> dict:
    """The loop engine on both routes over the first ticks, tick by tick,
    with tests/test_fused_mapping.py's loop settings (loop_backend at its
    default: the card's engine on the card): installs, checks and the
    re-anchored poses equal."""
    over = dict(loop_enable=True, loop_submap_revs=2, loop_check_revs=2, loop_max_submaps=4,
                loop_candidates=1, loop_min_points=4, pose_graph_iters=16)
    arms = {"fused": _fm_service(device.type, "fused", **over),
            "host": _fm_service(device.type, "host", **over)}
    for svc in arms.values():
        svc.attach_loop_closure()
    corrected = {name: [] for name in arms}
    for tick in ticks:
        for name, svc in arms.items():
            svc.submit_bytes(tick)
            corrected[name].append([None if c is None else tuple(int(v) for v in c)
                                    for c in svc.last_corrected_poses])
    f, h = arms["fused"].loop, arms["host"].loop
    check(corrected["fused"] == corrected["host"],
          "fused_mapping loop leg: corrected poses differ between the routes")
    check(f.installs == h.installs and f.checks == h.checks,
          "fused_mapping loop leg: installs or checks differ between the routes")
    check(f.installs > 0 and f.checks > 0, "fused_mapping loop leg: nothing installed or checked")
    return {"ticks": len(ticks), "backend": f.backend, "installs": f.installs,
            "checks": f.checks, "accepted": f.status().get("accepted"),
            "poses_corrected": sum(c is not None for row in corrected["fused"] for c in row)}


def _fm_quarantine(device, ticks, mesh=None, stream: int = 1) -> dict:
    """The fused route (on ``mesh``; None: the service's default) under
    the health supervisor with ``stream``'s frames corrupted
    (driver/chaos.chaos_ticks, seed 3): its quarantine snapshot carries the
    ``ingest.map_*`` rows; every output, pose, transition and the final
    maps are returned for the comparison with the CPU."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosConfig, chaos_ticks
    from rplidar_ros2_driver_tpu_torch.driver.health import FleetHealth, HealthConfig

    fm = FUSED_MAPPING
    start, stop = fm["chaos_frames"]
    cticks = chaos_ticks(ticks, {stream: ChaosConfig(seed=3, start_frame=start, stop_frame=stop,
                                                     corrupt_rate=0.9, truncate_rate=0.5)})
    svc = _fm_service(device.type, "fused", mesh)
    fake = {"now": 0.0}
    # a revolution spans 5 ticks at 16 frames: starvation past 12 ticks
    health = FleetHealth(
        fm["streams"], HealthConfig(window_ticks=3, corrupt_ratio=0.5, starvation_ticks=12,
                                    suspect_ticks=2, probation_ticks=2, backoff_base_s=0.4,
                                    backoff_jitter=0.0, seed=5),
        clock=lambda: fake["now"], probes={stream: lambda: 0}, record_masks=True)
    svc.attach_health(health)
    snaps = []
    quarantine = svc._quarantine_stream

    def keep(i):
        quarantine(i)
        snaps.append(sorted(svc.stream_checkpoints[i]["ingest"]))

    svc._quarantine_stream = keep
    outs, poses = [], []
    for tick in cticks:
        res = svc.submit_bytes(tick)
        outs.append([None if r is None else np.asarray(r.ranges).copy() for r in res])
        poses.append(_fm_pose_row(svc))
        fake["now"] += 0.1
    return {"outs": outs, "poses": poses, "events": list(health.events),
            "map": svc.mapper.snapshot(), "quarantines": svc.quarantines,
            "rejoins": svc.rejoins, "snapshot_keys": snaps}


def _fm_quarantine_same(a: dict, b: dict) -> bool:
    import numpy as np

    def same(x, y):
        return (x is None) == (y is None) and (x is None or np.array_equal(x.view(np.int32),
                                                                          y.view(np.int32)))

    return (a["poses"] == b["poses"] and a["events"] == b["events"]
            and _fm_map_equal(a["map"], b["map"])
            and all(same(x, y) for ra, rb in zip(a["outs"], b["outs"]) for x, y in zip(ra, rb)))


def phase_fused_mapping(device) -> dict:
    """Config 18 on the card: the carried map (fused arm, one step a drain
    of T ticks) against the host route (one ingest step a tick plus one
    mapper step a mapping tick), both equal to each other and to the CPU
    run of the same arm; the dispatch and launch counts; the loop leg; the
    quarantine cycle held to the CPU service under the same chaos.  The
    profiled figures come later (:func:`fused_mapping_profile`), after the
    other phases' host timings."""
    fm = FUSED_MAPPING
    ticks, groups = _fm_scene()
    n_groups = len(groups)
    check(n_groups > fm["warm"] + 1, "fused_mapping: the scene is too short for a timed drain")
    card = _fm_drains(device, groups)
    cpu = {arm: _ref(None, ref_fm_drains, arm) for arm in ("fused", "host")}
    fused, host = card["fused"], card["host"]
    timed = n_groups - fm["warm"]
    n_ticks = timed * fm["T"]
    check(_fm_same(fused, host), "fused_mapping: the fused and host routes differ on the card")
    check(_fm_same(fused, cpu["fused"]), "fused_mapping: the fused arm differs from the CPU")
    check(_fm_same(host, cpu["host"]), "fused_mapping: the host-route arm differs from the CPU")
    check(fused["dispatches"] == timed, f"fused_mapping: {fused['dispatches']} fused steps for "
          f"{timed} drains, not one a drain")
    check(fused["mapper_dispatches"] == 0, "fused_mapping: the carried mapper launched a step")
    check(host["dispatches"] == n_ticks, "fused_mapping: host route not one ingest step a tick")
    check(host["mapper_dispatches"] == host["mapper_ticks"] > 0,
          "fused_mapping: host route not one mapper step a mapping tick")
    rows = {}
    for name, rec in (("fused", fused), ("host", host)):
        sec = sum(rec["seconds"])
        rows[name] = {"drains": timed, "ticks": n_ticks, "drains_per_s": timed / sec,
                      "ticks_per_s": n_ticks / sec, **_pcts(rec["seconds"]),
                      "dispatches": rec["dispatches"], "mapper_dispatches": rec["mapper_dispatches"],
                      "revolutions": rec["revolutions"], "launches": rec["launches"],
                      "cpu_drains_per_s": timed / sum(cpu[name]["seconds"])}
    if device.type == "cuda":
        fl, hl = fused["launches"], host["launches"]
        for k in ("coarse_scores", "fine_scores", "log_odds_update"):
            # every tick of the paced scene stages frames: no skip applies
            check(fl[k] == n_ticks, f"fused_mapping: {fl[k]} {k} launches for {n_ticks} ticks, "
                  "not one a tick for the fleet")
            check(hl[k] == host["mapper_dispatches"],
                  f"fused_mapping: host route {k} launches != mapper steps")
        for name, lc in (("fused", fl), ("host", hl)):
            rec = card[name]
            check(lc["temporal_median"] == rec["revolutions"],
                  f"fused_mapping {name}: B1 launches != completed revolutions")
            check(lc["beam_min"] == n_ticks + card["rev_ticks"],
                  f"fused_mapping {name}: B4 launches != ticks + ticks completing revolutions")
            check(lc["shift_sad"] == card["rev_ticks"],
                  f"fused_mapping {name}: B5 launches != ticks completing revolutions")
    row = {"phase": "fused_mapping", "config": "bench.py GRADED[18] (bench_fused_mapping)",
           "streams": fm["streams"], "T": fm["T"], "ticks_completing_revolutions":
           card["rev_ticks"], "arms": rows, "launches": card["launches"]}
    row["loop"] = _fm_loop_leg(device, ticks[: fm["loop_ticks"]])
    q_ticks = ticks[: fm["chaos_ticks"]]
    qc, qr = _fm_quarantine(device, q_ticks), _ref(None, ref_fm_quarantine)
    check(qc["quarantines"] >= 1 and qc["rejoins"] >= 1,
          "fused_mapping quarantine: stream 1 was never quarantined and rejoined")
    check(all(f"ingest.map_{k}" in keys for keys in qc["snapshot_keys"]
              for k in ("log_odds", "pose", "origin_xy", "revision")),
          "fused_mapping quarantine: the snapshot lacks the ingest.map_* rows")
    check(_fm_quarantine_same(qc, qr), "fused_mapping quarantine: the card differs from the CPU")
    row["quarantine"] = {"ticks": len(q_ticks), "quarantines": qc["quarantines"],
                         "rejoins": qc["rejoins"],
                         "walk": [(t, s, a, b) for (t, s, a, b) in qc["events"]]}
    row["kernel_inputs"] = card["kernel_inputs"]
    return row


def _fm_scene() -> tuple:
    """Config 18's paced ring: every tick, and the drains of T ticks."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm = FUSED_MAPPING
    ticks = fleet_byte_ticks(ring_frames(fm["revs"], fm["points"]), fm["streams"], fm["run"],
                             int(Ans.MEASUREMENT_DENSE_CAPSULED))
    return ticks, [ticks[g * fm["T"] : (g + 1) * fm["T"]] for g in range(len(ticks) // fm["T"])]


def ref_fm_drains(arm: str) -> dict:
    """The CPU reference of one arm of the fused_mapping phase's drains
    (the arms are independent services): config 18 over the same drains
    on the host."""
    import torch

    return _fm_drains(torch.device("cpu"), _fm_scene()[1], (arm,))[arm]


def ref_fm_quarantine() -> dict:
    """The CPU reference of the fused_mapping phase's quarantine cycle."""
    import torch

    return _fm_quarantine(torch.device("cpu"), _fm_scene()[0][: FUSED_MAPPING["chaos_ticks"]])


def fused_mapping_profile(device, row: dict, card: str) -> dict:
    """The profiled half of the phase, run after the other phases' host
    timings: B6/B7/B8 at this path's tick (N = 4, G = 128, the fused arm's
    last carried map and sweep) against their plain versions, events and
    device ms; device operations a drain and the idle share of both arms
    (a fresh warmed service, ``profile_groups`` drains)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm = FUSED_MAPPING
    t0 = time.perf_counter()
    cfg, lo, pose, pts = row.pop("kernel_inputs")
    check(cfg.match_backend == "pallas", "fused_mapping: the card's matcher is not B6/B7/B8")
    ptd = torch.from_numpy(pts).to(device)
    pq, okm = tsm.quantize_points(ptd[..., :2].contiguous(), ptd[..., 2] > 0.5, cfg)
    lo_t, _, _, posec, trig, pose_t = _map_kernel_args(
        cfg, lo.cpu().numpy(), pose.cpu().numpy(), pq.cpu().numpy(), okm.cpu().numpy(), device)
    cos_q, sin_q = tsm._theta_trig(pose_t, cfg)
    coarse = (lo_t, pq, okm, posec, trig)
    mq, _sc = smk.coarse_scores_plain(*coarse, cfg)
    n = fm["streams"]
    uv = torch.zeros((n, 2), dtype=torch.int32, device=device)
    fine = (pq, okm, posec, cos_q, sin_q, uv)
    calls = {
        "coarse_scores": (lambda: smk.coarse_scores_kernel(*coarse, cfg),
                          lambda: smk.coarse_scores_plain(*coarse, cfg)),
        "fine_scores": (lambda: smk.fine_scores_kernel(mq, *fine, cfg),
                        lambda: smk.fine_scores_plain(mq, *fine, cfg)),
        "log_odds_update": (lambda: smk.log_odds_update_kernel(*coarse, cfg),
                            lambda: smk.log_odds_update_plain(*coarse, cfg)),
    }
    nvalid = int(okm.sum())
    bounds = match_bounds(cfg, n, nvalid, fine)
    kernels = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"fused_mapping: {name} differs from its plain version at the N={n} tick")
        kernels[name] = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, iters=20, warmup=3),
                         "device_ms": device_ms(kern),
                         "plain_device_ms": device_ms(plain, iters=10),
                         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                         "max_abs_err": 0.0}
    ticks = fleet_byte_ticks(ring_frames(fm["warm"] + fm["profile_groups"] + 1, fm["points"]),
                             fm["streams"], fm["run"], int(Ans.MEASUREMENT_DENSE_CAPSULED))
    groups = [ticks[g * fm["T"] : (g + 1) * fm["T"]]
              for g in range(fm["warm"] + fm["profile_groups"])]
    profiled = {}
    for name in ("fused", "host"):
        svc = _fm_service("cuda", name)
        drain = ((lambda g, s=svc: s.submit_bytes_backlog(g)) if name == "fused"
                 else (lambda g, s=svc: [s.submit_bytes(t) for t in g]))
        for g in groups[: fm["warm"]]:
            drain(g)
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            for g in groups[fm["warm"]:]:
                drain(g)
            _sync(device)
            wall = time.perf_counter() - w0
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in ev)
        k = fm["profile_groups"]
        profiled[name] = {"device_ops_per_drain": len(ev) / k,
                          "device_busy_ms_per_drain": busy_us / k / 1e3,
                          "profiled_wall_ms_per_drain": wall / k * 1e3,
                          "device_idle_share": 1.0 - busy_us / 1e6 / wall}
    row.update(kernels_at_path_tick={"shape": {"N": n, "G": cfg.grid, "B": cfg.beams,
                                               "valid_beams": nvalid}, **kernels},
               profiled=profiled, profile_seconds=time.perf_counter() - t0, card=card)
    emit(row)
    return row


def _pod_keys(shards: int) -> dict:
    """Config 15's pod settings: lanes auto, snapshots every 4 ticks,
    backoff 0.45 s (cap 2 s) without jitter, probation 2."""
    fo = FAILOVER
    return dict(fleet_ingest_backend="fused", map_enable=True, shard_count=shards, shard_lanes=0,
                failover_snapshot_ticks=fo["snapshot_ticks"], shard_backoff_base_s=fo["backoff_s"],
                shard_backoff_max_s=2.0, shard_backoff_jitter=0.0,
                shard_probation_ticks=fo["probation"])


def _fo_params(backend: str):
    """Config 15: the fused FleetMapper on the map (no de-skew)."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    fo = FAILOVER
    return DriverParams(filter_backend=backend, filter_chain=("clip", "median", "voxel"),
                        filter_window=fo["window"], voxel_grid_size=fo["grid"],
                        voxel_cell_m=fo["cell_m"], map_backend="fused", map_grid=fo["map_grid"],
                        map_cell_m=fo["map_cell_m"], map_match_window=fo["match_window_m"],
                        **_pod_keys(fo["shards"]))


def _carried_params(backend: str):
    """Config 18's carried route (the fused_mapping phase's params, one
    tick a dispatch) as a 2-shard pod."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    fm = FUSED_MAPPING
    return DriverParams(
        filter_backend=backend, filter_chain=("clip", "median", "voxel"),
        filter_window=fm["window"], voxel_grid_size=fm["grid"], voxel_cell_m=fm["cell_m"],
        deskew_enable=True, sweep_reconstruct_window=fm["recon_window"],
        deskew_profile_beams=fm["profile_beams"], deskew_shift_window=fm["shift_window"],
        map_backend="host", fused_mapping_backend="fused", map_grid=fm["map_grid"],
        map_cell_m=fm["map_cell_m"], **_pod_keys(FAILOVER["carried_shards"]))


def _fo_pod(backend: str, kill, params, streams: int, beams: int, capacity: int, run: int,
            mesh=None):
    """A warmed pod on ``backend`` with a fake clock; ``kill`` a (shard,
    start, stop) chaos kill or None; ``mesh`` one mesh for every shard, or
    None: the pod's groups of the visible cards (one card a shard with as
    many cards as shards, one card: all on it), each shard on its group's
    lead card."""
    from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosConfig, ShardChaosSchedule
    from rplidar_ros2_driver_tpu_torch.parallel.service import ElasticFleetService
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fake = {"now": 0.0}
    pod = ElasticFleetService(params, streams, beams=beams, capacity=capacity,
                              fleet_ingest_buckets=(run,), clock=lambda: fake["now"], mesh=mesh)
    if kill is not None:
        pod.attach_shard_chaos(ShardChaosSchedule(ShardChaosConfig(kills=(kill,))))
    pod.precompile([int(Ans.MEASUREMENT_DENSE_CAPSULED)])
    return pod, fake


def _out_digest(out):
    """A published output's bytes (ranges, intensities, points, mask,
    voxel grid) as one short hash; None stays None."""
    import hashlib

    import numpy as np

    if out is None:
        return None
    h = hashlib.sha1()
    for f in ("ranges", "intensities", "points_xy", "point_mask", "voxel"):
        h.update(np.ascontiguousarray(np.asarray(getattr(out, f))).tobytes())
    return h.hexdigest()[:16]


def _shard_cards(pod) -> list:
    """Each shard's lead card index (-1: the host)."""
    return [-1 if m.device.type == "cpu" else m.device.index for m in pod.meshes]


def _fo_record(pod) -> dict:
    """What the CPU comparison holds: events, replay plan, counters, the
    snapshot store's ticks and each stream's final map row (hashed), after
    a run; and what two card layouts of one pod are also held equal on:
    the stored snapshots' bytes (hashed) and the scheduled seam's logs."""
    rows = []
    for i in range(pod.streams):
        got = pod.topology.placement(i)
        mapper = None if got is None else pod.shards[got[0]].mapper
        if mapper is None:
            rows.append(None)
            continue
        row = mapper.snapshot_stream(got[1])
        rows.append(_digest(row[k] for k in ("log_odds", "pose", "origin_xy", "revision")))
    store = sorted(pod._snap.items())
    return {"events": [list(e) for e in pod.events], "plan": pod.replay_plan(),
            "evacuations": pod.evacuations, "readmits": pod.readmits,
            "migrations": pod.migrations, "map_rows": rows,
            "snap_ticks": [(i, tick) for i, (tick, _snap) in store],
            "snaps": [(i, _digest(part[k] for name in sorted(snap) for part in (snap[name],)
                                  for k in sorted(part)))
                      for i, (_tick, snap) in store],
            "rung_log": list(pod.rung_log), "scale_events": list(pod.scale_events),
            "steal_log": [] if pod.scheduler is None else list(pod.scheduler.steal_log)}


def _fo_cpu(kill, params, ticks, streams: int, beams: int, capacity: int, run: int,
            warm: int) -> dict:
    """The same pod on the CPU over the same ticks and fake clock."""
    pod, fake = _fo_pod("cpu", kill, params, streams, beams, capacity, run)
    outs = []
    for tick in ticks:
        outs.append([_out_digest(r) for r in pod.submit_bytes(tick)])
        fake["now"] += FAILOVER["dt"]
    return {"outs": outs[warm:], **_fo_record(pod)}


def _fo_timed(device, ticks, mesh=None) -> dict:
    """Config 15's tick-paired pass on the card: the baseline pod and the
    chaos pod alternate which goes first each tick, the whole post-warm
    loop under guards.steady_state (nothing built, no new device memory on
    any card, no undeclared synchronisation)."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.utils import guards

    fo = FAILOVER
    backend = "cuda" if device.type == "cuda" else "cpu"
    pods = {}
    for name, kill in (("base", None), ("chaos", fo["kill"])):
        pods[name] = _fo_pod(backend, kill, _fo_params(backend), fo["streams"], fo["beams"],
                             fo["capacity"], fo["points"] // 40, mesh)
    for tick in ticks[: fo["warm"]]:
        for pod, fake in pods.values():
            pod.submit_bytes(tick)
            fake["now"] += fo["dt"]
    chaos = pods["chaos"][0]
    d0 = [sh.fleet_ingest.dispatch_count for sh in chaos.shards]
    secs = {"base": [], "chaos": []}
    outs = {"base": [], "chaos": []}
    _sync(device)
    _reset_counts()
    with guards.steady_state(tag="failover pair"):
        for t, tick in enumerate(ticks[fo["warm"]:]):
            for name in (("base", "chaos") if t % 2 == 0 else ("chaos", "base")):
                pod, fake = pods[name]
                t0 = time.perf_counter()
                res = pod.submit_bytes(tick)
                secs[name].append(time.perf_counter() - t0)
                outs[name].append([_out_digest(r) for r in res])
                fake["now"] += fo["dt"]
    launches, card_launches = _counts(), _card_counts()
    n = len(ticks) - fo["warm"]
    dispatches = [sh.fleet_ingest.dispatch_count - d for sh, d in zip(chaos.shards, d0)]
    base_s, deg_s = np.asarray(secs["base"]), np.asarray(secs["chaos"])
    # which ticks are slow: the snapshot refreshes ((t + 1) % 4 == 0) apart
    # from the rest, and each pod's three slowest ticks
    tick_no = np.arange(fo["warm"], fo["warm"] + n)
    snap = (tick_no + 1) % fo["snapshot_ticks"] == 0
    split = {name: {"snapshot_tick_p50_ms": float(np.median(v[snap])) * 1e3,
                    "other_tick_p50_ms": float(np.median(v[~snap])) * 1e3,
                    "slowest": [[int(tick_no[i]), float(v[i]) * 1e3]
                                for i in np.argsort(v)[::-1][:3]]}
             for name, v in (("base", base_s), ("chaos", deg_s))}
    return {"tick_split": split, "pods": {k: v[0] for k, v in pods.items()}, "outs": outs,
            "launches": launches, "card_launches": card_launches, "ticks": n,
            "dispatches": dispatches,
            "base_ticks_per_s": n / float(base_s.sum()),
            "chaos_ticks_per_s": n / float(deg_s.sum()),
            "paired_median_tick_ratio": float(np.median(base_s / np.maximum(deg_s, 1e-9))),
            "total_ratio": float(base_s.sum() / max(float(deg_s.sum()), 1e-9)),
            "base_tick_ms": _pcts(base_s), "chaos_tick_ms": _pcts(deg_s),
            "chaos_tick_max_ms": float(deg_s.max()) * 1e3}


def _fo_carried(device, mesh=None) -> dict:
    """The carried-map arm on ``device``: config 18's route as a 2-shard
    pod, killed after its second snapshot.  Returns the record, the
    per-tick output hashes, the victim's map revision each tick, whether
    the store ever held a "map" key or lacked the ingest.map_* rows, and
    the run's launches (by kernel and by card)."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm, fo = FUSED_MAPPING, FAILOVER
    ticks = fleet_byte_ticks(ring_frames(fo["carried_revs"], fm["points"]), fm["streams"],
                             fm["run"], int(Ans.MEASUREMENT_DENSE_CAPSULED))
    backend = "cuda" if device.type == "cuda" else "cpu"
    pod, fake = _fo_pod(backend, fo["carried_kill"], _carried_params(backend), fm["streams"],
                        fm["beams"], fm["capacity"], fm["run"], mesh)
    _sync(device)
    _reset_counts()
    outs, revs, store_ok = [], [], True
    victims = set(pod.topology.streams_on(fo["carried_kill"][0]))
    for tick in ticks:
        outs.append([_out_digest(r) for r in pod.submit_bytes(tick)])
        fake["now"] += fo["dt"]
        revs.append({i: int(pod.shards[pod.topology.placement(i)[0]].mapper.snapshot_stream(
            pod.topology.placement(i)[1])["revision"]) for i in sorted(victims)})
        store_ok &= all("map" not in snap and all(f"ingest.map_{k}" in snap["ingest"]
                                                  for k in ("log_odds", "pose", "origin_xy",
                                                            "revision"))
                        for _t, snap in pod._snap.values())
    _sync(device)
    return {"outs": outs, "revs": revs, "store_ok": store_ok, "launches": _counts(),
            "card_launches": _card_counts(), "backend": pod.shards[0].mapper.backend,
            "victims": sorted(victims), "pod": pod, **_fo_record(pod)}


def _guard_controls(device) -> dict:
    """The sentinels fire on the card (so a clean guarded loop means
    something): an undeclared ``.item()`` and device->host copy raise
    under no_implicit_transfers, the same copy inside declared_sync
    passes, and a fresh segment raises under no_new_device_memory (at
    least 64 MiB, and more than every cached free byte of the card, so no
    cached block can serve it)."""
    import torch

    from rplidar_ros2_driver_tpu_torch.utils import guards

    x = torch.ones(4, device=device)
    fired = {}
    for name, op in (("item", lambda: x.sum().item()), ("d2h_copy", lambda: x.cpu())):
        try:
            with guards.no_implicit_transfers():
                op()
            fired[name] = False
        except RuntimeError:
            fired[name] = True
    with guards.no_implicit_transfers(), guards.declared_sync():
        x.cpu()
    torch.cuda.empty_cache()
    stats = torch.cuda.memory_stats(device)
    free = stats.get("reserved_bytes.all.current", 0) - stats.get("allocated_bytes.all.current", 0)
    try:
        with guards.no_new_device_memory():
            y = torch.empty(max(64 << 20, free + (2 << 20)), dtype=torch.uint8, device=device)
            del y
        fired["new_segment"] = False
    except AssertionError:
        fired["new_segment"] = True
    check(all(fired.values()), f"failover: a sentinel did not fire on the card: {fired}")
    return fired


def phase_failover(device, mesh=None, cpu_runs=None) -> dict:
    """Config 15 on the card (the failover pod's per-tick seam, ROADMAP
    A.10a): the tick-paired baseline and chaos pods under the steady-state
    guard, the chaos pod byte-equal to its CPU run and the survivors to the
    baseline pod, the kill -> evacuate -> re-admit cycle's counts, one
    dispatch a tick on every surviving shard, only chaos losses; then the
    carried-map arm held to its CPU run.  Runs before any profiler session
    (its host times); the profiled half is :func:`failover_profile`.
    ``mesh`` serves every shard (None: the pod's groups of cards); ``cpu_runs``
    keeps the CPU runs for a second layout (:func:`_memo`).  ``records`` holds what
    ``--pod-cards`` compares across layouts."""
    from rplidar_ros2_driver_tpu_torch.driver.health import ShardState

    fo = FAILOVER
    ticks = _fo_ticks()
    timed = _fo_timed(device, ticks, mesh)
    chaos = timed["pods"]["chaos"]
    card = _fo_record(chaos)
    cpu, cpu_s = _ref(cpu_runs, ref_fo_pod)
    check(all(e[3].startswith("chaos:") for e in chaos.events if e[1] == "lost"),
          f"failover: a loss that the chaos schedule did not cause: {chaos.events}")
    base = timed["pods"]["base"]
    check(base.evacuations == 0 and not any(e[1] == "lost" for e in base.events),
          f"failover: the baseline pod lost a shard (a drain raised): {base.events}")
    check(chaos.evacuations == 1 and chaos.readmits == 1 and chaos.migrations == 4,
          f"failover: {chaos.evacuations} evacuations, {chaos.readmits} re-admissions, "
          f"{chaos.migrations} migrations (want 1, 1, 4)")
    check(all(hs.state is ShardState.UP for hs in chaos.shard_health),
          f"failover: shards not all UP: {[hs.state.name for hs in chaos.shard_health]}")
    check(chaos.topology.unhosted() == [], f"failover: unhosted {chaos.topology.unhosted()}")
    for s, got in enumerate(timed["dispatches"]):
        check(s == fo["kill"][0] or got == timed["ticks"],
              f"failover: surviving shard {s} made {got} dispatches in {timed['ticks']} ticks")
    check(timed["outs"]["chaos"] == cpu["outs"], "failover: the chaos pod's outputs differ "
          "from its CPU run")
    for key in ("events", "plan", "evacuations", "readmits", "migrations", "map_rows",
                "snap_ticks"):
        check(card[key] == cpu[key], f"failover: the chaos pod's {key} differ from its CPU run")
    migrated = sorted({e[2] for e in chaos.events if e[1] in ("evacuated", "migrated")})
    survivors = [i for i in range(fo["streams"]) if i not in migrated]
    check(all(b[i] == c[i] for b, c in zip(timed["outs"]["base"], timed["outs"]["chaos"])
              for i in survivors), "failover: a survivor's output differs from the baseline pod")
    published = sum(o is not None for row in timed["outs"]["chaos"] for o in row)
    lc = timed["launches"]
    if device.type == "cuda":
        for k in ("temporal_median", "coarse_scores", "fine_scores", "log_odds_update"):
            check(lc[k] > 0, f"failover: {k} never launched on config 15's path")
    c_card = _fo_carried(device, mesh)
    c_cpu = _ref(cpu_runs, ref_fo_carried)
    check(c_card["backend"] == "carried", "failover carried arm: the mapper is not the carried one")
    check(c_card["store_ok"], "failover carried arm: a stored snapshot held a map key or lacked "
          "the ingest.map_* rows")
    kill_t = fo["carried_kill"][1]
    check(c_card["evacuations"] == 1 and c_card["readmits"] == 1
          and c_card["events"][0][0] == kill_t >= 2 * fo["snapshot_ticks"],
          "failover carried arm: not one evacuation after the second snapshot and one "
          "re-admission")
    check(all(r[i] > c_card["revs"][kill_t][i] > 0 for r in c_card["revs"][-1:]
              for i in c_card["victims"]),
          "failover carried arm: a victim's map revision stopped after migrating")
    for key in ("outs", "revs", "events", "plan", "map_rows", "snap_ticks"):
        check(c_card[key] == c_cpu[key], f"failover carried arm: {key} differ from the CPU run")
    if device.type == "cuda":
        for k in ("temporal_median", "beam_min", "shift_sad", "coarse_scores", "fine_scores",
                  "log_odds_update"):
            check(c_card["launches"][k] > 0, f"failover carried arm: {k} never launched")
    launches = {k: lc.get(k, 0) + c_card["launches"].get(k, 0)
                for k in set(lc) | set(c_card["launches"])}
    ev = dict(chaos.last_evacuation)
    row = {
        "phase": "failover", "config": "bench.py GRADED[15] (bench_failover)",
        "streams": fo["streams"], "shards": fo["shards"], "lanes": chaos.topology.lanes,
        "ticks": timed["ticks"], "warm": fo["warm"], "published": published,
        "base_ticks_per_s": timed["base_ticks_per_s"],
        "chaos_ticks_per_s": timed["chaos_ticks_per_s"],
        "paired_median_tick_ratio": timed["paired_median_tick_ratio"],
        "total_ratio": timed["total_ratio"], "survivor_ratio_claim": 0.95,
        "base_tick_ms": timed["base_tick_ms"], "chaos_tick_ms": timed["chaos_tick_ms"],
        "chaos_tick_max_ms": timed["chaos_tick_max_ms"], "tick_split": timed["tick_split"],
        "evacuation": {k: ev[k] for k in ("tick", "shard", "streams", "snapshot_pull_ms",
                                          "restore_scatter_ms", "first_tick_ms")},
        "events": [list(e) for e in chaos.events], "migrated": migrated,
        "dispatches": timed["dispatches"], "steady_state": "clean",
        "cpu": {"ticks": len(ticks), "seconds": cpu_s, "equal": True},
        "carried": {"streams": FUSED_MAPPING["streams"], "shards": fo["carried_shards"],
                    "ticks": len(c_card["outs"]), "victims": c_card["victims"],
                    "events": c_card["events"], "victim_revisions":
                    [c_card["revs"][kill_t], c_card["revs"][-1]], "launches": c_card["launches"],
                    "cpu_equal": True},
        "launches": lc,
        "shard_cards": _shard_cards(chaos),
    }
    if device.type == "cuda":
        row["guard_controls"] = _guard_controls(device)
    row["failover_launches"] = launches
    row["card_launches"] = {"config15": timed["card_launches"],
                            "carried": c_card["card_launches"]}
    row["hosting_cards"] = {"config15": _shard_cards(chaos),
                            "carried": _shard_cards(c_card["pod"])}
    row["records"] = {"outs": timed["outs"], "chaos": card,
                      "base": _fo_record(timed["pods"]["base"]),
                      "carried": {k: c_card[k] for k in ("outs", "revs", "events", "plan",
                                                         "map_rows", "snap_ticks", "snaps")}}
    return row


def _fo_ticks() -> list:
    """Config 15's paced ring: one revolution a stream a tick."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fo = FAILOVER
    return fleet_byte_ticks(ring_frames(fo["revs"], fo["points"]), fo["streams"],
                            fo["points"] // 40, int(Ans.MEASUREMENT_DENSE_CAPSULED))


def ref_fo_pod() -> tuple:
    """The CPU reference of the failover phase's chaos pod, and its
    seconds."""
    fo = FAILOVER
    c0 = time.perf_counter()
    got = _fo_cpu(fo["kill"], _fo_params("cpu"), _fo_ticks(), fo["streams"], fo["beams"],
                  fo["capacity"], fo["points"] // 40, fo["warm"])
    return got, time.perf_counter() - c0


def ref_fo_carried() -> dict:
    """The CPU reference of the failover phase's carried-map arm."""
    import torch

    got = _fo_carried(torch.device("cpu"))
    got.pop("pod")
    return got


def _profiled(device, step, k: int) -> dict:
    """``k`` calls of ``step`` (a pod tick or drain each) under
    torch.profiler, every card synchronised before and after: device
    operations and busy ms a call, the wall ms a call and the idle share —
    in all and per card (``per_card``: a card's busy time against the
    same wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(k):
            step()
        _sync(device)
        wall = time.perf_counter() - w0
    per: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ops_us = per.setdefault(e.device_index, [0, 0.0])
            ops_us[0] += 1
            ops_us[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _n, us in per.values())
    return {"device_ops": sum(n for n, _us in per.values()) / k,
            "device_busy_ms": busy_us / k / 1e3, "wall_ms": wall / k * 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "per_card": {d: {"device_ops": n / k, "device_busy_ms": us / k / 1e3,
                             "device_idle_share": 1.0 - us / 1e6 / wall}
                         for d, (n, us) in sorted(per.items())}}


def failover_profile(device, row: dict, card: str, mesh=None) -> dict:
    """The profiled half of the failover phase, after the other phases'
    host timings: a fresh warmed config-15 pod without chaos (``mesh`` as
    in :func:`phase_failover`) over ``profile_ticks`` ticks — device
    operations and busy ms a pod tick and the idle share, in all and per
    card."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fo = FAILOVER
    t0 = time.perf_counter()
    run = fo["points"] // 40
    k = fo["profile_ticks"]
    ticks = fleet_byte_ticks(ring_frames(fo["warm"] + k, fo["points"]), fo["streams"], run,
                             int(Ans.MEASUREMENT_DENSE_CAPSULED))
    pod, fake = _fo_pod("cuda", None, _fo_params("cuda"), fo["streams"], fo["beams"],
                        fo["capacity"], run, mesh)
    for tick in ticks[: fo["warm"]]:
        pod.submit_bytes(tick)
        fake["now"] += fo["dt"]
    live = iter(ticks[fo["warm"]:])

    def step():
        pod.submit_bytes(next(live))
        fake["now"] += fo["dt"]

    got = _profiled(device, step, k)
    row.update(profiled={"ticks": k, "device_ops_per_pod_tick": got["device_ops"],
                         "device_busy_ms_per_pod_tick": got["device_busy_ms"],
                         "profiled_wall_ms_per_pod_tick": got["wall_ms"],
                         "device_idle_share": got["device_idle_share"],
                         "per_card": got["per_card"], "shard_cards": _shard_cards(pod)},
               profile_seconds=time.perf_counter() - t0, card=card)
    emit({k: v for k, v in row.items() if k not in _INTERNAL})
    return row


def stream_data_ticks(frames, run: int, ans: int, t0: float) -> list:
    """bench.py ``_stream_data_ticks``: one stream's data ticks of ``run``
    wire frames, 1.25 ms a frame from ``t0``."""
    ticks, t = [], t0
    for i in range(0, len(frames), run):
        batch = []
        for f in frames[i : i + run]:
            t += 1.25e-3
            batch.append((f, t))
        ticks.append((ans, batch))
    return ticks


def storm_wall_schedule(per_stream_ticks, rates, *, stall_period, stall_frames, phase, storm_at,
                        storm_len) -> list:
    """bench.py ``_storm_wall_schedule`` (config 19's arrivals): stream s's
    source makes ``rates[s]`` data ticks a wall tick; a wall tick the chaos
    stall schedule stalls (per-stream phase) buffers at the source and the
    next open one delivers the whole buffer — a reconnect storm — plus one
    fleet-wide outage of ``storm_len`` wall ticks from ``storm_at``.  Wall
    ticks in the ``offer_bytes`` layout, with a tail that flushes every
    buffer."""
    from rplidar_ros2_driver_tpu_torch.driver.chaos import (
        FAULT_STALL,
        ChaosConfig,
        ChaosSchedule,
    )

    streams = len(per_stream_ticks)
    sched = ChaosSchedule(ChaosConfig(stall_period=stall_period, stall_frames=stall_frames))
    pos = [0] * streams
    buf: list = [[] for _ in range(streams)]
    wall = []
    t = 0
    while True:
        producing = any(pos[s] < len(per_stream_ticks[s]) for s in range(streams))
        if not producing and not any(buf):
            break
        items: list = []
        for s in range(streams):
            take = per_stream_ticks[s][pos[s] : pos[s] + rates[s]]
            pos[s] += rates[s]
            buf[s].extend(take)
            stalled = (storm_at <= t < storm_at + storm_len
                       or sched.plan(t + phase * s) == FAULT_STALL)
            if stalled and producing:
                items.append(None)
            elif buf[s]:
                items.append(buf[s])
                buf[s] = []
            else:
                items.append(None)
        wall.append(items)
        t += 1
    return wall


def _sched_params(backend: str, c: dict, **over):
    """The scheduled pods' DriverParams: config 5's filter widths, the
    fused fleet ingest, snapshots every 4 ticks."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    sc = SCHEDULED
    return DriverParams(filter_backend=backend, filter_chain=("clip", "median", "voxel"),
                        filter_window=sc["window"], voxel_grid_size=sc["grid"],
                        voxel_cell_m=sc["cell_m"], fleet_ingest_backend="fused",
                        shard_count=c["shards"], failover_snapshot_ticks=sc["snapshot_ticks"],
                        **over)


def _sched_pod(params, c: dict, buckets: tuple, fake: dict, kill=None, world: bool = False,
               mesh=None):
    """A warmed scheduled pod: the shaper attached before precompile (the
    rung ladder is warmed there), the chaos kill after it, as the bench
    builds them; a fake clock.  ``mesh`` serves every shard; None gives
    each shard a card of its own (shard s on cuda:(s % cards); one card:
    all on it) or the host."""
    from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosConfig, ShardChaosSchedule
    from rplidar_ros2_driver_tpu_torch.parallel.service import ElasticFleetService
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    sc = SCHEDULED
    pod = ElasticFleetService(params, c["streams"], shards=c["shards"], beams=sc["beams"],
                              capacity=sc["capacity"], fleet_ingest_buckets=buckets,
                              clock=lambda: fake["now"], mesh=mesh)
    pod.attach_scheduler()
    pod.precompile([int(Ans.MEASUREMENT_DENSE_CAPSULED)])
    if kill is not None:
        pod.attach_shard_chaos(ShardChaosSchedule(ShardChaosConfig(kills=(kill,))))
    if world:
        pod.attach_world_map()
    return pod


def _engine_totals(pod) -> tuple:
    """(dispatches, per-rung dispatches) summed over the pod's engines."""
    table: dict = {}
    total = 0
    for sh in pod.shards:
        eng = sh.fleet_ingest
        for r, n in eng.rung_dispatches.items():
            table[r] = table.get(r, 0) + n
        total += eng.dispatch_count
    return total, table


def _losses(pod, mark: int, what: str) -> int:
    """Fail on a shard loss in ``pod.events[mark:]`` that the run did not
    plan.  A drain that raises (guard (c)'s undeclared sync, a failed
    launch) is caught at the pod's heartbeat boundary and shows only as a
    lost shard; a planned kill's reason starts ``chaos:``.  Returns the
    new mark."""
    for ev in pod.events[mark:]:
        if ev[1] == "lost":
            check(ev[3].startswith("chaos:"),
                  f"{what}: shard {ev[2]} lost at pod tick {ev[0]} to an unplanned fault: {ev[3]}")
    return len(pod.events)


def _check_accounting(pod, what: str, kills: int = 0) -> None:
    """Per engine: the rung and (rung, bucket) counters sum to the
    dispatch count, nothing overflowed max_revs.  Per pod: exactly
    ``kills`` shard losses, each a planned chaos kill, and as many
    evacuations."""
    lost = [(e[0], e[2], e[3]) for e in pod.events if e[1] == "lost"]
    check(pod.evacuations == kills == len(lost) and all(r.startswith("chaos:") for *_x, r in lost),
          f"{what}: {pod.evacuations} evacuations, losses {lost}; want {kills} planned chaos "
          "kill(s)")
    for s, sh in enumerate(pod.shards):
        eng = sh.fleet_ingest
        check(sum(eng.rung_dispatches.values()) == eng.dispatch_count,
              f"{what}: shard {s}'s per-rung dispatches do not sum to its dispatch count")
        check(sum(eng.rung_bucket_dispatches.values()) == eng.dispatch_count,
              f"{what}: shard {s}'s per-(rung, bucket) dispatches do not sum to its dispatch "
              "count")
        check(eng.revs_dropped == 0, f"{what}: shard {s} dropped {eng.revs_dropped} revolutions")


def _serve(device, pods: dict, wall, warm: int, tag: str, cap=None, on_tick=None) -> dict:
    """Drive ``pods`` (arm name -> (pod, fake clock)) over ``wall`` tick-
    paired, alternating which arm drains first; every wall tick from
    ``warm`` on runs under guards.steady_state on the card.  Per arm: the
    digests of every wall tick's outputs, each drain's wall seconds and
    its slowest shard drain; the deepest admission queue seen, the shadow
    admission's sheds and the launches of the guarded window (by kernel
    and by card)."""
    import contextlib

    from rplidar_ros2_driver_tpu_torch.utils import guards

    names = list(pods)
    outs = {n: [] for n in names}
    secs = {n: [] for n in names}
    shard_max = {n: [] for n in names}
    shadow = [[] for _ in range(len(wall[0]))]
    shadow_drops = [0] * len(wall[0])
    max_depth = 0
    stack = contextlib.ExitStack()
    d0 = {}
    marks = {n: len(pods[n][0].events) for n in names}
    try:
        for t, items in enumerate(wall):
            if t == warm:
                _sync(device)
                _reset_counts()
                d0 = {n: _engine_totals(pods[n][0])[0] for n in names}
                stack.enter_context(guards.steady_state(tag=tag))
            for name in (names if t % 2 == 0 else names[::-1]):
                pod, fake = pods[name]
                pod.offer_bytes(items)
                max_depth = max(max_depth, max(len(q) for q in pod.scheduler.queues))
                mark = len(pod.drain_log)
                t0 = time.perf_counter()
                got = pod.drain_scheduled()
                dt = time.perf_counter() - t0
                marks[name] = _losses(pod, marks[name], f"{tag} {name}")
                fake["now"] += SCHEDULED["dt"]
                outs[name].append([[_out_digest(o) for o in g] for g in got])
                if t >= warm:
                    secs[name].append(dt)
                    shard_max[name].append(max((e[4] for e in pod.drain_log[mark:]),
                                               default=0.0))
            if cap is not None:
                for s, item in enumerate(items):
                    for tick in item or ():
                        shadow[s].append(tick)
                        if len(shadow[s]) > cap:
                            shadow[s].pop(0)
                            shadow_drops[s] += 1
                    shadow[s].clear()
            if on_tick is not None:
                on_tick(t)
        _sync(device)
        launches, card_launches = _counts(), _card_counts()
    finally:
        stack.close()
    timed = len(wall) - warm
    arms = {}
    for n in names:
        total = _engine_totals(pods[n][0])[0]
        arms[n] = {"pod_ticks_per_s": timed / max(sum(secs[n]), 1e-9), "drain_ms": _pcts(secs[n]),
                   "losses": [(e[0], e[2], e[3]) for e in pods[n][0].events if e[1] == "lost"],
                   "slowest_shard_drain_ms": _pcts(shard_max[n]),
                   "dispatches_per_pod_drain": (total - d0[n]) / max(timed, 1),
                   "dispatches": total}
    return {"outs": outs, "arms": arms, "max_depth": max_depth, "shadow_drops": shadow_drops,
            "launches": launches, "card_launches": card_launches, "timed_ticks": timed}


def _last_data_tick(wall: list) -> list:
    """The last wall tick that offers any data (the profiled drain's)."""
    return next(items for items in reversed(wall) if any(items))


def _per_stream(per_tick: list) -> list:
    """Per stream, every output digest in order."""
    return [[d for tick in per_tick for d in tick[s]] for s in range(len(per_tick[0]))]


def _cpu_prefix(pod, fake: dict, wall, k: int) -> list:
    """One arm's CPU pod over the first ``k`` wall ticks: its per-wall-tick
    output digests."""
    got = []
    mark = len(pod.events)
    for items in wall[:k]:
        pod.offer_bytes(items)
        got.append([[_out_digest(o) for o in g] for g in pod.drain_scheduled()])
        mark = _losses(pod, mark, "the CPU run")
        fake["now"] += SCHEDULED["dt"]
    return got


def _sched_wall(n: int, deep=None) -> list:
    """Scheduled config ``n``'s wall ticks, as the bench builds them (config
    21's from ``deep``, the two streams on shard 0's lanes that burst)."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    sc, c = SCHEDULED, SCHEDULED[n]
    ans = int(Ans.MEASUREMENT_DENSE_CAPSULED)
    if n == 19:
        hot = max(1, c["streams"] // 4)
        rates = [2 if s < hot else 1 for s in range(c["streams"])]
        per_stream = [stream_data_ticks(ring_frames(c["revs"] * rates[s], sc["points"]),
                                        c["run"], ans, 1000.0 + 7.0 * s)
                      for s in range(c["streams"])]
        return storm_wall_schedule(per_stream, rates, stall_period=c["stall_period"],
                                   stall_frames=c["stall_frames"], phase=3,
                                   storm_at=len(per_stream[hot]) // (2 * rates[hot]),
                                   storm_len=c["storm_len"])
    if n == 20:
        live = max(1, c["streams"] // 4)
        need = [c["ticks_a"] + (c["collapse_len"] if s < live else 0) + c["recovery_len"]
                for s in range(c["streams"])]
        frames = ring_frames(max(need) + 4, sc["points"])
        data = [stream_data_ticks(frames, c["run"], ans, 1000.0 + 7.0 * s)
                for s in range(c["streams"])]
        wall = storm_wall_schedule([d[: c["ticks_a"]] for d in data], [1] * c["streams"],
                                   stall_period=c["stall_period"],
                                   stall_frames=c["stall_frames"], phase=3,
                                   storm_at=c["ticks_a"] // 3, storm_len=c["storm_len"])
        rem = [list(d[c["ticks_a"]: need[s]]) for s, d in enumerate(data)]
        for _ in range(c["collapse_len"]):
            wall.append([[rem[s].pop(0)] if s < live else None for s in range(c["streams"])])
        for _ in range(c["recovery_len"]):
            wall.append([[rem[s].pop(0)] for s in range(c["streams"])])
        return wall
    if n == 21:
        need = c["skew_len"] * c["burst"] + c["resume_len"] + 2
        revs = -(-(need * c["run"] * 40) // sc["points"]) + 2
        frames = ring_frames(revs, sc["points"])
        data = [stream_data_ticks(frames, c["run"], ans, 1000.0 + 7.0 * s)
                for s in range(c["streams"])]
        cursor = [0] * c["streams"]

        def take(s, k):
            got = data[s][cursor[s]: cursor[s] + k]
            cursor[s] += len(got)
            return list(got) or None

        wall = [[take(s, c["burst"] if s in deep else 1) for s in range(c["streams"])]
                for _ in range(c["skew_len"])]
        wall += [[None] * c["streams"] for _ in range(c["idle_len"])]
        wall += [[take(s, 1) for s in range(c["streams"])] for _ in range(c["resume_len"])]
        return wall
    revs = -(-(c["wall_len"] * c["run"] * 40) // sc["points"]) + 2
    frames = ring_frames(revs, sc["points"])
    data = [stream_data_ticks(frames, c["run"], ans, 1000.0 + 7.0 * s)
            for s in range(c["streams"])]
    return [[[data[s][t]] for s in range(c["streams"])] for t in range(c["wall_len"])]


def _cfg19_kill(wall_len: int) -> tuple:
    """Config 19's chaos kill: shard 1 near the end of the wall."""
    return (1, wall_len - max(4, wall_len // 5), 0)


def _sched_build(n: int, arm, backend: str, wall_len: int, mesh=None) -> tuple:
    """One arm's warmed pod of scheduled config ``n`` and its fake clock:
    ``arm`` is config 19's rung ladder, config 20's double buffer, config
    21's stealing and autoscaling, config 22's world map (on or off)."""
    c = SCHEDULED[n]
    fake = {"now": 0.0}
    if n == 19:
        params = _sched_params(backend, c, sched_rungs=arm, admission_max_backlog_ticks=c["cap"],
                               shard_starvation_ticks=2 * (c["storm_len"] + c["stall_frames"]))
        return _sched_pod(params, c, (c["run"],), fake, kill=_cfg19_kill(wall_len),
                          mesh=mesh), fake
    if n == 20:
        buckets = (4, c["run"])
        params = _sched_params(
            backend, c, sched_rungs=c["rungs"], admission_max_backlog_ticks=c["cap"],
            staging_double_buffer=arm, bucket_rungs=buckets if arm else (),
            shard_starvation_ticks=2 * (c["storm_len"] + c["stall_frames"]
                                        + c["collapse_len"]))
        return _sched_pod(params, c, buckets, fake, mesh=mesh), fake
    if n == 21:
        params = _sched_params(
            backend, c, sched_rungs=c["rungs"], admission_max_backlog_ticks=c["cap"],
            pod_hosts=c["hosts"], steal_threshold_ticks=2 if arm else 0,
            autoscale_enable=arm, autoscale_low_watermark=0.3,
            autoscale_high_watermark=0.75, autoscale_hysteresis_ticks=3,
            shard_starvation_ticks=4 * (c["skew_len"] + c["idle_len"] + c["resume_len"]))
        return _sched_pod(params, c, (c["run"],), fake, mesh=mesh), fake
    params = _sched_params(
        backend, c, map_enable=True, map_backend="fused", map_grid=c["map_grid"],
        map_cell_m=c["map_cell_m"], shard_starvation_ticks=4 * c["wall_len"],
        world_map_enable=arm, map_tile_backend="auto",
        world_tile_cells=c["tile_cells"], world_max_submaps=c["world_cap"],
        world_merge_revs=c["merge_revs"], world_publish_ticks=c["publish_ticks"])
    return _sched_pod(params, c, (c["run"],), fake, world=arm, mesh=mesh), fake


def _deep_streams(pod) -> list:
    """Config 21's bursting streams: the first two on shard 0's lanes."""
    return [s for s in pod.topology.lane_streams(0) if s is not None][:2]


def _wall_digest(wall) -> str:
    import hashlib
    import pickle

    return hashlib.sha1(pickle.dumps(wall)).hexdigest()[:16]


def ref_sched_prefix(n: int, arm, k: int) -> tuple:
    """The CPU reference of scheduled config ``n``'s arm over its first
    ``k`` wall ticks: (output digests a wall tick, the digest of the wall
    ticks fed, config 22's world then — merges, evictions, accumulation,
    the published tiles' version and grid — or None)."""
    from rplidar_ros2_driver_tpu_torch.mapping.tiles import snapshot_grid

    if n == 21:
        pod, fake = _sched_build(n, arm, "cpu", 0)
        wall = _sched_wall(n, _deep_streams(pod))
    else:
        wall = _sched_wall(n)
        pod, fake = _sched_build(n, arm, "cpu", len(wall))
    got = _cpu_prefix(pod, fake, wall, k)
    world = None
    if n == 22 and arm:
        w, snap = pod.world, pod.world.snapshot()
        world = {"merges": w.merges, "evictions": w.evictions, "acc": w.accumulation(),
                 "version": None if snap is None else snap.version,
                 "grid": None if snap is None else snapshot_grid(snap)}
    return got, _wall_digest(wall[:k]), world


def _sched_cpu(cpu_runs, n: int, name: str, arm, wall, k: int) -> tuple:
    """Scheduled config ``n``'s CPU reference for arm ``name``, held to have
    been fed the card's first ``k`` wall ticks."""
    got, fed, world = _ref(cpu_runs, ref_sched_prefix, n, arm, k)
    check(fed == _wall_digest(wall[:k]),
          f"config {n} {name}: the CPU run was fed other wall ticks than the card")
    return got, world


def _sched_result(run: dict, pods: dict, wall: list, **extra) -> dict:
    """A scheduled config's result: its figures (``extra``), the guarded
    window's launches, the pods and the last data tick (for the profiled
    drain), the shard -> card map, and the records ``--pod-cards`` holds
    across layouts (every arm's per-wall-tick outputs and
    :func:`_fo_record`)."""
    got = {n: p for n, (p, _f) in pods.items()}
    return {"wall_ticks": len(wall), "arms": run["arms"], **extra, "launches": run["launches"],
            "card_launches": run["card_launches"], "timed_ticks": run["timed_ticks"],
            "pods": got, "profile_items": _last_data_tick(wall),
            "shard_cards": _shard_cards(next(iter(got.values()))),
            "records": {"outs": run["outs"], "pods": {n: _fo_record(p) for n, p in got.items()}}}


def _cfg19(device, mesh=None, cpu_runs=None) -> dict:
    """Config 19 (bench_elastic_serving): the static arm pinned to rung 1
    against the adaptive ladder (1, 2, 4, 8) over the reconnect-storm
    trace, admission cap 8, shard 1 killed near the end."""
    sc, c = SCHEDULED, SCHEDULED[19]
    wall = _sched_wall(19)
    kill_tick = _cfg19_kill(len(wall))[1]
    backend = "cuda" if device.type == "cuda" else "cpu"
    arms = {"static": (1,), "adaptive": c["rungs"]}
    pods = {name: _sched_build(19, r, backend, len(wall), mesh) for name, r in arms.items()}
    weights = {}

    def on_tick(t):
        if t == kill_tick:
            weights["at_kill"] = [pods["adaptive"][0].topology.weight_of(s)
                                  for s in range(c["streams"])]

    run = _serve(device, pods, wall, c["warm"], "config 19 pair", cap=c["cap"], on_tick=on_tick)
    st, ad = pods["static"][0], pods["adaptive"][0]
    for name, (pod, _f) in pods.items():
        _check_accounting(pod, f"config 19 {name}", kills=1)
        check(list(pod.scheduler.admission_drops) == run["shadow_drops"],
              f"config 19 {name}: sheds {pod.scheduler.admission_drops} != the shadow "
              f"admission's {run['shadow_drops']}")
    _, st_table = _engine_totals(st)
    _, ad_table = _engine_totals(ad)
    check(not any(n for r, n in st_table.items() if r != 1),
          f"config 19: the static arm dispatched above rung 1: {st_table}")
    check(ad_table.get(max(c["rungs"]), 0) > 0,
          f"config 19: the adaptive arm never reached rung {max(c['rungs'])}: {ad_table}")
    check(run["arms"]["adaptive"]["dispatches"] < run["arms"]["static"]["dispatches"],
          "config 19: the adaptive arm did not dispatch fewer times than the static arm")
    check(run["max_depth"] <= c["cap"], f"config 19: backlog {run['max_depth']} over the bound")
    check(sum(run["shadow_drops"]) > 0, "config 19: the outage never forced a shed")
    check(_per_stream(run["outs"]["static"]) == _per_stream(run["outs"]["adaptive"]),
          "config 19: the static and adaptive arms' outputs differ")
    groups: dict = {}
    for et, ev, stream, *rest in ad.events:
        if ev == "evacuated":
            groups.setdefault((et, rest[0]), []).append(stream)
    for key, group in groups.items():
        w = [weights["at_kill"][s] for s in group]
        check(w == sorted(w, reverse=True), f"config 19: evacuation {key} not heaviest first")
    k = sc["cpu_wall_ticks"][19]
    for name, r in arms.items():
        check(run["outs"][name][:k] == _sched_cpu(cpu_runs, 19, name, r, wall, k)[0],
              f"config 19 {name}: the card's outputs differ from the CPU run")
    return _sched_result(run, pods, wall, kill_tick=kill_tick,
                         rung_dispatches={"static": st_table, "adaptive": ad_table},
                         sheds=run["shadow_drops"], max_depth=run["max_depth"],
                         evacuated=list(groups.values()), cpu_wall_ticks=k)


def _cfg20(device, mesh=None, cpu_runs=None) -> dict:
    """Config 20 (bench_async_serving): the double buffer and the bucket
    ladder (4, 16) against the single-buffered static bucket, both on the
    rung ladder (1, 2, 4, 8): the storm trace, then an occupancy collapse,
    then recovery."""
    sc, c = SCHEDULED, SCHEDULED[20]
    buckets = (4, c["run"])
    wall = _sched_wall(20)
    backend = "cuda" if device.type == "cuda" else "cpu"
    arms = {"pr14": False, "async": True}
    pods = {name: _sched_build(20, on, backend, len(wall), mesh) for name, on in arms.items()}
    seeded = {}

    def on_tick(t):
        if t == 0:
            model = pods["async"][0].scheduler.model.table_ms()
            seeded["keys"] = sorted(model)

    run = _serve(device, pods, wall, c["warm"], "config 20 pair", cap=c["cap"], on_tick=on_tick)
    sync_pod, async_pod = pods["pr14"][0], pods["async"][0]
    for name, (pod, _f) in pods.items():
        _check_accounting(pod, f"config 20 {name}")
        check(list(pod.scheduler.admission_drops) == run["shadow_drops"],
              f"config 20 {name}: sheds differ from the shadow admission")
    hits = {n: sum(sh.fleet_ingest.staging_overlap_hits for sh in p.shards)
            for n, (p, _f) in pods.items()}
    switches = {n: sum(sh.fleet_ingest.bucket_switches for sh in p.shards)
                for n, (p, _f) in pods.items()}
    check(hits["async"] > 0 and hits["pr14"] == 0,
          f"config 20: staging overlap hits {hits} (want > 0 with the double buffer, 0 off)")
    check(switches["async"] >= 2 and switches["pr14"] == 0,
          f"config 20: bucket switches {switches} (want >= 2 on the ladder, 0 off)")
    want_keys = sorted(f"T{r}xM{b}" for r in c["rungs"] for b in buckets)
    check(seeded.get("keys") == want_keys,
          f"config 20: the latency model after the first drain {seeded.get('keys')} does not "
          f"price every warmed (rung, bucket) {want_keys}")
    check(run["max_depth"] <= c["cap"], "config 20: backlog over the bound")
    check(_per_stream(run["outs"]["pr14"]) == _per_stream(run["outs"]["async"]),
          "config 20: the double-buffered arm's outputs differ from the single-buffered arm's")
    k = sc["cpu_wall_ticks"][20]
    for name, on in arms.items():
        check(run["outs"][name][:k] == _sched_cpu(cpu_runs, 20, name, on, wall, k)[0],
              f"config 20 {name}: the card's outputs differ from the CPU run")
    rb = {}
    for sh in async_pod.shards:
        for (r, b), n in sh.fleet_ingest.rung_bucket_dispatches.items():
            rb[f"T{r}xM{b}"] = rb.get(f"T{r}xM{b}", 0) + n
    return _sched_result(run, pods, wall, staging_overlap_hits=hits, bucket_switches=switches,
                         async_rung_bucket_dispatches=rb, sheds=run["shadow_drops"],
                         max_depth=run["max_depth"], cpu_wall_ticks=k)


def _cfg21(device, mesh=None, cpu_runs=None) -> dict:
    """Config 21 (bench_pod_scaleout): work stealing plus the autoscaler
    against the static pod, 8 streams over 4 shards on 2 hosts: skewed
    bursts on shard 0's two streams, an idle stretch, a full resume."""
    sc, c = SCHEDULED, SCHEDULED[21]
    backend = "cuda" if device.type == "cuda" else "cpu"
    arms = {"static": False, "pod": True}
    pods = {name: _sched_build(21, on, backend, 0, mesh) for name, on in arms.items()}
    deep = _deep_streams(pods["pod"][0])
    wall = _sched_wall(21, deep)
    run = _serve(device, pods, wall, c["warm"], "config 21 pair", cap=c["cap"])
    pp, ps = pods["pod"][0], pods["static"][0]
    for name, (pod, _f) in pods.items():
        _check_accounting(pod, f"config 21 {name}")
        check(list(pod.scheduler.admission_drops) == run["shadow_drops"],
              f"config 21 {name}: sheds differ from the shadow admission")
    check(ps.scheduler.steals == 0 and ps.scale_events == [],
          "config 21: the static pod stole or scaled")
    check(pp.scheduler.steals > 0 and pp.steal_drops == 0,
          f"config 21: {pp.scheduler.steals} steals, {pp.steal_drops} dropped")
    check(pp.scheduler.steal_ticks == sum(n for *_, n in pp.scheduler.steal_log),
          "config 21: steal_ticks != the sum of the steal log")
    check(all(src == 0 and stream in deep for _dst, src, stream, _n in pp.scheduler.steal_log),
          f"config 21: a steal off another shard than the deep one: {pp.scheduler.steal_log}")
    downs = [e for e in pp.scale_events if e[1] == "down"]
    ups = [e for e in pp.scale_events if e[1] == "up"]
    check(downs and ups and pp.pod_status()["parked"] == [],
          f"config 21: no full scale cycle: {pp.scale_events}")
    check(run["max_depth"] <= c["cap"], "config 21: backlog over the bound")
    per = {n: _per_stream(run["outs"][n]) for n in pods}
    check(per["pod"] == per["static"], "config 21: the pod arm's outputs differ from the static "
          "arm's")
    check(all(len(o) > 0 for o in per["pod"]), "config 21: a stream never published")
    k = sc["cpu_wall_ticks"][21]
    for name, on in arms.items():
        check(run["outs"][name][:k] == _sched_cpu(cpu_runs, 21, name, on, wall, k)[0],
              f"config 21 {name}: the card's outputs differ from the CPU run")
    return _sched_result(run, pods, wall, deep=deep, steals=pp.scheduler.steals,
                         steal_ticks=pp.scheduler.steal_ticks, scale_events=pp.scale_events,
                         sheds=run["shadow_drops"], max_depth=run["max_depth"], cpu_wall_ticks=k)


def _cfg22(device, mesh=None, cpu_runs=None) -> dict:
    """Config 22 (bench_map_serving): 6 streams over 3 shards with the
    fused FleetMapper on 256² at 0.05 m; the world map arm (merges on the
    drain, tiles published on its idle half) against per-stream pulls."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.mapping.tiles import snapshot_grid
    from rplidar_ros2_driver_tpu_torch.ops.tile_quant import fuse_planes_np
    sc, c = SCHEDULED, SCHEDULED[22]
    wall = _sched_wall(22)
    backend = "cuda" if device.type == "cuda" else "cpu"
    arms = {"tiles": True, "pull": False}
    pods = {name: _sched_build(22, on, backend, len(wall), mesh) for name, on in arms.items()}
    world = pods["tiles"][0].world
    reads = {"tiles": [], "pull": []}
    k = sc["cpu_wall_ticks"][22]
    at_k: dict = {}

    def counts(name):
        return [dict(sh.fleet_ingest.rung_dispatches) for sh in pods[name][0].shards]

    def on_tick(t):
        check(len(world._members) <= world.cfg.max_submaps, "config 22: membership over the cap")
        if t == k - 1:
            # the world as the CPU run leaves it after its last wall tick
            at_k.update(acc=world.accumulation(), merges=world.merges,
                        evictions=world.evictions, snapshot=world.snapshot())
        if world.snapshot() is None:
            return
        before = counts("tiles")
        x0 = time.perf_counter()
        grid = snapshot_grid(world.snapshot())
        t_tiles = time.perf_counter() - x0
        x0 = time.perf_counter()
        acc = np.zeros((c["map_grid"], c["map_grid"]), np.int64)
        pull = pods["pull"][0]
        for s, sh in enumerate(pull.shards):
            for lane, stream in enumerate(pull.topology.lane_streams(s)):
                if stream is not None:
                    acc += np.asarray(sh.mapper.snapshot_stream(lane)["log_odds"], np.int64)
        t_pull = time.perf_counter() - x0
        check(counts("tiles") == before, "config 22: a map read moved a dispatch counter")
        check(grid.shape == acc.shape == (c["map_grid"], c["map_grid"]),
              "config 22: a read grid is misshapen")
        if t >= c["warm"]:
            reads["tiles"].append(t_tiles)
            reads["pull"].append(t_pull)

    run = _serve(device, pods, wall, c["warm"], "config 22 pair", on_tick=on_tick)
    for name, (pod, _f) in pods.items():
        _check_accounting(pod, f"config 22 {name}")
    check(counts("tiles") == counts("pull"),
          "config 22: the world arm's dispatch counts differ from the pull arm's")
    check(world.merges >= c["world_cap"] + 1 and world.evictions >= 1,
          f"config 22: {world.merges} merges, {world.evictions} evictions")
    check(world.serving_version >= 1 and world.snapshot() is not None,
          "config 22: no tile snapshot was published")
    check(np.array_equal(world.accumulation(),
                         fuse_planes_np([m.plane for m in world._members])),
          "config 22: the accumulation differs from the sum of its members")
    check(_per_stream(run["outs"]["tiles"]) == _per_stream(run["outs"]["pull"]),
          "config 22: the world arm's outputs differ from the pull arm's")
    cpu = {name: _sched_cpu(cpu_runs, 22, name, on, wall, k) for name, on in arms.items()}
    for name, (got, _world) in cpu.items():
        check(run["outs"][name][:k] == got,
              f"config 22 {name}: the card's outputs differ from the CPU run")
    # the card's world after k wall ticks against the CPU run's
    cw = cpu["tiles"][1]
    check(at_k["merges"] == cw["merges"] >= 1 and at_k["evictions"] == cw["evictions"],
          f"config 22: after {k} wall ticks the card's world has {at_k['merges']} merges, "
          f"{at_k['evictions']} evictions; the CPU's {cw['merges']}, {cw['evictions']}")
    check(np.array_equal(at_k["acc"], cw["acc"]),
          f"config 22: after {k} wall ticks the card's world accumulation differs from the CPU's")
    snap = at_k["snapshot"]
    check(snap is not None and cw["version"] is not None and snap.version == cw["version"]
          and np.array_equal(snapshot_grid(snap), cw["grid"]),
          f"config 22: after {k} wall ticks the card's published tiles differ from the CPU's")
    got = _sched_result(run, pods, wall, merges=world.merges, evictions=world.evictions,
                        serving_version=world.serving_version, tiles=world.snapshot().tiles,
                        compression_ratio=world.snapshot().compression_ratio,
                        read_ms={n: _pcts(v) for n, v in reads.items()}, cpu_wall_ticks=k,
                        world_card=world.device.index)
    # the world on card 0, fed by every shard's card
    got["records"]["world"] = {
        "at_cpu_ticks": _digest([at_k["acc"], snapshot_grid(at_k["snapshot"])]),
        "end": _digest([world.accumulation(), snapshot_grid(world.snapshot())]),
        "merges": world.merges, "evictions": world.evictions,
        "serving_version": world.serving_version}
    return got


def phase_scheduled(device, mesh=None, cpu_runs=None) -> dict:
    """Scheduled serving (ROADMAP A.10b) on the card: bench.py configs
    19-22 at full geometry, two pods per config drained tick-paired under
    guards.steady_state — rung and bucket switches, snapshot pulls, the
    kill and evacuation, steals, park and unpark, the world's merges and
    publications — each arm byte-equal to the other and to its CPU run
    over the first wall ticks, the bench's identities asserted.  Runs
    before any profiler session; the profiled drains are
    :func:`scheduled_profile`.  ``mesh`` and ``cpu_runs`` as in
    :func:`phase_failover`."""
    row = {"phase": "scheduled", "configs": {}}
    launches: dict = {}
    for n, fn in ((19, _cfg19), (20, _cfg20), (21, _cfg21), (22, _cfg22)):
        c0 = time.perf_counter()
        got = fn(device, mesh, cpu_runs)
        # guards (a) and (b) raise when the guarded window closes; guard
        # (c) and a failed launch raise inside a drain, where the pod's
        # heartbeat boundary turns them into a lost shard: clean means
        # every arm lost exactly its planned chaos kills
        planned = 1 if n == 19 else 0
        losses = {arm: v["losses"] for arm, v in got["arms"].items()}
        clean = all(len(v) == planned and all(r.startswith("chaos:") for *_x, r in v)
                    for v in losses.values())
        check(clean, f"scheduled: config {n}'s shard losses {losses} are not its {planned} "
              "planned kill(s)")
        # every check above held: the arms and the CPU runs
        got.update(seconds=time.perf_counter() - c0,
                   steady_state="clean" if clean else "violated", arms_equal=True,
                   cpu_equal=True)
        for k, v in got["launches"].items():
            launches[k] = launches.get(k, 0) + v
        row["configs"][n] = got
    if device.type == "cuda":
        check(all(row["configs"][n]["launches"].get("temporal_median", 0) > 0
                  for n in (19, 20, 21, 22)), "scheduled: B1 never launched on a config")
        for k in ("coarse_scores", "fine_scores", "log_odds_update"):
            check(row["configs"][22]["launches"].get(k, 0) > 0,
                  f"scheduled: {k} never launched on config 22's path")
    row["scheduled_launches"] = launches
    return row


def scheduled_profile(device, row: dict, card: str) -> dict:
    """The profiled half of the scheduled phase, after the other phases'
    host timings: one more drain of each config's new arm (its last wall
    tick offered again) under torch.profiler — device operations, busy ms
    and the idle share, in all and per card — then the phase's line."""
    t0 = time.perf_counter()
    arms = {19: "adaptive", 20: "async", 21: "pod", 22: "tiles"}
    for n, arm in arms.items():
        cfg = row["configs"][n]
        pod = cfg["pods"][arm]
        pod.offer_bytes(cfg["profile_items"])
        got = _profiled(device, pod.drain_scheduled, 1)
        cfg["profiled_drain"] = {"arm": arm, **got}
    out = {k: v for k, v in row.items() if k not in ("configs", *_INTERNAL)}
    out["configs"] = {n: {k: v for k, v in cfg.items() if k not in _INTERNAL}
                      for n, cfg in row["configs"].items()}
    out.update(profile_seconds=time.perf_counter() - t0, card=card)
    emit(out)
    return row


# ---------------------------------------------------------------------------
# checkpoints: the sharded checkpoints of the service and the mapper
# ---------------------------------------------------------------------------


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


def _snap_equal(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _ckpt_service(backend: str, median: str, window: int = None, mesh=None):
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    over = {"median_backend": median}
    if window is not None:
        over["filter_window"] = window
    svc = ShardedFilterService(_fleet_params(backend, "host", **over), CHECKPOINTS["streams"],
                               beams=FLEET["beams"], capacity=FLEET["capacity"], mesh=mesh)
    svc.precompile()
    return svc


def _ckpt_service_arm(device, median: str, ticks, tmp: str, meshes=(None, None)) -> dict:
    """Config 10's service (N = 8, W = 64, 2048 beams, 256x256 grid) with
    the ``median`` backend: saved mid-trace, loaded into a fresh service,
    both continued over the rest of the trace byte-equal; the restored
    state byte-equal to the saved one (the ``inc`` backend's recomputed
    sorted window too).  ``meshes``: the saving and the loading service's
    meshes (None: the default card)."""
    backend = "cuda" if device.type == "cuda" else "cpu"
    save_at = CHECKPOINTS["save_tick"]
    svc = _ckpt_service(backend, median, mesh=meshes[0])
    for scans in ticks[:save_at]:
        svc.submit(scans)
    path = os.path.join(tmp, f"service_{median}")
    _sync(device)
    t0 = time.perf_counter()
    svc.save_sharded(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    saved = svc.snapshot()
    fresh = _ckpt_service(backend, median, mesh=meshes[1])
    t0 = time.perf_counter()
    check(fresh.load_sharded(path), f"checkpoints: the {median} service's checkpoint refused")
    _sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    check(_snap_equal(fresh.snapshot(), saved),
          f"checkpoints: the restored {median} state differs from the saved one")
    if median == "inc":
        check(exact(fresh._state.median_sorted, svc._state.median_sorted)[0],
              "checkpoints: the recomputed sorted window differs")
    compared = 0
    for scans in ticks[save_at:]:
        for a, b in zip(svc.submit(scans), fresh.submit(scans)):
            check((a is None) == (b is None) and (a is None or _same_output(a, b)),
                  f"checkpoints: the restored {median} service diverged")
            compared += a is not None
    check(compared > 0, "checkpoints: nothing compared after the restore")
    check(_snap_equal(fresh.snapshot(), svc.snapshot()),
          f"checkpoints: the {median} services ended in different states")
    stats = {"save_ms": save_ms, "load_ms": load_ms, "bytes_on_disk": _dir_bytes(path),
             "saved_at_tick": save_at, "outputs_compared": compared}
    return stats, svc, path, saved


def _ckpt_mapper(device, tmp: str, load_on=None) -> dict:
    """Config 12's fused FleetMapper (N = 4, 256x256 at 0.05 m, 2048
    beams): saved mid-trace, loaded into a fresh mapper (on ``load_on``,
    default ``device``), both continued byte-equal; another grid refuses
    the checkpoint untouched."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

    backend = "cuda" if device.type == "cuda" else "cpu"
    n, b = MAPPING["streams"], MAPPING["beams"]
    ticks, _truth = room_fleet_ticks(n, b, MAPPING["ticks"])
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    save_at = CHECKPOINTS["map_save_tick"]

    def mapper(on=device, **over):
        m = FleetMapper(_map_params(backend, **over), n, beams=b, device=on)
        m.precompile()
        return m

    m = mapper()
    for pts in ticks[:save_at]:
        m.submit_points(pts, masks, live)
    path = os.path.join(tmp, "mapper")
    _sync(device)
    t0 = time.perf_counter()
    m.save_sharded(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    saved = m.snapshot()
    fresh = mapper(load_on or device)
    t0 = time.perf_counter()
    check(fresh.load_sharded(path), "checkpoints: the mapper's checkpoint refused")
    _sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    check(_snap_equal(fresh.snapshot(), saved), "checkpoints: the restored map differs")
    for pts in ticks[save_at:]:
        for a, c in zip(m.submit_points(pts, masks, live), fresh.submit_points(pts, masks, live)):
            check(np.array_equal(a.pose_q, c.pose_q) and a.score == c.score,
                  "checkpoints: the restored mapper diverged")
    check(_snap_equal(fresh.snapshot(), m.snapshot()), "checkpoints: the mappers' maps differ")
    other = mapper(map_grid=MAPPING["grid"] // 2)
    other.submit_points(ticks[0], masks, live)
    before = other.snapshot()
    check(not other.load_sharded(path) and _snap_equal(other.snapshot(), before),
          "checkpoints: a mapper of another grid took the checkpoint")
    return {"save_ms": save_ms, "load_ms": load_ms, "bytes_on_disk": _dir_bytes(path),
            "saved_at_tick": save_at, "ticks_after": len(ticks) - save_at}


def phase_checkpoints(device) -> dict:
    """The sharded checkpoints (utils/checkpoint_sharded.py) on the card:
    config 10's service with the sort (B1) and ``inc`` (B2) medians and
    config 12's fused mapper (B6-B8), each saved mid-trace, loaded into a
    fresh one and continued byte-equal; then a checkpoint of another
    window refused with the state untouched, the ``.old`` fallback, an
    overwrite in place.  Save and load ms and the bytes on disk."""
    import shutil

    n = CHECKPOINTS["streams"]
    revs = make_revolutions(CHECKPOINTS["seed"], n * CHECKPOINTS["ticks"], FLEET["points"])
    ticks = [revs[k * n:(k + 1) * n] for k in range(CHECKPOINTS["ticks"])]
    tmp = tempfile.mkdtemp(prefix="rpl_ckpt_")
    _sync(device)
    _reset_counts()
    try:
        # DCP's first save in a process pays a one-time set-up of seconds:
        # taken on a one-element state and reported apart
        import torch

        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded

        c0 = time.perf_counter()
        checkpoint_sharded.save_sharded(os.path.join(tmp, "first"),
                                        {"x": torch.zeros(1, device=device)})
        first_save_ms = (time.perf_counter() - c0) * 1e3
        arms = {}
        for median in ("inc", "pallas"):  # the sort arm's service stays for the cases below
            arms[median], svc, path, saved = _ckpt_service_arm(device, median, ticks, tmp)
        mapper = _ckpt_mapper(device, tmp)
        backend = "cuda" if device.type == "cuda" else "cpu"
        # another window: refused, the live state untouched
        other = _ckpt_service(backend, "pallas", window=FLEET["window"] // 2)
        other.submit(ticks[0])
        before = other.snapshot()
        check(not other.load_sharded(path) and _snap_equal(other.snapshot(), before),
              "checkpoints: a service of another window took the checkpoint")
        check(not other.load_sharded(os.path.join(tmp, "absent")),
              "checkpoints: an absent checkpoint loaded")
        # the rotation's crash window: the previous checkpoint at .old
        shutil.move(path, path + ".old")
        fresh = _ckpt_service(backend, "pallas")
        check(fresh.load_sharded(path) and _snap_equal(fresh.snapshot(), saved),
              "checkpoints: the .old fallback failed")
        # an overwrite in place keeps the newest, and no sibling
        over = os.path.join(tmp, "overwrite")
        svc.save_sharded(over)
        svc.submit(ticks[0])
        svc.save_sharded(over)
        newest = svc.snapshot()
        again = _ckpt_service(backend, "pallas")
        check(again.load_sharded(over) and _snap_equal(again.snapshot(), newest),
              "checkpoints: the overwrite in place did not keep the newest")
        check(not os.path.exists(over + ".old") and not os.path.exists(over + ".saving"),
              "checkpoints: the overwrite left a sibling behind")
        _sync(device)
        launches = _counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if device.type == "cuda":
        for k in ("temporal_median", "sorted_replace", "coarse_scores", "fine_scores",
                  "log_odds_update"):
            check(launches.get(k, 0) > 0, f"checkpoints: {k} never launched")
    row = {"phase": "checkpoints", "first_save_ms": first_save_ms, "service": arms,
           "mapper": mapper,
           "wrong_geometry_refused": True, "old_fallback": True, "overwrite_in_place": True,
           "launches": launches}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# scenarios: the scenario matrix (bench config 23) over the port
# ---------------------------------------------------------------------------


def phase_scenarios(device) -> dict:
    """bench.py config 23 at its full geometry through
    tools/scenario_matrix on the card: the fused FleetMapper arm (B6-B8)
    equal to the host matcher in all 12 cells, the de-skew probe's B4/B5
    estimate equal to the host estimator's, claims 1-5; each loop probe's
    fused engine on the card equal to the same probe on the CPU.  Each
    cell's end_pose_err_cells and map_f1 are printed beside the committed
    JAX CPU figures (artifacts/scenario_matrix_cpu.json: a recorded
    comparison, not a gate)."""
    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    t0 = time.perf_counter()

    def host(kind, chaos, fleet, base_seed, n_revs, grid, cell, beams):
        check(base_seed == smx.SEED, f"scenarios: seed {base_seed}")
        return _ref(None, ref_scenario_cell, kind, chaos, fleet, n_revs, grid, cell, beams)

    _sync(device)
    _reset_counts()
    res = smx.scenario_matrix(smoke=False, device=device, host=host)
    _sync(device)
    launches = _counts()
    matrix_s = time.perf_counter() - t0
    check(res["matrix_cells"] == 12 and all(c["fused_equal"] for c in res["scenario_matrix"]),
          "scenarios: the fused arm was not held to the host matcher in every cell")
    cpu_probes = {}
    for chaos in smx.CHAOS:
        cpu, cpu_probes[chaos] = _ref(None, ref_loop_probe, *_loop_probe_args(chaos))
        check(cpu == res["loop_probe"][chaos],
              f"scenarios: the {chaos} loop probe on the card differs from the CPU's")
    if device.type == "cuda":
        for k in ("beam_min", "shift_sad", "coarse_scores", "fine_scores", "log_odds_update"):
            check(launches.get(k, 0) > 0, f"scenarios: {k} never launched")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "artifacts", "scenario_matrix_cpu.json")) as f:
        jax_cpu = json.load(f)
    jcells = {(c["scene"], c["chaos"], c["fleet"]): c for c in jax_cpu["scenario_matrix"]}
    beside = []
    for c in res["scenario_matrix"]:
        j = jcells.get((c["scene"], c["chaos"], c["fleet"]), {})
        beside.append({"cell": f"{c['scene']}/{c['chaos']}/{c['fleet']}",
                       "end_pose_err_cells": c["end_pose_err_cells"],
                       "jax_cpu_end_pose_err_cells": j.get("end_pose_err_cells"),
                       "map_f1": c["map_f1"], "jax_cpu_map_f1": j.get("map_f1"),
                       "host_scans_per_s": c["scans_per_sec"],
                       "fused_ticks_per_s": c["fused_ticks_per_sec"],
                       "fused_dispatches": c["fused_dispatches"]})
    row = {"phase": "scenarios", "cells": beside,
           "deskew_probe": res["deskew_probe"], "loop_probe": res["loop_probe"],
           "decay_probe": res["decay_probe"], "structural": res["structural"],
           "worst_end_pose_err_cells": res["worst_end_pose_err_cells"],
           "worst_map_f1": res["worst_map_f1"], "host_scans_per_s": res["scans_per_sec"],
           "geometry": {k: res[k] for k in ("grid", "cell_m", "loop_grid", "loop_cell_m",
                                            "beams", "fleets")},
           "loop_probe_equal_cpu": True, "launches": launches, "matrix_seconds": matrix_s,
           "cpu_probe_seconds": cpu_probes}
    emit(row)
    return row


def ref_scenario_cell(kind: str, chaos: str, fleet: int, n_revs: int, grid: int, cell: float,
                      beams: int) -> tuple:
    """The CPU reference of one scenario-matrix cell: the host matcher's
    (record, streams, poses, maps) (tools/scenario_matrix.host_arm)."""
    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    return smx.host_arm(kind, chaos, fleet, smx.SEED, n_revs, grid, cell, beams)


def _loop_probe_args(chaos: str) -> tuple:
    """A scenario loop probe's arguments at config 23's geometry, as
    scenario_matrix gives them."""
    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    g = smx.geometry(smoke=False)
    return (chaos, g["fleets"][-1], g["probe_revs"], g["loop_grid"], g["loop_cell"], g["beams"])


def ref_loop_probe(chaos: str, streams: int, n_revs: int, grid: int, cell: float,
                   beams: int) -> tuple:
    """The CPU reference of one scenario loop probe, and its seconds."""
    import torch

    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    c0 = time.perf_counter()
    got = smx.loop_probe(chaos, streams, n_revs, grid, cell, beams, smx.SEED,
                         torch.device("cpu"))
    return got, time.perf_counter() - c0


# ---------------------------------------------------------------------------
# tooling: the CLI's doctor/view/udev, the container, compat, the examples
# ---------------------------------------------------------------------------


def _cli(argv) -> tuple:
    """The package's CLI in process: (exit code, standard output)."""
    import contextlib
    import io

    from rplidar_ros2_driver_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def _example(script: str, argv) -> tuple:
    """One script of examples/torch/ in process: (exit code, output)."""
    import contextlib
    import importlib.util
    import io

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{script[:-3]}", os.path.join(here, "examples", "torch", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


def phase_tooling(device) -> dict:
    """The CLI's ``doctor`` (every row PASS but the serial port's WARN, the
    torch backend on the card), ``view --pgm`` and ``udev`` (the JAX
    package's text, by digest), the composable-node container's two nodes
    publishing over the bus (each with the chain on the card: B1), compat's
    force scan against the simulator, and the four examples/torch/ scripts
    on the card at the lengths of the JAX suite's tests/test_examples.py.
    On a CPU device (a rehearsal) every step runs with ``--cpu``."""
    import hashlib
    import re

    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.launch import NodeContainer

    row = {"phase": "tooling"}
    # on the card unless the phase is rehearsed on the host
    host = [] if device.type == "cuda" else ["--cpu"]
    _sync(device)
    _reset_counts()
    c0 = time.perf_counter()
    rc, out = _cli(["doctor", "--port", "/dev/definitely_not_a_lidar", *host])
    rows = re.findall(r"^\[(\w+)\s*\] ([^:]+): (.*)$", out, re.M)
    levels = {name: level for level, name, _ in rows}
    check(rc == 0 and [n for _, n, _ in rows] == DOCTOR_ROWS
          and all(v == "PASS" for k, v in levels.items() if k != "serial port")
          and levels["serial port"] == "WARN", f"tooling: doctor rows {rows} (rc {rc})")
    row["doctor"] = {"rc": rc, "rows": {n: f"{lvl}: {d}" for lvl, n, d in rows},
                     "seconds": time.perf_counter() - c0}
    c0 = time.perf_counter()
    pgm = os.path.join(tempfile.mkdtemp(prefix="rpl_view_"), "view.pgm")
    rc, out = _cli(["view", "--scans", "3", "--pgm", pgm, *host])
    with open(pgm, "rb") as f:
        head = f.read(15)
    check(rc == 0 and head.startswith(b"P5\n256 256\n255"), f"tooling: view --pgm ({rc}, {head})")
    row["view"] = {"rc": rc, "pgm_header": head.decode("ascii", "replace"),
                   "seconds": time.perf_counter() - c0}
    rc, out = _cli(["udev"])
    digest = hashlib.sha256(out.encode()).hexdigest()
    check(rc == 0 and digest == UDEV_SHA256, f"tooling: udev text digest {digest}")
    row["udev"] = {"rc": rc, "sha256": digest}
    c0 = time.perf_counter()
    with NodeContainer() as cont:
        for name in ("lidar_a", "lidar_b"):
            cont.add_node(name, DriverParams(dummy_mode=True,
                                             filter_chain=("clip", "median", "voxel"),
                                             **({"filter_backend": "cpu"} if host else {})))
        subs = [cont.bus.subscribe(f"/{name}/scan") for name in ("lidar_a", "lidar_b")]
        check(cont.configure_all() and cont.activate_all(), "tooling: container bring-up failed")
        got = [0, 0]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and min(got) < 5:
            for i, s in enumerate(subs):
                got[i] += len(s.drain())
            time.sleep(0.02)
        devices = sorted({str(n.chain.device) for n in cont.nodes.values()})
    check(min(got) >= 5 and not cont.nodes and devices == [str(device)],
          f"tooling: composed nodes published {got} on {devices}")
    row["container"] = {"scans": got, "devices": devices, "seconds": time.perf_counter() - c0}
    row["compat"] = _compat_force_scan()
    row["examples"] = {}
    for script, argv, expect in EXAMPLES:
        c0 = time.perf_counter()
        rc, out = _example(script, [*argv, *host])
        check(rc == 0 and expect in out, f"tooling: example {script} (rc {rc}): {out[-2000:]}")
        row["examples"][script] = {"rc": rc, "seconds": time.perf_counter() - c0,
                                   "last_line": out.strip().splitlines()[-1]}
    _sync(device)
    row["launches"] = _counts()
    if device.type == "cuda":
        for k in ("temporal_median", "sliding_median"):
            check(row["launches"].get(k, 0) > 0, f"tooling: {k} never launched")
    emit(row)
    return row


def _compat_force_scan() -> dict:
    """compat.RPlidarDriver.startScan(force=True) against the simulator:
    FORCE_SCAN goes out and revolutions come back."""
    from rplidar_ros2_driver_tpu_torch import compat
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice

    sim = SimulatedDevice().start()
    try:
        drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                              motor_warmup_s=0.0, legacy_warmup_s=0.0)
        facade = compat.RPlidarDriver(drv)
        check(facade.connect("sim", 0) and facade.startScan(force=True),
              "tooling: compat connect/force scan failed")
        batch = facade.grabScanDataHq(5000)
        check(batch is not None and int(batch.count) > 0, "tooling: compat grabbed nothing")
        mode = drv.profile.active_mode
        check(mode == "Standard (forced)", f"tooling: compat mode {mode!r}")
        facade.stop()
        facade.disconnect()
        return {"active_mode": mode, "nodes": int(batch.count)}
    finally:
        sim.stop()


# ---------------------------------------------------------------------------
# graded: bench.py configs 1-4, 9, 11, 13, 16 and config 12's room at 1024^2
# ---------------------------------------------------------------------------


def _graded_geometry(name: str) -> dict:
    """Graded configuration ``name``'s full geometry (tools/graded.py)."""
    from rplidar_ros2_driver_tpu_torch.tools import graded as gr

    return gr.GEOMETRY["full"]["map1024" if name == "map1024" else int(name.split("_")[0])]


def _graded_run(name: str, backend: str, g: dict) -> dict:
    """Graded configuration ``name`` ("1", "2", "3", "4_pallas", "4_inc",
    "9", "11", "13", "16", "map1024") on ``backend`` through tools/graded.py
    at geometry ``g``."""
    from rplidar_ros2_driver_tpu_torch.tools import graded as gr

    if name in ("2", "3"):
        return gr.run_chain_config(int(name), backend, g)
    if name.startswith("4_"):
        return gr.run_chain_config(4, backend, g, name[2:])
    if name == "map1024":
        return gr.run_map1024(backend, g)
    return getattr(gr, f"run_config{name}")(backend, g)


def ref_graded(name: str, g: dict) -> dict:
    """The CPU reference of graded configuration ``name`` at geometry ``g``."""
    got = _graded_run(name, "cpu", g)
    got.pop("mapper", None)
    return got


def _graded_arms(device, name: str) -> tuple:
    """One configuration on the card and on the CPU: the card arm's kernel
    launches counted around it, every output and count of the two arms
    held equal.  Returns (card, cpu, launches)."""
    from rplidar_ros2_driver_tpu_torch.tools import graded as gr

    _sync(device)
    _reset_counts()
    g = _graded_geometry(name)
    card = _graded_run(name, "cuda" if device.type == "cuda" else "cpu", g)
    _sync(device)
    launched = _counts()
    cpu = _ref(None, ref_graded, name, g)
    bad = gr.same_outputs(card["outputs"], cpu["outputs"])
    check(not bad, f"graded {name}: the card's outputs differ from the CPU's in {bad[:6]}")
    check(card["counts"] == cpu["counts"],
          f"graded {name}: counts {card['counts']} on the card, {cpu['counts']} on the CPU")
    return card, cpu, launched


def phase_graded(device, card_name: str) -> dict:
    """bench.py's configs 1-4, 9, 11, 13 and 16 and config 12's room on a
    1024x1024 map at their full widths through tools/graded.py (its
    GEOMETRY["full"]; depth cut as listed there), each on the card and on
    the CPU: every output byte-equal between the two, every claim the bench
    asserts checked (tools/graded raises), and here: no B1/B2 launch at
    configs 2-3, B1 at W = 16 and B2 on config 4's arms, one B1 launch a
    revolution on both of config 9's arms, B4/B5 on config 16's
    reconstruct arm only, B6/B7/B8 once a tick at G = 1024 with B8's
    remote route planned.  One line a configuration with its rates beside
    the card's name and power limit."""
    import torch

    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.tools import graded as gr

    geo = gr.GEOMETRY["full"]
    on_card = device.type == "cuda"
    total: dict = {}
    rows = {}

    def one(name: str):
        t0 = time.perf_counter()
        card, cpu, launched = _graded_arms(device, name)
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        row = {"phase": "graded", "config": name, "counts": card["counts"],
               "launches": launched, "loop_launches": card["launches"],
               "stats": card["stats"], "cpu_stats": cpu["stats"],
               "config_seconds": time.perf_counter() - t0, "card": card_name}
        rows[name] = row
        emit(row)
        return card, launched

    one("1")
    for c in (2, 3):
        _card, launched = one(str(c))
        check(launched["temporal_median"] == 0 and launched["sorted_replace"] == 0,
              f"graded {c}: the median kernels launched with the median off: {launched}")
    for median, kernel, other in (("pallas", "temporal_median", "sorted_replace"),
                                  ("inc", "sorted_replace", "temporal_median")):
        card, _l = one(f"4_{median}")
        loop = card["launches"][median]
        if on_card:
            check(loop[kernel] == geo[4]["revs"] and loop[other] == 0,
                  f"graded 4 ({median}): {loop} for {geo[4]['revs']} revolutions at W = 16")
    card, _l = one("9")
    if on_card:
        for arm in ("host", "fused"):
            got = card["launches"][arm]["temporal_median"]
            check(got == card["counts"]["revolutions"],
                  f"graded 9: {got} B1 launches on the {arm} arm for "
                  f"{card['counts']['revolutions']} revolutions")
    card, _l = one("11")
    if on_card:
        for arm in ("per_tick", "super"):
            check(card["launches"][arm]["temporal_median"] > 0,
                  f"graded 11: no B1 launch on the {arm} arm")
    card, _l = one("13")
    if on_card:
        check(card["launches"]["all_arms"]["temporal_median"] > 0, "graded 13: no B1 launch")
    card, _l = one("16")
    if on_card:
        rec, base = card["launches"]["rec"], card["launches"]["base"]
        check(rec["beam_min"] > 0 and rec["shift_sad"] > 0 and rec["temporal_median"] > 0,
              f"graded 16: the reconstruct arm launched {rec}")
        check(base["beam_min"] == 0 and base["shift_sad"] == 0,
              f"graded 16: the baseline arm launched the de-skew kernels: {base}")
    g12 = geo["map1024"]
    card, _l = one("map1024")
    if on_card:
        loop = card["launches"]["mapper"]
        check(all(loop[k] == g12["ticks"] for k in ("coarse_scores", "fine_scores",
                                                    "log_odds_update")),
              f"graded map1024: {loop} for {g12['ticks']} ticks")
        cfg = card.pop("mapper").cfg
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = smk.update_plan(g12["streams"], cfg.grid, sms)
        check(plan[0] == 0, f"graded map1024: B8 planned its local route at G = 1024: {plan}")
        rows["map1024"]["update_plan"] = dict(zip(("local", "cluster", "threads", "rows",
                                                   "smem"), plan))
        rows["map1024"]["coarse_plan"] = smk.coarse_plan(
            g12["streams"], cfg.grid, cfg.coarse, cfg.window_cells, cfg.clamp_q,
            cfg.quant_shift, sms)
        rows["map1024"]["sms"] = sms
        emit({"phase": "graded", "config": "map1024_plans", "G": cfg.grid,
              "update_plan": rows["map1024"]["update_plan"],
              "coarse_plan": rows["map1024"]["coarse_plan"], "sms": sms, "card": card_name})
    emit({"phase": "graded", "config": "all", "launches": total, "card": card_name})
    return {"launches": total, "rows": rows}


def graded_profile(device, card_name: str) -> dict:
    """B6, B7 and B8 at the 1024x1024 mapper's tick (N = 4, 2048 beams: the
    map of the graded phase's room after its ticks, the next scan) against
    their plain versions on the card: events ms, device ms and the bound —
    B8 on its remote route, B6 on coarse_plan's.  Runs after the host
    timings (a profiler session)."""
    import numpy as np
    import torch

    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
    from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
    from rplidar_ros2_driver_tpu_torch.tools import graded as gr

    g = gr.GEOMETRY["full"]["map1024"]
    n, b = g["streams"], g["beams"]
    ticks = gr.room_ticks(n, b, g["ticks"] + 1)
    mapper = FleetMapper(gr.map1024_params("cuda", g), n, beams=b)
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    for pts in ticks[:-1]:
        mapper.submit_points(pts, masks, live)
    cfg = mapper.cfg
    snap = mapper.snapshot()
    pq, okm = tsm.quantize_points(torch.from_numpy(ticks[-1]).to(device),
                                  torch.from_numpy(masks).to(device), cfg)
    lo_t, _, _, posec, trig, pose_t = _map_kernel_args(
        cfg, snap["log_odds"], snap["pose"], pq.cpu().numpy(), okm.cpu().numpy(), device)
    cos_q, sin_q = tsm._theta_trig(pose_t, cfg)
    coarse = (lo_t, pq, okm, posec, trig)
    mq, _sc = smk.coarse_scores_plain(*coarse, cfg)
    fine = (pq, okm, posec, cos_q, sin_q, torch.zeros((n, 2), dtype=torch.int32, device=device))
    calls = {
        "coarse_scores": (lambda: smk.coarse_scores_kernel(*coarse, cfg),
                          lambda: smk.coarse_scores_plain(*coarse, cfg)),
        "fine_scores": (lambda: smk.fine_scores_kernel(mq, *fine, cfg),
                        lambda: smk.fine_scores_plain(mq, *fine, cfg)),
        "log_odds_update": (lambda: smk.log_odds_update_kernel(*coarse, cfg),
                            lambda: smk.log_odds_update_plain(*coarse, cfg)),
    }
    nvalid = int(okm.sum())
    bounds = match_bounds(cfg, n, nvalid, fine)
    kernels = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(all(torch.equal(a, w) for a, w in zip(got, want)),
              f"graded: {name} differs from its plain version at the G = 1024 tick")
        kernels[name] = {"ms": cuda_ms(kern, iters=50, warmup=5),
                         "plain_ms": cuda_ms(plain, iters=10, warmup=2),
                         "device_ms": device_ms(kern, iters=20),
                         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                         "max_abs_err": 0.0}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row = {"phase": "graded_profile", "shape": {"N": n, "G": cfg.grid, "B": b,
                                                 "valid_beams": nvalid},
           "update_plan": dict(zip(("local", "cluster", "threads", "rows", "smem"),
                                   smk.update_plan(n, cfg.grid, sms))),
           "kernels": kernels, "card": card_name}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# --pod-cards: the serving pod over the cards (the pod's groups)
# ---------------------------------------------------------------------------

# the kernels each hosting card must launch on a pod path: the fused
# ingest's median (B1) everywhere, the fused FleetMapper's B6-B8 on config
# 15 and 22, and the carried arm's de-skew (B4, B5) besides
POD_B1 = ("temporal_median",)
POD_MAP = POD_B1 + ("coarse_scores", "fine_scores", "log_odds_update")
POD_CARRIED = POD_MAP + ("beam_min", "shift_sad")


def _check_cards(what: str, counts: dict, hosting: list, names: tuple) -> None:
    """Every card in ``hosting`` launched each kernel of ``names`` in
    ``counts`` ({card: {kernel: launches}}), and no other card launched
    anything."""
    for card in sorted(set(hosting)):
        for name in names:
            check(counts.get(card, {}).get(name, 0) > 0,
                  f"pod cards: {what}: {name} never launched on cuda:{card} (launches {counts})")
    check(set(counts) <= set(hosting),
          f"pod cards: {what}: a card that hosts no shard launched a kernel: {counts}, "
          f"shards on {hosting}")


def _kernels_on_card(dev) -> dict:
    """All eight kernels against their plain versions on card ``dev``
    (the kernels phases' checks; B6-B8 set up their cluster launches once
    per card): what was checked and the largest errors (0)."""
    import numpy as np
    import torch

    cap = torch.cuda.get_device_capability(dev)
    check(tuple(cap) == (9, 0), f"pod cards: {dev} has compute capability {cap}, not (9, 0)")
    t0 = time.perf_counter()
    rng = np.random.default_rng(dev.index)
    med = check_median_kernels(dev, rng)
    mp = check_map_kernels(dev, rng)
    dsk = check_deskew_kernels(dev, rng)
    return {"name": torch.cuda.get_device_name(dev),
            "max_abs_err": {**med["max_abs_err"], **mp["max_abs_err"], **dsk["max_abs_err"]},
            "checked": {"temporal_median": med["checked_b1_fixtures"],
                        "sorted_replace": med["checked_b2_fixtures"] + med["b2_steps"],
                        "sliding_median": med["checked_b3_fixtures"],
                        "beam_min": dsk["checked"]["beam_min"],
                        "shift_sad": dsk["checked"]["shift_sad"] + dsk["b5_edge_fixtures"],
                        "matcher_fixtures": len(mp["fixtures"]),
                        "update_plan_sweep": len(mp["update_plan_sweep"])},
            "seconds": time.perf_counter() - t0}


def _checkpoint_across_cards(src, dst) -> dict:
    """A shard's state saved from card ``src`` and loaded onto card
    ``dst``, as a pod restarted with another layout needs: config 10's
    service with the inc (B2) and sort (B1) medians and config 12's fused
    mapper (B6-B8), each saved mid-trace on ``src``, loaded onto a fresh
    one on ``dst`` (the restored state byte-equal to the saved one) and
    both continued byte-equal; every kernel launched on both cards."""
    import shutil

    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    n = CHECKPOINTS["streams"]
    revs = make_revolutions(CHECKPOINTS["seed"], n * CHECKPOINTS["ticks"], FLEET["points"])
    ticks = [revs[k * n:(k + 1) * n] for k in range(CHECKPOINTS["ticks"])]
    meshes = (make_mesh(1, device=src), make_mesh(1, device=dst))
    tmp = tempfile.mkdtemp(prefix="rpl_pod_ckpt_")
    _sync(src)
    _reset_counts()
    try:
        service = {median: _ckpt_service_arm(src, median, ticks, tmp, meshes)[0]
                   for median in ("inc", "pallas")}
        mapper = _ckpt_mapper(src, tmp, load_on=dst)
        launches = _card_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_cards("the checkpoint leg", launches, [src.index, dst.index],
                 ("temporal_median", "sorted_replace") + POD_MAP[1:])
    return {"from": src.index, "to": dst.index, "service": service, "mapper": mapper,
            "card_launches": launches, "seconds": time.perf_counter() - t0}


def _layout_figures(run: dict) -> dict:
    """One layout's pod figures: config 15's ticks/s and tick p50/p99 of
    both pods and its profiled pod tick; each scheduled config's pod
    ticks/s and drain p50/p99 per arm and its profiled drain."""
    fo, sc = run["failover"], run["scheduled"]
    out = {"config15": {k: fo[k] for k in ("base_ticks_per_s", "chaos_ticks_per_s",
                                           "base_tick_ms", "chaos_tick_ms", "profiled")}}
    for c, cfg in sc["configs"].items():
        out[f"config{c}"] = {
            "arms": {arm: {k: v[k] for k in ("pod_ticks_per_s", "drain_ms")}
                     for arm, v in cfg["arms"].items()},
            "profiled_drain": cfg["profiled_drain"]}
    return out


def phase_pod_cards(n: int, card: str, names: list, seed: int = 0) -> dict:
    """``--pod-cards N``: the serving pod over N cards in one process, the
    shards on the pod's groups (parallel/sharding.pod_groups: one card a
    shard when the shards are at least as many, else N/shards cards a
    shard, its fused engines on the group's lead card).  First every kernel is
    held bit-equal to its plain version on each card (the kernels phases'
    checks: B6-B8 set up their cluster launches once per card).  Then
    config 15 (the failover pod and its carried arm) and configs 19-22
    (scheduled serving) run twice, as their phases run them — every check
    of those phases, guards.steady_state over the whole pod on every card,
    only the planned chaos kills lost: once over the cards and once
    with one ``make_mesh(1, device="cuda:0")`` serving every shard; every
    output, event, replay plan, stored snapshot (tick and bytes), map row
    and log of the first equals the second's, and both equal the one CPU
    run they are held to.  Each lead card launched its path's kernels,
    and no other card did.  Then each layout's profiled pod tick and
    drains (busy ms and idle share per card), a shard's checkpoint saved
    on card 1 and loaded onto card N-1, and one line with the figures of
    both layouts, recorded beside each other (no claim); then the
    one-process meshes over the cards (:func:`phase_pod_cards_mesh`)."""
    import torch

    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh, pod_groups

    t0 = time.perf_counter()
    cards = [torch.device("cuda", d) for d in range(n)]
    for a in range(n):
        # peer access between every pair of cards (a copy between two cards
        # without it is staged through the host by CUDA)
        emit({"phase": "pod_cards_peer", "card": a,
              "can_access_peer": {b: torch.cuda.can_device_access_peer(a, b)
                                  for b in range(n) if b != a}})
    per_card = {d.index: _kernels_on_card(d) for d in cards}
    emit({"phase": "pod_cards_kernels", "cards": n, "per_card": per_card})

    layouts = {"cards": None, "one_card": make_mesh(1, device=cards[0])}
    cpu_runs: dict = {}
    runs = {}
    for name, mesh in layouts.items():
        l0 = time.perf_counter()
        runs[name] = {"failover": phase_failover(cards[0], mesh, cpu_runs),
                      "scheduled": phase_scheduled(cards[0], mesh, cpu_runs)}
        runs[name]["seconds"] = time.perf_counter() - l0
    spread, one = runs["cards"], runs["one_card"]
    for key, got in spread["failover"]["records"].items():
        check(got == one["failover"]["records"][key],
              f"pod cards: config 15's {key} over {n} cards differ from the one-card pod's")
    for c, cfg in spread["scheduled"]["configs"].items():
        for key, got in cfg["records"].items():
            check(got == one["scheduled"]["configs"][c]["records"][key],
                  f"pod cards: config {c}'s {key} over {n} cards differ from the one-card pod's")
    # the shard -> card maps and each hosting card's launches
    maps = {}
    for name, run in runs.items():
        fo = run["failover"]
        maps[name] = {"config15": fo["hosting_cards"]["config15"],
                      "carried": fo["hosting_cards"]["carried"]}
        for part, names_ in (("config15", POD_MAP), ("carried", POD_CARRIED)):
            _check_cards(f"{name} config 15 {part}", fo["card_launches"][part],
                         fo["hosting_cards"][part], names_)
        for c, cfg in run["scheduled"]["configs"].items():
            maps[name][f"config{c}"] = cfg["shard_cards"]
            _check_cards(f"{name} config {c}", cfg["card_launches"], cfg["shard_cards"],
                         POD_MAP if c == 22 else POD_B1)
    for part, cards_of in maps["cards"].items():
        leads = [g[0] for g in pod_groups(len(cards_of), n)]
        check(cards_of == leads,
              f"pod cards: {part}'s shards lead on {cards_of}, not {leads} (the pod's groups)")
        check(maps["one_card"][part] == [0] * len(cards_of),
              f"pod cards: the one-card {part} pod's shards sit on {maps['one_card'][part]}")
    emit({"phase": "pod_cards_map", "cards": n, "shard_cards": maps})

    # the profiled halves, after every host timing of both layouts
    for name, mesh in layouts.items():
        for half in ("failover", "scheduled"):
            runs[name][half]["layout"] = name
        failover_profile(cards[0], runs[name]["failover"], card, mesh)
        scheduled_profile(cards[0], runs[name]["scheduled"], card)
    ckpt = _checkpoint_across_cards(cards[1 % n], cards[n - 1])
    mesh_row = phase_pod_cards_mesh(n, cards, card, seed)
    row = {
        "phase": "pod_cards", "cards": n, "card_names": names, "shard_cards": maps,
        "kernels_bit_equal_on": sorted(per_card), "equal_across_layouts": True,
        "cpu_equal": True, "steady_state": "clean",
        "losses": {name: {"config15": [e for e in run["failover"]["events"] if e[1] == "lost"],
                          **{f"config{c}": {arm: v["losses"] for arm, v in cfg["arms"].items()}
                             for c, cfg in run["scheduled"]["configs"].items()}}
                   for name, run in runs.items()},
        "card_launches": {name: {"config15": run["failover"]["card_launches"],
                                 **{f"config{c}": cfg["card_launches"]
                                    for c, cfg in run["scheduled"]["configs"].items()}}
                          for name, run in runs.items()},
        "figures": {name: _layout_figures(run) for name, run in runs.items()},
        "layout_seconds": {name: run["seconds"] for name, run in runs.items()},
        "checkpoint_across_cards": ckpt, "mesh": {k: mesh_row[k] for k in ("layouts", "seconds")},
        "card": card, "seconds": time.perf_counter() - t0,
    }
    emit(row)
    return row


def phase_pod_cards_mesh(n: int, cards: list, card: str, seed: int) -> dict:
    """``--pod-cards N``'s one-process meshes over the N cards: config 8
    and config 10's host arm over (2, N/2) and (1, N) meshes of the cards,
    each byte-equal to the one-card (1, 1) run and the CPU, each card
    launching its blocks' kernels (:func:`_mb_layouts`); the pod with 2
    shards of N/2 cards and 1 shard of N, each equal to the one-card pod
    (:func:`_mb_pods`); a (2, N/2) checkpoint loaded onto a (1, 1) card
    mesh and continued (:func:`_mb_checkpoint`); then each layout's
    profiled config-8 chunk and config-10 tick beside the one-card run's
    (per-card busy ms, idle share, scans/s; no claim).  Then the fused byte
    ingest over the stream rows of (2, N/2) and (N, 1) meshes: config 10's
    fused arm and config 18's carried route equal to one card and the CPU,
    launching on the row leads only (:func:`_mb_fused_layouts`); on
    (2, N/2) the quarantine cycle of a row-1 stream, scheduled drains at a
    rung and the engine's checkpoint loaded onto (1, 1); each layout's
    profiled tick and drain."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    layouts = {f"1x{n}": make_mesh(devices=cards, stream=1)}
    if n % 2 == 0:
        layouts = {f"2x{n // 2}": make_mesh(devices=cards, stream=2), **layouts}
    cpu: dict = {}
    row = {"phase": "pod_cards_mesh", "cards": n, **_mb_layouts(layouts, seed, cpu)}
    emit({**row, "part": "layouts"})
    if n >= 2:
        row["pods"] = _mb_pods(n, cards)
        emit({"phase": "pod_cards_mesh", "part": "pods", "pods": row["pods"], "card": card})
    if n % 2 == 0 and n >= 4:
        row["checkpoint"] = _mb_checkpoint(cards)
    row["profiles"] = _mb_profiles(layouts, seed, cpu)
    emit({"phase": "pod_cards_mesh", "part": "profiles", "profiles": row["profiles"],
          "checkpoint": row.get("checkpoint"), "card": card,
          "seconds": time.perf_counter() - t0})
    if n % 2 == 0:
        rows = {f"2x{n // 2}": make_mesh(devices=cards, stream=2),
                f"{n}x1": make_mesh(devices=cards, stream=n)}
        one = make_mesh(device=cards[0])
        half = rows[f"2x{n // 2}"]
        row["rows"] = _mb_fused_layouts(rows, cpu)
        emit({"phase": "pod_cards_mesh", "part": "rows", **row["rows"], "card": card})
        row["rows_health"] = _mb_rows_health(half, one)
        row["rows_scheduled"] = _mb_rows_scheduled(half, one)
        row["rows_checkpoint"] = _mb_rows_checkpoint(half, one)
        row["rows_profiles"] = _mb_rows_profiles(rows, cpu)
        emit({"phase": "pod_cards_mesh", "part": "rows_legs",
              **{k: row[k] for k in ("rows_health", "rows_scheduled", "rows_checkpoint",
                                     "rows_profiles")}, "card": card})
    row.update(card=card, seconds=time.perf_counter() - t0)
    return row


# ---------------------------------------------------------------------------
# the mesh held in one process over several blocks (parallel/sharding.Mesh)
# ---------------------------------------------------------------------------


def _mb_chunks(seed: int) -> list:
    """Config 8's packed chunks at full width: MESH_BLOCKS' streams, each
    cycled from seeded revolutions as bench.py bench_fleet does, in
    ``chunks`` chunks of ``chunk`` scans: (S, K, 3, N) uint16 and (S, K)
    counts each."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.ops.filters import pack_host_scans_compact

    mb = MESH_BLOCKS
    scans = make_revolutions(seed, mb["seed_revs"], FLEET["points"])
    out = []
    for c in range(mb["chunks"]):
        seqs, counts = zip(*[pack_host_scans_compact(
            [scans[(c * mb["chunk"] + i + 7 * s) % len(scans)] for i in range(mb["chunk"])],
            FLEET["capacity"]) for s in range(mb["streams"])])
        out.append((np.stack(seqs), np.stack(counts).astype(np.int32)))
    return out


def _mb_ticks() -> list:
    """Config 10's byte ticks at N = MESH_BLOCKS' streams: one 3200-point
    DenseBoost revolution a stream a tick (bench.py bench_fleet_ingest)."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    mb = MESH_BLOCKS
    frames = denseboost_frames(FLEET["seed"], mb["ticks"] + 1, FLEET["points"])
    return fleet_byte_ticks(frames, mb["streams"], FLEET["points"] // 40,
                            int(Ans.MEASUREMENT_DENSE_CAPSULED))[: mb["ticks"]]


def _mb_blocks_on(mesh) -> dict:
    """{card index: blocks of ``mesh`` on it}."""
    out: dict = {}
    for v in mesh.blocks:
        if v.device.type == "cuda":
            out[v.device.index] = out.get(v.device.index, 0) + 1
    return out


def _mb_check_launches(what: str, mesh, got: dict, by_card: dict, name: str, units: int) -> None:
    """``name`` launched once a block a unit (tick or chunk): ``units`` x
    blocks in all, each card as many times as it holds blocks, and no card
    outside the mesh launched anything.  On the host nothing launches."""
    if mesh.device.type != "cuda":
        return
    per = _mb_blocks_on(mesh)
    check(got.get(name, 0) == units * len(mesh.blocks),
          f"mesh blocks: {what}: {name} launched {got.get(name, 0)} times, not once a block "
          f"a unit ({units} x {len(mesh.blocks)})")
    for card, n in per.items():
        check(by_card.get(card, {}).get(name, 0) == units * n,
              f"mesh blocks: {what}: cuda:{card} launched {name} "
              f"{by_card.get(card, {}).get(name, 0)} times for its {n} blocks x {units}")
    check(set(by_card) <= set(per),
          f"mesh blocks: {what}: a card outside the mesh launched a kernel: {by_card}")


def _mb_scan(mesh, median: str, reduce: str, chunks) -> dict:
    """Config 8's fused replay over ``mesh`` (build_sharded_scan; median
    ``pallas`` is B3 a block a chunk): each chunk's ranges and the state
    after it (digests), the launches in all and by card, the seconds.  On
    a card one chunk runs first on a state thrown away, untimed and
    uncounted: each card's first chunk maps its allocator's blocks."""
    import dataclasses

    import torch

    from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params
    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

    backend = "cuda" if mesh.device.type == "cuda" else "cpu"
    cfg = dataclasses.replace(
        config_from_params(_fleet_params(backend, median_backend=median), FLEET["beams"],
                           platform=mesh.device.type), voxel_reduce=reduce)
    scan = ts.build_sharded_scan(mesh, cfg)
    if mesh.device.type == "cuda":
        scan(ts.create_sharded_state(mesh, cfg, MESH_BLOCKS["streams"]), *chunks[0])
    state = ts.create_sharded_state(mesh, cfg, MESH_BLOCKS["streams"])
    _sync(mesh.device)
    _reset_counts()
    ranges, states, wall = [], [], 0.0
    for seq, cnt in chunks:
        t0 = time.perf_counter()
        state, r = scan(state, seq, cnt)
        _sync(mesh.device)
        wall += time.perf_counter() - t0
        ranges.append(_digest([r.cpu().numpy()]))
        st = ts.gather_state(mesh, state)
        states.append(_digest(st[k] for k in sorted(st)))
    return {"ranges": ranges, "states": states, "launches": _counts(),
            "card_launches": _card_counts(), "seconds": wall,
            "scans_per_s": MESH_BLOCKS["streams"] * MESH_BLOCKS["chunk"] * len(chunks) / wall}


def _mb_host_service(mesh, median: str, reduce: str):
    """Config 10's host-arm service over ``mesh``, warmed, its blocks'
    voxel partials summed by ``reduce`` (a FilterConfig choice, set on the
    service's config: the service takes the params' psum)."""
    import dataclasses

    backend = "cuda" if mesh.device.type == "cuda" else "cpu"
    svc = _fleet_service(backend, "host", MESH_BLOCKS["streams"], FLEET["points"] // 40,
                         mesh=mesh, median_backend=median)
    svc.cfg = dataclasses.replace(svc.cfg, voxel_reduce=reduce)
    return svc


def _mb_host(mesh, median: str, reduce: str, ticks) -> dict:
    """Config 10's host arm over ``mesh``: submit_bytes a tick, the ticks
    after the first two under guards.steady_state on a card (every card
    of the mesh: nothing built, no new segment, no undeclared sync).
    Returns the published outputs (digests), the final snapshot (digest),
    the launches in all and by card, the dispatched ticks, ticks/s and the
    copies between cards a dispatched tick (``sharding.peer_copies``)."""
    import numpy as np

    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
    from rplidar_ros2_driver_tpu_torch.utils import guards

    svc = _mb_host_service(mesh, median, reduce)
    warm = 2
    outs = [svc.submit_bytes(t) for t in ticks[:warm]]
    _sync(mesh.device)
    _reset_counts()
    copies = ts.peer_copies
    scope = (guards.steady_state(tag=f"mesh blocks config 10 {mesh}")
             if mesh.device.type == "cuda" else contextlib.nullcontext())
    lat = []
    with scope:
        for t in ticks[warm:]:
            t0 = time.perf_counter()
            outs.append(svc.submit_bytes(t))
            lat.append(time.perf_counter() - t0)
    _sync(mesh.device)
    copies = ts.peer_copies - copies
    snap = svc.snapshot()
    pub = _published(outs, MESH_BLOCKS["streams"])
    dispatched = sum(any(o is not None for o in res) for res in outs[warm:])
    return {"published": [[_out_digest(o) for o in p] for p in pub],
            "snapshot": _digest(snap[k] for k in sorted(snap)),
            "launches": _counts(), "card_launches": _card_counts(), "dispatched": dispatched,
            "peer_copies_per_tick": copies / max(dispatched, 1),
            "ticks_per_s": len(lat) / float(np.sum(lat)), "tick_ms": _pcts(np.asarray(lat))}


def ref_mb_scan(seed: int, median: str) -> dict:
    """The CPU reference of config 8's first chunk over the host mesh."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    return _mb_scan(make_mesh(device="cpu"), median, "psum", _mb_chunks(seed)[:1])


def ref_mb_host(median: str) -> dict:
    """The CPU reference of config 10's host arm over the host mesh."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    return _mb_host(make_mesh(device="cpu"), median, "psum", _mb_ticks())


def ref_mb_leg(leg: str) -> dict:
    """The CPU reference of a row leg over the host mesh: config 10's fused
    arm or config 18's carried-map route."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    host = make_mesh(device="cpu")
    if leg == "config10_fused":
        return _mb_fused(host, _mb_ticks()[: MESH_BLOCKS["fused_ticks"]])
    return _mb_carried(host, _mb_carried_groups())


def _mb_layouts(layouts: dict, seed: int, cpu: dict) -> dict:
    """Config 8 (both medians) and config 10's host arm (the sort median
    with psum and ring, the inc median with psum) over each mesh of
    ``layouts`` and over the (1, 1) mesh on cuda:0: every layout byte-equal
    to the (1, 1) card run (every chunk's ranges and state, every published
    output and the final snapshot) and to the CPU arm (config 8's first
    chunk, config 10's whole run); B3 / B1 / B2 launched once a block a
    chunk or tick on each block's card, and on no other card.  The (1, 1)
    mesh sits on the first layout's lead device."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    mb = MESH_BLOCKS
    t0 = time.perf_counter()
    lead = next(iter(layouts.values())).device
    one = make_mesh(device=lead)
    chunks = _memo(cpu, "mb chunks", lambda: _mb_chunks(seed))
    ticks = _memo(cpu, "mb ticks", _mb_ticks)
    row: dict = {"config8": {}, "config10": {}, "launches": {}}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            row["launches"][k] = row["launches"].get(k, 0) + v

    for median in ("pallas", "inc"):
        ref = _mb_scan(one, median, "psum", chunks)
        cpu_run = _ref(cpu, ref_mb_scan, seed, median)
        check(ref["ranges"][:1] == cpu_run["ranges"] and ref["states"][:1] == cpu_run["states"],
              f"mesh blocks: config 8 {median}: the (1, 1) card run differs from the CPU")
        arm = {"one_card_scans_per_s": ref["scans_per_s"]}
        for name, mesh in layouts.items():
            got = _mb_scan(mesh, median, "psum", chunks)
            check(got["ranges"] == ref["ranges"] and got["states"] == ref["states"],
                  f"mesh blocks: config 8 {median} over {name} differs from the (1, 1) card run")
            if median == "pallas":
                _mb_check_launches(f"config 8 over {name}", mesh, got["launches"],
                                   got["card_launches"], "sliding_median", len(chunks))
            add(got["launches"])
            arm[name] = {"scans_per_s": got["scans_per_s"], "seconds": got["seconds"],
                         "card_launches": got["card_launches"]}
        row["config8"][median] = arm
    for median, reduce in (("pallas", "psum"), ("pallas", "ring"), ("inc", "psum")):
        ref = _mb_host(one, median, reduce, ticks)
        cpu_run = _ref(cpu, ref_mb_host, median)
        check(ref["published"] == cpu_run["published"] and ref["snapshot"] == cpu_run["snapshot"],
              f"mesh blocks: config 10 {median}: the (1, 1) card run differs from the CPU")
        check(sum(len(p) for p in ref["published"]) > 0, "mesh blocks: config 10 published nothing")
        kernel = "sorted_replace" if median == "inc" else "temporal_median"
        arm = {"one_card_ticks_per_s": ref["ticks_per_s"], "dispatched": ref["dispatched"]}
        for name, mesh in layouts.items():
            got = _mb_host(mesh, median, reduce, ticks)
            check(got["published"] == ref["published"] and got["snapshot"] == ref["snapshot"],
                  f"mesh blocks: config 10 {median}/{reduce} over {name} differs from the "
                  "(1, 1) card run")
            _mb_check_launches(f"config 10 {median}/{reduce} over {name}", mesh, got["launches"],
                               got["card_launches"], kernel, got["dispatched"])
            add(got["launches"])
            arm[name] = {"ticks_per_s": got["ticks_per_s"], "tick_ms": got["tick_ms"],
                         "peer_copies_per_tick": got["peer_copies_per_tick"],
                         "card_launches": got["card_launches"]}
        row["config10"][f"{median}_{reduce}"] = arm
    row.update(streams=mb["streams"], chunk=mb["chunk"], chunks=mb["chunks"], ticks=mb["ticks"],
               layouts={name: str(m) for name, m in layouts.items()}, steady_state="clean",
               equal_to_one_card=True, cpu_equal=True, seconds=time.perf_counter() - t0)
    return row


def phase_mesh_blocks(device, seed: int, card: str) -> dict:
    """The default run's one-process mesh: a (2, 2) mesh whose four blocks
    all sit on ``device`` (make_mesh(devices=[card] * 4)), config 8 and
    config 10's host arm over it (:func:`_mb_layouts`), then config 10's
    fused arm and config 18's carried-map route over its two stream rows
    (:func:`_mb_fused_layouts`)."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(devices=[device] * 4, stream=2)
    row = {"phase": "mesh_blocks", **_mb_layouts({"2x2_one_card": mesh}, seed, None),
           "card": card}
    row["rows"] = _mb_fused_layouts({"2x2_one_card": mesh}, None)
    emit(row)
    return row


def _mb_pods(n: int, cards: list) -> dict:
    """Config 15's traffic on pods whose shards hold several cards
    (ElasticFleetService(mesh=None) over the n visible cards: the groups
    of parallel/sharding.pod_groups): 2 shards of n/2 cards (shard 1
    killed over ticks 10-12) and 1 shard of n cards, each against the same
    pod with every shard on cuda:0, the post-warm ticks under
    guards.steady_state: outputs, events, replay plan, stored snapshots
    and map rows equal; the pod's groups JAX's, each shard's one-card mesh
    on its group's lead card, the lead cards launching the pod's kernels
    and no other card launching any (a shard computes on its lead card
    alone)."""
    import dataclasses

    import numpy as np

    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh, pod_groups
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
    from rplidar_ros2_driver_tpu_torch.utils import guards

    fo = FAILOVER
    run = fo["points"] // 40
    ticks = fleet_byte_ticks(ring_frames(fo["revs"], fo["points"]), fo["streams"], run,
                             int(Ans.MEASUREMENT_DENSE_CAPSULED))
    backend = "cuda" if cards[0].type == "cuda" else "cpu"
    out = {}
    for shards, kill in ((2, fo["kill"]), (1, None)):
        params = dataclasses.replace(_fo_params(backend), shard_count=shards)
        recs = {}
        for layout, mesh in (("groups", None), ("one_card", make_mesh(device=cards[0]))):
            pod, fake = _fo_pod(backend, kill, params, fo["streams"], fo["beams"],
                                fo["capacity"], run, mesh)
            for tick in ticks[: fo["warm"]]:
                pod.submit_bytes(tick)
                fake["now"] += fo["dt"]
            _sync(cards[0])
            _reset_counts()
            outs, secs = [], []
            with guards.steady_state(tag=f"pod {shards} shards {layout}"):
                for tick in ticks[fo["warm"]:]:
                    t0 = time.perf_counter()
                    outs.append([_out_digest(r) for r in pod.submit_bytes(tick)])
                    secs.append(time.perf_counter() - t0)
                    fake["now"] += fo["dt"]
            _sync(cards[0])
            recs[layout] = {"outs": outs, "record": _fo_record(pod),
                            "card_launches": _card_counts(), "pod": pod,
                            "ticks_per_s": len(secs) / float(np.sum(secs)),
                            "tick_ms": _pcts(np.asarray(secs))}
        g, o = recs["groups"], recs["one_card"]
        what = f"pod cards: {shards} shard(s) of {n // shards} cards"
        check(g["outs"] == o["outs"], f"{what}: outputs differ from the one-card pod")
        for key, got in g["record"].items():
            check(got == o["record"][key], f"{what}: {key} differ from the one-card pod")
        groups = pod_groups(shards, n)
        pod = g["pod"]
        check(pod.groups == groups
              and [m.device for m in pod.meshes] == [cards[grp[0]] for grp in groups]
              and not any(m.multi_block for m in pod.meshes),
              f"{what}: the shards are not on the lead cards of the groups {groups}")
        if backend == "cuda":
            _check_cards(what, g["card_launches"], [grp[0] for grp in groups], POD_MAP)
        if kill is not None:
            check(pod.evacuations == 1 and pod.readmits == 1,
                  f"{what}: {pod.evacuations} evacuations, {pod.readmits} re-admissions")
        out[f"{shards}x{n // shards}"] = {
            "groups": groups, "events": g["record"]["events"],
            "ticks_per_s": g["ticks_per_s"], "tick_ms": g["tick_ms"],
            "one_card_ticks_per_s": o["ticks_per_s"], "one_card_tick_ms": o["tick_ms"],
            "card_launches": g["card_launches"], "equal_to_one_card": True}
    return out


def _mb_checkpoint(cards: list) -> dict:
    """Config 10's service over a (2, N/2) mesh of ``cards`` fed seeded
    3200-point revolutions (submit, a revolution a stream a tick), saved
    after MESH_BLOCKS["ckpt_save"] ticks (save_sharded: the global layout),
    loaded onto a fresh (1, 1) service on the first card (the restored
    snapshot equal to the saved one) and both continued byte-equal to the
    end."""
    import shutil

    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    mb = MESH_BLOCKS
    t0 = time.perf_counter()
    n = mb["streams"]
    revs = make_revolutions(CHECKPOINTS["seed"], n * mb["ticks"], FLEET["points"])
    ticks = [revs[k * n:(k + 1) * n] for k in range(mb["ticks"])]
    src = _mb_host_service(make_mesh(devices=cards, stream=2), "pallas", "psum")
    dst = _mb_host_service(make_mesh(device=cards[0]), "pallas", "psum")
    cut = mb["ckpt_save"]
    for t in ticks[:cut]:
        src.submit(t)
    tmp = tempfile.mkdtemp(prefix="rpl_mesh_ckpt_")
    try:
        path = os.path.join(tmp, "ckpt")
        s0 = time.perf_counter()
        src.save_sharded(path)
        save_ms = (time.perf_counter() - s0) * 1e3
        s0 = time.perf_counter()
        check(dst.load_sharded(path), "mesh blocks checkpoint: the (1, 1) service refused it")
        load_ms = (time.perf_counter() - s0) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = src.snapshot(), dst.snapshot()
    check(all(_bits_equal(a[k], b[k]) for k in a), "mesh blocks checkpoint: the restored "
          "(1, 1) state differs from the (2, 2) one")
    for t in ticks[cut:]:
        for x, y in zip(src.submit(t), dst.submit(t)):
            check((x is None) == (y is None) and (x is None or _same_output(x, y)),
                  "mesh blocks checkpoint: the continued (1, 1) service differs from the (2, 2)")
    a, b = src.snapshot(), dst.snapshot()
    check(all(_bits_equal(a[k], b[k]) for k in a),
          "mesh blocks checkpoint: the final states differ")
    return {"from": f"2x{len(cards) // 2} over {[str(c) for c in cards]}",
            "to": f"1x1 on {cards[0]}", "saved_after": cut,
            "ticks": len(ticks), "save_ms": save_ms, "load_ms": load_ms,
            "seconds": time.perf_counter() - t0}


def _mb_profiles(layouts: dict, seed: int, cpu: dict) -> dict:
    """Per-card busy ms and idle share, beside the (1, 1) card run's: two
    config-8 chunks (sort median; scans/s) and four config-10 host ticks
    (sort, psum) over each layout, profiled after every host timing."""
    import torch

    from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params
    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

    chunks = _memo(cpu, "mb chunks", lambda: _mb_chunks(seed))
    ticks = _memo(cpu, "mb ticks", _mb_ticks)
    card0 = torch.device("cuda", 0)
    cfg = config_from_params(_fleet_params("cuda", median_backend="pallas"), FLEET["beams"],
                             platform="cuda")
    out = {}
    for name, mesh in {"one_card": ts.make_mesh(device=card0), **layouts}.items():
        scan = ts.build_sharded_scan(mesh, cfg)
        box = {"state": ts.create_sharded_state(mesh, cfg, MESH_BLOCKS["streams"])}
        feed = iter(chunks * 2)

        def chunk_step():
            seq, cnt = next(feed)
            box["state"], _r = scan(box["state"], seq, cnt)

        chunk_step()  # warm
        c8 = _profiled(card0, chunk_step, 2)
        c8["scans_per_s"] = MESH_BLOCKS["streams"] * MESH_BLOCKS["chunk"] / (c8["wall_ms"] / 1e3)
        svc = _mb_host_service(mesh, "pallas", "psum")
        for t in ticks[:2]:
            svc.submit_bytes(t)
        live = iter(ticks[2:6])
        c10 = _profiled(card0, lambda: svc.submit_bytes(next(live)), 4)
        out[name] = {"config8_chunk": c8, "config10_tick": c10}
    return out


# the fused byte ingest over a mesh's stream rows (FleetFusedIngest's rows)
# ---------------------------------------------------------------------------

# kernels whose launches scale with the rows (one a row per tick, or per
# tick completing revolutions, on the lockstep scenes here); B1 is one a
# completed revolution a stream, so the rows share the one-row count
ROW_KERNELS = ("beam_min", "shift_sad", "coarse_scores", "fine_scores", "log_odds_update")


def _mb_rows(svc) -> list:
    return [[list(r.block), str(r.device), r.lanes.start, r.lanes.stop]
            for r in svc.fleet_ingest.rows]


def _mb_guard(device, what: str):
    from rplidar_ros2_driver_tpu_torch.utils import guards

    return (guards.steady_state(tag=what) if device.type == "cuda"
            else contextlib.nullcontext())


def _mb_fused(mesh, ticks) -> dict:
    """Config 10's fused arm over ``mesh``: submit_bytes a tick, the ticks
    after the first two under guards.steady_state on a card (every card:
    nothing built, no new segment, no undeclared sync).  Returns the
    published outputs and the engine's final snapshot (digests), the
    launches in all and by card, the rows, the dispatch counters and
    ticks/s."""
    import numpy as np

    backend = "cuda" if mesh.device.type == "cuda" else "cpu"
    n = MESH_BLOCKS["streams"]
    svc = _fleet_service(backend, "fused", n, FLEET["points"] // 40, mesh=mesh)
    warm = 2
    outs = [svc.submit_bytes(t) for t in ticks[:warm]]
    _sync(mesh.device)
    _reset_counts()
    lat = []
    with _mb_guard(mesh.device, f"mesh rows config 10 fused {mesh}"):
        for t in ticks[warm:]:
            t0 = time.perf_counter()
            outs.append(svc.submit_bytes(t))
            lat.append(time.perf_counter() - t0)
    _sync(mesh.device)
    eng = svc.fleet_ingest
    snap = eng.snapshot()
    return {"published": [[_out_digest(o) for o in p] for p in _published(outs, n)],
            "snapshot": _digest(snap[k] for k in sorted(snap)),
            "launches": _counts(), "card_launches": _card_counts(), "rows": _mb_rows(svc),
            "dispatches": eng.dispatch_count, "h2d_transfers": eng.h2d_transfers,
            "card_dispatches": dict(eng.card_dispatches), "revolutions": eng.scans_completed,
            "ticks_per_s": len(lat) / float(np.sum(lat)), "tick_ms": _pcts(np.asarray(lat))}


def _mb_carried_groups(n: int = 0) -> list:
    """Config 18's drains at full width: ``n`` (MESH_BLOCKS'
    ``carried_groups``) drains of T ticks of FUSED_MAPPING's paced ring."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm = FUSED_MAPPING
    n = n or MESH_BLOCKS["carried_groups"]
    revs = -(-n * fm["T"] * fm["run"] * 40 // fm["points"]) + 1
    ticks = fleet_byte_ticks(ring_frames(revs, fm["points"]), fm["streams"], fm["run"],
                             int(Ans.MEASUREMENT_DENSE_CAPSULED))
    return [ticks[g * fm["T"]:(g + 1) * fm["T"]] for g in range(n)]


def _mb_carried(mesh, groups) -> dict:
    """Config 18's carried-map route over ``mesh``: one super-step drain of
    T ticks a group, the drains after the first under guards.steady_state
    on a card.  Returns each stream's ranges, the drain-boundary poses, the
    carried map and the engine's snapshot (digests), the launches in all
    and by card, the rows, the dispatch counters and drains/s."""
    import numpy as np

    fm = FUSED_MAPPING
    svc = _fm_service(mesh.device.type, "fused", mesh)
    ranges, poses, lat = [[] for _ in range(fm["streams"])], [], []

    def drain(group):
        for i, outs in enumerate(svc.submit_bytes_backlog(group)):
            ranges[i] += [_digest([np.asarray(o.ranges)]) for o in outs]
        poses.append(_fm_pose_row(svc))

    drain(groups[0])
    _sync(mesh.device)
    _reset_counts()
    with _mb_guard(mesh.device, f"mesh rows config 18 {mesh}"):
        for group in groups[1:]:
            t0 = time.perf_counter()
            drain(group)
            lat.append(time.perf_counter() - t0)
    _sync(mesh.device)
    eng = svc.fleet_ingest
    snap, cmap = eng.snapshot(), svc.mapper.snapshot()
    return {"ranges": ranges, "poses": poses, "map": _digest(cmap[k] for k in sorted(cmap)),
            "snapshot": _digest(snap[k] for k in sorted(snap)),
            "launches": _counts(), "card_launches": _card_counts(), "rows": _mb_rows(svc),
            "dispatches": eng.dispatch_count, "card_dispatches": dict(eng.card_dispatches),
            "revolutions": eng.scans_completed,
            "drains_per_s": len(lat) / float(np.sum(lat)), "drain_ms": _pcts(np.asarray(lat))}


def _mb_check_rows(what: str, mesh, got: dict, ref: dict, names: tuple) -> None:
    """Launches by card of a run over ``mesh``'s rows against the one-row
    card run ``ref``: each row's lead card launched each kernel of
    ``names`` once a row it leads for every launch of the one row, B1 as
    many times in all as the one row (one a completed revolution a
    stream) and on every lead card, and no card but a row lead launched
    anything.  On the host nothing launches."""
    if mesh.device.type != "cuda":
        return
    leads: dict = {}
    for _block, dev, _start, _stop in got["rows"]:
        card = int(dev.split(":")[1])
        leads[card] = leads.get(card, 0) + 1
    by_card, total = got["card_launches"], got["launches"]
    check(set(by_card) <= set(leads),
          f"mesh rows: {what}: a card that leads no row launched a kernel: {by_card}, "
          f"row leads {leads}")
    check(total.get("temporal_median", 0) == ref["launches"].get("temporal_median", 0) > 0,
          f"mesh rows: {what}: B1 launched {total.get('temporal_median', 0)} times, the one "
          f"row {ref['launches'].get('temporal_median', 0)}")
    for card, k in leads.items():
        check(by_card.get(card, {}).get("temporal_median", 0) > 0,
              f"mesh rows: {what}: cuda:{card} leads a row and launched no B1")
        for name in names:
            want = k * ref["launches"].get(name, 0)
            check(by_card.get(card, {}).get(name, 0) == want > 0,
                  f"mesh rows: {what}: cuda:{card} launched {name} "
                  f"{by_card.get(card, {}).get(name, 0)} times, not {want} ({k} rows)")


def _mb_fused_layouts(layouts: dict, cpu: dict) -> dict:
    """Config 10's fused arm and config 18's carried-map route over each
    mesh of ``layouts`` (the engine's rows on the rows' lead blocks) and
    over the (1, 1) mesh on the first layout's lead card: every layout
    byte-equal to the (1, 1) card run (every published output or drain's
    ranges and poses, the carried map, the engine's snapshot) and to the
    CPU run; the dispatch counters of one engine whatever the rows; the
    launches on the row leads (:func:`_mb_check_rows`)."""
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    lead = next(iter(layouts.values())).device
    one = make_mesh(device=lead)
    ticks = _memo(cpu, "mb ticks", _mb_ticks)[: MESH_BLOCKS["fused_ticks"]]
    groups = _memo(cpu, "mb carried groups", _mb_carried_groups)
    row: dict = {"config10_fused": {}, "config18_carried": {}, "launches": {}}
    legs = (("config10_fused", _mb_fused, ticks, ("published", "snapshot"), ()),
            ("config18_carried", _mb_carried, groups, ("ranges", "poses", "map", "snapshot"),
             ROW_KERNELS))
    for leg, run, data, keys, names in legs:
        ref = run(one, data)
        cpu_run = _ref(cpu, ref_mb_leg, leg)
        check(all(ref[k] == cpu_run[k] for k in keys),
              f"mesh rows: {leg}: the (1, 1) card run differs from the CPU")
        rate = "ticks_per_s" if leg == "config10_fused" else "drains_per_s"
        arm = {"one_card": {rate: ref[rate], "launches": ref["launches"],
                            "dispatches": ref["dispatches"], "revolutions": ref["revolutions"]}}
        for name, mesh in layouts.items():
            got = run(mesh, data)
            check(all(got[k] == ref[k] for k in keys),
                  f"mesh rows: {leg} over {name} differs from the (1, 1) card run")
            check(got["dispatches"] == ref["dispatches"]
                  and sum(got["card_dispatches"].values())
                  == len(got["rows"]) * got["dispatches"],
                  f"mesh rows: {leg} over {name}: dispatches {got['dispatches']} (one row "
                  f"{ref['dispatches']}), by card {got['card_dispatches']}")
            _mb_check_rows(f"{leg} over {name}", mesh, got, ref, names)
            for k, v in got["launches"].items():
                row["launches"][k] = row["launches"].get(k, 0) + v
            arm[name] = {rate: got[rate], "rows": got["rows"],
                         "card_dispatches": got["card_dispatches"],
                         "card_launches": got["card_launches"]}
        row[leg] = arm
    row.update(layouts={name: str(m) for name, m in layouts.items()}, steady_state="clean",
               equal_to_one_card=True, cpu_equal=True, seconds=time.perf_counter() - t0)
    return row


def _mb_rows_health(mesh, one) -> dict:
    """Config 18's carried route under the health supervisor over ``mesh``
    with stream 2 (row 1 of a (2, 2) mesh) corrupted, against the same
    cycle on the one-row mesh ``one``: outputs, poses, transitions and the
    final maps equal; the stream quarantined and rejoined, its snapshot
    carrying its ``ingest.map_*`` rows."""
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    fm = FUSED_MAPPING
    ticks = fleet_byte_ticks(ring_frames(fm["revs"], fm["points"]), fm["streams"], fm["run"],
                             int(Ans.MEASUREMENT_DENSE_CAPSULED))[: MESH_BLOCKS["carried_chaos_ticks"]]
    t0 = time.perf_counter()
    got = _fm_quarantine(mesh.device, ticks, mesh, stream=2)
    ref = _fm_quarantine(one.device, ticks, one, stream=2)
    check(got["quarantines"] >= 1 and got["rejoins"] >= 1
          and all(s == 2 for (_t, s, _a, _b) in got["events"]),
          f"mesh rows quarantine: stream 2 did not walk alone ({got['events']})")
    check(all(f"ingest.map_{k}" in keys for keys in got["snapshot_keys"]
              for k in ("log_odds", "pose", "origin_xy", "revision")),
          "mesh rows quarantine: the snapshot lacks the ingest.map_* rows")
    check(_fm_quarantine_same(got, ref), "mesh rows quarantine: the rows differ from one row")
    return {"ticks": len(ticks), "stream": 2, "quarantines": got["quarantines"],
            "rejoins": got["rejoins"], "walk": [list(e) for e in got["events"]],
            "equal_to_one_card": True, "seconds": time.perf_counter() - t0}


def _mb_rows_scheduled(mesh, one) -> dict:
    """Config 18's carried route with the traffic shaper (rungs
    MESH_BLOCKS["sched_rungs"]) over ``mesh`` and the one-row mesh
    ``one``: a burst of T ticks, then two ticks, then a burst again, each
    drained by drain_scheduled; every drain's outputs, the shaper's status
    (its wall-clock model aside) and the rung counts equal."""
    import numpy as np

    fm = FUSED_MAPPING
    ticks = [t for g in _mb_carried_groups(3) for t in g]
    bursts = (fm["T"], 2, fm["T"])
    t0 = time.perf_counter()
    runs = []
    for m in (mesh, one):
        svc = _fm_service(m.device.type, "fused", m, scheduled=True,
                          sched_rungs=MESH_BLOCKS["sched_rungs"],
                          admission_max_backlog_ticks=2 * fm["T"])
        outs, statuses, pos = [], [], 0
        for n in bursts:
            chunk = ticks[pos:pos + n]
            pos += n
            svc.offer_bytes([[t[i] for t in chunk] for i in range(fm["streams"])])
            outs.append([[_digest([np.asarray(o.ranges)]) for o in s]
                         for s in svc.drain_scheduled()])
            st = svc.scheduler_status()
            st.pop("latency_model")
            statuses.append(st)
        runs.append({"outs": outs, "statuses": statuses, "poses": _fm_pose_row(svc),
                     "rungs": dict(svc.fleet_ingest.rung_dispatches)})
    got, ref = runs
    check(got == ref, "mesh rows scheduled: the rows' drains differ from one row")
    check(got["rungs"].get(fm["T"], 0) >= 2, f"mesh rows scheduled: rung dispatches {got['rungs']}")
    return {"bursts": list(bursts), "rung_dispatches": got["rungs"], "equal_to_one_card": True,
            "seconds": time.perf_counter() - t0}


def _mb_rows_checkpoint(mesh, one) -> dict:
    """Config 10's fused service over the (2, 2) ``mesh`` for four ticks,
    its engine saved with save_sharded (the global layout from the rows),
    loaded onto a fresh service on the one-row mesh ``one`` (the restored
    snapshot equal) and both continued byte-equal to the end."""
    import shutil

    ticks = _mb_ticks()[: MESH_BLOCKS["fused_ticks"]]
    n, run = MESH_BLOCKS["streams"], FLEET["points"] // 40
    src = _fleet_service(mesh.device.type, "fused", n, run, mesh=mesh)
    dst = _fleet_service(one.device.type, "fused", n, run, mesh=one)
    cut = len(ticks) // 2
    for t in ticks[:cut]:
        src.submit_bytes(t)
    tmp = tempfile.mkdtemp(prefix="rpl_rows_ckpt_")
    try:
        path = os.path.join(tmp, "ckpt")
        s0 = time.perf_counter()
        src.fleet_ingest.save_sharded(path)
        save_ms = (time.perf_counter() - s0) * 1e3
        s0 = time.perf_counter()
        check(dst.fleet_ingest.load_sharded(path), "mesh rows checkpoint: the (1, 1) engine "
              "refused it")
        load_ms = (time.perf_counter() - s0) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = src.fleet_ingest.snapshot(), dst.fleet_ingest.snapshot()
    check(all(_bits_equal(a[k], b[k]) for k in a),
          "mesh rows checkpoint: the restored (1, 1) state differs from the rows'")
    for t in ticks[cut:]:
        for x, y in zip(src.submit_bytes(t), dst.submit_bytes(t)):
            check((x is None) == (y is None) and (x is None or _same_output(x, y)),
                  "mesh rows checkpoint: the continued (1, 1) service differs from the rows'")
    a, b = src.fleet_ingest.snapshot(), dst.fleet_ingest.snapshot()
    check(all(_bits_equal(a[k], b[k]) for k in a), "mesh rows checkpoint: the final states differ")
    return {"from": str(mesh), "to": str(one), "saved_after": cut, "ticks": len(ticks),
            "save_ms": save_ms, "load_ms": load_ms}


def _mb_rows_profiles(layouts: dict, cpu: dict) -> dict:
    """Per-card busy ms and idle share of a profiled config-10 fused tick
    and config-18 drain over each layout, beside the (1, 1) card run's
    (ticks/s and drains/s from the profiled wall; no claim)."""
    import torch

    from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts

    k = MESH_BLOCKS["profile_ticks"]
    ticks = _memo(cpu, "mb ticks", _mb_ticks)
    groups = _memo(cpu, "mb carried groups", _mb_carried_groups)
    card0 = torch.device("cuda", 0)
    out = {}
    for name, mesh in {"one_card": ts.make_mesh(device=card0), **layouts}.items():
        svc = _fleet_service("cuda", "fused", MESH_BLOCKS["streams"], FLEET["points"] // 40,
                             mesh=mesh)
        for t in ticks[:2]:
            svc.submit_bytes(t)
        live = iter(ticks[2:2 + k])
        c10 = _profiled(card0, lambda: svc.submit_bytes(next(live)), k)
        c10["ticks_per_s"] = 1e3 / c10["wall_ms"]
        carried = _fm_service("cuda", "fused", mesh)
        carried.submit_bytes_backlog(groups[0])
        drains = iter(groups[1:])
        c18 = _profiled(card0, lambda: carried.submit_bytes_backlog(next(drains)),
                        len(groups) - 1)
        c18["drains_per_s"] = 1e3 / c18["wall_ms"]
        out[name] = {"config10_fused_tick": c10, "config18_drain": c18}
    return out


def redesign_report(name: str, timed: list, launched: list) -> dict:
    """B1's and B4's extra keys in the kernels line.  ``timed``: the kernel
    and deskew_kernels phases' rows at each of the path's shapes (device
    ms; events ms and host µs after the profiler has run); ``launched``:
    the launch phase's rows at the same shapes (events ms and host µs
    before it).  Adds host µs per call beside the library call's and
    whether each goal was met: only figures measured in this run."""
    return {
        "host_us": launched[0]["host_us"], "library_host_us": launched[0]["library_host_us"],
        "host_us_after_profiler": timed[0]["host_us"],
        "library_device_ms": timed[0]["library_device_ms"],
        "launch_phase": launched,
        "goals": {
            "device_met": all(x["device_ms"] is not None and x["device_ms"] <= GOAL_DEVICE_MS[name]
                              for x in timed),
            "events_met": all(x["ms"] <= x["library_ms"] for x in launched),
            "events_met_in_timing_phase": all(x["ms"] <= x["library_ms"] for x in timed),
            "host_met": all(x["host_us"] < GOAL_HOST_US for x in launched),
        },
    }


def match_goals(name: str, t: dict, replay_map: dict, replay_bound) -> dict:
    """B6's, B7's and B8's extra keys in the kernels line: their times at
    the map replay's one-stream tick and whether each redesign goal was met
    — only figures measured in this run."""
    before = BEFORE[name]["replay_map_device_ms"]
    return {
        "replay_map_shape": {**replay_map, "bound_ms": replay_bound[0],
                             "bound_by": replay_bound[1]},
        "goals": {
            "device_met": t["device_ms"] is not None
            and t["device_ms"] <= GOAL_DEVICE_MS[name],
            "replay_map_device_met": replay_map["device_ms"] is not None
            and before is not None and replay_map["device_ms"] <= before / 3,
        },
    }


# the phases ``--phase NAME`` runs alone: (device, seed, card) -> None
ONE_PHASE = {
    "e2e": lambda device, seed, card: phase_e2e(device),
    "fused_mapping": lambda device, seed, card: fused_mapping_profile(
        device, phase_fused_mapping(device), card),
    "failover": lambda device, seed, card: failover_profile(device, phase_failover(device), card),
    "scheduled": lambda device, seed, card: scheduled_profile(device, phase_scheduled(device),
                                                              card),
    "fleet": lambda device, seed, card: phase_fleet(device, seed),
    "mesh_blocks": lambda device, seed, card: phase_mesh_blocks(device, seed, card),
    "checkpoints": lambda device, seed, card: phase_checkpoints(device),
    "scenarios": lambda device, seed, card: phase_scenarios(device),
    "tooling": lambda device, seed, card: phase_tooling(device),
    "graded": lambda device, seed, card: (phase_graded(device, card),
                                          graded_profile(device, card)),
    "loop": lambda device, seed, card: phase_loop(device, replay_revolutions(seed), seed),
}
# the graded phase's configurations, in its order
GRADED_CONFIGS = ("1", "2", "3", "4_pallas", "4_inc", "9", "11", "13", "16", "map1024")


def ref_plan(seed: int) -> dict:
    """Every CPU reference a phase holds the card to, by phase, in the
    order the phase asks for them: what the default run (and ``--phase``)
    hands its reference workers as the run starts.  The configuration
    phases' scheduled pods and every card-only comparison are not here."""
    from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx

    return {
        "fused_mapping": [(ref_fm_drains, "fused"), (ref_fm_drains, "host"),
                          (ref_fm_quarantine,)],
        "failover": [(ref_fo_pod,), (ref_fo_carried,)],
        "scheduled": [(ref_sched_prefix, n, arm, SCHEDULED["cpu_wall_ticks"][n])
                      for n, arms in ((19, ((1,), SCHEDULED[19]["rungs"])), (20, (False, True)),
                                      (21, (False, True)), (22, (True, False)))
                      for arm in arms],
        "scenarios": [(ref_scenario_cell, *a) for a in smx.cell_args(smx.geometry(False))]
        + [(ref_loop_probe, *_loop_probe_args(chaos)) for chaos in smx.CHAOS],
        "graded": [(ref_graded, name, _graded_geometry(name)) for name in GRADED_CONFIGS],
        "fleet": [(ref_fleet_bytes, n, arm) for n in FLEET["fleets"] for arm in _fleet_arms(n)]
        + [(ref_fleet_replay_chunk, seed), (ref_fleet_slam,)],
        "mesh_blocks": [(ref_mb_scan, seed, m) for m in ("pallas", "inc")]
        + [(ref_mb_host, m) for m in ("pallas", "inc")]
        + [(ref_mb_leg, leg) for leg in ("config10_fused", "config18_carried")],
        "mapping": [(ref_mapping, "host"), (ref_mapping, "cpu_torch")],
        "replay_map": [(ref_replay_map, seed)],
        "loop": [(ref_loop_arm, "off"), (ref_loop_arm, "host"), (ref_loop_replay, seed)],
        "replay_fused": [(ref_replay_fused, seed, False), (ref_replay_fused, seed, True),
                         (ref_deskew_twin, seed)],
    }


def _timed(name: str, fn, *args):
    """``fn(*args)``, a phase (or half of one) under the clock ``name``."""
    with phase_clock(name):
        return fn(*args)


def _start_references(phases, seed: int) -> None:
    """Open the reference workers and hand them every CPU reference of
    ``phases``, in order: they compute them on cores of their own while
    this process drives the card.  Started after the e2e phase, whose live
    arms keep their host to themselves."""
    plan = ref_plan(seed)
    jobs = [job for name in phases for job in plan.get(name, ())]
    if jobs:
        REFS.start()
        for fn, *args in jobs:
            REFS.submit(fn, *args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--revs", type=int, default=300)
    ap.add_argument("--trace-dir", default=None,
                    help="also write the profiled chain windows as Chrome traces here")
    ap.add_argument("--fleet-mp-worker", nargs=6, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-check", type=int, default=None, metavar="N",
                    help="only the fleet's multi-process check: N NCCL processes, one card "
                         "each, on (1, N) and (2, N/2) meshes (needs N cards)")
    ap.add_argument("--pod-cards", type=int, default=None, metavar="N",
                    help="only the N cards in one process: the serving pod over them (configs 15 "
                         "and 19-22, the pod's groups), config 8 and config 10's host arm over "
                         "(2, N/2) and (1, N) meshes of them, each held to one card and to the "
                         "CPU, and every kernel checked on each card (needs N cards)")
    ap.add_argument("--phase", choices=sorted(ONE_PHASE), action="append", default=None,
                    help="build the kernels and run this one phase alone (its profiled half "
                         "included), with the same last lines; given again, the phases run "
                         "in the order given, in one process")
    args = ap.parse_args(argv)
    if args.pod_cards and "CUDA_VISIBLE_DEVICES" not in os.environ:
        # the pod spreads over every visible card: show it the first N
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(d) for d in range(args.pod_cards))

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "rplidar_ros2_driver_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, here)
    if args.fleet_mp_worker:
        rank, port, world, stream, backend, dev = args.fleet_mp_worker
        return fleet_mp_worker(int(rank), int(port), int(world), int(stream), backend, dev)
    if args.mesh_check:
        n = args.mesh_check
        check(torch.cuda.device_count() >= n, f"--mesh-check {n} needs {n} cards")
        info = _timed("device", phase_device)
        _timed("build", phase_build)
        with phase_clock("mesh_check"):
            rows = {f"{s}x{n // s}": _fleet_multiprocess(n, s, "nccl", one_card=False)
                    for s in (1, 2) if n % s == 0}
            emit({"phase": "mesh_check", "cards": n, "meshes": rows})
        print(info["nvidia_smi"], flush=True)
        return 0
    if args.pod_cards:
        n = args.pod_cards
        check(torch.cuda.device_count() == n,
              f"--pod-cards {n} needs {n} cards, {torch.cuda.device_count()} visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        info = _timed("device", phase_device)
        _timed("build", phase_build)
        _timed("pod_cards", phase_pod_cards, n, info["nvidia_smi"], info["nvidia_smi_cards"],
               args.seed)
        print(info["nvidia_smi"], flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    info = _timed("device", phase_device)
    _timed("build", phase_build)
    try:
        if args.phase:
            if "e2e" not in args.phase:
                _start_references(args.phase, args.seed)
            for name in args.phase:
                _timed(name, ONE_PHASE[name], device, args.seed, info["nvidia_smi"])
            print(info["nvidia_smi"], flush=True)
            emit({"ok": True, "device": {"platform": "gpu",
                                         "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}})
            return 0
        return _default_run(args, device, info, t_start)
    finally:
        REFS.close()


def _default_run(args, device, info: dict, t_start: float) -> int:
    """Every phase in order, then the kernels line and the last lines."""
    import numpy as np
    import torch

    card = info["nvidia_smi"]
    # before any profiler session and before the reference workers start
    launch = _timed("launch", phase_launch, device, np.random.default_rng(args.seed + 3))
    _timed("e2e", phase_e2e, device)
    _start_references(["fused_mapping", "failover", "scheduled", "scenarios", "graded", "fleet",
                       "mesh_blocks", "mapping", "replay_map", "loop", "replay_fused"], args.seed)
    # phases with no CPU reference first, while the workers start on theirs
    ckpt = _timed("checkpoints", phase_checkpoints, device)
    tooling = _timed("tooling", phase_tooling, device)
    fmap = _timed("fused_mapping", phase_fused_mapping, device)
    # the failover pod's timed pass, before any profiler session
    failover = _timed("failover", phase_failover, device)
    sched = _timed("scheduled", phase_scheduled, device)
    scen = _timed("scenarios", phase_scenarios, device)
    graded = _timed("graded", phase_graded, device, card)
    fleet = _timed("fleet", phase_fleet, device, args.seed)
    mesh_blocks = _timed("mesh_blocks", phase_mesh_blocks, device, args.seed, card)
    _timed("fused_mapping", fused_mapping_profile, device, fmap, card)
    _timed("failover", failover_profile, device, failover, card)
    _timed("scheduled", scheduled_profile, device, sched, card)
    graded_map = _timed("graded_profile", graded_profile, device, card)
    kern = _timed("kernels", phase_kernels, device, np.random.default_rng(args.seed))
    revs = make_revolutions(args.seed, args.revs, GEOMETRY["points"])
    chain = _timed("chain", phase_chain, device, revs)
    _timed("profile", phase_profile, device, revs, args.trace_dir)
    _timed("ab", phase_ab, device, revs)
    _timed("node", phase_node, device)
    replay, replay_revs, replay_frames = _timed("replay", phase_replay, device, args.seed)
    mapk = _timed("mapkernels", phase_mapkernels, device, np.random.default_rng(args.seed + 1))
    mapping = _timed("mapping", phase_mapping, device)
    replay_map = _timed("replay_map", phase_replay_map, device, replay_revs, args.seed)
    loop = _timed("loop", phase_loop, device, replay_revs, args.seed)
    dskk = _timed("deskew_kernels", phase_deskew_kernels, device,
                  np.random.default_rng(args.seed + 2))
    fused = _timed("replay_fused", phase_replay_fused, device, replay_frames, replay_revs,
                   args.seed, args.trace_dir)

    w, b = GEOMETRY["window"], GEOMETRY["beams"]
    w3, k3, b3 = REPLAY["window"], REPLAY["chunk"], REPLAY["beams"]
    src = "rplidar_ros2_driver_tpu_torch/csrc/"
    kernels = []
    for name, source, replaces, (bnd, by), launches in (
        ("temporal_median", "median.cu", "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:396",
         bound(w * b * 4 + b * 4, 2 * w * b), chain["launches"]["temporal_median"]),
        ("sorted_replace", "median.cu", "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:337",
         bound(2 * w * b * 4 + 3 * b * 4, 2 * w * b), chain["launches"]["sorted_replace"]),
        # B3 reads the (W+K, B) stripe once and writes (K, B) medians; the
        # least compare work of a sliding selection is 2·W per output
        ("sliding_median", "sliding_median.cu", "rplidar_ros2_driver_tpu/ops/pallas_kernels.py:215",
         bound((w3 + 2 * k3) * b3 * 4, 2 * w3 * k3 * b3), replay["launches"]["sliding_median"]),
    ):
        t = kern["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": replaces,
            "launches": launches, "max_abs_err": kern["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
        })
        if name == "temporal_median":
            kernels[-1].update(redesign_report(name, [t], [launch["temporal_median"]]))
        if name in ("sorted_replace", "sliding_median"):
            kernels[-1]["goals"] = {"device_met": t["device_ms"] is not None
                                    and t["device_ms"] <= GOAL_DEVICE_MS[name]}
        if name == "sliding_median":
            kernels[-1]["plan"] = t["plan"]
            kernels[-1]["tail_k7"] = t["tail_k7"]
    # B6/B7/B8: launches on the config-12 fleet path (one per tick each);
    # the map replay's launches are checked in its phase
    for name, replaces in (
        ("coarse_scores", "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:154"),
        ("fine_scores", "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:248"),
        ("log_odds_update", "rplidar_ros2_driver_tpu/ops/pallas_scan_match.py:369"),
    ):
        t = mapk["times"]["config12"][name]
        bnd, by = mapk["bounds"]["config12"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "scan_match.cu", "replaces": replaces,
            "launches": mapping["launches"][name], "max_abs_err": mapk["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "replay_map_launches": replay_map["launches"][name],
        })
        if name in GOAL_DEVICE_MS:
            kernels[-1].update(match_goals(name, t, mapk["times"]["replay_map"][name],
                                           mapk["bounds"]["replay_map"][name]))
        if name in loop["kernels_at_loop_shape"]:
            # B6/B7 at the loop check's shape (config 17: N = 4 streams x 2
            # candidates), launches on the phase's fused arm
            kernels[-1]["loop_close_shape"] = loop["kernels_at_loop_shape"][name]
    # B4/B5: launches on the de-skew-on fused replay; B4 is timed at both
    # of its shapes there (the rasterizer's in the row, the profiles' beside)
    for name, key, replaces in (
        ("beam_min", "beam_min_raster", "rplidar_ros2_driver_tpu/ops/pallas_deskew.py:104"),
        ("shift_sad", "shift_sad", "rplidar_ros2_driver_tpu/ops/pallas_deskew.py:198"),
    ):
        t = dskk["times_ms"][key]
        bnd, by = t["bound"]
        entry = {
            "name": name, "route": "cuda", "source": src + "deskew.cu", "replaces": replaces,
            "launches": fused["deskew_on"]["launches"][name],
            "max_abs_err": dskk["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bnd, "bound_by": by,
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"], "shape": t["shape"],
        }
        if name == "beam_min":
            p = dskk["times_ms"]["beam_min_profile"]
            entry["library_device_ms"] = t["library_device_ms"]
            entry["profile_shape"] = {k: p[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                                         "library_ms", "library_device_ms",
                                                         "bound", "host_us", "library_host_us")}
            entry.update(redesign_report(
                name, [t, p], [launch["beam_min_raster"], launch["beam_min_profile"]]))
        if name == "shift_sad":
            lp = launch["shift_sad"]
            entry.update({
                "host_us": lp["host_us"], "host_us_after_profiler": t["host_us"],
                "launch_phase": lp,
                "goals": {
                    "device_met": t["device_ms"] is not None
                    and t["device_ms"] <= GOAL_DEVICE_MS[name],
                    "events_within_1us_of_b4": abs(lp["ms"] - lp["beside_ms"]) * 1e3
                    <= GOAL_B5_GAP_US,
                    "host_within_1us_of_b4": abs(lp["host_us"] - lp["beside_host_us"])
                    <= GOAL_B5_GAP_US,
                },
            })
        kernels.append(entry)
    for k in kernels:
        # the fleet's path (config 10's byte arms, config 8's replay, the
        # SLAM seams)
        k["fleet_launches"] = fleet["launches"].get(k["name"], 0)
        check(k["fleet_launches"] > 0, f"kernel {k['name']} never launched on the fleet path")
        # this slice's path: config 18, the carried map against the host
        # route (B2 and B3 are not on it)
        k["fused_mapping_launches"] = fmap["launches"].get(k["name"], 0)
        if k["name"] not in ("sorted_replace", "sliding_median"):
            check(k["fused_mapping_launches"] > 0,
                  f"kernel {k['name']} never launched on the fused mapping path")
        if k["name"] in fmap["kernels_at_path_tick"]:
            k["fused_mapping_tick"] = fmap["kernels_at_path_tick"][k["name"]]
        # the failover pod's path: config 15 (B1, B6-B8) and the carried
        # arm (B4, B5 too); B2 and B3 are not on it
        k["failover_launches"] = failover["failover_launches"].get(k["name"], 0)
        if k["name"] not in ("sorted_replace", "sliding_median"):
            check(k["failover_launches"] > 0,
                  f"kernel {k['name']} never launched on the failover path")
        # the scheduled pods' paths: configs 19-22 (B1; B6-B8 on config
        # 22's mappers); B2-B5 are not on them
        k["scheduled_launches"] = sched["scheduled_launches"].get(k["name"], 0)
        if k["name"] in ("temporal_median", "coarse_scores", "fine_scores", "log_odds_update"):
            check(k["scheduled_launches"] > 0,
                  f"kernel {k['name']} never launched on the scheduled path")
        # this slice's paths: the sharded checkpoints, the scenario matrix,
        # the tooling (each phase checks its own kernels launched)
        k["checkpoints_launches"] = ckpt["launches"].get(k["name"], 0)
        k["scenarios_launches"] = scen["launches"].get(k["name"], 0)
        k["tooling_launches"] = tooling["launches"].get(k["name"], 0)
        # this slice's path: the graded configurations (1-4, 9, 11, 13, 16
        # and the 1024^2 map); B3 is not on it
        k["graded_launches"] = graded["launches"].get(k["name"], 0)
        # this slice's path: config 8 and config 10's host arm over a (2, 2)
        # mesh of four blocks on the card (B1, B2 and B3, once a block)
        k["mesh_blocks_launches"] = mesh_blocks["launches"].get(k["name"], 0)
        if k["name"] in ("temporal_median", "sorted_replace", "sliding_median"):
            check(k["mesh_blocks_launches"] > 0,
                  f"kernel {k['name']} never launched on the mesh blocks path")
        if k["name"] != "sliding_median":
            check(k["graded_launches"] > 0,
                  f"kernel {k['name']} never launched on the graded path")
        if k["name"] in graded_map["kernels"]:
            k["graded_map1024_tick"] = {**graded_map["kernels"][k["name"]],
                                        "shape": graded_map["shape"]}
    for name in ("temporal_median", "sliding_median"):
        entry = next(k for k in kernels if k["name"] == name)
        entry["fleet_shapes"] = {key: v for key, v in fleet["shapes"].items()
                                 if key.startswith(name)}
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on the main path")
    with phase_clock("references"):
        emit({"phase": "references", "workers": len(REFS.cpus), "worker_cpus": REFS.cpus,
              "driver_cpus": sorted(os.sched_getaffinity(0)),
              "worker_seconds": REFS.worker_seconds,
              "cpu_seconds_by_phase": {k: v[1] for k, v in _CLOCKS.items()}})
    with phase_clock("before"):
        emit({"phase": "before", "constants_from": "PERF.md (not measured in this run)",
              "figures": BEFORE, "goal_device_ms": GOAL_DEVICE_MS, "goal_host_us": GOAL_HOST_US})
    emit({"kernels": kernels, "seconds": time.perf_counter() - t_start})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
