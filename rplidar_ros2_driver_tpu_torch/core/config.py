"""Parameter surface.

Mirrors the reference's 13 ROS 2 parameters (declared in the node
constructor and ``init_parameters``, src/rplidar_node.cpp:80-90,268-289;
defaults shipped in param/rplidar.yaml) and adds the filter-chain
parameters that are this framework's north star (BASELINE.json).

This is the PyTorch package's copy of the JAX package's parameter
surface: the same fields and defaults, so one YAML drives either
package.  Only ``VALID_BACKENDS`` differs (it also accepts ``cuda``).

Three tiers, like the reference:
  * static params (read once at configure time),
  * runtime-mutable params (rpm / scan_processing / scan_mode,
    src/rplidar_node.cpp:689-774) — see node/node.py set_parameters,
  * device-side config (the GET/SET_LIDAR_CONF key space) — see
    protocol/conf.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Baud-rate table shipped in param/rplidar.yaml:9-15.
MODEL_BAUD_TABLE = {
    "A1": 115200,
    "A2M8": 115200,
    "A2M7": 256000,
    "A2M12": 256000,
    "A3": 256000,
    "S1": 256000,
    "C1": 460800,
    "S2": 1000000,
    "S3": 1000000,
}

RUNTIME_MUTABLE = ("rpm", "scan_processing", "scan_mode")

VALID_QOS = ("reliable", "best_effort")
# "tpu" (the default, kept so the same YAML drives both packages) and
# "cuda" both mean "the accelerator": cuda:0 in this package, which
# raises rather than falling back to the host when no card is present
VALID_BACKENDS = ("cpu", "tpu", "cuda")
VALID_CHANNELS = ("serial", "tcp", "udp", "dummy")
# "polar" is accepted for symmetry with the BASELINE graded configs but
# the Cartesian projection is always computed inside the fused step (its
# output feeds voxelization); the other three stages toggle real work.
VALID_FILTER_STAGES = ("clip", "polar", "median", "voxel")


@dataclasses.dataclass
class DriverParams:
    """All tunables, defaults matching param/rplidar.yaml."""

    # -- connection (param/rplidar.yaml:5-15) --
    serial_port: str = "/dev/rplidar"
    serial_baudrate: int = 1000000
    channel_type: str = "serial"      # serial | tcp | udp (sl channel factories)
    tcp_host: str = "192.168.0.7"
    tcp_port: int = 20108
    udp_host: str = "192.168.11.2"
    udp_port: int = 8089

    # -- frame / geometry (param/rplidar.yaml:17-33) --
    frame_id: str = "laser"
    inverted: bool = False
    angle_compensate: bool = True

    # -- processing (param/rplidar.yaml:35-57) --
    scan_processing: bool = False
    scan_mode: str = ""               # "" => auto (DenseBoost > Sensitivity)
    rpm: int = 0                      # 0 => device default (600)
    max_distance: float = 0.0         # 0 => hardware limit

    # -- simulation / recovery (param/rplidar.yaml:59-88) --
    dummy_mode: bool = False
    max_retries: int = 3

    # -- publishing (param/rplidar.yaml:73-80) --
    publish_tf: bool = True
    qos_reliability: str = "best_effort"

    # -- filter chain (new; BASELINE.json north star) --
    filter_backend: str = "tpu"       # cpu | tpu | cuda (tpu = the accelerator)
    filter_window: int = 16           # rolling scans kept on device (<= 64 typical)
    # empty = raw passthrough (reference-parity default); enable stages for
    # the device pipeline, e.g. ("clip", "polar", "median", "voxel")
    filter_chain: tuple = ()
    range_clip_min_m: float = 0.15
    range_clip_max_m: float = 40.0
    intensity_min: float = 0.0
    voxel_grid_size: int = 256        # cells per side of the 2-D occupancy grid
    voxel_cell_m: float = 0.25        # metres per cell
    # temporal-median implementation, same values as the JAX package:
    # "xla" (plain sort), "pallas" (the hand-written per-beam selection
    # kernel, ops/median_kernels.py), "inc" (incremental sliding median
    # over a sorted-window carried state; "inc_pallas" pins its kernel,
    # "inc_xla" its plain form), or "auto" — resolved per device by
    # filters/chain.resolve_median_backend.
    median_backend: str = "auto"
    # per-scan streaming-step resampler: "scatter" (jnp .at[].min),
    # "dense" (the fused path's tiled masked-min at K=1; bit-identical,
    # parity-tested), or "auto" — resolved per device platform from the
    # streaming-step ablation evidence (scripts/step_ablation.py;
    # resolve_resample_backend in filters/chain.py holds the mapping and
    # its provenance).  The fused replay path always uses the dense tile.
    resample_backend: str = "auto"
    # voxel accumulation kernel: "scatter" (.at[].add histogram),
    # "matmul" (one-hot einsum on the MXU, exact counts), or "auto" —
    # resolved per platform from the step-ablation evidence
    # (resolve_voxel_backend in filters/chain.py)
    voxel_backend: str = "auto"
    # ingest backend seam: "host" = the golden path (CPU-pinned batch
    # decode -> Python revolution assembly -> packed per-revolution
    # upload into the chain); "fused" = device-resident single-dispatch
    # ingest (raw frame bytes staged once, unpack + revolution
    # segmentation + the donated filter step in ONE compiled program —
    # ops/ingest.py / driver/ingest.FusedIngest; bit-exact vs host,
    # tests/test_fused_ingest.py).  "auto" resolves per the standing
    # decision procedure (filters/chain.resolve_ingest_backend —
    # currently host).  Fused requires the filter chain and a wire-
    # streaming driver (real/sim); it drops the RawNodeHolder interval
    # tap and the chain checkpoint surface.
    ingest_backend: str = "host"
    # fleet ingest backend seam (parallel/service.py submit_bytes*):
    # "host" = per-stream host decode (BatchScanDecoder + ScanAssembler,
    # newest revolution per stream) feeding the one batched sharded
    # filter dispatch per tick — the golden fleet path; "fused" = the
    # fleet-fused single-dispatch path (ops/ingest.fleet_fused_ingest_step
    # via driver/ingest.FleetFusedIngest: every stream's raw frame bytes
    # staged into ONE buffer, unpack + segmentation + per-stream filter
    # steps in ONE compiled vmapped program per tick — O(1) dispatches
    # and transfers per tick, independent of fleet size; bit-exact vs N
    # independent host paths, tests/test_fleet_fused_ingest.py).  "auto"
    # resolves per the standing decision procedure
    # (filters/chain.resolve_fleet_ingest_backend — host until an
    # on-chip artifact clears the bar; scripts/decide_backends.py flips
    # it from `fleet_ingest_ab` evidence).
    fleet_ingest_backend: str = "auto"
    # T-tick super-step lowering (ops/ingest.super_fleet_ingest_step via
    # driver/ingest.FleetFusedIngest): when a backlog of fleet ticks is
    # queued (link stall, slow consumer — submit_backlog /
    # ShardedFilterService.submit_bytes_backlog) or one tick splits
    # across bucket slices, up to this many ticks drain in ONE compiled
    # dispatch instead of T (lax.scan over the fleet tick, carries as
    # donated scan state — bit-exact vs T sequential ticks,
    # tests/test_super_tick.py).  1 disables the lowering (per-tick
    # dispatches only); each (T, bucket) pair costs one extra program
    # compile, warmed by FleetFusedIngest.precompile.
    super_tick_max: int = 1
    # where the CUDA kernel libraries are built and kept
    # (utils/backend.maybe_enable_compilation_cache moves
    # utils/cuda_build.BUILD_DIR there; None keeps build/torch_kernels/):
    # a restart that finds a library there loads it instead of running
    # nvcc (the JAX package names its XLA compilation cache with this key)
    compilation_cache_dir: str | None = None
    # -- SLAM front-end (mapping/mapper.FleetMapper + ops/scan_match) --
    # enable the per-stream log-odds mapper + correlative scan matcher:
    # each revolution's chain output is matched against a persistent
    # occupancy map and the estimated pose published alongside the scan.
    # Requires filter_chain stages (the mapper consumes the chain's
    # Cartesian endpoint output).
    map_enable: bool = False
    # mapper backend seam: "host" = the NumPy golden reference (one
    # per-stream step on the host — the bit-exact oracle); "fused" = the
    # device path (N streams match N maps in ONE compiled vmapped
    # dispatch per fleet tick, ops/scan_match.fleet_map_match_step —
    # bit-exact vs N host steps, tests/test_mapping.py); "auto" resolves
    # per the standing decision procedure (mapping/mapper.
    # resolve_map_backend — host until an on-chip config-12 artifact
    # clears the bar; scripts/decide_backends.py reads `mapping_ab`).
    map_backend: str = "auto"
    # correlative-matcher kernel lowering (MapConfig.match_backend):
    # "xla" = the jnp score-volume + log-odds-update arm in
    # ops/scan_match.py; "pallas" = the VMEM-tiled Pallas kernels
    # (ops/pallas_scan_match.py — match map resident in VMEM across the
    # whole (dθ,dx,dy) candidate grid, scatter-free one-hot/matmul
    # log-odds update; interpret mode off-TPU so CPU configs stay
    # runnable).  Bit-exact either way (the int32 datapath makes
    # evaluation order irrelevant; tests/test_pallas_scan_match.py).
    # "auto" resolves per the standing decision procedure
    # (mapping/mapper.resolve_match_backend — xla until an on-chip
    # config-14 artifact clears the bar; scripts/decide_backends.py
    # reads `pallas_match_ab`, TPU records only, interpret-mode runs
    # carry no weight).
    match_backend: str = "auto"
    # fused mapping route ("one dispatch for the whole stack"):
    # "fused" threads the per-stream MapState through the fused ingest
    # carry (ops/ingest cfg.mapping) so bytes -> decode -> de-skewed
    # sweep -> pose -> map update is ONE compiled program per
    # (super-)tick per shard — T ticks of ingest+mapping collapse from
    # T+T dispatches to 1; "host" keeps the two-dispatch golden
    # reference (the ingest dispatch plus a separate FleetMapper
    # dispatch fed from take_recon()); "auto" resolves per the standing
    # decision procedure (mapping/mapper.resolve_fused_mapping_backend
    # — host until an on-chip config-18 artifact clears the bar;
    # scripts/decide_backends.py reads `fused_mapping_ab`, TPU records
    # only).  Requires map_enable + deskew_enable + the fused fleet
    # ingest seam (the in-program mapper consumes the reconstructed
    # sweep; both routes are byte-identical — tests/test_fused_mapping
    # pins trajectories, wires and final MapState across T x fleet x
    # matcher-backend arms).
    fused_mapping_backend: str = "auto"
    map_grid: int = 256               # cells per side of the log-odds map
    map_cell_m: float = 0.05          # metres per map cell
    map_match_window: float = 0.4     # translation search radius (m)
    # log-odds parameters (probability units; quantized to Q10 fixed
    # point once, in mapping/mapper.map_config_from_params)
    map_log_odds_hit: float = 0.9     # increment per endpoint hit
    map_log_odds_miss: float = -0.4   # decrement per free-space pass
    map_log_odds_clamp: float = 8.0   # saturation bound (±)
    # per-revolution decay of every cell toward zero (dynamic scenes:
    # stale moving-obstacle evidence fades even when no ray revisits
    # it).  0.0 disables — and the gate is static, so the default traces
    # the byte-identical mapping program the pre-decay tree compiled
    map_decay: float = 0.0
    # -- SLAM back-end: loop closure + pose graph (slam/loop.
    # LoopClosureEngine + ops/loop_close.py + ops/pose_graph.py) --
    # attach the loop-closure engine beside the mapper: every
    # loop_submap_revs revolutions the stream's MapState finalizes into
    # a quantized submap (library capped at loop_max_submaps,
    # cap-and-hold); every loop_check_revs revolutions the current scan
    # is matched against the loop_candidates nearest submaps in ONE
    # call for the whole fleet (candidate scoring reuses the correlative
    # matcher's score-volume core, so match_backend routes it through the
    # plain arm or the kernels B6/B7), and accepted closures feed the
    # fixed-point pose-graph relaxation whose corrected pose is
    # republished.
    # Requires map_enable (the back-end closes the front-end's loop).
    loop_enable: bool = False
    # loop backend seam: "host" = the NumPy golden reference
    # (ops/loop_close_ref.py — the bit-exact oracle); "fused" = the
    # device path (N streams check N submap libraries in one call,
    # ops/loop_close.fleet_loop_close_step); "auto" = fused on a CUDA
    # device, host otherwise (slam/loop.resolve_loop_backend).
    loop_backend: str = "auto"
    loop_submap_revs: int = 8         # revolutions between finalizations
    loop_max_submaps: int = 8         # submap library capacity (= graph nodes)
    loop_check_revs: int = 4          # revolutions between closure checks
    loop_candidates: int = 2          # nearest submaps scored per check
    loop_window_cells: int = 4        # candidate coarse search radius (coarse cells)
    loop_theta_window: int = 8        # candidate search: ± rotation-table steps
    loop_min_points: int = 32         # overlap gate: valid endpoints required
    # absolute acceptance gate as a right shift of the per-point score
    # CEILING (clamp_q-after-quantization x the bilinear weight sum):
    # accept needs a mean per-point score above ceiling >> shift — 3 =
    # 1/8 of a perfectly saturated perfectly aligned match.  A shift
    # keeps the bar geometry-independent (the raw score scale moves
    # with quant_shift, which min_quant_shift derives from beams).
    loop_accept_shift: int = 3
    loop_peak_shift: int = 3          # contrast gate: peak-floor >= best>>s
    loop_weight: int = 4              # loop-constraint weight (odometry = 1)
    # rewrite the submap anchors AND the front-end pose to the corrected
    # solution on an accepted closure (map re-anchoring): subsequent
    # revolutions rasterize in the corrected frame.  Off by default —
    # corrected poses are republished either way; re-anchoring
    # additionally mutates the front-end trajectory.
    loop_reanchor: bool = False
    # fixed relaxation sweeps per solve (ops/pose_graph.py)
    pose_graph_iters: int = 96
    # loop-constraint plane capacity (dense padded; the solver plane is
    # loop_max_submaps odometry rows + this many loop rows)
    pose_graph_max_constraints: int = 16
    # -- shared-world mapping plane (mapping/worldmap.WorldMap +
    # mapping/tiles.py + ops/tile_quant.py) --
    # attach the fleet-wide world map: finalized per-stream submaps are
    # aligned against a fixed reference (the matcher's bit-exact host
    # twin, loop-closure search radii), fused into ONE device-resident
    # int32 accumulation (associative addition — any merge order is
    # byte-identical; eviction subtracts exactly), and served as
    # versioned quantized run-length tile snapshots published on the
    # idle staging half (a map read adds zero dispatches to a drain).
    # Requires map_enable (the world is made of the mapper's submaps).
    world_map_enable: bool = False
    # tile serving backend seam: "raw" = dense int32 tiles (lossless —
    # the A/B baseline arm); "int8"/"int4" = SR-LIO++-style quantized
    # levels + run-length coding (mapping/tiles.resolve_map_tile_backend
    # — bounded band-midpoint error, tests pin it); "auto" = int8
    # (capacity feature with a validated error bound, so auto does not
    # wait on on-chip evidence; the `map_serving_ab` decide_backends
    # key governs only the serving-latency claim, TPU records only).
    map_tile_backend: str = "auto"
    world_tile_cells: int = 8         # tile edge (cells; must divide map_grid)
    world_max_submaps: int = 16       # world membership cap (= graph nodes)
    world_merge_revs: int = 4         # revolutions between cross-stream merges
    world_publish_ticks: int = 8      # drain ticks between tile publications
    # -- de-skew + sweep reconstruction (ops/deskew.py, fused ingest) --
    # per-revolution range-only de-skew + caching-aware sweep
    # reconstruction INSIDE the fused ingest core
    # (ops/ingest._segment_filter_core — rides the single-stream,
    # fleet-vmapped and super-tick lowerings with zero extra
    # dispatches): the per-revolution rigid motion is estimated from
    # consecutive revolutions' range profiles (no IMU — the wire
    # carries none) and every beam re-projected to the revolution's end
    # pose by its phase fraction, int32 end to end so the NumPy host
    # twin (ops/deskew_ref.py) stays bit-exact; each tick's nodes also
    # land in a device-resident ring of the last K sub-sweep segments
    # whose newest-wins overlay is emitted EVERY tick as a
    # reconstructed sweep — the mapper seam consumes it for R >= 2
    # matcher/mapper updates per physical revolution at the same
    # dispatch count (bench --config 16; scripts/decide_backends.py
    # `deskew_ab` key gates the default flip on on-chip evidence).
    # Requires a fused ingest seam (the host service path has no
    # per-tick device residency to cache sub-sweeps in).
    deskew_enable: bool = False
    # K: sub-sweep segments cached per stream; the reconstruction
    # window (and the cache-expiry horizon — data older than K data
    # ticks ages out of the ring)
    sweep_reconstruct_window: int = 4
    # motion-profile beam grid (power of two in [64, 1024]) and the
    # ± dθ search radius in profile-beam steps
    deskew_profile_beams: int = 256
    deskew_shift_window: int = 8
    # de-skew kernel lowering (ops/deskew.DeskewConfig.backend): "xla"
    # = the jnp dense tiled-min / shift-search arms; "pallas" = the
    # VMEM-tiled kernels (ops/pallas_deskew.py — the sub-sweep
    # rasterizer's beam-min and the profile shift search, the two
    # intra-program hot loops the fused mapping route exposes; interpret mode
    # off-TPU so CPU configs stay runnable).  Bit-exact either way
    # (int32 min/sum are evaluation-order independent;
    # tests/test_pallas_deskew.py).  "auto" resolves per the standing
    # decision procedure (ops/deskew.resolve_deskew_backend — xla
    # until on-chip evidence; CPU interpret-mode runs carry no weight).
    deskew_backend: str = "auto"
    # -- fleet fault tolerance (driver/health.py + parallel/service.py) --
    # attach the per-stream health FSM supervisor to the fleet byte-tick
    # seams (ShardedFilterService.submit_bytes*): HEALTHY -> SUSPECT ->
    # QUARANTINED -> RECOVERING per stream, driven by corrupt-frame
    # ratio and tick-starvation age.  Quarantined streams are masked
    # onto the existing idle padding lanes (same compiled program, zero
    # recompiles — graftlint/guards enforced), their filter+map state
    # checkpointed at quarantine and restored at rejoin.  Off by
    # default: single-node deployments already have the scan-loop FSM.
    health_enable: bool = False
    health_window_ticks: int = 8      # sliding observation window (ticks)
    health_corrupt_ratio: float = 0.5  # malformed/total over window -> bad
    health_starvation_ticks: int = 16  # ticks w/o a revolution -> bad
    health_suspect_ticks: int = 4     # consecutive bad ticks -> quarantine
    health_probation_ticks: int = 4   # consecutive clean ticks -> healthy
    # capped exponential backoff on quarantine release / reconnect
    # probing: min(base * 2**attempt, max) * (1 + jitter * u)
    health_backoff_base_s: float = 0.5
    health_backoff_max_s: float = 30.0
    health_backoff_jitter: float = 0.1
    # -- elastic fleet / shard failover (parallel/service.
    # ElasticFleetService + driver/health.ShardHealth) --
    # number of shards in the fleet-of-fleets pod: each shard is one
    # fused engine pair (FleetFusedIngest + FleetMapper) hosting
    # `shard_lanes` stream lanes; streams are placed onto shards by
    # parallel/sharding.FleetTopology and migrate between them with
    # zero recompiles (membership changes relabel lanes, never shapes).
    # 1 = single-shard (no failover headroom — nowhere to evacuate to).
    shard_count: int = 1
    # stream lanes compiled per shard: 0 = auto, the smallest count
    # that survives one full shard loss ((shards-1)*lanes >= streams).
    # The idle lanes are the evacuation headroom AND the padding lanes
    # quarantined streams already ride.
    shard_lanes: int = 0
    # shard health FSM thresholds (UP -> SUSPECT -> LOST ->
    # READMITTING): fleet-wide tick starvation walks a shard to LOST;
    # a raised dispatch or a chaos kill is LOST immediately.
    shard_starvation_ticks: int = 8   # all-lane dry ticks -> bad
    shard_suspect_ticks: int = 4      # consecutive bad ticks -> LOST
    shard_probation_ticks: int = 4    # productive readmitting ticks -> UP
    # capped exponential backoff + probe gate on shard re-admission
    shard_backoff_base_s: float = 1.0
    shard_backoff_max_s: float = 60.0
    shard_backoff_jitter: float = 0.1
    # cadence of the per-stream snapshot pulls that feed the evacuation
    # store (row-sized gather + host fetch per stream, every N ticks):
    # on shard loss, each victim restores from its LAST pulled snapshot
    # — ticks since it are lost, so the cadence bounds the loss window.
    # 0 disables pulls (victims restore as fresh streams).
    failover_snapshot_ticks: int = 8
    # -- traffic-shaped elastic serving (parallel/scheduler.py) --
    # precompiled super-tick RUNG ladder for backlog drains: every
    # listed depth T gets its own pre-warmed (T, bucket) executable at
    # FleetFusedIngest.precompile, and the scheduler picks the rung per
    # drain from measured backlog depth — a burst is swallowed in one
    # deep dispatch, steady traffic stays on the low-latency shallow
    # rungs, and a mid-run rung switch is a compile-cache hit by
    # construction (zero recompiles, guards-pinned).  Must start at 1
    # (the per-tick program is the floor the scheduler can always fall
    # to) and ascend; each extra rung costs one compile per bucket at
    # warmup.  The ladder is inert until a TrafficShaper is attached
    # (ShardedFilterService.attach_scheduler / ElasticFleetService).
    sched_rungs: tuple = (1, 2, 4, 8)
    # consecutive drains at or below a LOWER rung's depth before the
    # scheduler steps down one rung (stepping UP is immediate — a burst
    # must be swallowed now, but easing back waits out the echo so a
    # sawtooth backlog doesn't thrash the rung choice)
    sched_hysteresis_ticks: int = 2
    # per-shard drain deadline budget (ms): the rung choice is capped
    # so the PREDICTED drain wall time (EWMA per-tick drain cost x
    # rung depth) stays inside the budget — the SLO feeding the rung
    # choice.  0 disables the cap (backlog depth alone picks the rung).
    sched_deadline_ms: float = 0.0
    # EWMA weight for the per-stream byte-rate estimate that feeds
    # byte-rate-weighted placement (FleetTopology weights) and the
    # /diagnostics scheduler group
    sched_byte_rate_alpha: float = 0.2
    # per-stream admission bound: a stream's queued backlog never
    # exceeds this many ticks — beyond it the OLDEST queued tick is
    # shed (counted per stream, surfaced on /diagnostics), never
    # unbounded growth.  The SLO-aware admission policy's hard edge.
    admission_max_backlog_ticks: int = 32
    # -- link-latency hiding --
    # double-buffered async H2D staging: within a multi-group drain the
    # NEXT group's staging planes are filled and device_put while the
    # previous group's compute is in flight, so the host->device link
    # transfer of drain t+1 hides under the compute of drain t (d2h
    # already overlaps via async dispatch).  Staging order is
    # unchanged — byte-equal trajectories by construction; off
    # reproduces the serialized stage->compute order exactly (the
    # bench --config 20 A/B arm).
    staging_double_buffer: bool = True
    # adaptive padding-bucket LADDER for the frame-run bucket M: every
    # listed bucket is pre-warmed per rung at precompile (one compiled
    # program per (rung, bucket)), and the scheduler's live-lane
    # occupancy EWMA picks the ACTIVE slicing cap with hysteresis —
    # occupancy collapse (many idle/quarantined lanes) drops dispatches
    # to a cheaper executable with zero recompiles; recovery steps back
    # up.  Must be strictly ascending when set; empty disables the
    # ladder (the static largest-bucket cap).
    # Inert until a TrafficShaper is attached.
    bucket_rungs: tuple = ()
    # EWMA weight of the live-lane occupancy estimate feeding the
    # bucket ladder (deliberately separate from sched_byte_rate_alpha:
    # retuning placement responsiveness must not silently retune the
    # bucket choice, or vice versa)
    occupancy_alpha: float = 0.2
    # -- pod of pods: two-level placement, stealing, autoscale --
    # number of HOSTS the pod's shards split across (two-level
    # (host, shard, lane) coordinates): shards partition into
    # contiguous equal blocks, one host-local StagingPool per block,
    # and placement/evacuation/rebalance prefer same-host moves.
    # Must divide shard_count; 1 = the single-level pod (byte-
    # identical placement to pre-PR-17).
    pod_hosts: int = 1
    # cross-shard work stealing: when a shard's queued backlog depth
    # exceeds this many ticks and a sibling has idle lanes plus
    # deadline headroom, the sibling drains whole per-stream QUEUES
    # borrowed for that drain only (row snapshot -> restore onto the
    # taker's idle lane, decode carries intact, copied home after —
    # placement never moves).  Byte-equal to the no-steal schedule by
    # construction: admission and tick order are untouched, the policy
    # picks WHERE, never what.  0 disables stealing.
    steal_threshold_ticks: int = 0
    # reserve (ms) subtracted from sched_deadline_ms when pricing a
    # prospective taker's post-steal drain with the measured latency
    # model — the taker must finish the borrowed depth inside
    # (deadline - headroom).  With sched_deadline_ms=0 this is the
    # absolute budget; 0 disables the time gate (idle lanes alone
    # gate the steal).  Must stay below sched_deadline_ms when both
    # are set.
    steal_headroom_ms: float = 0.0
    # byte-rate autoscale seam: sustained fleet-wide thin occupancy
    # (live streams per active lane below the low watermark for
    # autoscale_hysteresis_ticks straight) gracefully drains one shard
    # out of the pod (live row moves, engine released); sustained
    # pressure above the high watermark re-admits one.  Hysteresis
    # mirrors the rung/bucket ladders: the watermark gap is the dead
    # zone a sawtooth cannot thrash across, and every scale event is
    # recompile-free (surviving shards' (rung, bucket) programs are
    # already warmed).  Scheduled seam only.
    autoscale_enable: bool = False
    autoscale_low_watermark: float = 0.25
    autoscale_high_watermark: float = 0.75
    autoscale_hysteresis_ticks: int = 8
    # the pod never scales below this many active shards
    autoscale_min_shards: int = 1
    # byte-rate EWMA floor (bytes/tick) above which a stream counts as
    # LIVE for occupancy: the EWMA decays toward zero but never
    # reaches it, so a zero floor would count every stream ever seen
    # as live forever
    autoscale_rate_floor: float = 256.0
    # pipelined publish seam: publish revolution N-1's chain output while
    # revolution N computes on the device (one revolution of bounded
    # staleness; the publish never waits on device compute).  Off by
    # default — the reference publishes synchronously.
    pipelined_publish: bool = False
    # bound on the pipelined collect's device->host fetch, mirroring the
    # reference's bounded grab (every wait in its SDK carries a timeout,
    # 2000 ms default — sl_lidar_driver.h:332).  On expiry the revolution
    # is re-stashed and the fault surfaces to the FSM like any transient
    # device error.  0/None = unbounded.
    collect_timeout_s: float | None = None

    def validate(self) -> None:
        if self.qos_reliability not in VALID_QOS:
            raise ValueError(f"qos_reliability must be one of {VALID_QOS}")
        if self.serial_baudrate <= 0:
            raise ValueError("serial_baudrate must be positive")
        if not (0 < self.tcp_port <= 0xFFFF) or not (0 < self.udp_port <= 0xFFFF):
            raise ValueError("tcp_port/udp_port must be within [1, 65535]")
        if self.max_distance < 0:
            raise ValueError("max_distance must be >= 0 (0 = hardware limit)")
        if not (0 <= self.range_clip_min_m < self.range_clip_max_m):
            raise ValueError(
                "range clip must satisfy 0 <= range_clip_min_m < "
                "range_clip_max_m"
            )
        if self.intensity_min < 0:
            raise ValueError("intensity_min must be >= 0")
        if self.filter_backend not in VALID_BACKENDS:
            raise ValueError(f"filter_backend must be one of {VALID_BACKENDS}")
        if self.channel_type not in VALID_CHANNELS:
            raise ValueError(f"channel_type must be one of {VALID_CHANNELS}")
        if not (0 <= self.rpm <= 1200):
            # same bound the dynamic-param path enforces (src/rplidar_node.cpp:713)
            raise ValueError("rpm must be within [0, 1200]")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.filter_window < 1:
            raise ValueError("filter_window must be >= 1")
        bad = set(self.filter_chain) - set(VALID_FILTER_STAGES)
        if bad:
            raise ValueError(
                f"unknown filter_chain stages {sorted(bad)}; valid: {VALID_FILTER_STAGES}"
            )
        if self.voxel_grid_size < 1 or self.voxel_cell_m <= 0:
            raise ValueError("invalid voxel grid configuration")
        if self.median_backend not in (
            "auto", "xla", "pallas", "inc", "inc_xla", "inc_pallas"
        ):
            raise ValueError(
                "median_backend must be 'auto', 'xla', 'pallas', 'inc', "
                "'inc_xla' or 'inc_pallas'"
            )
        if self.resample_backend not in ("auto", "scatter", "dense"):
            raise ValueError(
                "resample_backend must be 'auto', 'scatter' or 'dense'"
            )
        if self.voxel_backend not in ("auto", "scatter", "matmul"):
            raise ValueError(
                "voxel_backend must be 'auto', 'scatter' or 'matmul'"
            )
        if self.collect_timeout_s is not None and self.collect_timeout_s < 0:
            raise ValueError("collect_timeout_s must be >= 0 (or None)")
        if self.health_window_ticks < 1:
            raise ValueError("health_window_ticks must be >= 1")
        if not (0.0 < self.health_corrupt_ratio <= 1.0):
            raise ValueError("health_corrupt_ratio must be within (0, 1]")
        if self.health_starvation_ticks < 1:
            raise ValueError("health_starvation_ticks must be >= 1")
        if self.health_suspect_ticks < 1:
            raise ValueError("health_suspect_ticks must be >= 1")
        if self.health_probation_ticks < 1:
            raise ValueError("health_probation_ticks must be >= 1")
        if self.health_backoff_base_s <= 0:
            raise ValueError("health_backoff_base_s must be positive")
        if self.health_backoff_max_s < self.health_backoff_base_s:
            raise ValueError(
                "health_backoff_max_s must be >= health_backoff_base_s "
                "(the cap bounds the exponential, it cannot undercut it)"
            )
        if not (0.0 <= self.health_backoff_jitter <= 1.0):
            raise ValueError("health_backoff_jitter must be within [0, 1]")
        if self.shard_count < 1:
            raise ValueError("shard_count must be >= 1")
        if self.shard_lanes < 0:
            raise ValueError("shard_lanes must be >= 0 (0 = auto)")
        if self.shard_starvation_ticks < 1:
            raise ValueError("shard_starvation_ticks must be >= 1")
        if self.shard_suspect_ticks < 1:
            raise ValueError("shard_suspect_ticks must be >= 1")
        if self.shard_probation_ticks < 1:
            raise ValueError("shard_probation_ticks must be >= 1")
        if self.shard_backoff_base_s <= 0:
            raise ValueError("shard_backoff_base_s must be positive")
        if self.shard_backoff_max_s < self.shard_backoff_base_s:
            raise ValueError(
                "shard_backoff_max_s must be >= shard_backoff_base_s "
                "(the cap bounds the exponential, it cannot undercut it)"
            )
        if not (0.0 <= self.shard_backoff_jitter <= 1.0):
            raise ValueError("shard_backoff_jitter must be within [0, 1]")
        if self.failover_snapshot_ticks < 0:
            raise ValueError(
                "failover_snapshot_ticks must be >= 0 (0 disables the "
                "periodic snapshot pulls)"
            )
        if self.ingest_backend not in ("auto", "host", "fused"):
            raise ValueError(
                "ingest_backend must be 'auto', 'host' or 'fused'"
            )
        if self.ingest_backend == "fused" and not self.filter_chain:
            raise ValueError(
                "ingest_backend='fused' requires filter_chain stages (the "
                "fused program ends in the filter step; raw passthrough "
                "has no device-side consumer)"
            )
        if self.fleet_ingest_backend not in ("auto", "host", "fused"):
            raise ValueError(
                "fleet_ingest_backend must be 'auto', 'host' or 'fused'"
            )
        if self.fleet_ingest_backend == "fused" and not self.filter_chain:
            raise ValueError(
                "fleet_ingest_backend='fused' requires filter_chain stages "
                "(the fleet-fused program ends in the per-stream filter "
                "steps; raw passthrough has no device-side consumer)"
            )
        if self.super_tick_max < 1:
            raise ValueError("super_tick_max must be >= 1 (1 disables)")
        if not (2 <= self.sweep_reconstruct_window <= 64):
            raise ValueError(
                "sweep_reconstruct_window must be within [2, 64] (a "
                "1-deep ring cannot reconstruct across ticks)"
            )
        d = self.deskew_profile_beams
        if d < 64 or d > 1024 or d & (d - 1):
            raise ValueError(
                "deskew_profile_beams must be a power of two in [64, 1024]"
            )
        if not (1 <= self.deskew_shift_window <= d // 8):
            raise ValueError(
                "deskew_shift_window must be within [1, "
                "deskew_profile_beams/8]"
            )
        if self.deskew_enable:
            if not self.filter_chain:
                raise ValueError(
                    "deskew_enable requires filter_chain stages (the "
                    "de-skewed revolutions feed the fused filter step)"
                )
            if "fused" not in (
                self.ingest_backend, self.fleet_ingest_backend
            ):
                raise ValueError(
                    "deskew_enable requires a fused ingest seam "
                    "(ingest_backend='fused' or fleet_ingest_backend="
                    "'fused'): the sub-sweep cache lives inside the "
                    "fused program's device state — the host decode "
                    "path has nowhere to keep it"
                )
        if self.deskew_backend not in ("auto", "xla", "pallas"):
            raise ValueError(
                "deskew_backend must be 'auto', 'xla' or 'pallas'"
            )
        if self.map_backend not in ("auto", "host", "fused"):
            raise ValueError(
                "map_backend must be 'auto', 'host' or 'fused'"
            )
        if self.fused_mapping_backend not in ("auto", "host", "fused"):
            raise ValueError(
                "fused_mapping_backend must be 'auto', 'host' or 'fused'"
            )
        if self.fused_mapping_backend == "fused":
            if not self.map_enable:
                raise ValueError(
                    "fused_mapping_backend='fused' requires map_enable "
                    "(there is no map to thread through the carry)"
                )
            if not self.deskew_enable:
                raise ValueError(
                    "fused_mapping_backend='fused' requires deskew_enable "
                    "(the in-program mapper consumes the reconstructed "
                    "sweep the de-skew stage emits every tick)"
                )
            if self.fleet_ingest_backend != "fused":
                # the map rides the FLEET engine's carry: the
                # single-stream fused seam satisfies the deskew check
                # above but never builds cfg.mapping, so an 'auto' (or
                # host) fleet seam here would silently run with no
                # in-program map anywhere
                raise ValueError(
                    "fused_mapping_backend='fused' requires "
                    "fleet_ingest_backend='fused' (spelled, not 'auto' "
                    "— the MapState rides the fleet ingest carry, and "
                    "only that engine builds the in-program mapper)"
                )
        if self.match_backend not in ("auto", "xla", "pallas"):
            raise ValueError(
                "match_backend must be 'auto', 'xla' or 'pallas'"
            )
        if self.map_enable and not self.filter_chain:
            raise ValueError(
                "map_enable requires filter_chain stages (the mapper "
                "consumes the chain's Cartesian endpoint output)"
            )
        if not (8 <= self.map_grid <= 1024) or self.map_grid % 4:
            raise ValueError(
                "map_grid must be within [8, 1024] and divide by 4 "
                "(the matcher's coarse pyramid factor)"
            )
        if self.map_cell_m <= 0:
            raise ValueError("map_cell_m must be positive")
        if self.map_match_window <= 0:
            raise ValueError("map_match_window must be positive")
        if self.map_log_odds_hit <= 0:
            raise ValueError("map_log_odds_hit must be positive")
        if self.map_log_odds_miss >= 0:
            raise ValueError("map_log_odds_miss must be negative")
        if self.map_log_odds_clamp < self.map_log_odds_hit:
            raise ValueError(
                "map_log_odds_clamp must be >= map_log_odds_hit (a clamp "
                "below one hit increment can never mark a cell occupied)"
            )
        if self.map_decay < 0 or self.map_decay > self.map_log_odds_clamp:
            raise ValueError(
                "map_decay must be within [0, map_log_odds_clamp] "
                "(0 disables; decaying past the clamp is meaningless)"
            )
        if self.loop_backend not in ("auto", "host", "fused"):
            raise ValueError(
                "loop_backend must be 'auto', 'host' or 'fused'"
            )
        if self.loop_enable and not self.map_enable:
            raise ValueError(
                "loop_enable requires map_enable (the loop-closure "
                "back-end closes the front-end mapper's loop — there is "
                "no trajectory to correct without it)"
            )
        if self.loop_submap_revs < 1:
            raise ValueError("loop_submap_revs must be >= 1")
        if not (2 <= self.loop_max_submaps <= 64):
            raise ValueError(
                "loop_max_submaps must be within [2, 64] (one submap to "
                "close against, one to close from; the cap sizes the "
                "pose graph)"
            )
        if self.loop_check_revs < 1:
            raise ValueError("loop_check_revs must be >= 1")
        if not (1 <= self.loop_candidates <= self.loop_max_submaps):
            raise ValueError(
                "loop_candidates must be within [1, loop_max_submaps]"
            )
        if self.loop_window_cells < 1:
            raise ValueError("loop_window_cells must be >= 1")
        if self.loop_theta_window < 1:
            raise ValueError("loop_theta_window must be >= 1")
        if self.loop_min_points < 1:
            raise ValueError("loop_min_points must be >= 1")
        if not (0 <= self.loop_accept_shift <= 20):
            raise ValueError("loop_accept_shift must be within [0, 20]")
        if not (0 <= self.loop_peak_shift <= 30):
            raise ValueError("loop_peak_shift must be within [0, 30]")
        if not (1 <= self.loop_weight <= 16):
            raise ValueError(
                "loop_weight must be within [1, 16] (the pose-graph "
                "weight clamp — and the int32 accumulator bound)"
            )
        if self.pose_graph_iters < 1:
            raise ValueError("pose_graph_iters must be >= 1")
        if self.map_tile_backend not in ("auto", "raw", "int8", "int4"):
            raise ValueError(
                "map_tile_backend must be 'auto', 'raw', 'int8' or "
                "'int4'"
            )
        if self.world_map_enable and not self.map_enable:
            raise ValueError(
                "world_map_enable requires map_enable (the shared "
                "world is fused from the mapper's finalized submaps)"
            )
        if self.world_tile_cells < 1:
            raise ValueError("world_tile_cells must be >= 1")
        if self.map_grid % self.world_tile_cells != 0:
            raise ValueError(
                "world_tile_cells must divide map_grid (partial edge "
                "tiles would give one cell two serving addresses)"
            )
        if not (2 <= self.world_max_submaps <= 64):
            raise ValueError(
                "world_max_submaps must be within [2, 64] (a reference "
                "plus at least one member; the cap sizes the "
                "inter-stream pose graph)"
            )
        if self.world_merge_revs < 1:
            raise ValueError("world_merge_revs must be >= 1")
        if self.world_publish_ticks < 1:
            raise ValueError("world_publish_ticks must be >= 1")
        rungs = tuple(self.sched_rungs)
        if not rungs or any(
            not isinstance(r, int) or isinstance(r, bool) for r in rungs
        ):
            raise ValueError("sched_rungs must be a non-empty tuple of ints")
        if rungs[0] != 1:
            raise ValueError(
                "sched_rungs must start at 1 (the per-tick program is "
                "the floor the scheduler can always fall to)"
            )
        if any(b <= a for a, b in zip(rungs, rungs[1:])):
            raise ValueError("sched_rungs must be strictly ascending")
        if rungs[-1] > 64:
            raise ValueError(
                "sched_rungs depths must be <= 64 (every rung is one "
                "more compiled super-step program per padding bucket)"
            )
        if self.sched_hysteresis_ticks < 1:
            raise ValueError("sched_hysteresis_ticks must be >= 1")
        if self.sched_deadline_ms < 0:
            raise ValueError(
                "sched_deadline_ms must be >= 0 (0 disables the "
                "deadline cap on the rung choice)"
            )
        if not (0.0 < self.sched_byte_rate_alpha <= 1.0):
            raise ValueError(
                "sched_byte_rate_alpha must be within (0, 1]"
            )
        if self.admission_max_backlog_ticks < 1:
            raise ValueError(
                "admission_max_backlog_ticks must be >= 1 (the per-"
                "stream backlog is BOUNDED by contract — unbounded "
                "growth is the failure mode this knob exists to forbid)"
            )
        if not isinstance(self.staging_double_buffer, bool):
            raise ValueError(
                "staging_double_buffer must be a bool (the ping/pong "
                "staging pair is on or off — there is no depth knob; "
                "two halves fully overlap one in-flight drain)"
            )
        buckets = tuple(self.bucket_rungs)
        if any(
            not isinstance(b, int) or isinstance(b, bool) for b in buckets
        ):
            raise ValueError("bucket_rungs must be a tuple of ints")
        if buckets:
            if min(buckets) < 1:
                raise ValueError("bucket_rungs buckets must be >= 1")
            if any(b <= a for a, b in zip(buckets, buckets[1:])):
                raise ValueError(
                    "bucket_rungs must be strictly ascending (the "
                    "bucket ladder steps between pre-warmed padding "
                    "buckets)"
                )
        if not (0.0 < self.occupancy_alpha <= 1.0):
            raise ValueError("occupancy_alpha must be within (0, 1]")
        if self.pod_hosts < 1:
            raise ValueError("pod_hosts must be >= 1")
        if self.shard_count % self.pod_hosts != 0:
            raise ValueError(
                f"pod_hosts must divide shard_count ({self.shard_count} "
                f"shards cannot split evenly across {self.pod_hosts} "
                "hosts — the two-level topology uses contiguous equal "
                "blocks)"
            )
        if self.steal_threshold_ticks < 0:
            raise ValueError(
                "steal_threshold_ticks must be >= 0 (0 disables "
                "work stealing)"
            )
        if self.steal_headroom_ms < 0:
            raise ValueError("steal_headroom_ms must be >= 0")
        if (
            self.sched_deadline_ms > 0
            and self.steal_headroom_ms >= self.sched_deadline_ms
        ):
            raise ValueError(
                "steal_headroom_ms must leave part of sched_deadline_ms "
                "as the taker's drain budget"
            )
        if not isinstance(self.autoscale_enable, bool):
            raise ValueError("autoscale_enable must be a bool")
        if not (
            0.0 < self.autoscale_low_watermark
            < self.autoscale_high_watermark <= 1.0
        ):
            raise ValueError(
                "autoscale watermarks must satisfy 0 < low < high <= 1 "
                "(the gap between them is the hysteresis dead zone)"
            )
        if self.autoscale_hysteresis_ticks < 1:
            raise ValueError("autoscale_hysteresis_ticks must be >= 1")
        if self.autoscale_min_shards < 1:
            raise ValueError("autoscale_min_shards must be >= 1")
        if self.autoscale_rate_floor <= 0:
            raise ValueError(
                "autoscale_rate_floor must be > 0 (the byte-rate EWMA "
                "decays toward zero but never reaches it, so a zero "
                "floor would count every stream ever seen as live "
                "forever)"
            )
        if not (1 <= self.pose_graph_max_constraints <= 256):
            raise ValueError(
                "pose_graph_max_constraints must be within [1, 256]"
            )

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DriverParams":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown parameters: {sorted(unknown)}")
        p = cls(**{k: v for k, v in d.items() if k in known})
        if isinstance(p.filter_chain, list):
            p.filter_chain = tuple(p.filter_chain)
        if isinstance(p.sched_rungs, list):
            p.sched_rungs = tuple(p.sched_rungs)
        if isinstance(p.bucket_rungs, list):
            p.bucket_rungs = tuple(p.bucket_rungs)
        p.validate()
        return p

    @classmethod
    def from_yaml(cls, path: str) -> "DriverParams":
        """Load a ROS-style YAML (node -> ros__parameters -> dict)."""
        import yaml  # baked into the image via other deps

        with open(path) as f:
            doc = yaml.safe_load(f)
        # unwrap ros2 param file nesting if present
        if isinstance(doc, dict) and len(doc) == 1:
            (inner,) = doc.values()
            if isinstance(inner, dict) and "ros__parameters" in inner:
                doc = inner["ros__parameters"]
        return cls.from_dict(doc or {})
