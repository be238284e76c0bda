"""Fixed-point 2-D pose-graph relaxation — the SLAM back-end's solver.

The PyTorch counterpart of the JAX package's ``ops/pose_graph.py``.  The
loop-closure check (ops/loop_close.py) turns accepted submap matches into
inter-pose constraints; this module relaxes the graph on the device in the
matcher's int32 fixed point:

  * a NODE is a pose (tx_sub, ty_sub, theta_idx) int32 — translation in
    SUB-subcell units, heading an index into the ``theta_divisions``
    rotation table (ops/scan_match.rotation_table, 2^14 scale);
  * a CONSTRAINT row is (i, j, zx_sub, zy_sub, ztheta_steps, weight)
    int32 — "node j observed from node i at relative pose z"; weight 0
    is padding, so every fill level shares one dense plane.

Each of ``iters`` sweeps predicts every constraint's node-j pose from node
i through the integer rotation core, forms the weighted residual,
accumulates ± corrections per node with one integer ``scatter_add_``
(int32 addition is associative and commutative, so any order — a CUDA
atomic included — lands the same bits) and steps every node but the gauge
anchor (node 0) by the truncated half-mean correction.  Truncation toward
zero keeps a ±1-subcell residual from walking the graph.

The solver is batched over a leading stream axis: (S, M, 3) nodes and
(S, C, 6) constraint planes relax in one sweep loop for the whole fleet
(about 43 device operations a sweep, whatever S — host-bound on a card).
There is no kernel here: the JAX package has no Pallas kernel for it
either.

Arithmetic bounds (why nothing overflows int32) are the JAX package's:
translations clamp to ±t_limit_sub, z terms to ±2·t_limit_sub, so a node's
accumulator stays below 5·t_limit_sub·weight_max·max_constraints, which
:class:`PoseGraphConfig` validates < 2^31.  The NumPy twin
(ops/pose_graph_ref.py) is bit-exact.
"""

from __future__ import annotations

import dataclasses

import torch

from rplidar_ros2_driver_tpu_torch.ops.scan_match import rotate_rows, rotation_table

POSE_GRAPH_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Static solver configuration (the JAX package's, field for field).
    ``max_nodes`` / ``max_constraints`` are the dense padded plane sizes."""

    max_nodes: int
    max_constraints: int
    iters: int = 96
    theta_divisions: int = 720
    t_limit_sub: int = 4096     # ± translation clamp (subcells)
    weight_max: int = 16        # constraint weight clamp

    def __post_init__(self):
        if self.max_nodes < 1:
            raise ValueError("pose graph needs at least one node")
        if self.max_constraints < 1:
            raise ValueError("pose graph needs a constraint plane")
        if self.iters < 1:
            raise ValueError("pose_graph_iters must be >= 1")
        if self.theta_divisions < 4:
            raise ValueError("theta_divisions must be >= 4")
        if self.t_limit_sub < 1:
            raise ValueError("t_limit_sub must be positive")
        if self.weight_max < 1:
            raise ValueError("weight_max must be >= 1")
        # int32 accumulator bound: every node sums <= max_constraints
        # weighted residuals of < 5·t_limit each
        if 5 * self.t_limit_sub * self.weight_max * self.max_constraints >= 2**31:
            raise ValueError(
                "pose-graph accumulator can overflow int32: shrink "
                "max_constraints, weight_max or t_limit_sub "
                f"(5*{self.t_limit_sub}*{self.weight_max}"
                f"*{self.max_constraints} >= 2^31)"
            )


_TABLES: dict = {}


def device_table(div: int, device) -> torch.Tensor:
    """The (div, 2) int32 rotation table on ``device``, uploaded once per
    (div, device) — its own cache, apart from the matcher's, whose key
    also carries the θ window."""
    key = (div, torch.device(device))
    got = _TABLES.get(key)
    if got is None:
        got = _TABLES[key] = torch.from_numpy(rotation_table(div)).to(device)
    return got


# ---------------------------------------------------------------------------
# exact SE(2) fixed-point composition (each has a literal numpy twin in
# ops/pose_graph_ref.py); poses are (..., 3) int32 tensors
# ---------------------------------------------------------------------------


def wrap_steps(d, div: int):
    """Wrap a rotation-table step delta into [-div/2, div/2)."""
    half = div // 2
    return torch.remainder(d + half, div) - half


def _trig(table: torch.Tensor, th: torch.Tensor):
    """(cos, sin) rows of ``table`` at ``th``, any shape, 0-d included: one
    gather on the device (indexing by a 0-d tensor would read it on the
    host).  A negative step in [-div, 0) wraps, as ``jnp.take`` does."""
    idx = torch.remainder(th.reshape(-1).long(), table.shape[0])
    rows = table.index_select(0, idx)
    return rows[:, 0].reshape(th.shape), rows[:, 1].reshape(th.shape)


def pose_compose(p, z, table, div: int):
    """p ∘ z: apply relative transform ``z`` in ``p``'s frame (t = t_p +
    R(θ_p)·z_t, θ = θ_p + z_θ mod div); broadcasts over leading axes."""
    cos_q, sin_q = _trig(table, p[..., 2])
    rx, ry = rotate_rows(z[..., 0], z[..., 1], cos_q, sin_q)
    return torch.stack(
        [p[..., 0] + rx, p[..., 1] + ry, torch.remainder(p[..., 2] + z[..., 2], div)], dim=-1
    )


def pose_relative(a, b, table, div: int):
    """b ⊖ a: the transform from ``a`` to ``b`` in ``a``'s frame (z_t =
    R(-θ_a)·(t_b - t_a), z_θ = θ_b - θ_a mod div)."""
    cos_q, sin_q = _trig(table, a[..., 2])
    rx, ry = rotate_rows(b[..., 0] - a[..., 0], b[..., 1] - a[..., 1], cos_q, -sin_q)
    return torch.stack([rx, ry, torch.remainder(b[..., 2] - a[..., 2], div)], dim=-1)


def rel_inverse(z, table, div: int):
    """z⁻¹ of a relative transform: (−R(−θ_z)·t_z, −θ_z)."""
    inv_th = torch.remainder(-z[..., 2], div)
    cos_q, sin_q = _trig(table, inv_th)
    rx, ry = rotate_rows(z[..., 0], z[..., 1], cos_q, sin_q)
    return torch.stack([-rx, -ry, inv_th], dim=-1)


# ---------------------------------------------------------------------------
# the relaxation, batched over streams
# ---------------------------------------------------------------------------


def fleet_solve_pose_graph(nodes0: torch.Tensor, cons: torch.Tensor,
                           cfg: PoseGraphConfig) -> torch.Tensor:
    """Relax S graphs at once: ``nodes0`` (S, M, 3) int32 initial poses,
    ``cons`` (S, C, 6) int32 dense constraint planes (weight 0 = padding).
    Returns a new (S, M, 3) int32 tensor after ``cfg.iters`` sweeps —
    stream s bit-equal to the JAX package's ``solve_pose_graph`` of
    (nodes0[s], cons[s])."""
    s, m = nodes0.shape[0], cfg.max_nodes
    if tuple(nodes0.shape[1:]) != (m, 3) or cons.ndim != 3 or cons.shape[2] != 6:
        raise ValueError(
            f"expected (S, {m}, 3) nodes and (S, C, 6) constraints, got "
            f"{tuple(nodes0.shape)} and {tuple(cons.shape)}"
        )
    div, lim = cfg.theta_divisions, cfg.t_limit_sub
    table = device_table(div, nodes0.device)
    ci = cons[..., 0].clamp(0, m - 1).long()
    cj = cons[..., 1].clamp(0, m - 1).long()
    wgt = cons[..., 5].clamp(0, cfg.weight_max)                 # (S, C)
    # z clamp: the residual bound the config validated assumes it
    zx = cons[..., 2].clamp(-2 * lim, 2 * lim)
    zy = cons[..., 3].clamp(-2 * lim, 2 * lim)
    zth = cons[..., 4]
    # one scatter per sweep: node j gains +res and node i −res, and both
    # gain the weight in column 3 (the degree); (S, 2C) rows of 4 values
    c = cons.shape[1]
    gather_i = ci[..., None].expand(-1, -1, 3)
    gather_j = cj[..., None].expand(-1, -1, 3)
    scatter = torch.cat([cj, ci], dim=1)[..., None].expand(-1, -1, 4)
    sign = torch.ones((1, 2 * c, 4), dtype=torch.int32, device=cons.device)
    sign[:, c:, :3] = -1
    wgt2 = torch.cat([wgt, wgt], dim=1)
    movable = (torch.arange(m, device=nodes0.device) > 0)[None, :, None]

    nodes = nodes0.clone()
    for _ in range(cfg.iters):
        pi = torch.gather(nodes, 1, gather_i)                   # (S, C, 3)
        pj = torch.gather(nodes, 1, gather_j)
        cos_q, sin_q = _trig(table, pi[..., 2])
        rx, ry = rotate_rows(zx, zy, cos_q, sin_q)
        res = torch.stack([
            pi[..., 0] + rx - pj[..., 0],
            pi[..., 1] + ry - pj[..., 1],
            wrap_steps(pi[..., 2] + zth - pj[..., 2], div),
        ], dim=2) * wgt[..., None]
        vals = torch.cat([torch.cat([res, res], dim=1), wgt2[..., None]], dim=2) * sign
        acc = torch.zeros((s, m, 4), dtype=torch.int32, device=nodes.device)
        acc.scatter_add_(1, scatter, vals)
        den = 2 * acc[..., 3:].clamp_min(1)                     # damping 1/2
        # truncating (toward-zero) division: bias-free around zero
        corr = torch.sign(acc[..., :3]) * (acc[..., :3].abs() // den)
        nodes = torch.where(movable, nodes + corr, nodes)
        nodes = torch.stack([
            nodes[..., 0].clamp(-lim, lim),
            nodes[..., 1].clamp(-lim, lim),
            torch.remainder(nodes[..., 2], div),
        ], dim=2)
    return nodes


def solve_pose_graph(nodes0: torch.Tensor, cons: torch.Tensor,
                     cfg: PoseGraphConfig) -> torch.Tensor:
    """One graph: (M, 3) nodes and (C, 6) constraints -> (M, 3)."""
    return fleet_solve_pose_graph(nodes0[None], cons[None], cfg)[0]
