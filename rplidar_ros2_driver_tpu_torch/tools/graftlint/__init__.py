"""graftlint — repo-native static analysis of the PyTorch package.

The port's correctness rests on invariants no test run sees whole: its
device steps must only queue work (no hidden host sync), its fixed-point
zones must stay byte-equal to the JAX package (no float reduction, no
unpoliced cast, no int32 overflow), a CUDA tensor must launch its kernel
or raise (no fallback), its threads must hold their declared locks, and
its marked read paths must never touch the card.  graftlint checks them
by AST, without importing the code it lints.

Rules (each fires with a file:line finding; suppression is
``# graftlint: disable=GLxxx — reason`` on the offending or preceding
line, and ``# graftlint: policed — reason`` blesses a float→int cast):

  GL001  host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
         ``torch.cuda.synchronize``, ``int``/``float``/``bool`` of a
         tensor argument) reachable from a declared device step, outside
         ``with guards.declared_sync():``
  GL002  Python ``if``/``while`` on tensor values in that code
  GL003  a carried state a device step updates in place, read through an
         alias taken before the call
  GL004  bit-exact zones: float reductions (``sum``/``mean``/``matmul``/
         ``einsum``/``cumsum``) and unpoliced float→int casts
  GL005  bare Python float scalars mixed into int tensors in the zones
  GL006  non-frozen ``*Config`` dataclasses
  GL007  allocations (``torch.empty``/``zeros``/``tensor``/...,
         ``np.zeros``/...) inside regions marked ``# graftlint: hot-loop``
  GL008  structural consistency: every ``DriverParams`` field present in
         ``param/rplidar.yaml`` and validated in ``core/config.py``; every
         declared device step reachable from a ``precompile()``
  GL009  unbounded retry loops: ``while True`` sleeping a constant
         delay with no attempt cap, deadline, or computed backoff
  GL010  the no-fallback rule: compiled bindings are called only from
         ``ops/*_kernels.py`` wrappers whose CPU branch calls the
         ``*_plain`` twin and whose other non-CUDA branch raises; no
         ``except`` handler on a launching path falls back to a plain twin
  GL011  fixed-point overflow prover: an interval abstract interpreter
         over the zones flags any product / left shift / sum-reduce /
         accumulating scatter not provably inside int32
  GL012  lock-discipline race detector over the declared lock map, and
         lock-order cycles
  GL013  zero-dispatch read-path prover from ``# graftlint: read-path``
         roots (``torch.*`` tensor calls, transfers, kernel wrappers,
         engine ``submit_*``)

The declarations (zones, device steps, hot files, naming-convention
dtype patterns, value bounds, lock maps, exemptions) live in
``graftlint.toml`` beside this file; findings must reconcile against
``graftlint.baseline.json`` next to it (every entry needs a
justification; new and stale entries both fail).

CLI: ``python -m rplidar_ros2_driver_tpu_torch.tools.graftlint`` with
``--json`` / ``--json-out PATH``, ``--github``, ``--jobs N|auto``
and ``--explain GLxxx``.
"""

from rplidar_ros2_driver_tpu_torch.tools.graftlint.config import LintConfig, load_config
from rplidar_ros2_driver_tpu_torch.tools.graftlint.model import Finding, RepoIndex
from rplidar_ros2_driver_tpu_torch.tools.graftlint.runner import run_lint

__all__ = ["Finding", "LintConfig", "RepoIndex", "load_config", "run_lint"]
