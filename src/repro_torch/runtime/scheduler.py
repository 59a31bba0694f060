"""Algorithm 1 (the paper's scheduler), event-driven — the PyTorch
counterpart of ``repro.runtime.scheduler``.

The scheduler drives a ``LambdaPool`` of simulated serverless workers
running REAL ADMM math on real shards; time and dollars come from the
numpy simulators (``pool``, ``reduce``, ``billing``).  Per round it
reproduces the paper's measurement set (idle / compute / delay per worker,
cold starts, respawns) in four barrier modes:

  * ``sync``         — full barrier (the paper's setting);
  * ``drop_slowest`` — K-of-W partial barrier with a stale ω table;
  * ``replicated``   — r workers per shard group, first responder wins;
  * ``async_``       — bounded-staleness async ADMM: the master updates z
                       every ``async_batch`` arrivals, at a fixed rho; a
                       worker whose z is more than ``staleness_bound``
                       versions old blocks until the next rebroadcast.

Engines: ``engine="loop"`` solves one worker at a time; ``"batched"``
solves all W as lanes of one FISTA (``problems.BatchedShardProblem``).
``async_`` paces itself per arrival, so it solves one worker at a time
whatever the engine.  Kernels: ``kernel="torch"`` is plain PyTorch
everywhere; ``"cuda"`` routes the batched engine's loss+grad through the
fused margin kernel and the master's l1 z-update through the fused
soft-threshold kernel (``repro_torch.kernels.ops``) — on a CPU tensor those
wrappers run their plain versions.  ω messages may be compressed
(``compress="topk"|"qsgd"``, ``optim.compression.OmegaCodec``): the codec
shrinks the modelled wire bytes and the master averages the lossy ω.

Precision follows the reference step by step: q is a float32 sum widened
to float64; the plain z-update's dual residual is a float32 product, the
fused one a host float64 product; rho is rounded through float32 by
``new_penalty``.

With a float64 problem, ``kernel="cuda"`` runs the margin kernel in
float32 under the float64 FISTA (the reference's cast: the shards are
staged in float32 once per fleet size, x is rounded per call, the float32
results are widened by the float64 steps around them), and the z-update
takes the plain float64 prox (``z_nnz`` stays -1), as the reference's
fused z-update runs only for a float32 ω̄.

``checkpoint_every`` and ``checkpoint_dir`` are accepted and not read, as
in the reference, whose scheduler never reads them (only its LM trainer
writes checkpoints).  Second-order problems are not ported yet and raise
``NotImplementedError`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import admm
from repro_torch.core.admm import AdmmOptions
from repro_torch.kernels import ops
from repro_torch.optim.compression import OmegaCodec, message_bytes
from repro_torch.problems.base import WorkerProblem
from repro_torch.runtime.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.runtime.billing import BillingConfig, BillingMeter
from repro_torch.runtime.pool import LambdaPool, PoolConfig
from repro_torch.runtime.reduce import TreeConfig, fanin_drain

_WAITS = "not ported yet; see ROADMAP.md, Queue 1, {!r}"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    n_workers: int = 16
    mode: str = "sync"            # sync | drop_slowest | replicated | async_
    engine: str = "loop"          # loop | batched
    # "torch": plain PyTorch everywhere; "cuda": the fused kernels
    kernel: str = "torch"
    drop_frac: float = 0.1        # drop_slowest: fraction not waited for
    replication: int = 2          # replicated: r
    async_batch: int = 4          # async_: S arrivals per z-update
    staleness_bound: int = 4      # async_: max z-version lag
    admm: AdmmOptions = AdmmOptions()
    pool: PoolConfig = PoolConfig()
    fanin: str = "flat"           # flat | tree
    tree: TreeConfig = TreeConfig()
    compress: str = "none"        # none | topk | qsgd
    topk_frac: float = 0.05       # topk: fraction of d kept per message
    qsgd_bits: int = 4            # qsgd: bits per coordinate
    # decision-vector size for the WIRE/cost model only (defaults to d)
    wire_d: Optional[int] = None
    respawn_before_deadline_s: float = 30.0
    # timing: use the round-median inner-iteration count per worker
    iter_smoothing: bool = False
    # accepted and not read (module docstring)
    checkpoint_every: int = 0     # rounds; 0 = off
    checkpoint_dir: Optional[str] = None
    billing: BillingConfig = BillingConfig()
    autoscale: AutoscaleConfig = AutoscaleConfig()


class RoundMetrics(NamedTuple):
    k: int
    sim_time: float              # sim clock at end of round
    r_norm: float
    s_norm: float
    rho: float
    t_comp: np.ndarray           # (W,) per-worker compute time
    t_comm: np.ndarray           # (W,)
    t_idle: np.ndarray           # (W,) comm + scheduler processing
    inner_iters: np.ndarray      # (W,)
    n_respawns: int
    slowest10: np.ndarray        # (W,) bool — in the slowest 10% this round
    round_wall_s: float = 0.0    # this round's wall time (rescale-safe)
    t_fanin_wait: float = 0.0    # master drain past the last omega arrival
    cost_usd: float = 0.0        # cumulative run cost (runtime.billing)
    n_workers: int = 0           # fleet size this round
    # nnz(z) after the round's soft-threshold, from the fused z-update
    # (kernel="cuda" on l1 workloads); -1 when the plain z-update ran
    z_nnz: int = -1


def _check_supported(problem, cfg: SchedulerConfig) -> None:
    if getattr(problem, "second_order", False):
        raise NotImplementedError(
            "second-order problems are " + _WAITS.format(
                "The second-order path"))
    if cfg.mode not in ("sync", "drop_slowest", "replicated", "async_"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.kernel not in ("torch", "cuda"):
        raise ValueError(f"kernel must be 'torch' or 'cuda', "
                         f"got {cfg.kernel!r}")
    if cfg.fanin not in ("flat", "tree"):
        raise ValueError(f"fanin must be 'flat' or 'tree', "
                         f"got {cfg.fanin!r}")
    if cfg.engine not in ("loop", "batched"):
        raise ValueError(f"engine must be 'loop' or 'batched', "
                         f"got {cfg.engine!r}")
    if cfg.engine == "batched" and not (
            callable(getattr(problem, "solve_all", None))
            and getattr(problem, "supports_batched", lambda: True)()):
        raise ValueError(
            f"engine='batched' needs the problem to implement the batched "
            f"contract (see repro_torch.problems.BatchedShardProblem); "
            f"{type(problem).__name__} does not")


class Scheduler:
    """Drives one experiment; its tensors live on the problem's device.
    ``pool`` injects a pre-built LambdaPool (the multi-tenant cluster hands
    every job a pool backed by one shared provider); ``start_time`` starts
    the event clock at a later instant (the cluster admits jobs
    mid-timeline).  The defaults give the single-experiment path."""

    def __init__(self, problem: WorkerProblem, cfg: SchedulerConfig, *,
                 pool: Optional[LambdaPool] = None,
                 start_time: float = 0.0):
        dt = getattr(problem, "dtype", torch.float32)
        _check_supported(problem, cfg)
        self.problem = problem
        self.cfg = cfg
        self.device = getattr(problem, "device", torch.device("cpu"))
        self.pool = pool if pool is not None else LambdaPool(cfg.pool)
        W, d = cfg.n_workers, problem.n_features
        # replicated mode: W physical slots host W/r LOGICAL workers; the
        # r replicas of a logical worker solve the same shard, so first-
        # responder-wins is exact under any r-1 stragglers or failures
        self.repl = cfg.replication if cfg.mode == "replicated" else 1
        if W % self.repl:
            raise ValueError("replicated mode needs r | W")
        self.n_logical = W // self.repl
        WL = self.n_logical
        self.x = torch.zeros((WL, d), dtype=dt, device=self.device)
        self.u = torch.zeros((WL, d), dtype=dt, device=self.device)
        self.z = torch.zeros((d,), dtype=dt, device=self.device)
        self.z_prev = torch.zeros((d,), dtype=dt, device=self.device)
        self.omega_table = torch.zeros((WL, d), dtype=dt, device=self.device)
        self.q_table = np.zeros((WL,), np.float64)
        self.rho = cfg.admm.rho0
        self.k = 0
        self.sim_time = 0.0
        self.history: List[RoundMetrics] = []
        self.n_respawns = 0
        self._engine_batched = cfg.engine == "batched"
        self._kernel_cuda = cfg.kernel == "cuda"
        self._z_nnz = -1
        # the paper sends (q, ω), d+1 f32 dense; the codec shrinks it (and
        # lossy-codes the ω the master sees) when compression is on
        self.codec = OmegaCodec(cfg.compress, d, topk_frac=cfg.topk_frac,
                                qsgd_bits=cfg.qsgd_bits)
        self.wire_d = cfg.wire_d or d
        self.msg_bytes = message_bytes(cfg.compress, self.wire_d,
                                       topk_frac=cfg.topk_frac,
                                       qsgd_bits=cfg.qsgd_bits)
        self.meter = BillingMeter(cfg.billing)
        self._billed_spawns = 0
        self.autoscaler: Optional[Autoscaler] = None
        self.pool.spawn_bulk(list(range(W)), at=start_time)
        self.sim_time = max(w.ready_at for w in self.pool.workers.values())
        self.cold_starts = {w.wid: w.cold_start_s
                            for w in self.pool.workers.values()}
        self._bill_spawns()
        # the early workers idle (billed) until the whole fleet is up,
        # and the coordinator runs from the job's admission instant
        for w in self.pool.workers.values():
            self.meter.record_duration(self.sim_time - w.ready_at)
        self.meter.record_master(self.sim_time - start_time)

    # -- billing --------------------------------------------------------
    def _bill_spawns(self):
        """Meter invocation starts (and, optionally, their init time)."""
        log = self.pool.spawn_log
        new = log[self._billed_spawns:]
        if new:
            self.meter.record_requests(len(new))
            if self.cfg.billing.bill_cold_init:
                self.meter.record_duration(sum(s for s, _ in new))
            self._billed_spawns = len(log)

    def _logical(self, wid: int) -> int:
        return wid // self.repl

    # ------------------------------------------------------------------
    def _maybe_respawn(self, wid: int) -> float:
        """Returns extra delay if slot wid had to be respawned this round."""
        w = self.pool.workers[wid]
        lifetime_hit = (self.sim_time > w.deadline
                        - self.cfg.respawn_before_deadline_s)
        # the failure roll is only drawn when the lifetime check passes
        # (the reference's RNG draw order)
        failed = not lifetime_hit and self.pool.roll_failure()
        if not (lifetime_hit or failed):
            return 0.0
        if failed:
            # a crashed invocation's sandbox is torn down, not kept warm
            self.pool.crash(wid)
        self.pool.spawn_bulk([wid], at=self.sim_time)
        self.n_respawns += 1
        return self.pool.workers[wid].cold_start_s

    def _worker_pass(self, wid: int) -> Tuple[torch.Tensor, float, int,
                                              float]:
        """One Algorithm-2 body for physical slot wid: returns (omega, q,
        inner_iters, extra_delay).  Replicas of a logical worker share one
        result."""
        lw = self._logical(wid)
        extra = self._maybe_respawn(wid)
        if lw not in self._round_results:
            r = self.x[lw] - self.z
            u_new = self.u[lw] + r
            q = float(torch.dot(r, r))
            x_new, iters = self.problem.solve(
                lw, self.n_logical, self.x[lw], self.z, u_new, self.rho)
            omega = self.codec.encode(lw, x_new + u_new)
            self._round_results[lw] = (omega, q, iters, x_new, u_new)
        omega, q, iters, _, _ = self._round_results[lw]
        return omega, q, iters, extra

    def _commit_xu(self, lw: int):
        _, _, _, x_new, u_new = self._round_results[lw]
        self.x[lw] = x_new
        self.u[lw] = u_new

    def _all_worker_passes(self) -> Tuple[np.ndarray, np.ndarray,
                                          torch.Tensor, np.ndarray]:
        """The batched engine's worker phase: every Algorithm-2 body as
        lanes of one FISTA (``problem.solve_all``).  The respawn checks run
        first, in wid order, so the pool RNG draws what the loop engine
        draws.  Returns (q (WL,), inner_iters (WL,), ω (WL, d), extras
        (W,)); the new (x, u) wait on ``self._batched_xu``."""
        W = self.cfg.n_workers
        extras = np.zeros(W)
        for wid in range(W):
            extras[wid] = self._maybe_respawn(wid)
        r = self.x - self.z[None, :]
        u_new = self.u + r
        q = torch.sum(r * r, dim=-1).cpu().numpy().astype(np.float64)
        if self._kernel_cuda:
            xs_new, iters = self.problem.solve_all(self.x, u_new, self.z,
                                                   self.rho, kernel="cuda")
        else:
            xs_new, iters = self.problem.solve_all(self.x, u_new, self.z,
                                                   self.rho)
        omegas = xs_new + u_new
        if self.codec.method != "none":
            # the codec is stateful per logical slot, so compression
            # encodes slot by slot, as the reference does
            omegas = torch.stack([self.codec.encode(lw, omegas[lw])
                                  for lw in range(self.n_logical)])
        self._batched_xu = (xs_new, u_new)
        return q, np.asarray(iters, np.int64), omegas, extras

    def _master_z_update(self, omega_bar: torch.Tensor, q_sum: float,
                         n_eff: int, adapt_rho: bool = True):
        r_norm = float(np.sqrt(q_sum))
        # dual residual in Boyd's consensus form s = rho*sqrt(W)*||dz||
        lam = getattr(self.problem, "h_l1_lam", None)
        if (self._kernel_cuda and lam is not None
                and omega_bar.dtype == torch.float32):
            # fused: z = S(ω̄; lam/(W·rho)), ||dz||² and nnz(z) in one pass
            thr = float(lam) / (n_eff * self.rho)
            z_new, ssq, nnz = ops.fused_z_update(omega_bar, self.z, thr)
            s_norm = float(self.rho * np.sqrt(float(ssq)) * np.sqrt(n_eff))
            self._z_nnz = int(nnz)
        else:
            z_new = self.problem.prox_h(omega_bar, 1.0 / (n_eff * self.rho))
            dz = torch.linalg.vector_norm(z_new - self.z)
            s_norm = float((self.rho * dz) * float(np.sqrt(n_eff)))
            self._z_nnz = -1
        self.z_prev, self.z = self.z, z_new
        rho_old = self.rho
        if adapt_rho:
            self.rho = float(admm.new_penalty(self.rho, r_norm, s_norm,
                                              self.cfg.admm))
        if self.rho != rho_old:
            # workers rescale their scaled duals u = y/rho (Boyd §3.4.1)
            self.u = self.u * (rho_old / self.rho)
        return r_norm, s_norm

    # ------------------------------------------------------------------
    def run_round(self) -> RoundMetrics:
        """One synchronous-family round (sync / drop_slowest / replicated)."""
        cfg = self.cfg
        W = cfg.n_workers
        t_comp = np.zeros(W)
        t_comm = np.zeros(W)
        inner = np.zeros(W, np.int64)
        round_start = self.sim_time
        self._round_results: Dict[int, Tuple] = {}
        codec_snap = self.codec.snapshot()

        batched = self._engine_batched
        fresh: Dict[int, Tuple[torch.Tensor, float]] = {}
        extras = np.zeros(W)
        if batched:
            q_all, iters_all, omegas, extras = self._all_worker_passes()
            for wid in range(W):
                inner[wid] = iters_all[self._logical(wid)]
        else:
            for wid in range(W):
                omega, q, it, extra = self._worker_pass(wid)
                inner[wid] = it
                extras[wid] = extra
                fresh[wid] = (omega, q)

        timing_iters = inner.copy()
        if cfg.iter_smoothing:
            timing_iters[:] = max(int(np.median(inner)), 1)
        arrivals = []
        # z is broadcast dense (only the ω uplink would be compressed)
        rx = self.pool.comm_time(4 * self.wire_d)
        tx = self.pool.comm_time(self.msg_bytes)
        for wid in range(W):
            lw = self._logical(wid)
            tc = self.pool.compute_time(
                self.pool.workers[wid], int(timing_iters[wid]),
                self.problem.n_samples(lw, self.n_logical))
            t_comp[wid] = tc
            t_comm[wid] = rx + tx                      # rx z + tx ω
            arrivals.append((round_start + extras[wid] + rx + tc + tx,
                             wid))

        # -- which messages does the master wait for? -----------------------
        if cfg.mode == "drop_slowest":
            n_wait = W - int(cfg.drop_frac * W)
            waited = sorted(arrivals)[:n_wait]
        elif cfg.mode == "replicated":
            # first responder per group (replicas are exact copies)
            waited, seen = [], set()
            for t, wid in sorted(arrivals):
                g = self._logical(wid)
                if g not in seen:
                    seen.add(g)
                    waited.append((t, wid))
        else:
            waited = sorted(arrivals)

        # stale-cache ω table: unwaited slots keep their previous ω; local
        # x/u always advance
        waited_lws = {self._logical(wid) for _, wid in waited}
        self.codec.rollback_except(codec_snap, waited_lws)
        if batched:
            idx = np.fromiter(sorted(waited_lws), np.int64)
            tidx = torch.as_tensor(idx, device=self.device)
            self.omega_table[tidx] = omegas[tidx]
            self.q_table[idx] = q_all[idx]
            self.x, self.u = self._batched_xu
        else:
            for _, wid in waited:
                om, q = fresh[wid]
                lw = self._logical(wid)
                self.omega_table[lw] = om
                self.q_table[lw] = q
            for lw in self._round_results:
                self._commit_xu(lw)

        # -- scheduler fan-in timing (flat router vs the tree) --------------
        master_done = fanin_drain(waited, cfg.fanin, self.pool, cfg.tree,
                                  self.msg_bytes, W)

        omega_bar = torch.mean(self.omega_table, dim=0)
        q_sum = float(self.q_table.sum())
        r_norm, s_norm = self._master_z_update(omega_bar, q_sum,
                                               self.n_logical)

        bcast = self.pool.comm_time(4 * self.wire_d)
        self.sim_time = master_done + bcast
        round_wall = self.sim_time - round_start
        t_idle = round_wall - t_comp
        self.k += 1

        # the bill: every worker holds its memory for the whole round, every
        # ω uplink + z downlink crosses the boundary, the coordinator runs
        # throughout; respawn init spans are carved out of the workers' time
        self._bill_spawns()
        self.meter.record_duration(round_wall * W - float(extras.sum()))
        self.meter.record_master(round_wall)
        self.meter.record_bytes(W * (self.msg_bytes + 4 * self.wire_d))

        thresh = np.quantile([t for t, _ in arrivals], 0.9)
        m = RoundMetrics(
            k=self.k, sim_time=self.sim_time, r_norm=r_norm, s_norm=s_norm,
            rho=self.rho, t_comp=t_comp, t_comm=t_comm, t_idle=t_idle,
            inner_iters=inner, n_respawns=self.n_respawns,
            slowest10=np.array([t >= thresh for t, _ in arrivals]),
            round_wall_s=round_wall,
            t_fanin_wait=master_done - max(t for t, _ in waited),
            cost_usd=self.meter.total_usd(), n_workers=W,
            z_nnz=self._z_nnz)
        self.history.append(m)
        return m

    # ------------------------------------------------------------------
    def run_async(self, max_updates: int,
                  on_round: Optional[Callable] = None) -> List[RoundMetrics]:
        """Bounded-staleness async ADMM: the master updates z every
        ``async_batch`` arrivals; a worker more than ``staleness_bound``
        z-versions behind blocks until the next update.  ``on_round`` fires
        once per z-update.  Arrivals pop from a heap of (time, wid, q), so
        ties go to the lower wid; the pool's RNG is drawn inside each
        launch, in launch order, as the reference draws it."""
        cfg = self.cfg
        W = cfg.n_workers
        z_version = 0
        worker_version = np.zeros(W, np.int64)
        pending: List[Tuple[float, int, float]] = []
        since_update = 0

        def launch(wid: int, at: float):
            lw = self._logical(wid)
            self._round_results = {}
            omega, q, it, extra = self._worker_pass(wid)
            self._commit_xu(lw)
            tc = self.pool.compute_time(
                self.pool.workers[wid], it,
                self.problem.n_samples(lw, self.n_logical))
            rx = self.pool.comm_time(4 * self.wire_d)   # dense z downlink
            tx = self.pool.comm_time(self.msg_bytes)    # compressed ω up
            arrive = at + extra + rx + tc + tx
            heapq.heappush(pending, (arrive, wid, float(q)))
            self._async_omega[wid] = omega
            self._async_tcomp[wid] = tc
            self._async_iters[wid] = it
            # one invocation: billed for its active span and its wire
            # bytes; a respawn's init (extra) is _bill_spawns' to bill
            self.meter.record_duration(arrive - at - extra)
            self.meter.record_bytes(self.msg_bytes + 4 * self.wire_d)

        self._async_omega: Dict[int, torch.Tensor] = {}
        self._async_tcomp: Dict[int, float] = {}
        self._async_iters: Dict[int, int] = {}
        blocked: List[int] = []
        master_billed_to = self.sim_time

        for wid in range(W):
            launch(wid, self.pool.workers[wid].ready_at)

        updates = 0
        while updates < max_updates and pending:
            arrive, wid, q = heapq.heappop(pending)
            self.sim_time = max(self.sim_time, arrive)
            # a copy into the table: no row aliases a worker's ω
            self.omega_table[wid] = self._async_omega[wid]
            self.q_table[wid] = q
            since_update += 1

            if since_update >= cfg.async_batch:
                since_update = 0
                omega_bar = torch.mean(self.omega_table, dim=0)
                # a FIXED penalty: the bounded-staleness analyses assume a
                # constant rho, and residual balancing would act on a
                # stale r against a per-micro-update s
                r_norm, s_norm = self._master_z_update(
                    omega_bar, float(self.q_table.sum()), W,
                    adapt_rho=False)
                z_version += 1
                updates += 1
                self.k += 1
                self._bill_spawns()
                self.meter.record_master(self.sim_time - master_billed_to)
                master_billed_to = self.sim_time
                t_comp = np.array([self._async_tcomp.get(i, 0.0)
                                   for i in range(W)])
                m = RoundMetrics(
                    k=self.k, sim_time=self.sim_time, r_norm=r_norm,
                    s_norm=s_norm, rho=self.rho, t_comp=t_comp,
                    t_comm=np.zeros(W), t_idle=np.zeros(W),
                    inner_iters=np.array([self._async_iters.get(i, 0)
                                          for i in range(W)]),
                    n_respawns=self.n_respawns,
                    slowest10=np.zeros(W, bool),
                    cost_usd=self.meter.total_usd(), n_workers=W,
                    z_nnz=self._z_nnz)
                self.history.append(m)
                if on_round:
                    on_round(m)
                # the z-update is the rebroadcast: every blocked worker
                # takes the fresh z and relaunches at the current version
                for bw in blocked:
                    worker_version[bw] = z_version
                    launch(bw, self.sim_time)
                blocked.clear()

            # relaunch this worker against the current z
            if z_version - worker_version[wid] > cfg.staleness_bound:
                blocked.append(wid)
            else:
                worker_version[wid] = z_version
                launch(wid, max(arrive, self.sim_time))
        return self.history

    # ------------------------------------------------------------------
    def step(self, on_round: Optional[Callable] = None
             ) -> Tuple[RoundMetrics, bool]:
        """Drive ONE synchronous-family round and what hangs off it — the
        callback, the convergence check, the autoscaler.  Returns
        (metrics, done)."""
        cfg = self.cfg
        if cfg.mode == "async_":
            raise ValueError("step() drives the synchronous-family modes; "
                             "async_ paces itself per arrival (run_async)")
        if cfg.autoscale.policy != "off" and self.autoscaler is None:
            self.autoscaler = Autoscaler(cfg.autoscale, quantum=self.repl)
        m = self.run_round()
        if on_round:
            on_round(m)
        if (m.r_norm <= cfg.admm.eps_primal
                and m.s_norm <= cfg.admm.eps_dual):
            return m, True
        if self.autoscaler is not None:
            self.autoscaler.observe(
                round_wall_s=m.round_wall_s,
                t_comp_mean=float(m.t_comp.mean()),
                t_fanin_wait=m.t_fanin_wait)
            new_w = self.autoscaler.decide(self.cfg.n_workers)
            if new_w is not None:
                self.rescale(new_w)
        return m, False

    def solve(self, *, max_rounds: Optional[int] = None,
              on_round: Optional[Callable] = None) -> torch.Tensor:
        K = max_rounds or self.cfg.admm.max_iters
        if self.cfg.mode == "async_":
            self.run_async(K, on_round=on_round)
            return self.z
        for _ in range(K):
            _, done = self.step(on_round)
            if done:
                break
        return self.z

    # -- elastic rescale ----------------------------------------------------
    def rescale(self, new_w: int):
        """Change the worker count mid-run.  Data re-sharding is free (pure
        regeneration); x/u are re-seeded from the consensus z."""
        d = self.problem.n_features
        if new_w % self.repl:
            raise ValueError("new worker count must keep r | W")
        old_w = self.cfg.n_workers
        self.cfg = dataclasses.replace(self.cfg, n_workers=new_w)
        self.n_logical = new_w // self.repl
        WL = self.n_logical
        self.x = self.z.expand(WL, d).clone()
        self.u = torch.zeros_like(self.x)
        self.omega_table = self.z.expand(WL, d).clone()
        self.q_table = np.zeros((WL,), np.float64)
        self.codec.reset()
        # shrink: retired slots hand their sandboxes to the keep-alive pool
        if new_w < old_w:
            self.pool.retire(list(range(new_w, old_w)), at=self.sim_time)
        t0 = self.sim_time
        self.pool.spawn_bulk(list(range(new_w)), at=self.sim_time)
        self.sim_time = max(w.ready_at for w in self.pool.workers.values())
        self._bill_spawns()
        for w in self.pool.workers.values():
            self.meter.record_duration(self.sim_time - w.ready_at)
        self.meter.record_master(self.sim_time - t0)
