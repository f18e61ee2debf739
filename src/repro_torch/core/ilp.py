# Copied unchanged from repro/core/ilp.py (the JAX package), so the port imports nothing of it.
"""The paper's multi-objective ILP (§6, Eqs. 3-26) via scipy HiGHS ``milp``.

The paper states the full model is intractable at data-center scale and
never benchmarks it; here it serves as a *ground-truth oracle* on small
instances to validate GRMU and the baselines (tests/test_ilp.py) and to
measure optimality gaps (benchmarks/ilp_gap.py), and as the engine of the
rolling-horizon :class:`repro.core.policies.ILPPolicy`.

The encoding is parameterized over each GPU's
:class:`repro.core.mig.DeviceModel`: a VM's size ``g``, last legal start
``s`` and GI/GPU compatibility are resolved *per (VM, GPU)* through the
GPU's own profile table, so heterogeneous A30 + A100 + H100 fleets are
solved under each device's exact placement grammar.

Encoding notes
--------------
* Start-block legality (Fig. 1) is captured exactly by the paper's
  (beta_i, s_i) device: z_ijk = g_ijk * beta_i and z_ijk <= s_ijk
  reproduces each profile's legal start set — e.g. 3g.20gb: multiples of
  4 capped at 4 -> {0, 4}.  Every shipped ``DeviceModel`` satisfies this
  arithmetic grammar (starts = multiples of size capped at last_start);
  ``MigILP`` verifies it per (model, profile) and raises otherwise rather
  than silently mis-encode an exotic model.
* Eqs. 17-18 (GI/GPU compatibility) generalize from the paper's scalar
  h_i = H_jk characteristic to "the request resolves to a profile on the
  GPU's device model": a per-model profile id of -1 (or a model outside
  the VM's ``profile_ids``) forces y_ijk = 0 through its variable bound.
* The three objectives are scalarized lexicographically with weights
  W_accept >> W_hw >> W_mig (the paper's priority order).
* alpha uses one binary per unordered VM pair per GPU (Eqs. 12-13 pair up).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp
from scipy.sparse import csr_matrix

from ..sim.cluster import (VM, Cluster, derive_fleet,
                           resolve_profile_ids)
from .mig import DEFAULT_MODEL, DeviceModel, GPU

BIG_M = 64.0  # B: comfortably above any z (<=7) + g (<=8)


def _check_arithmetic_grammar(model: DeviceModel) -> None:
    """The (beta, s) device encodes starts as {g*b : g*b <= s}; verify the
    model's start sets really have that shape (all presets do)."""
    for p in model.profiles:
        implied = tuple(range(0, p.last_start + 1, p.size))
        if tuple(sorted(p.start_blocks)) != implied:
            raise ValueError(
                f"{model.name}/{p.name}: start blocks "
                f"{sorted(p.start_blocks)} are not multiples of size "
                f"{p.size} capped at {p.last_start}; the ILP's (beta, s) "
                "start-grammar device cannot encode this profile")


@dataclasses.dataclass
class ILPResult:
    status: int
    message: str
    accepted: Dict[int, Tuple[int, int, int]]  # vm_id -> (pm, gpu, start)
    rejected: List[int]
    objective_accept: float
    active_pms: int
    active_gpus: int
    migrations_pm: int
    migrations_gpu: int
    feasible: bool = False  # an integral incumbent was parsed

    @property
    def ok(self) -> bool:
        """Solved to (gap-)proven optimality — required of an *oracle*.
        A time-limited solve may still carry a feasible incumbent
        (``feasible``), which the rolling-horizon policy can apply."""
        return self.status == 0


class MigILP:
    """Builder for one placement round.

    Parameters mirror the paper's notation: ``vms`` = N (new + resident),
    ``pm_gpus`` = GPUs per PM (P_j), capacities C_j / R_j, previous
    allocation (x', y', z') for residents, per-VM weights a_i / delta_i and
    per-PM weights b_j.  ``gpu_models`` assigns each GPU its
    ``DeviceModel`` (default: the paper's homogeneous A100-40GB fleet);
    ``models`` pins the fleet ordering ``VM.profile_ids`` vectors index
    into (default: first-appearance order over ``gpu_models``).
    """

    # z-stability epsilon (see solve()): must satisfy
    # N_residents * (B_max - 1) * W_Z < w_hw so it can never trade
    # against a real objective unit; fine for oracle-scale instances.
    # Conversely, the no-shuffle guarantee only binds when the solve's
    # absolute gap slack (mip_rel_gap * objective) is below W_Z —
    # callers that rely on stable resident blocks (ILPPolicy) must keep
    # mip_rel_gap tight.
    W_Z = 1e-3

    def __init__(self, pm_gpus: Sequence[int],
                 cpu_capacity: float = 1e9, ram_capacity: float = 1e9,
                 w_accept: float = 1e4, w_hw: float = 1.0,
                 w_mig: float = 1e2,
                 gpu_models: Optional[Sequence[Sequence[DeviceModel]]] = None,
                 models: Optional[Sequence[DeviceModel]] = None):
        self.pm_gpus = list(pm_gpus)
        self.M = len(self.pm_gpus)
        self.cpu_capacity = cpu_capacity
        self.ram_capacity = ram_capacity
        self.w_accept, self.w_hw, self.w_mig = w_accept, w_hw, w_mig
        if gpu_models is None:
            gpu_models = [[DEFAULT_MODEL] * k for k in self.pm_gpus]
        if (len(gpu_models) != self.M
                or any(len(gpu_models[j]) != self.pm_gpus[j]
                       for j in range(self.M))):
            raise ValueError("gpu_models must match pm_gpus shape")
        self.gpu_models = [list(row) for row in gpu_models]
        if models is None:
            models = derive_fleet(
                [m for row in self.gpu_models for m in row])
        self.models = list(models)
        for m in self.models:
            _check_arithmetic_grammar(m)
        self._mindex = {m: i for i, m in enumerate(self.models)}
        for row in self.gpu_models:
            for m in row:
                if m not in self._mindex:
                    raise ValueError(
                        f"GPU model {m.name} not in fleet model list")
        self.vms: List[VM] = []
        self.delta: List[float] = []
        self.prev: Dict[int, Tuple[int, int, int]] = {}  # vm_id->(j,k,z)
        self.frozen: Dict[int, bool] = {}                # vm_id -> pinned
        self.must_place: Dict[int, bool] = {}

    @classmethod
    def from_cluster(cls, cluster: Cluster, **kw) -> "MigILP":
        """Mirror a :class:`~repro.sim.cluster.Cluster`'s geometry: per-PM
        GPU counts, per-GPU device models, fleet ordering and host
        CPU/RAM capacities (uniform capacities assumed, as in
        ``make_cluster``)."""
        pm_gpus = [len(h.gpus) for h in cluster.hosts]
        gpu_models = [[g.model for g in h.gpus] for h in cluster.hosts]
        kw.setdefault("cpu_capacity", float(cluster.hosts[0].cpu_capacity))
        kw.setdefault("ram_capacity", float(cluster.hosts[0].ram_capacity))
        return cls(pm_gpus, gpu_models=gpu_models, models=cluster.models,
                   **kw)

    def add_vm(self, vm: VM, resident_at: Optional[Tuple[int, int, int]]
               = None, delta: float = 1.0, frozen: bool = False,
               must_place: bool = False) -> None:
        """resident_at=(pm, gpu, start) marks x'/y'/z'; None = new arrival
        (delta forced to 0 per the paper).  ``frozen`` pins a resident to
        its previous placement (the rolling-horizon window boundary);
        ``must_place`` turns Eq. 8 into an equality for this VM so the
        solver cannot evict a running resident to make room.
        """
        if frozen and resident_at is None:
            raise ValueError("frozen requires resident_at")
        self.vms.append(vm)
        if resident_at is None:
            self.delta.append(0.0)
        else:
            self.delta.append(delta)
            self.prev[vm.vm_id] = resident_at
        self.frozen[vm.vm_id] = frozen
        self.must_place[vm.vm_id] = must_place or frozen

    # ------------------------------------------------------------------
    def solve(self, time_limit: float = 60.0,
              mip_rel_gap: float = 1e-9) -> ILPResult:
        """``mip_rel_gap`` trades proof-of-optimality time for precision:
        with the lexicographic weights (1e4 / 1e2 / 1) any gap below
        ~1e-6 of the objective still resolves every acceptance and
        active-hardware unit exactly on oracle-scale instances."""
        N, M = len(self.vms), self.M
        K = self.pm_gpus
        gpu_keys = [(j, k) for j in range(M) for k in range(K[j])]
        G = len(gpu_keys)
        gidx = {jk: t for t, jk in enumerate(gpu_keys)}
        pairs = list(itertools.combinations(range(N), 2))
        gpu_model = [self.gpu_models[j][k] for (j, k) in gpu_keys]
        gpu_mid = [self._mindex[m] for m in gpu_model]

        # ---- per-(VM, GPU) grammar from each GPU's DeviceModel ---------
        # g_it / s_it (Table 5's g_i / s_i resolved per device) and the
        # Eq. 17-18 compatibility bit.
        pids = np.array(
            [resolve_profile_ids(v, self.models, missing_ok=True)
             for v in self.vms],
            dtype=np.int32).reshape(N, len(self.models))
        g_it = np.zeros((N, G))
        s_it = np.zeros((N, G))
        compat = np.zeros((N, G), dtype=bool)
        for t in range(G):
            model = gpu_model[t]
            for i in range(N):
                pid = int(pids[i, gpu_mid[t]])
                if 0 <= pid < model.num_profiles:
                    p = model.profiles[pid]
                    g_it[i, t] = float(p.size)
                    s_it[i, t] = float(p.last_start)
                    compat[i, t] = True

        # ---- variable layout ------------------------------------------
        # x[i,j], y[i,t], z[i,t], alpha[p,t], beta[i], phi[j], gamma[t],
        # m[i,j], omega[i,t], d[i] (resident |z-change| on the same GPU)
        nx = N * M
        ny = N * G
        nz = N * G
        na = len(pairs) * G
        nb = N
        nphi = M
        ngam = G
        nm = N * M
        nom = N * G
        nd = N
        off_x = 0
        off_y = off_x + nx
        off_z = off_y + ny
        off_a = off_z + nz
        off_b = off_a + na
        off_phi = off_b + nb
        off_gam = off_phi + nphi
        off_m = off_gam + ngam
        off_om = off_m + nm
        off_d = off_om + nom
        nvar = off_d + nd

        def X(i, j): return off_x + i * M + j
        def Y(i, t): return off_y + i * G + t
        def Z(i, t): return off_z + i * G + t
        def A(p, t): return off_a + p * G + t
        def Bv(i): return off_b + i
        def PHI(j): return off_phi + j
        def GAM(t): return off_gam + t
        def Mv(i, j): return off_m + i * M + j
        def OM(i, t): return off_om + i * G + t
        def D(i): return off_d + i

        a_w = np.array([v.weight for v in self.vms], dtype=float)
        c_req = np.array([v.cpu for v in self.vms], dtype=float)
        r_req = np.array([v.ram for v in self.vms], dtype=float)
        delta = np.array(self.delta, dtype=float)

        rows, cols, vals, lbs, ubs = [], [], [], [], []
        row = 0

        def add(coefs: List[Tuple[int, float]], lb: float, ub: float):
            nonlocal row
            for c, v in coefs:
                rows.append(row), cols.append(c), vals.append(v)
            lbs.append(lb), ubs.append(ub)
            row += 1

        INF = np.inf
        # (6)/(7) CPU & RAM per PM
        for j in range(M):
            add([(X(i, j), c_req[i]) for i in range(N)], -INF,
                self.cpu_capacity)
            add([(X(i, j), r_req[i]) for i in range(N)], -INF,
                self.ram_capacity)
        # (8) one PM per VM (== 1 for must-place residents); (9) one GPU
        for i in range(N):
            lo = 1.0 if self.must_place[self.vms[i].vm_id] else -INF
            add([(X(i, j), 1.0) for j in range(M)], lo, 1.0)
            add([(Y(i, t), 1.0) for t in range(G)], lo, 1.0)
        # (10) x_ij <= sum_k y_ijk ; (11) y_ijk <= x_ij
        for i in range(N):
            for j in range(M):
                ts = [gidx[(j, k)] for k in range(K[j])]
                add([(X(i, j), 1.0)] + [(Y(i, t), -1.0) for t in ts],
                    -INF, 0.0)
                for t in ts:
                    add([(Y(i, t), 1.0), (X(i, j), -1.0)], -INF, 0.0)
        # (12)/(13) non-overlap orderings per unordered pair per GPU, with
        # each VM's footprint g resolved against that GPU's model
        for p, (i, i2) in enumerate(pairs):
            for t in range(G):
                add([(Z(i, t), 1.0), (Y(i, t), g_it[i, t]),
                     (Z(i2, t), -1.0), (A(p, t), -BIG_M)], -INF, 0.0)
                add([(Z(i2, t), 1.0), (Y(i2, t), g_it[i2, t]),
                     (Z(i, t), -1.0), (A(p, t), BIG_M)], -INF, BIG_M)
        # (14)/(15) z = g*beta when y=1 ; (16) z <= s  (per-GPU grammar)
        for i in range(N):
            for t in range(G):
                if not compat[i, t]:
                    continue  # y is bound to 0 below; z unconstrained
                add([(Z(i, t), 1.0), (Bv(i), -g_it[i, t]),
                     (Y(i, t), BIG_M)], -INF, BIG_M)
                add([(Z(i, t), -1.0), (Bv(i), g_it[i, t]),
                     (Y(i, t), BIG_M)], -INF, BIG_M)
                add([(Z(i, t), 1.0)], -INF, s_it[i, t])
        # (19) x <= phi ; (20) y <= gamma ; (21) gamma <= sum_i y
        for i in range(N):
            for j in range(M):
                add([(X(i, j), 1.0), (PHI(j), -1.0)], -INF, 0.0)
            for t in range(G):
                add([(Y(i, t), 1.0), (GAM(t), -1.0)], -INF, 0.0)
        for t in range(G):
            add([(GAM(t), 1.0)] + [(Y(i, t), -1.0) for i in range(N)],
                -INF, 0.0)
        # Strengthening cuts (integrally implied; they tighten the LP's
        # active-hardware bound, which is otherwise fractional-weak and
        # dominates proof time): block capacity links usage to gamma, and
        # an active GPU activates its PM.
        for t, (j, _k) in enumerate(gpu_keys):
            B_t = float(gpu_model[t].num_blocks)
            add([(Y(i, t), g_it[i, t]) for i in range(N)]
                + [(GAM(t), -B_t)], -INF, 0.0)
            add([(GAM(t), 1.0), (PHI(j), -1.0)], -INF, 0.0)
        # (22)-(25) migration indicators vs previous state
        xprev = np.zeros((N, M))
        yprev = np.zeros((N, G))
        for i, vm in enumerate(self.vms):
            if vm.vm_id in self.prev:
                j, k, _z = self.prev[vm.vm_id]
                xprev[i, j] = 1.0
                yprev[i, gidx[(j, k)]] = 1.0
        for i in range(N):
            for j in range(M):
                add([(X(i, j), 1.0), (Mv(i, j), -1.0)], -INF, xprev[i, j])
                add([(X(i, j), -1.0), (Mv(i, j), -1.0)], -INF, -xprev[i, j])
            for t in range(G):
                add([(Y(i, t), 1.0), (OM(i, t), -1.0)], -INF, yprev[i, t])
                add([(Y(i, t), -1.0), (OM(i, t), -1.0)], -INF, -yprev[i, t])

        # z-stability: d_i >= |z_i - z'_i| when a resident stays on its
        # previous GPU.  The paper's Eq. 5 charges only PM/GPU
        # reassignment, so same-GPU block moves are objective-free and a
        # solver may shuffle residents' start blocks arbitrarily among
        # optima; an epsilon penalty (below every lexicographic unit)
        # pins them unless a move is actually needed, which keeps the
        # rolling-horizon policy's applied/counted migrations exact.
        for i, vm in enumerate(self.vms):
            if vm.vm_id not in self.prev:
                continue
            j0, k0, z0 = self.prev[vm.vm_id]
            t0 = gidx[(j0, k0)]
            add([(D(i), 1.0), (Z(i, t0), -1.0), (Y(i, t0), -BIG_M)],
                -z0 - BIG_M, INF)
            add([(D(i), 1.0), (Z(i, t0), 1.0), (Y(i, t0), -BIG_M)],
                z0 - BIG_M, INF)

        # ---- symmetry breaking (optimality-preserving) -----------------
        # Interchangeable entities make branch-and-bound revisit the same
        # layout under G!-many relabelings; ordering their indicators
        # prunes those orbits without excluding any objective value.
        # (a) Same-model GPUs within a PM, neither referenced by a
        #     previous allocation, are interchangeable: activate in order.
        gpu_has_prev = yprev.sum(axis=0) > 0
        for j in range(M):
            for k in range(K[j] - 1):
                t, t2 = gidx[(j, k)], gidx[(j, k + 1)]
                if (gpu_model[t] is gpu_model[t2]
                        and not gpu_has_prev[t] and not gpu_has_prev[t2]):
                    add([(GAM(t), 1.0), (GAM(t2), -1.0)], 0.0, INF)
        # (b) Resident-free PMs with identical GPU rosters and capacities
        #     are interchangeable: power on in index order.  Rosters are
        #     compared by model *value* (fleet index), not name — two
        #     models sharing a name but not a geometry must never group.
        pm_has_prev = xprev.sum(axis=0) > 0
        sig = [tuple(self._mindex[m] for m in self.gpu_models[j])
               for j in range(M)]
        by_sig: Dict[Tuple[int, ...], List[int]] = {}
        for j in range(M):
            if not pm_has_prev[j]:
                by_sig.setdefault(sig[j], []).append(j)
        for group in by_sig.values():
            for j, j2 in zip(group, group[1:]):
                add([(PHI(j), 1.0), (PHI(j2), -1.0)], 0.0, INF)
        # (c) Identical new VMs (same per-model profile vector, weight,
        #     CPU/RAM, no previous allocation, same placement obligation)
        #     are interchangeable: accept in index order.  must_place VMs
        #     are excluded — forcing an ordinary twin to be accepted
        #     *before* an obligated one could make a feasible instance
        #     infeasible.
        vm_sig: Dict[Tuple, List[int]] = {}
        for i, vm in enumerate(self.vms):
            if (vm.vm_id not in self.prev
                    and not self.must_place[vm.vm_id]):
                key = (tuple(pids[i]), a_w[i], c_req[i], r_req[i])
                vm_sig.setdefault(key, []).append(i)
        for group in vm_sig.values():
            for i, i2 in zip(group, group[1:]):
                add([(X(i, j), 1.0) for j in range(M)]
                    + [(X(i2, j), -1.0) for j in range(M)], 0.0, INF)

        Amat = csr_matrix((vals, (rows, cols)), shape=(row, nvar))
        constraints = LinearConstraint(Amat, np.array(lbs), np.array(ubs))

        # ---- objective (3)-(5) scalarized ------------------------------
        cobj = np.zeros(nvar)
        for i in range(N):
            for j in range(M):
                cobj[X(i, j)] -= self.w_accept * a_w[i]        # maximize
                cobj[Mv(i, j)] += self.w_mig * delta[i]
            for t in range(G):
                cobj[OM(i, t)] += self.w_mig * delta[i]
        for j in range(M):
            cobj[PHI(j)] += self.w_hw  # b_j = 1 by default
        for t in range(G):
            cobj[GAM(t)] += self.w_hw
        # Epsilon z-stability: small enough that the total (<= N * B_max
        # * W_Z) never outweighs one active-hardware unit.
        for i, vm in enumerate(self.vms):
            if vm.vm_id in self.prev:
                cobj[D(i)] += self.W_Z

        # ---- bounds & integrality --------------------------------------
        lb = np.zeros(nvar)
        ub = np.ones(nvar)
        max_blocks = max(m.num_blocks for m in self.models)
        for i, vm in enumerate(self.vms):
            ub[D(i)] = (float(max_blocks - 1) if vm.vm_id in self.prev
                        else 0.0)
        for i in range(N):
            for t in range(G):
                # z lives in the GPU's own block space; (17)/(18): an
                # incompatible (VM, GPU) pair pins y to 0.
                ub[Z(i, t)] = float(gpu_model[t].num_blocks - 1)
                if not compat[i, t]:
                    ub[Y(i, t)] = 0.0
            ub[Bv(i)] = float(max_blocks - 1)
        # Frozen residents: pin x/y/z to the previous placement.
        for i, vm in enumerate(self.vms):
            if not self.frozen.get(vm.vm_id):
                continue
            j0, k0, z0 = self.prev[vm.vm_id]
            t0 = gidx[(j0, k0)]
            for j in range(M):
                lb[X(i, j)] = ub[X(i, j)] = 1.0 if j == j0 else 0.0
            for t in range(G):
                lb[Y(i, t)] = ub[Y(i, t)] = 1.0 if t == t0 else 0.0
            lb[Z(i, t0)] = ub[Z(i, t0)] = float(z0)
        integrality = np.ones(nvar)  # all integer (binaries via bounds)

        res = milp(c=cobj, constraints=constraints,
                   bounds=Bounds(lb, ub), integrality=integrality,
                   options={"time_limit": time_limit,
                            "mip_rel_gap": mip_rel_gap})
        if res.x is None:
            # No incumbent at all (infeasible, or the time limit struck
            # before any integral solution).
            return ILPResult(res.status, res.message, {},
                             [v.vm_id for v in self.vms], 0.0, 0, 0, 0, 0)

        xv = res.x
        accepted: Dict[int, Tuple[int, int, int]] = {}
        rejected: List[int] = []
        for i, vm in enumerate(self.vms):
            placed = False
            for t, (j, k) in enumerate(gpu_keys):
                if xv[Y(i, t)] > 0.5:
                    accepted[vm.vm_id] = (j, k, int(round(xv[Z(i, t)])))
                    placed = True
                    break
            if not placed:
                rejected.append(vm.vm_id)
        mig_pm = int(round(sum(xv[Mv(i, j)] * delta[i] for i in range(N)
                               for j in range(M))))
        mig_gpu = int(round(sum(xv[OM(i, t)] * delta[i] for i in range(N)
                                for t in range(G))))
        return ILPResult(
            res.status, res.message, accepted, rejected,
            objective_accept=float(sum(a_w[i] for i, vm in
                                       enumerate(self.vms)
                                       if vm.vm_id in accepted)),
            active_pms=int(round(sum(xv[PHI(j)] for j in range(M)))),
            active_gpus=int(round(sum(xv[GAM(t)] for t in range(G)))),
            migrations_pm=mig_pm, migrations_gpu=mig_gpu, feasible=True)


def validate_solution(result: ILPResult, vms: Sequence[VM],
                      pm_gpus: Sequence[int],
                      gpu_models: Optional[Sequence[Sequence[DeviceModel]]]
                      = None,
                      models: Optional[Sequence[DeviceModel]] = None) -> bool:
    """Check an ILP solution against each GPU's own MIG grammar.

    Every accepted placement is replayed object-level on a GPU carrying
    the correct :class:`DeviceModel`: the VM must resolve to a profile on
    that model, the start block must be in *that* profile's legal start
    set, and ``assign_at`` rejects any block overlap or out-of-range
    footprint.  Defaults reproduce the legacy homogeneous A100-40GB check.
    """
    if gpu_models is None:
        gpu_models = [[DEFAULT_MODEL] * k for k in pm_gpus]
    if models is None:
        models = derive_fleet([m for row in gpu_models for m in row])
    mindex = {m: i for i, m in enumerate(models)}
    gpus = {(j, k): GPU(model=gpu_models[j][k])
            for j in range(len(pm_gpus)) for k in range(pm_gpus[j])}
    by_id = {v.vm_id: v for v in vms}
    for vm_id, (j, k, z) in result.accepted.items():
        if (j, k) not in gpus:
            return False
        gpu = gpus[(j, k)]
        pid = int(resolve_profile_ids(by_id[vm_id], models,
                                      missing_ok=True)[mindex[gpu.model]])
        if not 0 <= pid < gpu.model.num_profiles:
            return False  # Eq. 17-18: no profile on this device model
        profile = gpu.model.profiles[pid]
        if z not in profile.start_blocks:
            return False
        try:
            gpu.assign_at(vm_id, profile, z)  # raises on overlap
        except ValueError:
            return False
    return True


def validate_on_cluster(result: ILPResult, vms: Sequence[VM],
                        cluster: Cluster) -> bool:
    """``validate_solution`` against a live cluster's geometry."""
    return validate_solution(
        result, vms, [len(h.gpus) for h in cluster.hosts],
        gpu_models=[[g.model for g in h.gpus] for h in cluster.hosts],
        models=cluster.models)


__all__ = ["MigILP", "ILPResult", "validate_solution",
           "validate_on_cluster", "BIG_M"]
