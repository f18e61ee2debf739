# Copied unchanged from repro/sim/cluster.py (the JAX package), so the port imports nothing of it.
"""Cluster model: hosts (PMs), GPUs, VMs — the paper's data-center state.

Mirrors the two-level placement split of §8: an upper level chooses the
host/GPU traversal order (the policies), while the lower level — block
placement inside a GPU — is always NVIDIA's fixed default policy
(``repro.core.mig.GPU.assign``).

Fleets may be heterogeneous: every GPU carries a
:class:`repro.core.mig.DeviceModel`, the cluster exposes the fleet's model
list plus a per-GPU ``gpu_model_id`` index, and a VM request resolves to a
per-model profile (``VM.profile_ids`` / ``Cluster.vm_pids``) so the same
VM can land on any model in the fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.mig import (DEFAULT_MODEL, GPU, DeviceModel, Profile, get_model)


@dataclasses.dataclass
class VM:
    """A MIG-enabled VM request (a 'pod' in the Alibaba trace mapping).

    ``profile`` is the request's profile under the cluster's *reference*
    model (``cluster.models[0]``); for heterogeneous fleets,
    ``profile_ids`` carries the Eq. 27-30 mapping of the same GPU
    requirement onto every fleet model (aligned with ``cluster.models``)
    and is required — on single-model clusters it may stay ``None`` (the
    profile resolves by name against the one model).
    """
    vm_id: int
    profile: Profile
    arrival: float          # hours
    duration: float         # hours
    cpu: float = 1.0
    ram: float = 1.0
    weight: float = 1.0     # a_i in Eq. (3)
    profile_ids: Optional[Tuple[int, ...]] = None

    @property
    def departure(self) -> float:
        return self.arrival + self.duration


def derive_fleet(models: Sequence[DeviceModel]) -> Tuple[DeviceModel, ...]:
    """Fleet model list in first-appearance order (the ordering contract
    ``VM.profile_ids`` vectors index into — single definition, shared by
    ``Cluster`` and the ILP oracle layer).  Dedup is by model *value*
    (``DeviceModel`` hashes by its fields), never by name."""
    seen: List[DeviceModel] = []
    for m in models:
        if m not in seen:
            seen.append(m)
    return tuple(seen)


def resolve_profile_ids(vm: "VM", models: Sequence[DeviceModel],
                        missing_ok: bool = False) -> np.ndarray:
    """The request's profile index on every fleet model, (M,) int32.

    This is the single definition of the per-model resolution contract
    (shared by the engines via ``Cluster.vm_pids`` and by the ILP oracle
    layer): explicit ``profile_ids`` when present — required on
    multi-model fleets, since a profile *name* does not identify a
    geometry across models — else a name lookup against the one model.
    ``missing_ok`` maps an unknown name to -1 (the ILP's Eq. 17-18
    "no GI on this device" marker) instead of raising.
    """
    if vm.profile_ids is not None:
        if len(vm.profile_ids) != len(models):
            raise ValueError(
                f"vm {vm.vm_id}: profile_ids has {len(vm.profile_ids)} "
                f"entries for a {len(models)}-model fleet")
        return np.asarray(vm.profile_ids, dtype=np.int32)
    if len(models) != 1:
        raise ValueError(
            f"vm {vm.vm_id} has no profile_ids on a "
            f"{len(models)}-model fleet; map its GPU requirement "
            "onto every model (Eq. 27-30, see workload.alibaba."
            "map_gpu_requirement_to_profile)")
    index = models[0].profile_index
    if missing_ok:
        return np.array([index.get(vm.profile.name, -1)], dtype=np.int32)
    return np.array([index[vm.profile.name]], dtype=np.int32)


@dataclasses.dataclass
class Host:
    """A physical machine (PM) with 1-8 MIG-enabled GPUs."""
    host_id: int
    gpus: List[GPU]
    cpu_capacity: float = 128.0
    ram_capacity: float = 1024.0
    cpu_used: float = 0.0
    ram_used: float = 0.0
    weight: float = 1.0     # b_j in Eq. (4)

    @property
    def is_active(self) -> bool:
        """phi_j: powered on iff any GPU hosts a VM."""
        return any(not g.is_empty for g in self.gpus)

    @property
    def active_gpus(self) -> int:
        """sum_k gamma_jk."""
        return sum(1 for g in self.gpus if not g.is_empty)


class Cluster:
    """Data-center state + placement bookkeeping."""

    def __init__(self, hosts: List[Host],
                 models: Optional[Sequence[DeviceModel]] = None):
        self.hosts = hosts
        for pos, h in enumerate(hosts):
            if h.host_id != pos:
                raise ValueError("host_id must equal position in hosts list")
        # GPU.global_index -> (host, gpu); also provides the orderly
        # first-fit traversal used by every policy and by GRMU's pool.
        self.gpu_index: Dict[int, Tuple[Host, GPU]] = {}
        idx = 0
        for h in hosts:
            for g in h.gpus:
                g.global_index = idx
                self.gpu_index[idx] = (h, g)
                idx += 1
        # Fleet model list: explicit, or derived in first-appearance order.
        if models is None:
            models = derive_fleet(
                [self.gpu_index[i][1].model for i in range(idx)]
            ) or (DEFAULT_MODEL,)
        self.models: Tuple[DeviceModel, ...] = tuple(models)
        # Index by model *value* (DeviceModel hashes by its fields), so a
        # custom model reusing a preset's name cannot silently resolve to
        # the wrong fleet slot.
        mindex = {m: i for i, m in enumerate(self.models)}
        try:
            self.gpu_model_id = np.array(
                [mindex[self.gpu_index[i][1].model]
                 for i in range(idx)], dtype=np.int32)
        except KeyError:
            raise ValueError(
                "a GPU's device model is not in the cluster's model list "
                f"{[m.name for m in self.models]}") from None
        self.placements: Dict[int, Tuple[Host, GPU]] = {}  # vm_id -> loc
        self.vms: Dict[int, VM] = {}
        # Vectorized mirror of per-GPU free-block masks (kept in sync by
        # every mutation below); policies scan this instead of objects.
        self.free_masks = np.array(
            [self.gpu_index[i][1].model.full_mask for i in range(idx)],
            dtype=np.uint8)
        # Vectorized host headroom, indexed by gpu global_index's host.
        self.gpu_host_id = np.array(
            [self.gpu_index[i][0].host_id for i in range(len(self.gpu_index))],
            dtype=np.int32)
        # Maintained per-host CPU/RAM accounting (the hot path of every
        # sequential ``place`` call).  float32 on purpose: the batched JAX
        # engine accumulates in float32, and using the same width + the
        # same event order here makes feasibility comparisons bit-identical
        # across engines.
        self.host_cpu_cap = np.array([h.cpu_capacity for h in hosts],
                                     dtype=np.float32)
        self.host_ram_cap = np.array([h.ram_capacity for h in hosts],
                                     dtype=np.float32)
        self.host_cpu_used = np.array([h.cpu_used for h in hosts],
                                      dtype=np.float32)
        self.host_ram_used = np.array([h.ram_used for h in hosts],
                                      dtype=np.float32)

    def _sync(self, gpu: GPU) -> None:
        self.free_masks[gpu.global_index] = gpu.free_mask()

    def _host_fits(self, host: Host, vm: VM) -> bool:
        """Array-backed host headroom check (same math as host_fits_vec)."""
        i = host.host_id
        return bool(
            (self.host_cpu_used[i] + np.float32(vm.cpu)
             <= self.host_cpu_cap[i])
            and (self.host_ram_used[i] + np.float32(vm.ram)
                 <= self.host_ram_cap[i]))

    def _host_charge(self, host: Host, vm: VM, sign: int) -> None:
        i = host.host_id
        if sign > 0:
            self.host_cpu_used[i] += np.float32(vm.cpu)
            self.host_ram_used[i] += np.float32(vm.ram)
        else:
            self.host_cpu_used[i] -= np.float32(vm.cpu)
            self.host_ram_used[i] -= np.float32(vm.ram)
        # Keep the object-level mirror exactly equal to the arrays, so
        # Host.fits_host answers match the engines' decisions.
        host.cpu_used = float(self.host_cpu_used[i])
        host.ram_used = float(self.host_ram_used[i])

    def host_fits_vec(self, vm: VM) -> np.ndarray:
        """Boolean per-GPU vector: does the owning host fit ``vm``?"""
        ok = ((self.host_cpu_used + np.float32(vm.cpu) <= self.host_cpu_cap)
              & (self.host_ram_used + np.float32(vm.ram)
                 <= self.host_ram_cap))
        return ok[self.gpu_host_id]

    # -- per-model request resolution -------------------------------------
    def vm_pids(self, vm: VM) -> np.ndarray:
        """See :func:`resolve_profile_ids` (strict: unknown names raise)."""
        return resolve_profile_ids(vm, self.models)

    def profile_on(self, vm: VM, gpu: GPU) -> Profile:
        """The concrete Profile ``vm`` occupies on ``gpu``'s model."""
        pid = int(self.vm_pids(vm)[self.gpu_model_id[gpu.global_index]])
        return gpu.model.profiles[pid]

    # -- queries ----------------------------------------------------------
    @property
    def num_gpus(self) -> int:
        return len(self.gpu_index)

    def all_gpus(self) -> Iterator[GPU]:
        for i in range(self.num_gpus):
            yield self.gpu_index[i][1]

    def host_of_gpu(self, gpu: GPU) -> Host:
        return self.gpu_index[gpu.global_index][0]

    def active_hardware(self) -> Tuple[int, int]:
        """(active PMs, active GPUs) per Eq. (4)'s phi/gamma convention."""
        pms = sum(1 for h in self.hosts if h.is_active)
        gpus = sum(h.active_gpus for h in self.hosts)
        return pms, gpus

    def active_hardware_rate(self) -> float:
        pms, gpus = self.active_hardware()
        return (pms + gpus) / (len(self.hosts) + self.num_gpus)

    # -- mutation ---------------------------------------------------------
    def place(self, vm: VM, gpu: GPU) -> Optional[int]:
        """Try to place ``vm`` on ``gpu`` with the default block policy.
        Returns the start block, or None (GPU full / host resources)."""
        host = self.host_of_gpu(gpu)
        if not self._host_fits(host, vm):
            return None
        start = gpu.assign(vm.vm_id, self.profile_on(vm, gpu))
        if start is None:
            return None
        self._host_charge(host, vm, +1)
        self.placements[vm.vm_id] = (host, gpu)
        self.vms[vm.vm_id] = vm
        self._sync(gpu)
        return start

    def place_at(self, vm: VM, gpu: GPU, start: int) -> None:
        host = self.host_of_gpu(gpu)
        gpu.assign_at(vm.vm_id, self.profile_on(vm, gpu), start)
        self._host_charge(host, vm, +1)
        self.placements[vm.vm_id] = (host, gpu)
        self.vms[vm.vm_id] = vm
        self._sync(gpu)

    def release(self, vm_id: int) -> None:
        host, gpu = self.placements.pop(vm_id)
        vm = self.vms.pop(vm_id)
        gpu.release(vm_id)
        self._host_charge(host, vm, -1)
        self._sync(gpu)

    def migrate_intra(self, vm_id: int, new_start: int) -> None:
        """Intra-GPU migration: move a VM's GI to a new start block."""
        host, gpu = self.placements[vm_id]
        vm = self.vms[vm_id]
        gpu.release(vm_id)
        gpu.assign_at(vm_id, self.profile_on(vm, gpu), new_start)
        self._sync(gpu)

    def migrate_inter(self, vm_id: int, dst: GPU) -> bool:
        """Inter-GPU migration (live migration of VM + its GI)."""
        vm = self.vms[vm_id]
        src_host, src_gpu = self.placements[vm_id]
        dst_host = self.host_of_gpu(dst)
        if dst_host is not src_host and not self._host_fits(dst_host, vm):
            return False
        start = dst.assign(vm_id, self.profile_on(vm, dst))
        if start is None:
            return False
        src_gpu.release(vm_id)
        if dst_host is not src_host:
            self._host_charge(src_host, vm, -1)
            self._host_charge(dst_host, vm, +1)
        self.placements[vm_id] = (dst_host, dst)
        self._sync(src_gpu)
        self._sync(dst)
        return True


ModelLike = Union[DeviceModel, str]


def _resolve(model: ModelLike) -> DeviceModel:
    return get_model(model) if isinstance(model, str) else model


def make_cluster(gpu_counts: List[int], cpu: float = 128.0,
                 ram: float = 1024.0,
                 host_models: Optional[Sequence[ModelLike]] = None,
                 models: Optional[Sequence[DeviceModel]] = None) -> Cluster:
    """Build a cluster from a per-host GPU-count list.

    ``host_models`` optionally assigns a device model per host (names or
    ``DeviceModel`` instances); default is the paper's homogeneous
    A100-40GB fleet.  ``models`` pins the fleet's model ordering (the
    first entry is the reference model for VM profiles/metrics); by
    default it is derived in first-appearance order.
    """
    if host_models is not None and len(host_models) != len(gpu_counts):
        raise ValueError("host_models must match gpu_counts length")
    hosts = []
    for hid, n in enumerate(gpu_counts):
        model = (_resolve(host_models[hid]) if host_models is not None
                 else DEFAULT_MODEL)
        hosts.append(Host(hid, [GPU(model=model) for _ in range(n)],
                          cpu, ram))
    if models is not None:
        models = tuple(_resolve(m) for m in models)
    return Cluster(hosts, models=models)


__all__ = ["VM", "Host", "Cluster", "make_cluster",
           "resolve_profile_ids", "derive_fleet"]
