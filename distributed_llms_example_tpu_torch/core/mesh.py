"""The process group and the device mesh (port of the JAX package's
``core/mesh.py``).

The JAX package bootstraps ``jax.distributed`` from the Valohai
rendezvous triple (the master's IP, the world size, this member's rank;
the reference's ``train-task.py``) and lays every parallelism out on one
``jax.sharding.Mesh``.  The port takes the same triple, from the same
sources in the same order (explicit arguments, the ``valohai.distributed``
platform config, ``VH_MASTER_IP``/``VH_WORLD_SIZE``/``VH_RANK``, torchrun's
``MASTER_ADDR``/``WORLD_SIZE``/``RANK``), into a ``torch.distributed``
process group: NCCL for CUDA, gloo when the caller asks for the CPU, and
never one in place of the other.  The mesh is a ``DeviceMesh`` of the
``data``, ``fsdp``, ``sequence`` and ``tensor`` axes, one process a GPU,
ranks laid out row-major in the JAX package's axis order, so ``tensor``
varies fastest; ``axis_groups`` adds the groups the model-parallel step
reduces over.  A world of one process creates no group.

Launch (one process per GPU)::

    torchrun --nproc-per-node 4 -m distributed_llms_example_tpu_torch.launch.cli \\
        --model-ckpt llama-2-7b --mesh fsdp=4 --train-file train.json ...

or each process with ``VH_MASTER_IP``, ``VH_WORLD_SIZE`` and ``VH_RANK`` set
(or ``--coordinator-address``, ``--num-processes``, ``--process-id``).

Host-loss recovery re-creates the group on the surviving ranks
(``reinitialize_distributed``, the one owner of the teardown).  Rank 0
serves the rendezvous ``TCPStore`` on the coordinator's port; the process
keeps that store for its life and gives each generation of the group its
own ``PrefixStore`` (``gen0``, ``gen1``, ...), so a re-created group never
binds the port again nor meets the keys of the group it replaces.  The
generation counts the re-inits each process has completed, and every
survivor has completed the same ones, so the prefixes agree; a replacement
process joining a re-created group (it would start at ``gen0``) is not
supported.
``elastic_mesh_spec`` re-resolves ``--mesh`` for the survivors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch

from distributed_llms_example_tpu_torch.core.config import PORTED_AXES, MeshConfig

DEFAULT_COORDINATOR_PORT = 1234  # the reference's tcp://<master>:1234
STORE_TIMEOUT = datetime.timedelta(minutes=30)  # the rendezvous store's (torch's default)

# the process group is process-wide state in torch.distributed, and so is
# what re-creating it needs: the rendezvous store of each coordinator
# address, the facts the live group was made from, and its generation
_STORES: dict[str, "torch.distributed.TCPStore"] = {}
_GROUP_FACTS: dict[str, object] = {}
_GENERATION = 0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Resolved (positive) sizes of the axes the port lays out."""

    data: int
    fsdp: int
    sequence: int = 1
    tensor: int = 1

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.sequence * self.tensor

    def axes(self) -> dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp, "sequence": self.sequence,
                "tensor": self.tensor}


def resolve_mesh_shape(cfg: MeshConfig, n_devices: int) -> MeshSpec:
    """Resolve a -1 axis and check the product against the device count
    (the JAX package's rules and messages).  ``stage`` and ``expert`` must
    resolve to 1."""
    sizes = cfg.axis_sizes()
    bad = {k: v for k, v in sizes.items() if v == 0 or v < -1}
    if bad:
        raise ValueError(f"mesh axis sizes must be positive or -1, got {bad}")
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wild}")
    fixed = int(np.prod([v for v in sizes.values() if v != -1]))
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
        sizes[wild[0]] = n_devices // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(f"mesh {sizes} has size {total}, but {n_devices} devices are available")
    unported = {k: v for k, v in sizes.items() if k not in PORTED_AXES and v != 1}
    if unported:
        raise ValueError(f"the port lays out data, fsdp, sequence and tensor only, got "
                         f"{unported} (ROADMAP.md item 6)")
    return MeshSpec(data=sizes["data"], fsdp=sizes["fsdp"], sequence=sizes["sequence"],
                    tensor=sizes["tensor"])


def _valohai_facts() -> tuple[str, int, int | None]:
    """(master_ip, world_size, rank) from the platform, else the env, else
    a local run.  ``rank`` is None when no source gave one."""
    try:
        import valohai  # type: ignore

        dist = valohai.distributed
        if dist.is_distributed_task():
            return (dist.master().primary_local_ip, int(dist.required_count),
                    int(dist.me().rank))
    except Exception:
        pass
    env = os.environ
    ip = env.get("VH_MASTER_IP", env.get("MASTER_ADDR", ""))
    world = int(env.get("VH_WORLD_SIZE", env.get("WORLD_SIZE", "1")))
    rank_s = env.get("VH_RANK", env.get("RANK"))
    return ip, world, (int(rank_s) if rank_s is not None else None)


def is_distributed() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return torch.distributed.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if is_distributed() else 0


def local_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (torchrun), else the
    rank modulo the GPUs of the host; the CPU is one device."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else process_index() % max(1, torch.cuda.device_count())
    return torch.device("cuda", idx)


def initialize_distributed(coordinator_address: str = "", num_processes: int = 0,
                           process_id: int = -1, *, device_type: str = "cuda") -> int:
    """Join the process group from the rendezvous triple: the arguments,
    else the Valohai platform, else ``VH_*``, else torchrun's env.  Returns
    the world size.  One process (no facts, or a world of 1) creates no
    group; an existing group is kept.  An address without a port takes
    torchrun's ``MASTER_PORT``, else the reference's 1234.  The backend is
    NCCL on CUDA and gloo on the CPU; a failing NCCL raises, it never turns
    into gloo."""
    if is_distributed():
        return process_count()
    if not coordinator_address or num_processes <= 0 or process_id < 0:
        ip, world, rank = _valohai_facts()
        coordinator_address = coordinator_address or ip
        num_processes = num_processes if num_processes > 0 else world
        process_id = process_id if process_id >= 0 else (rank if rank is not None else -1)
    if num_processes <= 1:
        return 1
    # a multi-process run without its rendezvous facts must fail: N
    # independent trainings with no gradient exchange would run silently
    if not coordinator_address:
        raise ValueError(
            f"num_processes={num_processes} but no coordinator address found "
            "(pass --coordinator-address, or set VH_MASTER_IP/MASTER_ADDR)")
    if process_id < 0:
        raise ValueError(
            f"num_processes={num_processes} but no process id found "
            "(pass --process-id, or set VH_RANK/RANK)")
    _create_group(coordinator_address, num_processes, process_id,
                  "nccl" if device_type == "cuda" else "gloo", _GENERATION)
    return num_processes


def _with_port(address: str) -> str:
    if ":" in address:
        return address
    return f"{address}:{os.environ.get('MASTER_PORT', str(DEFAULT_COORDINATOR_PORT))}"


def _create_group(address: str, world: int, rank: int, backend: str, gen: int) -> None:
    """The group of generation ``gen`` over the address's store (made on
    the first use of the address: rank 0 serves it)."""
    address = _with_port(address)
    store = _STORES.get(address)
    if store is None:
        host, port = address.rsplit(":", 1)
        store = torch.distributed.TCPStore(host, int(port), world, is_master=rank == 0,
                                           timeout=STORE_TIMEOUT, wait_for_workers=False)
        _STORES[address] = store
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    torch.distributed.init_process_group(
        backend, store=torch.distributed.PrefixStore(f"gen{gen}", store),
        world_size=world, rank=rank)
    _GROUP_FACTS.update(address=address, world=world, rank=rank)


def generation() -> int:
    """How many times ``reinitialize_distributed`` re-created the group."""
    return _GENERATION


def reinitialize_distributed(coordinator_address: str = "", num_processes: int = 0,
                             process_id: int = -1, *, device_type: str = "cuda") -> int:
    """Tear the process group down and create the next generation on the
    surviving ranks (topology-change recovery); returns the world size.

    The one owner of the teardown: ``destroy_process_group`` if a group is
    live (the caller has nothing in flight on it: saves joined, the card
    synchronised, the prefetch thread stopped), then the group anew from the
    rendezvous facts re-read as at startup (the arguments, the platform,
    ``VH_*``, torchrun's env), else the facts of the group torn down.  The
    backend is the torn-down group's (NCCL stays NCCL: a failing NCCL raises
    and never turns into gloo), else by ``device_type``.  Without a live
    group and with a world of one it creates nothing."""
    global _GENERATION
    live = is_distributed()
    backend = torch.distributed.get_backend() if live else (
        "nccl" if device_type == "cuda" else "gloo")
    if live:
        torch.distributed.destroy_process_group()
    if not coordinator_address or num_processes <= 0 or process_id < 0:
        ip, world, rank = _valohai_facts()
        coordinator_address = coordinator_address or ip or str(_GROUP_FACTS.get("address", ""))
        if num_processes <= 0:
            num_processes = world if ip else int(_GROUP_FACTS.get("world", world))
        if process_id < 0:
            process_id = rank if rank is not None else int(_GROUP_FACTS.get("rank", -1))
    if num_processes <= 1 and not live:
        return 1
    if not coordinator_address or process_id < 0:
        raise ValueError("re-creating the process group needs its rendezvous facts: pass "
                         "--coordinator-address and --process-id, or set VH_MASTER_IP/"
                         "MASTER_ADDR and VH_RANK/RANK")
    # counted once the group exists: a failed attempt leaves the prefix
    # where the other ranks' is
    _create_group(coordinator_address, num_processes, process_id, backend, _GENERATION + 1)
    _GENERATION += 1
    return num_processes


def elastic_mesh_spec(cfg: MeshConfig, n_devices: int) -> MeshSpec:
    """The mesh for a CHANGED device count (topology-change recovery): the
    configured shape re-resolved against the survivors.  A -1 axis absorbs
    the change as at startup; a fully pinned shape whose product no longer
    matches re-scales ``data`` (replicas are what elasticity varies); when
    the other axes' product does not divide the count there is no shrink,
    and this raises with both shapes named."""
    sizes = cfg.axis_sizes()
    try:
        return resolve_mesh_shape(cfg, n_devices)
    except ValueError:
        pass
    rest = int(np.prod([v for k, v in sizes.items() if k != "data"]))
    if -1 in sizes.values() or rest <= 0 or n_devices % rest:
        raise ValueError(
            f"cannot re-factorize mesh {sizes} onto {n_devices} surviving device(s): the "
            f"non-data axes' product ({rest}) must divide the device count — resume on a "
            "slice shape the configured model sharding fits, or change the mesh config")
    return resolve_mesh_shape(dataclasses.replace(cfg, data=n_devices // rest), n_devices)


MESH_AXES = ("data", "fsdp", "sequence", "tensor")


def build_mesh(spec: MeshSpec, device_type: str):
    """The (data, fsdp, sequence, tensor) ``DeviceMesh`` over the process
    group, ranks laid out row-major in the JAX package's axis order
    (``tensor`` fastest): rank r holds what JAX device r holds, its
    coordinates ``mesh_coords``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(spec.axes().values()), mesh_dim_names=MESH_AXES)


def mesh_coords(spec: MeshSpec, rank: int) -> tuple[int, int, int, int]:
    """(data, fsdp, sequence, tensor) position of ``rank`` on the mesh of
    ``spec``."""
    out = []
    for size in reversed(spec.axes().values()):
        rank, c = divmod(rank, size)
        out.append(c)
    return tuple(reversed(out))


def mesh_rank(spec: MeshSpec, coords) -> int:
    """The rank at (data, fsdp, sequence, tensor) ``coords``."""
    rank = 0
    for c, size in zip(coords, spec.axes().values()):
        rank = rank * size + c
    return rank


@dataclasses.dataclass(frozen=True)
class AxisGroups:
    """This rank's groups of a model-parallel mesh: ``rows``, the ranks of
    its ``tensor`` position (data x sequence: the loss, the token count and
    the gradients meet over them), ``data`` (the ranks of its sequence and
    tensor position), ``sequence`` and ``tensor`` (each None at size 1),
    and this rank's index in the last two."""

    rows: Any
    data: Any
    sequence: Any
    tensor: Any
    sequence_index: int
    tensor_index: int


def axis_groups(spec: MeshSpec, rank: int) -> AxisGroups:
    """The groups of ``axis_groups`` on the live process group: every rank
    creates every group (``new_group`` is collective), in one order."""
    new_group = torch.distributed.new_group
    _, _, s, t = mesh_coords(spec, rank)
    picked: dict[str, Any] = {}
    lines = {
        # the ranks that share a tensor position: one group a tensor index
        "rows": [[mesh_rank(spec, (dd, 0, ss, tt)) for dd in range(spec.data)
                  for ss in range(spec.sequence)] for tt in range(spec.tensor)],
        "data": [[mesh_rank(spec, (dd, 0, ss, tt)) for dd in range(spec.data)]
                 for ss in range(spec.sequence) for tt in range(spec.tensor)],
        "sequence": [[mesh_rank(spec, (dd, 0, ss, tt)) for ss in range(spec.sequence)]
                     for dd in range(spec.data) for tt in range(spec.tensor)],
        "tensor": [[mesh_rank(spec, (dd, 0, ss, tt)) for tt in range(spec.tensor)]
                   for dd in range(spec.data) for ss in range(spec.sequence)],
    }
    for name, groups in lines.items():
        for ranks in groups:
            g = new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                picked[name] = g
    return AxisGroups(**picked, sequence_index=s, tensor_index=t)


def process_allgather(x: np.ndarray, *, device: torch.device | None = None) -> np.ndarray:
    """Every process's ``x`` stacked on a new leading axis (one process: x
    with that axis added).  The collective runs on ``device`` (NCCL needs
    the rank's GPU; gloo the CPU)."""
    x = np.asarray(x)
    if not is_distributed():
        return x[None]
    if device is None:
        device = (local_device("cuda") if torch.distributed.get_backend() == "nccl"
                  else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def device_report(device: torch.device) -> dict:
    """The torch and CUDA inventory (the reference's ``print_gpu_report``),
    as a dict for the JSON-lines channel."""
    out = {"torch_version": torch.__version__, "cuda_version": torch.version.cuda,
           "device": str(device), "process_index": process_index(),
           "process_count": process_count(),
           "backend": torch.distributed.get_backend() if is_distributed() else None}
    if device.type == "cuda":
        out["local_device_count"] = torch.cuda.device_count()
        out["devices"] = [{"id": i, "kind": torch.cuda.get_device_name(i)}
                          for i in range(torch.cuda.device_count())]
    return out
