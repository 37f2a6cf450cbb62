"""Device meshes over ``torch.distributed``; mirrors ``repro/launch/mesh.py``.

Each device is one process (one rank).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world,
with the JAX package's axis names, so the primitives and ``LinearOp``s
name their axes the same way (``core/primitives.py``).

The backend follows the device, a rule and not a fallback, as the kernels'
dispatch does (``kernels/ops.py``): a ``cuda`` mesh (the default, through
``device.resolve_device``) runs NCCL with one rank per card, and a world
larger than ``torch.cuda.device_count()`` raises: NCCL refuses two ranks on
one card, and nothing here moves CUDA tensors to gloo or to the host.  A
``cpu`` mesh runs gloo.  A ``meta`` mesh runs torch's fake backend
(``init_fake_world``): one host process stands in for rank r of a world of
any size, its collectives return at once on shape stand-ins, and nothing
is allocated (the dry run, ``launch/dryrun.py``).

Builders are FUNCTIONS, not module constants, and every rank of the world
calls each one in the same order (creating a process group is collective).
Each axis's groups get the world's timeout, so a hang fails instead of
waiting out torch's default.

After the loss of a mesh slice (the elastic supervisor, DESIGN §10) the
survivors build their degraded mesh without the lost ranks.
``shrink_world`` re-forms the world over the survivors, in survivor order,
rather than creating the new groups with ``new_group(...,
use_local_synchronization=True)`` inside the old world: under NCCL with
the card bound at ``init_process_group`` (eager init) a new group is split
from the world's communicator, a collective of every rank of the world,
lost ones included, so a local-synchronization group of the survivors
would wait for ranks that are gone; and the old world's own barrier and
default group would keep naming them.  The re-formed world rendezvouses on
the first world's store (kept alive by its master, rank 0, which always
survives: the lost slice is the last one), under a new prefix, and waits
until every lost rank has left before it forms.

``spawn`` runs a function on every rank of a fresh world: the counterpart
of ``--xla_force_host_platform_device_count`` for the tests, and of one
process per card for ``chip_smoke.py``.  ``shard_map`` needs none.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import primitives as prim
from ..device import resolve_device
from ..tree import tree_map

BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "cpu:fake,meta:fake"}
_TIMEOUT: list = []   # the world's process-group timeout, set by init_world
_WORLD: dict = {}     # the first world's store and this process's card


def _device_type(device) -> str:
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no mesh backend for device {dev}")
    return dev.type


def _check_world(world: int, device_type: str):
    """One rank per card on a CUDA mesh."""
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"a CUDA mesh takes one rank per card: {world} ranks, "
            f"{torch.cuda.device_count()} card(s) (NCCL refuses two ranks "
            f"on one card)")


def init_world(rank: int, world: int, *, device="cuda", port,
               timeout_s: float = 300.0):
    """Join this process to a world of ``world`` ranks, NCCL for ``cuda``
    (rank r on card r), gloo for ``cpu``, every group with a ``timeout_s``
    timeout.  ``port`` is a shared ``multiprocessing.Value`` holding 0
    (``spawn``'s): rank 0 binds a free port for the world's store and
    publishes it there, and the other ranks wait for it, so no other
    process can take the port between its choice and its bind."""
    device_type = _device_type(device)
    _check_world(world, device_type)
    timeout = datetime.timedelta(seconds=timeout_s)
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=timeout,
                              wait_for_workers=False)
        port.value = store.port
    else:
        deadline = time.monotonic() + timeout_s
        while not port.value:
            if time.monotonic() > deadline:
                raise TimeoutError("rank 0 published no store port")
            time.sleep(0.01)
        store = dist.TCPStore("127.0.0.1", port.value, world, False,
                              timeout=timeout)
    _WORLD.clear()
    _WORLD.update(store=store, card=rank, generation=0)
    _join(store, rank, world, device_type, timeout)


def _join(store, rank: int, world: int, device_type: str, timeout):
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(_WORLD["card"])
        kw["device_id"] = torch.device("cuda", _WORLD["card"])
    dist.init_process_group(BACKENDS[device_type], store=store,
                            world_size=world, rank=rank, timeout=timeout,
                            **kw)
    _TIMEOUT[:] = [timeout]


def init_fake_world(rank: int, world: int):
    """Join this process to a fake world of ``world`` ranks as ``rank``:
    torch's fake process group (``torch.testing._internal.distributed.
    fake_pg``) on the host and ``meta`` devices, over an in-process store.
    Every collective, ``batch_isend_irecv`` included, returns at once
    without moving data, so one process traces rank ``rank``'s program of
    a mesh of any size on ``meta`` tensors.  ``dist.destroy_process_group``
    leaves it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    timeout = datetime.timedelta(seconds=300)
    _WORLD.clear()
    _WORLD.update(store=None, card=rank, generation=0)
    dist.init_process_group(BACKENDS["meta"], store=FakeStore(), rank=rank,
                            world_size=world, timeout=timeout)
    _TIMEOUT[:] = [timeout]


def shrink_world(ranks) -> int | None:
    """Re-form the world over ``ranks`` (ranks of the current world, in
    the order they take in the new one); every rank of the current world
    calls this together.  A rank left out destroys its process groups,
    signals that it has left, and gets None: it takes no part in the new
    world.  The others wait until every left-out rank has signalled, then
    join the new world (each on its own card) and get their new rank.  The
    current world's groups, and every mesh built on them, are gone."""
    ranks = [int(r) for r in ranks]
    me, world = dist.get_rank(), dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    gen = _WORLD["generation"] + 1
    prefix = f"shrink{gen}/"
    dist.barrier()
    dist.destroy_process_group()
    store = _WORLD["store"]
    if me not in ranks:
        store.set(f"{prefix}left/{me}", "1")
        return None
    store.wait([f"{prefix}left/{r}" for r in range(world)
                if r not in ranks])
    _WORLD["generation"] = gen
    rank = ranks.index(me)
    _join(dist.PrefixStore(prefix, store), rank, len(ranks), device_type,
          _TIMEOUT[0])
    return rank


def _make_mesh(shape, axes, devices=None, *, device=None,
               all_ranks_group: bool = False):
    """A DeviceMesh of ``shape`` named ``axes`` over ``devices`` (global
    ranks in mesh order; default the first prod(shape) ranks).  Every rank
    of the world calls this; ranks outside the mesh get None.

    ``all_ranks_group`` also makes one group of all the mesh's ranks, kept
    on the mesh as ``all_ranks_group``, for the one all-reduce over the
    whole mesh of ``primitives.mesh_all_reduce_`` (the pipeline's guard
    flag); a 1-D mesh uses its one axis group.  With a ``data`` axis of
    size > 1 it also makes one group per data replica (the ranks of one
    data coordinate), kept as ``replica_group`` (the hybrid step's clip
    norm); otherwise ``replica_group`` is ``all_ranks_group``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    device_type = _device_type(device)
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"a {device_type} mesh runs "
                         f"{BACKENDS[device_type]}, but the world runs "
                         f"{backend}")
    avail = (list(range(dist.get_world_size())) if devices is None
             else [int(d) for d in devices])
    want = math.prod(shape)
    if want > len(avail):
        raise ValueError(f"mesh {shape} needs {want} ranks, only "
                         f"{len(avail)} available")
    _check_world(want, device_type)
    grid = np.asarray(avail[:want]).reshape(shape)
    me = dist.get_rank()
    timeout = _TIMEOUT[0] if _TIMEOUT else None
    groups = []
    for d in range(len(shape)):
        mine = None
        for row in np.moveaxis(grid, d, -1).reshape(-1, shape[d]):
            group = dist.new_group(row.tolist(), timeout=timeout)
            if me in row:
                mine = group
        groups.append(mine)
    flat = (dist.new_group(grid.ravel().tolist(), timeout=timeout)
            if all_ranks_group and len(shape) > 1 else None)
    replica = None
    if all_ranks_group and "data" in axes and len(shape) > 1:
        d = axes.index("data")
        if shape[d] > 1:
            for i in range(shape[d]):
                sub = np.take(grid, i, axis=d).ravel().tolist()
                group = dist.new_group(sub, timeout=timeout)
                if me in sub:
                    replica = group
    if me not in grid:
        return None
    # Under NCCL, when ``batch_isend_irecv`` is a group's first collective
    # every rank of the group must join it, and a non-cyclic shift with
    # |offset| >= 2 leaves some ranks out (``primitives._shift_many``).  One
    # small all-reduce on each of this rank's groups comes first instead.
    probe = torch.zeros(1, device=(torch.device("cuda",
                                                torch.cuda.current_device())
                                   if device_type == "cuda" else device_type))
    for group in groups + [flat] * (flat is not None):
        dist.all_reduce(probe, group=group)
    mesh = DeviceMesh.from_group(groups, device_type,
                                 mesh=torch.as_tensor(grid),
                                 mesh_dim_names=axes)
    if all_ranks_group:
        mesh.all_ranks_group = groups[0] if flat is None else flat
        mesh.replica_group = mesh.all_ranks_group if replica is None \
            else replica
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         all_ranks_group: bool = False):
    """Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 x 16 x
    16 = 512 ranks (pod, data, model); the pod axis is pure data
    parallelism.  ``all_ranks_group`` as ``_make_mesh`` (the policy train
    step's one all-reduce over the mesh needs it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device=device,
                      all_ranks_group=all_ranks_group)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *, device=None,
                   all_ranks_group: bool = False):
    """Small mesh over the world's ranks: smoke tests, examples, checks,
    and the policy train program's (data, model) mesh, which passes
    ``all_ranks_group`` (``_make_mesh``) for its one all-reduce over the
    mesh."""
    return _make_mesh(shape, axes, device=device,
                      all_ranks_group=all_ranks_group)


def make_pipeline_mesh(num_stages: int, tp: int = 1, *, device=None):
    """Pipe x tensor 2-D mesh for pipeline parallelism: stage-to-stage
    SendRecv moves along ``pipe``, the TP ring collectives along ``model``
    inside each stage.  The axis names are fixed."""
    return _make_mesh((num_stages, tp), ("pipe", "model"), device=device,
                      all_ranks_group=True)


def make_hybrid_mesh(dp: int, num_stages: int, cp: int = 1, tp: int = 1,
                     ep: int = 1, *, devices=None, device=None):
    """Hybrid DP x pipe x ctx x tensor x expert mesh (DESIGN §5-6, §8):
    per-replica batch shards move along ``data``, stage boundaries along
    ``pipe``, KV ring-attention rotations along ``ctx``, TP ring
    collectives along ``model``, MoE token dispatch along ``ep``: all five
    of the paper's parallelism styles on ONE mesh.  The axis names are
    fixed.

    Degenerate factorizations reduce exactly: ep=1 returns the 4-D (or, at
    cp=1, 3-D) mesh without the axis; cp=1 likewise elides ``ctx``.

    ``devices`` pins the mesh to an explicit subset of global ranks (the
    elastic path builds degraded meshes over the survivors of a device
    loss); oversubscribing the available ranks raises a ``ValueError``
    naming the factorization, the error the elastic supervisor probes
    while searching for the largest legal degraded mesh.
    """
    avail = len(devices) if devices is not None else dist.get_world_size()
    want = dp * num_stages * cp * tp * ep
    if want > avail:
        raise ValueError(
            f"hybrid mesh factorization dp*S*cp*tp*ep = "
            f"{dp}x{num_stages}x{cp}x{tp}x{ep} = {want} oversubscribes the "
            f"{avail} available device(s)")
    if ep == 1:
        if cp == 1:
            return _make_mesh((dp, num_stages, tp), ("data", "pipe", "model"),
                              devices, device=device, all_ranks_group=True)
        return _make_mesh((dp, num_stages, cp, tp),
                          ("data", "pipe", "ctx", "model"), devices,
                          device=device, all_ranks_group=True)
    return _make_mesh((dp, num_stages, cp, tp, ep),
                      ("data", "pipe", "ctx", "model", "ep"), devices,
                      device=device, all_ranks_group=True)


def surviving_devices(mesh, lost_axis: str) -> list:
    """The global ranks left after losing one slice of ``lost_axis``.

    Simulated device loss: the LAST slice along the lost axis goes away and
    the survivors keep their order, so the degraded mesh is a sub-grid of
    the original and every surviving shard stays on the rank that holds it.
    """
    names = list(mesh.mesh_dim_names)
    if lost_axis not in names:
        raise ValueError(
            f"mesh has no axis {lost_axis!r} (axes: {names})")
    grid = mesh.mesh.cpu().numpy()
    ax = names.index(lost_axis)
    if grid.shape[ax] <= 1:
        raise ValueError(
            f"axis {lost_axis!r} has size 1: losing its only slice "
            f"leaves no devices")
    idx = [slice(None)] * grid.ndim
    idx[ax] = slice(0, grid.shape[ax] - 1)
    return [int(r) for r in grid[tuple(idx)].ravel()]


def shrink_factorization(factorization, lost_axis: str):
    """The largest legal degraded (dp, S, cp, tp, ep) after losing one
    slice of ``lost_axis``, plus the fold multiplier.

    Shrinks the lost axis' degree to the largest divisor of the old one
    below it; the lost parallelism is folded into grad accumulation
    (``virtual_dp`` for the data axis) so the global batch schedule, and
    with it the fp32 loss, is unchanged.  Returns ``((dp, S, cp, tp, ep),
    fold)`` where ``fold`` is old_degree // new_degree.
    """
    axes = {"data": 0, "pipe": 1, "ctx": 2, "model": 3, "ep": 4}
    if lost_axis not in axes:
        raise ValueError(f"unknown mesh axis {lost_axis!r}")
    fact = list(factorization)
    i = axes[lost_axis]
    old = fact[i]
    if old <= 1:
        raise ValueError(
            f"axis {lost_axis!r} has degree {old}: nothing to shrink")
    new = old - 1
    while old % new:
        new -= 1
    fact[i] = new
    return tuple(fact), old // new


# ---------------------------------------------------------------------------
# spawn: one process per rank.
# ---------------------------------------------------------------------------

def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def _rank_main(rank, world, fn, device_type, timeout_s, port, results):
    try:
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_world(rank, world, device=device_type, port=port,
                   timeout_s=timeout_s)
        mesh = _make_mesh((world,), ("model",), device=device_type)
        with prim.use_mesh(mesh):
            out = _to_numpy(fn(rank, mesh))
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    if dist.is_initialized():    # a rank left out by shrink_world is not
        dist.destroy_process_group()


def spawn(fn, world: int, *, device="cuda",
          timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, mesh)`` on ``world`` fresh processes, one rank each,
    and return the ranks' results in rank order, tensors as numpy arrays.

    ``fn`` must be importable by name (a module-level function) and return
    tensors, numbers or nested lists, tuples and dicts of them.  ``mesh``
    is the 1-D ``(world,)`` mesh named ``("model",)``, the current mesh
    while ``fn`` runs; ``fn`` builds any other mesh it needs.  ``device`` picks the backend
    (module docstring).  Every process group times out after
    ``timeout_s``, and the whole run must end within it: on a failure or
    a timeout every process is stopped and the error raised.
    """
    device_type = _device_type(device)
    _check_world(world, device_type)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = ctx.Value("i", 0)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, fn, device_type, timeout_s, port,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn: ranks {dead} exited without "
                                       f"a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: {world - len(out)} of {world} ranks gave "
                        f"no result within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [out[r] for r in range(world)]
