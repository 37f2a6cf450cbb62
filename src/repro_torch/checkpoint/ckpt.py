"""Fault-tolerant checkpointing: atomic, verified, keep-k, async, elastic
(mirrors ``repro/checkpoint/ckpt.py``, with the same on-disk format).

- **Atomic**: a checkpoint is written to ``step_XXXX.tmp`` and renamed only
  after every array and the manifest are on disk, so a crash mid-write
  never corrupts the latest restorable state.
- **Verified**: the manifest records a crc32 per array; ``restore`` checks
  every byte it loads and raises :class:`CorruptCheckpointError` on any
  mismatch, unreadable file or unreadable manifest.
  ``restore_latest_verified`` walks checkpoints newest-first, quarantines
  corrupt ones as ``<dir>.corrupt`` and falls back to the previous intact
  one (DESIGN §9).
- **Keep-k**: older checkpoints are garbage-collected after a successful
  save (the newest k survive), under a per-directory lock that saves also
  hold, so gc never races an in-flight write.
- **Async**: ``save_async`` copies the state to host memory before it
  returns (the optimizer updates the state in place, so a later copy could
  see a half-updated step) and writes on a background thread; the first
  failure of a thread is re-raised by ``wait_pending()`` (or, once the
  thread has ended, ``check_pending()``).
- **Mesh-aware (elastic)**: arrays are stored whole (the global array) and
  the manifest records the save-time mesh factorization and each leaf's
  partition spec.  ``restore`` onto the same factorization gives each rank
  its blocks; onto a different one it raises :class:`MeshMismatchError`
  naming :func:`restore_resharded`, which verifies every crc32 in the
  source layout and lands each leaf through an explicit
  :class:`~repro_torch.core.linop.Repartition` plan.

Layout:  ``<dir>/step_<n>/manifest.json`` + ``arr_<i>.npy``.  The manifest
(``step``, ``mesh``, ``leaves[{key, file, shape, dtype, crc32, spec}]``)
and the files are the reference's byte for byte, so a checkpoint written
by either package restores in the other:

- keys are the reference's key paths, ``/``-joined and in its leaf order
  (dict keys sorted level by level); the port's flat dotted parameter
  names are split at ``.`` under each top-level key (``params/…``,
  ``opt/m/…``, ``opt/v/…``, ``opt/count``, ``step``, ``skipped_steps``);
- the Python-int counters (``step``, ``skipped_steps``, ``opt["count"]``)
  are written as 0-d int32 arrays, as the reference holds them, and read
  back as ints;
- a bfloat16 leaf is written as its 16-bit words under the npy descr
  ``'<V2'`` with manifest dtype ``"bfloat16"``, as ``np.save`` writes an
  ``ml_dtypes`` array, and read back by the manifest's dtype name (the
  reference's own ``restore(like=...)`` refuses such a leaf: it compares
  the loaded ``|V2`` with ``bfloat16``; ROADMAP, "Known caveats").

On a mesh (``policy`` given) every rank of ``policy.mesh`` calls each
function together.  A save assembles each leaf over the axes of its spec
(``core.linop.assemble``) and the mesh's first rank alone copies it to
the host and writes it; a restore reads each stored array on every rank
and keeps this rank's block (``core.compile.local_blocks``).  Verdicts are
agreed over the mesh by one max all-reduce of a one-bit flag, so every
rank restores the same step.

Host copies go through page-locked buffers (``tools/ckpt_io_probe_torch.py``
on an NVIDIA H100 80GB HBM3 machine: a device-to-host copy into pageable
memory ran at 2.4 GB/s, into pinned memory at 55 GB/s); the crc32 and the
file writes and reads of the leaves run on a thread pool (``zlib`` and
numpy's file I/O release the GIL).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..core import linop
from ..core import primitives as prim
from ..core.compile import local_blocks, resolve_parts


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed verification: checksum mismatch, unreadable
    array file, or unreadable manifest.  Recoverable: fall back to the
    previous intact checkpoint (``restore_latest_verified``)."""


class MeshMismatchError(ValueError):
    """A checkpoint saved under one mesh factorization was restored under
    a different one through the plain path.  A ValueError (NOT in the
    supervisor's RECOVERABLE set): a restart cannot fix a configuration
    disagreement; route the restore through :func:`restore_resharded`."""


_STEP_RE = re.compile(r"^step_(\d{8})$")
_IO_THREADS = min(8, os.cpu_count() or 1)

# The last save's and restore's timings on this rank, read by the card
# check (chip_smoke.py phase 14): "save" (the host snapshot: device-to-host
# copies, on a mesh the gathers too), "write" (the crc32 pass and the file
# writes of the background or synchronous write) and "restore" (the reads
# with their crc32 checks, and the host-to-device copies).
IO_STATS: dict = {}

# One lock per checkpoint directory: saves (sync or async) and the gc they
# trigger are serialized per directory.
_dir_locks: dict[str, threading.Lock] = {}
_dir_locks_guard = threading.Lock()


def _dir_lock(ckpt_dir: str) -> threading.Lock:
    key = os.path.abspath(ckpt_dir)
    with _dir_locks_guard:
        return _dir_locks.setdefault(key, threading.Lock())


# ---------------------------------------------------------------------------
# Keys: the reference's key paths over the port's trees.
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    """(path, leaf) for every leaf of nested dicts, each dotted key split
    into its components; None leaves are dropped, as in JAX."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + tuple(str(k).split(".")))
    elif tree is not None:
        yield prefix, tree


def _tree_paths(tree):
    """``(keys, leaves)`` in the reference's leaf order: ``jax.tree_util``
    sorts dict keys level by level, which is the order of the component
    tuples."""
    items = sorted(_paths(tree), key=lambda item: item[0])
    return ["/".join(p) for p, _ in items], [leaf for _, leaf in items]


def _rebuild(like, fn, prefix=()):
    """``like``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, prefix + tuple(str(k).split(".")))
                for k, v in like.items()}
    if like is None:
        return None
    return fn("/".join(prefix), like)


# ---------------------------------------------------------------------------
# Layouts: the save-time mesh and each leaf's spec.
# ---------------------------------------------------------------------------

def _mesh_factorization(policy) -> dict | None:
    """``{axis: size}`` of ``policy.mesh`` under the reference's axis
    names, or None without a mesh."""
    if policy is None:
        return None
    return linop.axis_sizes(policy.mesh)


def _param_specs(policy, parts) -> dict:
    """``{parameter name: PartitionSpec}`` of the resolved ``parts``."""
    if policy is None or parts is None:
        return {}
    return resolve_parts(parts, policy)


def _key_spec(key: str, specs: dict):
    """The spec of state leaf ``key``: a parameter's own, an optimizer
    moment its parameter's (``opt/<slot>/<name>``), a counter None."""
    parts = key.split("/")
    if parts[0] == "params":
        return specs.get(".".join(parts[1:]))
    if parts[0] == "opt" and len(parts) > 2:
        return specs.get(".".join(parts[2:]))
    return specs.get(".".join(parts))


def _json_spec(spec, ndim: int):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return [list(e) if isinstance(e, tuple) else e for e in entries]


def _leaf_specs(keys, leaves, policy, parts) -> list:
    """Each leaf's PartitionSpec on ``policy``'s mesh (replicated where
    none is declared), or all None without a mesh."""
    if policy is None:
        return [None] * len(keys)
    specs = _param_specs(policy, parts)
    out = []
    for key, leaf in zip(keys, leaves):
        spec = _key_spec(key, specs)
        if spec is None and isinstance(leaf, torch.Tensor) and leaf.ndim:
            if any(key.startswith(p) for p in ("params/", "opt/")):
                raise ValueError(f"no partition spec for state leaf {key}: "
                                 f"pass the parameters' parts")
        out.append(linop.PartitionSpec() if spec is None else spec)
    return out


def capture_layouts(state, policy=None, parts=None):
    """Save-time layout snapshot: ``(mesh_factorization, per-leaf specs)``
    as the manifest records them.  Port tensors carry no sharding, so the
    layout comes from ``policy`` (its mesh) and ``parts`` (the parameters'
    ``Partitioned`` declaration, e.g. ``models.pipeline_param_parts``);
    each optimizer moment takes its parameter's spec.  Without a mesh
    every spec is None."""
    keys, leaves = _tree_paths(state)
    return _layouts(leaves, _leaf_specs(keys, leaves, policy, parts),
                    policy)


def _layouts(leaves, specs, policy):
    return _mesh_factorization(policy), [
        None if spec is None else _json_spec(
            spec, leaf.ndim if isinstance(leaf, torch.Tensor) else 0)
        for spec, leaf in zip(specs, leaves)]


# ---------------------------------------------------------------------------
# Host copies and the npy files.
# ---------------------------------------------------------------------------

def _host(leaf):
    """``(array, dtype name)``: a host copy of the leaf as a numpy array,
    never a view of it (the optimizer updates the state in place).  A
    tensor on the card is copied into page-locked memory (the caller
    synchronises); bfloat16 is carried as its 16-bit words; a Python int is
    the reference's 0-d int32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = "bfloat16" if t.dtype == torch.bfloat16 else None
        if name:
            t = t.view(torch.int16)
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
        else:
            host = t.clone(memory_format=torch.contiguous_format)
        arr = host.numpy()
        return arr, name or str(arr.dtype)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.array(leaf, order="C")
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str):
    """Write ``arr`` as the reference's ``np.save`` does."""
    with open(path, "wb") as f:
        if dtype == "bfloat16":
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(arr.shape)})
            f.write(arr.data)
        else:
            np.save(f, arr)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded array as a CPU tensor of the manifest's dtype ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# Save.
# ---------------------------------------------------------------------------

def _writer(policy) -> bool:
    """True on the rank that writes: every rank without a mesh, the mesh's
    first rank on one."""
    if policy is None:
        return True
    return int(policy.mesh.mesh.flatten()[0]) == torch.distributed.get_rank()


def _agree(flag: int, policy) -> int:
    """The max of every rank's one-bit ``flag`` over ``policy.mesh``, read
    on the host by every rank (so it is also a barrier); ``flag`` itself
    without a mesh."""
    if policy is None:
        return int(flag)
    device = ("cuda" if policy.mesh.device_type == "cuda" else "cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    with prim.use_mesh(policy.mesh):
        prim.mesh_all_reduce_(t, "max")
    return int(t.item())


def _snapshot(state, policy, parts):
    """``(keys, host arrays, dtype names, layouts)`` of ``state``; on a mesh
    each leaf is assembled into its global array on every rank and only the
    writer keeps a host copy (the other ranks' arrays are None).  Complete
    when it returns."""
    t0 = time.perf_counter()
    keys, leaves = _tree_paths(state)
    specs = _leaf_specs(keys, leaves, policy, parts)
    layouts = _layouts(leaves, specs, policy)
    mine = _writer(policy)
    arrays, dtypes = [], []
    with torch.no_grad():
        for leaf, spec in zip(leaves, specs):
            if spec is not None and isinstance(leaf, torch.Tensor):
                leaf = linop.assemble(leaf, spec, policy.mesh)
            arr, dtype = _host(leaf) if mine else (None, None)
            arrays.append(arr)
            dtypes.append(dtype)
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for leaf in leaves):
        torch.cuda.current_stream().synchronize()
    IO_STATS["save"] = {"bytes": sum(a.nbytes for a in arrays
                                     if a is not None),
                        "snapshot_s": time.perf_counter() - t0}
    return keys, arrays, dtypes, layouts


def _write(ckpt_dir: str, step: int, snap, keep: int) -> str:
    """Write a snapshot atomically (``.tmp``, then rename) and gc."""
    keys, arrays, dtypes, (mesh_fact, specs) = snap
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    with _dir_lock(ckpt_dir):
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def one(i):
            _write_npy(os.path.join(tmp, f"arr_{i}.npy"), arrays[i],
                       dtypes[i])

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            t0 = time.perf_counter()
            crcs = list(pool.map(zlib.crc32, arrays))
            t1 = time.perf_counter()
            list(pool.map(one, range(len(keys))))
            t2 = time.perf_counter()
        IO_STATS["write"] = {"bytes": sum(a.nbytes for a in arrays),
                             "crc_s": t1 - t0, "write_s": t2 - t1}
        manifest = {"step": step, "mesh": mesh_fact, "leaves": [
            {"key": key, "file": f"arr_{i}.npy", "shape": list(arr.shape),
             "dtype": dtype, "crc32": crc, "spec": spec}
            for i, (key, arr, dtype, crc, spec) in enumerate(
                zip(keys, arrays, dtypes, crcs, specs))]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomicity boundary
        _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state, keep: int = 3, *, policy=None,
         parts=None) -> str:
    """Synchronous atomic save; returns the final checkpoint path.

    The manifest records the mesh factorization of ``policy`` and each
    leaf's spec under ``parts`` (:func:`capture_layouts`).  On a mesh the
    writer renames and then every rank passes one barrier, so no rank
    takes another step before the checkpoint is final.  A failed write
    (``OSError``) is agreed by that barrier, so every rank raises it."""
    snap = _snapshot(state, policy, parts)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    failure = None
    if _writer(policy):
        try:
            final = _write(ckpt_dir, step, snap, keep)
        except OSError as e:
            failure = e
    if _agree(failure is not None, policy):
        raise failure or OSError(f"the writer failed to write checkpoint "
                                 f"step {step}")
    return final


_pending: list[threading.Thread] = []
_async_errors: list[BaseException] = []
_pending_guard = threading.Lock()


def save_async(ckpt_dir: str, step: int, state, keep: int = 3, *,
               policy=None, parts=None):
    """Snapshot to host now; write on a background thread (on a mesh, the
    writer's).  The host copy is complete before this returns, so the
    in-place optimizer update that follows cannot reach it.  Failures on
    the thread are captured and the first re-raised by
    :func:`wait_pending` or :func:`check_pending`; finished threads are pruned on every call.
    Returns the thread (None on a rank that does not write)."""
    snap = _snapshot(state, policy, parts)
    if not _writer(policy):
        return None

    def target():
        try:
            _write(ckpt_dir, step, snap, keep)
        except BaseException as e:        # noqa: BLE001 — re-raised in wait_pending
            with _pending_guard:
                _async_errors.append(e)

    t = threading.Thread(target=target, daemon=True)
    with _pending_guard:
        _pending[:] = [p for p in _pending if p.is_alive()]
        _pending.append(t)
    t.start()
    return t


def settle(policy=None, fault: bool = False) -> bool:
    """Finish this rank's pending saves (``wait_pending``) and, on a mesh,
    wait until every rank of it has (one max all-reduce of ``fault``):
    afterwards every rank lists the same checkpoints.  Returns whether any
    rank passed ``fault`` (``fault`` itself without a mesh)."""
    wait_pending()
    return bool(_agree(fault, policy))


def wait_pending():
    """Join all outstanding async saves; re-raise the first failure."""
    with _pending_guard:
        threads = list(_pending)
    for t in threads:
        t.join()
    check_pending()


def check_pending():
    """Re-raise the first failure of a finished async save, without
    waiting for the running ones (:func:`wait_pending` waits)."""
    with _pending_guard:
        _pending[:] = [p for p in _pending if p.is_alive()]
        errors = list(_async_errors)
        _async_errors.clear()
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# Restore.
# ---------------------------------------------------------------------------

def _intact_steps(ckpt_dir: str) -> list[int]:
    """Steps of finalized checkpoints, ascending: a directory counts only
    when it matches ``step_<8 digits>`` exactly AND holds a manifest."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.isfile(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = _intact_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_verified(path: str, entry) -> np.ndarray:
    """np.load + crc32 check; any failure is a CorruptCheckpointError."""
    try:
        arr = np.load(os.path.join(path, entry["file"]))
    except Exception as e:
        raise CorruptCheckpointError(
            f"unreadable array {entry['file']} in {path}: {e}") from e
    want = entry.get("crc32")
    if want is not None:
        got = zlib.crc32(np.ascontiguousarray(arr))
        if got != want:
            raise CorruptCheckpointError(
                f"checksum mismatch for {entry['key']} in {path}: "
                f"crc32 {got} != manifest {want}")
    return arr


def _read_manifest(ckpt_dir: str, step: int | None):
    """(manifest, step, path), resolving ``step=None`` to the newest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except Exception as e:
        raise CorruptCheckpointError(
            f"unreadable manifest in {path}: {e}") from e
    return manifest, step, path


def _loaded(path, entries):
    """Yield each entry's verified array in order, read on the thread pool
    at most ``_IO_THREADS`` arrays ahead, so the host never holds the whole
    checkpoint."""
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        ahead = []
        for entry in entries:
            ahead.append(pool.submit(_load_verified, path, entry))
            if len(ahead) > _IO_THREADS:
                yield ahead.pop(0).result()
        for fut in ahead:
            yield fut.result()


def _land(key, like, arr, entry, spec, policy, device):
    """The stored global array ``arr`` as ``like``'s leaf: a Python int for
    an int counter, else this rank's block under ``spec`` (the whole array
    without a mesh) on ``device`` (else ``like``'s), its shape and dtype
    checked."""
    t = _to_tensor(arr, entry["dtype"])
    if not isinstance(like, torch.Tensor):
        if t.ndim:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs ()")
        return int(t)
    if spec is not None and policy is not None:
        t = local_blocks(spec, t, policy)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{tuple(t.shape)} vs {tuple(like.shape)}")
    if t.dtype != like.dtype:
        raise ValueError(
            f"dtype mismatch for {key}: checkpoint {entry['dtype']} vs "
            f"expected {like.dtype} — cast explicitly if the precision "
            f"change is intended")
    return t.to(like.device if device is None else device)


def _restore_into(path, manifest, like, policy, parts, device=None):
    """``like``'s tree from the checkpoint at ``path``, every array
    verified, each leaf cut to this rank's block under ``policy``;
    ``like=None`` gives ``{key: numpy array}`` of every stored leaf."""
    if like is None:
        entries = manifest["leaves"]
        return {e["key"]: a for e, a in zip(entries,
                                            _loaded(path, entries))}
    by_key = {e["key"]: e for e in manifest["leaves"]}
    keys, leaves = _tree_paths(like)
    missing = [k for k in keys if k not in by_key]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")
    specs = _leaf_specs(keys, leaves, policy, parts)
    t0, land_s, landed = time.perf_counter(), 0.0, {}
    for key, leaf, spec, arr in zip(keys, leaves, specs, _loaded(
            path, [by_key[k] for k in keys])):
        t1 = time.perf_counter()
        landed[key] = _land(key, leaf, arr, by_key[key], spec, policy,
                            device)
        land_s += time.perf_counter() - t1
    IO_STATS["restore"] = {
        "bytes": sum(int(np.prod(by_key[k]["shape"], dtype=np.int64))
                     * (_ITEMSIZE.get(by_key[k]["dtype"])
                        or np.dtype(by_key[k]["dtype"]).itemsize)
                     for k in keys),
        "read_verify_s": time.perf_counter() - t0 - land_s,
        "land_s": land_s}
    return _rebuild(like, lambda key, leaf: landed[key])


def restore(ckpt_dir: str, step: int | None = None, like=None, *,
            policy=None, parts=None, device=None):
    """Load a checkpoint, verifying every array against its manifest crc32.

    ``like`` (the port's state tree, or any nested dicts of tensors and
    ints) gives the structure, dtypes and devices; without it a
    flat ``{key: numpy array}`` comes back.  ``device``, where given, is
    where every tensor leaf lands, so ``like`` may hold ``meta`` tensors
    (shapes and dtypes without memory, as the supervisors pass).
    ``policy``/``parts`` give each rank its blocks on the CURRENT mesh,
    which must have the factorization the checkpoint was saved under:
    otherwise :class:`MeshMismatchError` names :func:`restore_resharded`.
    Raises
    :class:`CorruptCheckpointError` when the manifest or an array fails to
    load or verify, ``ValueError`` on a shape or dtype mismatch against
    ``like``.  Returns ``(state, step)``."""
    manifest, step, path = _read_manifest(ckpt_dir, step)
    saved_mesh = manifest.get("mesh")
    live_mesh = _mesh_factorization(policy)
    if saved_mesh and live_mesh and saved_mesh != live_mesh:
        raise MeshMismatchError(
            f"checkpoint step {step} was saved under mesh factorization "
            f"{saved_mesh} but the live mesh is {live_mesh} — plain restore "
            f"cannot carry state across meshes; use restore_resharded(), "
            f"which moves each leaf on an explicit Repartition plan")
    return _restore_into(path, manifest, like, policy, parts,
                         device), step


# ---------------------------------------------------------------------------
# Cross-mesh restore: per-leaf Repartition plans (the elastic path).
# ---------------------------------------------------------------------------

def _single_axis_layout(spec) -> linop.Layout | None:
    """The :class:`~repro_torch.core.linop.Layout` a recorded spec denotes:
    None or all-None entries -> replicated; one named axis at dim d ->
    stacked there; several -> None (the plan routes through the replicated
    space, the stored array being whole either way)."""
    if spec is None:
        return linop.Layout(None)
    placed = [(d, a) for d, a in enumerate(spec) if a is not None]
    if not placed:
        return linop.Layout(None)
    if len(placed) > 1 or not isinstance(placed[0][1], str):
        return None
    return linop.Layout(placed[0][1], placed[0][0])


@dataclass(frozen=True)
class LeafReshardPlan:
    """One leaf's movement plan for a cross-mesh restore.

    ``gather`` is the source-side leg ``Repartition(src -> replicated)``
    (materialized at save time: the stored array IS the global array),
    ``scatter`` the target-side leg ``Repartition(replicated -> dst)``,
    realized by each rank keeping its block.  ``bytes_moved`` counts the
    whole array off disk plus the resident target blocks; ``bytes_lower``
    the bytes that must be resident on the target mesh after any correct
    repartition."""

    key: str
    src: linop.Layout | None
    dst: linop.Layout | None
    gather: linop.LinearOp
    scatter: linop.LinearOp
    global_shape: tuple
    bytes_moved: int
    bytes_lower: int


_ITEMSIZE = {"bfloat16": 2}


def _plan_leaf(key, spec, dst_spec, sizes, shape, dtype) -> LeafReshardPlan:
    """One leaf's plan from its recorded spec onto ``dst_spec`` (JSON
    entries, or None) on a mesh of axis sizes ``sizes``."""
    src = _single_axis_layout(spec)
    dst = _single_axis_layout(dst_spec)
    gather = (linop.Repartition(src, linop.Layout(None))
              if src is not None else linop.Identity())
    scatter = (linop.Repartition(linop.Layout(None), dst)
               if dst is not None else linop.Identity())
    itemsize = _ITEMSIZE.get(dtype) or np.dtype(dtype).itemsize
    nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
    n_dev = int(np.prod(list(sizes.values()) or [1]))
    if dst is not None and dst.axis is not None:
        lower = nbytes * n_dev // sizes[dst.axis]
    elif dst_spec is not None and any(e is not None for e in dst_spec):
        lower = nbytes
    else:
        lower = nbytes * n_dev
    return LeafReshardPlan(key=key, src=src, dst=dst, gather=gather,
                           scatter=scatter, global_shape=tuple(shape),
                           bytes_moved=nbytes + lower, bytes_lower=lower)


def plan_reshard(ckpt_dir: str, policy=None, parts=None,
                 step: int | None = None,
                 like=None) -> list[LeafReshardPlan]:
    """Per-leaf Repartition plans for restoring onto ``policy``'s mesh
    under ``parts`` (the target layout).

    Pure planning: reads only the manifest and typechecks each leg's space
    signature, the gather leg under the SOURCE mesh's axis sizes and the
    scatter leg under the TARGET's (same-named axes may differ in size
    across a shrink).  ``policy=None`` plans a replicated landing.  The
    leaves are ``like``'s when given, else the manifest's."""
    manifest, step, _ = _read_manifest(ckpt_dir, step)
    src_sizes = manifest.get("mesh") or {}
    dst_sizes = _mesh_factorization(policy) or {}
    by_key = {e["key"]: e for e in manifest["leaves"]}
    if like is not None:
        keys, leaves = _tree_paths(like)
    else:
        keys = [e["key"] for e in manifest["leaves"]]
        leaves = [np.empty(e["shape"], np.int8) for e in manifest["leaves"]]
    dst_specs = _leaf_specs(keys, leaves, policy, parts)
    plans = []
    for key, leaf, dst_spec in zip(keys, leaves, dst_specs):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        plan = _plan_leaf(key, entry.get("spec"),
                          None if dst_spec is None
                          else _json_spec(dst_spec, len(entry["shape"])),
                          dst_sizes, entry["shape"], entry["dtype"])
        if plan.src is not None and plan.src.axis is not None:
            k = int(src_sizes.get(plan.src.axis, 1))
            local = list(plan.global_shape)
            local[plan.src.dim] //= k
            mid = plan.gather.space_map(
                linop.Space.stacked(plan.src.axis, plan.src.dim, local),
                {plan.src.axis: k})
        else:
            mid = linop.Space.replicated(plan.global_shape)
        if plan.dst is not None and plan.dst.axis is not None:
            plan.scatter.space_map(mid, dst_sizes)
        plans.append(plan)
    return plans


def restore_resharded(ckpt_dir: str, policy=None, parts=None,
                      step: int | None = None, like=None, device=None):
    """Cross-mesh restore: verify in the source layout, Repartition out.

    The elastic path: ``policy``/``parts`` lay the state out on the TARGET
    mesh, of any factorization and rank count (``policy=None`` lands every
    leaf whole).  Every array is crc32-verified as stored (the source
    layout's global bytes), then driven through its
    :class:`LeafReshardPlan`: the gather leg was materialized at save time,
    the scatter leg keeps this rank's block; ``device`` as in
    :func:`restore`.  Returns ``(state, step)``."""
    manifest, step, path = _read_manifest(ckpt_dir, step)
    plan_reshard(ckpt_dir, policy, parts, step, like)
    return _restore_into(path, manifest, like, policy, parts,
                         device), step


def quarantine(ckpt_dir: str, step: int) -> str:
    """Rename a bad checkpoint out of the restorable namespace:
    ``step_XXXXXXXX`` -> ``step_XXXXXXXX.corrupt`` (``.corrupt.N`` if
    taken), kept for forensics, invisible to ``latest_step``, ``restore``
    and gc.  Returns the new path."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    dst = src + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = src + f".corrupt.{n}"
    os.rename(src, dst)
    return dst


def restore_latest_verified(ckpt_dir: str, like=None, *, policy=None,
                            parts=None, quarantine_bad: bool = True,
                            logger=None, reshard: bool = False,
                            device=None):
    """Restore the newest checkpoint that passes verification.

    Walks finalized checkpoints newest-first; on
    :class:`CorruptCheckpointError` the bad directory is quarantined as
    ``.corrupt`` (when ``quarantine_bad``) and the previous one is tried
    (DESIGN §9).  ``reshard=True`` routes each candidate through
    :func:`restore_resharded` (the elastic supervisor's path); ``device``
    as in :func:`restore`.  Returns
    ``(state, step, quarantined)``, or None when no intact checkpoint
    exists (cold start).

    On a mesh every rank first finishes its pending saves and passes a
    barrier, so all ranks list the same checkpoints; each candidate's
    verdict is agreed by one max all-reduce of a one-bit flag (corrupt on
    any rank is corrupt on all), the writer quarantines, and a barrier
    follows: without this two ranks could restore different steps."""
    if policy is not None:
        settle(policy)
    quarantined: list[int] = []
    for step in reversed(_intact_steps(ckpt_dir)):
        got, err = None, None
        try:
            if reshard:
                got = restore_resharded(ckpt_dir, policy, parts, step,
                                        like=like, device=device)
            else:
                got = restore(ckpt_dir, step, like=like, policy=policy,
                              parts=parts, device=device)
        except CorruptCheckpointError as e:
            err = e
        if not _agree(err is not None, policy):
            state, got_step = got
            return state, got_step, quarantined
        got = None
        if logger:
            logger(f"checkpoint step {step} corrupt: "
                   f"{err if err is not None else 'on another rank'}")
        if quarantine_bad:
            if _writer(policy):
                quarantine(ckpt_dir, step)
            _agree(0, policy)
            quarantined.append(step)
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = _intact_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
