"""Checkpoints of the port's state trees with crash-safe commits
(counterpart of ``repro.checkpoint.checkpoint``).

Format: one ``.npz`` per tree (the soak runtime's carries and keys), its
arrays keyed by each leaf's path (``repro_torch.tree``), and a JSON
``manifest.json`` holding the step, each tree's structure and leaf keys,
and any extra fields.  ``restore`` rebuilds the tensors on the device of
the example tree it is given (or on ``device``); device -> npz -> device
round trips are exact for the int32, int64, bool and float32 leaves the
simulator holds.

Crash-safety contract (the soak runtime's resume path depends on it):

* **Atomic commit.**  ``save`` stages every file (npz trees, manifest,
  ``COMMITTED`` marker) in a ``<path>.tmp.<pid>`` sibling, fsyncs each
  file, then renames the staging directory onto ``path`` and fsyncs the
  parent: a reader never sees a half-written snapshot under ``path``, and a
  crash at any byte leaves at most a stale ``.tmp`` directory (``prune``
  sweeps those).
* **Committed gating.**  ``is_committed`` / ``latest`` surface only
  snapshots whose marker exists *and* whose manifest parses.
* **Transient-IO retry.**  ``save(..., retries=N)`` retries the whole
  staged commit with exponential backoff on ``OSError``.
* **Async error surfacing.**  ``save_async`` copies the tensors to the
  host synchronously, writes in a worker thread, and re-raises any worker
  exception from ``join()``.

Elastic re-shard (reference ``checkpoint.py:216-235``).  Under an active
``distrib.sharding.mesh_rules`` mesh, ``restore(..., axes=)`` places each
leaf whose logical axes are given as a ``DTensor`` on that mesh (the
placements ``resolve_spec`` / ``placements`` give for the saved shape),
whatever layout it was saved from; each rank reads only the block it owns
from the ``.npz`` (the arrays are stored uncompressed, so a block is a few
seeks and reads).  Leaves without axes, or with no mesh active, come back
as plain tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import (
    tree_flatten_with_path, tree_map_with_path, tree_structure, tree_unflatten_like,
)

_TMP_MARK = ".tmp."


def _host(tree):
    """The tree with every leaf a host numpy array (a copy of each tensor)."""
    return tree_map_with_path(
        lambda _, t: t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor)
        else np.asarray(t), tree)


def _dev(leaf):
    return leaf.device if isinstance(leaf, torch.Tensor) else "cpu"


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_once(path: str, step: int, trees: dict[str, Any], axes: Optional[dict],
               extra: Optional[dict]):
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}{_TMP_MARK}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        manifest = {"step": int(step), "trees": {}}
        for name, tree in trees.items():
            host = _host(tree)
            flat = tree_flatten_with_path(host)
            fpath = os.path.join(tmp, f"{name}.npz")
            np.savez(fpath, **flat)
            _fsync_path(fpath)
            manifest["trees"][name] = {"treedef": tree_structure(host), "keys": sorted(flat)}
        if axes is not None:
            manifest["axes"] = json.loads(json.dumps(axes, default=list))
        if extra:
            for k in extra:
                if k in manifest:
                    raise ValueError(f"extra manifest key {k!r} collides")
            manifest.update(extra)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        # the rename below is the single atomic commit point; the marker
        # gates readers of copied snapshot directories
        cpath = os.path.join(tmp, "COMMITTED")
        with open(cpath, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        _fsync_path(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save(path: str, step: int, trees: dict[str, Any], axes: Optional[dict] = None,
         extra: Optional[dict] = None, retries: int = 0, backoff_s: float = 0.05):
    """``trees``: ``{name: state tree}`` (tensors on any device, or numpy
    arrays); ``extra``: further JSON-able manifest fields.  ``retries`` > 0
    re-attempts the whole atomic commit with exponential backoff on
    ``OSError``."""
    for attempt in range(retries + 1):
        try:
            _save_once(path, step, trees, axes, extra)
            return
        except OSError:
            if attempt == retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))


class SaveHandle:
    """Handle on a background save: ``join()`` re-raises any worker
    exception instead of swallowing it."""

    def __init__(self, target, args, kwargs):
        self._exc: BaseException | None = None

        def run():
            try:
                target(*args, **kwargs)
            except BaseException as e:  # surfaced on join, never swallowed
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def join(self, timeout: float | None = None):
        self._thread.join(timeout)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def exception(self) -> BaseException | None:
        return self._exc


def save_async(path: str, step: int, trees: dict, axes=None, extra: Optional[dict] = None,
               retries: int = 0, backoff_s: float = 0.05) -> SaveHandle:
    """Copy every tree to the host now (the device state may change as soon
    as this returns), write in a background thread.  The handle's
    ``join()`` re-raises worker exceptions."""
    snapshot = {name: _host(tree) for name, tree in trees.items()}
    return SaveHandle(save, (path, step, snapshot),
                      {"axes": axes, "extra": extra, "retries": retries, "backoff_s": backoff_s})


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, "COMMITTED"))


def read_manifest(path: str) -> dict:
    """The snapshot's manifest (step, tree layouts, ``extra`` fields);
    raises on an uncommitted snapshot."""
    if not is_committed(path):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore(path: str, like: dict[str, Any], axes: Optional[dict] = None, device=None):
    """Trees shaped like ``like`` (``{name: example tree}``), each leaf a
    tensor on its example leaf's device (or on ``device``), with the saved
    values and dtypes.  With a mesh active (``distrib.sharding.mesh_rules``)
    and ``axes`` (``{name: logical-axes tree}``, a tuple of axis names per
    leaf), each leaf with axes is a ``DTensor`` on that mesh, this rank's
    block read from the file: the elastic re-shard path.  Returns
    ``(trees, step)``."""
    from repro_torch.distrib.sharding import active_mesh

    manifest = read_manifest(path)
    mesh = active_mesh()
    out = {}
    for name, tree in like.items():
        fpath = os.path.join(path, f"{name}.npz")
        flat_axes = (_flat_axes(axes[name]) if mesh is not None and axes and name in axes
                     else {})
        devs = {k: device if device is not None else _dev(t)
                for k, t in tree_flatten_with_path(tree).items()}
        if flat_axes:
            with zipfile.ZipFile(fpath) as zf:
                flat = {k: (_placed(zf, k, flat_axes[k], mesh, devs[k]) if k in flat_axes
                            else torch.as_tensor(_read_block(zf, k, None), device=devs[k]))
                        for k in devs}
            out[name] = tree_unflatten_like(tree, flat)
            continue
        with np.load(fpath) as data:
            arrays = tree_unflatten_like(tree, {k: data[k] for k in data.files})
        out[name] = tree_map_with_path(
            lambda p, a: torch.as_tensor(a, device=devs[p or "_"]), arrays)
    return out, manifest["step"]


def _flat_axes(axes_tree, prefix: str = "") -> dict:
    """``{leaf path: logical axes}`` of an axes tree (dicts, lists and
    tuples of subtrees; a leaf is a tuple of axis names and Nones)."""
    if isinstance(axes_tree, tuple) and all(a is None or isinstance(a, str) for a in axes_tree):
        return {prefix or "_": axes_tree}
    if not isinstance(axes_tree, (dict, list, tuple)):
        raise TypeError(f"axes at {prefix or '_'!r}: a leaf's axes are a tuple of axis names "
                        f"(or Nones), got {type(axes_tree).__name__} {axes_tree!r}")
    items = axes_tree.items() if isinstance(axes_tree, dict) else enumerate(axes_tree)
    out = {}
    for k, v in items:
        out.update(_flat_axes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _placed(zf: zipfile.ZipFile, key: str, logical_axes, mesh, device):
    """The saved leaf ``key`` as a ``DTensor`` on ``mesh``, placed by its
    logical axes under the active rules; only this rank's block is read."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distrib.sharding import contiguous_stride, placements, resolve_spec

    shape, _, _ = _header(zf, key)
    pl = placements(mesh, resolve_spec(logical_axes, shape))
    coord = mesh.get_coordinate()
    start, length = [0] * len(shape), list(shape)
    for m, p in enumerate(pl):  # DTensor's order: the lower mesh dimension is the outer split
        if p.is_shard():
            length[p.dim] //= mesh.size(m)
            start[p.dim] += coord[m] * length[p.dim]
    local = torch.as_tensor(_read_block(zf, key, (start, length)), device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=tuple(shape),
                              stride=contiguous_stride(shape))


def _read_header(f):
    """``(shape, fortran_order, dtype)`` from an open ``.npy`` stream,
    leaving it at the data."""
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    return read(f)


def _header(zf: zipfile.ZipFile, key: str):
    with zf.open(f"{key}.npy") as f:
        return _read_header(f)


def _read_block(zf: zipfile.ZipFile, key: str, block=None) -> np.ndarray:
    """The stored array ``key``, or its block ``(start, length)`` (one range
    per dimension): one seek and read per contiguous run of the C-ordered
    data (Fortran-ordered and 0-d arrays are read whole)."""
    with zf.open(f"{key}.npy") as f:
        shape, fortran, dtype = _read_header(f)
        if block is None or fortran or not shape:
            f.seek(0)
            arr = np.lib.format.read_array(f, allow_pickle=False)
            if block is None:
                return arr
            return arr[tuple(slice(s, s + n) for s, n in zip(*block))].copy()
        base = f.tell()
        start, length = block
        strides = [dtype.itemsize] * len(shape)  # C order, in bytes
        for d in range(len(shape) - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        # the innermost dimension that is cut: each run spans it and all after it
        k = max([d for d in range(len(shape)) if length[d] != shape[d]], default=0)
        out = np.empty(length, dtype=dtype)
        if out.size == 0:
            return out
        runs = out.reshape(-1, length[k] * strides[k] // dtype.itemsize)
        for i, idx in enumerate(np.ndindex(*length[:k])):
            off = sum((start[d] + j) * strides[d] for d, j in enumerate(idx))
            f.seek(base + off + start[k] * strides[k])
            runs[i] = np.frombuffer(f.read(runs.shape[1] * dtype.itemsize), dtype=dtype)
        return out


def _snapshot_step(base: str, d: str) -> Optional[int]:
    """The step of one snapshot directory, or None when it is not a usable
    snapshot (another name, uncommitted, or an unreadable manifest)."""
    if not d.startswith("step_") or _TMP_MARK in d:
        return None
    try:
        step = int(d.split("_", 1)[1])
    except ValueError:
        return None
    p = os.path.join(base, d)
    if not is_committed(p):
        return None
    try:
        with open(os.path.join(p, "manifest.json")) as f:
            json.load(f)
    except (OSError, ValueError):
        return None  # committed marker present but manifest unreadable
    return step


def latest(base: str) -> Optional[str]:
    """The newest committed, readable snapshot under ``base`` (or None)."""
    if not os.path.isdir(base):
        return None
    steps = []
    for d in os.listdir(base):
        step = _snapshot_step(base, d)
        if step is not None:
            steps.append((step, os.path.join(base, d)))
    return max(steps)[1] if steps else None


def prune(base: str, keep: int) -> list[str]:
    """Keep the newest ``keep`` committed snapshots under ``base``; delete
    older ones and any stale staging or uncommitted directory.  Returns the
    deleted paths."""
    if keep < 1:
        raise ValueError("refusing to prune every snapshot")
    if not os.path.isdir(base):
        return []
    committed: list[tuple[int, str]] = []
    doomed: list[str] = []
    for d in os.listdir(base):
        p = os.path.join(base, d)
        if not os.path.isdir(p):
            continue
        step = _snapshot_step(base, d)
        if step is not None:
            committed.append((step, p))
        elif d.startswith("step_") or _TMP_MARK in d:
            doomed.append(p)  # stale staging / interrupted save
    committed.sort()
    doomed.extend(p for _, p in committed[:-keep])
    for p in doomed:
        shutil.rmtree(p, ignore_errors=True)
    return doomed
