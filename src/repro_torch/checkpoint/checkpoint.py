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

The reference re-shards a restore onto a device mesh (``axes``); the port
runs on one card, so ``restore`` with ``axes`` raises (multi-GPU is
ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
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
    values and dtypes.  Returns ``(trees, step)``."""
    if axes is not None:
        raise NotImplementedError(
            "restore(axes=...) re-shards onto a device mesh; the port runs on one card "
            "(multi-GPU is ROADMAP.md queue 1 item 12)")
    manifest = read_manifest(path)
    out = {}
    for name, tree in like.items():
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            arrays = tree_unflatten_like(tree, {k: data[k] for k in data.files})
        devs = iter([device if device is not None else _dev(t)
                     for t in tree_flatten_with_path(tree).values()])
        out[name] = tree_map_with_path(lambda _, a: torch.as_tensor(a, device=next(devs)), arrays)
    return out, manifest["step"]


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
