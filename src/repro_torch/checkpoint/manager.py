"""Checkpoint manager: atomic writes, async saves, validated restore.

The port's twin of the reference's ``repro/checkpoint/manager.py``, over a
FLAT mapping of named tensors (or numpy arrays and scalars) in place of a
JAX tree:

  * Atomic: a checkpoint is staged under ``<dir>/tmp.<step>`` and renamed to
    ``<dir>/step_<step>`` only after every leaf + the manifest are written —
    a preempted save can never corrupt the latest-valid pointer.
  * Async: ``save(..., blocking=False)`` COPIES every tensor to host memory
    before a background thread writes it, so the caller's next in-place
    update (the port's cache updates mutate their state) cannot change a
    leaf while it is being serialized.  On the CPU ``.cpu()`` of a tensor is
    the tensor itself, so the copy is explicit.
  * Self-validating restore: the manifest records each leaf's file, shape,
    dtype and an md5 of its first MiB; a checkpoint whose manifest or a
    leaf file is missing, or whose leaf no longer matches its shape, dtype
    or checksum, is invalid, and ``restore_latest`` walks checkpoints
    newest-first past any that are.

Leaves are written with ``np.save``.  ``restore`` returns a dict keyed like
its template: a tensor leaf comes back as a tensor on the template leaf's
device, anything else as a numpy array.  The reference's ``reshard_tree``
places a tree on a JAX mesh and has no counterpart here.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Mapping

import numpy as np
import torch


def _host(x: Any, copy: bool) -> np.ndarray:
    """A leaf as a host numpy array; ``copy`` forces fresh memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        return x.numpy()
    return np.array(x) if copy else np.asarray(x)


def _checksum(leaf: np.ndarray) -> str:
    return hashlib.md5(np.ascontiguousarray(leaf).tobytes()[:1 << 20]) \
        .hexdigest()


def _flat(tree: Mapping[str, Any]) -> list[tuple[str, Any]]:
    if not isinstance(tree, Mapping):
        raise TypeError(f"checkpoint trees are flat mappings of named "
                        f"tensors, got {type(tree).__name__}")
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            raise TypeError(f"leaf {key!r} is a mapping; flatten the names "
                            "(e.g. 'params/w') first")
    return list(tree.items())


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Mapping[str, Any],
             blocking: bool = True) -> None:
        host = {key: _host(leaf, copy=not blocking)
                for key, leaf in _flat(tree)}
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:012d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, leaf in host.items():
            fn = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), leaf)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(leaf.shape),
                "dtype": str(leaf.dtype), "checksum": _checksum(leaf)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _validate(self, path: str) -> dict | None:
        """The manifest if every leaf it lists is present and matches its
        shape, dtype and checksum; else None."""
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            return None
        try:
            with open(mf) as f:
                manifest = json.load(f)
            for meta in manifest["leaves"].values():
                fp = os.path.join(path, meta["file"])
                if not os.path.exists(fp):
                    return None
                leaf = np.load(fp)
                if (list(leaf.shape) != meta["shape"]
                        or str(leaf.dtype) != meta["dtype"]
                        or _checksum(leaf) != meta["checksum"]):
                    return None
            return manifest
        except (json.JSONDecodeError, KeyError, ValueError, OSError):
            return None

    def restore(self, step: int, template: Mapping[str, Any]) -> dict:
        """The checkpoint of ``step`` keyed like ``template``; a key the
        checkpoint lacks raises ``KeyError``."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        manifest = self._validate(path)
        if manifest is None:
            raise FileNotFoundError(f"no valid checkpoint at {path}")
        out = {}
        for key, leaf in _flat(template):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            out[key] = (torch.from_numpy(arr).to(leaf.device)
                        if isinstance(leaf, torch.Tensor) else arr)
        return out

    def restore_latest(self, template: Mapping[str, Any]
                       ) -> tuple[int, dict] | None:
        """Newest-first, skipping corrupt checkpoints (crash tolerance)."""
        for step in reversed(self.all_steps()):
            path = os.path.join(self.dir, f"step_{step:012d}")
            if self._validate(path) is not None:
                return step, self.restore(step, template)
        return None
