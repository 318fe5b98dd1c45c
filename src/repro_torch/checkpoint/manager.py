"""Checkpointing: atomic, retention-managed, in the reference's layout.

The port's own copy of the reference ``repro.checkpoint.manager``, with
its own flattener in place of ``jax.tree_util``.  Layout (one directory
per step, the reference's byte for byte):

    <root>/step_000000123/
        manifest.json      # step, metadata, leaf paths, shapes, dtypes
        arrays.npz         # raw little-endian buffers, one entry per leaf

* **Paths** — a state is a tree of dicts, lists/tuples and array leaves
  (numpy arrays, torch tensors, Python scalars).  Leaves are visited as
  JAX flattens such a tree: dict keys in sorted order, sequences in
  order, ``None`` an empty subtree; a leaf's path joins its keys and
  indices with ``/`` (``carry/min_val``), a named tuple's fields by
  name (``opt/step``, ``opt/mu/...`` for an ``AdamWState``), as the
  reference's ``_path_str`` names them.  So a checkpoint the reference
  wrote restores here and the other way round.
* **Atomicity** — a save lands in ``step_X.tmp`` and is renamed only
  after the arrays and the manifest are fsync'd; the parent directory
  is fsync'd after the rename.  A crash never corrupts the latest
  checkpoint; it can leave ``*.tmp`` debris, swept at construction.
* **dtype fidelity** — buffers are raw bytes with the dtype's name in
  the manifest (npz cannot hold bf16); ``bfloat16`` comes back as a
  torch tensor.
* **Retention** — the ``keep`` most recent checkpoints are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree, prefix=()) -> list:
    """``[(path, leaf), ...]`` in the reference's (JAX's) leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for name, x in zip(tree._fields, tree)
                for kv in _flatten(x, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_bytes(leaf) -> tuple[bytes, tuple, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
        return arr.tobytes(), tuple(t.shape), name
    arr = np.asarray(leaf)
    return arr.tobytes(), arr.shape, str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape):
    # bf16 comes back as a torch tensor: numpy knows it only where
    # ml_dtypes happens to be imported.
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16
                                ).reshape(tuple(shape))
    return np.frombuffer(raw, np.dtype(dtype)).reshape(shape)


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        # Sweep *.tmp debris of crashed saves (the rename is atomic, so
        # debris is all a SIGKILL can leave).  Checkpoint roots have one
        # writer, so no live save owns a tmp dir while this runs.
        for name in os.listdir(self.root):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    step = int(name.split("_")[1])
                except (IndexError, ValueError):
                    continue
                # A step without its manifest is not a checkpoint.
                if os.path.exists(os.path.join(self._step_dir(step),
                                               "manifest.json")):
                    out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, metadata: dict | None = None
             ) -> str:
        """Atomically persist a tree of arrays."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "metadata": metadata or {},
                    "leaves": []}
        buffers = {}
        for i, (path, leaf) in enumerate(_flatten(state)):
            raw, shape, dtype = _to_bytes(leaf)
            key = f"leaf_{i:05d}"
            manifest["leaves"].append({"key": key, "path": path,
                                       "shape": list(shape),
                                       "dtype": dtype})
            buffers[key] = np.frombuffer(raw, np.uint8).reshape(-1)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **buffers)
        with open(npz_path, "rb") as f:
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # fsync the parent so the rename itself survives a crash
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._enforce_retention()
        return final

    def _enforce_retention(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def _entries(self, step: int):
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        buffers = np.load(os.path.join(d, "arrays.npz"))
        for entry in manifest["leaves"]:
            yield entry, _from_bytes(buffers[entry["key"]].tobytes(),
                                     entry["dtype"], entry["shape"])

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like`` (a tree of arrays or
        tensors), as CPU torch tensors."""
        arrays = [a for _, a in self._entries(step)]
        want = [leaf for _, leaf in _flatten(like)]
        if len(arrays) != len(want):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, target structure "
                f"has {len(want)}")
        for got, w in zip(arrays, want):
            if tuple(got.shape) != tuple(np.shape(w)):
                raise ValueError(
                    f"shape mismatch: ckpt {tuple(got.shape)} vs "
                    f"{tuple(np.shape(w))}")
        tensors = (torch.as_tensor(np.array(a) if isinstance(a, np.ndarray)
                                   else a) for a in arrays)
        return _unflatten(like, tensors)

    def restore_items(self, step: int) -> dict[str, np.ndarray]:
        """Restore a checkpoint as ``{path: array}`` without a like-tree
        (for state with data-dependent shapes, such as the streaming
        executor's Pareto front): shapes and dtypes exactly as stored."""
        return {entry["path"]: a for entry, a in self._entries(step)}

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step),
                               "manifest.json")) as f:
            return json.load(f)["metadata"]
