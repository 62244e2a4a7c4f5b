"""Checkpoint / restore with atomic writes (PyTorch port of
`repro.train.checkpoint`), in the JAX package's on-disk format, so a
checkpoint written by either package restores in the other.

Layout:  <dir>/step_<N>/
           manifest.json       metadata, with the step and `keys`
           arrays.npz          one array per leaf, keyed by its path
         <dir>/LATEST          atomic pointer (written last)

A leaf's key joins its path with "/": dict keys, then a tuple's index
(`{"params": ..., "opt": tuple(adamw_state)}` gives `params/blocks/
attn/wq`, `opt/0` (the step), `opt/1/...` (mu), `opt/2/...` (nu)).
bfloat16 leaves are written as float32 (npz has no bfloat16) and cast
back to the dtype of the tree restored into.

  * step-atomic: LATEST flips only after the full step directory is in
    place — a crash mid-save leaves the previous checkpoint intact;
  * data cursor: the manifest carries what the caller puts in
    `metadata` (the trainer: data_seed, next_batch_index);
  * async: `save(..., blocking=False)` copies every leaf to host memory
    before the writer thread starts, so an in-place optimizer step that
    follows cannot change what is written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEPARATOR = "/"


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of nested dicts and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield _SEPARATOR.join(prefix), tree


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of the leaf (a copy even of a CPU tensor)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, tree: Tree,
         metadata: Optional[Dict] = None, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Snapshot `tree` to host and write <ckpt_dir>/step_<step>
    atomically; with blocking=False the write runs on a thread, which
    is returned."""
    arrays = {key: _to_host(leaf) for key, leaf in _paths(tree)}
    meta = dict(metadata or {})
    meta["step"] = step
    meta["keys"] = sorted(arrays)

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, like: Tree, step: Optional[int] = None,
            device=None) -> Tuple[Tree, Dict]:
    """Restore into the structure of `like` (tensors, possibly on the
    meta device: only shapes and dtypes are read; its tuples come back
    as tuples), each leaf at like's dtype on `device` (default: like's
    leaf's device).  `device` stands where JAX's takes `shardings`."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def build(t, prefix):
            if isinstance(t, dict):
                return {k: build(v, prefix + (str(k),))
                        for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                return tuple(build(v, prefix + (str(i),))
                             for i, v in enumerate(t))
            key = _SEPARATOR.join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(t.shape)}")
            return torch.from_numpy(arr).to(
                device=device if device is not None else t.device,
                dtype=t.dtype)
        out = build(like, ())
    return out, meta
