"""Carry the JAX package's parameters into the port's.

Input: a nested dict of numpy arrays, the JAX parameter tree with every
array turned into numpy by the caller.  A quantized leaf arrives as a
dict with exactly the keys {data, scales, bits, group, axis, orig_shape}
(the fields of `repro.quant.qarray.QTensor`); its packed bytes and f16
scales come over byte for byte, at any number of stacked leading dims:
a doubly stacked leaf such as the mLSTM's head-wise `wq`, (groups,
slstm_every - 1, nh, dh, dh) packed along dh into (groups, ..., nh,
dh / 2, dh) bytes, keeps its negative `axis`, and indexing the QTensor
(`qt[g][j]`) gives a layer's (nh, dh / 2, dh) stack.  For training,
`requires_grad=True` makes every float leaf of a float tree a leaf that
requires grad, and `adamw_state_from_numpy` carries the optimizer state
(step, mu, nu) across.  This module imports no JAX: the `jax -> numpy`
step belongs to the caller (the tests do it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.quant.qarray import QTensor

QTENSOR_KEYS = frozenset({"data", "scales", "bits", "group", "axis",
                          "orig_shape"})


def to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> torch with the same bytes.  bfloat16 arrays (ml_dtypes)
    cross through their 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_numpy_tree(tree: Any, device=None,
                    requires_grad: bool = False) -> Any:
    """Nested dict of numpy arrays (QTensor leaves as field dicts) ->
    the port's nested dict of tensors and QTensors on `device`; with
    `requires_grad` its float tensors require grad (trainable params)."""
    if isinstance(tree, dict):
        if set(tree) == QTENSOR_KEYS:
            return QTensor(data=to_tensor(tree["data"], device),
                           scales=to_tensor(tree["scales"], device),
                           bits=int(tree["bits"]), group=int(tree["group"]),
                           axis=int(tree["axis"]),
                           orig_shape=tuple(int(s) for s in
                                            tree["orig_shape"]))
        return {k: from_numpy_tree(v, device, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        t = to_tensor(tree, device)
        return t.requires_grad_(True) if requires_grad and \
            t.is_floating_point() else t
    raise TypeError(f"from_numpy_tree: unexpected leaf {type(tree)!r}")


def adamw_state_from_numpy(step: np.ndarray, mu: Any, nu: Any,
                           device=None):
    """The JAX `AdamWState` fields as numpy (the step, the moment trees)
    -> the port's `AdamWState` on `device`."""
    from repro_torch.train.adamw import AdamWState
    return AdamWState(step=to_tensor(np.asarray(step, np.int32), device),
                      mu=from_numpy_tree(mu, device),
                      nu=from_numpy_tree(nu, device))
