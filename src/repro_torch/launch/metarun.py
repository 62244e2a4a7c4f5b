"""One dispatch mode over a step run on the meta device: what the
dry-run reports in place of XLA's `cost_analysis()` and
`memory_analysis()`.

  flops   the products and attention of every op, by
          `torch.utils.flop_counter`'s formulas (FlopCounterMode's
          registry: mm, addmm, bmm, baddbmm, convolutions, the fused
          attentions); elementwise work is not counted, where XLA counts
          it too
  bytes   the bytes every op reads and writes: each tensor argument and
          each tensor result at its viewed size, view ops excluded
  moved   for each argument storage, the bytes ops read of it and the
          bytes they wrote into it in place, each at most its size (a
          gather reads at most the rows it returns, a scatter writes at
          most the rows it is given): what the step must move of its
          arguments (`MetaCounter.moved`)
  peak    the most bytes of live storages the run held at once, the
          argument storages apart (`MetaCounter.peak_bytes`), swept
          lazily: only an allocation can raise the peak, so dead
          storages are dropped only when the count would exceed it

An op whose schema neither mutates nor aliases an argument has its
result metadata, FLOPs and bytes memoized by its arguments' shapes,
strides, dtypes and other values: the meta kernels of many ops are
Python decompositions, and a recurrence's loop repeats the same calls
(the sLSTM's time steps).  A hit makes fresh result tensors with
`torch.empty_strided`.

While a counter is active it stands in for the models' `scan`
(`models/common.py`, the counterpart of JAX's `lax.scan`): the n steps
of a time loop (the sLSTM's recurrence, Mamba2's chunks) run as one
step on the meta device with its counts scaled by n, its backward
likewise; the other steps' activations are not held, so a cell with
such a loop reports a peak below what the loop would hold.

Ops whose result shapes depend on the data have no meta kernel; the
counter gives them their largest result: `unique_consecutive` keeps
every element (the embedding gradient's distinct rows, `_TakeRows`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.common import SCANS


def tensors_of(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of nested dicts, lists, tuples and QTensors."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif hasattr(tree, "data") and hasattr(tree, "scales"):
        yield tree.data
        yield tree.scales


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, (int, float, bool, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format)):
        return x
    raise TypeError(type(x))


def _pure(func) -> bool:
    """True when no argument or result of `func` is marked as mutated
    or aliased in its schema."""
    schema = func._schema
    return not any(a.alias_info is not None
                   for a in list(schema.arguments) + list(schema.returns))


_ACTIVE: List["MetaCounter"] = []


@contextlib.contextmanager
def scaled(n: int):
    """Count the ops run inside n times (no-op without a counter)."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None:
        yield
        return
    prev = c.scale
    c.scale = prev * n
    try:
        yield
    finally:
        c.scale = prev


class _Steps(torch.autograd.Function):
    """n steps of `fn(*[x[:, t] for x in seqs], *consts)` as one step
    counted n times; the result is the first step's output at every t."""

    @staticmethod
    def forward(ctx, n, fn, n_seq, *tensors):
        ctx.n, ctx.fn, ctx.n_seq = n, fn, n_seq
        ctx.save_for_backward(*tensors)
        with scaled(n):
            out = fn(*_first(tensors, n_seq))
        return out.unsqueeze(1).expand(out.shape[0], n,
                                       *out.shape[1:]).contiguous()

    @staticmethod
    def backward(ctx, grad):
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        ins = [x.detach().requires_grad_(nd)
               for x, nd in zip(_first(tensors, ctx.n_seq), need)]
        with torch.enable_grad():
            with scaled(0):             # a loop keeps its activations
                out = ctx.fn(*ins)
            want = [x for x in ins if x.requires_grad]
            with scaled(ctx.n):
                got = iter(torch.autograd.grad(out, want, grad[:, 0],
                                               allow_unused=True))
        grads = [next(got) if x.requires_grad else None for x in ins]
        for i in range(ctx.n_seq):
            if grads[i] is not None:
                grads[i] = grads[i].unsqueeze(1).expand(
                    tensors[i].shape).contiguous()
        return (None, None, None, *grads)


def _first(tensors, n_seq):
    return [x[:, 0] for x in tensors[:n_seq]] + list(tensors[n_seq:])


def scan_once(step: Callable, carry: Tuple[torch.Tensor, ...],
              xs: Tuple[torch.Tensor, ...],
              consts: Tuple[torch.Tensor, ...] = ()):
    """`models.common.scan` on the meta device, counted as its n steps
    (module docstring): every step has the same shapes, so one stands
    for all.  The carry comes back as it went in."""
    k = len(xs) + len(consts)
    ys = _Steps.apply(xs[0].shape[1],
                      lambda *a: step(tuple(a[k:]), *a[:k])[1], len(xs),
                      *xs, *consts, *carry)
    return carry, ys


def _unique_consecutive(x, return_inverse=False, return_counts=False,
                        dim=None):
    """Every element distinct: the largest result (dim None only)."""
    if dim is not None:
        raise NotImplementedError("unique_consecutive over a dim on meta")
    n = x.numel()
    return (x.new_empty((n,)),
            torch.empty(x.shape if return_inverse else (0,),
                        dtype=torch.int64, device=x.device),
            torch.empty((n if return_counts else 0,), dtype=torch.int64,
                        device=x.device))


_DATA_SHAPED = {torch.ops.aten.unique_consecutive.default:
                _unique_consecutive}

# ops that read only the rows their result holds of their source
_GATHERS = {torch.ops.aten.embedding.default,
            torch.ops.aten.index_select.default,
            torch.ops.aten.index.Tensor, torch.ops.aten.gather.default}
# ops that write only the rows their values hold into their target
_SCATTERS = {torch.ops.aten.index_put_.default,
             torch.ops.aten.index_copy_.default,
             torch.ops.aten.index_add_.default,
             torch.ops.aten.scatter_.src, torch.ops.aten.scatter_add_.default}
_VALUES = ("values", "source", "src")


class MetaCounter(TorchDispatchMode):
    """Counts one run's FLOPs, bytes and live-storage peak (module
    docstring).  `hold(tree)` names the argument storages first."""

    def __init__(self, memo: Dict = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self._args: Dict[int, int] = {}
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self._live_bytes = 0
        self.peak_bytes = 0
        self._memo = {} if memo is None else memo
        self._pure: Dict[Any, bool] = {}
        self.scale = 1
        self._aliasing = set()      # views the schema does not mark
        self.read: Dict[int, int] = {}      # argument storage -> bytes
        self.written: Dict[int, int] = {}   #   ops read / wrote in place

    def __enter__(self):
        _ACTIVE.append(self)
        SCANS.append(scan_once)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        SCANS.remove(scan_once)
        return super().__exit__(*exc)

    def hold(self, tree: Any) -> None:
        """Name the argument storages: apart from the peak; `read` and
        `written` keep the bytes ops take of them (`_note`)."""
        for t in tensors_of(tree):
            st = t.untyped_storage()
            self._args[st._cdata] = st.nbytes()

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    def _track(self, out: Any) -> None:
        for t in tensors_of(out):
            st = t.untyped_storage()
            k = st._cdata
            if k in self._args:
                continue
            seen = self._live.get(k)
            if seen is not None:
                if not seen[0].expired():
                    continue
                self._live_bytes -= seen[1]     # an address freed, reused
            n = st.nbytes()
            self._live[k] = (StorageWeakRef(st), n)
            self._live_bytes += n
            if self._live_bytes > self.peak_bytes:
                self._sweep()
                self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        pure = self._pure.get(func)
        if pure is None:
            pure = self._pure[func] = _pure(func)
        key = None
        if pure and func not in self._aliasing:
            try:
                key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
            except TypeError:
                key = None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            metas, single, flops, nbytes = hit
            outs = tuple(torch.empty_strided(shape, stride, dtype=dt,
                                             device="meta")
                         for shape, stride, dt in metas)
            out = outs[0] if single else outs
        else:
            out = _DATA_SHAPED.get(func, func)(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if pure and func not in self._aliasing:
                # a schema may not mark an alias (`_unsafe_view`)
                held = {t.untyped_storage()._cdata
                        for t in tensors_of((args, kwargs))}
                if any(t.untyped_storage()._cdata in held
                       for t in tensors_of(outs)):
                    self._aliasing.add(func)
            flops = 0
            packet = func._overloadpacket
            if packet in flop_registry:
                flops = int(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
            nbytes = 0
            if not func.is_view and func not in self._aliasing:
                nbytes = sum(_nbytes(t) for t in tensors_of(args)) + \
                    sum(_nbytes(t) for t in tensors_of(kwargs)) + \
                    sum(_nbytes(t) for t in tensors_of(out))
            if key is not None and func not in self._aliasing and all(
                    isinstance(t, torch.Tensor) and t.device.type == "meta"
                    for t in outs):
                self._memo[key] = (
                    [(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                    not isinstance(out, tuple), flops, nbytes)
        self.flops += flops * self.scale
        self.bytes += nbytes * self.scale
        if self._args:
            self._note(func, args, kwargs, out)
        self._track(out)
        return out

    def _note(self, func, args, kwargs, out) -> None:
        """Add the bytes `func` takes of each argument storage to `read`,
        or to `written` where its schema writes it: a tensor's viewed
        bytes, a gather's source at most its result's bytes."""
        if not any(t.untyped_storage()._cdata in self._args
                   for t in tensors_of((args, kwargs))):
            return
        params = func._schema.arguments
        pairs = list(zip(params, args)) + [(p, kwargs[p.name])
                                           for p in params
                                           if p.name in kwargs]
        rows = None
        if func in _GATHERS:
            rows = sum(_nbytes(o) for o in tensors_of(out))
        elif func in _SCATTERS:
            rows = sum(_nbytes(t) for p, a in pairs if p.name in _VALUES
                       for t in tensors_of(a))
        for p, a in pairs:
            for t in tensors_of(a):
                k = t.untyped_storage()._cdata
                if k not in self._args:
                    continue
                n = _nbytes(t)
                if rows is not None and p.name in ("self", "weight"):
                    n = min(n, rows)
                book = self.written if (p.alias_info is not None and
                                        p.alias_info.is_write) else self.read
                book[k] = book.get(k, 0) + n

    def moved(self) -> Dict[int, float]:
        """Each argument storage an op took -> the fraction of it ops
        read plus the fraction they wrote in place, each at most 1."""
        out = {}
        for k in set(self.read) | set(self.written):
            whole = self._args[k] or 1
            out[k] = min(1.0, self.read.get(k, 0) / whole) + \
                min(1.0, self.written.get(k, 0) / whole)
        return out
