"""Checkpoints in ``nf_tpu``'s format (counterpart of
``nf_tpu/train/checkpoint.py``): a file either package writes, the other
reads.

The file is one ``.npz``: ``leaf_0 .. leaf_n`` in ``jax.tree_util``'s
flatten order of ``nf_tpu``'s ``TrainState(params, state, opt_state,
step)``, ``__step__``, and ``__structure__``, the JSON list of
``[keystr, shape, dtype]`` per leaf.  ``train_state_tree`` builds that
tree for the port's model and ``TrainState`` (``convert.variable_tree``
for the variables, in ``nf_tpu``'s layouts, a ``ScannedChain``'s stacked);
the optimizer state maps both ways:

* Adam: ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``,
  mu and nu torch's ``exp_avg`` / ``exp_avg_sq`` in the parameters'
  ``nf_tpu`` layouts, the count the per-parameter ``step`` torch keeps;
* RMSprop: ``(ScaleByRmsState(nu), ScaleByScheduleState(count))``;
* with weight decay, ``optax.chain``'s leading ``add_decayed_weights``
  entry (an empty state) before them;
* ``count`` and ``step`` int32 scalars.

A parameter the optimizer has not updated yet has zero moments.  After a
load, ``TrainState.step`` resumes the learning-rate staircase and
``Trainer.step_generator`` where the file left them.  ``load_checkpoint``
raises ``ValueError`` when the file's fingerprint differs from the
model's (another configuration, or an unrolled file into a scanned
model).  Writes are atomic (a temporary file, then ``os.replace``), and
only rank 0 writes when ``torch.distributed`` is initialized.

Under tensor parallelism (``parallel/sharding.py``) every rank holds its
slice of each split leaf and of its moments: ``save_checkpoint`` gathers
them over the model group into nf_tpu's full layout (every rank takes
part; rank 0 writes), and ``load_checkpoint`` hands each rank its slice.
"""
from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, NamedTuple

import numpy as np
import torch

from ..convert import Leaf, leaves, tree_map, variable_tree
from .trainer import RMSprop, TrainState


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByRmsState(NamedTuple):
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class EmptyState(NamedTuple):
    pass


class JaxTrainState(NamedTuple):
    """``nf_tpu.train.TrainState``'s fields, in its order."""
    params: Any
    state: Any
    opt_state: Any
    step: Any


class Scalar(Leaf):
    """An int32 scalar leaf read by ``get()`` and written by ``put(int)``."""

    def __init__(self, get, put=lambda value: None):
        super().__init__([], dtype=np.int32)
        self.get, self.put = get, put

    @property
    def shape(self):
        return ()

    def to_jax(self) -> np.ndarray:
        return np.asarray(self.get(), dtype=np.int32)

    def load(self, a, name: str) -> None:
        a = np.asarray(a)
        if a.shape != ():
            raise ValueError(f"{name}: shape {a.shape} does not fit ()")
        self.put(int(a))


class ShardedLeaf(Leaf):
    """A leaf whose tensors are this rank's slices along ``dim`` of the
    full tensors (tensor parallelism): nf_tpu's shape and array are the
    full ones."""

    def __init__(self, leaf: Leaf, dim: int, tp):
        super().__init__(leaf.tensors, leaf.perm, leaf.dtype, leaf.stack)
        self.dim, self.tp = dim, tp

    def _full_shape(self):
        s = list(self.tensors[0].shape)
        s[self.dim] *= self.tp.mesh.model
        return tuple(s)

    @property
    def shape(self):
        s = self._full_shape()
        return self.stack + (s if self.perm is None else tuple(s[i] for i in self.perm))

    def with_tensors(self, tensors) -> "ShardedLeaf":
        return ShardedLeaf(Leaf(tensors, self.perm, self.dtype, self.stack), self.dim, self.tp)

    def to_jax(self) -> np.ndarray:
        full = [self.tp.gather(t, self.dim) for t in self.tensors]
        return Leaf(full, self.perm, self.dtype, self.stack).to_jax()

    def load(self, a, name: str) -> None:
        full = [torch.empty(self._full_shape(), dtype=t.dtype) for t in self.tensors]
        Leaf(full, self.perm, self.dtype, self.stack).load(a, name)
        for t, f in zip(self.tensors, full):
            t.copy_(self.tp.slice_of(f, self.dim).to(t.device))


def _sharded(tree, model):
    """``tree`` with each leaf of split tensors as a ``ShardedLeaf``."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return tree

    def wrap(leaf, name):
        dim = tp.dims.get(id(leaf.tensors[0]))
        return leaf if dim is None else ShardedLeaf(leaf, dim, tp)

    return {kind: tree_map(wrap, tree[kind]) for kind in ("params", "state")}


def _moments(opt: torch.optim.Optimizer, params: Leaf, key: str, create: bool) -> Leaf:
    """The optimizer's ``key`` state of ``params``' tensors in their layout:
    zeros where it holds none (made and kept with ``create``)."""
    out = []
    for p in params.tensors:
        state = opt.state[p]
        if key not in state:
            if not create:
                out.append(torch.zeros_like(p))
                continue
            if isinstance(opt, torch.optim.Adam):
                state.setdefault("step", torch.tensor(0.0, dtype=torch.float32))
            state[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
        out.append(state[key])
    return params.with_tensors(out)


def _set_adam_count(opt, count: int) -> None:
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p]["step"] = torch.tensor(float(count), dtype=torch.float32)


def train_state_tree(model, ts: TrainState, create: bool = False) -> JaxTrainState:
    """``nf_tpu``'s ``TrainState`` of ``model`` and ``ts`` with a ``Leaf`` at
    every leaf.  ``create`` makes the optimizer's missing moments, so a
    load can write them."""
    var = _sharded(variable_tree(model), model)
    params = var["params"]
    opt = ts.optimizer
    covered = {id(t) for _, leaf in leaves(params) for t in leaf.tensors}
    if covered != {id(p) for p in model.parameters()}:
        raise ValueError("the optimizer's parameters are not the model's")

    def moments(key):
        return tree_map(lambda leaf, name: _moments(opt, leaf, key, create), params)

    schedule = ScaleByScheduleState(Scalar(lambda: ts.step))
    if isinstance(opt, torch.optim.Adam):
        count = Scalar(lambda: ts.step, lambda c: _set_adam_count(opt, c))
        inner = (ScaleByAdamState(count, moments("exp_avg"), moments("exp_avg_sq")),
                 schedule)
    elif isinstance(opt, RMSprop):
        inner = (ScaleByRmsState(moments("nu")), schedule)
    else:
        raise ValueError(f"no checkpoint form for {type(opt).__name__}")
    if opt.param_groups[0]["weight_decay"] > 0.0:
        inner = (EmptyState(), inner)

    def set_step(step):
        ts.step = step

    return JaxTrainState(params, var["state"], inner, Scalar(lambda: ts.step, set_step))


def structure_fingerprint(tree) -> list:
    """``[[keystr, shape, dtype], ...]`` per leaf, ``nf_tpu``'s
    ``_structure_fingerprint``."""
    return [[path, list(leaf.shape), str(leaf.dtype)] for path, leaf in leaves(tree)]


def _writer() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_checkpoint(path: str, model, ts: TrainState) -> None:
    """Write ``model`` and ``ts`` to ``path`` in ``nf_tpu``'s format (under
    tensor parallelism every rank gathers, rank 0 writes)."""
    sharded = getattr(model, "tensor_parallel", None) is not None
    if not (_writer() or sharded):
        return
    tree = train_state_tree(model, ts)
    flat = [leaf for _, leaf in leaves(tree)]
    payload = {f"leaf_{i}": leaf.to_jax() for i, leaf in enumerate(flat)}
    if not _writer():
        return
    payload["__step__"] = np.asarray(ts.step)
    payload["__structure__"] = np.asarray(json.dumps(structure_fingerprint(tree)))
    buf = io.BytesIO()
    np.savez(buf, **payload)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


@torch.no_grad()
def load_checkpoint(path: str, model, ts: TrainState) -> int:
    """Read ``path`` into ``model`` and ``ts`` (parameters, buffers,
    optimizer state, ``ts.step``); returns the file's ``__step__``.
    Raises ``ValueError`` when its structure differs from the model's."""
    data = np.load(path, allow_pickle=False)
    if "__structure__" in data:
        saved = json.loads(str(data["__structure__"]))
        current = structure_fingerprint(train_state_tree(model, ts))
        if saved != current:
            diffs = [f"  leaf {i}: saved {s} != current {c}"
                     for i, (s, c) in enumerate(zip(saved, current)) if s != c]
            if len(saved) != len(current):
                diffs.append(f"  leaf count: saved {len(saved)} != current {len(current)}")
            raise ValueError(f"checkpoint structure mismatch for {path!r} (different model "
                             f"config or layer order?):\n" + "\n".join(diffs[:20]))
    for i, (name, leaf) in enumerate(leaves(train_state_tree(model, ts, create=True))):
        leaf.load(data[f"leaf_{i}"], name)
    return int(data["__step__"])
