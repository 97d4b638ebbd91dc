"""Topology-neutral checkpoints, in the JAX package's format.

Port of ``src/repro/checkpoint/topology.py``.  A checkpoint stores
logical arrays, never per-device shards: ``<dir>/step_<N>/manifest.json``
and one ``.npy`` per leaf, written into ``.tmp_step_<N>`` and published by
one atomic rename.  A leaf's key is its path in the state tree (dict keys
sorted, list indices), ``/``-joined, and its file the key with ``__`` for
``/``; the manifest records each leaf's file, shape, numpy type string
and logical partition spec (the reference's JSON form: a list with one
entry per dimension, an axis name, a list of names or null; ``null`` for
a leaf saved without one) and the caller's ``extra``.
The files are the reference's, so a checkpoint written by either package
restores in the other, on a mesh with its specs: the port's trainer
writes its parameters in the JAX tree's layout
(:func:`repro_torch.models.params_to_jax`) with the specs of
:class:`repro_torch.parallel.MeshRules`, and :func:`restore` fits the
stored specs onto the mesh it restores to, as the reference does.

bf16 leaves: numpy has no bfloat16, and the reference's ``np.save`` of
one writes the type string ``'<V2'`` (2-byte opaque records).  The port
writes a bf16 tensor's bits the same way, with the ``'<V2'`` header, and
reads a ``V2`` leaf back as ``torch.bfloat16``.

``AsyncCheckpointer`` copies the state to the host before ``save``
returns (the snapshot barrier) and writes the files on a thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..parallel.sharding import distribute, gather_to, is_sharded, mesh_axes

MANIFEST = "manifest.json"
#: numpy's type string of a bf16 leaf (what the reference's np.save writes)
BF16_DESCR = "<V2"


# -- tree <-> flat path helpers ---------------------------------------------


def _flatten_with_paths(tree, spec_leaves: bool = False) -> Dict[str, Any]:
    """Leaves by ``/``-joined path; with ``spec_leaves`` a tuple is a leaf
    (a spec tree, whose specs are tuples)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, list) or (isinstance(node, tuple)
                                         and not spec_leaves):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def _unflatten(flat: Dict[str, Any]):
    """The tree of ``flat``'s paths: a node whose keys are 0 .. n-1 is a
    list (the JAX tree's lists of layer groups), any other a dict."""
    root: Dict = {}
    for key, leaf in flat.items():
        *path, name = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and sorted(out) == [str(i) for i in range(len(out))]:
            return [out[str(i)] for i in range(len(out))]
        return out
    return lists(root)


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(obj) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in obj)


# -- leaves <-> .npy ----------------------------------------------------------


def _host(leaf) -> Any:
    """A leaf on the host: a torch tensor on the CPU (copied off a device;
    a ``DTensor`` gathered to the first rank of its mesh, which every rank
    of the mesh must do together: None on the other ranks, which hold
    only their blocks) or a numpy array."""
    if isinstance(leaf, DTensor):
        leaf = gather_to(leaf, int(leaf.device_mesh.mesh.min()))
        if leaf is None:
            return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return np.asarray(leaf)


def _write_leaf(fname: Path, leaf) -> tuple:
    """Write one host leaf; returns (shape, numpy type string)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            with open(fname, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": BF16_DESCR, "fortran_order": False,
                        "shape": tuple(bits.shape)})
                f.write(bits.tobytes())
            return list(bits.shape), BF16_DESCR
        leaf = leaf.contiguous().numpy()
    np.save(fname, leaf)
    return list(leaf.shape), leaf.dtype.str


def _read_leaf(fname: Path) -> torch.Tensor:
    """One leaf, read straight into memory of torch's own (aligned as its
    tensors are: CPU matmuls round by the operands' alignment)."""
    fmt = np.lib.format
    with open(fname, "rb") as f:
        version = fmt.read_magic(f)
        shape, fortran, dtype = (fmt.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 fmt.read_array_header_2_0(f))
        if fortran:
            raise ValueError(f"{fname}: Fortran order is not supported")
        if dtype.kind == "V" and dtype.itemsize == 2:       # bf16 bits
            tdt = torch.bfloat16
        else:
            tdt = torch.from_numpy(np.empty(0, dtype)).dtype
        t = torch.empty(shape, dtype=tdt)
        buf = t.reshape(-1).view(torch.uint8).numpy()
        if f.readinto(buf) != buf.nbytes:
            raise ValueError(f"{fname}: truncated leaf")
    return t


# -- save / restore -----------------------------------------------------------


def save(path, step: int, state, specs=None, extra: Optional[dict] = None
         ) -> None:
    """Write a checkpoint of ``state`` (a tree of dicts and lists whose
    leaves are torch tensors, ``DTensor``s or numpy arrays).  ``specs``:
    the matching tree of partition specs (tuples), recorded for the
    restore to fit.  With ``DTensor`` leaves every rank of their mesh
    calls this together: each leaf is gathered to the mesh's first rank,
    which alone writes."""
    path = Path(path)
    flat = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
    if any(v is None for v in flat.values()):
        return
    tmp = path / f".tmp_step_{step}"
    final = path / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)

    flat_specs = _flatten_with_paths(specs, spec_leaves=True) \
        if specs is not None else {}
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in flat.items():
        fname = key.replace("/", "__") + ".npy"
        shape, dtype = _write_leaf(tmp / fname, leaf)
        manifest["leaves"][key] = {
            "file": fname, "shape": shape, "dtype": dtype,
            "spec": _spec_to_json(flat_specs[key])
            if key in flat_specs else None}
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish


def latest_step(path) -> Optional[int]:
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(m.group(1)) for p in path.iterdir()
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def fit_spec(spec, shape, axis_size: Dict[str, int]) -> tuple:
    """The reference's ``default_respec``: a stored spec fitted to a mesh
    of ``axis_size`` (name -> size).  Axes the mesh lacks are dropped; an
    entry left with one axis is kept where the axis divides the dimension
    (a tuple of several is kept as it is); no spec: replicated."""
    if spec is None:
        return ()
    fitted = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            fitted.append(None)
            continue
        axes = [a for a in (entry if isinstance(entry, tuple)
                            else (entry,)) if a in axis_size]
        n = 1
        for a in axes:
            n *= axis_size[a]
        fitted.append(tuple(axes) if len(axes) > 1 else
                      (axes[0] if axes else None)
                      if dim % max(n, 1) == 0 else None)
    return tuple(fitted)


def restore(path, step: int, mesh=None):
    """Load the checkpoint of ``step``: (state, extra).  The state is the
    tree of the leaves' paths (lists where the saved tree had lists).  On
    a mesh of several ranks (a ``DeviceMesh``) each leaf is a ``DTensor``
    placed by its stored spec fitted to the mesh (:func:`fit_spec`);
    otherwise the leaves are torch tensors on the CPU."""
    path = Path(path) / f"step_{step}"
    manifest = json.loads((path / MANIFEST).read_text())
    flat = {}
    for key, info in manifest["leaves"].items():
        t = _read_leaf(path / info["file"])
        if mesh is not None and is_sharded(mesh):
            spec = _spec_from_json(info["spec"]) if info["spec"] else None
            t = distribute(t, mesh, fit_spec(spec, t.shape,
                                             mesh_axes(mesh)))
        flat[key] = t
    return _unflatten(flat), manifest["extra"]


class AsyncCheckpointer:
    """Snapshot synchronously (to the host), persist asynchronously.  A
    leaf on a device is copied to the host before :meth:`save` returns; a
    leaf already on the host is written as it is, so the caller leaves it
    unchanged until :meth:`wait` (the reference's numpy leaves likewise)."""

    def __init__(self, path):
        self.path = Path(path)
        self._thread: Optional[threading.Thread] = None
        self._errors: list = []
        self.saved_steps: list = []

    def save(self, step: int, state, specs=None, extra=None) -> None:
        self.wait()
        # the flat dicts of paths are themselves trees with the same paths
        host = {k: _host(v) for k, v in _flatten_with_paths(state).items()}
        if any(v is None for v in host.values()):
            return          # another rank of the leaves' mesh writes
        flat_specs = _flatten_with_paths(specs, spec_leaves=True) \
            if specs is not None else None

        def work():
            try:
                save(self.path, step, host, specs=flat_specs, extra=extra)
                self.saved_steps.append(step)
            except Exception as exc:          # re-raised by wait()
                self._errors.append(exc)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the last save has written its files; raises what
        the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._errors:
                raise self._errors.pop()
