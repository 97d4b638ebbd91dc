"""Topology-neutral checkpoints, in the JAX package's format.

Port of ``src/repro/checkpoint/topology.py``.  A checkpoint stores
logical arrays, never per-device shards: ``<dir>/step_<N>/manifest.json``
and one ``.npy`` per leaf, written into ``.tmp_step_<N>`` and published by
one atomic rename.  A leaf's key is its path in the state tree (dict keys
sorted, list indices), ``/``-joined, and its file the key with ``__`` for
``/``; the manifest records each leaf's file, shape, numpy type string
and partition spec (``null``: one device has no shards) and the caller's
``extra``.
The files are the reference's, so a checkpoint written by either package
restores in the other: the port's trainer writes its parameters in the
JAX tree's layout (:func:`repro_torch.models.params_to_jax`).

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

MANIFEST = "manifest.json"
#: numpy's type string of a bf16 leaf (what the reference's np.save writes)
BF16_DESCR = "<V2"


# -- tree <-> flat path helpers ---------------------------------------------


def _flatten_with_paths(tree) -> Dict[str, Any]:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
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


# -- leaves <-> .npy ----------------------------------------------------------


def _host(leaf) -> Any:
    """A leaf on the host: a torch tensor on the CPU (copied off a device)
    or a numpy array."""
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
    arr = np.load(fname)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bf16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# -- save / restore -----------------------------------------------------------


def save(path, step: int, state, extra: Optional[dict] = None) -> None:
    """Write a checkpoint of ``state`` (a tree of dicts and lists whose
    leaves are torch tensors or numpy arrays)."""
    path = Path(path)
    tmp = path / f".tmp_step_{step}"
    final = path / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)

    flat = _flatten_with_paths(state)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in flat.items():
        fname = key.replace("/", "__") + ".npy"
        shape, dtype = _write_leaf(tmp / fname, _host(leaf))
        manifest["leaves"][key] = {"file": fname, "shape": shape,
                                   "dtype": dtype, "spec": None}
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


def restore(path, step: int):
    """Load the checkpoint of ``step``: (state, extra).  The state is the
    tree of the leaves' paths (lists where the saved tree had lists),
    its leaves torch tensors on the CPU; the specs are not read (one
    device)."""
    path = Path(path) / f"step_{step}"
    manifest = json.loads((path / MANIFEST).read_text())
    flat = {key: _read_leaf(path / info["file"])
            for key, info in manifest["leaves"].items()}
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

    def save(self, step: int, state, extra=None) -> None:
        self.wait()
        # the flat dict of paths is itself a tree with the same paths
        host = {k: _host(v) for k, v in _flatten_with_paths(state).items()}

        def work():
            try:
                save(self.path, step, host, extra=extra)
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
