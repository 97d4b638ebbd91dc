"""Device-neutral execution state — the paper's snapshot format.

A :class:`Snapshot` captures exactly what the paper's state-capture design
prescribes (§4.2 "State Representation"):

* an array of **per-thread virtual register files** — here, a dict mapping
  hetIR register name → ndarray of shape ``[num_blocks, block_size]``;
* the **program position** — not a machine PC but the *node index* in the
  segmented program (all threads of all blocks are aligned at a barrier);
* **loop counters** for barrier-containing loops (uniform scalars);
* **shared memory** contents per block (``[num_blocks, shared_size]``);
* **global memory** buffers.

Everything is stored as host numpy arrays, so a snapshot taken from any
backend (scalar interpreter, vectorized jnp, Pallas) can be re-instantiated
on any other — the cross-architecture migration property (§6.3).  The wire
format is a self-describing, versioned npz blob (``to_bytes`` /
``from_bytes``): the migration payload :func:`~repro_torch.core.runtime.migrate`
ships between sessions.  The snapshot records the ``opt_level`` its
``node_idx`` was taken at, because node indices address the *optimized*
segmented program (see :mod:`~repro_torch.core.segments`) and the destination
must re-run the deterministic :mod:`~repro_torch.core.passes` pipeline at the
same level to reconstruct an identical node list.  What a snapshot does
*not* carry is translated code: the destination's translations come from
its own :class:`~repro_torch.core.cache.TranslationCache` — warmed from a
persistent store when one is available (§4.2 cluster-lifetime JIT).
"""
from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

FORMAT_VERSION = 1


@dataclass
class Snapshot:
    program_name: str
    num_blocks: int
    block_size: int
    node_idx: int
    loop_counters: Dict[int, int]
    regs: Dict[str, np.ndarray]        # [num_blocks, block_size] each
    shared: Optional[np.ndarray]       # [num_blocks, shared_size] or None
    globals_: Dict[str, np.ndarray]    # buffer name -> host array
    scalars: Dict[str, object] = field(default_factory=dict)
    # pass-pipeline level the program was optimized at when the snapshot was
    # taken: node_idx indexes the *optimized* segmented program, so restore
    # must re-optimize at the same level (the pipeline is deterministic)
    opt_level: int = 0
    # launch-time specialization key — the (name, value) scalar bindings the
    # source engine optimized under; () = generic.  Restore re-binds them
    # verbatim (never re-consults the policy), so a mid-kernel checkpoint of
    # a specialized program reconstructs the identical node list on the
    # destination backend
    spec_key: tuple = ()
    # DeviceBuffer identity: buffer param name -> uid of the handle bound
    # at launch (None for raw host arrays).  Restore re-binds the live
    # buffer with a matching uid when one exists, so checkpoint/restore in
    # one session lands results in the *same* DeviceBuffer objects, and a
    # migration chain keeps stable buffer identity across hops
    buffer_uids: Dict[str, Optional[str]] = field(default_factory=dict)

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize to a self-describing npz blob (the migration payload)."""
        meta = {
            "version": FORMAT_VERSION,
            "program_name": self.program_name,
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "node_idx": self.node_idx,
            "opt_level": int(self.opt_level),
            "loop_counters": {str(k): int(v)
                              for k, v in self.loop_counters.items()},
            "scalars": {k: (float(v)
                            if isinstance(v, (float, np.floating))
                            else int(v))
                        for k, v in self.scalars.items()},
            "spec_key": [[str(k), (float(v)
                                   if isinstance(v, (float, np.floating))
                                   else int(v))]
                         for k, v in self.spec_key],
            "buffer_uids": {k: v for k, v in self.buffer_uids.items()},
            "reg_names": sorted(self.regs),
            "global_names": sorted(self.globals_),
            "has_shared": self.shared is not None,
        }
        arrays = {f"reg_{k}": np.asarray(v) for k, v in self.regs.items()}
        arrays.update({f"glb_{k}": np.asarray(v)
                       for k, v in self.globals_.items()})
        if self.shared is not None:
            arrays["shared"] = np.asarray(self.shared)
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Snapshot":
        with np.load(io.BytesIO(blob)) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            if meta["version"] != FORMAT_VERSION:
                raise ValueError(f"snapshot version {meta['version']} "
                                 f"!= {FORMAT_VERSION}")
            regs = {k: z[f"reg_{k}"] for k in meta["reg_names"]}
            globals_ = {k: z[f"glb_{k}"] for k in meta["global_names"]}
            shared = z["shared"] if meta["has_shared"] else None
        return cls(
            program_name=meta["program_name"],
            num_blocks=meta["num_blocks"],
            block_size=meta["block_size"],
            node_idx=meta["node_idx"],
            opt_level=int(meta.get("opt_level", 0)),
            spec_key=tuple((k, v) for k, v in meta.get("spec_key", [])),
            buffer_uids=dict(meta.get("buffer_uids", {})),
            loop_counters={int(k): v
                           for k, v in meta["loop_counters"].items()},
            regs=regs,
            shared=shared,
            globals_=globals_,
            scalars=meta["scalars"],
        )

    def nbytes(self) -> int:
        n = sum(v.nbytes for v in self.regs.values())
        n += sum(v.nbytes for v in self.globals_.values())
        if self.shared is not None:
            n += self.shared.nbytes
        return n
