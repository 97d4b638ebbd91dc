"""Vectorized-warp backend — software SIMT in eager PyTorch.

The Tenstorrent "vectorized warp on a core" strategy (paper §4.4): every
block's threads become lanes of dense tensors ``[num_blocks, block_size]``
on the session's device; divergence is an explicit active mask; one
instruction stream serves all threads.  Each op is one eager PyTorch call
(no ``torch.compile``), through :mod:`~repro_torch.core.backends.semantics`
— which makes this backend the plain version of the CUDA segment kernels
on the same device.

Register contract (shared with interp and cuda): hetIR registers read as
**zero** until first written, and registers in the incoming state that the
segment does not write back pass through unchanged.  It writes back what
the CUDA kernel writes: the registers it defines that are live after it
(:func:`~repro_torch.core.liveness.segment_outputs`).
"""
from __future__ import annotations

from ..liveness import live_out, segment_outputs
from ..segments import SegNode
from .base import Backend, HostState, Launch
from .semantics import run_segment_plain, serial_segment


class VectorizedBackend(Backend):
    name = "vectorized"

    def run_segment(self, seg: SegNode, state: HostState,
                    launch: Launch) -> None:
        # nothing is translated, but the segment's block-order verdict is
        # computed once per segment and cached like a translation
        serial = self.cache.get_or_translate(
            self._cache_key(seg, launch), lambda: (serial_segment(seg), None))
        run_segment_plain(seg.stmts, state, launch, serial, self.device,
                          segment_outputs(seg, live_out(launch.program, seg)))
