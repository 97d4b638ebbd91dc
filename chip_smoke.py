#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It drives the port's main path — ``HetSession.load`` →
``Function.launch_async`` → ``Engine`` → ``CudaBackend.run_segment`` → the
translated CUDA segment kernels — and holds every result against the plain
version of the kernels (the eager-PyTorch ``vectorized`` backend on the same
card) and against the NumPy oracles:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the ``nvcc`` build of every segment library used below (one ``nvcc``
   per optimized program and lanes a thread) and of the six hand-written
   kernels of ``repro_torch.kernels`` (one ``nvcc`` per source), in one
   batch that runs one ``nvcc`` per CPU core at a time, with ``ptxas``'s
   registers and spills of every hand-written kernel's builds;
1. all 17 suite and 4 zoo kernels at their canonical launch, at O0 and
   OPT_MAX: bits equal to the plain version on the card and to the NumPy
   interpreter on the CPU (NaN compared as NaN), within 1e-5 of the suite
   oracles and bit-equal to the zoo oracles; ``block_stats`` equal to the
   verdicts pinned below (checked against the JAX reference by the CPU
   tests); then the one-op edge-grid programs of
   ``repro_torch.core.edge_grids`` (DIV/MOD/shifts/casts/MIN/MAX on edge
   values, folds of ``-0.0``, folds and votes under divergence, atomic and
   store order, shuffles), bits equal to the plain version and the
   interpreter; then the programs with cross-lane ops (folds, scans,
   votes, ``REDUCE_MAX`` ties, atomics, shuffles, and the suite's
   reduction, scan, vote and dot product) in blocks of 2048 lanes, two to
   a thread of the scalar kernels, bits equal likewise;
2. full width, scalar path: one ``attn_decode`` step at Llama 3.2 3B's 24
   query heads of width 128 over a 4096-token window (K and V 48 MiB each),
   bits equal to the zoo oracle and to the plain version; then a second
   launch paused after 3 segments, checkpointed, restored in a CPU
   ``vectorized`` session, advanced 2 segments there, migrated back to the
   card and finished — bits unchanged; the step must have run a segment
   kernel that staged its K tile in shared memory and one that folded
   ``REDUCE_MAX`` by a shuffle tree (``CudaBackend.scalar_paths``);
3. full width, block path: ``vadd`` over 2^24 elements, whose block kernel
   must move no register array (per-segment liveness): the bytes per
   element its slots imply are printed;
4. times: one launch of 2 and of 3 (median over warm launches, CUDA
   events), the device time of its segment kernels alone, their plain
   versions, one PyTorch call computing the same function as a yardstick,
   and each kernel's bound; then one launch of each under
   ``torch.profiler``, with the device time of every kernel it ran (the
   segment kernels and the engine's copies) and the device's busy share.

5. the kernel library (``repro_torch.kernels``) at full width, through
   its user entry points (the ``autograd.Function`` ops): flash attention
   at Llama 3.2 3B's prefill (24 heads of 128 over 4096 tokens, causal,
   bf16 on the wgmma/TMA kernel and f32 on the CUDA-core one, each with
   its own launch count) and recurrentgemma-2b's local attention (10
   heads of 256, window 2048, bf16 and f32); the MoE grouped matmul at granite-moe-3b-a800m's
   experts (40 x 1024 rows x 1536 -> 512, seeded counts with an empty and
   a full expert; bf16 on the wgmma/TMA kernel, f32 on the CUDA-core one,
   each with its own launch count); the RG-LRU scan at recurrentgemma-2b's
   width (4096 steps x 2560 channels, bf16); the mLSTM chunk kernels at
   xlstm-125m's width (32 batch-heads x 4096 steps, dk = dv = 384, f32,
   bt 128), with the operations they execute against the bound's; and the
   domain the port repaired: bf16 attention that TMA cannot load (d =
   100, 4 bytes off 16-byte alignment: the CUDA-core kernel's bf16
   build), a head of 320 (its wide build), the mLSTM with chunks of 256
   and keys of 704.  Each result is held against the kernel's plain version and
   the torch oracle on the card, at the JAX tests' tolerances in the
   working type (grouped matmul 5e-2 bf16, 1e-4 f32) — except bf16
   attention, held to one bf16 step (``BF16_ATTN_TOL``): at 4096 tokens
   its outputs are near 0.03, so the tests' 2e-2 would hide a mask error; each attention case also checks
   that oracles with a planted mask error (a band one key short or long,
   late rows missing their first kv tile) fall outside its tolerance;
   empty experts must be exact zeros, the scan bit-equal,
   the mLSTM kernels at bt 32 within 1e-3 of bt 128 and executing at most
   1.15 times the bound's operations; one small gradient per
   op through its ``autograd.Function`` against autograd of the oracle;
   and ``het_kernel`` runs a suite program on the card bit-equal to
   ``het_kernel_ref``.

6. the runtime around the kernels, on the card, over the CUDA segment
   kernels: (a) a fresh process on an empty local ``DiskStore`` removes
   the segment libraries of the 21 programs at O0 and OPT_MAX from the
   build directory and builds them (one ``nvcc`` per module, through the
   translation cache), and a second fresh process, the libraries removed
   again, restores every module from the store with no ``nvcc`` — both
   run every canonical launch bit-equal to the interpreter; (b) three
   fresh processes started together on one ``SharedStore`` fabric, each
   with an empty build directory of its own, run one ``nvcc`` per module
   between them, fetch every module they did not build, and give the same
   bits; (c) ``ServingFrontEnd`` on a ``cuda`` session with the
   JAX package's serving smoke (1200 launches from 8 weighted tenants,
   fair shares within 15 %, >= 90 % steady-state pool reuse, p99 under
   its SLO, an oversubscribed phase that sheds and loses nothing), every
   output bit-equal to the interpreter, p50/p99 to the device event after
   each request's last segment, and the device's busy share from a
   profiled run; (d) a ``FleetCoordinator`` of ``cuda``, ``cuda`` and
   ``interp`` workers with a retry-queue directory: worker 0 is killed by
   ``kill -9`` at the ``mid-kernel`` fault point and its launches replay,
   worker 1 is drained to the ``interp`` worker by checkpoint/restore
   across backends, every launch finishes bit-equal to the interpreter
   with none lost and none acknowledged twice; the drain's checkpoint,
   transfer and restore milliseconds.  The segment-kernel launches of
   each part are counted where they happen (in the child processes and
   the fleet's worker) and printed; the kernels line carries them as
   ``phase6_launches``.

7. the model stack's serving path at full width: granite-moe-3b-a800m
   (32 layers of attention and a 40-expert MoE, 3,298,985,472 parameters
   in bf16 drawn on the card from a seeded ``torch.Generator``) served by
   ``repro_torch.launch.serve`` at batch 4, prompt 1024 and 32 steps:
   (a) the prefill's and the decode's milliseconds, tokens/s, the launch
   counts split at the end of the prefill (32 ``flash_attention_sm90``
   and 96 ``moe_gmm_sm90`` launches, then three grouped matmuls a layer
   and step, whose route the decode's one-row capacity takes), one
   prefill and one decode step under ``torch.profiler`` (device busy
   share, each kernel's device time and share), the host time of the
   decode step's ``moe_gmm_sm90`` launch calls and the bounds of both;
   (b) a second, identical run whose layers capture a seeded sample of 8
   flash attention and 8 grouped matmul calls of the prefill and 8 of
   the decode, each held against its plain version at phase 5's
   tolerances, rows past the counts (empty experts) exact zeros; the
   kernel, its plain version and the PyTorch call timed at the model's
   shapes; (c) the same weights in f32: a prefill and a decode step on
   the f32 kernels, bit-equal over two runs (the MoE combine adds in a
   fixed order), against the same run with the harness patching the
   layers' two ops to their plain versions, logits within
   ``F32_MODEL_TOL`` and the same greedy tokens, and within it again
   when the kernels' run takes the plain run's expert choices (the two
   runs' routing flips, where a token's K-th and (K+1)-th router logits
   nearly tie, are printed), while the queries rotated one position late
   and two experts swapped fall outside it.

8. the recurrent families on the serving path at full width and depth,
   phase 7's three parts for two models (seeded random weights drawn on
   the card): recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention
   with window 2048; bf16) at batch 2 over a prompt of 3072, past the
   window, so that the windowed flash mask and the ring cache's roll are
   on the path, and xlstm-125m's production profile
   (``configs.get_optimized_config``: 6 chunked mLSTM, 6 sLSTM; f32) at
   batch 8 over 2048 (32 batch-heads in 16 chunks of 128), 32 steps each,
   through ``repro_torch.launch.serve``: (a) prefill and decode
   milliseconds, tokens/s, the launch counts split at the end of the
   prefill (8 flash attention and 18 ``rglru_scan``, then 18
   ``rglru_scan`` a decode step and nothing else; 6 ``mlstm_chunk`` and
   none in the decode), the busy share and each kernel's device time of
   a profiled prefill and decode step, the host time of the sLSTM layers'
   per-step loop, the bounds of both; (b) a second, identical run whose
   layers capture a seeded sample of the flash, ``rglru_scan`` (prefill
   and decode) and ``mlstm_chunk`` calls, each held against its plain
   version at phase 5's tolerances (``rglru_scan`` bit-equal, f32 from a
   non-zero ``h0``), and the kernel, its plain version and (flash) SDPA
   with a band mask timed at the model's shapes; (c) a prefill and a
   decode step in f32 on the kernels against the same run on the plain
   versions (xlstm-125m's first ``P8_XLSTM_F32_LAYERS`` blocks), logits
   within ``P8_MODELS``'s tolerance (xlstm-125m's
   ``XLSTM_FLOOR_MULT`` times the rounding floor measured in the same
   run) and the same greedy tokens, while the RG-LRU decode step's ``h0``
   dropped, the mLSTM's forget gates one step late, its prefill state
   handed on in the empty state's scaling and, with q and k 8 times
   larger so that |q·n| passes 1, the normalizer's column of ones zeroed
   fall outside it.

9. the encoder–decoder family on the serving path at full width and
   depth: whisper-large-v3 (32 encoder and 32 decoder layers, d_model
   1280, 20 heads of 64, 1,603,097,600 parameters in bf16 drawn on the
   card from a seeded ``torch.Generator``) served by
   ``repro_torch.launch.serve`` at batch 4 with 1500 frames
   (``WHISPER_CROSS_LEN``, 30 s of audio), a text prompt of 64 tokens and
   32 steps, phase 7's three parts: (a) prefill and decode milliseconds,
   tokens/s, the launch counts split at the end of the prefill (96
   ``flash_attention_sm90``: 32 bidirectional encoder, 32 causal decoder
   and 32 cross-attention calls; then 32 a decode step, the
   cross-attention of one query against 1500 keys, and nothing else), the
   head-major cross cache, the busy share and flash's device time of a
   profiled prefill and decode step, the bytes the flash wrapper copies
   to contiguous tensors, the bounds of both; (b) a second, identical run
   whose flash calls are sampled (8 encoder, 8 cross prefill, 8 cross
   decode), each held against the plain version at ``BF16_ATTN_TOL``, and
   the kernel, its plain version and SDPA (no mask) timed at the
   encoder's and the cross decode's shapes; (c) the same weights in f32:
   a prefill and a decode step on the f32 kernel against the plain
   version, logits within ``F32_MODEL_TOL`` and the same greedy tokens,
   while the encoder run causally, each decoder layer's decode step on
   the next layer's cross k/v and a zeroed cross cache fall outside it.

10. the training path at full width: granite-moe-3b-a800m (32 layers,
   bf16 weights and f32 AdamW moments, 33 GB of state) trained by
   ``repro_torch.runtime.Trainer`` (seed 0, remat: each block recomputed
   in the backward pass) on batches of 4 x 1024 tokens: (a) 6 steps of
   ``Trainer.run`` with a checkpoint after the 3rd (the JAX package's
   format, about 33 GB): milliseconds a step, tokens/s, peak memory, the
   launches of every step (64 ``flash_attention_sm90`` and 192
   ``moe_gmm_sm90``), one profiled step (busy share, the kernels' device
   time) against the step's bound, and one more step whose launches are
   split at the end of the forward (32 and 96, then the same again in the
   backward: the recompute; the kernels' own backward passes recompute
   through their oracles and launch none); a fresh ``Trainer`` restores
   the checkpoint, its state bit-equal to the saved one (checksums of
   every tensor's bits), and its steps' losses bit-equal to the
   uninterrupted run's; (b) 8 steps of ``make_train_step`` on one
   repeated batch (warmup 1) must lower the loss by ``FIT_MARGIN``; (c)
   one f32 train step at full width and 4 layers on the f32 kernels
   against the same step on the plain versions: loss, gradient norm,
   every parameter's gradient and update within ``F32_TRAIN_TOL``, while
   the aux term dropped, the aux term divided by the number of layers
   (a mean where the reference sums) and flash run non-causally fall
   outside them.

11. the multi-device layer on the card, whose one device is the ``(1,
   1)`` mesh (``repro_torch.parallel.MeshRules`` on ``cuda:0``): (a)
   granite-moe-3b-a800m at phase 7's shapes (batch 4 x 1024, bf16) served
   by ``make_prefill_step`` and ``make_serve_step`` with the rules, its
   logits and tokens bit-equal to ``Model.prefill`` /
   ``Model.decode_step`` (phase 7's ``serve.generate``), and one step of
   ``make_train_step(rules)`` bit-equal (loss, gradient norm, checksums of
   the updated state) to the step without rules (phase 10's), with 32
   ``flash_attention_sm90`` and 96 ``moe_gmm_sm90`` launches in the
   prefill and 64 and 192 in the step; (b) live migration of the whole
   job between the card and the host: ``Trainer`` runs 4 steps at phase
   10's batch (the reference), then a fresh one runs 2, ``resize``s onto
   the host and back onto the card (the seconds and bytes of each move,
   the state's checksums equal on both sides of each move) and runs 2
   more, losses bit-equal to the reference's; (c) the same in f32 at full
   width and 2 layers on batches of 1 x 128: a step on the card, a step
   on the host (the plain versions), a step on the card, within
   ``F32_TRAIN_TOL`` of 3 steps on the card, while a resize that
   re-initializes AdamW's moments falls outside it.

12. the production dry run's one-card cell (``repro_torch.launch.
   dryrun.lower_cell`` on the ``(1, 1)`` mesh): phase 10's train step
   (granite-moe-3b-a800m, bf16, 4 x 1024, remat, AdamW) traced on
   ``meta`` under the op counter, which launches nothing; it prints the
   counted FLOPs, bytes, ``state_bytes_per_device``, the predicted peak of
   live bytes and the roofline terms (H100 datasheet rates).  Then phase
   10's job takes two steps on the card: its state's bytes (parameters,
   ``m``, ``v``) must equal the predicted ``state_bytes_per_device``, and
   the second step's time and ``torch.cuda.max_memory_allocated`` (above
   what the process held before the phase) are printed beside the
   roofline and the predicted peak, with the step's launches
   (``dryrun_path``).  On ``meta`` flash attention and the
   grouped matmul run their plain math (the JAX model's, which the
   reference's dry run counts); on the card, their kernels.

13. the split over a mesh, on the card's one device: each rank's share
   of a split layer is a function of the rank's index and the split's
   size (``repro_torch.models.layers``' share functions, which the mesh
   path calls with its own index); ``repro_torch.parallel.shares`` calls
   them for every index in turn and puts the shares together as the
   collectives do.  (a) granite-moe-3b-a800m's MoE layer at full width,
   bf16, at phase 7's prefill batch (4 x 1024 tokens, capacity 1024): the
   three expert products on the whole capacity buffer against the same
   on 2, 4 and 16 capacity slices with offset counts, each slice on the
   wgmma kernel, concatenated bit-equal; the same on the f32 kernel; the
   layer from the shares of ``(data, model)`` meshes (2, 2) and (4, 4)
   (EP: granite's 40 experts divide them, the capacity stays whole) and
   (2, 16) and (4, 16) (expert-TP: the capacity in 2 and 4 slices)
   against the one-device layer at phase 7's bf16 bar, and (4, 16) in f32
   at ``F32_MODEL_TOL``; (b) xlstm-125m's production profile at full
   width, f32, phase 8's batch (8 x 2048): ``mlstm_chunk`` on each head's
   384 value columns in 1, 2 and 4 blocks, each with its own column of
   ones, concatenated, against the whole launch (bit-equal, or within
   ``MLSTM_F32_TOL``, the difference printed); the chunked mLSTM and the
   sLSTM (plain per-step loop: no kernel) on 2, 4 and 16 ``model`` ranks
   (heads; on 16, a head's value columns in 4 blocks and the sLSTM's 4
   heads each repeated) against one device within ``MLSTM_F32_TOL`` (the
   sLSTM's largest error over its allowance printed, and every error
   beside one device's f32 loop's error against an f64 run of it); each
   kernel also against its plain version; (c) phase 12's peak within
   ``PEAK_TOL`` of its prediction (phase 11 (a) and phase 12's state
   bytes are checked in those phases).  The mesh checks run the layers'
   own mesh code (``moe_ffn_global``, the mixers) on every rank of a
   simulated mesh, whose collectives exchange tensors in memory
   (``repro_torch.parallel.shares``).  Each check prints its kernels'
   launches and their device time (CUDA events around each launch;
   ``split_path`` in the kernels line).

14. the training path of the recurrent and encoder-decoder families at
   full width and depth, as phase 10 trains granite: recurrentgemma-2b
   (bf16, 2 x 3072 tokens: RG-LRU scans and windowed flash attention),
   xlstm-125m's production profile (f32, 8 x 2048: the chunked mLSTM on
   ``mlstm_chunk``, the sLSTM's per-step loop) and whisper-large-v3
   (bf16, 4 x 1500 frames and 1500 tokens: bidirectional, causal and
   cross flash attention), weights drawn on the card from seed 0, through
   ``repro_torch.runtime.Trainer`` (remat, AdamW with f32 moments):
   (a) 4 steps: ms a step and tokens/s, ``max_memory_allocated`` beside
   the parameter, gradient and moment bytes, the launches split at the
   end of the forward (forward, then the same again in the recompute; the
   backward passes' oracles launch none), one step profiled (device busy
   share, the leading kernels, and the host time of the RG-LRU's, the
   mLSTM's and the sLSTM's backward passes), the step's bound (3 x the
   forward's operations against AdamW's bytes); xlstm-125m checkpoints
   after step 2, restarts from it in a fresh ``Trainer`` and must lose
   the same in step 3, bit for bit; (b) the loss falling on one repeated
   batch (one update); (c) one f32 step at full width and
   ``F32_TRAIN_LAYERS`` of depth (xlstm-125m: one mLSTM and sLSTM pair)
   on the f32 kernels against the plain versions (the mLSTM's: the chunked
   oracle), within ``P14_FLOOR_MULT`` times the plain step's distance to
   the same step in f64 on the oracles and never looser than
   ``F32_TRAIN_TOL``, and planted errors outside it: the window one key
   short, the RG-LRU's ``h0`` ignored (the second half of a scan from
   0), the mLSTM's column of ones zeroed (q, k x ``MLSTM_QK_SCALE`` so
   that the normalizer is read), a chunked mLSTM backward that drops the
   state carried between chunks, the encoder's attention made causal, and
   cross-attention on the encoder output shifted by one frame.

Phase 4 runs after phase 5, phase 6 after phase 4, phase 7 after phase 6,
phase 8 after phase 7, phase 9 after phase 8, phase 10 after phase 9,
phase 11 after phase 10, phase 12 after phase 11, phase 13 after phase
12, phase 14 after phase 13.
Phase 4 also times
the six library kernels (CUDA events,
median of warm launches, and the profiler's device time), their plain
versions, and the one PyTorch call that computes the same function where
there is one (``scaled_dot_product_attention`` for flash attention,
``torch.bmm`` for the grouped matmul).

In the ``kernels`` line, a segment kernel's ``ms`` is the device time of
the segment kernels of one launch, ``launch_ms`` the latency of the whole
launch (host work and the engine's copies included), ``plain_ms`` the same
launch through the plain version on the card; a library kernel's ``ms`` is
the time of one call at the main path's shape (CUDA events around the
call, so the host's work before the launch counts where the device waits
for it), ``device_ms`` the device time of its kernels alone (from
``torch.profiler``; null where the profiler saw no device activity),
``plain_ms`` its plain version's; ``library_ms`` and
``library_device_ms`` the same two for the PyTorch call.

The launch counts of the kernels are reset before phases 2-3 and read after
them, reset before phase 5's main path and read after it, and reset before
each serving run of phases 7, 8 and 9 and read at the end of its prefill
and after it (``model_path`` in the kernels line, by model), and reset
before each train step of phase 10 and read after it, and for one step
also at the end of its forward (``train_path``: the launches of one
step), and reset before each of phase 11's prefill, decode and train
steps and read after it (``mesh_path``), and reset before phase 12's
trace and its measured step and read after each (``dryrun_path``), and
reset before each check of phase 13 and read after it (``split_path``),
and reset before each train step of phase 14 and read after it, and for
its first step also at the end of its forward (``train_path``, by model,
beside phase 10's).  Any
mismatch or launch error ends the run with a non-zero code.  The last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: memory rate of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (same source)
F32_OPS_PER_S = 67e12
#: dense bf16 rate of the tensor cores (same source)
BF16_OPS_PER_S = 989e12

#: block-path verdicts per kernel and opt level at the canonical launch:
#: (tiled segment executions, scalar executions, refusal categories).
#: tests/test_torch_ir.py holds this table against the JAX reference.
PINNED_BLOCK_STATS = {
    "vadd": {0: (1, 0, {}), 3: (1, 0, {})},
    "saxpy": {0: (1, 0, {}), 3: (1, 0, {})},
    "matmul_tiled": {0: (1, 5, {"shared-memory": 4, "unprovable-base": 1}),
                     3: (1, 5, {"shared-memory": 4, "unprovable-base": 1})},
    "reduction": {0: (1, 7, {"shared-memory": 7}),
                  3: (1, 7, {"shared-memory": 7})},
    "inclusive_scan": {0: (0, 1, {"collective": 1}),
                       3: (0, 1, {"collective": 1})},
    "bitcount_vote": {0: (0, 1, {"collective": 1}),
                      3: (0, 1, {"collective": 1})},
    "montecarlo_pi": {0: (0, 1, {"collective": 1}),
                      3: (0, 1, {"collective": 1})},
    "nn_layer": {0: (0, 1, {"collective": 1}), 3: (0, 1, {"collective": 1})},
    "stencil_1d": {0: (1, 0, {}), 3: (1, 0, {})},
    "persistent_counter": {0: (1, 4, {"opaque-index": 4}),
                           3: (1, 4, {"opaque-index": 4})},
    "dot_product": {0: (0, 1, {"collective": 1}),
                    3: (0, 1, {"collective": 1})},
    "poly_eval": {0: (1, 0, {}), 3: (1, 0, {})},
    "swizzle_copy": {0: (1, 0, {}), 3: (1, 0, {})},
    "tap_filter": {0: (1, 1, {"opaque-index": 1}),
                   3: (1, 1, {"opaque-index": 1})},
    "dyn_matmul": {0: (1, 9, {"shared-memory": 8, "unprovable-base": 1}),
                   3: (1, 9, {"shared-memory": 8, "unprovable-base": 1})},
    "dyn_fir": {0: (1, 0, {}), 3: (1, 0, {})},
    "decode_gemv": {0: (1, 9, {"opaque-index": 1, "shared-memory": 8}),
                    3: (1, 9, {"opaque-index": 1, "shared-memory": 8})},
    "attn_decode": {0: (1, 8, {"shared-memory": 7, "unprovable-base": 1}),
                    3: (1, 8, {"shared-memory": 7, "unprovable-base": 1})},
    "moe_route_gmm": {0: (0, 1, {"unprovable-base": 1}),
                      3: (0, 1, {"unprovable-base": 1})},
    "rglru_step": {0: (0, 1, {"collective": 1}), 3: (0, 1, {"collective": 1})},
    "mlstm_cell": {0: (0, 3, {"shared-memory": 3}),
                   3: (0, 3, {"shared-memory": 3})},
}

#: full-width decode step: Llama 3.2 3B (src/repro/configs/llama3_2_3b.py)
#: has 24 query heads of width 128; 32 kv tiles of 128 keys = 4096 tokens
ATTN_H, ATTN_D, ATTN_T, ATTN_NTILES = 24, 128, 128, 32
#: full-width elementwise launch: 2^24 float32 elements, block 256
VADD_N, VADD_BLOCK = 1 << 24, 256

#: phase 5 shapes, from the repo's model configurations (src/repro/configs):
#: Llama 3.2 3B prefill: 24 query heads of 128 (kv repeated), 4096 tokens
FA_B, FA_H, FA_S, FA_D = 1, 24, 4096, 128
#: recurrentgemma-2b local attention: 10 heads of 2560 / 10, window 2048
RGA_H, RGA_D, RGA_WINDOW = 10, 256, 2048
#: granite-moe-3b-a800m experts: 40 experts, d_model 1536, d_ff 512 each;
#: capacity of a 4096-token batch at top-8 and factor 1.25:
#: ceil(4096 * 8 / 40 * 1.25) = 1024 rows
GMM_E, GMM_C, GMM_D, GMM_F = 40, 1024, 1536, 512
#: recurrentgemma-2b RG-LRU: d_rnn 2560, 4096 steps, one sequence
RG_B, RG_S, RG_D = 1, 4096, 2560
#: xlstm-125m mLSTM: 4 heads of (2 * 768) / 4 = 384 keys and values, a
#: batch of 8 sequences of 4096 steps, chunks of 128
ML_BH, ML_S, ML_DK, ML_BT = 8 * 4, 4096, 384, 128
#: the port's repaired domain (phase 5): bf16 flash attention that TMA
#: cannot load (d = 100, tensors 4 bytes off 16-byte alignment) and a head
#: wider than 256, at 8 heads over 2048 tokens; the mLSTM with chunks of
#: 256 steps (run as 128) and keys of 704, at 2 batch-heads of 1024 steps
REPAIR_H, REPAIR_S, REPAIR_D_BF16, REPAIR_D_WIDE = 8, 2048, 100, 320
REPAIR_ML_BH, REPAIR_ML_S, REPAIR_ML_DK, REPAIR_ML_DV, REPAIR_ML_BT = \
    2, 1024, 704, 64, 256
#: the hetIR block of phase 1's wide launches: two lanes a CUDA thread
WIDE_BLOCK = 2048
#: bf16 attention outputs, (atol, rtol): the kernel, its plain version and
#: the oracle all round an f32 result to bf16, and f32 sums in another
#: order round at most one bf16 step (2^-7 of the value) apart; 1e-3
#: absolute for outputs near 0
BF16_ATTN_TOL = (1e-3, 2.0 ** -7)
#: the TPU kernel each library kernel replaces (its Pallas wrapper)
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_sm90": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_bf16": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_wide": "src/repro/kernels/flash_attention/kernel.py:98",
    "moe_gmm": "src/repro/kernels/moe_gmm/kernel.py:47",
    "moe_gmm_sm90": "src/repro/kernels/moe_gmm/kernel.py:47",
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:54",
    "mlstm_chunk": "src/repro/kernels/mlstm_chunk/kernel.py:79",
}
#: the CUDA source of each kernel in the kernels line (the bf16 and wide
#: flash builds are builds of flash_attention.cu)
KERNEL_SOURCE = {"flash_attention_bf16": "flash_attention",
                 "flash_attention_wide": "flash_attention"}


#: phase 6 (c): the serving smoke of the JAX package's
#: benchmarks/bench_serving.py — 8 weighted tenants keep 16 requests each
#: in flight until 1200 are admitted; a request is one persistent_counter
#: launch of 4 segments over a 64-element state allocated per request
SERVE_TENANTS, SERVE_LAUNCHES, SERVE_BACKLOG = 8, 1200, 16
SERVE_WEIGHTS = (1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0)
SERVE_ITERS, SERVE_STATE = 4, 64
#: its bars: shares within 15 %, steady-state pool reuse, the smoke's SLO
SERVE_SHARE_ERR, SERVE_REUSE, SERVE_P99_MS = 0.15, 0.90, 2000.0
#: the oversubscribed phase: quota 4, 8 bursts of 8 requests per tenant
SHED_QUOTA, SHED_BURSTS, SHED_BURST = 4, 8, 8
#: requests of the profiled serving run that gives the busy share
SERVE_PROFILED_LAUNCHES = 240
#: phase 6 (d): the fleet's launches (canonical example launches)
FLEET_KERNELS = ("dyn_matmul", "decode_gemv", "attn_decode")
FLEET_COPIES = 3
#: the three fresh processes of phase 6 (b) that share one fabric
FABRIC_PROCS = 3
#: phase 7: granite-moe-3b-a800m (src/repro_torch/configs/
#: granite_moe_3b_a800m.py) at full width, served as the JAX launcher's
#: --batch 4 at --prompt-len 1024 for 32 steps
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_STEPS = "granite-moe-3b-a800m", 4, 1024, 32
#: kernel calls of each kind that phase 7 (b) holds against their plain
#: versions: a seeded sample of the prefill's flash attention and grouped
#: matmul calls and of the decode's grouped matmul calls
CAPTURE_SAMPLE = 8
#: phase 7 (c), f32 logits (atol, rtol) of the model on the f32 kernels
#: against the same model on the plain versions: f32 sums in another order
#: through 32 layers (about 1e-5 of a logit near 4), and the rare MoE
#: routing that flips at a near-tied router logit, which reaches the last
#: position through attention at about 1/S of its weight
F32_MODEL_TOL = (1e-3, 1e-3)
#: phase 8: the recurrent families at full width and depth, served as the
#: JAX launcher would (arch, config getter, batch, prompt): recurrentgemma-2b
#: (src/repro_torch/configs/recurrentgemma_2b.py, bf16) over a prompt past
#: its 2048-token window, so that the windowed flash mask and the ring
#: cache's roll are on the path, and xlstm-125m's production profile
#: (configs.get_optimized_config: the chunked mLSTM, f32), 8 x 4 = 32
#: batch-heads in 16 chunks of 128
#: and (c)'s tolerance of the f32 logits on the kernels against the plain
#: versions: recurrentgemma-2b's differ only by flash attention's sums in
#: another order (F32_MODEL_TOL, as phase 7); xlstm-125m's sLSTM layers
#: amplify rounding about 400-fold each at random weights over 2048 steps
#: (on an NVIDIA H100, the embeddings one f32 step, a factor 1 + 1e-7,
#: off moved its logits by 0.032), so its check is tied to the rounding
#: floor that (c) measures each run: the plain versions in chunks of 64
#: instead of 128, the same function in another rounding order (0.00741 on
#: an NVIDIA H100 80GB HBM3 at 700 W, where the kernels were 0.01134 from
#: the plain versions).  Its logits must lie within XLSTM_FLOOR_MULT times
#: that floor, absolute, and never further than XLSTM_MODEL_TOL allows
XLSTM_MODEL_TOL = (5e-2, 1e-2)
XLSTM_FLOOR_MULT = 3.0
#: the mLSTM normalizer's planted error (c): q and k 8 times larger, so
#: that |q·n| passes 1 and its column of ones decides the output
MLSTM_QK_SCALE = 8.0
P8_MODELS = (("recurrentgemma-2b", "get_config", 2, 3072, F32_MODEL_TOL),
             ("xlstm-125m", "get_optimized_config", 8, 2048,
              XLSTM_MODEL_TOL))
P8_STEPS = 32
#: (c) runs xlstm-125m's first blocks only (two mLSTM and two sLSTM): its
#: nine f32 prefills at full depth took about a minute, most of it the
#: sLSTM's per-step loop, which phase 14's training needs more
P8_XLSTM_F32_LAYERS = 4
#: phase 9: whisper-large-v3 (src/repro_torch/configs/whisper_large_v3.py)
#: at full width and depth, bf16, served at batch 4 with 30 s of audio
#: (WHISPER_CROSS_LEN = 1500 frames of the frontend stub) and a text
#: prompt of 64 tokens, 32 steps
WHISPER_ARCH, WHISPER_B, WHISPER_S, WHISPER_STEPS = \
    "whisper-large-v3", 4, 64, 32
#: phase 10: granite-moe-3b-a800m (SERVE_ARCH) trained at full width and
#: depth in bf16 through repro_torch.runtime.Trainer (seed 0, remat, the
#: reference's Trainer defaults: AdamW with f32 moments, peak lr 1e-3),
#: batches of 4 x 1024 tokens; 6 steps, a checkpoint after the 3rd
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_AT = 4, 1024, 6, 3
#: (b) steps of the train step on one repeated batch (warmup 1, peak lr
#: 1e-3), and the least fall of the loss, in nats, from the first to the
#: last
FIT_STEPS, FIT_MARGIN = 8, 1.0
#: (c) one f32 train step at full width and FIT_LAYERS of depth (the f32
#: state and the plain versions' autograd kept small), on the f32 kernels
#: against the plain versions: the loss (absolute), the global gradient
#: norm (relative), each parameter's gradient and update (relative L2).
#: AdamW's update is about lr·sign(g) where |g| passes eps and lr·g/eps
#: below, so a gradient entry at the rounding noise moves its update:
#: updates are held looser than gradients
F32_TRAIN_LAYERS = 4
F32_TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "grad": 1e-3,
                 "update": 1e-2}
#: phase 11: the multi-device layer on the card's one-device mesh. (a)
#: granite at phase 7's shapes through MeshRules and the steps, with
#: MESH_STEPS tokens each; (b) the bf16 job at phase 10's batch moved card
#: -> host -> card after MIGRATE_AT of MIGRATE_STEPS steps; (c) a step on
#: each side in f32 at full width and MIGRATE_F32_LAYERS layers (the depth
#: cut so that the host's step fits the time limit) on batches of
#: MIGRATE_F32_B x MIGRATE_F32_S tokens, held to F32_TRAIN_TOL
MESH_STEPS = 4
MIGRATE_STEPS, MIGRATE_AT = 4, 2
MIGRATE_F32_LAYERS, MIGRATE_F32_B, MIGRATE_F32_S = 2, 1, 128
#: phase 12: the dry run's one-card cell is phase 10's train step (its
#: batch, remat, one microbatch); the card takes DRYRUN_STEPS steps of it
#: and the last is measured
DRYRUN_STEPS = 2
#: phase 13: the split's shares on the one card. (a) granite's MoE layer
#: at phase 7's prefill batch: the capacity cut into SPLIT_SLICES slices
#: at the kernel, and the layer as the ranks of SPLIT_MOE_MESHES (data,
#: model) compute it (granite's 40 experts: EP on a model of 2 and 4, the
#: capacity whole; expert-TP on 16, the capacity over data); (b)
#: xlstm-125m's mixers at phase 8's batch: mlstm_chunk on each head's
#: value columns in SPLIT_VALUE_BLOCKS blocks, and the mLSTM and sLSTM as
#: SPLIT_MIXER_RANKS model ranks compute them (heads; on 16, each head's
#: value columns in 4 blocks and the sLSTM's head repeated), held to
#: MLSTM_F32_TOL, phase 8 (b)'s bar on mlstm_chunk in f32; (c) phase 12's
#: peak within PEAK_TOL of its prediction
SPLIT_SLICES = (2, 4, 16)
SPLIT_MOE_MESHES = ((2, 2), (4, 4), (2, 16), (4, 16))
SPLIT_VALUE_BLOCKS = (1, 2, 4)
SPLIT_MIXER_RANKS = (2, 4, 16)
MLSTM_F32_TOL = 2e-3
PEAK_TOL = 0.01
#: phase 14: the recurrent and encoder-decoder families trained at full
#: width and depth through repro_torch.runtime.Trainer (seed 0, remat, the
#: reference's Trainer defaults: AdamW with f32 moments): (arch, config
#: getter, batch, sequence, batch of (c)).  recurrentgemma-2b and
#: xlstm-125m at phase 8's batches (the former past its 2048-token window),
#: xlstm-125m in its production profile (configs.get_optimized_config: the
#: chunked mLSTM in chunks of 128, as phase 8 serves it; the base config's
#: per-step mLSTM runs no kernel); whisper-large-v3 at phase 9's batch of 4
#: as the Trainer batches it (1500 frames and 1500 text tokens).  Then (c)'s
#: batch and depth: one sequence of recurrentgemma-2b (its f64 witness's
#: logits over 256000 tokens, 12.6 GB a pair of sequences, and their
#: gradient would not fit the card beside the f64 state at two); the mLSTM
#: block of xlstm-125m alone (the sLSTM, which runs no kernel, amplifies
#: the backward's rounding: on an NVIDIA H100 80GB HBM3 at 700 W the plain
#: f32 step's gradients lie 0.03876 from its f64 run's at 4 blocks and
#: 0.01388 at one mLSTM and one sLSTM block, where no f32 step can meet
#: F32_TRAIN_TOL)
P14_MODELS = (("recurrentgemma-2b", "get_config", 2, 3072, 1,
               F32_TRAIN_LAYERS),
              ("xlstm-125m", "get_optimized_config", 8, 2048, 8, 1),
              ("whisper-large-v3", "get_config", 4, 1500, 4,
               F32_TRAIN_LAYERS))
#: (a) Trainer.run steps: each counts its launches split at the end of the
#: forward and is timed there and at its end (the first, the warm-up, not
#: kept), but the third, which is profiled (and its recurrent backward
#: passes timed on the host); xlstm-125m checkpoints after the second, and
#: its fourth is the third run again from a fresh Trainer restored from
#: that checkpoint, which must lose the same, bit for bit
P14_STEPS, P14_CKPT_AT = 4, 2
#: (b) steps of the train step on one repeated batch (warmup 1, peak lr
#: 1e-3), then a forward on it, and the least fall of the loss, in nats,
#: from the first step's to the forward's: one update (on an NVIDIA H100
#: 80GB HBM3 at 700 W it lowered recurrentgemma-2b's loss by 0.904 and
#: xlstm-125m's, the least, by 0.044; an xlstm-125m step takes 25-46 s,
#: most of it the sLSTM's host time)
P14_FIT_STEPS, P14_FIT_MARGIN = 1, 0.02
#: (c) one f32 train step at full width and F32_TRAIN_LAYERS of depth (the
#: first blocks of the pattern; whisper's encoder cut alike) on the f32
#: kernels against the plain versions.  The tolerance is measured: the
#: plain versions' f32 step against the same step in f64 on the oracles
#: (the rounding of f32 through the model: the sLSTM amplifies it about
#: 400-fold a layer), P14_FLOOR_MULT times that, and never looser than
#: F32_TRAIN_TOL, for the loss, the gradient norm and the gradients; the
#: update is held to F32_TRAIN_TOL's
P14_FLOOR_MULT = 3.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def same_bits(a, b) -> bool:
    """Raw 32-bit equality with every NaN mapped to one pattern: x86 and
    the card produce different NaN payloads (0xFFC00000 vs 0x7FFFFFFF for
    0/0), and no hetIR op reads a payload."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        na, nb = np.isnan(a), np.isnan(b)
        return bool(np.array_equal(na, nb)) and bool(np.array_equal(
            a[~na].view(np.uint32), b[~nb].view(np.uint32)))
    return bool(np.array_equal(a, b))


def max_abs_err(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(np.where(both_nan, 0.0, a - b))
    return float(np.nanmax(d)) if d.size else 0.0


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """``(entry, line)`` for each registers and spill line of ``ptxas -v``
    output, the entry function as ``name<template arguments>`` (mangled:
    ``Li128E`` is the int 128, ``Lb1E`` true, ``f`` float)."""
    import re
    found, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"entry function '_ZN?([^']+)'", line)
        if m:   # (<length><identifier>)+ [I<arguments>E] E v ...
            name, rest = "?", m.group(1)
            while rest[:1].isdigit():
                n = re.match(r"\d+", rest).group()
                name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
            entry = f"{name}<{rest[1:rest.find('EEv')]}>" \
                if rest.startswith("I") else name
        elif "registers" in line or "spill" in line:
            found.append((entry, line.split(":", 1)[-1].strip()))
    return found


def run_launch(session, prog, grid, block, args, outs):
    """One launch through the driver API; returns (record, host outputs)."""
    from repro_torch.core import hetir as ir
    fn = session.load(prog).function()
    bound = {}
    for p in prog.params:
        if isinstance(p, ir.Ptr):
            bound[p.name] = session.alloc(
                int(args[p.name].size), p.dtype).copy_from_host(args[p.name])
        else:
            bound[p.name] = args[p.name]
    rec = fn.launch_async(grid, block, bound)
    check(rec.wait(), f"{prog.name}: launch did not finish")
    return rec, {o: rec.buffer(o).copy_to_host() for o in outs}


def time_ms(fn, reps: int) -> float:
    """Median time of ``fn()`` over ``reps`` warm calls, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(backend, go) -> tuple:
    """Device time of the segment kernels one call of ``go()`` launches —
    CUDA events recorded on the stream right before and after each kernel
    launch call — their number, and ``{(segment, mode): [ms, launches]}``.
    The rest of a launch's time is host work the device waits for."""
    import torch
    events = []
    wrapped = []

    def timing(key, fn):
        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            events.append((key, start, end))
            return err
        return timed

    for mod in backend.modules():
        for key, fn in list(mod.fns.items()):
            wrapped.append((mod, key, fn))
            mod.fns[key] = timing(key, fn)
    try:
        go()
    finally:
        for mod, key, fn in wrapped:
            mod.fns[key] = fn
    torch.cuda.synchronize()
    per = {}
    for key, a, b in events:
        ms = a.elapsed_time(b)
        per.setdefault(key, [0.0, 0])
        per[key][0] += ms
        per[key][1] += 1
    return sum(ms for ms, _ in per.values()), len(events), per


def profile_launch(go) -> dict:
    """Device time (ms) of every kernel and copy that one warm call of
    ``go()`` runs, by name (:func:`profile_device`)."""
    import torch
    go()
    torch.cuda.synchronize()
    return profile_device(go)


def profile_device(go) -> dict:
    """Device time (ms) of every kernel and copy one call of ``go()`` runs,
    by name: a ``torch.profiler`` trace of the device alone, read from its
    raw events (a host-bound training step launches about a million
    kernels; the profiler's per-op tree is not built); empty when the
    profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        go()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            by_name[e.name()] = by_name.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6
    return by_name


def print_profile(what: str, by_name: dict, launch_ms: float) -> None:
    if not by_name:
        print(f"# profile {what}: torch.profiler recorded no device "
              "activity (device busy share not measured)")
        return
    busy = sum(by_name.values())
    print(f"# profile {what}: device busy {busy:.4f} ms of a "
          f"{launch_ms:.4f} ms launch (busy share {busy / launch_ms:.4f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"#   {ms:.4f} ms  {name[:90]}")


def wide_cases(block: int) -> list:
    """(label, case) of the programs with cross-lane ops in blocks of
    ``block`` lanes: the edge grids' and the suite's."""
    from repro_torch.core import edge_grids
    return list(edge_grids.wide_cases(block)) + [
        (name, edge_grids.wide_suite_case(name, block))
        for name in edge_grids.WIDE_SUITE]


def check_edge_grids(dev, cases=None) -> int:
    """Every edge-grid program (or every one of ``cases``) through
    ``HetSession("cuda")`` on ``dev``, bits equal to the plain version on
    ``dev`` and to the interpreter on the CPU (NaN as NaN); returns the
    number of programs."""
    from repro_torch.core import HetSession, TranslationCache
    from repro_torch.core import edge_grids
    cases = list(edge_grids.all_cases()) if cases is None else cases
    for label, (prog, grid, block, args, outs) in cases:
        got = {}
        for backend, device in (("cuda", dev), ("vectorized", dev),
                                ("interp", "cpu")):
            s = HetSession(backend, opt_level=0, device=device,
                           cache=TranslationCache())
            _, got[backend] = run_launch(s, prog, grid, block, args, outs)
        for o in outs:
            check(same_bits(got["cuda"][o], got["vectorized"][o]),
                  f"edge grid {label} {o}: kernel != plain version")
            check(same_bits(got["cuda"][o], got["interp"][o]),
                  f"edge grid {label} {o}: kernel != interpreter")
    return len(cases)


def _outs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _close(got, want, tol) -> bool:
    """Within ``tol``: ``(atol, rtol)``, or one number for both; bit-equal
    for 0."""
    import torch
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return all(torch.equal(g, w) if tol == 0 else
               torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
               for g, w in zip(_outs(got), _outs(want)))


def _err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(_outs(got), _outs(want)))


def _excess(got, want, tol) -> float:
    """The largest ``|got - want|`` over its allowance ``atol + rtol *
    |want|`` (``tol`` as :func:`_close` takes it): within ``tol`` when at
    most 1."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return max(float(((g.float() - w.float()).abs()
                      / (atol + rtol * w.float().abs())).max())
               for g, w in zip(_outs(got), _outs(want)))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class LibCase:
    """One full-width call of a library kernel: the user entry point
    (``op``, the main path), the wrapper alone (``fwd``, for timing), its
    plain version and oracle on the same inputs, the tolerance in the
    working type (0: bit-equal), the bytes and operations of its bound,
    the PyTorch call that computes the same function where there is one,
    a second tiling of the kernel that must agree within 1e-3, a
    predicate the output must meet (its docstring says what failed), and
    oracles with a planted error, ``(what, call)``, that the tolerance must
    refuse."""

    def __init__(self, kernel, label, op, fwd, plain, ref, tol, nbytes,
                 ops, ops_rate, library=None, retiled=None, invariant=None,
                 planted=()):
        self.kernel, self.label = kernel, label
        self.op, self.fwd, self.plain, self.ref = op, fwd, plain, ref
        self.tol, self.nbytes, self.ops = tol, nbytes, ops
        self.ops_rate, self.library, self.retiled = ops_rate, library, retiled
        self.invariant, self.planted = invariant, planted
        self.out = self.err = None

    def bound(self) -> tuple:
        """(bound in ms, "bytes" or "operations")."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        t_ops = self.ops / self.ops_rate
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"


def _attn_pairs(S: int, window) -> float:
    """(query, key) pairs of causal attention over S positions, within
    ``window`` keys when given."""
    return float(sum(min(t + 1, window or t + 1) for t in range(S)))


def _mlstm_ops(BH: int, S: int, dk: int, dv: int, bt: int) -> float:
    """Operations (2 a multiply-add) of chunked gated linear attention in
    chunks of n = min(bt, S) steps: per chunk q kᵀ and (s ∘ decay) v over
    the causal triangle of n(n+1)/2 pairs, q C and the state update kᵀ v
    in full."""
    n = min(bt, S)
    return 2.0 * ((n * (n + 1) // 2) * (dk + dv) + 2 * n * dk * dv) \
        * BH * (S // n)


def library_cases(dev) -> list:
    """The phase 5 calls, on inputs made on the card from a seed."""
    import torch
    import torch.nn.functional as tf
    from repro_torch.kernels import (flash_attention, mlstm_chunk, moe_gmm,
                                     rglru_scan)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mlstm_chunk import kernel as ml
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    cases = []

    def flash(label, q, k, v, window, library, kernel=None):
        B, H, S, d = q.shape
        rate = BF16_OPS_PER_S if q.dtype == bf16 else F32_OPS_PER_S
        if window is None:   # rows S-32.. miss up to 32 of their first keys
            planted = [("late rows missing their first kv tile",
                        lambda: attention_ref(q, k, v, causal=True,
                                              window=S - 32))]
        else:
            planted = [(f"the band one key {what}",
                        lambda w=window + dw: attention_ref(
                            q, k, v, causal=True, window=w))
                       for what, dw in (("short", -1), ("long", 1))]
        # bf16 runs on the wgmma/TMA kernel, f32 on the CUDA-core one
        cases.append(LibCase(
            kernel or ("flash_attention_sm90" if q.dtype == bf16
                       else "flash_attention"),
            label,
            lambda: flash_attention(q, k, v, True, window),
            lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                           window=window),
            lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                             window=window),
            lambda: attention_ref(q, k, v, causal=True, window=window),
            BF16_ATTN_TOL if q.dtype == bf16 else 2e-5, _nbytes(q, k, v, q),
            4 * d * B * H * _attn_pairs(S, window), rate, library,
            planted=planted))

    qkv = [randn(FA_B, FA_H, FA_S, FA_D, dtype=bf16) for _ in range(3)]
    flash("Llama 3.2 3B prefill, bf16", *qkv, None,
          lambda: tf.scaled_dot_product_attention(*qkv, is_causal=True))
    qkv32 = [t.float() for t in qkv]
    flash("Llama 3.2 3B prefill, f32", *qkv32, None,
          lambda: tf.scaled_dot_product_attention(*qkv32, is_causal=True))
    rqkv = [randn(1, RGA_H, FA_S, RGA_D, dtype=bf16) for _ in range(3)]
    pos = torch.arange(FA_S, device=dev)
    band = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - RGA_WINDOW)
    flash("recurrentgemma-2b local attention, bf16", *rqkv, RGA_WINDOW,
          lambda: tf.scaled_dot_product_attention(*rqkv, attn_mask=band))
    rqkv32 = [t.float() for t in rqkv]
    flash("recurrentgemma-2b local attention, f32", *rqkv32, RGA_WINDOW,
          lambda: tf.scaled_dot_product_attention(*rqkv32, attn_mask=band))

    counts = torch.randint(0, GMM_C + 1, (GMM_E,), generator=gen,
                           device=dev, dtype=torch.int32)
    counts[0], counts[1] = 0, GMM_C          # one empty, one full expert
    x = randn(GMM_E, GMM_C, GMM_D, dtype=bf16)
    w = randn(GMM_E, GMM_D, GMM_F, scale=GMM_D ** -0.5, dtype=bf16)
    live = counts.long()
    dead = torch.arange(GMM_C, device=dev)[None, :] >= counts[:, None]
    x[dead] = 0                # the contract: rows past counts[e] are zero

    def dead_rows_zero(out):
        """rows past counts[e] (all of the empty expert) are not zeros"""
        return bool((out[dead] == 0).all())

    # bf16 runs on the wgmma/TMA kernel, f32 on the CUDA-core one; the
    # bound counts live rows of x, the weights of experts with a live row,
    # all of the output and the counts
    for kernel, xe, we, rate, tol in (
            ("moe_gmm_sm90", x, w, BF16_OPS_PER_S, 5e-2),
            ("moe_gmm", x.float(), w.float(), F32_OPS_PER_S, 1e-4)):
        size = xe.element_size()
        cases.append(LibCase(
            kernel, "granite-moe-3b-a800m experts, "
            + ("bf16" if xe.dtype == bf16 else "f32"),
            lambda xe=xe, we=we: moe_gmm(xe, we, counts),
            lambda xe=xe, we=we: gmm.moe_gmm_fwd(xe, we, counts),
            lambda xe=xe, we=we: gmm.moe_gmm_plain(xe, we, counts),
            lambda xe=xe, we=we: moe_gmm_ref(xe, we, counts), tol,
            (int(live.sum()) * GMM_D + int((live > 0).sum()) * GMM_D * GMM_F
             + GMM_E * GMM_C * GMM_F) * size + 4 * GMM_E,
            2.0 * int(live.sum()) * GMM_D * GMM_F, rate,
            lambda xe=xe, we=we: torch.bmm(xe, we), invariant=dead_rows_zero))

    a = uniform(0.7, 0.999, RG_B, RG_S, RG_D).to(bf16)
    xr = randn(RG_B, RG_S, RG_D, scale=0.1, dtype=bf16)
    h0 = randn(RG_B, RG_D, scale=0.1)
    cases.append(LibCase(
        "rglru_scan", "recurrentgemma-2b RG-LRU, bf16",
        lambda: rglru_scan(a, xr, h0), lambda: rg.rglru_scan_fwd(a, xr, h0),
        lambda: rg.rglru_scan_plain(a, xr, h0),
        lambda: rglru_scan_ref(a, xr, h0), 0.0,
        _nbytes(a, xr, a, h0, h0), 2.0 * RG_B * RG_S * RG_D,
        F32_OPS_PER_S))

    def mlstm(label, BH, S, dk, dv, bt, retiled):
        q, k = (randn(BH, S, dk, scale=0.5) for _ in range(2))
        v = randn(BH, S, dv, scale=0.5)
        lf = torch.log(uniform(0.9, 0.999, BH, S, 1))
        gi = uniform(0.1, 1.0, BH, S, 1)
        case = LibCase(
            "mlstm_chunk", label,
            lambda: mlstm_chunk(q, k, v, lf, gi, bt),
            lambda: ml.mlstm_chunk_fwd(q, k, v, lf, gi, bt=bt),
            lambda: ml.mlstm_chunk_plain(q, k, v, lf, gi, bt=bt),
            lambda: mlstm_chunk_ref(q, k, v, lf, gi), 2e-3,
            _nbytes(q, k, v, lf, gi, v) + BH * dk * dv * 4,
            _mlstm_ops(BH, S, dk, dv, bt), F32_OPS_PER_S,
            retiled=(lambda: ml.mlstm_chunk_fwd(q, k, v, lf, gi, bt=32))
            if retiled else None)
        # what the three kernels execute, tiles and padding included
        case.executed = ml.executed_ops(BH, S, dk, dv, bt)
        cases.append(case)

    mlstm("xlstm-125m mLSTM, f32, bt 128", ML_BH, ML_S, ML_DK, ML_DK, ML_BT,
          True)

    # the repaired domain, last, so that the cases above draw the inputs
    # of earlier runs: bf16 that TMA cannot load (d = 100, 4 bytes off
    # 16-byte alignment) on the CUDA-core kernel's bf16 build, and a head
    # of 320 on its wide build
    def off16(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=dev)
        out = buf[2:].view(t.shape)
        out.copy_(t)
        return out

    bqkv = [off16(randn(1, REPAIR_H, REPAIR_S, REPAIR_D_BF16, dtype=bf16))
            for _ in range(3)]
    check(all(t.data_ptr() % 16 == 4 for t in bqkv),
          "the unaligned bf16 inputs are aligned")
    flash(f"bf16 d={REPAIR_D_BF16}, 4 bytes off 16-byte alignment", *bqkv,
          None, lambda: tf.scaled_dot_product_attention(*bqkv,
                                                        is_causal=True),
          kernel="flash_attention_bf16")
    wqkv = [randn(1, REPAIR_H, REPAIR_S, REPAIR_D_WIDE) for _ in range(3)]
    flash(f"f32 d={REPAIR_D_WIDE}", *wqkv, None,
          lambda: tf.scaled_dot_product_attention(*wqkv, is_causal=True),
          kernel="flash_attention_wide")

    mlstm(f"mLSTM, f32, bt {REPAIR_ML_BT}, dk {REPAIR_ML_DK}", REPAIR_ML_BH,
          REPAIR_ML_S, REPAIR_ML_DK, REPAIR_ML_DV, REPAIR_ML_BT, False)
    return cases


def _tol_text(tol) -> str:
    return f"{tol[0]:.4g} + {tol[1]:.4g}|x|" if isinstance(tol, tuple) \
        else str(tol)


def check_library_case(c: LibCase) -> None:
    """Hold phase 5's output of one case against the plain version and the
    oracle, its invariant and second tiling; check that its tolerance
    refuses each planted error; print what was found."""
    want = c.plain()
    check(_close(c.out, want, c.tol), f"{c.label}: kernel != plain version")
    c.err = _err(c.out, want)
    want = c.ref()
    check(_close(c.out, want, c.tol), f"{c.label}: kernel != oracle")
    ref_err = _err(c.out, want)
    also = ""
    if c.invariant is not None:
        check(c.invariant(c.out), f"{c.label}: {c.invariant.__doc__}")
        also += "; dead rows exact zeros"
    if c.retiled is not None:
        check(_close(c.out, c.retiled(), 1e-3),
              f"{c.label}: bt 32 != bt {ML_BT}")
        also += f"; bt 32 within 1e-3 of bt {ML_BT}"
        # the redesign's budget: at most 1.15 times the bound's operations
        check(c.executed <= 1.15 * c.ops,
              f"{c.label}: the kernels execute {c.executed:.6g} operations, "
              f"more than 1.15 x the bound's {c.ops:.6g}")
        also += (f"; executes {c.executed / c.ops:.4f} x the bound's "
                 "operations")
    for what, call in c.planted:
        bad = call()
        check(not _close(bad, want, c.tol),
              f"{c.label}: tolerance {_tol_text(c.tol)} misses {what}")
        seen = "also" if not _close(bad, want, 2e-2) else "not"
        also += (f"; refuses {what} (max abs err {_err(bad, want):.4g}, "
                 f"{seen} refused at 2e-2)")
        del bad
    print(f"phase 5: {c.label}: kernel within {_tol_text(c.tol)} of the "
          f"plain version (max abs err {c.err:.4g}) and the oracle "
          f"({ref_err:.4g}){also}")


def check_library_grads(dev) -> None:
    """One small gradient per op: its ``autograd.Function`` (forward
    kernel, backward through the oracle) against autograd of the oracle,
    at 1e-3."""
    import torch
    from repro_torch.kernels import (flash_attention, mlstm_chunk, moe_gmm,
                                     rglru_scan)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(1)

    def leaf(*shape, lo=None, hi=None):
        t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo \
            if lo is not None else \
            torch.randn(shape, generator=gen, device=dev) * 0.5
        return t.requires_grad_()

    def grads(fn, ins):
        loss = sum((o.float() ** 2).sum() for o in _outs(fn(*ins)))
        return torch.autograd.grad(loss, ins)

    def mlstm_ins():
        return [leaf(2, 40, 8) for _ in range(3)] \
            + [torch.log(leaf(2, 40, 1, lo=0.9, hi=0.99))
               .detach().requires_grad_(), leaf(2, 40, 1, lo=0.1, hi=1.0)]

    counts = torch.tensor([20, 64], dtype=torch.int32, device=dev)
    xg = torch.randn((2, 64, 24), generator=gen, device=dev)
    xg[0, 20:] = 0
    pairs = {
        "flash_attention": (
            lambda q, k, v: flash_attention(q, k, v, True, None),
            lambda q, k, v: attention_ref(q, k, v, causal=True),
            [leaf(1, 2, 70, 64) for _ in range(3)]),
        "moe_gmm": (lambda x, w: moe_gmm(x, w, counts),
                    lambda x, w: moe_gmm_ref(x, w, counts),
                    [xg.requires_grad_(), leaf(2, 24, 40)]),
        "rglru_scan": (rglru_scan, rglru_scan_ref,
                       [leaf(1, 40, 16, lo=0.7, hi=0.99), leaf(1, 40, 16),
                        leaf(1, 16)]),
        "mlstm_chunk": (mlstm_chunk, mlstm_chunk_ref, mlstm_ins()),
        # three chunks of 16 (the last partial): the backward's chunked
        # oracle carries its state between them
        "mlstm_chunk in chunks of 16": (
            lambda *a: mlstm_chunk(*a, 16), mlstm_chunk_ref, mlstm_ins()),
    }
    for name, (op, ref, ins) in pairs.items():
        for g, r in zip(grads(op, ins), grads(ref, ins)):
            check(torch.allclose(g, r, atol=1e-3, rtol=1e-3),
                  f"{name}: gradient through the op != oracle's")


def bits_digest(arrays) -> str:
    """sha256 over arrays' raw bytes, every float32 NaN mapped to one
    pattern (as :func:`same_bits` compares)."""
    import numpy as np
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        if a.dtype == np.float32:
            a = np.where(np.isnan(a), np.float32(np.nan), a)
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def example_programs(backend, levels) -> list:
    """``(name, level, optimized program)`` of every suite and zoo
    program's canonical launch: what the translation phases warm."""
    import numpy as np
    from repro_torch.core import Engine
    from repro_torch.core import kernels_suite as ks
    out = []
    for name in list(ks.SUITE) + list(ks.registered_examples("zoo")):
        for lvl in levels:
            prog, _, grid, block, args, _ = ks.example_launch(
                name, rng=np.random.default_rng(42))
            out.append((name, lvl, Engine(prog, backend, grid, block, args,
                                          opt_level=lvl).program))
    return out


def remove_libraries(programs) -> int:
    """Delete the segment libraries of ``programs`` from the build
    directory (a process that loaded one keeps its mapping)."""
    from repro_torch.core.backends import nvcc_build
    from repro_torch.core.backends.cuda_backend import emit_module
    removed = 0
    for prog in programs:
        so = nvcc_build.library_path(emit_module(prog)[0])
        for path in (so, so.with_suffix(".cu")):
            if path.exists():
                path.unlink()
                removed += path.suffix == ".so"
    return removed


def phase6_child(role: str, directory: str, build_dir: str = "",
                 device: str = "cuda:0") -> int:
    """One process of phase 6 (a)/(b): a cache on a fresh tier — ``cold``
    and ``warm`` on a local DiskStore at ``directory``, ``fabric`` on a
    SharedStore there and no local store — takes every suite and zoo
    program at O0 and OPT_MAX to its segment library through
    ``CudaBackend.prebuild`` (cold and warm remove the libraries from the
    build directory first; ``build_dir``, where given, replaces the
    checkout's build directory, so a library built by another process
    reaches this one only through its tiers), then runs every canonical
    launch on the card and on the interpreter.  Prints one JSON line: the nvcc builds, the
    cache's counters after the warm-up, its milliseconds, the mismatches
    and a digest of the outputs."""
    import numpy as np
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import zoo  # noqa: F401
    from repro_torch.core import (DiskStore, HetSession, OPT_MAX,
                                  SharedStore, TranslationCache)
    from repro_torch.core import kernels_suite as ks
    from repro_torch.core.backends import nvcc_build
    if build_dir:
        nvcc_build.BUILD_DIR = Path(build_dir)
    dev = torch.device(device)
    if role == "fabric":
        cache = TranslationCache(shared=SharedStore(directory))
    else:
        cache = TranslationCache(store=DiskStore(directory))
    levels = (0, OPT_MAX)
    sessions = {lvl: HetSession("cuda", opt_level=lvl, device=dev,
                                cache=cache) for lvl in levels}
    progs = example_programs(sessions[0].backend, levels)
    optimized = [p for _, _, p in progs]
    if role != "fabric":
        remove_libraries(optimized)
    t0 = time.perf_counter()
    rep = sessions[0].backend.prebuild(optimized)
    warm_ms = (time.perf_counter() - t0) * 1e3
    st = cache.stats()
    outs, mismatches = [], []
    for name, lvl, _ in progs:
        got = {}
        for backend, device in (("cuda", dev), ("interp", "cpu")):
            prog, _, grid, block, args, names = ks.example_launch(
                name, rng=np.random.default_rng(42))
            s = sessions[lvl] if backend == "cuda" else HetSession(
                "interp", opt_level=lvl, device=device,
                cache=TranslationCache())
            _, got[backend] = run_launch(s, prog, grid, block, args, names)
        for o in names:
            outs.append(got["cuda"][o])
            if not same_bits(got["cuda"][o], got["interp"][o]):
                mismatches.append(f"{name} O{lvl} {o}")
    launches = {k: sum(s.backend.launches[k] for s in sessions.values())
                for k in ("scalar", "block")}
    print(json.dumps({
        "role": role, "modules": rep["modules"],
        "built": sum(s.backend.nvcc["built"] for s in sessions.values()),
        "nvcc_s": sum(s.backend.nvcc["seconds"]
                      for s in sessions.values()),
        "warm_ms": warm_ms,
        "translated": st["translated"], "restored": st["restored"],
        "libraries_written": st["libraries_written"],
        "fetched": st["shared_fetches"], "published": st["shared_publishes"],
        "launches": launches, "mismatches": mismatches,
        "digest": bits_digest(outs)}))
    return 0


def _start_child(role: str, directory, build_dir="") -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--phase6-child",
         role, str(directory), str(build_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _child_result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure("a phase 6 child did not finish in 600 s")
    check(proc.returncode == 0,
          f"phase 6 child failed ({proc.returncode}):\n{err[-4000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    check(not res["mismatches"],
          f"phase 6 {res['role']}: cuda != interp for {res['mismatches']}")
    return res


def serve_scenario(session, fn, expected, n_tenants, total, backlog,
                   profile=False) -> dict:
    """The serving smoke's phase 1 on ``session``: ``n_tenants`` weighted
    tenants (``SERVE_WEIGHTS``) keep ``backlog`` requests each in flight
    until ``total`` are admitted, reaping (and freeing) completions; the
    fair-share window is measured mid-run with every tenant backlogged.
    A tenant's requests start from its seeded state and must end with
    ``expected[tenant]``'s bits.  ``profile``: run under torch.profiler
    and return the device time of its kernels and copies as well."""
    import numpy as np
    from repro_torch.core import ServingFrontEnd
    front = ServingFrontEnd(session, max_inflight=n_tenants * backlog,
                            default_quota=backlog)
    names = [f"t{i}" for i in range(n_tenants)]
    for i, name in enumerate(names):
        front.tenant(name, weight=SERVE_WEIGHTS[i % len(SERVE_WEIGHTS)])
    init = {name: expected[name][0] for name in names}
    live, results = [], []
    submitted = [0]

    def submit(name):
        db = session.alloc(SERVE_STATE).copy_from_host(init[name])
        live.append((front.submit(name, fn, 2, 32,
                                  {"State": db, "iters": SERVE_ITERS}),
                     db))
        submitted[0] += 1

    def reap_free():
        still = []
        for ticket, db in live:
            if ticket.done():
                results.append((ticket.tenant, db.data.clone()))
                db.free()
            else:
                still.append((ticket, db))
        live[:] = still

    def run():
        for name in names:
            for _ in range(backlog):
                submit(name)
        pool0 = session.pool_stats()
        session.sched_trace.clear()
        session.step(50 * n_tenants)
        counts = {front.tenants[n].stream.sid: 0 for n in names}
        for t in session.sched_trace:
            if t["stream"] in counts:
                counts[t["stream"]] += 1
        while submitted[0] < total or live:
            front.pump(64)
            reap_free()
            for name in names:
                while (submitted[0] < total
                       and len(front.tenants[name].inflight) < backlog):
                    submit(name)
        front.drain()
        reap_free()
        return pool0, counts

    t0 = time.perf_counter()
    dev_ms = None
    if profile:
        import torch
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            pool0, counts = run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                     if e.device_type != torch.autograd.DeviceType.CPU) \
            or None
    else:
        pool0, counts = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_segs = sum(counts.values()) or 1
    total_w = sum(front.tenants[n].stream.weight for n in names)
    share_err = max(abs(counts[front.tenants[n].stream.sid] / total_segs
                        - front.tenants[n].stream.weight / total_w)
                    / (front.tenants[n].stream.weight / total_w)
                    for n in names)
    agg = front.stats()
    pool = session.pool_stats()
    dh, dm = pool["hits"] - pool0["hits"], pool["misses"] - pool0["misses"]
    wrong = [tenant for tenant, data in results
             if not same_bits(data.cpu().numpy(), expected[tenant][1])]
    return {"launches": agg["admitted"], "completed": agg["completed"],
            "lost": agg["admitted"] - agg["completed"] - agg["inflight"],
            "wall_ms": wall_ms, "p50_ms": agg.get("p50_ms"),
            "p99_ms": agg.get("p99_ms"), "share_err": share_err,
            "steady_reuse": dh / max(dh + dm, 1), "device_ms": dev_ms,
            "checked": len(results), "wrong": wrong}


def shed_scenario(session, fn, expected, n_tenants) -> dict:
    """The serving smoke's phase 2: quota ``SHED_QUOTA``, bursts far above
    it — the excess is rejected at admission, everything admitted
    completes with the expected bits."""
    from repro_torch.core import QuotaExceeded, ServingFrontEnd
    front = ServingFrontEnd(session, max_inflight=n_tenants * SHED_QUOTA,
                            default_quota=SHED_QUOTA)
    names = [f"t{i}" for i in range(n_tenants)]
    for i, name in enumerate(names):
        front.tenant(name, weight=SERVE_WEIGHTS[i % len(SERVE_WEIGHTS)])
    live, rejected = [], 0
    for _ in range(SHED_BURSTS):
        for name in names:
            for _ in range(SHED_BURST):
                db = session.alloc(SERVE_STATE).copy_from_host(
                    expected[name][0])
                try:
                    live.append((front.submit(
                        name, fn, 2, 32,
                        {"State": db, "iters": SERVE_ITERS}), db))
                except QuotaExceeded:
                    db.free()
                    rejected += 1
        front.pump(16)
    front.drain()
    agg = front.stats()
    wrong = [t.tenant for t, db in live
             if not same_bits(db.copy_to_host(), expected[t.tenant][1])]
    return {"offered": agg["admitted"] + agg["rejected"],
            "admitted": agg["admitted"], "rejected": agg["rejected"],
            "counted": rejected, "completed": agg["completed"],
            "lost": agg["admitted"] - agg["completed"], "wrong": wrong}


def serving_expected(n_tenants) -> dict:
    """Each tenant's seeded initial state and its bits after one request,
    from the interpreter on the CPU."""
    import numpy as np
    from repro_torch.core import HetSession, TranslationCache
    from repro_torch.core import kernels_suite as ks
    rng = np.random.default_rng(6)
    s = HetSession("interp", device="cpu", cache=TranslationCache())
    prog = ks.persistent_counter()[0]
    out = {}
    for i in range(n_tenants):
        init = rng.standard_normal(SERVE_STATE).astype(np.float32)
        _, got = run_launch(s, prog, 2, 32,
                            {"State": init, "iters": SERVE_ITERS},
                            ("State",))
        out[f"t{i}"] = (init, got["State"])
    return out


def fleet_oracles() -> dict:
    """The interpreter's outputs of each fleet kernel's canonical launch."""
    import numpy as np
    from repro_torch.core import HetSession, TranslationCache
    from repro_torch.core import kernels_suite as ks
    out = {}
    for name in FLEET_KERNELS:
        prog, _, grid, block, args, names = ks.example_launch(
            name, rng=np.random.default_rng(42))
        s = HetSession("interp", device="cpu", cache=TranslationCache())
        out[name] = run_launch(s, prog, grid, block, args, names)[1]
    return out


def phase6(dev, smi: str) -> dict:
    """Phase 6: the persistent tiers, the serving front end and the fleet
    on the card, over the CUDA segment kernels.  Returns the scalar and
    block segment-kernel launches of each part."""
    import numpy as np
    import torch
    from repro_torch.core import (FleetCoordinator, HetSession, OPT_MAX,
                                  TranslationCache)
    from repro_torch.core import kernels_suite as ks
    launches = {}
    with tempfile.TemporaryDirectory(prefix="hetgpu-phase6-") as tmp:
        tmp = Path(tmp)
        # (a) cold and warm translation on one local store
        cold = _child_result(_start_child("cold", tmp / "store"))
        check(cold["built"] == cold["modules"] and cold["restored"] == 0
              and cold["translated"] == cold["modules"],
              f"phase 6 cold: not one nvcc per module: {cold}")
        warm = _child_result(_start_child("warm", tmp / "store"))
        check(warm["built"] == 0 and warm["translated"] == 0
              and warm["restored"] == warm["modules"]
              and warm["libraries_written"] == warm["modules"],
              f"phase 6 warm: not every module restored: {warm}")
        check(warm["digest"] == cold["digest"],
              "phase 6: warm outputs differ from cold")
        print(f"phase 6 (a): {cold['modules']} segment libraries of the 21 "
              f"programs at O0/O{OPT_MAX}: cold {cold['built']} nvcc builds "
              f"({cold['nvcc_s']:.3f} s summed over the builds, warm-up "
              f"{cold['warm_ms']:.1f} ms wall); warm, libraries removed: "
              f"built 0, restored "
              f"{warm['restored']}, written back {warm['libraries_written']}"
              f", warm-up {warm['warm_ms']:.1f} ms; launches bit-equal to "
              f"interp on {smi}")
        launches["cold"], launches["warm"] = cold["launches"], \
            warm["launches"]

        # (b) three fresh processes on one fabric, each with an empty
        # build directory of its own: a library one of them builds
        # reaches the others only through the fabric
        t0 = time.perf_counter()
        procs = [_start_child("fabric", tmp / "fabric", tmp / f"build{i}")
                 for i in range(FABRIC_PROCS)]
        fab = [_child_result(p) for p in procs]
        fab_s = time.perf_counter() - t0
        modules = fab[0]["modules"]
        check(sum(r["built"] for r in fab) == modules,
              f"phase 6 fabric: {[r['built'] for r in fab]} nvcc builds "
              f"for {modules} modules")
        check(all(r["translated"] == r["built"]
                  and r["fetched"] == r["restored"] == modules - r["built"]
                  and r["digest"] == cold["digest"] for r in fab),
              f"phase 6 fabric: a process neither built nor fetched a "
              f"module, or its bits differ: {fab}")
        print(f"phase 6 (b): {FABRIC_PROCS} fresh processes on one fabric: "
              f"nvcc builds {[r['built'] for r in fab]} = one per module "
              f"({modules}), fetched {[r['fetched'] for r in fab]}, "
              f"results bit-equal; {fab_s:.1f} s wall")
        launches["fabric"] = {k: sum(r["launches"][k] for r in fab)
                              for k in ("scalar", "block")}

        # (c) the serving front end on a cuda session
        expected = serving_expected(SERVE_TENANTS)
        serve = HetSession("cuda", device=dev, cache=TranslationCache())
        fn = serve.load(ks.persistent_counter()[0]).function()
        serve.backend.launches.update(scalar=0, block=0)
        warmup = serve.alloc(SERVE_STATE)
        fn.launch(2, 32, {"State": warmup, "iters": SERVE_ITERS})
        load = serve_scenario(serve, fn, expected, SERVE_TENANTS,
                              SERVE_LAUNCHES, SERVE_BACKLOG)
        shed = shed_scenario(serve, fn, expected, SERVE_TENANTS)
        prof = serve_scenario(serve, fn, expected, SERVE_TENANTS,
                              SERVE_PROFILED_LAUNCHES, SERVE_BACKLOG,
                              profile=True)
        torch.cuda.synchronize()
        launches["serving"] = dict(serve.backend.launches)
        check(load["launches"] >= SERVE_LAUNCHES and load["lost"] == 0
              and load["checked"] == load["completed"] and not load["wrong"],
              f"phase 6 serving: lost or wrong requests: {load}")
        check(load["share_err"] <= SERVE_SHARE_ERR,
              f"phase 6 serving: weighted shares off by >15%: {load}")
        check(load["steady_reuse"] >= SERVE_REUSE,
              f"phase 6 serving: steady-state pool reuse < 90%: {load}")
        check(load["p99_ms"] <= SERVE_P99_MS,
              f"phase 6 serving: p99 above {SERVE_P99_MS} ms: {load}")
        check(shed["rejected"] > 0 and shed["lost"] == 0
              and shed["counted"] == shed["rejected"] and not shed["wrong"],
              f"phase 6 serving: shedding did not shed or lost work: {shed}")
        check(not prof["wrong"] and prof["lost"] == 0,
              f"phase 6 serving (profiled): {prof}")
        if prof["device_ms"] is None:
            busy = "not measured (the profiler saw no device activity)"
        else:
            # the profiler slows the host, not the device: the device time
            # a request takes under it, over the unprofiled run's wall time
            per_req = prof["device_ms"] / prof["completed"]
            busy = (f"{per_req * load['completed'] / load['wall_ms']:.4f} "
                    f"({per_req * 1e3:.2f} us of device time a request, "
                    f"torch.profiler over {prof['completed']} requests, "
                    f"whose own wall time gives "
                    f"{prof['device_ms'] / prof['wall_ms']:.4f})")
        print(f"phase 6 (c): serving {load['launches']} launches from "
              f"{SERVE_TENANTS} weighted tenants on cuda: p50 "
              f"{load['p50_ms']} ms, p99 {load['p99_ms']} ms (to the "
              f"device event after each request's last segment), "
              f"{load['completed'] / load['wall_ms'] * 1e3:.1f} requests/s, "
              f"shares within {load['share_err']:.4f}, steady pool reuse "
              f"{load['steady_reuse']:.4f}; oversubscribed: "
              f"{shed['admitted']} admitted, {shed['rejected']} shed, "
              f"{shed['lost']} lost; every output bit-equal to interp; "
              f"device busy share {busy}; on {smi}")

        # (d) a cuda/cuda/interp fleet: a kill -9 mid-kernel, a drain
        oracles = fleet_oracles()
        plan = [{"point": "mid-kernel", "worker": 0, "nth": 1,
                 "after_segments": 2}]
        with FleetCoordinator(backends=("cuda", "cuda", "interp"),
                              queue_dir=tmp / "queue", fault_plan=plan,
                              fault_seed=42, slice_segments=1) as fleet:
            tickets = []
            for name in FLEET_KERNELS:
                prog, _, grid, block, args, _ = ks.example_launch(
                    name, rng=np.random.default_rng(42))
                fleet.register(prog)
                tickets += [(name, fleet.submit(name, grid, block, args))
                            for _ in range(FLEET_COPIES)]
            deadline = time.perf_counter() + 300
            while fleet.counters["workers_lost"] == 0:
                check(time.perf_counter() < deadline and fleet.pump(),
                      "phase 6 fleet: the mid-kernel kill never fired")
            fleet.pump()        # the killed worker's launches redispatch
            w1 = fleet.workers[1]
            check(w1.alive and w1.launches,
                  "phase 6 fleet: the second cuda worker holds no launch")
            _, w1_stats = fleet._rpc(w1, "stats", {})
            moved = fleet.drain(1)
            fleet.wait_all(timeout=300)
            st = fleet.fleet_stats()
        for name, t in tickets:
            check(all(same_bits(t.result(o), want)
                      for o, want in oracles[name].items()),
                  f"phase 6 fleet: {name} != interp")
        n = len(tickets)
        check(st["workers_lost"] == 1 and st["duplicate_acks"] == 0
              and st["completed"] == n and st["queue"]["acked"] == n
              and st["queue"]["total"] == n and st["evacuated"] >= 1
              and moved >= 1 and st["migrated"] == moved,
              f"phase 6 fleet: counters {st}")
        check(all(m["src"] == 1 and m["dst"] == 2
                  for m in fleet.migrations),
              f"phase 6 fleet: a drain landed elsewhere: {fleet.migrations}")
        launches["fleet_worker1"] = w1_stats["kernel_launches"]
        check(w1_stats["kernel_launches"].get("scalar", 0) > 0,
              f"phase 6 fleet: the cuda worker launched no kernel: "
              f"{w1_stats}")
        ms = {k: sum(m[k] for m in fleet.migrations) / len(fleet.migrations)
              for k in ("checkpoint_ms", "transfer_ms", "restore_ms",
                        "payload_bytes")}
        print(f"phase 6 (d): fleet cuda/cuda/interp, {n} launches: worker "
              f"0 killed mid-kernel, {st['evacuated']} replayed; worker 1 "
              f"drained to the interp worker, {moved} moved live "
              f"(mean checkpoint {ms['checkpoint_ms']:.3f} ms, transfer "
              f"{ms['transfer_ms']:.3f} ms, restore {ms['restore_ms']:.3f} "
              f"ms, {ms['payload_bytes']:.0f} B); all bit-equal to interp, "
              f"0 lost, {st['duplicate_acks']} double-acked; counters "
              f"{ {k: st[k] for k in ('submitted', 'completed', 'retried', 'evacuated', 'migrated', 'workers_lost', 'workers_spawned', 'duplicate_acks')} } "
              f"recovery max {st.get('recovery_ms_max', 0.0):.1f} ms; on "
              f"{smi}")
    for part, counts in launches.items():
        check(counts.get("scalar", 0) > 0,
              f"phase 6 {part}: no scalar segment kernel launched: {counts}")
    check(launches["warm"]["block"] > 0 and launches["fabric"]["block"] > 0,
          f"phase 6: no block segment kernel launched: {launches}")
    print(f"# phase 6 segment-kernel launches: {launches}")
    return launches


def launch_counters() -> dict:
    """Each library kernel's launch count, by its name in the kernels
    line: ``(wrapper, attribute)``."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_fwd
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_fwd
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    return {"flash_attention": (flash_attention_fwd, "launches"),
            "flash_attention_sm90": (flash_attention_fwd, "sm90_launches"),
            "flash_attention_bf16": (flash_attention_fwd,
                                     "simt_bf16_launches"),
            "flash_attention_wide": (flash_attention_fwd, "wide_launches"),
            "moe_gmm": (moe_gmm_fwd, "launches"),
            "moe_gmm_sm90": (moe_gmm_fwd, "sm90_launches"),
            "rglru_scan": (rglru_scan_fwd, "launches"),
            "mlstm_chunk": (mlstm_chunk_fwd, "launches")}


def reset_launches(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_launches(counters: dict) -> dict:
    return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}


def _patched(obj, **attrs):
    """Context manager: ``obj``'s attributes set to ``attrs``, restored on
    exit (the harness's own patches of the layers' ops and of a model's
    method)."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        own = vars(obj)
        old = {k: own[k] for k in attrs if k in own}
        for k, v in attrs.items():
            setattr(obj, k, v)
        try:
            yield
        finally:
            for k in attrs:
                if k in old:
                    setattr(obj, k, old[k])
                else:
                    delattr(obj, k)
    return cm()


#: the model-path kernels by a part of their device names in a profile
MODEL_KERNEL_MARKS = {"flash_attention": "flash_fwd", "moe_gmm": "moe_gmm",
                      "rglru_scan": "rglru_scan", "mlstm_chunk": "mlstm_"}


def _kernel_of(name: str) -> str:
    return next((k for k, mark in MODEL_KERNEL_MARKS.items()
                 if mark in name), "other")


def _by_kernel(by_name: dict) -> dict:
    """Device ms of a profile, summed into each model-path kernel (flash
    attention, the grouped matmul, the RG-LRU scan, the mLSTM chunk
    kernels) and the rest."""
    out = dict.fromkeys([*MODEL_KERNEL_MARKS, "other"], 0.0)
    for name, ms in by_name.items():
        out[_kernel_of(name)] += ms
    return out


def _print_others(what: str, by_name: dict, n: int = 8) -> None:
    """The ``n`` largest device times of a profile outside the model-path
    kernels."""
    rest = sorted(((ms, name) for name, ms in by_name.items()
                   if _kernel_of(name) == "other"), reverse=True)
    for ms, name in rest[:n]:
        print(f"#   {what}: {ms:.4f} ms  {name[:100]}")


def _gmm_rows(counts, C: int, bc: int = 128) -> int:
    """Rows the grouped matmul computes: every row of a ``bc``-row tile
    that holds a live row."""
    import torch
    return int(torch.clamp(torch.ceil(counts.double() / bc) * bc,
                           max=C).sum())


def phase7(dev, smi: str) -> dict:
    """Phase 7: the model stack's serving path at granite-moe-3b-a800m's
    full width, through ``repro_torch.launch.serve``, with flash attention
    and the grouped matmul on it.  Returns what the kernels line carries
    for the four model-path kernels, by kernel name."""
    import dataclasses
    import random
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import _cuda as kernel_lib
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    from repro_torch.kernels.moe_gmm.kernel import (moe_gmm_fwd,
                                                    moe_gmm_plain)
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import layers

    counters = launch_counters()

    cfg = configs.get_config(SERVE_ARCH)
    B, S, steps = SERVE_B, SERVE_S, SERVE_STEPS
    E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
    C = int(math.ceil(B * S * cfg.moe.top_k / E * cfg.moe.capacity_factor))
    op_flash, op_gmm = layers.flash_attention, layers.moe_gmm
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"# phase 7: {cfg.name} at full width, {n_params} parameters in "
          f"{model.embed.dtype} on the card, drawn in "
          f"{time.perf_counter() - t0:.2f} s on {smi}")
    # warm-up at the main path's shapes: libraries loaded, allocator filled
    serve.serve(cfg, batch=B, prompt_len=S, steps=2, model=model, seed=1)
    torch.cuda.synchronize()

    # -- (a) serving: counts split at the end of the prefill ----------------
    prefill = model.prefill
    after_prefill = {}

    def prefill_and_count(*a, **kw):
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        after_prefill.update(read_launches(counters))
        return out

    reset_launches(counters)
    with _patched(model, prefill=prefill_and_count):
        run = serve.serve(cfg, batch=B, prompt_len=S, steps=steps,
                          model=model, seed=0)
    torch.cuda.synchronize()
    total = read_launches(counters)
    decode_counts = {n: total[n] - after_prefill[n] for n in total}
    tokens = run["tokens"]
    check(tuple(tokens.shape) == (B, steps)
          and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.padded_vocab,
          f"phase 7: generated tokens {tuple(tokens.shape)} out of range")
    check(after_prefill["flash_attention_sm90"] == cfg.n_layers
          and after_prefill["moe_gmm_sm90"] == 3 * cfg.n_layers
          and sum(after_prefill.values()) == 4 * cfg.n_layers,
          f"phase 7 prefill: expected {cfg.n_layers} flash_attention_sm90 "
          f"and {3 * cfg.n_layers} moe_gmm_sm90 launches and no other, got "
          f"{after_prefill}")
    check(sum(decode_counts.values()) == 3 * cfg.n_layers * (steps - 1)
          and decode_counts["moe_gmm_sm90"] + decode_counts["moe_gmm"]
          == 3 * cfg.n_layers * (steps - 1),
          f"phase 7 decode: expected {3 * cfg.n_layers * (steps - 1)} "
          f"grouped-matmul launches and no flash attention, got "
          f"{decode_counts}")
    decode_route = [n for n in ("moe_gmm_sm90", "moe_gmm")
                    if decode_counts[n]]
    print(f"phase 7 (a): served {B} prompts of {S} tokens, {steps} tokens "
          f"each: prefill {run['prefill_ms']:.3f} ms, decode "
          f"{run['decode_ms_per_step']:.3f} ms a step, "
          f"{run['tokens_per_s']:.1f} tokens/s on {smi}")
    print(f"# phase 7 launches: prefill {after_prefill}; {steps - 1} decode "
          f"steps {decode_counts} (the decode's C = 1 rows take "
          f"{'/'.join(decode_route)})")

    # device time and busy share: one prefill and one decode step profiled
    caches = run["caches"]
    batch = run["batch"]
    tok = tokens[:, -1:].to(dev)

    def go_prefill():
        return model.prefill(batch, cache_len=S + steps)

    def go_decode():
        return model.decode_step(tok, caches, S + steps - 1)

    raw_prefill, raw_decode = profile_launch(go_prefill), \
        profile_launch(go_decode)
    prof_prefill, prof_decode = _by_kernel(raw_prefill), \
        _by_kernel(raw_decode)
    shares = {}
    for what, prof, wall in (("prefill", prof_prefill, run["prefill_ms"]),
                             ("decode step", prof_decode,
                              run["decode_ms_per_step"])):
        busy = sum(prof.values())
        shares[what] = {k: ms / wall for k, ms in prof.items()}
        print(f"# phase 7 {what}: device busy {busy:.4f} ms of "
              f"{wall:.4f} ms (busy share {busy / wall:.4f}): flash "
              f"attention {prof['flash_attention']:.4f} ms "
              f"({prof['flash_attention'] / wall:.4f}), moe_gmm "
              f"{prof['moe_gmm']:.4f} ms ({prof['moe_gmm'] / wall:.4f}), "
              f"other {prof['other']:.4f} ms on {smi}")
    _print_others("prefill", raw_prefill)
    _print_others("decode step", raw_decode)

    # host cost of the wgmma grouped matmul's launches in one decode step:
    # the ctypes call encodes two tensor maps, sets the shared-memory
    # attribute and launches
    sm90 = kernel_lib._launcher("moe_gmm_sm90", ())
    host = []

    def timed_sm90(*args):
        t = time.perf_counter()
        err = sm90(*args)
        host.append(time.perf_counter() - t)
        return err

    kernel_lib._FNS["moe_gmm_sm90"] = timed_sm90
    try:
        go_decode()
        torch.cuda.synchronize()
    finally:
        kernel_lib._FNS["moe_gmm_sm90"] = sm90
    host_ms = sum(host) * 1e3
    print(f"# phase 7 decode step: {len(host)} moe_gmm_sm90 launch calls "
          f"take {host_ms:.4f} ms of host time "
          f"({host_ms / max(len(host), 1):.4f} ms a call: tensor-map "
          f"encoding, attribute, launch) of a "
          f"{run['decode_ms_per_step']:.4f} ms step")

    # -- (b) a second run with the layers' ops capturing a seeded sample ----
    rnd = random.Random(0)
    pick = {"flash": set(rnd.sample(range(cfg.n_layers), CAPTURE_SAMPLE)),
            "gmm": set(rnd.sample(range(3 * cfg.n_layers), CAPTURE_SAMPLE)),
            "dgmm": set(rnd.sample(range(3 * cfg.n_layers * (steps - 1)),
                                   CAPTURE_SAMPLE))}
    seen = {"flash": 0, "gmm": 0, "dgmm": 0}
    captured = {"flash": [], "gmm": [], "dgmm": []}
    prefill_counts = []

    def flash_capture(q, k, v, causal, window):
        out = op_flash(q, k, v, causal, window)
        if seen["flash"] in pick["flash"]:
            captured["flash"].append(((q, k, v, causal, window), out))
        seen["flash"] += 1
        return out

    def gmm_capture(x, w, counts):
        out = op_gmm(x, w, counts)
        kind = "gmm" if x.shape[1] == C else "dgmm"
        if kind == "gmm":
            prefill_counts.append(counts.clone())
        if seen[kind] in pick[kind]:
            captured[kind].append(((x, w, counts.clone()), out))
        seen[kind] += 1
        return out

    with _patched(layers, flash_attention=flash_capture,
                  moe_gmm=gmm_capture):
        again = serve.serve(cfg, batch=B, prompt_len=S, steps=steps,
                            model=model, seed=0)
    check(torch.equal(again["tokens"], tokens),
          "phase 7 (b): a second run generated other tokens")
    del again

    # bounds: the prefill by operations over the live tiles' rows, the
    # decode step by the bytes of the weights it touches and its cache
    D, H, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T = B * S
    gmm_rows = sum(_gmm_rows(c, C) for c in prefill_counts[::3])
    proj_ops = 2.0 * T * D * (2 * H * hd + 2 * hkv * hd + E) * cfg.n_layers
    gmm_ops = 2.0 * 3 * gmm_rows * D * Fe
    attn_ops = 4.0 * hd * B * H * (S * (S + 1) / 2) * cfg.n_layers
    logit_ops = 2.0 * B * D * cfg.padded_vocab
    prefill_ops = proj_ops + gmm_ops + attn_ops + logit_ops
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prefill_bound = max(prefill_ops / BF16_OPS_PER_S,
                        w_bytes / HBM_BYTES_PER_S) * 1e3
    touched = []
    with _patched(layers, moe_gmm=lambda x, w, c: (
            touched.append(int((c > 0).sum())), op_gmm(x, w, c))[1]):
        go_decode()
    expert_bytes = 2 * D * Fe * sum(touched)          # one matrix a call
    dense_bytes = w_bytes - 2 * 3 * E * D * Fe * cfg.n_layers
    cache_bytes = 2 * 2 * B * (S + steps) * hkv * hd * cfg.n_layers
    decode_bytes = expert_bytes + dense_bytes + cache_bytes
    decode_bound = decode_bytes / HBM_BYTES_PER_S * 1e3
    print(f"# phase 7 bounds: prefill {prefill_bound:.4f} ms by operations "
          f"({prefill_ops:.6g}: moe_gmm {gmm_ops:.6g} over {gmm_rows} live "
          f"tile rows of 32 layers, projections and router {proj_ops:.6g}, "
          f"causal attention {attn_ops:.6g}, logits {logit_ops:.6g}) at "
          f"989 TFLOP/s; decode step {decode_bound:.4f} ms by bytes "
          f"({decode_bytes} B: {sum(touched) // 3} touched expert sets, "
          f"dense weights {dense_bytes} B, cache {cache_bytes} B) at "
          f"3.35 TB/s; measured {run['prefill_ms'] / prefill_bound:.2f}x "
          f"and {run['decode_ms_per_step'] / decode_bound:.2f}x the bounds "
          f"on {smi}")


    # -- (b) every captured call against its plain version -------------------
    errs = {"flash": 0.0, "gmm": 0.0, "dgmm": 0.0}
    empty = 0
    for (q, k, v, causal, window), out in captured["flash"]:
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        check(_close(out, want, BF16_ATTN_TOL),
              f"phase 7 (b): flash attention {tuple(q.shape)} != plain")
        errs["flash"] = max(errs["flash"], _err(out, want))
    for kind in ("gmm", "dgmm"):
        for (x, w, counts), out in captured[kind]:
            want = moe_gmm_plain(x, w, counts)
            check(_close(out, want, 5e-2),
                  f"phase 7 (b): moe_gmm {tuple(x.shape)} != plain")
            errs[kind] = max(errs[kind], _err(out, want))
            dead = torch.arange(x.shape[1], device=dev)[None, :] \
                >= counts[:, None]
            check(bool((out[dead] == 0).all()),
                  f"phase 7 (b): moe_gmm {tuple(x.shape)}: rows past the "
                  "counts (empty experts included) are not exact zeros")
            empty += int((counts == 0).sum())
    check(all(len(captured[k]) == CAPTURE_SAMPLE for k in captured),
          f"phase 7 (b): capture missed calls: "
          f"{ {k: len(v) for k, v in captured.items()} }")
    print(f"phase 7 (b): {CAPTURE_SAMPLE} flash attention calls "
          f"{tuple(captured['flash'][0][0][0].shape)} within "
          f"{_tol_text(BF16_ATTN_TOL)} of the plain version (max abs err "
          f"{errs['flash']:.4g}); {CAPTURE_SAMPLE} prefill moe_gmm calls "
          f"within 5e-2 ({errs['gmm']:.4g}) and {CAPTURE_SAMPLE} decode "
          f"calls ({errs['dgmm']:.4g}); dead rows exact zeros, "
          f"{empty} empty experts among them, on {smi}")

    # kernel, plain version and library call at the model's shapes
    (q, k, v, causal, window), _ = captured["flash"][0]
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    (x, w, counts), _ = captured["gmm"][0]
    (dx, dw, dcounts), _ = captured["dgmm"][0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {
        "flash_attention_sm90": (
            lambda: flash_attention_fwd(qc, kc, vc, causal=True),
            lambda: flash_attention_plain(qc, kc, vc, causal=True),
            lambda: sdpa(qc, kc, vc, is_causal=True),
            _nbytes(qc, kc, vc, qc),
            4.0 * hd * B * H * (S * (S + 1) / 2)),
        "moe_gmm_sm90": (
            lambda: moe_gmm_fwd(x, w, counts),
            lambda: moe_gmm_plain(x, w, counts),
            lambda: torch.bmm(x, w),
            (int(counts.sum()) * x.shape[2]
             + int((counts > 0).sum()) * w.shape[1] * w.shape[2]
             + x.shape[0] * x.shape[1] * w.shape[2]) * 2 + 4 * E,
            2.0 * int(counts.sum()) * w.shape[1] * w.shape[2]),
        "moe_gmm_sm90 decode": (
            lambda: moe_gmm_fwd(dx, dw, dcounts),
            lambda: moe_gmm_plain(dx, dw, dcounts),
            lambda: torch.bmm(dx, dw),
            (int(dcounts.sum()) * dx.shape[2]
             + int((dcounts > 0).sum()) * dw.shape[1] * dw.shape[2]
             + dx.shape[0] * dx.shape[1] * dw.shape[2]) * 2 + 4 * E,
            2.0 * int(dcounts.sum()) * dw.shape[1] * dw.shape[2]),
    }
    times = {}
    for name, (fwd, plain, lib, nbytes, ops) in timing.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        times[name] = {
            "ms": time_ms(fwd, 10), "plain_ms": time_ms(plain, 3),
            "library_ms": time_ms(lib, 10),
            "device_ms": sum(profile_launch(fwd).values()) or None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        tm = times[name]
        print(f"# phase 7 {name} at the model's shape: kernel "
              f"{tm['ms']:.4f} ms (device {tm['device_ms']} ms), plain "
              f"{tm['plain_ms']:.4f} ms, library call "
              f"{tm['library_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms by "
              f"{tm['bound_by']} on {smi}")
    del captured, run, caches

    # -- (c) the same model in f32: kernels against plain versions ----------
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device="meta")
    m32.load_state_dict({n: t.float() for n, t in model.state_dict().items()},
                        assign=True)
    del model
    torch.cuda.empty_cache()

    def f32_run():
        logits, cache = m32.prefill(batch, cache_len=S + 1)
        first = logits[:, -1].argmax(-1)[:, None]
        step, _ = m32.decode_step(first, cache, S)
        torch.cuda.synchronize()
        return logits, first, step[:, -1].argmax(-1)[:, None]

    # the prefill's expert choices in each run, by layer: router logits
    # [B, S, E] and the chosen experts [B, S, K]
    real_topk, K = layers.topk, cfg.moe.top_k

    def routed(store):
        def capture(logits, k):
            vals, idx = real_topk(logits, k)
            if logits.numel() == B * S * E:
                store.append((logits.reshape(B, S, E), idx.reshape(B, S, k)))
            return vals, idx
        return _patched(layers, topk=capture)

    route_k, route_p = [], []
    reset_launches(counters)
    with routed(route_k):
        logits_k, first_k, next_k = f32_run()
    f32_counts = read_launches(counters)
    check(f32_counts["flash_attention"] == cfg.n_layers
          and f32_counts["moe_gmm"] == 2 * 3 * cfg.n_layers
          and f32_counts["flash_attention_sm90"] == 0
          and f32_counts["moe_gmm_sm90"] == 0,
          f"phase 7 (c): the f32 prefill and decode step missed the f32 "
          f"kernels: {f32_counts}")
    # the MoE combine adds each token's contributions in a fixed order:
    # the same weights and prompt give the same bits on every run
    check(torch.equal(f32_run()[0], logits_k),
          "phase 7 (c): a second f32 run on the kernels gave other logits")
    plain_flash = (lambda q, k, v, causal, window:
                   flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
    with _patched(layers, flash_attention=plain_flash,
                  moe_gmm=moe_gmm_plain), routed(route_p):
        logits_p, first_p, next_p = f32_run()
    err = _err(logits_k, logits_p)
    # where the two runs route a token to other experts (their rounding
    # differs, and a token whose K-th and (K+1)-th router logits nearly
    # tie can flip): (layer, row, position, that gap in the plain run).
    # The prefill's logits are its last position's: a flip anywhere in a
    # row reaches them
    flips = []
    for n, ((_, ik), (lp, ip)) in enumerate(zip(route_k, route_p)):
        differ = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        for b, s in differ.nonzero().tolist():
            v = lp[b, s].sort(descending=True).values
            flips.append((n, b, s, float(v[K - 1] - v[K])))
    # the kernels once more, routed as the plain versions routed
    forced = iter(route_p)

    def follow(logits, k):
        if logits.numel() != B * S * E:
            return real_topk(logits, k)
        idx = next(forced)[1].reshape(*logits.shape[:-1], k)
        return logits.gather(-1, idx), idx

    with _patched(layers, topk=follow):
        logits_f, _, _ = f32_run()
    err_forced = _err(logits_f, logits_p)
    check(_close(logits_f, logits_p, F32_MODEL_TOL),
          f"phase 7 (c): routed as the plain versions routed, the f32 "
          f"logits on the kernels differ from theirs by {err_forced:.4g}")
    gap = (logits_k - logits_p).abs().reshape(B, -1)
    at_b, at_v = divmod(int(gap.argmax()), gap.shape[1])
    print(f"# phase 7 (c) routing: {len(flips)} (layer, token) expert sets "
          f"differ between the kernels' and the plain versions' f32 "
          f"prefill, {[(n, b, s, f'{g:.3g}') for n, b, s, g in flips[:8]]} "
          f"(layer, row, position, K-th minus (K+1)-th router logit; "
          f"smallest {min((f[3] for f in flips), default=0):.3g}, largest "
          f"{max((f[3] for f in flips), default=0):.3g}); the logits' "
          f"largest error {err:.4g} is row {at_b}'s token {at_v} (logit "
          f"{float(logits_p.reshape(B, -1)[at_b, at_v]):.5g}), a row with "
          f"{sum(f[1] == at_b for f in flips)} of them; routed as the plain "
          f"versions routed, the kernels' logits are {err_forced:.4g} from "
          f"theirs")
    check(_close(logits_k, logits_p, F32_MODEL_TOL),
          f"phase 7 (c): f32 logits on the kernels differ from the plain "
          f"versions' by {err:.4g}, past {_tol_text(F32_MODEL_TOL)}")
    check(torch.equal(first_k, first_p) and torch.equal(next_k, next_p),
          "phase 7 (c): greedy tokens on the kernels differ from the plain "
          "versions'")
    top2 = torch.topk(logits_p[:, -1], 2).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    # planted errors: the queries' rotation one position late (a shift of
    # every position alike would cancel in q.k), two experts swapped
    rope = layers.rope

    def late_q(x, pos, theta):
        return rope(x, pos + int(x.shape[-2] == cfg.n_heads), theta)

    with _patched(layers, rope=late_q):
        logits_r, _, _ = f32_run()
    ffn = m32.blocks[0].ffn.p
    for name in ("wg", "wu", "wd"):
        ffn[name][[0, 1]] = ffn[name][[1, 0]]
    logits_s, _, _ = f32_run()
    for name in ("wg", "wu", "wd"):
        ffn[name][[0, 1]] = ffn[name][[1, 0]]
    planted = {"queries rotated one position late": logits_r,
               "experts 0 and 1 of layer 0 swapped": logits_s}
    seen_err = []
    for what, bad in planted.items():
        check(not _close(bad, logits_p, F32_MODEL_TOL),
              f"phase 7 (c): tolerance {_tol_text(F32_MODEL_TOL)} misses "
              f"{what}")
        seen_err.append(f"{what}: max abs err {_err(bad, logits_p):.4g}, "
                        f"{_excess(bad, logits_p, F32_MODEL_TOL):.4g} x "
                        f"the tolerance")
    print(f"phase 7 (c): f32 model on the f32 kernels ({f32_counts}), "
          f"bit-equal over two runs, "
          f"within {_tol_text(F32_MODEL_TOL)} of the plain versions (max abs "
          f"err {err:.4g}, {_excess(logits_k, logits_p, F32_MODEL_TOL):.4g} "
          f"x the tolerance; logits up to "
          f"{float(logits_p.abs().max()):.4g}); greedy tokens of the "
          f"prefill and first decode step identical (smallest top-2 margin "
          f"{margin:.4g}); refuses {'; '.join(seen_err)}; on {smi}")
    del m32
    torch.cuda.empty_cache()
    return {
        "tokens": tokens.cpu(),
        "flash_attention_sm90": dict(
            times["flash_attention_sm90"],
            launches_prefill=after_prefill["flash_attention_sm90"],
            launches_decode=decode_counts["flash_attention_sm90"],
            max_abs_err=errs["flash"],
            device_ms_prefill=prof_prefill["flash_attention"],
            share_prefill=shares["prefill"]["flash_attention"]),
        "moe_gmm_sm90": dict(
            times["moe_gmm_sm90"],
            decode=times["moe_gmm_sm90 decode"],
            launches_prefill=after_prefill["moe_gmm_sm90"],
            launches_decode=decode_counts["moe_gmm_sm90"],
            max_abs_err=max(errs["gmm"], errs["dgmm"]),
            device_ms_prefill=prof_prefill["moe_gmm"],
            share_prefill=shares["prefill"]["moe_gmm"],
            device_ms_decode_step=prof_decode["moe_gmm"],
            share_decode_step=shares["decode step"]["moe_gmm"],
            host_ms_decode_step=host_ms),
        "flash_attention": {"launches_f32_prefill":
                            f32_counts["flash_attention"],
                            "max_abs_err_f32_logits": err},
        "moe_gmm": {"launches_f32_prefill_and_step": f32_counts["moe_gmm"],
                    "launches_decode": decode_counts["moe_gmm"],
                    "max_abs_err_f32_logits": err},
    }

def _model_bounds(model, B: int, S: int, steps: int, caches) -> tuple:
    """(prefill bound ms, by, decode-step bound ms, by, text): the prefill
    by every weight's product over B·S tokens (the blocks' matrices, the
    conv taps and the sLSTM's recurrent weights a multiply-add each a
    token), attention over its pairs, the mLSTM cores and the last
    position's logits, at the peak for the weights' type, or its weights'
    bytes; a decode step by the bytes of every weight, the k/v caches it
    reads and the recurrent states it reads and writes."""
    import torch
    from repro_torch.configs.base import MLSTM, SWA
    cfg = model.cfg
    kinds = [s.mixer for s in cfg.blocks()]
    T = B * S
    dense = sum(p.numel() for blk in model.blocks for p in blk.parameters()
                if p.dim() >= 2)
    proj_ops = 2.0 * T * dense
    attn_ops = 4.0 * cfg.hd * B * cfg.n_heads * _attn_pairs(S, cfg.window) \
        * kinds.count(SWA)
    hd_m = 2 * cfg.d_model // cfg.n_heads
    core_ops = _mlstm_ops(B * cfg.n_heads, S, hd_m, hd_m + 1,
                          cfg.mlstm_chunk) * kinds.count(MLSTM) \
        if cfg.mlstm_impl == "chunked" else \
        4.0 * T * cfg.n_heads * hd_m * hd_m * kinds.count(MLSTM)
    logit_ops = 2.0 * B * cfg.d_model * cfg.padded_vocab
    ops = proj_ops + attn_ops + core_ops + logit_ops
    rate = BF16_OPS_PER_S if model.embed.dtype == torch.bfloat16 \
        else F32_OPS_PER_S
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    t_ops, t_w = ops / rate, w_bytes / HBM_BYTES_PER_S
    state_bytes = sum(t.numel() * t.element_size()
                      * (1 if n in ("k", "v") else 2)
                      for c in caches for n, t in c.items())
    decode_bytes = w_bytes + state_bytes
    text = (f"prefill {ops:.6g} operations (weights {proj_ops:.6g}, "
            f"attention {attn_ops:.6g}, mLSTM cores {core_ops:.6g}, logits "
            f"{logit_ops:.6g}) at {rate / 1e12:.0f} TFLOP/s, weights "
            f"{w_bytes} B; decode step {decode_bytes} B (weights "
            f"{w_bytes}, caches and states {state_bytes}) at 3.35 TB/s")
    return (max(t_ops, t_w) * 1e3, "operations" if t_ops >= t_w else "bytes",
            decode_bytes / HBM_BYTES_PER_S * 1e3, "bytes", text)


def _phase8_model(dev, smi: str, arch: str, getter: str, B: int, S: int,
                  model_tol: tuple, steps: int) -> dict:
    """Phase 8 for one recurrent model: (a) served through
    ``repro_torch.launch.serve``, (b) captured kernel calls against their
    plain versions, (c) the whole model on the kernels against the plain
    versions in f32.  Returns the kernels line's entries by kernel name."""
    import dataclasses
    import random
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import MLSTM, RGLRU, SLSTM, SWA
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_fwd,
                                                        mlstm_chunk_plain)
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_fwd,
                                                       rglru_scan_plain)
    from repro_torch.launch import serve
    from repro_torch.models import Model, layers

    counters = launch_counters()
    flash_routes = ("flash_attention", "flash_attention_sm90",
                    "flash_attention_bf16")

    cfg = getattr(configs, getter)(arch)
    kinds = [s.mixer for s in cfg.blocks()]
    n_rg, n_swa, n_sl = (kinds.count(k) for k in (RGLRU, SWA, SLSTM))
    n_ml = kinds.count(MLSTM) if cfg.mlstm_impl == "chunked" else 0
    ops = {"flash": layers.flash_attention, "rglru": layers.rglru_scan,
           "mlstm": layers.mlstm_chunk}
    tag = f"phase 8 {arch}"
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    torch.cuda.synchronize()
    print(f"# {tag}: {cfg.n_layers} layers at full width "
          f"({kinds.count(RGLRU)} RG-LRU, {n_swa} local attention, "
          f"{kinds.count(MLSTM)} mLSTM ({cfg.mlstm_impl}), {n_sl} sLSTM), "
          f"{sum(p.numel() for p in model.parameters())} parameters in "
          f"{model.embed.dtype} on the card, drawn in "
          f"{time.perf_counter() - t0:.2f} s; batch {B}, prompt {S}, "
          f"{steps} steps on {smi}")
    serve.serve(cfg, batch=B, prompt_len=S, steps=2, model=model, seed=1)
    torch.cuda.synchronize()

    # -- (a) serving: counts split at the end of the prefill ----------------
    prefill = model.prefill
    after_prefill = {}

    def prefill_and_count(*a, **kw):
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        after_prefill.update(read_launches(counters))
        return out

    reset_launches(counters)
    with _patched(model, prefill=prefill_and_count):
        run = serve.serve(cfg, batch=B, prompt_len=S, steps=steps,
                          model=model, seed=0)
    torch.cuda.synchronize()
    total = read_launches(counters)
    decode = {n: total[n] - after_prefill[n] for n in total}
    tokens = run["tokens"]
    check(tuple(tokens.shape) == (B, steps) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.padded_vocab,
          f"{tag}: generated tokens {tuple(tokens.shape)} out of range")
    flash_prefill = sum(after_prefill[n] for n in flash_routes)
    check(flash_prefill == n_swa and after_prefill["rglru_scan"] == n_rg
          and after_prefill["mlstm_chunk"] == n_ml,
          f"{tag} prefill: expected {n_swa} flash, {n_rg} rglru_scan and "
          f"{n_ml} mlstm_chunk launches, got {after_prefill}")
    check(decode["rglru_scan"] == n_rg * (steps - 1)
          and sum(decode.values()) == decode["rglru_scan"],
          f"{tag} decode: expected {n_rg * (steps - 1)} rglru_scan launches "
          f"and no other, got {decode}")
    route = next((n for n in flash_routes if after_prefill[n]), None)
    print(f"{tag} (a): served {B} prompts of {S} tokens, {steps} tokens "
          f"each: prefill {run['prefill_ms']:.3f} ms, decode "
          f"{run['decode_ms_per_step']:.3f} ms a step, "
          f"{run['tokens_per_s']:.1f} tokens/s on {smi}")
    print(f"# {tag} launches: prefill {after_prefill}; {steps - 1} decode "
          f"steps {decode} (flash route: {route})")

    caches, batch = run["caches"], run["batch"]
    tok = tokens[:, -1:].to(dev)

    def go_prefill():
        return model.prefill(batch, cache_len=S + steps)

    def go_decode():
        return model.decode_step(tok, caches, S + steps - 1)

    raw = {"prefill": profile_launch(go_prefill),
           "decode step": profile_launch(go_decode)}
    prof = {w: _by_kernel(r) for w, r in raw.items()}
    shares = {}
    for what, wall in (("prefill", run["prefill_ms"]),
                       ("decode step", run["decode_ms_per_step"])):
        p = prof[what]
        busy = sum(p.values())
        shares[what] = {k: ms / wall for k, ms in p.items()}
        parts = ", ".join(f"{k} {ms:.4f} ms ({ms / wall:.4f})"
                          for k, ms in p.items() if ms)
        print(f"# {tag} {what}: device busy {busy:.4f} ms of {wall:.4f} ms "
              f"(busy share {busy / wall:.4f}): {parts} on {smi}")
        _print_others(f"{arch} {what}", raw[what], 6)

    slstm_ms = None
    if n_sl:   # the sLSTM's per-step loop in the prefill: host-bound
        op_slstm, spent = layers.slstm, []

        def timed_slstm(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = op_slstm(*a, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)
            return out

        with _patched(layers, slstm=timed_slstm):
            torch.cuda.synchronize()
            t = time.perf_counter()
            go_prefill()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        slstm_ms = sum(spent) * 1e3
        print(f"# {tag} prefill: its {len(spent)} sLSTM layers take "
              f"{slstm_ms:.3f} ms of a {wall:.3f} ms prefill ({S} steps "
              f"each, a per-step loop of plain ops: host-bound) on {smi}")

    # -- (b) a second run whose layers capture a seeded sample --------------
    rnd = random.Random(0)
    pools = {"flash": n_swa, "rglru": n_rg, "drglru": n_rg * (steps - 1),
             "mlstm": n_ml}
    pick = {k: set(rnd.sample(range(n), min(CAPTURE_SAMPLE, n)))
            for k, n in pools.items()}
    seen = dict.fromkeys(pools, 0)
    captured = {k: [] for k in pools}

    def copies(ts):   # the layers go on to write the caches in place
        return tuple(t.clone() if isinstance(t, torch.Tensor) else t
                     for t in ts)

    def keep(kind, args, out):
        if seen[kind] in pick[kind]:
            captured[kind].append((copies(args), out if isinstance(
                out, torch.Tensor) else copies(out)))
        seen[kind] += 1

    def flash_capture(q, k, v, causal, window):
        out = ops["flash"](q, k, v, causal, window)
        keep("flash", (q, k, v, causal, window), out)
        return out

    def rglru_capture(a, x, h0):
        out = ops["rglru"](a, x, h0)
        keep("drglru" if a.shape[1] == 1 else "rglru", (a, x, h0), out)
        return out

    def mlstm_capture(q, k, v, lf, gi, bt):
        out = ops["mlstm"](q, k, v, lf, gi, bt)
        keep("mlstm", (q, k, v, lf, gi, bt), out)
        return out

    with _patched(layers, flash_attention=flash_capture,
                  rglru_scan=rglru_capture, mlstm_chunk=mlstm_capture):
        again = serve.serve(cfg, batch=B, prompt_len=S, steps=steps,
                            model=model, seed=0)
    check(torch.equal(again["tokens"], tokens),
          f"{tag} (b): a second run generated other tokens")
    del again
    check(all(len(captured[k]) == len(pick[k]) for k in pools),
          f"{tag} (b): capture missed calls: "
          f"{ {k: len(v) for k, v in captured.items()} }")

    pre_bound, pre_by, dec_bound, dec_by, text = _model_bounds(
        model, B, S, steps, caches)
    print(f"# {tag} bounds: prefill {pre_bound:.4f} ms by {pre_by}, decode "
          f"step {dec_bound:.4f} ms by {dec_by} ({text}); measured "
          f"{run['prefill_ms'] / pre_bound:.2f}x and "
          f"{run['decode_ms_per_step'] / dec_bound:.2f}x the bounds on {smi}")

    errs, done = {}, []
    for (q, k, v, causal, window), out in captured["flash"]:
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = BF16_ATTN_TOL if q.dtype == torch.bfloat16 else 2e-5
        check(_close(out, want, tol),
              f"{tag} (b): flash attention {tuple(q.shape)} != plain")
        errs["flash"] = max(errs.get("flash", 0.0), _err(out, want))
    for kind in ("rglru", "drglru"):
        for (a, x, h0), (h, hT) in captured[kind]:
            ph, phT = rglru_scan_plain(a, x, h0)
            check(torch.equal(h, ph) and torch.equal(hT, phT),
                  f"{tag} (b): rglru_scan {tuple(a.shape)} not bit-equal "
                  "to its plain version")
            errs[kind] = 0.0
    norm = 0.0
    for (q, k, v, lf, gi, bt), (y, c) in captured["mlstm"]:
        py, pc = mlstm_chunk_plain(q, k, v, lf, gi, bt=bt)
        check(_close(y, py, 2e-3) and _close(c, pc, 2e-3),
              f"{tag} (b): mlstm_chunk {tuple(v.shape)} != plain")
        errs["mlstm"] = max(errs.get("mlstm", 0.0), _err(y, py),
                            _err(c, pc))
        hd = q.shape[-1]
        norm = max(norm, float(y[..., hd].abs().max()))
    for kind, calls in captured.items():
        if calls:
            done.append(f"{len(calls)} {kind} calls "
                        f"{tuple(calls[0][0][0].shape)} (max abs err "
                        f"{errs[kind]:.4g})")
    print(f"{tag} (b): {'; '.join(done)} within phase 5's tolerances of "
          f"the plain versions{' (rglru_scan bit-equal)' if n_rg else ''} "
          f"on {smi}")
    if captured["mlstm"]:
        print(f"# {tag} (b): the normalizer column: max |q·n| {norm:.4g} "
              "(h = q·C / max(|q·n|, 1))")

    # kernel, plain version and library call at the model's shapes
    timing = {}
    if captured["flash"]:
        (q, k, v, _, window), _ = captured["flash"][0]
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        Bq, H, Sq, d = qc.shape
        pos = torch.arange(Sq, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - (window or Sq))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        timing[route] = (
            lambda: flash_attention_fwd(qc, kc, vc, causal=True,
                                        window=window),
            lambda: flash_attention_plain(qc, kc, vc, causal=True,
                                          window=window),
            lambda: sdpa(qc, kc, vc, attn_mask=band), _nbytes(qc, kc, vc, qc),
            4.0 * d * Bq * H * _attn_pairs(Sq, window),
            BF16_OPS_PER_S if qc.dtype == torch.bfloat16
            else F32_OPS_PER_S)
    for kind, name in (("rglru", "rglru_scan"),
                       ("drglru", "rglru_scan decode")):
        if captured[kind]:
            (a, x, h0), _ = captured[kind][0]
            timing[name] = (
                lambda a=a, x=x, h0=h0: rglru_scan_fwd(a, x, h0),
                lambda a=a, x=x, h0=h0: rglru_scan_plain(a, x, h0), None,
                _nbytes(a, x, a, h0, h0), 2.0 * a.numel(), F32_OPS_PER_S)
    if captured["mlstm"]:
        (q, k, v, lf, gi, bt), _ = captured["mlstm"][0]
        BH, Sm, dk = q.shape
        timing["mlstm_chunk"] = (
            lambda: mlstm_chunk_fwd(q, k, v, lf, gi, bt=bt),
            lambda: mlstm_chunk_plain(q, k, v, lf, gi, bt=bt), None,
            _nbytes(q, k, v, lf, gi, v) + BH * dk * v.shape[-1] * 4,
            _mlstm_ops(BH, Sm, dk, v.shape[-1], bt), F32_OPS_PER_S)
    times = {}
    for name, (fwd, plain, lib, nbytes, n_ops, rate) in timing.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / rate
        times[name] = {
            "ms": time_ms(fwd, 10), "plain_ms": time_ms(plain, 3),
            "library_ms": time_ms(lib, 10) if lib else None,
            "device_ms": sum(profile_launch(fwd).values()) or None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        tm = times[name]
        lib_txt = "none" if lib is None else f"{tm['library_ms']:.4f} ms"
        print(f"# {tag} {name} at the model's shape: kernel {tm['ms']:.4f} "
              f"ms (device {tm['device_ms']} ms), plain {tm['plain_ms']:.4f} "
              f"ms, library call {lib_txt}, bound {tm['bound_ms']:.4g} ms "
              f"by {tm['bound_by']} on {smi}")
    del captured, run, caches

    # -- (c) the whole model in f32: kernels against plain versions ---------
    if n_ml:   # xlstm-125m's first blocks, its own weights
        keep = _cut_depth(cfg, P8_XLSTM_F32_LAYERS)
        m32 = Model(keep, device="meta")
        m32.load_state_dict({
            n: t for n, t in model.state_dict().items()
            if not n.startswith("blocks.")
            or int(n.split(".")[1]) < keep.n_layers}, assign=True)
        n_ml = sum(b.mixer == MLSTM for b in keep.blocks())
        del model
        torch.cuda.empty_cache()
    elif model.embed.dtype != torch.float32:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        m32 = Model(cfg32, device="meta")
        m32.load_state_dict({n: t.float()
                             for n, t in model.state_dict().items()},
                            assign=True)
        del model
        torch.cuda.empty_cache()
    else:
        m32 = model
        del model

    def f32_run():
        logits, cache = m32.prefill(batch, cache_len=S + 1)
        first = logits[:, -1].argmax(-1)[:, None]
        step, _ = m32.decode_step(first, cache, S)
        torch.cuda.synchronize()
        return torch.cat([logits, step], 1), first, \
            step[:, -1].argmax(-1)[:, None]

    reset_launches(counters)
    logits_k, first_k, next_k = f32_run()
    f32_counts = read_launches(counters)
    check(f32_counts["flash_attention"] == n_swa
          and f32_counts["rglru_scan"] == 2 * n_rg
          and f32_counts["mlstm_chunk"] == n_ml,
          f"{tag} (c): the f32 prefill and decode step missed the f32 "
          f"kernels: {f32_counts}")
    plain_ops = dict(
        flash_attention=lambda q, k, v, causal, window:
            flash_attention_plain(q, k, v, causal=causal, window=window),
        rglru_scan=rglru_scan_plain,
        mlstm_chunk=lambda q, k, v, lf, gi, bt:
            mlstm_chunk_plain(q, k, v, lf, gi, bt=bt))
    with _patched(layers, **plain_ops):
        logits_p, first_p, next_p = f32_run()
    floor_text = ""
    if n_ml:   # the rounding floor: the plain mLSTM in chunks of 64
        with _patched(layers, **dict(plain_ops, mlstm_chunk=lambda q, k, v,
                                     lf, gi, bt: mlstm_chunk_plain(
                                         q, k, v, lf, gi, bt=64))):
            other, _, _ = f32_run()
        floor = _err(other, logits_p)
        check(floor > 0, f"{tag} (c): chunks of 64 and {cfg.mlstm_chunk} "
              "gave the same logits: no rounding floor to tie to")
        model_tol = (min(model_tol[0], XLSTM_FLOOR_MULT * floor), 0.0)
        floor_text = (f" ({XLSTM_FLOOR_MULT:g} times the rounding floor: "
                      f"the plain versions in chunks of 64 instead of "
                      f"{cfg.mlstm_chunk} move the logits by {floor:.4g})")
    err = _err(logits_k, logits_p)
    check(_close(logits_k, logits_p, model_tol),
          f"{tag} (c): f32 logits on the kernels differ from the plain "
          f"versions' by {err:.4g}, past {_tol_text(model_tol)}"
          f"{floor_text}")
    check(torch.equal(first_k, first_p) and torch.equal(next_k, next_p),
          f"{tag} (c): greedy tokens on the kernels differ from the plain "
          "versions'")
    top2 = torch.topk(logits_p[:, -1], 2).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    # planted errors: the RG-LRU decode step from h0 = 0 (the carried
    # state dropped); the mLSTM's forget gates one step late in the
    # kernel's input; the chunked prefill's mLSTM state handed to the
    # decode in the wrong scaling (m = -1e30, the empty state's, instead
    # of 0: the decode then drops it)
    planted = {}
    if n_rg:
        planted["the RG-LRU decode step's h0 dropped"] = dict(
            rglru_scan=lambda a, x, h0: ops["rglru"](a, x,
                                                     torch.zeros_like(h0)))
    if n_ml:
        planted["the mLSTM forget gates one step late"] = dict(
            mlstm_chunk=lambda q, k, v, lf, gi, bt: ops["mlstm"](
                q, k, v, torch.roll(lf, 1, 1), gi, bt))
        chunked = layers.mlstm_chunked

        def empty_scaling(*a, **kw):
            y, st = chunked(*a, **kw)
            return y, dict(st, m=torch.full_like(st["m"], -1e30))
        planted["the mLSTM prefill state handed on with m = -1e30"] = dict(
            mlstm_chunked=empty_scaling)
    seen_err = []
    for what, patch in planted.items():
        with _patched(layers, **patch):
            bad, _, _ = f32_run()
        check(not _close(bad, logits_p, model_tol),
              f"{tag} (c): tolerance {_tol_text(model_tol)} misses "
              f"{what}")
        seen_err.append(f"{what}: max abs err {_err(bad, logits_p):.4g}")
    if n_ml:
        seen_err.append(_normalizer_planted(m32, f32_run, ops["mlstm"],
                                            plain_ops, tag))
    print(f"{tag} (c): f32 prefill and decode step of "
          f"{len(m32.blocks)} blocks on the kernels "
          f"({f32_counts}) within {_tol_text(model_tol)}{floor_text} of the "
          f"plain versions (max abs err {err:.4g}, logits up to "
          f"{float(logits_p.abs().max()):.4g}); greedy tokens identical "
          f"(smallest top-2 margin {margin:.4g}); refuses "
          f"{'; '.join(seen_err)}; on {smi}")
    del m32
    torch.cuda.empty_cache()

    out = {}
    if route:
        out[route] = dict(
            times[route], launches_prefill=after_prefill[route],
            launches_decode=decode[route], max_abs_err=errs["flash"],
            device_ms_prefill=prof["prefill"]["flash_attention"],
            share_prefill=shares["prefill"]["flash_attention"])
        out.setdefault("flash_attention", {}).update(
            launches_f32_prefill=f32_counts["flash_attention"],
            max_abs_err_f32_logits=err)
    if n_rg:
        out["rglru_scan"] = dict(
            times["rglru_scan"], decode=times["rglru_scan decode"],
            launches_prefill=after_prefill["rglru_scan"],
            launches_decode=decode["rglru_scan"], max_abs_err=0.0,
            device_ms_prefill=prof["prefill"]["rglru_scan"],
            share_prefill=shares["prefill"]["rglru_scan"],
            device_ms_decode_step=prof["decode step"]["rglru_scan"],
            share_decode_step=shares["decode step"]["rglru_scan"],
            launches_f32_prefill_and_step=f32_counts["rglru_scan"],
            max_abs_err_f32_logits=err)
    if n_ml:
        out["mlstm_chunk"] = dict(
            times["mlstm_chunk"],
            launches_prefill=after_prefill["mlstm_chunk"],
            launches_decode=decode["mlstm_chunk"],
            max_abs_err=errs["mlstm"],
            device_ms_prefill=prof["prefill"]["mlstm_chunk"],
            share_prefill=shares["prefill"]["mlstm_chunk"],
            slstm_host_ms_prefill=slstm_ms,
            launches_f32_prefill_and_step=f32_counts["mlstm_chunk"],
            max_abs_err_f32_logits=err)
    return out


def _normalizer_planted(m32, f32_run, op_mlstm, plain_ops, tag: str
                        ) -> str:
    """Phase 8 (c)'s planted mLSTM normalizer error.  At the drawn weights
    |q·n| < 1, where ``h = q·C / max(|q·n|, 1)`` does not read the
    normalizer; with q and k ``MLSTM_QK_SCALE`` times larger (the mLSTM
    blocks' ``w_qkv`` columns, restored after) it passes 1.  The weights
    change, and with them the sLSTM's amplification of rounding, so the
    tolerance is tied to the rounding floor at these weights as (c) ties
    it at the drawn ones.  There the kernels must stay within it of the
    plain versions, and the kernel fed ``v`` with its column of ones
    zeroed must not."""
    import torch
    from repro_torch.configs.base import MLSTM
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_plain
    from repro_torch.models import layers
    blocks = [b for b in m32.blocks if b.spec.mixer == MLSTM]
    cols = 2 * 2 * m32.cfg.d_model            # q and k: 2 d_model each
    qn = []

    def mlstm_seen(q, k, v, lf, gi, bt):
        y, c = op_mlstm(q, k, v, lf, gi, bt)
        qn.append(float(y[..., q.shape[-1]].abs().max()))
        return y, c

    def ones_zeroed(q, k, v, lf, gi, bt):
        v = v.clone()
        v[..., q.shape[-1]] = 0
        return op_mlstm(q, k, v, lf, gi, bt)

    with torch.no_grad():
        for b in blocks:
            b.mixer.p["w_qkv"][:, :cols] *= MLSTM_QK_SCALE
    try:
        with _patched(layers, **plain_ops):
            want, _, _ = f32_run()
        with _patched(layers, **dict(plain_ops, mlstm_chunk=lambda q, k, v,
                                     lf, gi, bt: mlstm_chunk_plain(
                                         q, k, v, lf, gi, bt=64))):
            other, _, _ = f32_run()
        with _patched(layers, mlstm_chunk=mlstm_seen):
            good, _, _ = f32_run()
        with _patched(layers, mlstm_chunk=ones_zeroed):
            bad, _, _ = f32_run()
    finally:
        with torch.no_grad():
            for b in blocks:
                b.mixer.p["w_qkv"][:, :cols] /= MLSTM_QK_SCALE
    floor = _err(other, want)
    tol = (min(XLSTM_MODEL_TOL[0], XLSTM_FLOOR_MULT * floor), 0.0)
    check(max(qn) > 1.0, f"{tag} (c): q, k x {MLSTM_QK_SCALE:g} left max "
          f"|q·n| at {max(qn):.4g}: the normalizer is not read")
    check(floor > 0 and _close(good, want, tol),
          f"{tag} (c): with q, k x {MLSTM_QK_SCALE:g} the kernels differ "
          f"from the plain versions by {_err(good, want):.4g}, past "
          f"{_tol_text(tol)} (rounding floor {floor:.4g})")
    check(not _close(bad, want, tol),
          f"{tag} (c): tolerance {_tol_text(tol)} misses the "
          "normalizer's ones column zeroed")
    return (f"the normalizer's ones column zeroed at q, k x "
            f"{MLSTM_QK_SCALE:g} (max |q·n| {max(qn):.4g}; rounding floor "
            f"{floor:.4g}, tolerance {_tol_text(tol)}, the kernels "
            f"{_err(good, want):.4g} from the plain versions): max abs err "
            f"{_err(bad, want):.4g}")


def phase8(dev, smi: str) -> dict:
    """Phase 8: the recurrent families on the model's serving path at full
    width and depth (``P8_MODELS``).  Returns the kernels line's entries,
    by model and kernel name."""
    return {m[0]: _phase8_model(dev, smi, *m, P8_STEPS) for m in P8_MODELS}


def _whisper_bounds(model, B: int, S: int, E: int, steps: int,
                    caches) -> tuple:
    """(prefill bound ms, by, decode-step bound ms, by, text) of
    whisper's serving path: the prefill by its operations at the bf16
    peak — the frontend's projection and every encoder matrix over B·E
    frames, bidirectional attention over E² pairs a layer and head, each
    decoder layer's self-attention, FFN and cross q/o matrices over B·S
    tokens, its cross k/v projections over B·E frames, causal attention
    over S(S+1)/2 pairs and cross-attention over S·E, the last position's
    logits — or its weights' bytes; a decode step by the bytes it must
    read and write: the decoder's weights but the cross k/v projections
    (used only in the prefill), the unembedding, B embedding rows, every
    layer's self and cross caches, and the new keys and values."""
    cfg = model.cfg
    D, H, hd, Vp = cfg.d_model, cfg.n_heads, cfg.hd, cfg.padded_vocab
    L_enc, L_dec = cfg.enc_layers, cfg.n_layers

    def mats(mods):
        return sum(p.numel() for m in mods for p in m.parameters()
                   if p.dim() >= 2)
    cross_kv = sum(blk.cross.p[n].numel() for blk in model.blocks
                   for n in ("wk", "wv"))
    dec_mats = mats(model.blocks) - cross_kv
    ops = {"encoder matrices": 2.0 * B * E * (D * D + mats(model.enc.blocks)),
           "encoder attention": 4.0 * hd * B * H * E * E * L_enc,
           "cross k/v projections": 2.0 * B * E * cross_kv,
           "decoder matrices": 2.0 * B * S * dec_mats,
           "decoder self-attention": 4.0 * hd * B * H * (S * (S + 1) / 2)
           * L_dec,
           "cross-attention": 4.0 * hd * B * H * S * E * L_dec,
           "logits": 2.0 * B * D * Vp}
    n_ops = sum(ops.values())
    elt = model.embed.element_size()
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    t_ops, t_w = n_ops / BF16_OPS_PER_S, w_bytes / HBM_BYTES_PER_S
    dec_w = sum(p.numel() for p in model.blocks.parameters()) - cross_kv
    head = model.lm_head.numel() if model.lm_head is not None \
        else model.embed.numel()
    w_read = (dec_w + head + B * D
              + sum(p.numel() for p in model.final_norm.parameters())) * elt
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values())
    new_kv = 2 * B * cfg.n_kv_heads * hd * elt * L_dec
    dec_bytes = w_read + cache_bytes + new_kv
    text = (f"prefill {n_ops:.6g} operations ("
            + ", ".join(f"{k} {v:.6g}" for k, v in ops.items())
            + f") at 989 TFLOP/s, weights {w_bytes} B; decode step "
            f"{dec_bytes} B (weights read {w_read}, caches {cache_bytes}, "
            f"new k/v {new_kv}) at 3.35 TB/s")
    return (max(t_ops, t_w) * 1e3, "operations" if t_ops >= t_w else "bytes",
            dec_bytes / HBM_BYTES_PER_S * 1e3, "bytes", text)


def phase9(dev, smi: str) -> dict:
    """Phase 9: the encoder–decoder family on the serving path at
    whisper-large-v3's full width and depth, through
    ``repro_torch.launch.serve``, with flash attention on the encoder,
    the decoder's self-attention and the cross-attention of the prefill
    and of every decode step.  Returns what the kernels line carries, by
    kernel name."""
    import dataclasses
    import random
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _cuda as kernel_lib
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    from repro_torch.launch import serve
    from repro_torch.models import WHISPER_CROSS_LEN, Model, layers

    counters = launch_counters()
    cfg = configs.get_config(WHISPER_ARCH)
    B, S, steps, E = WHISPER_B, WHISPER_S, WHISPER_STEPS, WHISPER_CROSS_LEN
    L_enc, L_dec = cfg.enc_layers, cfg.n_layers
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    op_flash = layers.flash_attention
    t0 = time.perf_counter()
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    torch.cuda.synchronize()
    print(f"# phase 9: {cfg.name} at full width and depth ({L_enc} encoder "
          f"and {L_dec} decoder layers, d_model {cfg.d_model}, {H} heads of "
          f"{hd}), {sum(p.numel() for p in model.parameters())} parameters "
          f"in {model.embed.dtype} on the card, drawn in "
          f"{time.perf_counter() - t0:.2f} s; batch {B}, {E} frames, text "
          f"prompt {S}, {steps} steps on {smi}")

    def run_serve(seed: int, n_steps: int = steps):
        return serve.serve(cfg, batch=B, prompt_len=S, steps=n_steps,
                           model=model, seed=seed, enc_len=E)

    run_serve(1, 2)       # warm-up at the main path's shapes
    torch.cuda.synchronize()

    # -- (a) serving: counts split at the end of the prefill ----------------
    prefill = model.prefill
    after_prefill = {}

    def prefill_and_count(*a, **kw):
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        after_prefill.update(read_launches(counters))
        return out

    reset_launches(counters)
    with _patched(model, prefill=prefill_and_count):
        run = run_serve(0)
    torch.cuda.synchronize()
    total = read_launches(counters)
    decode = {n: total[n] - after_prefill[n] for n in total}
    tokens, caches, batch = run["tokens"], run["caches"], run["batch"]
    check(tuple(tokens.shape) == (B, steps) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.padded_vocab,
          f"phase 9: generated tokens {tuple(tokens.shape)} out of range")
    n_pre, n_dec = L_enc + 2 * L_dec, L_dec * (steps - 1)
    check(after_prefill["flash_attention_sm90"] == n_pre
          and sum(after_prefill.values()) == n_pre,
          f"phase 9 prefill: expected {n_pre} flash_attention_sm90 launches "
          f"({L_enc} encoder, {L_dec} decoder self-attention, {L_dec} "
          f"cross-attention) and no other, got {after_prefill}")
    check(decode["flash_attention_sm90"] == n_dec
          and sum(decode.values()) == n_dec,
          f"phase 9 decode: expected {n_dec} flash_attention_sm90 launches "
          f"(the cross-attention of {L_dec} layers a step) and no other, "
          f"got {decode}")
    for c in caches:
        for n in ("cross_k", "cross_v"):
            check(tuple(c[n].shape) == (B, hkv, E, hd)
                  and c[n].is_contiguous()
                  and bool(torch.isfinite(c[n]).all()),
                  f"phase 9: cross cache {n} {tuple(c[n].shape)} not "
                  f"head-major [B, Hkv, {E}, hd], contiguous and finite")
    print(f"phase 9 (a): served {B} prompts of {E} frames and {S} text "
          f"tokens, {steps} tokens each: prefill {run['prefill_ms']:.3f} "
          f"ms, decode {run['decode_ms_per_step']:.3f} ms a step, "
          f"{run['tokens_per_s']:.1f} tokens/s on {smi}")
    print(f"# phase 9 launches: prefill {after_prefill}; {steps - 1} decode "
          f"steps {decode}")

    tok = tokens[:, -1:].to(dev)

    def go_prefill():
        return model.prefill(batch, cache_len=S + steps)

    def go_decode():
        return model.decode_step(tok, caches, S + steps - 1)

    raw = {"prefill": profile_launch(go_prefill),
           "decode step": profile_launch(go_decode)}
    prof = {w: _by_kernel(r) for w, r in raw.items()}
    # the flash inputs that the wrapper copies to contiguous tensors (the
    # profile's copy kernels hold them among others)
    prepare, copied = kernel_lib.prepare, []

    def counting_prepare(operands, *a, **kw):
        copied.append(sum(t.numel() * t.element_size() for t in operands
                          if not t.is_contiguous()))
        return prepare(operands, *a, **kw)

    copies = {}
    with _patched(kernel_lib, prepare=counting_prepare):
        for what, go in (("prefill", go_prefill), ("decode step", go_decode)):
            copied.clear()
            go()
            copies[what] = sum(copied)
    shares = {}
    for what, wall in (("prefill", run["prefill_ms"]),
                       ("decode step", run["decode_ms_per_step"])):
        p = prof[what]
        busy = sum(p.values())
        shares[what] = {k: ms / wall for k, ms in p.items()}
        print(f"# phase 9 {what}: the flash wrapper copies {copies[what]} B "
              f"of non-contiguous inputs (at least "
              f"{2 * copies[what] / HBM_BYTES_PER_S * 1e3:.4f} ms of copying "
              f"at 3.35 TB/s)")
        print(f"# phase 9 {what}: device busy {busy:.4f} ms of {wall:.4f} "
              f"ms (busy share {busy / wall:.4f}): flash attention "
              f"{p['flash_attention']:.4f} ms "
              f"({p['flash_attention'] / wall:.4f}), other "
              f"{p['other']:.4f} ms on {smi}")
        _print_others(f"whisper {what}", raw[what])

    pre_bound, pre_by, dec_bound, dec_by, text = _whisper_bounds(
        model, B, S, E, steps, caches)
    print(f"# phase 9 bounds: prefill {pre_bound:.4f} ms by {pre_by}, "
          f"decode step {dec_bound:.4f} ms by {dec_by} ({text}); measured "
          f"{run['prefill_ms'] / pre_bound:.2f}x and "
          f"{run['decode_ms_per_step'] / dec_bound:.2f}x the bounds on {smi}")

    # -- (b) a second run whose flash calls are sampled ----------------------
    rnd = random.Random(0)
    pools = {"encoder": L_enc, "cross prefill": L_dec, "cross decode": n_dec}
    pick = {k: set(rnd.sample(range(n), CAPTURE_SAMPLE))
            for k, n in pools.items()}
    seen = dict.fromkeys(pools, 0)
    captured = {k: [] for k in pools}

    def kind_of(q, k, causal):
        """The attention a flash call computes: the decoder's
        self-attention is the causal one, the encoder's the square
        bidirectional one."""
        if causal:
            return None
        if q.shape[2] == k.shape[2]:
            return "encoder"
        return "cross decode" if q.shape[2] == 1 else "cross prefill"

    def flash_capture(q, k, v, causal, window):
        out = op_flash(q, k, v, causal, window)
        kind = kind_of(q, k, causal)
        if kind is not None:
            if seen[kind] in pick[kind]:
                captured[kind].append(((q, k, v, causal, window), out))
            seen[kind] += 1
        return out

    with _patched(layers, flash_attention=flash_capture):
        again = run_serve(0)
    check(torch.equal(again["tokens"], tokens),
          "phase 9 (b): a second run generated other tokens")
    del again
    check(all(len(captured[k]) == CAPTURE_SAMPLE for k in pools),
          f"phase 9 (b): capture missed calls: "
          f"{ {k: len(v) for k, v in captured.items()} }")
    errs, done = {}, []
    for kind, calls in captured.items():
        for (q, k, v, causal, window), out in calls:
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            check(_close(out, want, BF16_ATTN_TOL),
                  f"phase 9 (b): {kind} flash attention {tuple(q.shape)} x "
                  f"{tuple(k.shape)} != plain")
            errs[kind] = max(errs.get(kind, 0.0), _err(out, want))
        (q, k, _, _, _), _ = calls[0]
        done.append(f"{len(calls)} {kind} calls {tuple(q.shape)} x "
                    f"{tuple(k.shape)} (max abs err {errs[kind]:.4g})")
    print(f"phase 9 (b): {'; '.join(done)} within "
          f"{_tol_text(BF16_ATTN_TOL)} of the plain version on {smi}")

    # kernel, plain version and SDPA at the encoder's and the cross decode's
    # shapes
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for kind in ("encoder", "cross decode"):
        (q, k, v, _, _), _ = captured[kind][0]
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        Bq, Hq, Sq, d = qc.shape
        Sk = kc.shape[2]
        t_bytes = _nbytes(qc, kc, vc, qc) / HBM_BYTES_PER_S
        t_ops = 4.0 * d * Bq * Hq * Sq * Sk / BF16_OPS_PER_S
        fwd = (lambda qc=qc, kc=kc, vc=vc:
               flash_attention_fwd(qc, kc, vc, causal=False))
        times[kind] = {
            "shape": [list(qc.shape), list(kc.shape)],
            "ms": time_ms(fwd, 10),
            "plain_ms": time_ms(lambda: flash_attention_plain(
                qc, kc, vc, causal=False), 3),
            "library_ms": time_ms(lambda: sdpa(qc, kc, vc), 10),
            "device_ms": sum(profile_launch(fwd).values()) or None,
            "library_device_ms": sum(profile_launch(
                lambda: sdpa(qc, kc, vc)).values()) or None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        tm = times[kind]
        print(f"# phase 9 flash_attention_sm90 at the {kind} shape "
              f"{tuple(qc.shape)} x {tuple(kc.shape)}: kernel "
              f"{tm['ms']:.4f} ms (device {tm['device_ms']} ms), plain "
              f"{tm['plain_ms']:.4f} ms, SDPA {tm['library_ms']:.4f} ms "
              f"(device {tm['library_device_ms']} ms), bound "
              f"{tm['bound_ms']:.4g} ms by {tm['bound_by']} on {smi}")
    del captured, run, caches

    # -- (c) the same model in f32: the kernel against the plain version ----
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    m32 = Model(cfg32, device="meta")
    m32.load_state_dict({n: t.float() for n, t in model.state_dict().items()},
                        assign=True)
    del model
    torch.cuda.empty_cache()

    def f32_run(tamper=None):
        logits, cache = m32.prefill(batch, cache_len=S + 1)
        first = logits[:, -1].argmax(-1)[:, None]
        if tamper is not None:
            tamper(cache)
        step, _ = m32.decode_step(first, cache, S)
        torch.cuda.synchronize()
        return torch.cat([logits, step], 1), first, \
            step[:, -1].argmax(-1)[:, None]

    reset_launches(counters)
    logits_k, first_k, next_k = f32_run()
    f32_counts = read_launches(counters)
    check(f32_counts["flash_attention"] == n_pre + L_dec
          and sum(f32_counts.values()) == n_pre + L_dec,
          f"phase 9 (c): the f32 prefill and decode step missed the f32 "
          f"kernel: {f32_counts}")
    plain_flash = (lambda q, k, v, causal, window:
                   flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
    with _patched(layers, flash_attention=plain_flash):
        logits_p, first_p, next_p = f32_run()
    err = _err(logits_k, logits_p)
    check(_close(logits_k, logits_p, F32_MODEL_TOL),
          f"phase 9 (c): f32 logits on the kernel differ from the plain "
          f"version's by {err:.4g}, past {_tol_text(F32_MODEL_TOL)}")
    check(torch.equal(first_k, first_p) and torch.equal(next_k, next_p),
          "phase 9 (c): greedy tokens on the kernel differ from the plain "
          "version's")
    top2 = torch.topk(logits_p[:, -1], 2).values
    margin = float((top2[:, 0] - top2[:, 1]).min())

    # planted errors: the encoder's attention causal; each decoder layer's
    # decode step on the next layer's cross k/v; the cross cache zeroed
    def next_layers(cache):
        kv = [(c["cross_k"], c["cross_v"]) for c in cache]
        for i, c in enumerate(cache):
            c["cross_k"], c["cross_v"] = kv[(i + 1) % len(kv)]

    def zeroed(cache):
        for c in cache:
            c["cross_k"].zero_()
            c["cross_v"].zero_()

    causal_encoder = (lambda q, k, v, causal, window: op_flash(
        q, k, v, causal or q.shape[2] == k.shape[2], window))
    with _patched(layers, flash_attention=causal_encoder):
        bad_causal, _, _ = f32_run()
    planted = {"the encoder run causally": bad_causal,
               "each decoder layer on the next layer's cross k/v":
                   f32_run(next_layers)[0],
               "the decode step's cross cache zeroed": f32_run(zeroed)[0]}
    seen_err = []
    for what, bad in planted.items():
        check(not _close(bad, logits_p, F32_MODEL_TOL),
              f"phase 9 (c): tolerance {_tol_text(F32_MODEL_TOL)} misses "
              f"{what}")
        seen_err.append(f"{what}: max abs err {_err(bad, logits_p):.4g}")
    print(f"phase 9 (c): f32 prefill and decode step on the f32 kernel "
          f"({f32_counts}) within {_tol_text(F32_MODEL_TOL)} of the plain "
          f"version (max abs err {err:.4g}, logits up to "
          f"{float(logits_p.abs().max()):.4g}); greedy tokens identical "
          f"(smallest top-2 margin {margin:.4g}); refuses "
          f"{'; '.join(seen_err)}; on {smi}")
    del m32, planted
    torch.cuda.empty_cache()
    return {
        "flash_attention_sm90": dict(
            times["encoder"], cross_decode=times["cross decode"],
            launches_prefill=after_prefill["flash_attention_sm90"],
            launches_decode=decode["flash_attention_sm90"],
            max_abs_err=max(errs.values()),
            max_abs_err_by_kind=errs,
            device_ms_prefill=prof["prefill"]["flash_attention"],
            share_prefill=shares["prefill"]["flash_attention"],
            device_ms_decode_step=prof["decode step"]["flash_attention"],
            share_decode_step=shares["decode step"]["flash_attention"],
            copied_bytes_prefill=copies["prefill"],
            copied_bytes_decode_step=copies["decode step"],
            prefill_bound_ms=pre_bound, decode_step_bound_ms=dec_bound),
        "flash_attention": {"launches_f32_prefill_and_step":
                            f32_counts["flash_attention"],
                            "max_abs_err_f32_logits": err},
    }


def _state_digest(model, opt) -> dict:
    """Two checksums of the bits of every tensor of a train state (the
    parameters, AdamW's moments and count), by name: each tensor's bits
    as integers, summed, and summed weighted by position."""
    import torch
    ints = {2: torch.int16, 4: torch.int32}
    tensors = dict(model.state_dict(), count=opt["count"])
    for k in ("m", "v"):
        tensors.update({f"{k}.{n}": t for n, t in opt[k].items()})
    names = sorted(tensors)
    sums = []
    for n in names:
        t = tensors[n]
        bits = t.detach().reshape(-1).view(ints[t.element_size()]).long()
        w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return dict(zip(names, torch.stack(sums).tolist()))


def _train_diff(got: dict, want: dict) -> dict:
    """The largest differences of one f32 train step from another: loss
    (absolute), global gradient norm (relative), and over the parameters
    the gradient's and the update's relative L2."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))
    return {"loss": abs(got["loss"] - want["loss"]),
            "grad_norm": abs(got["grad_norm"] / want["grad_norm"] - 1),
            "grad": max(rel(got["grads"][n], g)
                        for n, g in want["grads"].items()),
            "update": max(rel(got["update"][n], u)
                          for n, u in want["update"].items())}


def _diff_text(d: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" for k, v in d.items())


def phase10(dev, smi: str) -> dict:
    """Phase 10: the training path at granite-moe-3b-a800m's full width on
    the card: (a) ``Trainer.run`` with a checkpoint and a restart, (b) the
    loss falling on one batch, (c) one f32 step on the kernels against the
    plain versions, with planted errors.  Returns the kernels line's
    ``train_path`` entries, by kernel name."""
    import dataclasses
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_plain
    from repro_torch.models import Model, layers
    from repro_torch.parallel import make_train_step
    from repro_torch.runtime import Trainer

    counters = launch_counters()
    cfg = configs.get_config(SERVE_ARCH)
    L, B, S = cfg.n_layers, TRAIN_B, TRAIN_S
    D, H, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
    C = int(math.ceil(B * S * cfg.moe.top_k / E * cfg.moe.capacity_factor))
    shape = ShapeCfg("phase10", S, B, "train")
    ckpt = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- (a) Trainer.run: 6 steps, a checkpoint after the 3rd, a restart ----
    tr = Trainer(cfg, shape, dev, ckpt_dir=ckpt, seed=0)
    tr.init_state()
    n_params = sum(p.numel() for p in tr.model.parameters())
    state_gb = sum(t.numel() * t.element_size() for t in (
        *tr.model.parameters(), *tr.opt["m"].values(),
        *tr.opt["v"].values())) / 1e9
    print(f"# phase 10: {cfg.name} at full width and depth, {n_params} "
          f"parameters in {tr.model.embed.dtype} and AdamW moments in "
          f"{cfg.opt_state_dtype}: a state of {state_gb:.2f} GB (the "
          f"process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
          f"the card); batch {B} x {S} tokens, remat, on {smi}")
    step_ms, losses, peaks = [], [], []
    digest = save_s = None
    want_fwd = {"flash_attention_sm90": L, "moe_gmm_sm90": 3 * L}
    try:
        for i in range(TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            reset_launches(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = tr.run(1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            total = read_launches(counters)
            check(all(total[n] == 2 * want_fwd.get(n, 0) for n in total),
                  f"phase 10 (a) step {i + 1}: expected twice {want_fwd} "
                  f"launches (the forward and the recompute), got {total}")
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            losses += rep.losses
            if i == 0:
                first_step = {"loss": rep.losses[0],
                              "digest": _state_digest(tr.model, tr.opt)}
            if tr.step == TRAIN_CKPT_AT:
                t0 = time.perf_counter()
                tr.save_checkpoint()
                save_s = time.perf_counter() - t0
                digest = _state_digest(tr.model, tr.opt)
        check(all(math.isfinite(x) for x in losses),
              f"phase 10 (a): losses {losses}")
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                         if f.is_file())
        ms = statistics.median(step_ms[1:])
        print(f"phase 10 (a): {TRAIN_STEPS} steps of Trainer.run: "
              f"{ms:.3f} ms a step (median of steps 2-{TRAIN_STEPS}; the "
              f"first {step_ms[0]:.1f} ms), {B * S / ms * 1e3:.1f} tokens/s, "
              f"peak memory {max(peaks):.2f} GB; launches a step: "
              f"{want_fwd} in the forward and again in the recompute; "
              f"losses {[round(x, 6) for x in losses]}; on {smi}")
        print(f"# phase 10 step ms: {[round(x, 3) for x in step_ms]}; "
              f"checkpoint after step {TRAIN_CKPT_AT}: {ckpt_bytes} B "
              f"written in {save_s:.2f} s")

        # one profiled step: device busy share and the kernels' time
        raw = profile_launch(lambda: tr.run(1))
        prof = _by_kernel(raw)
        # one more step: its launches split at the end of the forward, and
        # the rows the experts keep (each layer's first grouped matmul)
        live = []
        op_gmm, fwd = layers.moe_gmm, tr.model.forward_train
        after_fwd = {}

        def gmm_rows(x, w, counts):
            if x.shape[1] == C:
                live.append(counts.clone())
            return op_gmm(x, w, counts)

        def forward_and_count(*a, **kw):
            out = fwd(*a, **kw)
            torch.cuda.synchronize()
            after_fwd.update(read_launches(counters))
            return out

        reset_launches(counters)
        with _patched(layers, moe_gmm=gmm_rows), \
                _patched(tr.model, forward_train=forward_and_count):
            tr.run(1)
        total = read_launches(counters)
        back = {n: total[n] - after_fwd[n] for n in total}
        check(all(after_fwd[n] == back[n] == want_fwd.get(n, 0)
                  for n in total),
              f"phase 10 (a): expected {want_fwd} launches in the forward "
              f"and the same again in the backward (the recompute; the "
              f"backward's own oracles launch none), got {after_fwd} and "
              f"{back}")
        # the step's bound: three times the forward's products (forward,
        # and the backward's two products per forward product; remat's
        # recompute not counted) over the rows the experts keep and the
        # vocabulary's live columns, against the bytes of AdamW's state in
        # and out (bf16 weights, f32 moments read and written)
        rows = sum(int(c.sum()) for c in live[:3 * L:3])
        T = B * S
        fwd_ops = (2.0 * T * D * (2 * H * hd + 2 * hkv * hd + E) * L
                   + 2.0 * 3 * rows * D * Fe
                   + 4.0 * hd * B * H * (S * (S + 1) / 2) * L
                   + 2.0 * B * (S - 1) * D * cfg.vocab_size)
        step_ops = 3 * fwd_ops
        step_bytes = n_params * (2 + 4 + 4) * 2
        bound_ms = max(step_ops / BF16_OPS_PER_S,
                       step_bytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if step_ops / BF16_OPS_PER_S \
            >= step_bytes / HBM_BYTES_PER_S else "bytes"
        busy = sum(prof.values())
        print(f"# phase 10 profiled step: device busy {busy:.4f} ms of "
              f"{ms:.4f} ms (busy share {busy / ms:.4f}): flash attention "
              f"{prof['flash_attention']:.4f} ms "
              f"({prof['flash_attention'] / ms:.4f}), moe_gmm "
              f"{prof['moe_gmm']:.4f} ms ({prof['moe_gmm'] / ms:.4f}), other "
              f"{prof['other']:.4f} ms on {smi}")
        _print_others("train step", raw, 12)
        print(f"# phase 10 bound: {bound_ms:.4f} ms by {bound_by} "
              f"({step_ops:.6g} operations: 3 x a forward of "
              f"{fwd_ops:.6g}, moe_gmm over {rows} kept rows; "
              f"{step_bytes} B of weights and moments in and out) at 989 "
              f"TFLOP/s and 3.35 TB/s; measured {ms / bound_ms:.2f}x the "
              f"bound on {smi}")
        del tr, fwd, forward_and_count, gmm_rows
        torch.cuda.empty_cache()

        # the restart: a fresh Trainer from the checkpoint
        tb = Trainer(cfg, shape, dev, ckpt_dir=ckpt, seed=0)
        t0 = time.perf_counter()
        check(tb.maybe_restore() and tb.step == TRAIN_CKPT_AT,
              f"phase 10 (a): no restore to step {TRAIN_CKPT_AT}")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(_state_digest(tb.model, tb.opt) == digest,
              "phase 10 (a): the restored state is not the saved one, bit "
              "for bit")
        again = tb.run(TRAIN_STEPS - TRAIN_CKPT_AT).losses
        want = losses[TRAIN_CKPT_AT:]
        diff = max(abs(a - b) for a, b in zip(again, want))
        # the step repeats bit for bit: its forward has no atomics; in its
        # backward the indexing's scatters (index_put with accumulate) run
        # on sorted indices, and the label gather's adds each element once
        check(again == want,
              f"phase 10 (a): restarted losses {again} against {want}: "
              f"not bit-equal (max diff {diff:.3g})")
        print(f"phase 10 (a): restarted from the step-{TRAIN_CKPT_AT} "
              f"checkpoint in {restore_s:.2f} s: the state bit-equal to "
              f"the saved one (checksums of {len(digest)} tensors), "
              f"steps {TRAIN_CKPT_AT + 1}-{TRAIN_STEPS} lose {again}, "
              f"bit-equal to the uninterrupted run's, on {smi}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # -- (b) the loss falls on one repeated batch ------------------------------
    fit = make_train_step(cfg, tb.pcfg, peak_lr=1e-3, warmup=1,
                          total_steps=FIT_STEPS)
    batch = tb.data.batch_at(0)
    fit_losses = []
    reset_launches(counters)
    for i in range(FIT_STEPS):
        _, tb.opt, metrics = fit(tb.model, tb.opt, batch, i)
        fit_losses.append(float(metrics["loss"]))
    fit_counts = read_launches(counters)
    check(fit_counts["flash_attention_sm90"] == 2 * L * FIT_STEPS
          and fit_counts["moe_gmm_sm90"] == 6 * L * FIT_STEPS,
          f"phase 10 (b): launches {fit_counts}")
    check(all(math.isfinite(x) for x in fit_losses)
          and fit_losses[-1] <= fit_losses[0] - FIT_MARGIN,
          f"phase 10 (b): the loss fell from {fit_losses[0]} to "
          f"{fit_losses[-1]}, less than {FIT_MARGIN}")
    print(f"phase 10 (b): {FIT_STEPS} steps of make_train_step on one "
          f"batch (warmup 1, peak lr 1e-3): losses "
          f"{[round(x, 4) for x in fit_losses]}, a fall of "
          f"{fit_losses[0] - fit_losses[-1]:.4f} (at least {FIT_MARGIN}) "
          f"on {smi}")
    del tb, batch
    torch.cuda.empty_cache()

    # -- (c) one f32 step on the kernels against the plain versions ---------
    body = cfg.layer_groups[0][1]
    cfg32 = dataclasses.replace(
        cfg, n_layers=F32_TRAIN_LAYERS,
        layer_groups=((F32_TRAIN_LAYERS, body),),
        param_dtype="float32", compute_dtype="float32")
    m32 = Model(cfg32, generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
    init = {n: t.clone() for n, t in m32.state_dict().items()}
    batch = SyntheticLMData(cfg32, shape, 0, device=dev).batch_at(0)

    def f32_step(**patch) -> dict:
        return _f32_train_step(m32, init, batch,
                               [(layers, patch)] if patch else ())

    def within(d: dict) -> bool:
        return all(d[k] <= F32_TRAIN_TOL[k] for k in F32_TRAIN_TOL)

    reset_launches(counters)
    kern = f32_step()
    f32_counts = read_launches(counters)
    check(f32_counts["flash_attention"] == 2 * F32_TRAIN_LAYERS
          and f32_counts["moe_gmm"] == 6 * F32_TRAIN_LAYERS
          and sum(f32_counts.values()) == 8 * F32_TRAIN_LAYERS,
          f"phase 10 (c): the f32 step missed the f32 kernels: "
          f"{f32_counts}")
    plain = f32_step(
        flash_attention=lambda q, k, v, causal, window:
            flash_attention_plain(q, k, v, causal=causal, window=window),
        moe_gmm=moe_gmm_plain)
    d = _train_diff(kern, plain)
    check(within(d), f"phase 10 (c): the f32 step on the kernels differs "
          f"from the plain versions' ({_diff_text(d)}), past "
          f"{F32_TRAIN_TOL}")
    real_aux, op_flash = layers.moe_aux_loss, layers.flash_attention
    planted = {
        "the aux term dropped": dict(
            moe_aux_loss=lambda x, p, c: torch.zeros((), device=x.device)),
        "the aux term divided by the number of layers": dict(
            moe_aux_loss=lambda x, p, c: real_aux(x, p, c) / c.n_layers),
        "flash run non-causally": dict(
            flash_attention=lambda q, k, v, causal, window: op_flash(
                q, k, v, False, window))}
    refused = []
    for what, patch in planted.items():
        bad = _train_diff(f32_step(**patch), plain)
        check(not within(bad), f"phase 10 (c): tolerances "
              f"{F32_TRAIN_TOL} miss {what} ({_diff_text(bad)})")
        refused.append(f"{what}: {_diff_text(bad)}")
    print(f"phase 10 (c): one f32 train step at full width and "
          f"{F32_TRAIN_LAYERS} layers on the f32 kernels ({f32_counts}) "
          f"within {F32_TRAIN_TOL} of the plain versions ({_diff_text(d)}; "
          f"loss {plain['loss']:.6f}, gradient norm "
          f"{plain['grad_norm']:.6f}); refuses {'; '.join(refused)}; on "
          f"{smi}")
    del m32, init, kern, plain
    torch.cuda.empty_cache()
    return {
        "first_step": first_step,
        "flash_attention_sm90": {
            "launches_per_step": 2 * L, "launches_forward": L,
            "device_ms_step": prof["flash_attention"],
            "share_step": prof["flash_attention"] / ms},
        "moe_gmm_sm90": {
            "launches_per_step": 6 * L, "launches_forward": 3 * L,
            "device_ms_step": prof["moe_gmm"],
            "share_step": prof["moe_gmm"] / ms},
        "flash_attention": {
            "launches_f32_step": f32_counts["flash_attention"]},
        "moe_gmm": {"launches_f32_step": f32_counts["moe_gmm"]},
    }


def _bit_sums(tensors: dict) -> dict:
    """The sum of each tensor's bits as integers, by name, computed where
    the tensor lies (a checksum cheap enough on the host)."""
    import torch
    ints = {2: torch.int16, 4: torch.int32}
    return {n: int(t.detach().reshape(-1).view(ints[t.element_size()])
                   .sum(dtype=torch.int64))
            for n, t in tensors.items()}


def _train_state(tr) -> dict:
    """Every tensor of a trainer's state, by name."""
    out = dict(tr.model.named_parameters(), count=tr.opt["count"])
    for k in ("m", "v"):
        out.update({f"{k}.{n}": t for n, t in tr.opt[k].items()})
    return out


def phase11(dev, smi: str, serve_tokens, first_step: dict) -> dict:
    """Phase 11: the multi-device layer on the card's one-device mesh:
    (a) the rules' prefill and serve steps give phase 7's tokens
    (``serve_tokens``) and the rules' train step phase 10's first step
    (``first_step``: its loss and state checksums), with the main path's
    launches, (b) the bf16 job moved card -> host -> card mid-run,
    bit-equal, (c) an f32 step on the host between two on the card,
    within F32_TRAIN_TOL, with a planted error.  Returns the kernels
    line's ``mesh_path`` entries, by kernel name."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ParallelCfg, ShapeCfg
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import (MeshRules, make_prefill_step,
                                      make_serve_step, make_train_step)
    from repro_torch.parallel import steps as step_module
    from repro_torch.runtime import Trainer

    counters = launch_counters()
    cfg = configs.get_config(SERVE_ARCH)
    L = cfg.n_layers
    pcfg = ParallelCfg(grad_accum=1, remat=True, seq_shard=False)
    rules = MeshRules(cfg, pcfg, dev)
    check(not rules.sharded and rules.axis_size == {"data": 1, "model": 1},
          f"phase 11: the card is not the (1, 1) mesh: {rules.axis_size}")
    torch.cuda.empty_cache()

    # -- (a) the rules' steps against phases 7 and 10 ------------------------
    # On one device the rules' steps are the one-device paths: this holds
    # the dispatch and the launches, against the results phases 7 and 10
    # computed in this process (phase 7 served with room for SERVE_STEPS)
    B, S, steps = SERVE_B, SERVE_S, MESH_STEPS
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    batch = serve.make_batch(cfg, B, S, 0, dev)
    prefill = make_prefill_step(cfg, rules, cache_len=S + SERVE_STEPS)
    serve_step = make_serve_step(cfg, rules)
    with torch.no_grad():
        reset_launches(counters)
        logits, caches = prefill(model, batch)
        torch.cuda.synchronize()
        prefill_counts = read_launches(counters)
        toks = [logits[:, -1].argmax(-1)[:, None]]
        decode_counts = dict.fromkeys(prefill_counts, 0)
        for i in range(steps - 1):
            reset_launches(counters)
            logits, caches = serve_step(model, toks[-1], caches, S + i)
            torch.cuda.synchronize()
            decode_counts = {n: decode_counts[n] + c for n, c in
                             read_launches(counters).items()}
            toks.append(logits[:, -1].argmax(-1)[:, None])
    tokens = torch.cat(toks, dim=1).cpu()
    check(torch.equal(tokens, serve_tokens[:, :steps]),
          "phase 11 (a): the rules' prefill and serve steps generated other "
          "tokens than phase 7's serve")
    check(prefill_counts["flash_attention_sm90"] == L
          and prefill_counts["moe_gmm_sm90"] == 3 * L
          and sum(prefill_counts.values()) == 4 * L,
          f"phase 11 (a) prefill: expected {L} flash_attention_sm90 and "
          f"{3 * L} moe_gmm_sm90 launches, got {prefill_counts}")
    del caches, logits

    shape = ShapeCfg("phase11", TRAIN_S, TRAIN_B, "train")
    tbatch = SyntheticLMData(cfg, shape, 0, device=dev).batch_at(0)
    opt = adamw_init(dict(model.named_parameters()), cfg.opt_state_dtype)
    train_step = make_train_step(cfg, pcfg, rules, peak_lr=1e-3)
    reset_launches(counters)
    _, opt, metrics = train_step(model, opt, tbatch, 0)
    torch.cuda.synchronize()
    train_counts = read_launches(counters)
    loss = float(metrics["loss"])
    check(loss == first_step["loss"]
          and _state_digest(model, opt) == first_step["digest"],
          f"phase 11 (a): make_train_step(rules) gave loss {loss!r} against "
          f"phase 10's first step's {first_step['loss']!r}, or another "
          f"state")
    del model, opt, metrics
    torch.cuda.empty_cache()
    check(train_counts["flash_attention_sm90"] == 2 * L
          and train_counts["moe_gmm_sm90"] == 6 * L
          and sum(train_counts.values()) == 8 * L,
          f"phase 11 (a) train step: expected {2 * L} flash_attention_sm90 "
          f"and {6 * L} moe_gmm_sm90 launches, got {train_counts}")
    print(f"phase 11 (a): {cfg.name} on the (1, 1) mesh of {dev} through "
          f"MeshRules: prefill and {steps - 1} decode steps at {B} x {S} "
          f"gave phase 7's first {steps} tokens (launches: prefill "
          f"{prefill_counts}, decode {decode_counts}); one "
          f"make_train_step(rules) step bit-equal to phase 10's first "
          f"(loss {loss!r}, {len(first_step['digest'])} tensors' "
          f"checksums; launches {train_counts}) on {smi}")

    # -- (b) the bf16 job moved card -> host -> card mid-run -----------------
    ref = Trainer(cfg, shape, dev, seed=0)
    ref.init_state()
    want_losses = ref.run(MIGRATE_STEPS).losses
    want_digest = _state_digest(ref.model, ref.opt)
    del ref
    torch.cuda.empty_cache()
    tr = Trainer(cfg, shape, dev, seed=0)
    tr.init_state()
    losses = tr.run(MIGRATE_AT).losses
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _train_state(tr).values())
    before = _state_digest(tr.model, tr.opt)
    sums = _bit_sums(_train_state(tr))
    moves = []
    for where in ("cpu", dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.resize(where)
        torch.cuda.synchronize()
        moves.append(time.perf_counter() - t0)
        check(tr.step == MIGRATE_AT and tr.device == torch.device(where)
              and _bit_sums(_train_state(tr)) == sums,
              f"phase 11 (b): the state's bits changed in the move onto "
              f"{where}")
    check(_state_digest(tr.model, tr.opt) == before,
          "phase 11 (b): the state came back to the card with other bits")
    reset_launches(counters)
    losses += tr.run(MIGRATE_STEPS - MIGRATE_AT).losses
    torch.cuda.synchronize()
    migrate_counts = read_launches(counters)
    check(losses == want_losses
          and _state_digest(tr.model, tr.opt) == want_digest,
          f"phase 11 (b): losses {losses} against the unmoved run's "
          f"{want_losses}, or another final state: not bit-equal")
    print(f"phase 11 (b): {cfg.name} job ({state_bytes} B of bf16 weights "
          f"and f32 moments) moved card -> host in {moves[0]:.3f} s "
          f"({state_bytes / moves[0] / 1e9:.2f} GB/s) and host -> card in "
          f"{moves[1]:.3f} s ({state_bytes / moves[1] / 1e9:.2f} GB/s) "
          f"after step {MIGRATE_AT}; the state's checksums equal on both "
          f"sides of each move; losses {losses} bit-equal to the unmoved "
          f"run's; on {smi}")
    del tr
    torch.cuda.empty_cache()

    # -- (c) an f32 step on the host between two on the card -----------------
    body = cfg.layer_groups[0][1]
    cfg32 = dataclasses.replace(
        cfg, n_layers=MIGRATE_F32_LAYERS,
        layer_groups=((MIGRATE_F32_LAYERS, body),),
        param_dtype="float32", compute_dtype="float32")
    shape32 = ShapeCfg("phase11c", MIGRATE_F32_S, MIGRATE_F32_B, "train")
    real_update = step_module.adamw_update

    def run32(places, reinit=False) -> dict:
        """Steps on ``places`` in turn (resizing between them) from seed
        0; the losses, gradient norms, the last step's gradients and the
        update of the 3 steps."""
        tr = Trainer(cfg32, shape32, places[0], seed=0)
        tr.init_state()
        init = {n: p.detach().cpu().clone()
                for n, p in tr.model.named_parameters()}
        seen, out = {}, {"loss": [], "grad_norm": []}

        def keep_grads(grads, opt_state, params, **kw):
            seen.clear()
            seen.update({n: g.detach().cpu().clone()
                         for n, g in grads.items()})
            _, opt_state, metrics = real_update(grads, opt_state, params,
                                                **kw)
            out["grad_norm"].append(float(metrics["grad_norm"]))
            return params, opt_state, metrics

        with _patched(step_module, adamw_update=keep_grads):
            for i, where in enumerate(places):
                if torch.device(where) != tr.device:
                    tr.resize(where)
                    if reinit:
                        tr.opt = adamw_init(dict(tr.model.named_parameters()),
                                            cfg32.opt_state_dtype)
                out["loss"] += tr.run(1).losses
        out["grads"] = seen
        out["update"] = {n: p.detach().cpu() - init[n]
                         for n, p in tr.model.named_parameters()}
        return out

    def diff(got, want) -> dict:
        d = _train_diff(
            {"loss": 0.0, "grad_norm": 1.0, "grads": got["grads"],
             "update": got["update"]},
            {"loss": 0.0, "grad_norm": 1.0, "grads": want["grads"],
             "update": want["update"]})
        d["loss"] = max(abs(a - b) for a, b in zip(got["loss"],
                                                    want["loss"]))
        d["grad_norm"] = max(abs(a / b - 1) for a, b in
                             zip(got["grad_norm"], want["grad_norm"]))
        return d

    def within(d: dict) -> bool:
        return all(d[k] <= F32_TRAIN_TOL[k] for k in F32_TRAIN_TOL)

    card = run32([dev, dev, dev])
    reset_launches(counters)
    moved = run32([dev, "cpu", dev])
    f32_counts = read_launches(counters)
    check(f32_counts["flash_attention"] == 2 * 2 * MIGRATE_F32_LAYERS
          and f32_counts["moe_gmm"] == 2 * 6 * MIGRATE_F32_LAYERS,
          f"phase 11 (c): the two card steps missed the f32 kernels: "
          f"{f32_counts}")
    d = diff(moved, card)
    check(within(d), f"phase 11 (c): a step on the host between two on the "
          f"card differs from 3 on the card ({_diff_text(d)}), past "
          f"{F32_TRAIN_TOL}")
    bad = diff(run32([dev, "cpu", dev], reinit=True), card)
    check(not within(bad), f"phase 11 (c): tolerances {F32_TRAIN_TOL} miss "
          f"a resize that re-initializes AdamW's moments ({_diff_text(bad)})")
    print(f"phase 11 (c): {cfg.name} in f32 at full width and "
          f"{MIGRATE_F32_LAYERS} layers, batch {MIGRATE_F32_B} x "
          f"{MIGRATE_F32_S}: card, host (plain versions), card within "
          f"{F32_TRAIN_TOL} of three steps on the card ({_diff_text(d)}; "
          f"losses {moved['loss']} against {card['loss']}); refuses a "
          f"resize that re-initializes AdamW's moments ({_diff_text(bad)}); "
          f"on {smi}")
    torch.cuda.empty_cache()
    return {
        "flash_attention_sm90": {
            "launches_prefill": prefill_counts["flash_attention_sm90"],
            "launches_train_step": train_counts["flash_attention_sm90"],
            "launches_migrated_steps":
                migrate_counts["flash_attention_sm90"]},
        "moe_gmm_sm90": {
            "launches_prefill": prefill_counts["moe_gmm_sm90"],
            "launches_decode": decode_counts["moe_gmm_sm90"],
            "launches_train_step": train_counts["moe_gmm_sm90"],
            "launches_migrated_steps": migrate_counts["moe_gmm_sm90"]},
        "moe_gmm": {"launches_decode": decode_counts["moe_gmm"],
                    "launches_f32_card_steps": f32_counts["moe_gmm"]},
        "flash_attention": {
            "launches_f32_card_steps": f32_counts["flash_attention"]},
    }


def phase12(dev, smi: str) -> dict:
    """Phase 12: the production dry run's one-card cell against the card.
    Returns the kernels line's ``dryrun_path`` entries, by kernel name, and
    the measured peak over the predicted one."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ParallelCfg, ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.runtime import Trainer

    counters = launch_counters()
    cfg = configs.get_config(SERVE_ARCH)
    L = cfg.n_layers
    shape = ShapeCfg("phase10", TRAIN_S, TRAIN_B, "train")
    pcfg = ParallelCfg(grad_accum=1, remat=True, seq_shard=False)
    torch.cuda.empty_cache()

    # -- the cell traced on meta: counted, nothing launched -----------------
    reset_launches(counters)
    cell = dryrun.lower_cell(SERVE_ARCH, shape, False, pcfg_override=pcfg,
                             mesh=torch.device("meta"))
    traced = read_launches(counters)
    check(cell["status"] == "ok" and not any(traced.values()),
          f"phase 12: the dry run's trace: {cell.get('status')}, launches "
          f"{traced}")
    check(cell["state_bytes_per_device"] == cell["state_bytes_local"],
          f"phase 12: state bytes {cell['state_bytes_per_device']} by the "
          f"formula, {cell['state_bytes_local']} in the traced state")
    roof = cell["roofline"]
    print(f"phase 12: the dry run's one-card cell, {cfg.name} train step "
          f"{TRAIN_B} x {TRAIN_S} on the (1, 1) mesh, traced on meta in "
          f"{cell['t_trace_s']} s ({cell['n_ops']} ops; flash attention and "
          f"the grouped matmul counted as their plain math, which the "
          f"reference's dry run counts, where the card runs their kernels): "
          f"{cell['hlo_flops']:.6g} FLOPs, {cell['hlo_bytes']:.6g} B (eager, "
          f"unfused), state {cell['state_bytes_per_device']:.6g} B, "
          f"predicted peak {cell['peak_bytes_per_device'] / 1e9:.3f} GB; "
          f"roofline compute {roof['compute_s'] * 1e3:.3f} ms, memory "
          f"{roof['memory_s'] * 1e3:.3f} ms ({roof['constants']})")

    # -- phase 10's job on the card ------------------------------------------
    # what the process holds before (earlier phases' allocations) is not
    # the step's: the prediction is held against the rest
    held = torch.cuda.memory_allocated()
    tr = Trainer(cfg, shape, dev, pcfg=pcfg, seed=0)
    tr.init_state()
    card_state = sum(t.numel() * t.element_size() for t in (
        *tr.model.parameters(), *tr.opt["m"].values(),
        *tr.opt["v"].values()))
    check(card_state == cell["state_bytes_per_device"],
          f"phase 12: the card holds {card_state} B of state, the dry run "
          f"predicted {cell['state_bytes_per_device']}")
    for i in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(counters)
        t0 = time.perf_counter()
        loss = tr.run(1).losses[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated() - held
    check(math.isfinite(loss), f"phase 12: loss {loss}")
    want = {"flash_attention_sm90": 2 * L, "moe_gmm_sm90": 6 * L}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"phase 12: expected {want} launches in the step, got {launches}")
    bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3
    print(f"phase 12: the card's state {card_state} B equals the predicted "
          f"state_bytes_per_device; step {DRYRUN_STEPS}: {ms:.3f} ms against "
          f"the counted roofline's {bound_ms:.3f} ms ({ms / bound_ms:.2f}x), "
          f"max_memory_allocated {peak / 1e9:.3f} GB above the "
          f"{held / 1e9:.3f} GB the process held before, against the "
          f"predicted peak {cell['peak_bytes_per_device'] / 1e9:.3f} GB "
          f"({peak / cell['peak_bytes_per_device']:.3f}x); loss {loss:.6f}; "
          f"launches {launches}; on {smi}")
    del tr
    torch.cuda.empty_cache()
    return launches, peak / cell["peak_bytes_per_device"]


#: the device's spin before each timed launch (about 0.1 ms at the H100's
#: clock): the host records the start event and launches while the device
#: waits, so the two events bracket the kernel alone
SPIN_CYCLES = 200_000


def kernel_events_ms(go, name: str, reps: int = 3) -> float:
    """Device time (ms) of kernel ``name``'s launches in one warm call of
    ``go()``: CUDA events recorded on the stream right before and after
    each launch, each launch queued behind a spin of the device
    (``SPIN_CYCLES``), summed; the median of ``reps`` calls."""
    import torch
    from repro_torch.kernels import _cuda
    go()
    torch.cuda.synchronize()
    real, events, totals = _cuda._FNS[name], [], []

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        err = real(*args)
        b.record()
        events.append((a, b))
        return err
    _cuda._FNS[name] = timed
    try:
        for _ in range(reps):
            events.clear()
            go()
            torch.cuda.synchronize()
            totals.append(sum(a.elapsed_time(b) for a, b in events))
    finally:
        _cuda._FNS[name] = real
    return statistics.median(totals)


def _split_times(go, kernel: str) -> dict:
    """One check of phase 13: its time by CUDA events (median of 3 warm
    calls) and the device time of its launches of ``kernel``
    (:func:`kernel_events_ms`)."""
    return {"ms": time_ms(go, 3), "device_ms": kernel_events_ms(go, kernel)}


def _ms_text(t: dict) -> str:
    return f"{t['ms']:.4f} ms by events, kernels {t['device_ms']:.4f} ms"


def _split_moe(dev, smi: str, counters) -> dict:
    """Phase 13 (a): granite's MoE layer split over capacity slices and
    mesh ranks.  Returns the kernels line's ``split_path`` entries."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_plain
    from repro_torch.models import layers
    from repro_torch.parallel import shares

    cfg = configs.get_config(SERVE_ARCH)
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(0)
    p = layers.init_moe(cfg, torch.bfloat16, dev, gen)
    x = torch.randn((SERVE_B, SERVE_S, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    xf = x.reshape(-1, D)
    C = layers.global_capacity(xf.shape[0], cfg)
    r = layers._route((xf @ p["router"]).float(), K, E, C)
    out = {"moe_gmm_sm90": {"slices": {}, "meshes": {}},
           "moe_gmm": {"slices": {}, "meshes": {}}}
    for dt, name, tol in ((torch.bfloat16, "moe_gmm_sm90", 5e-2),
                          (torch.float32, "moe_gmm", 1e-4)):
        pw = {k: v.to(dt) for k, v in p.items()}
        buf, counts = layers._dispatch(xf.to(dt), r, K, 0, E, 0, C)
        check(_close(moe_gmm_fwd(buf, pw["wg"], counts),
                     moe_gmm_plain(buf, pw["wg"], counts), tol),
              f"phase 13 (a): {name} [{E}, {C}, {D}] != plain")
        reset_launches(counters)
        whole = layers._expert_products(buf, pw, cfg, counts)
        check(read_launches(counters)[name] == 3,
              f"phase 13 (a): the whole buffer missed {name}")
        for n in SPLIT_SLICES:
            Cl = C // n
            cut = [layers._dispatch(xf.to(dt), r, K, 0, E, c * Cl, Cl)
                   for c in range(n)]
            check(torch.equal(torch.cat([b for b, _ in cut], 1), buf),
                  f"phase 13 (a): {n} capacity slices != the buffer")

            def go():
                return [layers._expert_products(b, pw, cfg, cn)
                        for b, cn in cut]
            reset_launches(counters)
            got = torch.cat(go(), 1)
            launches = read_launches(counters)
            check(launches[name] == 3 * n and sum(launches.values()) == 3 * n,
                  f"phase 13 (a): {n} slices: expected {3 * n} {name} "
                  f"launches, got {launches}")
            check(torch.equal(got, whole),
                  f"phase 13 (a): {n} capacity slices of {name} are not "
                  f"bit-equal to the whole buffer's (max abs err "
                  f"{_err(got, whole):.4g})")
            out[name]["slices"][str(n)] = dict(
                _split_times(go, name), launches=launches[name],
                rows_each=Cl, bit_equal=True)
        whole_t = _split_times(
            lambda: layers._expert_products(buf, pw, cfg, counts), name)
        print(f"phase 13 (a): {name} on granite's capacity [{E}, {C}, {D}] "
              f"in {'/'.join(map(str, SPLIT_SLICES))} slices with offset "
              f"counts, the three expert products concatenated bit-equal "
              f"to the whole buffer's; whole: {_ms_text(whole_t)}; "
              + "; ".join(f"{n} slices: {_ms_text(t)}" for n, t in
                          out[name]["slices"].items()) + f" on {smi}")
        out[name]["whole"] = whole_t

    want = layers.moe_ffn_global(x, p, cfg)
    want32 = layers.moe_ffn_global(x.float(), {k: v.float() for k, v in
                                               p.items()}, cfg)
    for (nd, nm) in SPLIT_MOE_MESHES:
        rules = shares.rules_for(cfg, nd, nm)
        for dt, name, tol, ref in ((torch.bfloat16, "moe_gmm_sm90", 5e-2,
                                    want),
                                   (torch.float32, "moe_gmm", F32_MODEL_TOL,
                                    want32)):
            if dt == torch.float32 and (nd, nm) != SPLIT_MOE_MESHES[-1]:
                continue
            pw = {k: v.to(dt) for k, v in p.items()}

            def go():
                return shares.moe_global(x.to(dt), pw, cfg, rules)
            reset_launches(counters)
            got, info = go()
            launches = read_launches(counters)
            n_want = 3 * nd * nm     # every rank's three products
            check(launches[name] == n_want,
                  f"phase 13 (a): {nd}x{nm}: expected {n_want} {name} "
                  f"launches, got {launches}")
            check(_close(got, ref, tol),
                  f"phase 13 (a): the MoE layer on the ranks of a "
                  f"{nd}x{nm} mesh differs from one device's by "
                  f"{_err(got, ref):.4g}, past {_tol_text(tol)}")
            t = out[name]["meshes"][f"{nd}x{nm}"] = dict(
                info, **_split_times(go, name), launches=launches[name],
                max_abs_err=_err(got, ref))
            print(f"phase 13 (a): granite's MoE layer {tuple(x.shape)} "
                  f"{str(dt)[6:]} run by moe_ffn_global on every rank of a "
                  f"simulated ({nd}, {nm}) mesh "
                  f"({'EP' if info['ep'] else 'expert-TP'}, the capacity in "
                  f"{info['n_capacity']} slices): within {_tol_text(tol)} "
                  f"of one device (max abs err {_err(got, ref):.4g}), "
                  f"{launches[name]} {name} launches, all ranks "
                  f"{_ms_text(t)} on {smi}")
    return out


def _split_xlstm(dev, smi: str, counters) -> dict:
    """Phase 13 (b): xlstm-125m's mLSTM and sLSTM split by heads and value
    columns.  Returns the kernels line's ``split_path`` entry of
    ``mlstm_chunk``."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import MLSTM, SLSTM
    from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_fwd,
                                                        mlstm_chunk_plain)
    from repro_torch.models import layers
    from repro_torch.parallel import shares

    cfg = configs.get_optimized_config("xlstm-125m")
    _, _, B, S, _ = P8_MODELS[1]
    D, H = cfg.d_model, cfg.n_heads
    hd, bt = 2 * D // H, cfg.mlstm_chunk
    gen = torch.Generator(device=dev).manual_seed(0)
    pm = layers.init_mlstm(cfg, torch.float32, dev, gen)
    ps = layers.init_slstm(cfg, torch.float32, dev, gen)
    x = torch.randn((B, S, D), generator=gen, device=dev)
    out = {"value_blocks": {}, "ranks": {}}

    # -- mlstm_chunk on each head's value columns ---------------------------
    q, k, v, log_i, log_f = layers._mlstm_inputs(x, pm, cfg)

    def heads(t):
        t = t.float().transpose(1, 2)
        return t.reshape(B * H, S, *t.shape[3:]).contiguous()
    q, k, v = heads(q), heads(k), heads(v)
    lf, gi = heads(log_f)[..., None], torch.exp(heads(log_i))[..., None]

    def with_ones(vb):
        w = layers._ones_width(vb.shape[-1])
        return torch.cat([vb, torch.ones_like(vb[..., :1]), torch.zeros(
            (*vb.shape[:-1], w - vb.shape[-1] - 1), device=dev)], -1)
    v1 = with_ones(v)
    y_w, c_w = mlstm_chunk_fwd(q, k, v1, lf, gi, bt=bt)
    py, pc = mlstm_chunk_plain(q, k, v1, lf, gi, bt=bt)
    check(_close(y_w, py, MLSTM_F32_TOL) and _close(c_w, pc, MLSTM_F32_TOL),
          "phase 13 (b): mlstm_chunk [32, 2048, 388] != plain")
    out["whole"] = _split_times(
        lambda: mlstm_chunk_fwd(q, k, v1, lf, gi, bt=bt), "mlstm_chunk")
    for g in SPLIT_VALUE_BLOCKS:
        vb = hd // g
        ins = [with_ones(v[..., b * vb:(b + 1) * vb]) for b in range(g)]

        def go():
            return [mlstm_chunk_fwd(q, k, vi, lf, gi, bt=bt) for vi in ins]
        reset_launches(counters)
        parts = go()
        launches = read_launches(counters)["mlstm_chunk"]
        check(launches == g, f"phase 13 (b): {g} value blocks: {launches} "
                             "mlstm_chunk launches")
        y = torch.cat([yb[..., :vb] for yb, _ in parts], -1)
        c = torch.cat([cb[..., :vb] for _, cb in parts], -1)
        # each block's column of ones: the head's normalizer q·n and n
        qn = max(_err(yb[..., vb], y_w[..., hd]) for yb, _ in parts)
        nn = max(_err(cb[..., vb], c_w[..., hd]) for _, cb in parts)
        err = max(_err(y, y_w[..., :hd]), _err(c, c_w[..., :hd]), qn, nn)
        same = err == 0.0
        check(same or (_close(y, y_w[..., :hd], MLSTM_F32_TOL)
                       and _close(c, c_w[..., :hd], MLSTM_F32_TOL)
                       and qn <= MLSTM_F32_TOL and nn <= MLSTM_F32_TOL),
              f"phase 13 (b): mlstm_chunk on {g} value blocks differs from "
              f"the whole launch by {err:.4g}")
        t = out["value_blocks"][str(g)] = dict(
            _split_times(go, "mlstm_chunk"), launches=launches,
            columns_each=vb, bit_equal=same, max_abs_err=err)
        print(f"phase 13 (b): mlstm_chunk [{B * H}, {S}] on each head's "
              f"{hd} value columns in {g} block(s) of {vb} (each with its "
              f"own column of ones, {layers._ones_width(vb)} wide), "
              f"concatenated: "
              + ("bit-equal to the whole launch" if same else
                 f"{err:.4g} from the whole launch, within "
                 f"{MLSTM_F32_TOL}")
              + f"; {_ms_text(t)} on {smi}")

    # -- the mLSTM and the sLSTM as model ranks compute them ----------------
    want_m = layers.mlstm_chunked(x, pm, cfg, chunk=bt)
    want_s = layers.slstm(x, ps, cfg)
    # a second witness for the sLSTM: the whole loop in f64
    s64 = layers.slstm(x.double(), {k: v.double() for k, v in ps.items()},
                       cfg)
    s_keys = ("y", *want_s[1])

    def s_outs(o):
        return (o[0], *(o[1][k] for k in want_s[1]))

    def s_errs(got, want):
        return {k: _err(g, w) for k, g, w in
                zip(s_keys, s_outs(got), s_outs(want))}
    whole64 = s_errs(want_s, s64)
    # the recurrent product of one head alone against its slice of the
    # four heads' (the per-step einsum of a rank of one head)
    h = torch.randn((B, H, D // H), generator=gen, device=dev)
    r4 = ps["r"].reshape(H, D // H, 4, D // H)
    one_head = torch.equal(
        torch.einsum("bhk,hkgj->bghj", h[:, :1], r4[:1]),
        torch.einsum("bhk,hkgj->bghj", h, r4)[:, :, :1])
    ht, rf = h.transpose(0, 1), ps["r"].float()
    one_bmm = torch.equal(torch.bmm(ht[:1], rf[:1]), torch.bmm(ht, rf)[:1])
    print(f"phase 13 (b): the sLSTM's recurrent product of one head alone "
          f"is {'' if one_head else 'not '}bit-equal to its slice of the "
          f"{H} heads' product (einsum; as a bmm of one head against {H}: "
          f"{'' if one_bmm else 'not '}bit-equal); one device's f32 sLSTM "
          f"against its f64 run: "
          + ", ".join(f"{k} {e:.4g}" for k, e in whole64.items()))
    for n in SPLIT_MIXER_RANKS:
        split = f"{H // n} head(s) a rank" if H % n == 0 else \
            f"a head's {hd * H // n} value columns a rank"

        def go():
            return shares.mixer(MLSTM, x, pm, cfg, n, None, "chunked",
                                chunk=bt)
        reset_launches(counters)
        y, st = go()
        launches = read_launches(counters)["mlstm_chunk"]
        errs = [_err(y, want_m[0])] + [_err(st[k], want_m[1][k])
                                       for k in ("C", "n")]
        check(launches == n and _close(y, want_m[0], MLSTM_F32_TOL)
              and all(_close(st[k], want_m[1][k], MLSTM_F32_TOL)
                      for k in ("C", "n", "m")),
              f"phase 13 (b): the mLSTM on {n} ranks differs from one "
              f"device's by {max(errs):.4g} ({launches} launches)")
        t0 = time.perf_counter()
        got_s = shares.mixer(SLSTM, x, ps, cfg, n)
        slstm_s = time.perf_counter() - t0
        s_err = s_errs(got_s, want_s)
        excess = _excess(s_outs(got_s), s_outs(want_s), MLSTM_F32_TOL)
        split64 = s_errs(got_s, s64)
        check(excess <= 1.0,
              f"phase 13 (b): the sLSTM on {n} ranks differs from one "
              f"device's by {s_err} ({excess:.4g} x {MLSTM_F32_TOL}'s "
              "allowance)")
        t = out["ranks"][str(n)] = dict(
            _split_times(go, "mlstm_chunk"), launches=launches,
            max_abs_err=max(errs), slstm_max_abs_err=max(s_err.values()),
            slstm_excess=excess)
        print(f"phase 13 (b): xlstm-125m's chunked mLSTM [{B}, {S}, {D}] f32 "
              f"on {n} ranks ({split}): output and state within "
              f"{MLSTM_F32_TOL} of one device (max abs err {max(errs):.4g}), "
              f"{launches} mlstm_chunk launches, all ranks {_ms_text(t)}; "
              f"the sLSTM ({min(n, H)} head groups; plain per-step loop, "
              f"{slstm_s:.2f} s) against one device's f32: "
              + ", ".join(f"{k} {e:.4g}" for k, e in s_err.items())
              + f", at most {excess:.4g} x {MLSTM_F32_TOL}'s allowance; "
              f"against the f64 run: "
              + ", ".join(f"{k} {e:.4g}" for k, e in split64.items())
              + f" on {smi}")
    return out


def phase13(dev, smi: str, p12_peak_ratio: float) -> dict:
    """Phase 13: the split's per-rank shares on the one card (a card holds
    one rank's share; the phase computes every rank's in turn and puts
    them together as the collectives do).  Returns the kernels line's
    ``split_path`` entries, by kernel name."""
    import torch
    counters = launch_counters()
    with torch.no_grad():
        moe = _split_moe(dev, smi, counters)
        torch.cuda.empty_cache()
        xl = _split_xlstm(dev, smi, counters)
    torch.cuda.empty_cache()
    check(abs(p12_peak_ratio - 1.0) <= PEAK_TOL,
          f"phase 13 (c): phase 12's peak is {p12_peak_ratio:.4f} x its "
          f"prediction, past {PEAK_TOL}")
    print(f"phase 13 (c): the one-card mesh as it was: phase 11 (a) "
          f"bit-equal to phases 7 and 10 with their launch counts (checked "
          f"there), phase 12's state bytes equal to the prediction (checked "
          f"there) and its peak {p12_peak_ratio:.4f} x the prediction, "
          f"within {PEAK_TOL}")
    return {SERVE_ARCH: moe, "xlstm-125m": {"mlstm_chunk": xl}}


def _cut_depth(cfg, n: int):
    """``cfg`` cut to its first ``n`` blocks (an encoder to ``n`` blocks),
    in f32."""
    import dataclasses
    blocks = tuple(cfg.blocks()[:n])
    over = dict(n_layers=len(blocks), layer_groups=((1, blocks),),
                param_dtype="float32", compute_dtype="float32")
    if cfg.encoder_decoder:
        over["enc_layers"] = min(n, cfg.enc_layers)
    return dataclasses.replace(cfg, **over)


def _backward_spans(fn, spans: list):
    """``fn`` (a layer's op or mixer, its first argument the input) whose
    backward pass is timed on the host: from the gradient reaching its
    first output to the gradient of its first argument, the device synced
    at both ends, appended to ``spans`` (s).  Under remat the block's
    recompute runs before the span (the first saved tensor the block's
    backward unpacks), so a span is the op's own backward."""
    import torch

    def run(*args, **kw):
        out = fn(*args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        x = args[0]
        if first.grad_fn is not None and x.requires_grad:
            t0 = []

            def start(g):
                torch.cuda.synchronize()
                t0.append(time.perf_counter())

            def stop(g):
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0.pop())
            first.register_hook(start)
            x.register_hook(stop)
        return out
    return run


def _forward_ops(cfg, B: int, S: int) -> float:
    """Operations (2 a multiply-add) of one forward of ``cfg`` over ``B x
    S`` tokens: every block's weight products at each token (an encoder's
    at each of its ``S`` frames, the frontend's projection, a cross
    block's keys and values at each frame), the attention cores over
    their (query, key) pairs, the mLSTM cores in chunks, and the logits
    over the vocabulary's live columns; elementwise work not counted."""
    from repro_torch.configs.base import ATTN, MLSTM, SWA
    from repro_torch.models import Model
    model = Model(cfg, device="meta")
    T, D, hd = B * S, cfg.d_model, cfg.hd
    per_token = sum(p.numel() for n, p in model.named_parameters()
                    if p.dim() >= 2 and (n.startswith("blocks.")
                                         or n.startswith("enc.")
                                         or n.startswith("frontend."))
                    and not n.endswith("conv_w"))
    ops = 2.0 * T * per_token
    for spec in cfg.blocks():
        if spec.mixer in (ATTN, SWA):
            window = cfg.window if spec.mixer == SWA else None
            ops += 4.0 * hd * B * cfg.n_heads * _attn_pairs(S, window)
        if spec.mixer == MLSTM:
            hv = 2 * D // cfg.n_heads
            ops += _mlstm_ops(B * cfg.n_heads, S, hv, hv + 1,
                              cfg.mlstm_chunk)
        if spec.cross_attn:
            ops += 4.0 * hd * B * cfg.n_heads * S * S
    if cfg.encoder_decoder:
        ops += cfg.enc_layers * 4.0 * hd * B * cfg.n_heads * S * S
    return ops + 2.0 * B * (S - 1) * D * cfg.vocab_size


def _p14_train(dev, smi: str, tag: str, cfg, B: int, S: int, counters,
               want_fwd: dict, checkpoint: bool) -> dict:
    """Phase 14 (a) and (b) for one model: ``Trainer.run`` at full width
    and depth, and the loss on one repeated batch."""
    import shutil
    import torch
    from repro_torch.configs.base import MLSTM, RGLRU, SLSTM, ShapeCfg
    from repro_torch.models import layers
    from repro_torch.parallel import make_train_step
    from repro_torch.runtime import Trainer

    ckpt = ROOT / "build" / "phase14_ckpt" if checkpoint else None
    kinds = {s.mixer for s in cfg.blocks()}
    shape = ShapeCfg("phase14", S, B, "train")
    if ckpt:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    tr = Trainer(cfg, shape, dev, ckpt_dir=ckpt, seed=0)
    tr.init_state()
    params = list(tr.model.parameters())
    n_params = sum(p.numel() for p in params)
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    m_bytes = sum(t.numel() * t.element_size() for k in ("m", "v")
                  for t in tr.opt[k].values())
    print(f"# {tag}: {cfg.n_layers} layers at full width"
          + (f" (and {cfg.enc_layers} encoder blocks)"
             if cfg.encoder_decoder else "")
          + f", {n_params} parameters in {tr.model.embed.dtype}: "
          f"parameters {p_bytes} B, gradients {p_bytes} B, AdamW moments "
          f"{m_bytes} B in {cfg.opt_state_dtype}; batch {B} x {S} tokens, "
          f"remat, on {smi}")
    step_ms, losses, peaks = [], [], []
    after_fwd, spans, prof = {}, {}, {}
    fwd_ms = []

    def forward_marked(model, t0: float):
        """``model.forward_train`` reading the launches and the time at
        the end of the forward (the device synced)."""
        fwd = model.forward_train

        def run(*a, **kw):
            out = fwd(*a, **kw)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            after_fwd.update(read_launches(counters))
            return out
        return run
    timed_ops = {"rglru_scan": ("rglru_scan", RGLRU),
                 "mlstm_chunk": ("mlstm_chunk", MLSTM),
                 "slstm_share": ("sLSTM layer", SLSTM)}
    digest = None
    try:
        for i in range(P14_STEPS):
            restart = ckpt is not None and i == P14_STEPS - 1
            if restart:   # a fresh Trainer from the step-2 checkpoint
                del tr
                torch.cuda.empty_cache()
                tr = Trainer(cfg, shape, dev, ckpt_dir=ckpt, seed=0)
                t0 = time.perf_counter()
                check(tr.maybe_restore() and tr.step == P14_CKPT_AT,
                      f"{tag} (a): no restore to step {P14_CKPT_AT}")
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                check(_state_digest(tr.model, tr.opt) == digest,
                      f"{tag} (a): the restored state is not the saved "
                      "one, bit for bit")
            torch.cuda.reset_peak_memory_stats()
            reset_launches(counters)
            torch.cuda.synchronize()
            if i == 2:
                patch = {name: _backward_spans(getattr(layers, name),
                                               spans.setdefault(name, []))
                         for name, (_, kind) in timed_ops.items()
                         if kind in kinds}
                with _patched(layers, **patch):
                    prof = profile_device(lambda: losses.append(
                        tr.run(1).losses[0]))
            else:   # the first step's times are the warm-up's: not kept
                t0 = time.perf_counter()
                with _patched(tr.model,
                              forward_train=forward_marked(tr.model, t0)):
                    losses += tr.run(1).losses
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            total = read_launches(counters)
            check(all(total[n] == 2 * want_fwd.get(n, 0) for n in total),
                  f"{tag} (a) step {i + 1}: expected twice {want_fwd} "
                  f"launches (the forward and the recompute), got {total}")
            back = {n: total[n] - after_fwd[n] for n in total}
            check(all(after_fwd[n] == back[n] == want_fwd.get(n, 0)
                      for n in total),
                  f"{tag} (a) step {i + 1}: expected {want_fwd} launches in "
                  f"the forward and as many in the backward, got "
                  f"{after_fwd} and {back}")
            peaks.append(torch.cuda.max_memory_allocated())
            if ckpt is not None and tr.step == P14_CKPT_AT and not restart:
                t0 = time.perf_counter()
                tr.save_checkpoint()
                save_s = time.perf_counter() - t0
                digest = _state_digest(tr.model, tr.opt)
        check(all(math.isfinite(x) for x in losses), f"{tag} (a): losses "
              f"{losses}")
        if ckpt is not None:
            check(losses[3] == losses[2],
                  f"{tag} (a): the restarted step lost {losses[3]!r} "
                  f"against {losses[2]!r}: not bit-equal")
            ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                             if f.is_file())
            print(f"{tag} (a): checkpoint after step {P14_CKPT_AT} "
                  f"({ckpt_bytes} B, written in {save_s:.2f} s); a fresh "
                  f"Trainer restored "
                  f"it in {restore_s:.2f} s, the state bit-equal to the "
                  f"saved one ({len(digest)} tensors), and its step "
                  f"{P14_CKPT_AT + 1} lost {losses[3]!r}, bit-equal to the "
                  f"uninterrupted run's, on {smi}")
    finally:
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    step_ms, fwd_ms = step_ms[1:], fwd_ms[1:]
    ms = statistics.median(step_ms)
    f_ms = statistics.median(fwd_ms)
    peak = max(peaks)
    print(f"{tag} (a): {P14_STEPS} steps of Trainer.run: {ms:.3f} ms a step "
          f"(median of {[round(x, 3) for x in step_ms]}), "
          f"{B * S / ms * 1e3:.1f} tokens/s; the forward {f_ms:.3f} ms "
          f"(median of {[round(x, 3) for x in fwd_ms]}), the backward "
          f"(recompute included) and AdamW {ms - f_ms:.3f} ms, "
          f"{(ms - f_ms) / ms:.4f} of the step; peak memory "
          f"{peak / 1e9:.3f} GB "
          f"(max_memory_allocated; state {(2 * p_bytes + m_bytes) / 1e9:.3f} "
          f"GB of parameters, gradients and moments; the process held "
          f"{held / 1e9:.3f} GB before); launches a step: {after_fwd} in the "
          f"forward, {back} in the backward (the recompute; the oracles "
          f"launch none); losses {losses}; on {smi}")
    check(peak < 80e9, f"{tag} (a): peak memory {peak} B")
    # the profiled step: device busy share, the leading kernels, and the
    # recurrent backward passes' host time
    by_k = _by_kernel(prof)
    busy = sum(prof.values())
    lead = sorted(prof.items(), key=lambda kv: -kv[1])[:8]
    span_ms = {timed_ops[n][0]: 1e3 * sum(s) for n, s in spans.items()}
    if prof:
        print(f"# {tag} profiled step: device busy {busy:.4f} ms of "
              f"{ms:.4f} ms (busy share {busy / ms:.4f}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in by_k.items() if v)
              + f" on {smi}")
        for name, kms in lead:
            print(f"#   {kms:.4f} ms  {name[:100]}")
    else:
        print(f"# {tag} profiled step: torch.profiler recorded no device "
              "activity (busy share not measured)")
    for what, t in span_ms.items():
        n = len(spans[next(k for k, v in timed_ops.items()
                           if v[0] == what)])
        print(f"# {tag} profiled step: the backward of {n} {what} calls "
              f"takes {t:.1f} ms of host time ({t / ms:.4f} of a step; "
              f"synced at both ends of each)")
    # the step's bound: three times the forward's operations against the
    # bytes of AdamW's state in and out (phase 10's)
    fwd_ops = _forward_ops(cfg, B, S)
    rate = BF16_OPS_PER_S if tr.model.embed.dtype == torch.bfloat16 \
        else F32_OPS_PER_S
    step_bytes = n_params * (tr.model.embed.element_size() + 4 + 4) * 2
    t_ops, t_bytes = 3 * fwd_ops / rate, step_bytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"# {tag} bound: {bound_ms:.4f} ms by {bound_by} (3 x a forward "
          f"of {fwd_ops:.6g} operations at {rate / 1e12:g} TFLOP/s; "
          f"{step_bytes} B of weights and moments in and out at 3.35 TB/s); "
          f"measured {ms / bound_ms:.2f}x the bound on {smi}")

    # -- (b) the loss falls on one repeated batch --------------------------
    fit = make_train_step(cfg, tr.pcfg, peak_lr=1e-3, warmup=1,
                          total_steps=P14_FIT_STEPS)
    batch = tr.data.batch_at(0)
    fit_losses = []
    reset_launches(counters)
    for i in range(P14_FIT_STEPS):
        _, tr.opt, metrics = fit(tr.model, tr.opt, batch, i)
        fit_losses.append(float(metrics["loss"]))
    with torch.no_grad():   # the loss after the last update: a forward
        fit_losses.append(float(tr.model.forward_train(batch, remat=False)))
    fit_counts = read_launches(counters)
    check(all(fit_counts[n] == (2 * P14_FIT_STEPS + 1) * want_fwd.get(n, 0)
              for n in fit_counts), f"{tag} (b): launches {fit_counts}")
    check(all(math.isfinite(x) for x in fit_losses)
          and fit_losses[-1] <= fit_losses[0] - P14_FIT_MARGIN,
          f"{tag} (b): the loss fell from {fit_losses[0]} to "
          f"{fit_losses[-1]}, less than {P14_FIT_MARGIN}")
    print(f"{tag} (b): {P14_FIT_STEPS} step(s) of make_train_step on one "
          f"batch (warmup 1, peak lr 1e-3), then its loss: "
          f"{[round(x, 4) for x in fit_losses]}, a fall of "
          f"{fit_losses[0] - fit_losses[-1]:.4f} (at least {P14_FIT_MARGIN}) "
          f"on {smi}")
    del tr, batch, fit
    torch.cuda.empty_cache()
    return {"ms": ms, "forward_ms": f_ms, "peak_bytes": peak,
            "by_kernel": by_k, "busy": busy, "host_backward_ms": span_ms,
            "bound_ms": bound_ms}


def _f32_train_step(model, init: dict, batch, patches=()) -> dict:
    """One train step (remat, AdamW, peak lr 1e-3 after a warmup of one)
    of ``model`` from the parameters ``init``, with each ``(object,
    attributes)`` of ``patches`` set: the loss, the global gradient norm,
    every parameter's gradient and its update."""
    import contextlib
    import torch
    from repro_torch.configs.base import ParallelCfg
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import make_train_step
    from repro_torch.parallel import steps as step_module
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    seen = {}
    real_update = step_module.adamw_update

    def keep_grads(grads, opt_state, params, **kw):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return real_update(grads, opt_state, params, **kw)

    step = make_train_step(model.cfg, ParallelCfg(remat=True), peak_lr=1e-3,
                           warmup=1, total_steps=10)
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(step_module, adamw_update=keep_grads))
        for obj, attrs in patches:
            stack.enter_context(_patched(obj, **attrs))
        _, _, metrics = step(model, adamw_init(dict(
            model.named_parameters())), batch, 0)
    torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "grads": seen,
            "update": {n: p.detach() - init[n]
                       for n, p in model.named_parameters()}}


def _worst_grads(got: dict, want: dict, n: int = 3) -> str:
    """The ``n`` parameters whose gradients lie furthest from ``want``'s,
    in relative L2."""
    rel = {name: float((got["grads"][name] - g).norm()
                       / g.norm().clamp(min=1e-30))
           for name, g in want["grads"].items()}
    return ", ".join(f"{name} {r:.4g}" for name, r in sorted(
        rel.items(), key=lambda kv: -kv[1])[:n])


def _mlstm_state_dropped(q, k, v, lf, gi, bt=128):
    """The chunked oracle with each chunk started from an empty state: a
    chunked backward that drops the state carried between chunks."""
    import torch
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_chunked_ref
    outs = [mlstm_chunk_chunked_ref(*(t[:, t0:t0 + bt]
                                      for t in (q, k, v, lf, gi)), bt)
            for t0 in range(0, q.shape[1], bt)]
    return torch.cat([y for y, _ in outs], 1), outs[-1][1]


def _p14_f32(dev, smi: str, tag: str, cfg, B: int, S: int, depth: int,
             counters, want_f32: dict) -> dict:
    """Phase 14 (c) for one model: one f32 train step at full width and
    ``depth`` blocks on the f32 kernels against the plain versions, within
    a tolerance measured by the same step in f64 on the oracles; planted
    errors must fall outside it."""
    import dataclasses
    import torch
    from repro_torch.configs.base import MLSTM, RGLRU, SWA, ShapeCfg
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_chunked_ref
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_plain
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import Model, layers

    cfg32 = _cut_depth(cfg, depth)
    kinds = {s.mixer for s in cfg32.blocks()}
    m32 = Model(cfg32, generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
    blocks = [b for b in m32.blocks if b.spec.mixer == MLSTM]
    with torch.no_grad():   # |q·n| past 1: the normalizer is read (phase 8)
        for b in blocks:
            b.mixer.p["w_qkv"][:, :4 * cfg.d_model] *= MLSTM_QK_SCALE
    init = {n: t.detach().clone() for n, t in m32.state_dict().items()}
    batch = SyntheticLMData(cfg32, ShapeCfg("phase14c", S, B, "train"), 0,
                            device=dev).batch_at(0)
    ops = {n: getattr(layers, n)
           for n in ("flash_attention", "rglru_scan", "mlstm_chunk",
                     "attention", "cross_kv")}
    qn = []

    def mlstm_seen(q, k, v, lf, gi, bt):
        y, c = ops["mlstm_chunk"](q, k, v, lf, gi, bt)
        qn.append(float(y[..., q.shape[-1]].detach().abs().max()))
        return y, c

    reset_launches(counters)
    kern = _f32_train_step(m32, init, batch,
                           [(layers, {"mlstm_chunk": mlstm_seen})])
    counts = read_launches(counters)
    check(counts == {n: 2 * want_f32.get(n, 0) for n in counts},
          f"{tag} (c): the f32 step missed the f32 kernels: {counts}")
    if MLSTM in kinds:
        check(max(qn) > 1.0, f"{tag} (c): q, k x {MLSTM_QK_SCALE:g} left "
              f"max |q·n| at {max(qn):.4g}: the normalizer is not read")
    # the plain versions; the mLSTM's is the chunked oracle: the plain
    # version's decay overflows above the diagonal at 128-step chunks, and
    # its masked gradient there is NaN
    plain_ops = dict(
        flash_attention=lambda q, k, v, causal, window:
            flash_attention_plain(q, k, v, causal=causal, window=window),
        rglru_scan=rglru_scan_plain,
        mlstm_chunk=lambda q, k, v, lf, gi, bt:
            mlstm_chunk_chunked_ref(q, k, v, lf, gi, bt))
    plain = _f32_train_step(m32, init, batch, [(layers, plain_ops)])
    d = _train_diff(kern, plain)
    worst = _worst_grads(kern, plain)
    del kern
    planted = {}
    if SWA in kinds:
        planted["the window one key short"] = [(layers, dict(
            flash_attention=lambda q, k, v, causal, window:
                ops["flash_attention"](q, k, v, causal,
                                       window - 1 if window else window))
            )]
    if RGLRU in kinds:
        # training starts every scan from h0 = 0, so the RG-LRU runs as two
        # launches, the second half from h0 = 0 instead of the first
        # half's final state
        def halves(a, x, h0):
            n = a.shape[1] // 2
            h1, _ = ops["rglru_scan"](a[:, :n], x[:, :n], h0)
            h2, hT = ops["rglru_scan"](a[:, n:], x[:, n:],
                                       torch.zeros_like(h0))
            return torch.cat([h1, h2], 1), hT
        planted["the RG-LRU's h0 ignored (the second half of each scan "
                "from 0)"] = [(layers, {"rglru_scan": halves})]
    if MLSTM in kinds:
        def ones_zeroed(q, k, v, lf, gi, bt):
            keep = torch.ones(v.shape[-1], device=v.device)
            keep[q.shape[-1]] = 0
            return ops["mlstm_chunk"](q, k, v * keep, lf, gi, bt)
        planted["the mLSTM's column of ones zeroed"] = [
            (layers, {"mlstm_chunk": ones_zeroed})]
        planted["a chunked mLSTM backward that drops the state carried "
                "between chunks"] = [(mlstm_ops, {
                    "mlstm_chunk_chunked_ref": _mlstm_state_dropped})]
    if cfg.encoder_decoder:
        planted["the encoder's attention made causal"] = [(layers, {
            "attention": lambda *a, **kw: ops["attention"](
                *a, **dict(kw, causal=True))})]
        planted["cross-attention on the encoder output shifted by one "
                "frame"] = [(layers, {
                    "cross_kv": lambda e, *a, **kw: ops["cross_kv"](
                        torch.cat([e[:, 1:], e[:, -1:]], 1), *a, **kw)})]
    bad = {what: _train_diff(_f32_train_step(m32, init, batch, patch), plain)
           for what, patch in planted.items()}
    del m32
    torch.cuda.empty_cache()

    # the witness: the same step in f64 on the oracles
    cfg64 = dataclasses.replace(cfg32, param_dtype="float64",
                                compute_dtype="float64")
    m64 = Model(cfg64, device="meta")
    m64.load_state_dict({n: t.double() for n, t in init.items()},
                        assign=True)
    wit = _f32_train_step(m64, init, batch, [(layers, dict(
        flash_attention=lambda q, k, v, causal, window:
            attention_ref(q, k, v, causal=causal, window=window),
        rglru_scan=rglru_scan_ref,
        mlstm_chunk=lambda q, k, v, lf, gi, bt:
            mlstm_chunk_chunked_ref(q, k, v, lf, gi, bt)))])
    check(all(g.dtype == torch.float64 for g in wit["grads"].values()),
          f"{tag} (c): the witness's gradients are not f64")
    floor = _train_diff(plain, wit)
    worst64 = _worst_grads(plain, wit)
    del m64, wit
    torch.cuda.empty_cache()
    # the loss's and the gradient norm's floor at least one f32 rounding
    # of them (a scalar's f32 and f64 runs can round alike); the update
    # held at F32_TRAIN_TOL's: AdamW's first step is lr·sign(g), so its
    # distance counts the gradient entries at the rounding noise whose sign
    # flips, which is no multiple of the rounding floor
    ulp = 2.0 ** -23
    floor = dict(floor, loss=max(floor["loss"], ulp * abs(plain["loss"])),
                 grad_norm=max(floor["grad_norm"], ulp))
    tol = {k: min(F32_TRAIN_TOL[k], P14_FLOOR_MULT * floor[k])
           for k in ("loss", "grad_norm", "grad")}
    tol["update"] = F32_TRAIN_TOL["update"]

    def within(x: dict) -> bool:
        return all(x[k] <= tol[k] for k in tol)

    print(f"# {tag} (c): the gradients furthest from the plain versions': "
          f"on the kernels {worst}; in f32 from f64 {worst64}")

    check(within(d), f"{tag} (c): the f32 step on the kernels differs from "
          f"the plain versions' ({_diff_text(d)}), past {_diff_text(tol)} "
          f"({P14_FLOOR_MULT:g} x the f32 step's distance to its f64 run, "
          f"{_diff_text(floor)}, within {F32_TRAIN_TOL}; the update at "
          f"F32_TRAIN_TOL's)")
    for what, x in bad.items():
        check(not within(x), f"{tag} (c): the tolerance {_diff_text(tol)} "
              f"misses {what} ({_diff_text(x)})")
    print(f"{tag} (c): one f32 train step at full width and "
          f"{depth} layers, batch {B} x {S}, on the f32 kernels "
          f"({counts}) within {_diff_text(tol)} of the plain versions "
          f"({_diff_text(d)}; loss {plain['loss']:.6f}, gradient norm "
          f"{plain['grad_norm']:.6f}): {P14_FLOOR_MULT:g} x the plain "
          f"step's distance to the same step in f64 on the oracles "
          f"({_diff_text(floor)}; the loss's and the norm's at least one "
          f"f32 rounding), never looser than {F32_TRAIN_TOL}, the update "
          f"at its"
          + (f"; max |q·n| {max(qn):.4g} (q, k x {MLSTM_QK_SCALE:g})"
             if qn else "")
          + "; refuses " + "; ".join(f"{w}: {_diff_text(x)}"
                                     for w, x in bad.items())
          + f"; on {smi}")
    return {"counts": counts, "diff": d, "floor": floor, "tol": tol}


def phase14(dev, smi: str) -> dict:
    """Phase 14: the recurrent and encoder-decoder families' training path
    at full width and depth on the card (``P14_MODELS``): (a)
    ``Trainer.run``, (b) the loss on one repeated batch, (c) one f32 step
    at reduced depth on the kernels against the plain versions.  Returns
    the kernels line's ``train_path`` entries, by model and kernel name."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ATTN, MLSTM, RGLRU, SWA

    def launches(cfg, route: str) -> dict:
        kinds = [s.mixer for s in cfg.blocks()]
        n_attn = sum(k in (ATTN, SWA) for k in kinds) \
            + sum(s.cross_attn for s in cfg.blocks()) \
            + (cfg.enc_layers if cfg.encoder_decoder else 0)
        n = {route: n_attn, "rglru_scan": kinds.count(RGLRU),
             "mlstm_chunk": kinds.count(MLSTM)
             if cfg.mlstm_impl == "chunked" else 0}
        return {k: v for k, v in n.items() if v}

    counters = launch_counters()
    out = {}
    for arch, getter, B, S, B32, L32 in P14_MODELS:
        tag = f"phase 14 {arch}"
        cfg = getattr(configs, getter)(arch)
        route = "flash_attention_sm90" if cfg.param_dtype == "bfloat16" \
            else "flash_attention"
        want = launches(cfg, route)
        t0 = time.perf_counter()
        res = _p14_train(dev, smi, tag, cfg, B, S, counters, want,
                         checkpoint=arch == "xlstm-125m")
        t_train = time.perf_counter() - t0
        want32 = launches(_cut_depth(cfg, L32), "flash_attention")
        f32 = _p14_f32(dev, smi, tag, cfg, B32, S, L32, counters, want32)
        print(f"# {tag}: (a) and (b) {t_train:.1f} s, (c) "
              f"{time.perf_counter() - t0 - t_train:.1f} s")
        entry = {}
        for name, n in want.items():
            kind = "flash_attention" if name.startswith("flash") else name
            entry[name] = {
                "launches_per_step": 2 * n, "launches_forward": n,
                "device_ms_step": res["by_kernel"][kind],
                "share_step": res["by_kernel"][kind] / res["ms"]}
            host = res["host_backward_ms"].get(name)
            if host is not None:
                entry[name]["host_backward_ms_step"] = host
        for name, n in f32["counts"].items():
            if n:
                entry.setdefault(name, {})["launches_f32_step"] = n
        out[arch] = entry
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "core").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import zoo
    from repro_torch.core import (Engine, HetSession, OPT_MAX,
                                  TranslationCache, migrate)
    from repro_torch.core import edge_grids
    from repro_torch.core import kernels_suite as ks
    from repro_torch.core.backends import get_backend, nvcc_build
    from repro_torch.core.backends.cuda_backend import (emit_module,
                                                        lanes_per_thread)
    from repro_torch.kernels import _cuda as kernel_lib

    dev = torch.device("cuda", 0)
    smi = smi_line()
    start = time.perf_counter()

    def lap(done: str) -> None:
        print(f"# {done} done at {time.perf_counter() - start:.1f} s",
              flush=True)
    print(f"# card: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    names = list(ks.SUITE) + list(ks.registered_examples("zoo"))
    levels = (0, OPT_MAX)

    # -- phase 0: build every segment library the run needs -----------------
    rng = np.random.default_rng(0)
    attn_prog, attn_oracle = zoo.attn_decode(D=ATTN_D, T=ATTN_T)
    S = ATTN_NTILES * ATTN_T
    attn_args = {
        "Q": rng.standard_normal(ATTN_H * ATTN_D).astype(np.float32),
        "K": rng.standard_normal(ATTN_H * S * ATTN_D).astype(np.float32),
        "V": rng.standard_normal(ATTN_H * S * ATTN_D).astype(np.float32),
        "O": np.zeros(ATTN_H * ATTN_D, np.float32),
        "ntiles": ATTN_NTILES,
        "scale": np.float32(1.0 / math.sqrt(ATTN_D)),
    }
    vadd_prog, _ = ks.vadd()
    vadd_args = {
        "A": rng.standard_normal(VADD_N).astype(np.float32),
        "B": rng.standard_normal(VADD_N).astype(np.float32),
        "C": np.zeros(VADD_N, np.float32), "n": VADD_N,
    }
    builder = get_backend("cuda", device=dev)
    optimized = []
    for name in names:
        for lvl in levels:
            prog, _, grid, block, args, _ = ks.example_launch(
                name, rng=np.random.default_rng(42))
            optimized.append(
                Engine(prog, builder, grid, block, args, opt_level=lvl).program)
    optimized.append(Engine(attn_prog, builder, ATTN_H, ATTN_T, attn_args,
                            opt_level=OPT_MAX).program)
    optimized.append(Engine(vadd_prog, builder, VADD_N // VADD_BLOCK,
                            VADD_BLOCK, vadd_args, opt_level=OPT_MAX).program)
    for _, (prog, grid, block, args, _) in edge_grids.all_cases():
        optimized.append(
            Engine(prog, builder, grid, block, args, opt_level=0).program)
    # the wide launches of phase 1: their scalar kernels at two lanes a
    # thread, in libraries of their own
    wide = wide_cases(WIDE_BLOCK)
    lanes = lanes_per_thread(WIDE_BLOCK)
    wide_optimized = [Engine(prog, builder, grid, block, args,
                             opt_level=0).program
                      for _, (prog, grid, block, args, _) in wide]
    # one batch: an nvcc per generated source and per hand-written kernel
    jobs = [nvcc_build.segment_job(emit_module(p)[0]) for p in optimized]
    jobs += [nvcc_build.segment_job(emit_module(p, lanes)[0])
             for p in wide_optimized]
    jobs += [nvcc_build.kernel_job(n) for n in kernel_lib.SOURCES]
    built = nvcc_build.build(jobs)
    print(f"# nvcc: {built['built']} libraries built in "
          f"{built['seconds']:.1f} s for {len(optimized)} optimized programs, "
          f"{len(wide_optimized)} more at {lanes} lanes a thread and the "
          f"{len(kernel_lib.SOURCES)} hand-written kernels (one nvcc per "
          "source, one per CPU core at a time)")
    # ptxas's report of every hand-written kernel: registers and spills of
    # each template build
    for name in kernel_lib.SOURCES:
        log = built["logs"].get(nvcc_build.kernel_job(name)[1], "")
        for fn, line in ptxas_report(log):
            print(f"# ptxas {name} {fn}: {line}")

    lap("phase 0")
    # -- phase 1: every kernel against its plain version and the oracle ---------
    for name in names:
        for lvl in levels:
            got = {}
            for backend, device in (("cuda", dev), ("vectorized", dev),
                                    ("interp", "cpu")):
                prog, oracle, grid, block, args, outs = ks.example_launch(
                    name, rng=np.random.default_rng(42))
                s = HetSession(backend, opt_level=lvl, device=device,
                               cache=TranslationCache())
                _, got[backend] = run_launch(s, prog, grid, block, args, outs)
                if backend == "cuda":
                    st = s.block_stats()
                    torch.cuda.synchronize()
            oargs = dict(args, _num_blocks=grid, _block_size=block)
            want = oracle(oargs)
            for o in outs:
                k = got["cuda"][o]
                check(same_bits(k, got["vectorized"][o]),
                      f"{name} O{lvl} {o}: kernel != plain version")
                check(same_bits(k, got["interp"][o]),
                      f"{name} O{lvl} {o}: kernel != interpreter")
                if name in zoo.ZOO:
                    check(same_bits(k, np.asarray(want[o])),
                          f"{name} O{lvl} {o}: kernel != zoo oracle bits")
                else:
                    check(np.allclose(k, want[o], atol=1e-5, rtol=1e-5),
                          f"{name} O{lvl} {o}: kernel != suite oracle")
            pinned = PINNED_BLOCK_STATS[name][lvl]
            check((st["tiled"], st["scalar"], st["reasons"]) == pinned,
                  f"{name} O{lvl}: block_stats {st} != pinned {pinned}")
    print(f"phase 1: {len(names)} kernels x O0/O{OPT_MAX}: bits equal to the "
          "plain version and the interpreter, oracles met, block_stats as "
          "pinned")
    n_edge = check_edge_grids(dev)
    print(f"phase 1: {n_edge} edge-grid programs: bits equal to the plain "
          "version and the interpreter")
    n_wide = check_edge_grids(dev, wide)
    print(f"phase 1: {n_wide} programs with cross-lane ops in blocks of "
          f"{WIDE_BLOCK} lanes ({lanes} a thread): bits equal to the plain "
          "version and the interpreter")

    lap("phase 1")
    # -- phases 2-3: the main path at full width -------------------------------
    attn_want = attn_oracle(dict(attn_args))["O"]
    vadd_want = vadd_args["A"] + vadd_args["B"]
    gpu = HetSession("cuda", device=dev)
    vgpu = HetSession("cuda", device=dev)
    main_backends = (gpu.backend, vgpu.backend)
    for b in main_backends:
        b.launches.update(scalar=0, block=0)
        b.scalar_paths.update(staged=0, tree_fold=0)

    rec, out = run_launch(gpu, attn_prog, ATTN_H, ATTN_T, attn_args, ("O",))
    torch.cuda.synchronize()
    check(same_bits(out["O"], attn_want),
          "attn_decode full width: kernel != zoo oracle bits")
    step_launches = dict(gpu.backend.launches, **gpu.backend.scalar_paths)
    check(step_launches["staged"] > 0 and step_launches["tree_fold"] > 0,
          "attn_decode step: no segment kernel staged its K tile or folded "
          f"REDUCE_MAX by a shuffle tree: {step_launches}")
    segs_per_step = rec.engine.executed_ops and len(
        [t for t in gpu.sched_trace if t["seq"] == rec.seq])

    # second launch: pause after 3 segments, checkpoint, CPU hop, back
    fn = gpu.function("attn_decode")
    bufs = {p: gpu.alloc(attn_args[p].size).copy_from_host(attn_args[p])
            for p in ("Q", "K", "V", "O")}
    rec2 = fn.launch_async(ATTN_H, ATTN_T, dict(
        bufs, ntiles=ATTN_NTILES, scale=attn_args["scale"]))
    check(not rec2.advance(3), "attn_decode finished within 3 segments")
    blob = gpu.checkpoint(rec2)
    rec2.cancel()
    cpu = HetSession("vectorized", device="cpu")
    cpu.load(attn_prog)
    on_cpu = cpu.restore("attn_decode", blob)
    check(not on_cpu.advance(2), "attn_decode finished on the CPU hop")
    back = migrate(on_cpu, cpu, gpu, "attn_decode")
    check(back.wait(), "migrated attn_decode did not finish")
    torch.cuda.synchronize()
    check(same_bits(back.buffer("O").copy_to_host(), attn_want),
          "attn_decode cuda -> CPU eager -> cuda: bits changed")

    vrec, vout = run_launch(vgpu, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                            vadd_args, ("C",))
    torch.cuda.synchronize()
    check(same_bits(vout["C"], vadd_want),
          "vadd 2^24: kernel != oracle bits")
    # the block kernel moves the buffers' words and no register array
    vmod = vgpu.backend._module(vrec.engine.program)
    (vsl,) = [k.slots for k in vmod.kernels.values() if k.has_block]
    check(not vsl.inputs and not vsl.outputs,
          f"vadd block kernel has register slots: in {vsl.inputs}, out "
          f"{vsl.outputs}")
    vadd_slot_bytes = 4 * len(vsl.buffers + vsl.inputs + vsl.outputs)
    launches = {k: sum(dict(b.launches, **b.scalar_paths)[k]
                       for b in main_backends)
                for k in ("scalar", "block", "staged", "tree_fold")}
    check(launches["scalar"] > 0 and launches["block"] > 0,
          f"main path missed a kernel: launches {launches}")
    print("phase 2: attn_decode H=24 D=128 window 4096: bits equal to the "
          "oracle; cuda -> CPU eager -> cuda migration bit-identical")
    print(f"phase 3: vadd 2^24: bits equal to the oracle; its block kernel "
          f"has no register slot: {vadd_slot_bytes} B per element "
          f"({len(vsl.buffers)} buffer words)")
    print(f"# segment-kernel launches per decode step: {step_launches} "
          f"({segs_per_step} segments)")

    # -- plain versions at full width (on the card) ---------------------------
    plain = HetSession("vectorized", device=dev)
    _, pout = run_launch(plain, attn_prog, ATTN_H, ATTN_T, attn_args, ("O",))
    check(same_bits(out["O"], pout["O"]),
          "attn_decode full width: kernel != plain version")
    attn_err = max_abs_err(out["O"], pout["O"])
    _, pvout = run_launch(plain, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                          vadd_args, ("C",))
    check(same_bits(vout["C"], pvout["C"]),
          "vadd 2^24: kernel != plain version")
    vadd_err = max_abs_err(vout["C"], pvout["C"])

    lap("phases 2-3")
    # -- phase 5: the kernel library at full width ----------------------------
    from repro_torch.kernels.hetir_gen import het_kernel
    from repro_torch.kernels.hetir_gen.ref import het_kernel_ref
    torch.backends.cuda.matmul.allow_tf32 = False   # the oracles in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    counters = launch_counters()
    cases = library_cases(dev)
    reset_launches(counters)
    for c in cases:
        c.out = c.op()
    torch.cuda.synchronize()
    lib_launches = read_launches(counters)
    check(all(v > 0 for v in lib_launches.values()),
          f"phase 5 main path missed a kernel: launches {lib_launches}")
    for c in cases:
        check_library_case(c)
    check_library_grads(dev)
    print("phase 5: each op's gradient through its autograd.Function equals "
          "autograd of its oracle within 1e-3")
    prog, _, grid, block, args, _ = ks.example_launch(
        "matmul_tiled", rng=np.random.default_rng(42))
    het = het_kernel(prog, grid, block)
    got, want = het(**args), het_kernel_ref(prog, grid, block)(**args)
    torch.cuda.synchronize()
    check(all(same_bits(got[b], want[b]) for b in want),
          "het_kernel on the card != het_kernel_ref")
    check(sum(het.backend.launches.values()) > 0,
          "het_kernel launched no segment kernel")
    print(f"phase 5: het_kernel(matmul_tiled) on the card bit-equal to "
          f"het_kernel_ref; segment launches {dict(het.backend.launches)}")
    print(f"# kernel-library launches in phase 5's main path: {lib_launches}")

    lap("phase 5")
    # -- phase 4: times ---------------------------------------------------------
    def launcher(session, prog, grid, block, args):
        fn = session.load(prog).function()
        from repro_torch.core import hetir as ir
        bound = {}
        for p in prog.params:
            bound[p.name] = session.alloc(
                int(args[p.name].size), p.dtype).copy_from_host(
                    args[p.name]) if isinstance(p, ir.Ptr) else args[p.name]

        def go():
            r = fn.launch_async(grid, block, bound)
            check(r.wait(), "timed launch did not finish")
        return go

    attn_go = launcher(gpu, attn_prog, ATTN_H, ATTN_T, attn_args)
    attn_ms = time_ms(attn_go, 5)
    attn_dev_ms, attn_nk, attn_per = kernel_device_ms(gpu.backend, attn_go)
    attn_plain_ms = time_ms(launcher(plain, attn_prog, ATTN_H, ATTN_T,
                                     attn_args), 2)
    vadd_go = launcher(vgpu, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                       vadd_args)
    vadd_ms = time_ms(vadd_go, 20)
    vadd_dev_ms, vadd_nk, _ = kernel_device_ms(vgpu.backend, vadd_go)
    vadd_plain_ms = time_ms(launcher(plain, vadd_prog, VADD_N // VADD_BLOCK,
                                     VADD_BLOCK, vadd_args), 5)

    q = torch.from_numpy(attn_args["Q"]).to(dev).view(ATTN_H, 1, ATTN_D)
    kk = torch.from_numpy(attn_args["K"]).to(dev).view(ATTN_H, S, ATTN_D)
    vv = torch.from_numpy(attn_args["V"]).to(dev).view(ATTN_H, S, ATTN_D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_lib_ms = time_ms(lambda: sdpa(q, kk, vv,
                                       scale=float(attn_args["scale"])), 20)
    a = torch.from_numpy(vadd_args["A"]).to(dev)
    b = torch.from_numpy(vadd_args["B"]).to(dev)
    c = torch.empty_like(a)
    vadd_lib_ms = time_ms(lambda: torch.add(a, b, out=c), 20)
    # the library calls' device time alone, as for the library kernels
    attn_lib_dev_ms = sum(profile_launch(lambda: sdpa(
        q, kk, vv, scale=float(attn_args["scale"]))).values()) or None
    vadd_lib_dev_ms = sum(profile_launch(
        lambda: torch.add(a, b, out=c)).values()) or None

    attn_bytes = 4 * (attn_args["Q"].size + attn_args["K"].size
                      + attn_args["V"].size + attn_args["O"].size)
    attn_ops = 4 * ATTN_H * S * ATTN_D          # q.k and p.v multiply-adds
    attn_bound_ms = max(attn_bytes / HBM_BYTES_PER_S,
                        attn_ops / F32_OPS_PER_S) * 1e3
    vadd_bytes = 4 * 3 * VADD_N
    vadd_bound_ms = max(vadd_bytes / HBM_BYTES_PER_S,
                        VADD_N / F32_OPS_PER_S) * 1e3
    print(f"# attn_decode step: {attn_ms:.4f} ms (plain {attn_plain_ms:.4f} "
          f"ms, SDPA fp32 {attn_lib_ms:.4f} ms (device {attn_lib_dev_ms} "
          f"ms), bound {attn_bound_ms:.4f} ms "
          f"= {attn_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# attn_decode step: {attn_nk} segment kernels take "
          f"{attn_dev_ms:.4f} ms of device time; the rest is host work")
    # the two tile kernels (one launch per kv tile each) against the rest
    tiles = sorted(attn_per.items(), key=lambda kv: -kv[1][1])[:2]
    for (seg, mode), (ms, n) in sorted(tiles):
        print(f"#   segment {seg} ({mode}): {n} launches, {ms:.4f} ms")
    rest = attn_dev_ms - sum(ms for _, (ms, _) in tiles)
    print(f"#   the other {attn_nk - sum(n for _, (_, n) in tiles)} "
          f"launches: {rest:.4f} ms")
    print(f"# vadd 2^24: {vadd_ms:.4f} ms (plain {vadd_plain_ms:.4f} ms, "
          f"torch.add {vadd_lib_ms:.4f} ms (device {vadd_lib_dev_ms} ms), "
          f"bound {vadd_bound_ms:.4f} ms "
          f"= {vadd_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# vadd 2^24: {vadd_nk} segment kernel takes {vadd_dev_ms:.4f} ms "
          "of device time")
    print_profile("attn_decode step", profile_launch(attn_go), attn_ms)
    print_profile("vadd 2^24", profile_launch(vadd_go), vadd_ms)
    src = "src/repro_torch/core/backends/cuda_backend.py"
    kernels = [
        {"name": "hetir_segment_scalar", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:120",
         "launches": launches["scalar"],
         "staged_launches": launches["staged"],
         "tree_fold_launches": launches["tree_fold"],
         "max_abs_err": attn_err,
         "ms": attn_dev_ms, "launch_ms": attn_ms,
         "plain_ms": attn_plain_ms,
         "bound_ms": attn_bound_ms, "bound_by": "bytes",
         "library_ms": attn_lib_ms, "library_device_ms": attn_lib_dev_ms},
        {"name": "hetir_segment_block", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:263",
         "launches": launches["block"], "max_abs_err": vadd_err,
         "ms": vadd_dev_ms, "launch_ms": vadd_ms,
         "plain_ms": vadd_plain_ms,
         "bound_ms": vadd_bound_ms, "bound_by": "bytes",
         "library_ms": vadd_lib_ms, "library_device_ms": vadd_lib_dev_ms},
    ]
    # the kernel library at phase 5's shapes: the first case of each kernel
    # goes into the kernels line
    for c in cases:
        ms = time_ms(c.fwd, 10)
        plain_ms = time_ms(c.plain, 3)
        # rglru_scan and mlstm_chunk: no single PyTorch call computes a
        # linear recurrence or chunked gated linear attention, so null
        lib_ms = time_ms(c.library, 10) if c.library is not None else None
        # the device alone (the profiler's kernel times of one warm call):
        # a call's event time also holds the host's work before the launch
        # when the device is idle
        by_name = profile_launch(c.fwd)
        dev_ms = sum(by_name.values()) or None
        lib_dev_ms = sum(profile_launch(c.library).values()) or None \
            if c.library is not None else None
        bound_ms, bound_by = c.bound()
        if len(by_name) > 1:   # a call of several kernels: each one's share
            for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1]):
                print(f"#   {kms:.4f} ms device  {name[:90]}")
        if getattr(c, "executed", None):
            print(f"# {c.label}: the kernels execute {c.executed:.6g} "
                  f"operations, {c.executed / c.ops:.4f} of the bound's "
                  f"{c.ops:.6g}")
        lib_txt = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ms (device {lib_dev_ms} ms)"
        print(f"# {c.label}: kernel {ms:.4f} ms (device {dev_ms} ms), plain "
              f"{plain_ms:.4f} ms, library call {lib_txt}, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({c.nbytes} B, {c.ops:.6g} "
              f"operations) on {smi}")
        if c.ops_rate == F32_OPS_PER_S and bound_by == "operations":
            # the f32 products on the CUDA cores: rate and share of the bound
            dms = dev_ms or ms
            print(f"#   {c.ops / dms / 1e9:.2f} TFLOP/s of f32 in "
                  f"{dms:.4f} ms ({'device' if dev_ms else 'events'}), "
                  f"{bound_ms / dms:.4f} of the f32 bound")
        if any(k["name"] == c.kernel for k in kernels):
            continue
        kernels.append(
            {"name": c.kernel, "route": "cuda",
             "source": "src/repro_torch/csrc/kernels/"
                       f"{KERNEL_SOURCE.get(c.kernel, c.kernel)}.cu",
             "replaces": REPLACES[c.kernel],
             "launches": lib_launches[c.kernel], "max_abs_err": c.err,
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms, "library_device_ms": lib_dev_ms})
    lap("phase 4")
    # -- phase 6: the persistent tiers, serving and the fleet on the card -------
    p6 = phase6(dev, smi)
    for k, mode in ((kernels[0], "scalar"), (kernels[1], "block")):
        k["phase6_launches"] = {part: c.get(mode, 0)
                                for part, c in p6.items()}
    lap("phase 6")
    # phases 7-9 serve: no autograd (the parameters require gradients)
    with torch.no_grad():
        # -- phase 7: the model stack's serving path at full width ----------
        p7 = phase7(dev, smi)
        serve_tokens = p7.pop("tokens")
        lap("phase 7")
        # -- phase 8: the recurrent families on the serving path ------------
        p8 = dict(phase8(dev, smi), **{SERVE_ARCH: p7})
        lap("phase 8")
        # -- phase 9: the encoder-decoder family on the serving path --------
        p8[WHISPER_ARCH] = phase9(dev, smi)
    for k in kernels:
        path = {arch: res[k["name"]] for arch, res in p8.items()
                if k["name"] in res}
        if path:
            k["model_path"] = path
    lap("phase 9")
    # -- phase 10: the training path at full width -----------------------------
    p10 = phase10(dev, smi)
    first_step = p10.pop("first_step")
    lap("phase 10")
    # -- phase 11: the multi-device layer on the card's one-device mesh -------
    p11 = phase11(dev, smi, serve_tokens, first_step)
    for k in kernels:
        if k["name"] in p11:
            k["mesh_path"] = {SERVE_ARCH: p11[k["name"]]}
    lap("phase 11")
    # -- phase 12: the production dry run's one-card cell ---------------------
    p12, p12_peak = phase12(dev, smi)
    for k in kernels:
        if p12.get(k["name"]):
            k["dryrun_path"] = {SERVE_ARCH: p12[k["name"]]}
    lap("phase 12")
    # -- phase 13: the split's per-rank shares on the card ---------------------
    p13 = phase13(dev, smi, p12_peak)
    for k in kernels:
        path = {arch: res[k["name"]] for arch, res in p13.items()
                if k["name"] in res}
        if path:
            k["split_path"] = path
    lap("phase 13")
    # -- phase 14: the recurrent and encoder-decoder families trained ---------
    p14 = dict(phase14(dev, smi), **{SERVE_ARCH: p10})
    for k in kernels:
        if any(k["name"] in res for res in p14.values()):
            k["train_path"] = {arch: res.get(k["name"],
                                             {"launches_per_step": 0})
                               for arch, res in p14.items()}
    lap("phase 14")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--phase6-child"]:
            sys.exit(phase6_child(*sys.argv[2:5]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
