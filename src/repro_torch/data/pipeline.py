"""Deterministic, seekable synthetic data pipeline.

Port of ``src/repro/data/pipeline.py`` (numpy only, copied): batches are a
pure function of (seed, step) through numpy's Philox counter RNG, with no
iterator state, so a restarted or migrated job resumes mid-stream
exactly, and its batches are bit-identical to the reference's.  With a
``mesh`` of several ranks and the batch's ``specs``
(``MeshRules.batch_specs``) every rank makes the full batch and keeps
its block of each leaf as a ``DTensor`` placed by its spec, as the
reference places a batch on its mesh; otherwise the batch goes to one
device (``device``), or stays numpy with neither.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from ..parallel.sharding import distribute, is_sharded


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, seed: int = 0,
                 device=None, mesh=None, specs=None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.device = device
        self.mesh = mesh
        self.specs = specs
        self.B = shape.global_batch
        self.S = shape.seq_len

    def _numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step (Philox counter RNG): ``tokens`` int32,
        and the frontend stubs' f32 embeddings (``enc_embeds`` for an
        encoder–decoder model, ``embeds`` for the patch frontend, whose
        tokens then fill the sequence after ``frontend_tokens``)."""
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=[0, 0, 0, step]))
        cfg, B, S = self.cfg, self.B, self.S
        if cfg.encoder_decoder:
            return {"enc_embeds": rng.normal(size=(B, S, cfg.d_model))
                    .astype(np.float32) * 0.02,
                    "tokens": rng.integers(0, cfg.vocab_size, (B, S))
                    .astype(np.int32)}
        if cfg.frontend == "patch":
            F = cfg.frontend_tokens
            return {"embeds": rng.normal(size=(B, F, cfg.d_model))
                    .astype(np.float32) * 0.02,
                    "tokens": rng.integers(0, cfg.vocab_size, (B, S - F))
                    .astype(np.int32)}
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}

    def batch_at(self, step: int):
        """The batch of ``step``: ``DTensor``s on the mesh, or torch
        tensors on ``device`` (the same values and types), or the numpy
        arrays when neither was given."""
        batch = self._numpy_batch(step)
        if self.mesh is not None and self.specs is not None \
                and is_sharded(self.mesh):
            dev = self.device or "cpu"
            return {k: distribute(torch.from_numpy(v).to(dev), self.mesh,
                                  self.specs[k])
                    for k, v in batch.items()}
        if self.device is None:
            return batch
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}
