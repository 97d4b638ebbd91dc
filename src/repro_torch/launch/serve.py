"""Serving launcher: continuous batched greedy decode on the port's model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
        --device cpu

Port of ``src/repro/launch/serve.py``: prompts drawn from ``--seed`` with
numpy (tokens, then an encoder–decoder model's frame embeddings, then the
patch frontend's embeddings), one prefill with a cache of ``prompt_len +
steps`` positions (and an encoder–decoder model's cross k/v), then
``steps - 1`` decode steps at positions ``S + i``, each feeding back the
argmax over the padded vocab.
Weights are random, drawn from ``--seed`` by a ``torch.Generator`` on the
device.  The model runs on ``--device`` (``cuda`` unless the caller asks
for ``cpu``, where the kernels run their plain versions).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import configs
from ..configs.base import ModelConfig
from ..core.backends.base import resolve_device
from ..models import Model


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
               device, enc_len: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """The reference launcher's prompts: ``tokens [B, S]`` (the text part
    after the frontend's ``frontend_tokens`` when it has one), an
    encoder–decoder model's frame embeddings ``enc_embeds [B, enc_len,
    D]`` (``enc_len`` defaults to ``prompt_len``, as the reference draws
    them) and the patch frontend's ``embeds``."""
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, cfg.compute_dtype)
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = {"tokens": torch.from_numpy(tokens).to(device)}
    if cfg.encoder_decoder:
        frames = rng.normal(size=(batch, enc_len or prompt_len,
                                  cfg.d_model)) * 0.02
        out["enc_embeds"] = torch.from_numpy(frames.astype(np.float32)).to(
            device=device, dtype=dtype)
    if cfg.frontend == "patch":
        embeds = rng.normal(size=(batch, cfg.frontend_tokens,
                                  cfg.d_model)) * 0.02
        out["embeds"] = torch.from_numpy(embeds.astype(np.float32)).to(
            device=device, dtype=dtype)
        out["tokens"] = out["tokens"][:, cfg.frontend_tokens:]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, batch: Dict[str, torch.Tensor], steps: int
             ) -> Dict[str, object]:
    """Greedy decode of ``steps`` tokens per prompt: the prefill's argmax,
    then ``steps - 1`` decode steps.  Returns the tokens ``[B, steps]``
    (on the CPU), the prefill's milliseconds and the decode's per step
    (host clock around work that ends in a device synchronize).  ``S``,
    the decoder's prompt, does not count an encoder's frames
    (``enc_embeds``)."""
    dev = model.device
    S = batch["tokens"].shape[1] + (
        batch["embeds"].shape[1] if "embeds" in batch
        and model.frontend is not None else 0)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, cache_len=S + steps)
    toks = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    out = [toks]
    for i in range(steps - 1):
        logits, caches = model.decode_step(toks, caches, S + i)
        toks = logits[:, -1].argmax(-1)[:, None]
        out.append(toks)
    _sync(dev)
    t2 = time.perf_counter()
    B = batch["tokens"].shape[0]
    decode_s = t2 - t1
    return {"tokens": torch.cat(out, dim=1).cpu(),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / max(steps - 1, 1),
            "tokens_per_s": (steps - 1) * B / decode_s if decode_s else 0.0,
            "caches": caches}


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          steps: int = 32, device=None, seed: int = 0,
          model: Optional[Model] = None,
          enc_len: Optional[int] = None) -> Dict[str, object]:
    """Build the model of ``cfg`` from ``seed`` on ``device`` (or take
    ``model``), draw the prompts from ``seed`` (an encoder–decoder model's
    ``enc_len`` frames, ``prompt_len`` unless given) and
    :func:`generate`.  The result also holds the model and the batch."""
    if model is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        model = Model(cfg, generator=gen, device=device)
    batch_in = make_batch(cfg, batch, prompt_len, seed, model.device,
                          enc_len)
    out = generate(model, batch_in, steps)
    out.update(model=model, batch=batch_in)
    return out


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                steps=args.steps, device=args.device, seed=args.seed)
    n = (args.steps - 1) * args.batch
    print(f"prefill {out['prefill_ms']:.2f} ms; {n} tokens in "
          f"{out['decode_ms_per_step'] * (args.steps - 1) / 1e3:.2f}s "
          f"({out['tokens_per_s']:.1f} tokens/s) on {out['model'].device}")
    return out


if __name__ == "__main__":
    main()
