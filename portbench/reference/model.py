"""A reference model: the embedding, a family's blocks, the final norm and
the head, over weights by the port's parameter names, computed layer by
layer in float32 (or the ``fp8`` control's precision, :func:`.ops.mm`).

:meth:`RefModel.last_logits` is a prefill's last-position logits.
:meth:`RefModel.train` follows the training step: next-token
cross-entropy (plus ``router_aux_loss_coef`` times the layers' summed
load-balancing losses), its gradients in float32, taken layer by layer
from the layers' inputs (each layer recomputed with autograd), the
gradients clipped to ``clip_norm`` in global norm, and AdamW (bias
corrections, decoupled weight decay on every leaf) with the learning rate
warmed up linearly; the weights stay in the type they are served in, as
the configuration states (``torch_dtype``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from . import family
from .ops import mm, rms_norm


@dataclass(frozen=True)
class RefConfig:
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    window: Optional[int]
    theta: float
    eps: float
    tied: bool
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.0
    aux_coef: float = 0.0

    @classmethod
    def of(cls, c) -> "RefConfig":
        return cls(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim") or
                   c["hidden_size"] // c["num_attention_heads"],
                   window=c.get("sliding_window"), theta=c["rope_theta"],
                   eps=c["rms_norm_eps"],
                   tied=bool(c.get("tie_word_embeddings")),
                   experts=c.get("num_local_experts") or 0,
                   top_k=c.get("num_experts_per_tok") or 0,
                   capacity_factor=c.get("capacity_factor", 1.0),
                   aux_coef=c.get("router_aux_loss_coef", 0.0))


def lr_at(step: int, o) -> torch.Tensor:
    """The learning rate of ``step`` (from 0): linear warmup to
    ``peak_lr`` over ``warmup_steps`` (step ``s`` takes ``(s + 1) /
    warmup_steps`` of it), then a cosine to a tenth of it at
    ``total_steps``; float32."""
    s = torch.tensor(float(step))
    warm = o["peak_lr"] * torch.clamp((s + 1) / o["warmup_steps"], max=1.0)
    frac = torch.clamp((s - o["warmup_steps"]) / max(
        o["total_steps"] - o["warmup_steps"], 1), 0.0, 1.0)
    cos = o["peak_lr"] * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < o["warmup_steps"], warm, cos)


class RefModel:
    """The reference of configuration ``c`` over ``weights`` (by the port's
    parameter names; updated in place by :meth:`train`)."""

    def __init__(self, c, weights: Dict[str, torch.Tensor],
                 prec: str = "f32"):
        self.c = RefConfig.of(c)
        self.family = family(c)
        self.w = weights
        self.prec = prec

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        pre = f"blocks.{i}."
        return {n[len(pre):]: t for n, t in self.w.items()
                if n.startswith(pre)}

    def _head(self):
        return self.w["embed"].t() if self.c.tied else self.w["lm_head"]

    @torch.no_grad()
    def last_logits(self, tokens) -> torch.Tensor:
        """The last position's logits ``[B, vocab rows]`` of ``tokens [B,
        S]``."""
        x = self.w["embed"][tokens].float()
        for i in range(self.c.layers):
            lp = {n: t.float() for n, t in self.layer(i).items()}
            x, _ = self.family.block(x, lp, self.c, self.prec)
        x = rms_norm(x[:, -1], self.w["final_norm.scale"].float(),
                     self.c.eps)
        return mm(x, self._head().float(), self.prec)

    @staticmethod
    def _leaf(t):
        """A float32 copy of ``t`` that collects its own gradient."""
        return t.detach().to(torch.float32, copy=True).requires_grad_()

    def loss_and_grads(self, tokens):
        """(loss, float32 gradients by parameter name) of ``tokens [B,
        S]``."""
        c, w = self.c, self.w
        with torch.no_grad():
            xs = [w["embed"][tokens].float()]
            for i in range(c.layers):
                lp = {n: t.float() for n, t in self.layer(i).items()}
                xs.append(self.family.block(xs[-1], lp, c, self.prec)[0])
        grads: Dict[str, torch.Tensor] = {}
        x = xs.pop().requires_grad_()
        scale = self._leaf(w["final_norm.scale"])
        head_name = "embed" if c.tied else "lm_head"
        head = self._leaf(w[head_name])
        h = rms_norm(x[:, :-1], scale, c.eps)
        logits = mm(h, head.t() if c.tied else head, self.prec)
        labels = tokens[:, 1:].long()
        nll = (torch.logsumexp(logits, -1)
               - logits.gather(-1, labels[..., None])[..., 0]).mean()
        nll.backward()
        loss = float(nll.detach())
        del logits, h
        grads["final_norm.scale"], grads[head_name] = scale.grad, head.grad
        dx = x.grad
        for i in reversed(range(c.layers)):
            xin = xs.pop().requires_grad_()
            lp = {n: self._leaf(t) for n, t in self.layer(i).items()}
            out, aux = self.family.block(xin, lp, c, self.prec)
            if aux is None:
                out.backward(dx)
            else:
                torch.autograd.backward(
                    [out, aux], [dx, torch.tensor(c.aux_coef,
                                                  device=aux.device)])
                loss += c.aux_coef * float(aux.detach())
            dx = xin.grad
            for n, t in lp.items():
                grads[f"blocks.{i}.{n}"] = t.grad
        emb = torch.zeros(w["embed"].shape, dtype=torch.float32,
                          device=dx.device).index_add_(
            0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        grads["embed"] = emb + grads["embed"] if c.tied else emb
        return loss, grads

    def train(self, batches: List[torch.Tensor], o) -> Dict[str, object]:
        """Run one step per batch of token rows; returns each step's
        ``losses``, each leaf's first-moment norm after the first step
        (``m1``: the clipped first gradient, times ``1 - b1``) and the
        moments (``m``, ``v``) after the last."""
        m: Dict[str, torch.Tensor] = {}
        v: Dict[str, torch.Tensor] = {}
        losses, m1 = [], None
        for step, tokens in enumerate(batches):
            loss, grads = self.loss_and_grads(tokens)
            losses.append(loss)
            gnorm = torch.sqrt(sum(torch.sum(g.square())
                                   for g in grads.values()))
            scale = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            n = torch.tensor(float(step + 1), device=gnorm.device)
            c1 = 1.0 - torch.tensor(o["b1"], device=n.device) ** n
            c2 = 1.0 - torch.tensor(o["b2"], device=n.device) ** n
            lr = lr_at(step, o).to(n.device)
            with torch.no_grad():
                for name in list(grads):
                    g = grads.pop(name) * scale
                    p = self.w[name]
                    mn = (1 - o["b1"]) * g if name not in m else \
                        o["b1"] * m[name] + (1 - o["b1"]) * g
                    vn = (1 - o["b2"]) * g.square() if name not in v else \
                        o["b2"] * v[name] + (1 - o["b2"]) * g.square()
                    m[name], v[name] = mn, vn
                    p32 = p.float()
                    upd = (mn / c1) / (torch.sqrt(vn / c2) + o["eps"]) \
                        + o["weight_decay"] * p32
                    p.copy_(p32 - lr * upd)
                    del g
            if step == 0:
                m1 = {n: float(t.norm()) for n, t in m.items()}
        return {"losses": losses, "m1": m1, "m": m, "v": v}
