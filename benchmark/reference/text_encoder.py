"""RoBERTa text encoder: counterpart of ``ocpg_tpu/models/text_encoder.py``
(the tokenizer is left out: the benchmark draws token ids itself).

The encoder is written out here (a post-LN transformer with learned
positions offset by RoBERTa's padding index 1, and a tanh pooler), with the
JAX tree's names (``word_embeddings``, ``layer_{i}/q`` ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        c, f = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_heads
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.attn_out = nn.Linear(c, c)
        self.attn_ln = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(c, f)
        self.ffn_out = nn.Linear(f, c)
        self.ffn_ln = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h = self.num_heads
        dh = c // h

        def split(t):
            return t.reshape(b, l, h, dh).transpose(1, 2)

        logits = torch.matmul(split(self.q(x)), split(self.k(x)).transpose(-1, -2))
        logits = logits.float() / math.sqrt(dh)
        logits = logits.masked_fill(pad_mask[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        v = split(self.v(x))
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, c)
        x = self.attn_ln(x + self.attn_out(ctx))
        y = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + y)


class RobertaEncoder(nn.Module):
    def __init__(self, cfg: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", RobertaLayer(cfg))
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (last hidden state (B, L, C), pooled output (B, C))."""
        cfg = self.cfg
        pad_mask = attention_mask == 0
        mask_i = attention_mask.long()
        position_ids = torch.cumsum(mask_i, dim=1) * mask_i + cfg.pad_token_id
        x = (self.word_embeddings(input_ids.long())
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(torch.zeros_like(mask_i)))
        x = self.embeddings_ln(x)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled
