"""RoBERTa text encoder and the hermetic tokenizer: counterparts of
``ocpg_tpu/models/text_encoder.py``.

The encoder is written out here (a post-LN transformer with learned
positions offset by RoBERTa's padding index 1, and a tanh pooler), with the
JAX tree's names (``word_embeddings``, ``layer_{i}/q`` ...).  The tokenizer
is the JAX ``SimpleTokenizer``: a RoBERTa tokenizer from HF vocabulary
files (``checkpoint_path``), or else the md5 hash path, with identical ids
either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import List, Optional, Tuple

import numpy as np
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


class SimpleTokenizer:
    """Host-side tokenizer giving fixed-length ``(input_ids, attention_mask)``
    int32 arrays, padded to ``max_len``.

    With ``checkpoint_path`` it is HF's fast RoBERTa tokenizer loaded from
    that directory (``vocab.json``, ``merges.txt`` and ``tokenizer.json``,
    as a RoBERTa checkpoint holds them); a path that fails to load raises
    ``ValueError`` naming it, and an id ``>= vocab_size`` raises.  Without
    one it is the hermetic hash tokenizer: ``<s> words </s>`` with md5 word
    ids, padded with id 1.  Either way the ids are the JAX package's.
    """

    def __init__(self, checkpoint_path: Optional[str] = None, max_len: int = 32,
                 vocab_size: int = 50265):
        self.max_len = max_len
        self.vocab_size = vocab_size
        self._hf = None
        if checkpoint_path:
            # a tokenizer path that fails to load must not fall back to the
            # hash ids: a real checkpoint would run on garbage tokens
            import transformers

            # a local directory only: a name such as "roberta-base" must
            # not turn into a request to the model hub
            if not os.path.isdir(checkpoint_path):
                raise ValueError(f"failed to load tokenizer from {checkpoint_path!r}: not a "
                                 "directory; omit tokenizer_path to use the hash tokenizer")
            # transformers 5 moved the fast tokenizer into RobertaTokenizer;
            # its RobertaTokenizerFast.from_pretrained drops the BPE merges
            # of a tokenizer.json and cannot read vocab.json + merges.txt
            if int(transformers.__version__.split(".")[0]) < 5:
                tokenizer_class = transformers.RobertaTokenizerFast
            else:
                tokenizer_class = transformers.RobertaTokenizer
            try:
                self._hf = tokenizer_class.from_pretrained(checkpoint_path,
                                                           local_files_only=True)
            except Exception as e:
                raise ValueError(
                    f"failed to load tokenizer from {checkpoint_path!r}: {e}; "
                    "omit tokenizer_path to use the hash tokenizer") from e

    def __call__(self, captions: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if self._hf is not None:
            # the tokenizer's __call__ (transformers 5 has no batch_encode_plus)
            enc = self._hf(list(captions), padding="max_length", truncation=True,
                           max_length=self.max_len, return_tensors="np")
            ids = np.asarray(enc["input_ids"]).astype(np.int32)
            if ids.max(initial=0) >= self.vocab_size:
                # an out-of-range id would index past the embedding table
                raise ValueError(
                    f"tokenizer produced id {int(ids.max())} >= vocab_size "
                    f"{self.vocab_size}; pass vocab_size=cfg.text_vocab")
            return ids, np.asarray(enc["attention_mask"]).astype(np.int32)
        ids = np.full((len(captions), self.max_len), 1, dtype=np.int32)
        mask = np.zeros((len(captions), self.max_len), dtype=np.int32)
        for i, cap in enumerate(captions):
            row = [0]
            for word in cap.lower().split()[: self.max_len - 2]:
                h = int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")
                row.append(4 + (h % (self.vocab_size - 8)))
            row.append(2)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask
