"""Transformer stack: LayerScale / PreNorm attention and GEGLU blocks.

PyTorch counterpart of ``dalle_pytorch_tpu/ops/transformer.py``: the
residual executor with per-layer attention variants cycled from
``attn_types``, its training and ``return_kv`` (prefill) forwards, with
``use_remat`` as ``torch.utils.checkpoint`` per (attn, ff) block, and its
KV-cache ``decode_step``.  Dropout (attention output and feed-forward)
applies in the training forward of a module in training mode, never in
prefill or decode.  The projections keep f32 parameters and run in the
activation dtype, as flax's ``Dense(dtype=...)``.  The reversible
executor and the MoE feed-forward are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.helpers import cast_tuple, default, linear_in
from .attention import AttnPattern, MultiHeadAttention

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


def layerscale_init(layer_index: int) -> float:
    """LayerScale init by 1-based layer index."""
    if layer_index <= 18:
        return 0.1
    if layer_index <= 24:
        return 1e-5
    return 1e-6


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The f32 LayerNorm of the JAX blocks, cast back to x's dtype."""
    return norm(x.float()).to(x.dtype)


class AttnBlock(nn.Module):
    """LayerScale(PreNorm(attention))."""

    def __init__(self, pattern: AttnPattern, dim: int, layer_index: int,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 use_pallas: bool = False, sliced_kv_decode: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = MultiHeadAttention(
            pattern, dim=dim, heads=heads, dim_head=dim_head, dropout=dropout,
            use_pallas=use_pallas, sliced_kv_decode=sliced_kv_decode,
            dtype=dtype, device=device)
        self.scale = nn.Parameter(torch.full(
            (1, 1, dim), layerscale_init(layer_index), device=device))

    def forward(self, x, mask=None, return_kv: bool = False,
                drop: bool = False):
        out = self.attn(layer_norm(self.norm, x), mask=mask,
                        return_kv=return_kv, drop=drop)
        if return_kv:
            h, kv = out
            return h * self.scale.to(h.dtype), kv
        return out * self.scale.to(out.dtype)

    def decode_step(self, x, cache_k, cache_v, index: int, mask=None):
        h, ck, cv = self.attn.decode_step(layer_norm(self.norm, x), cache_k,
                                          cache_v, index, mask=mask)
        return h * self.scale.to(h.dtype), ck, cv


class FFBlock(nn.Module):
    """LayerScale(PreNorm(GEGLU feed-forward))."""

    def __init__(self, dim: int, layer_index: int, mult: int = 4,
                 dropout: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.dropout = dropout
        self.dtype = dtype
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.dense_in = nn.Linear(dim, inner * 2, device=device)
        self.dense_out = nn.Linear(inner, dim, device=device)
        self.scale = nn.Parameter(torch.full(
            (1, 1, dim), layerscale_init(layer_index), device=device))

    def forward(self, x, drop: bool = False):
        h = linear_in(self.dense_in, layer_norm(self.norm, x), self.dtype)
        h, gates = h.chunk(2, dim=-1)
        # flax's nn.gelu is the tanh approximation
        h = h * F.gelu(gates, approximate="tanh")
        if drop and self.dropout > 0:
            h = F.dropout(h, self.dropout)
        h = linear_in(self.dense_out, h, self.dtype)
        return h * self.scale.to(h.dtype)


class Transformer(nn.Module):
    """Depth x (attn, ff) residual stack with cycled attention variants."""

    def __init__(self, dim: int, depth: int, seq_len: int, causal: bool = True,
                 heads: int = 8, dim_head: int = 64, ff_mult: int = 4,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 attn_types: Optional[Tuple[str, ...]] = None,
                 image_fmap_size: Optional[int] = None,
                 text_len: Optional[int] = None, reversible: bool = False,
                 use_remat: bool = False, use_pallas: bool = False,
                 sliced_kv_decode: bool = True, ff_experts: int = 0,
                 sparse_layout_seed: int = 0, dtype=torch.float32,
                 device=None):
        super().__init__()
        if reversible:
            raise NotImplementedError("the reversible executor is not ported")
        if ff_experts > 1:
            raise NotImplementedError("the MoE feed-forward is not ported")
        self.depth = depth
        self.use_remat = use_remat
        self.heads = heads
        self.dim_head = dim_head
        self.seq_len = seq_len
        attn_types = cast_tuple(default(attn_types, ("full",)))
        fmap = default(image_fmap_size, 0)
        text_len = default(
            text_len, seq_len + 1 - fmap * fmap if fmap else seq_len + 1)
        attn_blocks, ff_blocks = [], []
        for ind in range(depth):
            pattern = AttnPattern(
                variant=attn_types[ind % len(attn_types)], seq_len=seq_len,
                text_len=text_len, fmap=fmap, causal=causal,
                layout_seed=sparse_layout_seed + ind)
            attn_blocks.append(AttnBlock(
                pattern, dim, ind + 1, heads=heads, dim_head=dim_head,
                dropout=attn_dropout, use_pallas=use_pallas,
                sliced_kv_decode=sliced_kv_decode, dtype=dtype,
                device=device))
            ff_blocks.append(FFBlock(dim, ind + 1, mult=ff_mult,
                                     dropout=ff_dropout, dtype=dtype,
                                     device=device))
        self.attn_blocks = nn.ModuleList(attn_blocks)
        self.ff_blocks = nn.ModuleList(ff_blocks)

    def _block(self, x, ind: int, mask, drop: bool):
        """One (attn, ff) residual block of the training forward."""
        x = x + self.attn_blocks[ind](x, mask=mask, drop=drop)
        return x + self.ff_blocks[ind](x, drop=drop)

    def forward(self, x, mask=None, return_kv: bool = False):
        """The stack over ``x [b, n, dim]``.  With ``return_kv`` (prefill)
        also each layer's ``(k, v)``, and no dropout.  Otherwise dropout
        follows the module's training mode, and ``use_remat`` recomputes
        each block in the backward (so a flash layer's forward kernel runs
        twice per step) when grads are being recorded."""
        if return_kv:
            kvs = []
            for attn, ff in zip(self.attn_blocks, self.ff_blocks):
                h, kv = attn(x, mask=mask, return_kv=True)
                kvs.append(kv)
                x = x + h
                x = x + ff(x)
            return x, kvs
        remat = self.use_remat and torch.is_grad_enabled()
        for ind in range(self.depth):
            if remat:
                x = checkpoint(self._block, x, ind, mask, self.training,
                               use_reentrant=False)
            else:
                x = self._block(x, ind, mask, self.training)
        return x

    def decode_step(self, x, caches, index: int, mask=None):
        """Single-token pass: x ``[b, 1, dim]``, per-layer ``(k, v)``
        caches (updated in place), absolute position ``index``.  Returns
        ``(out, caches)``."""
        new_caches = []
        for attn, ff, (ck, cv) in zip(self.attn_blocks, self.ff_blocks, caches):
            h, ck, cv = attn.decode_step(x, ck, cv, index, mask=mask)
            x = x + h
            x = x + ff(x)
            new_caches.append((ck, cv))
        return x, new_caches
