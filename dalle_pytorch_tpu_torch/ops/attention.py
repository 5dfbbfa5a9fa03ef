"""Attention variants as boolean patterns, and the attention layer.

PyTorch counterpart of ``dalle_pytorch_tpu/ops/attention.py``.  Every
variant (full / axial_row / axial_col / conv_like / sparse) is one
predicate over absolute positions (``_allowed``), evaluated with numpy on
the host: as the dense ``[n, n]`` mask of the dense path and of the flash
kernel's tile summary (``ops/flash_attention.py``), and as the per-position
key tables of the KV-cache decode step.  The masks equal the JAX package's
exactly, ``sparse``'s seeded random blocks included.

Positions use the padded grid: length ``seq_len + 1``, the first
``text_len = text_seq_len + 1`` positions are text (with <bos>), the rest
is the ``fmap x fmap`` image raster.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import linear_in, max_neg_value

VARIANTS = ("full", "axial_row", "axial_col", "conv_like", "sparse")


def make_variable_sparse_layout(
    num_blocks: int,
    global_blocks: int,
    num_random_blocks: int,
    local_window_blocks: Tuple[int, ...] = (4,),
    causal: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Block-level layout with DeepSpeed ``VariableSparsityConfig``
    semantics: local windows, per-row random blocks, global (text)
    block-columns, optionally unidirectional.  Deterministic via ``seed``."""
    layout = np.zeros((num_blocks, num_blocks), dtype=bool)

    # local windows: consecutive row groups attend within their own group;
    # the last window size repeats to cover the sequence
    sizes = list(local_window_blocks)
    start = 0
    i = 0
    while start < num_blocks:
        w = sizes[i] if i < len(sizes) else sizes[-1]
        end = min(start + w, num_blocks)
        layout[start:end, start:end] = True
        start = end
        i += 1

    # random blocks: per block-row, `num_random_blocks` random block-columns
    # (restricted to <= row when causal)
    rng = np.random.default_rng(seed)
    for row in range(num_blocks):
        hi = row + 1 if causal else num_blocks
        cols = rng.integers(0, hi, size=num_random_blocks)
        layout[row, cols] = True

    layout[:, :global_blocks] = True
    if causal:
        layout &= np.tril(np.ones((num_blocks, num_blocks), dtype=bool))
    return layout


@dataclasses.dataclass(frozen=True)
class AttnPattern:
    """Static description of one layer's attention pattern."""

    variant: str
    seq_len: int          # transformer seq len (text_seq_len + image_seq_len)
    text_len: int         # text positions incl <bos> = text_seq_len + 1
    fmap: int             # image feature-map side; fmap**2 = image_seq_len
    causal: bool = True
    kernel: int = 5       # conv_like kernel size
    dilation: int = 1
    block: int = 16       # sparse block size
    num_random_blocks: Optional[int] = None
    layout_seed: int = 0

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown attention variant {self.variant}")
        if self.variant == "conv_like" and self.kernel % 2 != 1:
            raise ValueError("kernel size must be odd")

    @property
    def padded_len(self) -> int:
        return self.seq_len + 1

    def block_layout(self) -> Optional[np.ndarray]:
        if self.variant != "sparse":
            return None
        n = self.padded_len
        nb = (n + self.block - 1) // self.block
        # random blocks = seq_len // block // 4; global blocks cover the text
        num_random = (
            self.num_random_blocks
            if self.num_random_blocks is not None
            else self.seq_len // self.block // 4
        )
        global_blocks = -(-self.text_len // self.block)  # ceil
        return make_variable_sparse_layout(
            nb, global_blocks, num_random, causal=True, seed=self.layout_seed
        )


def _allowed(pattern: AttnPattern, i, j, layout=None):
    """The pattern predicate: may query position ``i`` attend key position
    ``j``?  numpy integers or broadcastable integer arrays."""
    T, W = pattern.text_len, pattern.fmap
    causal = (j <= i) if pattern.causal else (j == j)
    v = pattern.variant

    if v == "full":
        return causal

    if v == "sparse":
        if layout is None:
            layout = pattern.block_layout()
        return causal & layout[i // pattern.block, j // pattern.block]

    # text queries attend text causally only
    text_q_allowed = causal & (j < T)

    # image query / key raster coordinates
    ri, ci = (i - T) // W, (i - T) % W
    rj, cj = (j - T) // W, (j - T) % W

    if v == "axial_row":
        img_pat = (rj == ri) & (cj <= ci)
    elif v == "axial_col":
        img_pat = (cj == ci) & (rj <= ri)
    else:  # conv_like
        pad = ((pattern.kernel - 1) * pattern.dilation + 1) // 2
        dr, dc = rj - ri, cj - ci
        in_window = (
            (np.abs(dr) <= pad)
            & (np.abs(dc) <= pad)
            & (dr % pattern.dilation == 0)
            & (dc % pattern.dilation == 0)
        )
        img_pat = in_window & causal

    img_q_allowed = np.where(j < T, True, img_pat)
    return np.where(i < T, text_q_allowed, img_q_allowed)


def dense_pattern_mask(pattern: AttnPattern, n_q: int, n_k: int) -> np.ndarray:
    """Static ``[n_q, n_k]`` boolean mask (True = attend)."""
    i = np.arange(n_q)[:, None]
    j = np.arange(n_k)[None, :]
    return np.asarray(_allowed(pattern, i, j, layout=pattern.block_layout()))


def decode_key_positions(
        pattern: AttnPattern, index: int
) -> Optional[Tuple[np.ndarray, np.ndarray, bool]]:
    """Candidate key positions for ONE decode query at position ``index``:
    all text plus the query's raster row / column / causal neighbourhood
    rows, a superset of its reachable keys (``_allowed`` over the returned
    positions restores exactness).  Returns ``(positions [m] int32, valid
    [m] bool, contiguous)`` or None for ``full`` (everything is reachable)
    and ``sparse`` (random blocks are not position-local).

    When ``contiguous`` the image segment ``positions[T:]`` is one
    ascending run, clipped into the raster: an out-of-image candidate must
    never alias onto a text position the text segment already carries."""
    T, W = pattern.text_len, pattern.fmap
    v = pattern.variant
    ii = index - T
    ri, ci = ii // W, ii % W
    contiguous = False
    if v == "axial_row":
        row0 = np.clip(ri, 0, W - 1)
        img = T + row0 * W + np.arange(W)
        img_valid = np.ones((W,), bool)
        contiguous = True
    elif v == "axial_col":
        img = T + ci + np.arange(W) * W
        img_valid = np.ones((W,), bool)
    elif v == "conv_like":
        pad = ((pattern.kernel - 1) * pattern.dilation + 1) // 2
        # the query row and the window rows above it, at the dilation
        # stride, each taken whole; the predicate enforces the columns
        n_rows = pad // pattern.dilation + 1
        if pattern.dilation == 1:
            n_rows = min(n_rows, W)
            row0 = np.clip(ri - (n_rows - 1), 0, W - n_rows)
            rows = row0 + np.arange(n_rows)
            img_valid = np.ones((n_rows * W,), bool)
            contiguous = True
        else:
            rows = ri - pattern.dilation * np.arange(n_rows)
            img_valid = np.broadcast_to(
                ((rows >= 0) & (rows < W))[:, None], (n_rows, W)).reshape(-1)
        img = (T + rows[:, None] * W + np.arange(W)[None, :]).reshape(-1)
    else:
        return None
    positions = np.concatenate([np.arange(T), img]).astype(np.int32)
    valid = np.concatenate([np.ones((T,), bool), img_valid])
    return positions, valid, contiguous


@dataclasses.dataclass(frozen=True)
class DecodeTable:
    """Per-position key tables of one pattern over an ``n_k``-long cache,
    built once on the host and kept on the device.

    Row ``index`` gives the keys the decode query at ``index`` reads:
    ``positions`` (in range), ``allow`` (``_allowed & valid``) and, for a
    contiguous image window, its clamped start in ``starts``."""

    positions: torch.Tensor       # [n_k, m] int64
    allow: torch.Tensor           # [n_k, m] bool
    starts: Optional[np.ndarray]  # [n_k] window starts, contiguous only
    text_len: int


@functools.lru_cache(maxsize=64)
def decode_table(pattern: AttnPattern, n_k: int,
                 device: torch.device) -> Optional[DecodeTable]:
    first = decode_key_positions(pattern, 0)
    if first is None:
        return None
    contiguous = first[2]
    T = pattern.text_len
    positions, allow, starts = [], [], []
    for index in range(n_k):
        pos, valid, _ = decode_key_positions(pattern, index)
        if contiguous:
            # clamp the window into the cache (the padded grid is one
            # longer than the cache, so the last row's window overruns by
            # one) and score the positions actually read
            m_img = pos.shape[0] - T
            start = int(np.clip(pos[T], 0, n_k - m_img))
            img_actual = start + np.arange(m_img)
            pos = np.concatenate([np.arange(T), img_actual])
            valid = np.concatenate([np.ones((T,), bool), img_actual >= T])
            safe = pos
            starts.append(start)
        else:
            valid = valid & (pos >= 0) & (pos < n_k)
            safe = np.clip(pos, 0, n_k - 1)
        positions.append(safe)
        allow.append(_allowed(pattern, index, pos) & valid)
    return DecodeTable(
        positions=torch.as_tensor(np.stack(positions).astype(np.int64),
                                  device=device),
        allow=torch.as_tensor(np.stack(allow), device=device),
        starts=np.asarray(starts) if contiguous else None,
        text_len=T)


@functools.lru_cache(maxsize=64)
def device_pattern_mask(pattern: AttnPattern, n: int,
                        device: torch.device) -> torch.Tensor:
    """``dense_pattern_mask(pattern, n, n)`` as a bool tensor on ``device``,
    built once per (pattern, n, device)."""
    return torch.as_tensor(dense_pattern_mask(pattern, n, n), device=device)


def _scope_key_pad(pattern: AttnPattern, key_mask: torch.Tensor,
                   n_k: int) -> torch.Tensor:
    """Per-variant scope of a ``[b, m]`` key padding mask (True = keep) ->
    ``[b, n_k]`` bool: ``full`` applies it to every key, the other
    variants to the text keys only; keys beyond its scope are kept."""
    if pattern.variant != "full":
        key_mask = key_mask[:, : pattern.text_len]
    m = key_mask.shape[1]
    if m >= n_k:
        return key_mask[:, :n_k]
    return torch.nn.functional.pad(key_mask, (0, n_k - m), value=True)


def _merge_key_pad_mask(pattern: AttnPattern, allow: torch.Tensor,
                        key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``allow`` is ``[..., n_q, n_k]``; returns a ``[b, 1, n_q, n_k]``-
    broadcastable boolean mask with the scoped key padding applied."""
    if key_mask is None:
        return allow
    pad = _scope_key_pad(pattern, key_mask, allow.shape[-1])
    return allow & pad[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """One attention layer of any variant.

    Fused QKV projection without bias and an output projection with bias,
    their parameters f32 and cast to ``dtype`` at use, as flax's
    ``DenseGeneral(dtype=...)`` does.  ``use_pallas`` selects the flash
    path (``ops/flash_attention.py``: the CUDA kernels on the card, their
    plain versions on the CPU); otherwise the dense masked path runs.  Both
    are differentiable.  Softmax runs in f32 whatever the activation dtype.
    ``dropout`` applies to the output projection's result when the caller
    asks for it with ``drop`` (training).
    """

    def __init__(self, pattern: AttnPattern, dim: int = 256, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0,
                 use_pallas: bool = False, sliced_kv_decode: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.pattern = pattern
        self.heads = heads
        self.dim_head = dim_head
        self.dropout = dropout
        self.use_pallas = use_pallas
        self.sliced_kv_decode = sliced_kv_decode
        self.dtype = dtype
        inner = heads * dim_head
        # output features ordered (q|k|v, head, dh), the JAX [dim, 3, h, dh]
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False, device=device)
        self.to_out = nn.Linear(inner, dim, device=device)

    def _qkv(self, x):
        b, n, _ = x.shape
        qkv = linear_in(self.to_qkv, x, self.dtype).view(
            b, n, 3, self.heads, self.dim_head)
        qkv = qkv.permute(2, 0, 3, 1, 4)  # [3, b, heads, n, dh]
        return qkv[0], qkv[1], qkv[2]

    def _key_pad_bias(self, mask, n):
        """``[b, m]`` bool key mask -> additive f32 ``[b, n]`` bias, scoped
        as the dense path scopes it."""
        if mask is None:
            return None
        pad = _scope_key_pad(self.pattern, mask, n)
        return torch.where(pad, 0.0, -1e30).to(torch.float32).contiguous()

    def forward(self, x, mask=None, return_kv: bool = False,
                drop: bool = False):
        b, n, _ = x.shape
        q, k, v = self._qkv(x)
        if self.use_pallas:
            from . import flash_attention

            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out = flash_attention.flash_pattern_attention(
                q, k, v, self.pattern,
                key_pad_bias=self._key_pad_bias(mask, n))
        else:
            scale = self.dim_head ** -0.5
            dots = torch.matmul((q * scale).float(),
                                k.float().transpose(-1, -2))
            allow = device_pattern_mask(self.pattern, n, x.device)[None, None]
            allow = _merge_key_pad_mask(self.pattern, allow, mask)
            dots = dots.masked_fill(~allow, max_neg_value(dots.dtype))
            attn = torch.softmax(dots, dim=-1).to(x.dtype)
            out = torch.matmul(attn, v)

        out = out.to(x.dtype).transpose(1, 2).reshape(
            b, n, self.heads * self.dim_head)
        out = linear_in(self.to_out, out, self.dtype)
        if drop and self.dropout > 0:
            out = F.dropout(out, self.dropout)
        if return_kv:
            return out, (k, v)
        return out

    @staticmethod
    def _cache_dots(q_scaled, k_sub):
        """q.k over a cache read: multiplicands rounded to the cache dtype,
        products and sums in f32 (bf16-in / f32-accumulate)."""
        return torch.matmul(q_scaled.to(k_sub.dtype).float(),
                            k_sub.float().transpose(-1, -2))

    @staticmethod
    def _attn_v(attn, v, out_dtype):
        """Decode attn (f32) x cached v: attn rounded to the cache dtype,
        f32 accumulation, result in the activation dtype."""
        return torch.matmul(attn.to(v.dtype).float(), v.float()).to(out_dtype)

    def decode_step(self, x, cache_k, cache_v, index: int, mask=None):
        """Single-token decode with KV cache.

        x: ``[b, 1, dim]``; cache_k/v: ``[b, heads, n_cache, dim_head]``;
        ``index`` is the absolute position of this token.  The caches are
        updated IN PLACE at ``index`` (one row write instead of a new cache
        per step) and returned: ``(out, cache_k, cache_v)``."""
        b = x.shape[0]
        q, k, v = self._qkv(x)  # [b, h, 1, dh]
        cache_k[:, :, index] = k[:, :, 0]
        cache_v[:, :, index] = v[:, :, 0]
        n_k = cache_k.shape[2]
        scale = self.dim_head ** -0.5
        table = (decode_table(self.pattern, n_k, x.device)
                 if self.sliced_kv_decode else None)
        if table is not None:
            # read only the reachable keys (text + row / column /
            # neighbourhood); softmax over the masked subset equals softmax
            # over the masked full row
            positions = table.positions[index]
            if table.starts is not None:
                T = table.text_len
                start = int(table.starts[index])
                m_img = positions.shape[0] - T

                def seg(cache):
                    return torch.cat([cache[:, :, :T],
                                      cache[:, :, start:start + m_img]], dim=2)
            else:
                def seg(cache):
                    return cache.index_select(2, positions)
            k_sub, v_sub = seg(cache_k), seg(cache_v)
            row = table.allow[index][None, None, None, :]
            if mask is not None:
                pad = _scope_key_pad(self.pattern, mask, n_k)
                row = row & pad.index_select(1, positions)[:, None, None, :]
        else:
            k_sub, v_sub = cache_k, cache_v
            row = device_pattern_mask(self.pattern, n_k, x.device)[index]
            row = _merge_key_pad_mask(self.pattern, row[None, None, None, :],
                                      mask)
        dots = self._cache_dots(q * scale, k_sub)
        dots = dots.masked_fill(~row, max_neg_value(dots.dtype))
        attn = torch.softmax(dots, dim=-1)  # f32
        out = self._attn_v(attn, v_sub, x.dtype)
        out = out.transpose(1, 2).reshape(b, 1, self.heads * self.dim_head)
        return linear_in(self.to_out, out, self.dtype), cache_k, cache_v
