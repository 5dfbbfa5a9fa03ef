"""Block-sparse flash attention forward for any ``AttnPattern``.

PyTorch side of the CUDA kernel ``csrc/flash_fwd.cu``, which replaces the
TPU kernel ``_fwd_kernel`` of ``dalle_pytorch_tpu/ops/attention_pallas.py``
(host side: ``_pattern_blocks``, ``_prepare``, ``_flash_fwd`` and
``flash_pattern_attention`` there).  Forward only: the two backward kernels
arrive with the training slice, and until then a CUDA input that requires
grad raises.

``flash_pattern_attention`` launches the kernel for a CUDA tensor and
raises when it cannot; for a CPU tensor it runs
``flash_pattern_attention_plain``, the same function in dense f32 torch
math with the kernel's edge semantics: a row with no attendable key gives
o = 0 and lse = +inf (the JAX dense path instead spreads such a row
uniformly, ``ops/attention.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from . import _build
from .attention import AttnPattern, dense_pattern_mask, device_pattern_mask

NEG_INF = -1e30   # finite mask value, as in the kernel
HEAD_DIM = 64     # the kernel's head dim
BLOCK_Q = 64      # query rows per thread block
BLOCK_K = 32      # keys per k tile
KERNEL = "flash_fwd"

# launches of each kernel of this module, added to where the kernel is
# launched and nowhere else; a run sets them to 0 and reads them back
LAUNCHES: Dict[str, int] = {KERNEL: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pattern_blocks(pattern: AttnPattern, n: int):
    """Host mask + tile summary for a pattern at length n.

    Returns (mask ``[n, n]`` bool, bsum ``[ceil(n/BLOCK_Q),
    ceil(n/BLOCK_K)]`` int32) with ``bsum[qb, kb] = 1`` iff some pair of
    the (q tile, k tile) may attend.  No padding: the last tiles are
    ragged and the kernel masks them."""
    mask = dense_pattern_mask(pattern, n, n)
    nq, nk = -(-n // BLOCK_Q), -(-n // BLOCK_K)
    padded = np.zeros((nq * BLOCK_Q, nk * BLOCK_K), dtype=bool)
    padded[:n, :n] = mask
    bsum = padded.reshape(nq, BLOCK_Q, nk, BLOCK_K).any(axis=(1, 3))
    return mask, bsum.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_blocks(pattern: AttnPattern, n: int, device: torch.device):
    """The kernel's mask (uint8) and bsum on ``device``, built once per
    (pattern, n, device)."""
    mask, bsum = _pattern_blocks(pattern, n)
    return (torch.as_tensor(mask.astype(np.uint8), device=device),
            torch.as_tensor(bsum, device=device))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The kernel's C entry point, built and loaded on first use."""
    fn = _build.load(KERNEL).flash_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_pattern_attention_plain(q, k, v, pattern: AttnPattern,
                                  key_pad_bias: Optional[torch.Tensor] = None,
                                  *, return_lse: bool = False):
    """The kernel's function in plain torch, on any device.

    q/k/v: ``[b, heads, n, dim_head]``; ``key_pad_bias`` an optional
    additive f32 ``[b, n]`` (0 keep / -1e30 drop).  Scores, softmax and
    p.v run in f32; o returns in q's dtype, lse ``[b, heads, n]`` in f32."""
    b, h, n, dh = q.shape
    scale = dh ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_pad_bias is not None:
        s = s + key_pad_bias.float()[:, None, None, :]
    s = torch.where(device_pattern_mask(pattern, n, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (torch.matmul(p, v.float()) / l_safe).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, float("inf"), m + torch.log(l_safe))
    return o, lse[..., 0]


def _check_inputs(q, k, v, key_pad_bias):
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [b, heads, n, dim_head], got {tuple(q.shape)}")
    b, h, n, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"flash_fwd takes dim_head {HEAD_DIM}, got {dh}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.requires_grad:
            raise NotImplementedError(
                "flash_fwd has no backward kernel yet; call it on tensors "
                "that do not require grad")
    if key_pad_bias is not None:
        if (key_pad_bias.shape != (b, n) or key_pad_bias.dtype != torch.float32
                or key_pad_bias.device != q.device
                or not key_pad_bias.is_contiguous()):
            raise ValueError("key_pad_bias must be a contiguous float32 "
                             f"[{b}, {n}] tensor on {q.device}")


def _launch(q, k, v, pattern, key_pad_bias):
    b, h, n, dh = q.shape
    mask, bsum = _device_blocks(pattern, n, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    bias_ptr = key_pad_bias.data_ptr() if key_pad_bias is not None else None
    rc = _kernel_fn()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), bsum.data_ptr(), bias_ptr, o.data_ptr(),
        lse.data_ptr(), b * h, n, h, dh, BLOCK_Q, BLOCK_K,
        bsum.shape[0], bsum.shape[1], dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    LAUNCHES[KERNEL] += 1
    return o, lse


def flash_pattern_attention(q, k, v, pattern: AttnPattern,
                            key_pad_bias: Optional[torch.Tensor] = None,
                            *, return_lse: bool = False):
    """Block-sparse flash attention for any ``AttnPattern``.

    q/k/v: ``[b, heads, n, dim_head]``; ``key_pad_bias`` an optional
    additive f32 ``[b, n]`` key bias (0 keep / -1e30 drop).  Returns o
    ``[b, heads, n, dim_head]`` in q's dtype, and with ``return_lse`` also
    lse ``[b, heads, n]`` f32.

    A CUDA tensor goes to the kernel (dim_head 64, float32 or bfloat16,
    contiguous, no grad) or the call raises; a CPU tensor goes to
    ``flash_pattern_attention_plain``."""
    if q.device.type == "cpu":
        return flash_pattern_attention_plain(q, k, v, pattern, key_pad_bias,
                                             return_lse=return_lse)
    _check_inputs(q, k, v, key_pad_bias)
    with torch.inference_mode():
        o, lse = _launch(q, k, v, pattern, key_pad_bias)
    return (o, lse) if return_lse else o
