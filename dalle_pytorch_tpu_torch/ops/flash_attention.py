"""Block-sparse flash attention for any ``AttnPattern``, forward and backward.

PyTorch side of the CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, which replace the three TPU kernels of
``dalle_pytorch_tpu/ops/attention_pallas.py``: ``_fwd_kernel`` (flash_fwd),
``_bwd_dq_kernel`` (flash_bwd_dq) and ``_bwd_dkv_kernel`` (flash_bwd_dkv).
The host side mirrors the custom VJP there (``_flash_attention``,
``_flash_fwd``, ``_flash_bwd``) as one ``torch.autograd.Function``: the
forward saves q, k, v, o and lse (never the ``[n, n]`` scores), the
backward computes delta = rowsum(do * o) in f32 and runs dq and dk/dv.
The key-pad bias gets no gradient.

For CUDA tensors the function launches the kernels, or raises when it
cannot; for CPU tensors it runs the plain versions,
``flash_pattern_attention_plain`` and ``flash_pattern_attention_bwd_plain``:
the same functions in dense f32 torch math with the kernels' edge
semantics.  A row with no attendable key gives o = 0, lse = +inf and no
gradient (the JAX dense path instead spreads such a row uniformly,
``ops/attention.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from . import _build
from .attention import AttnPattern, dense_pattern_mask, device_pattern_mask

NEG_INF = -1e30   # finite mask value, as in the kernels
HEAD_DIM = 64     # the kernels' head dim
BLOCK_Q = 64      # query rows per tile
BLOCK_K = 32      # keys per tile
KERNEL = "flash_fwd"
KERNEL_DQ = "flash_bwd_dq"
KERNEL_DKV = "flash_bwd_dkv"

# launches of each kernel of this module, added to where the kernel is
# launched and nowhere else; a run sets them to 0 and reads them back
LAUNCHES: Dict[str, int] = {KERNEL: 0, KERNEL_DQ: 0, KERNEL_DKV: 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pattern_blocks(pattern: AttnPattern, n: int):
    """Host mask + tile summary for a pattern at length n.

    Returns (mask ``[n, n]`` bool, bsum ``[ceil(n/BLOCK_Q),
    ceil(n/BLOCK_K)]`` int32) with ``bsum[qb, kb] = 1`` iff some pair of
    the (q tile, k tile) may attend.  No padding: the last tiles are
    ragged and the kernels mask them."""
    mask = dense_pattern_mask(pattern, n, n)
    nq, nk = -(-n // BLOCK_Q), -(-n // BLOCK_K)
    padded = np.zeros((nq * BLOCK_Q, nk * BLOCK_K), dtype=bool)
    padded[:n, :n] = mask
    bsum = padded.reshape(nq, BLOCK_Q, nk, BLOCK_K).any(axis=(1, 3))
    return mask, bsum.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_blocks(pattern: AttnPattern, n: int, device: torch.device):
    """The kernels' mask (uint8) and bsum on ``device``, built once per
    (pattern, n, device)."""
    mask, bsum = _pattern_blocks(pattern, n)
    return (torch.as_tensor(mask.astype(np.uint8), device=device),
            torch.as_tensor(bsum, device=device))


def _c_fn(source: str, name: str, n_ptrs: int):
    """A kernel's C entry point: dtype, ``n_ptrs`` pointers, 8 ints, the
    scale and the stream; returns a CUDA error code."""
    fn = getattr(_build.load(source), name)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """flash_fwd, built and loaded on first use."""
    return _c_fn("flash_fwd", KERNEL, 8)


@functools.lru_cache(maxsize=None)
def _bwd_kernel_fns():
    """(flash_bwd_dq, flash_bwd_dkv), built and loaded on first use."""
    return (_c_fn("flash_bwd", KERNEL_DQ, 10),
            _c_fn("flash_bwd", KERNEL_DKV, 11))


def _masked_scores(q, k, pattern, key_pad_bias):
    """f32 scores ``[b, h, n, n]``: scaled q.k plus the key bias, NEG_INF
    where the pattern forbids the pair."""
    n = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_pad_bias is not None:
        s = s + key_pad_bias.float()[:, None, None, :]
    return torch.where(device_pattern_mask(pattern, n, q.device), s, NEG_INF)


def flash_pattern_attention_plain(q, k, v, pattern: AttnPattern,
                                  key_pad_bias: Optional[torch.Tensor] = None,
                                  *, return_lse: bool = False):
    """The forward kernel's function in plain torch, on any device.

    q/k/v: ``[b, heads, n, dim_head]``; ``key_pad_bias`` an optional
    additive f32 ``[b, n]`` (0 keep / -1e30 drop).  Scores, softmax and
    p.v run in f32; o returns in q's dtype, lse ``[b, heads, n]`` in f32."""
    s = _masked_scores(q, k, pattern, key_pad_bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (torch.matmul(p, v.float()) / l_safe).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, float("inf"), m + torch.log(l_safe))
    return o, lse[..., 0]


def flash_pattern_attention_bwd_plain(q, k, v, o, lse, do,
                                      pattern: AttnPattern,
                                      key_pad_bias: Optional[torch.Tensor] = None):
    """The two backward kernels' function in plain torch, on any device.

    From the forward's inputs, its o (in q's dtype) and lse ``[b, h, n]``
    f32, and the output gradient ``do``: p = exp(s - lse) on the masked
    scores (0 on a row with lse = +inf), delta = rowsum(do * o),
    dp = do.v^T, ds = p * (dp - delta), dq = ds.k * scale,
    dk = ds^T.q * scale, dv = p^T.do.  Dense f32 math; the grads return in
    q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = _masked_scores(q, k, pattern, key_pad_bias)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_inputs(q, k, v, key_pad_bias):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels run on CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [b, heads, n, dim_head], got {tuple(q.shape)}")
    b, h, n, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"flash attention kernels take dim_head {HEAD_DIM}, "
                         f"got {dh}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if key_pad_bias is not None:
        if (key_pad_bias.shape != (b, n) or key_pad_bias.dtype != torch.float32
                or key_pad_bias.device != q.device
                or not key_pad_bias.is_contiguous()):
            raise ValueError("key_pad_bias must be a contiguous float32 "
                             f"[{b}, {n}] tensor on {q.device}")


def _geometry(q, pattern):
    """(mask, bsum, the kernels' 8 int arguments, scale)."""
    b, h, n, dh = q.shape
    mask, bsum = _device_blocks(pattern, n, q.device)
    ints = (b * h, n, h, dh, BLOCK_Q, BLOCK_K, bsum.shape[0], bsum.shape[1])
    return mask, bsum, ints, dh ** -0.5


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _launch(q, k, v, pattern, key_pad_bias):
    b, h, n, _ = q.shape
    mask, bsum, ints, scale = _geometry(q, pattern)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    bias_ptr = key_pad_bias.data_ptr() if key_pad_bias is not None else None
    _raise_on(_kernel_fn()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), bsum.data_ptr(), bias_ptr, o.data_ptr(),
        lse.data_ptr(), *ints, scale,
        torch.cuda.current_stream(q.device).cuda_stream), KERNEL)
    LAUNCHES[KERNEL] += 1
    return o, lse


def _bwd_args(q, k, v, lse, delta, do, pattern, key_pad_bias):
    """The arguments both backward kernels share, checked."""
    _check_inputs(q, k, v, key_pad_bias)
    if do.dtype != q.dtype or do.shape != q.shape or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor of q's shape and "
                         "dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor")
    mask, bsum, ints, scale = _geometry(q, pattern)
    bias_ptr = key_pad_bias.data_ptr() if key_pad_bias is not None else None
    ptrs = (_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), bsum.data_ptr(), bias_ptr, do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    return ptrs, ints, scale, torch.cuda.current_stream(q.device).cuda_stream


def launch_bwd_dq(q, k, v, lse, delta, do, pattern, key_pad_bias=None):
    """dq from the flash_bwd_dq kernel (CUDA tensors, checked as for the
    forward; delta = rowsum(do * o) ``[b, h, n]`` f32)."""
    ptrs, ints, scale, stream = _bwd_args(q, k, v, lse, delta, do, pattern,
                                          key_pad_bias)
    dq = torch.empty_like(q)
    _raise_on(_bwd_kernel_fns()[0](*ptrs, dq.data_ptr(), *ints, scale,
                                   stream), KERNEL_DQ)
    LAUNCHES[KERNEL_DQ] += 1
    return dq


def launch_bwd_dkv(q, k, v, lse, delta, do, pattern, key_pad_bias=None):
    """(dk, dv) from the flash_bwd_dkv kernel; arguments as
    ``launch_bwd_dq``."""
    ptrs, ints, scale, stream = _bwd_args(q, k, v, lse, delta, do, pattern,
                                          key_pad_bias)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _raise_on(_bwd_kernel_fns()[1](*ptrs, dk.data_ptr(), dv.data_ptr(),
                                   *ints, scale, stream), KERNEL_DKV)
    LAUNCHES[KERNEL_DKV] += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, pattern, key_pad_bias):
    """dq, dk, dv from the two backward kernels; delta = rowsum(do * o) is
    one f32 torch op here, as ``_flash_bwd`` computes it outside its
    kernels."""
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = launch_bwd_dq(q, k, v, lse, delta, do, pattern, key_pad_bias)
    dk, dv = launch_bwd_dkv(q, k, v, lse, delta, do, pattern, key_pad_bias)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of ``_flash_attention``: kernels for CUDA tensors,
    plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_pad_bias, pattern):
        if q.device.type == "cpu":
            o, lse = flash_pattern_attention_plain(q, k, v, pattern,
                                                   key_pad_bias,
                                                   return_lse=True)
        else:
            _check_inputs(q, k, v, key_pad_bias)
            o, lse = _launch(q, k, v, pattern, key_pad_bias)
        ctx.pattern = pattern
        ctx.save_for_backward(q, k, v, o, lse, key_pad_bias)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, key_pad_bias = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            grads = flash_pattern_attention_bwd_plain(q, k, v, o, lse, do,
                                                      ctx.pattern,
                                                      key_pad_bias)
        else:
            grads = _launch_bwd(q, k, v, o, lse, do, ctx.pattern,
                                key_pad_bias)
        return (*grads, None, None)  # the pad bias is not trainable


def flash_pattern_attention(q, k, v, pattern: AttnPattern,
                            key_pad_bias: Optional[torch.Tensor] = None,
                            *, return_lse: bool = False):
    """Block-sparse flash attention for any ``AttnPattern``, differentiable
    in q, k and v.

    q/k/v: ``[b, heads, n, dim_head]``; ``key_pad_bias`` an optional
    additive f32 ``[b, n]`` key bias (0 keep / -1e30 drop).  Returns o
    ``[b, heads, n, dim_head]`` in q's dtype, and with ``return_lse`` also
    lse ``[b, heads, n]`` f32.

    CUDA tensors go to the kernels (dim_head 64, float32 or bfloat16,
    contiguous) or the call raises; CPU tensors go to the plain versions."""
    o, lse = _FlashAttention.apply(q, k, v, key_pad_bias, pattern)
    return (o, lse) if return_lse else o
