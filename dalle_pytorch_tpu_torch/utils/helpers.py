"""Small shared helpers: option defaults, the device rule, and the
sampling filters.

PyTorch counterpart of ``dalle_pytorch_tpu/utils/helpers.py`` (its
``exists``/``default``/``cast_tuple``, ``max_neg_value``, ``top_k_filter``
and ``top_p_filter``), kept as a copy because this package never imports
the JAX one.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def exists(val):
    return val is not None


def default(val, d):
    if val is not None:
        return val
    return d() if callable(d) else d


def cast_tuple(val, depth: int = 1):
    if isinstance(val, list):
        val = tuple(val)
    return val if isinstance(val, tuple) else (val,) * depth


def linear_in(layer: torch.nn.Linear, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """A flax ``Dense(dtype=dtype)`` call: the layer's f32 weight and bias
    are cast to ``dtype`` at use (flax's ``promote_dtype``) and the
    product runs in ``dtype``.  The parameters themselves stay f32."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return torch.nn.functional.linear(x.to(dtype), layer.weight.to(dtype),
                                      bias)


def max_neg_value(dtype: torch.dtype) -> float:
    """Most-negative finite value for a dtype (the dense path's mask fill)."""
    return -torch.finfo(dtype).max


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another one.  Raises when CUDA is wanted and absent, so a run never
    carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def top_k_filter(logits: torch.Tensor, thres: float = 0.5,
                 k_vocab: Optional[int] = None) -> torch.Tensor:
    """Keep the top ``max(int((1-thres)*V), 1)`` logits, set the rest to
    -inf.  ``k_vocab`` overrides the vocab size V that k derives from: the
    decode path filters image-vocab-only logits with k taken from the full
    joint vocab, which selects the same candidates as filtering joint
    logits whose text half is -inf."""
    num_logits = k_vocab if k_vocab is not None else logits.shape[-1]
    k = max(int((1 - thres) * num_logits), 1)
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose softmax
    mass reaches ``p``, set the rest to -inf.  The most likely token always
    survives."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i survives if the mass BEFORE it is < p, so the token that
    # crosses p is still kept
    keep = (cum - probs) < p
    cutoff = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, float("-inf"))
