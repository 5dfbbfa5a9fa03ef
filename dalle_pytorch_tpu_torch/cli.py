"""Chunked generation: token ids -> image codes -> pixels.

PyTorch counterpart of the generation half of ``dalle_pytorch_tpu/cli.py``
(``make_decode_fn``, ``iter_generated_chunks``, ``generate_chunked``).
The tokenizers and the checkpoint reader are not ported yet, so callers
hand in token ids and models whose weights they loaded themselves
(``weights.py``).  Everything runs on the models' device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .models.dalle import DALLE, decode_codes, generate_codes, prefill_codes, tile_prefill
from .models.vae import DiscreteVAE


def make_decode_fn(vae: DiscreteVAE) -> Callable[[torch.Tensor], torch.Tensor]:
    """codes ``[b, image_seq_len]`` -> ``[b, h, w, 3]`` float images."""

    def decode(codes):
        return vae.decode(codes.to(vae.device))

    return decode


def iter_generated_chunks(dalle: DALLE, text_tokens: np.ndarray, *,
                          batch_size: int, top_k: float,
                          generator: Optional[torch.Generator] = None,
                          temperature: float = 1.0,
                          top_p: Optional[float] = None):
    """Sample image codes for ``[n, text_seq_len]`` tokens in
    ``batch_size`` chunks; yields ``(codes [batch_size, image_seq_len],
    n_valid)`` with the codes on the model's device.

    Shared prompt prefill: when every row is the same prompt, the prompt
    is prefilled ONCE at batch 1 and its caches tiled across the chunk
    (exact: the prompt's k/v never depend on the sampled continuation), so
    each chunk pays only the decode loop.  Distinct prompts take one
    ``generate_codes`` per chunk, the last chunk padded to the batch
    size."""
    n = text_tokens.shape[0]
    if n == 0:
        return iter(())
    batch_size = min(batch_size, n)
    n_chunks = -(-n // batch_size)
    device = dalle.device
    shared = bool(np.all(np.asarray(text_tokens) == text_tokens[:1]))
    kw = dict(filter_thres=top_k, temperature=temperature, top_p=top_p)

    if shared:
        def gen_shared():
            first1, caches1 = prefill_codes(
                dalle, torch.as_tensor(text_tokens[:1], device=device))
            first, caches = tile_prefill(first1, caches1, batch_size)
            for i in range(n_chunks):
                codes = decode_codes(dalle, first, caches, generator, **kw)
                yield codes, min(batch_size, n - i * batch_size)

        return gen_shared()

    def gen_distinct():
        for i in range(n_chunks):
            chunk = text_tokens[i * batch_size: (i + 1) * batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            codes = generate_codes(dalle, torch.as_tensor(chunk, device=device),
                                   generator, **kw)
            yield codes, batch_size - pad

    return gen_distinct()


def generate_chunked(dalle: DALLE, decode, text_tokens: np.ndarray, *,
                     batch_size: int, top_k: float,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0, top_p: Optional[float] = None,
                     desc: str = "generating") -> torch.Tensor:
    """Generate images for ``[n, text_seq_len]`` tokens in ``batch_size``
    chunks (``iter_generated_chunks`` semantics).  Returns images
    ``[n, h, w, 3]`` on the host.  ``generator`` must live on the model's
    device."""
    outs = []
    n = text_tokens.shape[0]
    done = 0
    for codes, n_valid in iter_generated_chunks(
            dalle, text_tokens, batch_size=batch_size, top_k=top_k,
            generator=generator, temperature=temperature, top_p=top_p):
        outs.append(decode(codes)[:n_valid].cpu())
        done += n_valid
        print(f"{desc}: {done}/{n}", flush=True)
    return torch.cat(outs) if outs else torch.zeros((0,))
