"""DALLE: joint text + image autoregressive transformer.

PyTorch counterpart of ``dalle_pytorch_tpu/models/dalle.py``: the config
(every field, with a ``to_dict``/``from_dict`` that round-trips the JAX
package's checkpoint ``hparams``), the per-phase logits head, the axial
image position embedding, the forward with its phase-sliced training loss
(``forward(..., return_loss=True)``, ``embed_sequence``,
``loss_from_hidden``), and generation: ``prefill`` of the prompt, the
KV-cache ``decode_step``, top-k/top-p sampling and the prefill / tile /
decode composition.  Int8, speculative decode, MoE, the reversible
executor and sequence parallelism are not ported yet; a config asking for
them raises ``NotImplementedError`` when the model is built.

Every parameter is f32 whatever ``cfg.dtype`` is, as in the JAX tree; the
transformer casts its projections to ``dtype`` at use, as flax does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..ops.transformer import LN_EPS, Transformer
from ..utils.helpers import (max_neg_value, resolve_device, top_k_filter,
                             top_p_filter)


@dataclasses.dataclass(frozen=True)
class DALLEConfig:
    """Model hyperparameters plus the VAE-derived geometry; field names and
    defaults are the JAX package's, so checkpoints carry identical
    ``hparams``.  The execution-plan fields select how the same params are
    computed and are left out of ``to_dict``."""

    dim: int
    num_text_tokens: int = 10000       # as passed in, before per-position pads
    text_seq_len: int = 256
    depth: int = 8
    heads: int = 8
    dim_head: int = 64
    reversible: bool = False
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    sparse_attn: bool = False
    attn_types: Optional[Tuple[str, ...]] = None
    loss_img_weight: int = 7
    num_image_tokens: int = 512
    image_size: int = 256
    image_fmap_size: int = 32
    use_remat: bool = False
    use_pallas: bool = False   # flash attention kernel in the forward
    pallas_block_q: int = 128  # the TPU kernel's tiles; the CUDA kernel
    pallas_block_k: int = 128  # uses its own (ops/flash_attention.py)
    logits_bf16: bool = False  # head matmul on bf16 inputs, f32 accumulate
    onehot_embed: bool = False
    ff_experts: int = 0
    ff_expert_top_k: int = 2
    ff_aux_weight: float = 0.01
    ff_expert_dispatch: str = "dense"
    ff_expert_capacity_factor: float = 1.25
    ring_axis: Optional[str] = None
    sp_impl: str = "ring"
    sp_size: int = 1
    head_phase_sliced: bool = True
    sliced_kv_decode: bool = True  # decode reads only reachable keys
    kv_cache_bf16: bool = True     # bf16 cache storage at f32 activations
    kv_cache_int8: bool = False
    weights_int8: bool = False
    aligned_span_decode: bool = True
    spec_decode: bool = False
    spec_draft_depth: int = 2
    spec_k: int = 4
    spec_force_reject: bool = False
    dtype: Any = torch.float32

    _PLAN_FIELDS = ("ring_axis", "sp_impl", "sp_size",
                    "ff_expert_dispatch", "ff_expert_capacity_factor",
                    "head_phase_sliced", "sliced_kv_decode", "kv_cache_bf16",
                    "kv_cache_int8", "weights_int8", "aligned_span_decode",
                    "spec_decode", "spec_draft_depth", "spec_k",
                    "spec_force_reject")

    @property
    def image_seq_len(self) -> int:
        return self.image_fmap_size ** 2

    @property
    def total_text_tokens(self) -> int:
        """num_text_tokens + one unique pad id per text position."""
        return self.num_text_tokens + self.text_seq_len

    @property
    def seq_len(self) -> int:
        return self.text_seq_len + self.image_seq_len

    @property
    def total_tokens(self) -> int:
        return self.total_text_tokens + self.num_image_tokens

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("dtype")
        for f in self._PLAN_FIELDS:
            d.pop(f)
        if d.get("attn_types") is not None:
            d["attn_types"] = list(d["attn_types"])
        return d

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "DALLEConfig":
        d = {k: v for k, v in d.items() if k not in cls._PLAN_FIELDS}
        if d.get("attn_types") is not None:
            d["attn_types"] = tuple(d["attn_types"])
        d.update(overrides)
        return cls(**d)

    @classmethod
    def from_vae(cls, vae_cfg, **kwargs) -> "DALLEConfig":
        return cls(
            num_image_tokens=vae_cfg.num_tokens,
            image_size=vae_cfg.image_size,
            image_fmap_size=vae_cfg.image_size // (2 ** vae_cfg.num_layers),
            **kwargs,
        )


def _check_supported(cfg: DALLEConfig) -> None:
    unported = [name for name in ("kv_cache_int8", "weights_int8",
                                  "spec_decode", "ring_axis")
                if getattr(cfg, name)]
    if unported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unported)}")


class PhaseLogits(nn.Module):
    """The joint-vocab logits head, one f32 linear layer per vocab phase
    (text, image).  ``bf16_matmul`` rounds the inputs to bf16 and
    accumulates in f32."""

    def __init__(self, dim: int, total_text: int, total: int,
                 bf16_matmul: bool = False, device=None):
        super().__init__()
        self.text = nn.Linear(dim, total_text, device=device)
        self.image = nn.Linear(dim, total - total_text, device=device)
        self.bf16_matmul = bf16_matmul

    def _phase(self, layer: nn.Linear, x):
        if self.bf16_matmul:
            x = x.to(torch.bfloat16).float()
            w = layer.weight.to(torch.bfloat16).float()
            return torch.nn.functional.linear(x, w, layer.bias)
        return layer(x)

    def forward(self, x, image_only: bool = False, text_only: bool = False):
        """Joint-vocab logits, or one phase alone: ``image_only`` (every
        sampled position is an image position) or ``text_only``."""
        if text_only:
            return self._phase(self.text, x)
        image = self._phase(self.image, x)
        if image_only:
            return image
        return torch.cat([self._phase(self.text, x), image], dim=-1)


class AxialPositionalEmbedding(nn.Module):
    """Summed per-row + per-column embeddings over the image raster."""

    def __init__(self, dim: int, fmap: int, device=None):
        super().__init__()
        self.row = nn.Parameter(torch.randn(fmap, 1, dim, device=device))
        self.col = nn.Parameter(torch.randn(1, fmap, dim, device=device))

    def forward(self, n: int):
        fmap, dim = self.row.shape[0], self.row.shape[-1]
        return (self.row + self.col).reshape(fmap * fmap, dim)[:n]


class DALLE(nn.Module):
    """The model, built on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg: DALLEConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        attn_types = cfg.attn_types
        if attn_types is None:
            attn_types = ("sparse",) if cfg.sparse_attn else ("full",)
        self.text_emb = nn.Embedding(cfg.total_text_tokens, cfg.dim,
                                     device=device)
        self.image_emb = nn.Embedding(cfg.num_image_tokens, cfg.dim,
                                      device=device)
        self.text_pos_emb = nn.Embedding(cfg.text_seq_len + 1, cfg.dim,
                                         device=device)
        self.image_pos_emb = AxialPositionalEmbedding(
            cfg.dim, cfg.image_fmap_size, device=device)
        self.transformer = Transformer(
            dim=cfg.dim, depth=cfg.depth, seq_len=cfg.seq_len, causal=True,
            heads=cfg.heads, dim_head=cfg.dim_head,
            attn_dropout=cfg.attn_dropout, ff_dropout=cfg.ff_dropout,
            attn_types=tuple(attn_types), image_fmap_size=cfg.image_fmap_size,
            text_len=cfg.text_seq_len + 1, reversible=cfg.reversible,
            use_remat=cfg.use_remat, use_pallas=cfg.use_pallas,
            sliced_kv_decode=cfg.sliced_kv_decode, ff_experts=cfg.ff_experts,
            dtype=cfg.dtype, device=device)
        self.final_norm = nn.LayerNorm(cfg.dim, eps=LN_EPS, device=device)
        self.to_logits_dense = PhaseLogits(
            cfg.dim, cfg.total_text_tokens, cfg.total_tokens,
            bf16_matmul=cfg.logits_bf16, device=device)

    @property
    def device(self) -> torch.device:
        return self.text_emb.weight.device

    def _remap_pad_tokens(self, text):
        """Pad id 0 at text position t -> unique id num_text_tokens + t."""
        cfg = self.cfg
        text_range = torch.arange(cfg.text_seq_len, device=text.device) + (
            cfg.total_text_tokens - cfg.text_seq_len)
        return torch.where(text == 0, text_range, text)

    @staticmethod
    def _lookup(table: nn.Embedding, ids, onehot: bool):
        """Token lookup; with ``onehot`` a one-hot matmul, whose gradient is
        a matmul instead of a scatter-add.  An f32 product that selects one
        row exactly, as the gather does."""
        if onehot:
            oh = torch.nn.functional.one_hot(ids, table.num_embeddings)
            return torch.matmul(oh.to(table.weight.dtype), table.weight)
        return table(ids)

    def _embed_text(self, text, onehot: bool = False):
        """Unique-pad remap + <bos> + token and position embeddings."""
        cfg = self.cfg
        if text.shape[-1] != cfg.text_seq_len:
            raise ValueError(f"text length {text.shape[-1]} != text_seq_len "
                             f"{cfg.text_seq_len}")
        text = torch.nn.functional.pad(self._remap_pad_tokens(text), (1, 0))
        tokens = self._lookup(self.text_emb, text, onehot)
        tokens = tokens + self.text_pos_emb(
            torch.arange(text.shape[1], device=text.device))
        return tokens.to(cfg.dtype)

    def _embed_image_codes(self, codes, onehot: bool = False):
        emb = (self._lookup(self.image_emb, codes, onehot)
               + self.image_pos_emb(codes.shape[1]))
        return emb.to(self.cfg.dtype)

    @staticmethod
    def _pad_mask_for_bos(mask):
        """Text key-pad mask ``[b, text_seq_len]`` -> ``[b, text_seq_len+1]``:
        <bos> is always attendable."""
        if mask is None:
            return None
        return torch.nn.functional.pad(mask, (1, 0), value=True)

    def _head(self, out, image_only: bool = False, text_only: bool = False):
        """f32 final norm + logits head."""
        return self.to_logits_dense(self.final_norm(out.float()),
                                    image_only=image_only, text_only=text_only)

    def _logits_mask(self, n: int):
        """``[n, total_tokens]``, True where a logit must be suppressed: text
        positions predict text tokens only, image positions image tokens
        only."""
        cfg = self.cfg
        seq = torch.arange(n, device=self.device)[:, None]
        vocab = torch.arange(cfg.total_tokens, device=self.device)[None, :]
        return (((seq >= cfg.text_seq_len) & (vocab < cfg.total_text_tokens))
                | ((seq < cfg.text_seq_len)
                   & (vocab >= cfg.total_text_tokens)))

    def embed_sequence(self, text, image_codes=None, onehot: bool = False):
        """[bos+text | image] token embeddings, truncated to ``seq_len``: the
        input of the transformer stack."""
        cfg = self.cfg
        tokens = self._embed_text(text, onehot)
        if image_codes is not None and image_codes.shape[1] > 0:
            tokens = torch.cat(
                [tokens, self._embed_image_codes(image_codes, onehot)], dim=1)
        return tokens[:, :cfg.seq_len]

    @staticmethod
    def _phase_nll(phase_logits, labels):
        """Per-position negative log-likelihood within one vocab phase."""
        lse = torch.logsumexp(phase_logits, dim=-1)
        ll = torch.gather(phase_logits, -1, labels[..., None])[..., 0]
        return lse - ll

    def loss_from_hidden(self, out, text, image_codes):
        """Final norm + logits head + phase-sliced cross-entropy over the
        transformer output ``out [b, n, dim]``: text positions score the
        text vocab against the (pad-remapped) text, image positions the
        image vocab against the codes.  Loss = (text + w * image) / (w + 1)
        with w = ``loss_img_weight``."""
        cfg = self.cfg
        T = cfg.text_seq_len
        if cfg.head_phase_sliced:
            text_logits = self._head(out[:, :T], text_only=True)
            img_logits = self._head(out[:, T:], image_only=True)
        else:  # the full head, then the phase slices
            logits = self._head(out)
            v_text = cfg.total_text_tokens
            text_logits = logits[:, :T, :v_text]
            img_logits = logits[:, T:, v_text:]
        loss_text = self._phase_nll(text_logits,
                                    self._remap_pad_tokens(text)).mean()
        loss_img = self._phase_nll(img_logits, image_codes).mean()
        w = cfg.loss_img_weight
        return (loss_text + w * loss_img) / (w + 1)

    def forward(self, text, image_codes=None, mask=None,
                return_loss: bool = False):
        """The full forward.  Logits ``[b, n, total_tokens]`` with the
        wrong-phase half at the dtype's most negative value, or with
        ``return_loss`` the training loss (image codes required).  Dropout
        follows the module's training mode."""
        cfg = self.cfg
        # one-hot embeds only pay off through their backward
        onehot = cfg.onehot_embed and return_loss
        tokens = self.embed_sequence(text, image_codes, onehot)
        n = tokens.shape[1]
        out = self.transformer(tokens, mask=self._pad_mask_for_bos(mask))
        if not return_loss:
            logits = self._head(out)
            return logits.masked_fill(self._logits_mask(n)[None],
                                      max_neg_value(logits.dtype))
        if image_codes is None:
            raise ValueError("when training, image codes must be supplied")
        return self.loss_from_hidden(out, text, image_codes)

    @torch.inference_mode()
    def prefill(self, text, prime_codes=None, mask=None):
        """Forward over [bos+text (+ primed image codes)], padded to the
        full seq_len.  Returns (last-position image-phase logits
        ``[b, num_image_tokens]``, per-layer ``(k, v)`` caches)."""
        cfg = self.cfg
        tokens = self._embed_text(text)
        if prime_codes is not None and prime_codes.shape[1] > 0:
            tokens = torch.cat([tokens, self._embed_image_codes(prime_codes)],
                               dim=1)
        n_pre = tokens.shape[1]
        pad = cfg.seq_len - n_pre
        if pad < 0:
            raise ValueError("priming must leave at least one image token "
                             "to sample")
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, pad))
        out, kvs = self.transformer(tokens, mask=self._pad_mask_for_bos(mask),
                                    return_kv=True)
        cache_dtype = torch.bfloat16 if cfg.kv_cache_bf16 else cfg.dtype
        kvs = [(k.to(cache_dtype).contiguous(), v.to(cache_dtype).contiguous())
               for k, v in kvs]
        logits = self._head(out[:, n_pre - 1: n_pre], image_only=True)
        return logits[:, 0], kvs

    @torch.inference_mode()
    def decode_step(self, code, caches, index: int, mask=None):
        """One image code in at position ``index``, next-position
        image-phase logits ``[b, num_image_tokens]`` out.  The caches are
        updated in place and returned."""
        cfg = self.cfg
        img_index = index - (cfg.text_seq_len + 1)
        pos = self.image_pos_emb(cfg.image_seq_len)[img_index]
        x = (self.image_emb(code[:, None]) + pos).to(cfg.dtype)
        out, caches = self.transformer.decode_step(
            x, caches, index, mask=self._pad_mask_for_bos(mask))
        return self._head(out, image_only=True)[:, 0], caches


def sample_image_code(logits, generator: Optional[torch.Generator] = None, *,
                      k_vocab: int, filter_thres: float = 0.5,
                      temperature: float = 1.0, top_p: Optional[float] = None,
                      gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample image codes from image-phase logits ``[..., num_image_tokens]``.

    Temperature scales before the filters; top-k takes k from the joint
    vocab ``k_vocab``; the optional nucleus follows.  The draw is the
    Gumbel-max rule over the filtered logits (the rule
    ``jax.random.categorical`` uses), with the noise drawn from
    ``generator`` (on the logits' device) unless ``gumbel`` hands it in."""
    filtered = top_k_filter(logits / temperature, thres=filter_thres,
                            k_vocab=k_vocab)
    if top_p is not None:
        filtered = top_p_filter(filtered, top_p)
    if gumbel is None:
        u = torch.rand(filtered.shape, generator=generator,
                       device=filtered.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return torch.argmax(filtered + gumbel, dim=-1)


def prefill_codes(dalle: DALLE, text, *, prime_codes=None, mask=None):
    """The prompt half of the sampler: ``(first_logits, caches)``."""
    return dalle.prefill(text, prime_codes, mask)


def broadcast_prefill(first_logits, caches, reps: int):
    """Tile a prefill state across ``reps`` batch rows."""
    if reps == 1:
        return first_logits, caches
    return (first_logits.repeat_interleave(reps, dim=0),
            [(k.repeat_interleave(reps, dim=0),
              v.repeat_interleave(reps, dim=0)) for k, v in caches])


def tile_prefill(first_logits, caches, reps: int):
    """Broadcast a batch-1 prefill state across ``reps`` candidates: every
    candidate of one prompt shares the prompt's k/v exactly."""
    if first_logits.shape[0] != 1:
        raise ValueError(
            "tile_prefill broadcasts a single-prompt (batch-1) prefill; got "
            f"first_logits of shape {tuple(first_logits.shape)}")
    return broadcast_prefill(first_logits, caches, reps)


@torch.inference_mode()
def decode_codes(dalle: DALLE, first_logits, caches,
                 generator: Optional[torch.Generator] = None, *,
                 n_prime: int = 0, prime_codes=None,
                 filter_thres: float = 0.5, temperature: float = 1.0,
                 top_p: Optional[float] = None, mask=None) -> torch.Tensor:
    """The sampling half: KV-cache decode from a prefill state, one step
    per remaining image position.  The input caches are copied first, so
    one prefill state can seed several decodes."""
    cfg = dalle.cfg
    n_pre = cfg.text_seq_len + 1 + n_prime
    caches = [(k.clone(), v.clone()) for k, v in caches]

    def sample(logits):
        return sample_image_code(logits, generator, k_vocab=cfg.total_tokens,
                                 filter_thres=filter_thres,
                                 temperature=temperature, top_p=top_p)

    code = sample(first_logits)
    codes = [code]
    for index in range(n_pre, cfg.seq_len):
        logits, caches = dalle.decode_step(code, caches, index, mask)
        code = sample(logits)
        codes.append(code)
    out = torch.stack(codes, dim=1)
    if prime_codes is not None and n_prime > 0:
        out = torch.cat([prime_codes.to(out.dtype), out], dim=1)
    return out


def generate_codes(dalle: DALLE, text,
                   generator: Optional[torch.Generator] = None, *,
                   prime_codes=None, filter_thres: float = 0.5,
                   temperature: float = 1.0, top_p: Optional[float] = None,
                   mask=None) -> torch.Tensor:
    """Sample a full image token sequence ``[b, image_seq_len]``:
    ``prefill_codes`` once, then ``decode_codes``."""
    n_prime = 0 if prime_codes is None else prime_codes.shape[1]
    first_logits, caches = prefill_codes(dalle, text, prime_codes=prime_codes,
                                         mask=mask)
    return decode_codes(dalle, first_logits, caches, generator,
                        n_prime=n_prime, prime_codes=prime_codes,
                        filter_thres=filter_thres, temperature=temperature,
                        top_p=top_p, mask=mask)
