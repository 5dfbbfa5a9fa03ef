"""DiscreteVAE: pixels -> image codes (encoder) and codes -> pixels.

PyTorch counterpart of ``dalle_pytorch_tpu/models/vae.py`` (``VAEConfig``,
``ResBlock``, ``Encoder``, ``Decoder``, the codebook, ``norm``,
``encode_logits``, ``get_codebook_indices`` and ``decode``).  The
gumbel-softmax, the VAE loss and its train step wait for the next slice.
The public functions keep the JAX package's NHWC layout; inside, the convs
run NCHW as torch's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Hyperparameters; field names and defaults are the JAX package's."""

    image_size: int = 256
    num_tokens: int = 512
    codebook_dim: int = 512
    num_layers: int = 3
    num_resnet_blocks: int = 0
    hidden_dim: int = 64
    channels: int = 3
    smooth_l1_loss: bool = False
    temperature: float = 0.9
    straight_through: bool = False
    kl_div_loss_weight: float = 0.0
    normalization: Optional[Tuple[Sequence[float], Sequence[float]]] = (
        (0.5, 0.5, 0.5),
        (0.5, 0.5, 0.5),
    )
    dtype: Any = torch.float32

    def __post_init__(self):
        if not math.log2(self.image_size).is_integer():
            raise ValueError("image size must be a power of 2")
        if self.num_layers < 1:
            raise ValueError("number of layers must be >= 1")

    @property
    def fmap_size(self) -> int:
        return self.image_size // (2 ** self.num_layers)

    @property
    def image_seq_len(self) -> int:
        return self.fmap_size ** 2

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("dtype")
        return d

    @classmethod
    def from_dict(cls, d: dict, **overrides) -> "VAEConfig":
        d = dict(d)
        if d.get("normalization") is not None:
            means, stds = d["normalization"]
            d["normalization"] = (tuple(means), tuple(stds))
        d.update(overrides)
        return cls(**d)


class ResBlock(nn.Module):
    """conv3-relu-conv3-relu-conv1 residual block."""

    def __init__(self, chan: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = nn.Conv2d(chan, chan, 3, padding=1, **kw)
        self.conv1 = nn.Conv2d(chan, chan, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(chan, chan, 1, **kw)

    def forward(self, x):
        h = F.relu(self.conv0(x))
        h = F.relu(self.conv1(h))
        return self.conv2(h) + x


class Encoder(nn.Module):
    """num_layers x (4x4 stride-2 conv + relu) + resblocks + 1x1 conv to
    codebook logits, the head in f32 for a stable softmax whatever the
    trunk's dtype."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        chan = cfg.channels
        downs = []
        for _ in range(cfg.num_layers):
            downs.append(nn.Conv2d(chan, cfg.hidden_dim, 4, stride=2,
                                   padding=1, **kw))
            chan = cfg.hidden_dim
        self.downs = nn.ModuleList(downs)
        self.resblocks = nn.ModuleList(ResBlock(chan, **kw)
                                       for _ in range(cfg.num_resnet_blocks))
        self.to_logits = nn.Conv2d(chan, cfg.num_tokens, 1, device=device)

    def forward(self, x):
        """x: ``[b, channels, H, W]`` in ``cfg.dtype`` -> logits
        ``[b, num_tokens, h, w]`` f32."""
        for down in self.downs:
            x = F.relu(down(x))
        for block in self.resblocks:
            x = block(x)
        return self.to_logits(x.float())


class Decoder(nn.Module):
    """[1x1 conv + resblocks] + num_layers x (4x4 stride-2 transposed conv
    + relu) + 1x1 conv to pixels (f32)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.dtype = cfg.dtype
        chan = cfg.codebook_dim
        self.stem = None
        self.resblocks = nn.ModuleList()
        if cfg.num_resnet_blocks > 0:
            self.stem = nn.Conv2d(chan, cfg.hidden_dim, 1, **kw)
            self.resblocks.extend(ResBlock(cfg.hidden_dim, **kw)
                                  for _ in range(cfg.num_resnet_blocks))
            chan = cfg.hidden_dim
        ups = []
        for _ in range(cfg.num_layers):
            # flax's ConvTranspose(k=4, s=2, "SAME") is this layer with the
            # kernel flipped in space (weights.py does the flip)
            ups.append(nn.ConvTranspose2d(chan, cfg.hidden_dim, 4, stride=2,
                                          padding=1, **kw))
            chan = cfg.hidden_dim
        self.ups = nn.ModuleList(ups)
        self.to_pixels = nn.Conv2d(chan, cfg.channels, 1, device=device)

    def forward(self, x):
        """x: ``[b, c, h, w]`` in ``cfg.dtype`` -> ``[b, channels, H, W]``
        f32."""
        if self.stem is not None:
            x = self.stem(x)
            for block in self.resblocks:
                x = block(x)
        for up in self.ups:
            x = F.relu(up(x))
        return self.to_pixels(x.float())


class DiscreteVAE(nn.Module):
    """Codebook, encoder and decoder, built on ``device`` (CUDA unless
    ``device="cpu"``).  Images are NHWC floats in [0, 1]."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim,
                                     device=device)
        self.encoder = Encoder(cfg, device=device)
        self.decoder = Decoder(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.codebook.weight.device

    def norm(self, images):
        """Per-channel input normalization, ``(images - mean) / std``."""
        if self.cfg.normalization is None:
            return images
        means, stds = (torch.as_tensor(t, dtype=images.dtype,
                                       device=images.device)
                       for t in self.cfg.normalization)
        return (images - means) / stds

    def encode_logits(self, img):
        """Encoder logits ``[b, h, w, num_tokens]`` f32 of images
        ``[b, H, W, channels]``."""
        x = self.norm(img).to(self.cfg.dtype).permute(0, 3, 1, 2)
        return self.encoder(x).permute(0, 2, 3, 1)

    def get_codebook_indices(self, img):
        """Hard token ids ``[b, image_seq_len]``: the encoder's argmax,
        flattened row-major."""
        logits = self.encode_logits(img)
        b, h, w, _ = logits.shape
        return logits.argmax(dim=-1).reshape(b, h * w)

    @torch.inference_mode()
    def decode(self, img_seq):
        """Token ids ``[b, n]`` -> images ``[b, H, W, channels]`` f32."""
        b, n = img_seq.shape
        h = w = math.isqrt(n)
        embeds = self.codebook(img_seq).reshape(b, h, w, self.cfg.codebook_dim)
        x = embeds.permute(0, 3, 1, 2).to(self.cfg.dtype)
        return self.decoder(x).permute(0, 2, 3, 1)
