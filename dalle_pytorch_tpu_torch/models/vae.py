"""DiscreteVAE decode: image codes -> pixels.

PyTorch counterpart of ``dalle_pytorch_tpu/models/vae.py`` (``VAEConfig``,
``ResBlock``, ``Decoder``, the codebook and ``DiscreteVAE.decode``).  The
encoder and the training loss wait for the training slice.  ``decode``
keeps the JAX package's NHWC layout at its boundary; inside, the convs run
NCHW as torch's do.
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
    """Codebook + decoder, built on ``device`` (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.codebook = nn.Embedding(cfg.num_tokens, cfg.codebook_dim,
                                     device=device)
        self.decoder = Decoder(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.codebook.weight.device

    @torch.inference_mode()
    def decode(self, img_seq):
        """Token ids ``[b, n]`` -> images ``[b, H, W, channels]`` f32."""
        b, n = img_seq.shape
        h = w = math.isqrt(n)
        embeds = self.codebook(img_seq).reshape(b, h, w, self.cfg.codebook_dim)
        x = embeds.permute(0, 3, 1, 2).to(self.cfg.dtype)
        return self.decoder(x).permute(0, 2, 3, 1)
