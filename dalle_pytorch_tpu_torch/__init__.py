"""dalle_pytorch_tpu_torch: the PyTorch / CUDA port of dalle_pytorch_tpu.

This slice runs generation: text token ids -> DALLE prefill (with the
hand-written CUDA block-sparse flash-attention forward) -> KV-cache decode
and sampling -> dVAE decode to pixels.  It imports torch and numpy, never
JAX or the JAX package.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

from .models.dalle import DALLE, DALLEConfig
from .models.vae import DiscreteVAE, VAEConfig

__all__ = ["DALLE", "DALLEConfig", "DiscreteVAE", "VAEConfig"]
