"""dalle_pytorch_tpu_torch: the PyTorch / CUDA port of dalle_pytorch_tpu.

Two slices run so far.  Generation: text token ids -> DALLE prefill (with
the hand-written CUDA block-sparse flash-attention forward) -> KV-cache
decode and sampling -> dVAE decode to pixels.  Training: the DALLE train
step (``training.make_dalle_train_step``) on image codes or, through the
frozen dVAE encoder, on images, with the flash-attention forward and its
two hand-written CUDA backward kernels.  The package imports torch and
numpy, never JAX or the JAX package.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from .models.dalle import DALLE, DALLEConfig
from .models.vae import DiscreteVAE, VAEConfig

__all__ = ["DALLE", "DALLEConfig", "DiscreteVAE", "VAEConfig"]
