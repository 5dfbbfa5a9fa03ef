"""The DALLE train step: loss, grads and the Adam update.

PyTorch counterpart of ``dalle_pytorch_tpu/training.py``'s
``make_optimizer``, ``set_learning_rate`` and ``make_dalle_train_step``.
The JAX step is one jitted function of (params, opt_state, ...); here the
state lives in the model's parameters and in the optimizer, and the step
updates both in place.

``Adam`` is optax's ``chain(clip_by_global_norm(c), adam(lr))`` written
out: b1 0.9, b2 0.999, eps 1e-8 added after the bias-corrected square
root, and a clip that leaves the grads alone below the limit and scales
them by limit / norm above it (unlike ``clip_grad_norm_``, which adds
1e-6 to the norm).  It packs the parameters into one flat f32 buffer,
each parameter becoming a view of it, so that an update is a few
element-wise ops over that buffer, and the guard of
``utils/guardrails.py`` can keep params, moments and step count bitwise
unchanged on a non-finite step without a host sync.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from .utils import guardrails

# optax.adam's defaults, which torch.optim.Adam shares
B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """optax's Adam, with an optional global-norm clip first, over the
    given f32 parameters (which become views of one flat buffer)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, grad_clip_norm: float = 0.0):
        self.params = list(params)
        bad = [tuple(p.shape) for p in self.params
               if p.dtype != torch.float32]
        if bad:
            raise ValueError(f"Adam takes float32 parameters; got others of "
                             f"shapes {bad}")
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        offset = 0
        for p in self.params:
            p.data = self.flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.flat.device)
        self.learning_rate = float(learning_rate)
        self.grad_clip_norm = float(grad_clip_norm)

    def flat_grads(self, grads) -> torch.Tensor:
        """The parameters' gradients as one f32 vector in buffer order."""
        return torch.cat([g.reshape(-1) for g in grads]).float()

    def update(self, grads: torch.Tensor, ok: Optional[torch.Tensor] = None,
               gnorm: Optional[torch.Tensor] = None) -> None:
        """One step from the flat gradient.  ``ok`` (a bool device scalar)
        selects between the new state and the old one; ``gnorm`` is the
        gradient's global norm when the caller has it."""
        g = grads
        if self.grad_clip_norm > 0:
            if gnorm is None:
                gnorm = torch.linalg.vector_norm(g)
            c = self.grad_clip_norm
            g = torch.where(gnorm < c, g, g / gnorm * c)
        count = self.count + 1
        mu = (1 - B1) * g + B1 * self.mu
        nu = (1 - B2) * (g * g) + B2 * self.nu
        t = count.float()
        mu_hat = mu / (1 - B1 ** t)
        nu_hat = nu / (1 - B2 ** t)
        new = self.flat + (-self.learning_rate) * (
            mu_hat / (torch.sqrt(nu_hat) + EPS))
        if ok is not None:
            new = torch.where(ok, new, self.flat)
            mu = torch.where(ok, mu, self.mu)
            nu = torch.where(ok, nu, self.nu)
            count = torch.where(ok, count, self.count)
        self.flat.copy_(new)
        self.mu, self.nu, self.count = mu, nu, count


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   grad_clip_norm: float = 0.0) -> Adam:
    """Adam with the reference's defaults and an optional global-norm clip;
    the learning rate can change between steps (``set_learning_rate``)."""
    return Adam(params, learning_rate, grad_clip_norm=grad_clip_norm)


def set_learning_rate(opt: Adam, lr: float) -> Adam:
    """Host-side lr override for the next steps (plateau/exp schedules)."""
    opt.learning_rate = float(lr)
    return opt


def make_dalle_train_step(dalle, opt: Adam, vae=None, health: bool = False,
                          guard: bool = True):
    """The DALLE step: ``step(text, images_or_codes, fault_scale=1.0)``.

    With ``vae`` the batch carries images ``[b, H, W, c]`` and the frozen
    VAE encodes them to codes inside the step, without grads; otherwise it
    carries codes ``[b, image_seq_len]``.  Dropout follows the model's
    training mode.  Returns the loss (a device scalar), and with
    ``health`` also the health dict of ``utils/guardrails.py``; then
    ``fault_scale`` multiplies the loss before differentiation (NaN
    poisons the gradients, as the chaos suites do) and ``guard`` keeps a
    non-finite step from touching the training state."""

    def train_step(text, images_or_codes, fault_scale: float = 1.0):
        if vae is not None:
            with torch.no_grad():
                codes = vae.get_codebook_indices(images_or_codes)
        else:
            codes = images_or_codes
        loss = dalle(text, codes, return_loss=True)
        if health:
            loss = loss * fault_scale
        grads = opt.flat_grads(torch.autograd.grad(
            loss, opt.params, allow_unused=True, materialize_grads=True))
        loss = loss.detach()
        if health:
            return loss, guardrails.guarded_update(opt, grads, loss=loss,
                                                   guard=guard)
        opt.update(grads)
        return loss

    return train_step
