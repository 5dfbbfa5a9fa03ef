"""Training health on the device: the guarded optimizer update.

PyTorch counterpart of the device side of
``dalle_pytorch_tpu/utils/guardrails.py`` (``guarded_update``).  The
host-side anomaly monitor, rollback and step watchdog are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch


def guarded_update(opt, grads: torch.Tensor, *, loss: torch.Tensor,
                   guard: bool = True) -> Dict[str, torch.Tensor]:
    """One optimizer update with a non-finite sentinel, without a host
    sync.

    ``grads`` is the flat f32 gradient (``opt.flat_grads``).  Computes the
    global grad norm and a finite flag (a NaN/Inf in any gradient reaches
    the norm; a non-finite ``loss`` trips it too).  With ``guard`` and the
    flag down, the update is selected away element by element, so params,
    both Adam moments and the step count stay bitwise as they were.
    Returns the health dict of f32 device scalars: ``loss``, ``grad_norm``
    and ``applied`` (1.0 applied, 0.0 skipped)."""
    gnorm = torch.linalg.vector_norm(grads)
    ok = torch.isfinite(gnorm) & torch.isfinite(loss)
    opt.update(grads, ok=ok if guard else None, gnorm=gnorm)
    return {"loss": loss.detach().float(), "grad_norm": gnorm,
            "applied": ok.float()}
