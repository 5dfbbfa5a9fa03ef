"""The port stands alone: importing dalle_pytorch_tpu_torch, its training
step included (or running chip_smoke.py), loads neither JAX, flax, optax
nor the JAX package, and its entry points never carry on quietly on the
CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dalle_pytorch_tpu_torch import DALLE, DALLEConfig, DiscreteVAE, VAEConfig

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dalle_pytorch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dalle_pytorch_tpu")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_loads_no_jax():
    code = ("import sys, dalle_pytorch_tpu_torch, dalle_pytorch_tpu_torch.cli, "
            "dalle_pytorch_tpu_torch.weights, "
            "dalle_pytorch_tpu_torch.training, "
            "dalle_pytorch_tpu_torch.utils.schedule, "
            "dalle_pytorch_tpu_torch.ops.flash_attention\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_no_jax_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without CUDA, building a model without device='cpu' raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DALLEConfig(dim=16, num_text_tokens=10, text_seq_len=4, depth=1,
                      heads=1, dim_head=8, num_image_tokens=8,
                      image_fmap_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DALLE(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DALLE(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiscreteVAE(VAEConfig(image_size=8, num_layers=1))
    assert DALLE(cfg, device="cpu").device.type == "cpu"
