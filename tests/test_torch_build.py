"""The port's kernel build (dalle_pytorch_tpu_torch.ops._build) on a
machine without nvcc: what it would build, and how it fails."""
import pytest

from dalle_pytorch_tpu_torch.ops import _build


def test_sources_and_library_names():
    assert {"flash_fwd", "flash_bwd"} <= set(_build.sources())
    for name in ("flash_fwd", "flash_bwd"):
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


def test_library_name_follows_the_flags(monkeypatch):
    """An edited source or flag set never reuses a stale build."""
    before = _build.library_path("flash_fwd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("flash_fwd") != before


def test_missing_nvcc_raises_before_touching_the_tree(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_fwd"])
    assert not (tmp_path / "build").exists()


def test_failed_compile_raises_with_its_log(monkeypatch, tmp_path):
    """A compiler that exits non-zero leaves no library behind."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed on csrc/flash_fwd.cu"):
        _build.build(["flash_fwd"])
    assert list((tmp_path / "build").iterdir()) == []
