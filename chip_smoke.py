#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (dalle_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure so the script exits non-zero:

1. device: the card's name and power limit, torch / CUDA versions, and
   the build of every CUDA kernel from csrc/ (nvcc, sm_90a);
2. kernel against plain: the flash-attention forward kernel against its
   plain torch version on the card, at the CUB shape (b 1 and 4, 8 heads,
   n 1104, dim_head 64, bf16) for every attention variant and a key-pad
   case with fully masked rows; times of the kernel, the plain version,
   scaled_dot_product_attention with the same mask (a yardstick the port
   never calls) and the card's bound for the same work;
3. main path: the CUB-200 DALLE (dim 256, depth 8, 8 heads of 64, 80 text
   tokens + <bos>, 32 x 32 codes, bf16) and its dVAE (128 px, 2 layers,
   2 resblocks, 8192 codes) with random weights made from a seed in the
   JAX param-tree layout and passed through the weight bridge; then
   cli.generate_chunked for one prompt x 4 images (shared prefill) and
   for 2 distinct prompts, checking codes, images and that the kernel ran
   8 times per prefill;
4. kernel in the model: prefill logits and caches, and teacher-forced
   decode logits, with the kernel against the same model running the
   plain version;
5. a JSON line listing each kernel with its launches on the main path,
   its error and times, then the card line again, and last the result.

Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
VARIANTS = ("full", "axial_row", "axial_col", "conv_like", "sparse")
CUB_TYPES = ("full", "axial_row", "axial_col", "conv_like")
TEXT_SEQ, FMAP, HEADS, DH = 80, 32, 8, 64
N = TEXT_SEQ + FMAP * FMAP  # 1104 transformer positions
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor / CUDA core
# kernel against plain: o is rounded to bf16 once on both sides, so they
# may differ by one bf16 step (2^-7 of |o|) plus f32 reordering; lse stays
# f32 end to end
O_ATOL, O_RTOL, LSE_ATOL = 2e-2, 2.0 ** -7, 1e-3
# model with the kernel against the model with the plain version: bf16
# activations round every op to 2^-8, and eight residual layers carry a
# few such steps of the largest entries
MODEL_REL = 2e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(q, mask, bias) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over HBM bandwidth and its matmul work on the allowed (query, key)
    pairs of these inputs over the peak rate for q's type."""
    import torch

    b, h, n, dh = q.shape
    item = q.element_size()
    nbytes = 4 * b * h * n * dh * item + b * h * n * 4 + n * n
    allowed = mask[None].expand(b, n, n)
    if bias is not None:
        nbytes += bias.numel() * 4
        allowed = allowed & (bias > -1e29)[:, None, :]
    pairs = int(allowed.sum()) * h
    flops = 4 * dh * pairs  # q.k and p.v, a multiply and an add each
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(gen):
    """Kernel against plain on the card; returns (max o error, timing rows)."""
    import torch
    import torch.nn.functional as F

    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.attention import (AttnPattern,
                                                       device_pattern_mask)

    worst, rows = 0.0, []
    cases = [(b, v, torch.bfloat16) for b in (1, 4) for v in VARIANTS + ("pad",)]
    cases.append((1, "full", torch.float32))
    for b, variant, dtype in cases:
        pattern = AttnPattern(variant="full" if variant == "pad" else variant,
                              seq_len=N, text_len=TEXT_SEQ + 1, fmap=FMAP)
        q, k, v = (torch.randn(b, HEADS, N, DH, device="cuda", generator=gen
                               ).to(dtype) for _ in range(3))
        bias = None
        if variant == "pad":
            # sample 0 drops its first 6 keys (rows 0-5 fully masked), the
            # others their last 30 text keys
            bias = torch.zeros(b, N, device="cuda")
            bias[0, :6] = -1e30
            bias[1:, TEXT_SEQ - 30:TEXT_SEQ + 1] = -1e30
        o, lse = fa.flash_pattern_attention(q, k, v, pattern, bias,
                                            return_lse=True)
        o_p, lse_p = fa.flash_pattern_attention_plain(q, k, v, pattern, bias,
                                                      return_lse=True)
        torch.cuda.synchronize()
        err_o = (o.float() - o_p.float()).abs()
        fin = torch.isfinite(lse_p)
        err_lse = (lse[fin] - lse_p[fin]).abs().max().item()
        ok = bool((err_o <= O_ATOL + O_RTOL * o_p.float().abs()).all())
        same_inf = torch.equal(torch.isinf(lse), torch.isinf(lse_p))
        check(ok and err_lse <= LSE_ATOL and same_inf,
              f"flash_fwd vs plain [{variant} b={b} {dtype}]: o err "
              f"{err_o.max().item():.3e}, lse err {err_lse:.3e}, "
              f"inf rows equal {same_inf}")
        if variant == "pad":
            check(bool(torch.isinf(lse[0, :, :6]).all())
                  and bool((o[0, :, :6] == 0).all()),
                  "fully masked rows give o = 0 and lse = +inf")
        if dtype == torch.bfloat16:
            worst = max(worst, err_o.max().item())

        mask = device_pattern_mask(pattern, N, q.device)
        if bias is None:
            lib_mask = mask
        else:
            lib_mask = (torch.where(mask, 0.0, float("-inf"))[None, None]
                        + bias[:, None, None, :]).to(dtype)
        row = dict(
            variant=variant, b=b, dtype=str(dtype).replace("torch.", ""),
            max_abs_err_o=err_o.max().item(), max_abs_err_lse=err_lse,
            ms=cuda_ms(lambda: fa.flash_pattern_attention(q, k, v, pattern,
                                                          bias)),
            plain_ms=cuda_ms(lambda: fa.flash_pattern_attention_plain(
                q, k, v, pattern, bias)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask)))
        row["bound_ms"], row["bound_by"] = bound(q, mask, bias)
        rows.append(row)
        print(f"flash_fwd [{variant:9s} b={b} {row['dtype']}] "
              f"o err {row['max_abs_err_o']:.3e} (tol {O_ATOL} + |o|/128), "
              f"lse err {err_lse:.3e} (tol {LSE_ATOL}) | kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})", flush=True)
    return worst, rows


def cub_models(device):
    import torch

    from dalle_pytorch_tpu_torch import DALLE, DALLEConfig, DiscreteVAE, VAEConfig
    from dalle_pytorch_tpu_torch import weights

    cfg = DALLEConfig(dim=256, num_text_tokens=7800, text_seq_len=TEXT_SEQ,
                      depth=8, heads=HEADS, dim_head=DH, attn_types=CUB_TYPES,
                      num_image_tokens=8192, image_size=256,
                      image_fmap_size=FMAP, use_pallas=True,
                      dtype=torch.bfloat16)
    vcfg = VAEConfig(image_size=128, num_tokens=8192, codebook_dim=512,
                     num_layers=2, num_resnet_blocks=2, hidden_dim=256)
    dalle = DALLE(cfg, device=device)
    dalle.load_state_dict(weights.dalle_state_dict_from_jax(
        weights.init_dalle_params(cfg, seed=0), cfg))
    vae = DiscreteVAE(vcfg, device=device)
    vae.load_state_dict(weights.vae_state_dict_from_jax(
        weights.init_vae_params(vcfg, seed=1), vcfg))
    return cfg, dalle, vae


def captions(n: int, seed: int) -> np.ndarray:
    """Token ids like a tokenized caption: 12-30 ids, then pad zeros."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, TEXT_SEQ), np.int64)
    for i in range(n):
        length = rng.integers(12, 31)
        out[i, :length] = rng.integers(1, 7800, length)
    return out


def main_path(cfg, dalle, vae, card):
    import torch

    from dalle_pytorch_tpu_torch import cli
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    decode = cli.make_decode_fn(vae)
    seen = []

    def decode_and_keep(codes):
        seen.append(codes)
        return decode(codes)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shared = np.repeat(captions(1, seed=2), 4, axis=0)
    distinct = captions(2, seed=3)

    fa.reset_launches()
    torch.cuda.synchronize()
    walls, images = [], []
    for tokens, batch in ((shared, 4), (distinct, 2)):
        t0 = time.perf_counter()
        images.append(cli.generate_chunked(dalle, decode_and_keep, tokens,
                                           batch_size=batch, top_k=0.9,
                                           generator=gen))
        walls.append(time.perf_counter() - t0)
    launches = fa.LAUNCHES[fa.KERNEL]

    prefills = 2  # one shared batch-1 prefill + one batch-2 chunk
    check(launches == cfg.depth * prefills,
          f"flash_fwd launched {launches} times on the main path, "
          f"expected {cfg.depth} x {prefills} prefills")
    for codes in seen:
        check(codes.shape[1] == cfg.image_seq_len
              and int(codes.min()) >= 0
              and int(codes.max()) < cfg.num_image_tokens,
              f"codes {tuple(codes.shape)} in [0, {cfg.num_image_tokens})")
    for imgs, n in zip(images, (4, 2)):
        check(tuple(imgs.shape) == (n, 128, 128, 3)
              and bool(torch.isfinite(imgs).all()),
              f"images {tuple(imgs.shape)} finite")

    text1 = torch.as_tensor(shared[:1], device="cuda")
    prefill_ms = cuda_ms(lambda: dalle.prefill(text1), reps=10)
    codes4 = seen[0]
    vae_ms = cuda_ms(lambda: vae.decode(codes4), reps=10)
    tok_s = [n * cfg.image_seq_len / w for n, w in zip((4, 2), walls)]
    print(f"main path [{card}]: flash_fwd launches {launches} "
          f"({cfg.depth} per prefill x {prefills}); shared prompt x4: "
          f"{walls[0]:.2f} s, {tok_s[0]:.1f} image-tokens/s; 2 prompts: "
          f"{walls[1]:.2f} s, {tok_s[1]:.1f} image-tokens/s; prefill b=1 "
          f"{prefill_ms:.3f} ms; VAE decode b=4 {vae_ms:.3f} ms", flush=True)
    return launches


def kernel_in_model(cfg, dalle):
    """Prefill and teacher-forced decode with the kernel, against the same
    model with the plain version patched in for this comparison only."""
    import torch

    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    text = torch.as_tensor(captions(2, seed=4), device="cuda")
    codes = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.num_image_tokens, (2, 8)), device="cuda")

    def run():
        logits, caches = dalle.prefill(text)
        out = [logits]
        for i in range(codes.shape[1]):
            step, caches = dalle.decode_step(codes[:, i], caches,
                                             cfg.text_seq_len + 1 + i)
            out.append(step)
        return torch.stack(out, 1), caches

    kernel_logits, kernel_caches = run()
    with mock.patch.object(fa, "flash_pattern_attention",
                           fa.flash_pattern_attention_plain):
        plain_logits, plain_caches = run()

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

    err_logits = rel(kernel_logits, plain_logits)
    err_cache = max(max(rel(k, pk), rel(v, pv)) for (k, v), (pk, pv)
                    in zip(kernel_caches, plain_caches))
    print(f"kernel in model: prefill + 8 teacher-forced decode logits rel err "
          f"{err_logits:.3e}, caches rel err {err_cache:.3e} "
          f"(tol {MODEL_REL})", flush=True)
    check(bool(torch.isfinite(kernel_logits).all()), "finite logits")
    check(err_logits <= MODEL_REL and err_cache <= MODEL_REL,
          "model with the kernel agrees with the model with the plain version")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dalle_pytorch_tpu_torch.ops import _build

    # full-f32 matmuls and convolutions for the plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, rows = kernel_phase(gen)

    cfg, dalle, vae = cub_models("cuda")
    launches = main_path(cfg, dalle, vae, card)
    kernel_in_model(cfg, dalle)

    main_rows = [r for r in rows if r["b"] == 1 and r["dtype"] == "bfloat16"
                 and r["variant"] in CUB_TYPES]

    def mean(key):
        return sum(r[key] for r in main_rows) / len(main_rows)

    bound_ms = mean("bound_ms")
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dalle_pytorch_tpu/ops/attention_pallas.py:74",
        "launches": launches, "max_abs_err": worst,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": bound_ms,
        "bound_by": Counter(r["bound_by"] for r in main_rows
                            ).most_common(1)[0][0],
        "library_ms": mean("library_ms"),
    }]
    print("kernel times: per launch, mean over the 4 CUB patterns at b=1 "
          "(the shared prefill's shape)", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
