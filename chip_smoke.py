#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (dalle_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure so the script exits non-zero:

1. device: the card's name and power limit, torch / CUDA versions, and
   the build of every CUDA source in csrc/ (flash_fwd.cu, flash_bwd.cu;
   one nvcc each, all started together, sm_90a);
2. forward kernel against plain: flash_fwd against its plain torch
   version at the CUB shape (8 heads, n 1104, dim_head 64, bf16; b 1 and
   4 for every attention variant and a key-pad case with fully masked
   rows, b 16 for the 4 CUB patterns, one f32 case); times of the kernel,
   the plain version, scaled_dot_product_attention with the same mask (a
   yardstick the port never calls) and the card's bound for the work;
3. backward kernels against plain: flash_bwd_dq and flash_bwd_dkv against
   the plain backward from the same o, lse and do, at b 16 and b 1 for
   every variant and the key-pad case (grads zero on the fully masked
   rows), and one f32 case; times of each kernel, the plain backward,
   SDPA's backward with the same mask, and each kernel's bound;
4. generation: the CUB-200 DALLE (dim 256, depth 8, 8 heads of 64, 80
   text tokens + <bos>, 32 x 32 codes, bf16) and its dVAE (128 px, 2
   layers, 2 resblocks, 8192 codes) with random weights made from a seed
   in the JAX param-tree layout and passed through the weight bridge;
   cli.generate_chunked for one prompt x 4 images (shared prefill) and
   for 2 distinct prompts, checking codes, images and that flash_fwd ran
   8 times per prefill;
5. the forward kernel in the model: prefill logits and caches, and
   teacher-forced decode logits, against the plain version;
6. training: the CUB train step at b 16 on the codes path (lr 3e-4, as
   bench.py::make_train_measure), 3 warm-up and 10 timed steps on one
   batch, with the kernels (8 launches of each per step) and on the dense
   path; finite, falling loss; training images/s of both;
7. the kernels in the train step: one step's loss and every grad against
   the same model with the plain forward and backward patched in;
8. the images path: one step at b 4, the frozen dVAE encoding 128 px
   images to codes inside the step;
9. a JSON line listing each kernel with its launches on the main paths,
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
# backward kernels against the plain backward: each grad is rounded to
# bf16 once on both sides (one bf16 step, 2^-7 of the value, where f32
# sums in another order land on either side of a rounding edge), plus
# 2^-10 of the tensor's largest entry for the f32 sums themselves; at
# f32, 1e-4 of the value and of the largest entry
BWD_RTOL, BWD_ATOL, F32_TOL = 2.0 ** -7, 2.0 ** -10, 1e-4
TRAIN_B, WARMUP, TIMED = 16, 3, 10  # the train step's batch and steps
# a train step with the kernels against the plain versions: bf16
# activations through 8 layers forward and back, where the two attention
# outputs may differ by a bf16 step; each grad as max |diff| / max |grad|
LOSS_REL, GRAD_REL = 1e-2, 5e-2
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
    cases += [(TRAIN_B, v, torch.bfloat16) for v in CUB_TYPES]  # train step
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


def bound_bwd(q, mask, bias) -> dict:
    """{kernel: (bound_ms, bound_by)} of the two backward kernels: dq reads
    q, k, v, do, lse, delta and the mask and writes dq, 6 * dim_head
    operations per allowed pair (q.k, do.v, ds.k); dk/dv read the same and
    write dk and dv, 8 * dim_head per pair (q.k, do.v, p^T.do, ds^T.q)."""
    b, h, n, dh = q.shape
    tensor = b * h * n * dh * q.element_size()
    rows = 2 * b * h * n * 4 + n * n  # lse, delta, mask
    allowed = mask[None].expand(b, n, n)
    if bias is not None:
        rows += bias.numel() * 4
        allowed = allowed & (bias > -1e29)[:, None, :]
    pairs = int(allowed.sum()) * h
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    out = {}
    for name, n_tensors, per_pair in (("flash_bwd_dq", 5, 6),
                                      ("flash_bwd_dkv", 6, 8)):
        t_bytes = (n_tensors * tensor + rows) / HBM_BYTES_PER_S
        t_ops = per_pair * dh * pairs / peak
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def bwd_kernel_phase(gen):
    """Both backward kernels against the plain backward on the card, from
    the forward kernel's o and lse; returns (max error per kernel, rows)."""
    import torch
    import torch.nn.functional as F

    from dalle_pytorch_tpu_torch.ops import flash_attention as fa
    from dalle_pytorch_tpu_torch.ops.attention import (AttnPattern,
                                                       device_pattern_mask)

    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    rows = []
    cases = [(b, v, torch.bfloat16) for b in (TRAIN_B, 1)
             for v in VARIANTS + ("pad",)]
    cases.append((1, "full", torch.float32))
    for b, variant, dtype in cases:
        pattern = AttnPattern(variant="full" if variant == "pad" else variant,
                              seq_len=N, text_len=TEXT_SEQ + 1, fmap=FMAP)
        q, k, v, do = (torch.randn(b, HEADS, N, DH, device="cuda",
                                   generator=gen).to(dtype) for _ in range(4))
        bias = None
        if variant == "pad":
            # sample 0 drops its first 6 keys (rows 0-5 fully masked), the
            # others their last 30 text keys
            bias = torch.zeros(b, N, device="cuda")
            bias[0, :6] = -1e30
            bias[1:, TEXT_SEQ - 30:TEXT_SEQ + 1] = -1e30
        o, lse = fa.flash_pattern_attention(q, k, v, pattern, bias,
                                            return_lse=True)
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = fa.launch_bwd_dq(q, k, v, lse, delta, do, pattern, bias)
        dk, dv = fa.launch_bwd_dkv(q, k, v, lse, delta, do, pattern, bias)
        ref = fa.flash_pattern_attention_bwd_plain(q, k, v, o, lse, do,
                                                   pattern, bias)
        torch.cuda.synchronize()
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            got, want = got.float(), want.float()
            err = (got - want).abs()
            if dtype == torch.bfloat16:
                tol = BWD_RTOL * want.abs() + BWD_ATOL * want.abs().max()
            else:
                tol = F32_TOL * (want.abs() + want.abs().max())
            check(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
                  f"{name} vs plain [{variant} b={b} {dtype}]: max err "
                  f"{err.max().item():.3e}, max |ref| "
                  f"{want.abs().max().item():.3e}")
            errs[name] = err.max().item()
        if variant == "pad":
            check(all(bool((g[0, :, :6] == 0).all()) for g in (dq, dk, dv)),
                  "fully masked rows and dropped keys get zero gradients")
        if dtype == torch.bfloat16:
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"],
                                         errs["dv"])

        mask = device_pattern_mask(pattern, N, q.device)
        if bias is None:
            lib_mask = mask
        else:
            lib_mask = (torch.where(mask, 0.0, float("-inf"))[None, None]
                        + bias[:, None, None, :]).to(dtype)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=lib_mask)
        row = dict(
            variant=variant, b=b, dtype=str(dtype).replace("torch.", ""),
            err_dq=errs["dq"], err_dk=errs["dk"], err_dv=errs["dv"],
            dq_ms=cuda_ms(lambda: fa.launch_bwd_dq(q, k, v, lse, delta, do,
                                                   pattern, bias)),
            dkv_ms=cuda_ms(lambda: fa.launch_bwd_dkv(q, k, v, lse, delta, do,
                                                     pattern, bias)),
            plain_ms=cuda_ms(lambda: fa.flash_pattern_attention_bwd_plain(
                q, k, v, o, lse, do, pattern, bias), reps=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                o_lib, (qg, kg, vg), do, retain_graph=True)))
        row["bound"] = bound_bwd(q, mask, bias)
        rows.append(row)
        (bq, byq), (bkv, bykv) = (row["bound"]["flash_bwd_dq"],
                                  row["bound"]["flash_bwd_dkv"])
        print(f"flash_bwd [{variant:9s} b={b:2d} {row['dtype']}] err dq "
              f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e} | "
              f"dq {row['dq_ms']:.4f} ms (bound {bq:.5f}, {byq}), dkv "
              f"{row['dkv_ms']:.4f} ms (bound {bkv:.5f}, {bykv}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa bwd {row['library_ms']:.4f} ms",
              flush=True)
    return worst, rows


def cub_dalle(use_pallas: bool = True):
    """The CUB-200 DALLE of bench.py::cub200_config on the card, with
    random weights from seed 0 in the JAX layout through the bridge."""
    import torch

    from dalle_pytorch_tpu_torch import DALLE, DALLEConfig, weights

    cfg = DALLEConfig(dim=256, num_text_tokens=7800, text_seq_len=TEXT_SEQ,
                      depth=8, heads=HEADS, dim_head=DH, attn_types=CUB_TYPES,
                      num_image_tokens=8192, image_size=256,
                      image_fmap_size=FMAP, use_pallas=use_pallas,
                      dtype=torch.bfloat16)
    dalle = DALLE(cfg, device="cuda")
    dalle.load_state_dict(weights.dalle_state_dict_from_jax(
        weights.init_dalle_params(cfg, seed=0), cfg))
    return cfg, dalle


def cub_vae():
    """The CUB dVAE of train_vae.py (128 px, 2 layers, so fmap 32), encoder
    included, random weights from seed 1."""
    from dalle_pytorch_tpu_torch import DiscreteVAE, VAEConfig, weights

    vcfg = VAEConfig(image_size=128, num_tokens=8192, codebook_dim=512,
                     num_layers=2, num_resnet_blocks=2, hidden_dim=256)
    vae = DiscreteVAE(vcfg, device="cuda")
    vae.load_state_dict(weights.vae_state_dict_from_jax(
        weights.init_vae_params(vcfg, seed=1), vcfg))
    return vae


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
    counts = dict(fa.LAUNCHES)
    launches = counts[fa.KERNEL]

    prefills = 2  # one shared batch-1 prefill + one batch-2 chunk
    check(launches == cfg.depth * prefills
          and counts[fa.KERNEL_DQ] == counts[fa.KERNEL_DKV] == 0,
          f"generation launched {counts}, expected flash_fwd "
          f"{cfg.depth} x {prefills} prefills and no backward kernel")
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
    return counts


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


def train_batch(n: int, seed: int):
    """(text, codes) on the card: captions and uniform random codes."""
    import torch

    codes = np.random.default_rng(seed).integers(0, 8192, (n, FMAP * FMAP))
    return (torch.as_tensor(captions(n, seed), device="cuda"),
            torch.as_tensor(codes, device="cuda"))


def train_path(card, use_pallas: bool) -> dict:
    """The CUB train step at b 16 on the codes path, lr 3e-4 as
    bench.py::make_train_measure: WARMUP steps, then TIMED steps on one
    fixed batch with the launch counts set to 0 just before them.  The
    loss must be finite and falling; with the kernels, each of them must
    launch 8 times (once per layer) per step."""
    import torch

    from dalle_pytorch_tpu_torch import training
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    cfg, dalle = cub_dalle(use_pallas)
    opt = training.make_optimizer(dalle.parameters(), 3e-4)
    step = training.make_dalle_train_step(dalle, opt)
    text, codes = train_batch(TRAIN_B, seed=6)
    for _ in range(WARMUP):
        step(text, codes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = [step(text, codes) for _ in range(TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses = [float(x) for x in losses]
    name = "kernels" if use_pallas else "dense"
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train [{name}]: finite, falling loss {losses}")
    want = cfg.depth * TIMED if use_pallas else 0
    check(all(n == want for n in launches.values()),
          f"train [{name}]: launches {launches}, expected {want} each "
          f"({cfg.depth} per step x {TIMED} steps)")
    out = dict(images_per_s=TRAIN_B * TIMED / wall,
               step_ms=wall / TIMED * 1e3, launches=launches,
               first_loss=losses[0], last_loss=losses[-1],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"train [{name:7s} b={TRAIN_B}] [{card}]: {out['images_per_s']:.1f} "
          f"images/s, {out['step_ms']:.2f} ms/step over {TIMED} steps after "
          f"{WARMUP} warm-up, loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak "
          f"{out['peak_gb']:.2f} GB, launches {launches}", flush=True)
    profile_steps(name, lambda: step(text, codes), out["step_ms"])
    del dalle, opt, step
    torch.cuda.empty_cache()
    return out


def kernel_category(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if f"{kernel}_kernel" in name:
            return kernel
    low = name.lower()
    if any(t in low for t in ("gemm", "cutlass", "xmma", "cublas")):
        return "matmul (cuBLAS)"
    return "other"


def profile_steps(name: str, run_step, step_ms: float, steps: int = 2):
    """Device time per step by kernel category under torch.profiler, over
    ``steps`` more steps, and the device's busy share: device time per
    step over the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    by_cat, by_kernel = Counter(), Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total / steps
        by_cat[kernel_category(e.key)] += us
        by_kernel[e.key[:60]] += us
    device_ms = sum(by_cat.values()) / 1e3
    cats = ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in by_cat.most_common())
    top = "; ".join(f"{k} {v / 1e3:.2f} ms"
                    for k, v in by_kernel.most_common(6))
    print(f"train [{name:7s}] profile per step: device {device_ms:.2f} ms "
          f"of {step_ms:.2f} ms ({100 * device_ms / step_ms:.1f} % busy): "
          f"{cats} | top kernels: {top}", flush=True)


def grads_in_model():
    """One b 16 train step's loss and every parameter gradient, with the
    kernels, against the same model with the plain forward and backward
    patched into the same autograd function for this comparison only."""
    import torch

    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    cfg, dalle = cub_dalle(True)
    text, codes = train_batch(TRAIN_B, seed=7)
    params = list(dalle.parameters())

    def loss_and_grads():
        loss = dalle(text, codes, return_loss=True)
        return loss.detach(), torch.autograd.grad(loss, params)

    def plain_fwd(q, k, v, pattern, bias):
        return fa.flash_pattern_attention_plain(q, k, v, pattern, bias,
                                                return_lse=True)

    kernel_loss, kernel_grads = loss_and_grads()
    with mock.patch.object(fa, "_launch", plain_fwd), \
            mock.patch.object(fa, "_launch_bwd",
                              fa.flash_pattern_attention_bwd_plain):
        plain_loss, plain_grads = loss_and_grads()
    err_loss = abs(float(kernel_loss) - float(plain_loss)) / abs(
        float(plain_loss))
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(dalle.named_parameters(), kernel_grads,
                               plain_grads):
        check(bool(torch.isfinite(a).all()), f"finite grad {name}")
        err = ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()
        if err > worst:
            worst, worst_name = err, name
    print(f"kernels in model (train step b={TRAIN_B}): loss rel err "
          f"{err_loss:.3e} (tol {LOSS_REL}), worst grad rel err {worst:.3e} "
          f"at {worst_name} (tol {GRAD_REL}), over {len(params)} parameters",
          flush=True)
    check(err_loss <= LOSS_REL and worst <= GRAD_REL,
          "train step with the kernels agrees with the plain versions")
    del dalle
    torch.cuda.empty_cache()


def images_path(vae) -> dict:
    """One step at b 4 on the images path: the frozen CUB dVAE encodes
    128 px images to 32 x 32 codes inside the step."""
    import torch

    from dalle_pytorch_tpu_torch import training
    from dalle_pytorch_tpu_torch.ops import flash_attention as fa

    cfg, dalle = cub_dalle(True)
    opt = training.make_optimizer(dalle.parameters(), 3e-4)
    step = training.make_dalle_train_step(dalle, opt, vae=vae, health=True)
    text, _ = train_batch(4, seed=8)
    images = torch.rand(4, 128, 128, 3, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(9))
    codes = vae.get_codebook_indices(images)
    check(tuple(codes.shape) == (4, cfg.image_seq_len)
          and int(codes.min()) >= 0 and int(codes.max()) < 8192,
          f"dVAE codes {tuple(codes.shape)} in [0, 8192)")
    fa.reset_launches()
    loss, health = step(text, images)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    check(bool(torch.isfinite(loss)) and float(health["applied"]) == 1.0,
          f"images path: finite loss {float(loss)}, applied")
    check(all(n == cfg.depth for n in launches.values()),
          f"images path: launches {launches}, expected {cfg.depth} each")
    print(f"images path (b=4, 128 px -> 32 x 32 codes): loss "
          f"{float(loss):.4f}, grad norm {float(health['grad_norm']):.4f}, "
          f"launches {launches}", flush=True)
    del dalle, opt, step
    torch.cuda.empty_cache()
    return launches


def kernel_lines(fwd_rows, fwd_worst, bwd_rows, bwd_worst, launches):
    """The kernels JSON line: the forward's times at b 1 (the shared
    prefill) with its b 16 times beside them, the backward kernels' at
    b 16 (the train step), each a mean over the 4 CUB patterns."""
    def pick(rows, b):
        return [r for r in rows if r["b"] == b and r["dtype"] == "bfloat16"
                and r["variant"] in CUB_TYPES]

    def mean(rows, fn):
        return sum(fn(r) for r in rows) / len(rows)

    def most(rows, fn):
        return Counter(fn(r) for r in rows).most_common(1)[0][0]

    f1, f16, b16 = pick(fwd_rows, 1), pick(fwd_rows, TRAIN_B), pick(
        bwd_rows, TRAIN_B)
    src = "dalle_pytorch_tpu/ops/attention_pallas.py"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/flash_fwd.cu",
        "replaces": f"{src}:74",
        "launches": launches["train"]["flash_fwd"],
        "launches_by_path": {p: launches[p]["flash_fwd"] for p in launches},
        "max_abs_err": fwd_worst,
        "ms": mean(f1, lambda r: r["ms"]),
        "plain_ms": mean(f1, lambda r: r["plain_ms"]),
        "bound_ms": mean(f1, lambda r: r["bound_ms"]),
        "bound_by": most(f1, lambda r: r["bound_by"]),
        "library_ms": mean(f1, lambda r: r["library_ms"]),
        "ms_b16": mean(f16, lambda r: r["ms"]),
        "plain_ms_b16": mean(f16, lambda r: r["plain_ms"]),
        "bound_ms_b16": mean(f16, lambda r: r["bound_ms"]),
        "library_ms_b16": mean(f16, lambda r: r["library_ms"]),
    }]
    for name, key, line in (("flash_bwd_dq", "dq_ms", 127),
                            ("flash_bwd_dkv", "dkv_ms", 163)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"{src}:{line}",
            "launches": launches["train"][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": bwd_worst[name],
            "ms": mean(b16, lambda r: r[key]),
            "plain_ms": mean(b16, lambda r: r["plain_ms"]),
            "bound_ms": mean(b16, lambda r: r["bound"][name][0]),
            "bound_by": most(b16, lambda r: r["bound"][name][1]),
            "library_ms": mean(b16, lambda r: r["library_ms"]),
        })
    return kernels


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
    fwd_worst, fwd_rows = kernel_phase(gen)
    bwd_worst, bwd_rows = bwd_kernel_phase(gen)

    cfg, dalle = cub_dalle(True)
    vae = cub_vae()
    launches = {"generate": main_path(cfg, dalle, vae, card)}
    kernel_in_model(cfg, dalle)
    del dalle
    torch.cuda.empty_cache()

    trains = {p: train_path(card, p) for p in (True, False)}
    launches["train"] = trains[True]["launches"]
    print(f"training images/s at b={TRAIN_B} [{card}]: kernels "
          f"{trains[True]['images_per_s']:.1f}, dense path "
          f"{trains[False]['images_per_s']:.1f}", flush=True)
    grads_in_model()
    launches["images"] = images_path(vae)

    kernels = kernel_lines(fwd_rows, fwd_worst, bwd_rows, bwd_worst, launches)
    print(f"kernel times: per launch, mean over the 4 CUB patterns; "
          f"flash_fwd at b=1 (the shared prefill; *_b16 at the train step), "
          f"the backward kernels at b={TRAIN_B} (the train step); their "
          f"plain_ms and library_ms (SDPA backward) compute dq, dk and dv "
          f"together; launches on the timed train steps", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
