"""The port's flash-attention backward (dalle_pytorch_tpu_torch.ops.
flash_attention) against the JAX package's: the plain backward against the
Pallas backward kernels in interpret mode and against jax.grad through the
custom VJP, and the autograd function against torch.autograd through the
plain forward.  Tiny geometry (b 2, 2 heads, n 22, dim_head 8, Pallas
blocks of 8), inputs drawn with numpy from a seed and handed to both
sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.ops import attention as jattn
from dalle_pytorch_tpu.ops import attention_pallas as jpallas
from dalle_pytorch_tpu_torch.ops import attention as tattn
from dalle_pytorch_tpu_torch.ops import flash_attention as tflash

VARIANTS = ("full", "axial_row", "axial_col", "conv_like", "sparse")
SEQ_LEN, TEXT_LEN, FMAP = 22, 7, 4
BLOCK = 8


def patterns(variant):
    args = dict(variant=variant, seq_len=SEQ_LEN, text_len=TEXT_LEN,
                fmap=FMAP)
    return jattn.AttnPattern(**args), tattn.AttnPattern(**args)


def inputs(with_bias, seed=1):
    """q, k, v, the output gradient g and the key-pad bias.  With the
    bias, sample 0 drops its first 3 keys, which leaves rows 0-2 fully
    masked, and sample 1 its last 4."""
    n = SEQ_LEN
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((2, 2, n, 8)).astype(np.float32)
                  for _ in range(4))
    bias = np.zeros((2, n), np.float32)
    if with_bias:
        bias[0, :3] = -1e30
        bias[1, n - 4:] = -1e30
    return q, k, v, g, bias


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# f32 throughout; the Pallas kernels sum block by block, the plain version
# in one pass, over at most 22 keys: errors seen ~1e-6
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_bwd_plain_matches_pallas_interpret(variant, with_bias):
    """dq, dk, dv of flash_pattern_attention_bwd_plain against
    ``_flash_bwd`` (which runs ``_call_bwd``'s two kernels in interpret
    mode), both from the Pallas forward's own o and lse."""
    jp, tp = patterns(variant)
    q, k, v, g, bias = inputs(with_bias)
    b, h, n, dh = q.shape
    o, res = jpallas._flash_fwd(jp, BLOCK, BLOCK, True, jnp.asarray(q),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias))
    want = jpallas._flash_bwd(jp, BLOCK, BLOCK, True, res, jnp.asarray(g))
    lse = np.asarray(res[-1])[:, 0, :n].reshape(b, h, n)
    got = tflash.flash_pattern_attention_bwd_plain(
        t(q), t(k), t(v), t(np.asarray(o)), t(lse), t(g), tp,
        t(bias) if with_bias else None)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want[:3]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL,
                                   err_msg=name)
    if with_bias:
        # fully masked rows and dropped keys get no gradient
        for gt in got:
            assert (gt.numpy()[0, :, :3] == 0).all()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_autograd_matches_jax_grad_of_pallas(variant, with_bias):
    """Grads of sum(o * g) through the port's autograd function (the plain
    forward and backward on the CPU) against jax.grad through the Pallas
    custom VJP in interpret mode."""
    jp, tp = patterns(variant)
    q, k, v, g, bias = inputs(with_bias, seed=2)

    def jloss(q, k, v):
        o = jpallas.flash_pattern_attention(
            q, k, v, jp, jnp.asarray(bias), block_q=BLOCK, block_k=BLOCK,
            interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    tflash.reset_launches()
    o = tflash.flash_pattern_attention(tq, tk, tv, tp,
                                       t(bias) if with_bias else None)
    (o * t(g)).sum().backward()
    assert all(c == 0 for c in tflash.LAUNCHES.values())
    for name, gt, wt in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                            want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_autograd_function_matches_autograd_of_plain_forward(variant,
                                                             with_bias):
    """The custom backward on CPU equals torch.autograd differentiating
    the plain forward itself, fully masked rows included.  Within 1e-5:
    the same f32 products, summed in other orders."""
    _, tp = patterns(variant)
    q, k, v, g, bias = inputs(with_bias, seed=3)
    key_bias = t(bias) if with_bias else None
    grads = []
    for fn in (tflash.flash_pattern_attention,
               tflash.flash_pattern_attention_plain):
        tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
        (fn(tq, tk, tv, tp, key_bias) * t(g)).sum().backward()
        grads.append((tq.grad, tk.grad, tv.grad))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_bwd_plain_keeps_q_dtype_and_lse_inf_rows_finite():
    """bf16 inputs give bf16 grads; a row with lse = +inf gives p = 0,
    never NaN."""
    _, tp = patterns("full")
    q, k, v, g, bias = inputs(True, seed=4)
    q, k, v, g = (t(a).bfloat16() for a in (q, k, v, g))
    o, lse = tflash.flash_pattern_attention_plain(q, k, v, tp, t(bias),
                                                  return_lse=True)
    assert torch.isinf(lse[0, :, :3]).all()
    grads = tflash.flash_pattern_attention_bwd_plain(q, k, v, o, lse, g, tp,
                                                     t(bias))
    for gt in grads:
        assert gt.dtype == torch.bfloat16
        assert torch.isfinite(gt.float()).all()
        assert (gt[0, :, :3] == 0).all()


def test_grad_path_never_falls_back_off_the_cpu():
    """A tensor that requires grad and is not on the CPU goes to the
    kernels or raises; the backward wrappers refuse CPU tensors before
    building anything."""
    _, tp = patterns("full")
    q = torch.randn(1, 2, SEQ_LEN, 64, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_pattern_attention(q, q, q, tp)
    c = torch.randn(1, 2, SEQ_LEN, 64)
    lse = torch.zeros(1, 2, SEQ_LEN)
    for fn in (tflash.launch_bwd_dq, tflash.launch_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(c, c, c, lse, lse, c, tp)
    assert tflash.LAUNCHES == {tflash.KERNEL: 0, tflash.KERNEL_DQ: 0,
                               tflash.KERNEL_DKV: 0}
