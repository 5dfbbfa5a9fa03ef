"""The port's attention (dalle_pytorch_tpu_torch.ops) against the JAX
package's: pattern masks, decode key tables, the flash kernel's plain
version against the Pallas kernel in interpret mode, and the attention
layer's dense and flash paths.  Inputs are drawn with numpy from a seed
and handed to both sides."""
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
# (seq_len, text_len, fmap): the tiny test geometry and the CUB model's
SHAPES = {"tiny": (22, 7, 4), "cub": (1104, 81, 32)}


def patterns(variant, shape, **kw):
    seq_len, text_len, fmap = SHAPES[shape]
    args = dict(variant=variant, seq_len=seq_len, text_len=text_len,
                fmap=fmap, **kw)
    return jattn.AttnPattern(**args), tattn.AttnPattern(**args)


@pytest.mark.parametrize("shape", ["tiny", "cub"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_mask_equals_jax(variant, shape):
    """Exact equality, sparse's seeded random blocks included."""
    jp, tp = patterns(variant, shape)
    n = jp.seq_len
    np.testing.assert_array_equal(tattn.dense_pattern_mask(tp, n, n),
                                  jattn.dense_pattern_mask(jp, n, n))
    if variant == "sparse":
        np.testing.assert_array_equal(tp.block_layout(), jp.block_layout())


@pytest.mark.parametrize("shape", ["tiny", "cub"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_key_positions_equal_jax(variant, shape):
    """Exact equality of the candidate keys for every decode position
    (every 7th at the CUB shape, plus the raster's edges)."""
    jp, tp = patterns(variant, shape)
    n = jp.seq_len
    idx = range(n) if shape == "tiny" else sorted(
        set(range(0, n, 7)) | {jp.text_len - 1, jp.text_len, n - 1, n})
    for index in idx:
        got = tattn.decode_key_positions(tp, index)
        want = jattn.decode_key_positions(jp, index)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert got[2] == want[2]


def test_conv_like_dilated_decode_positions_equal_jax():
    jp, tp = patterns("conv_like", "tiny", kernel=3, dilation=2)
    for index in range(jp.seq_len + 1):
        got = tattn.decode_key_positions(tp, index)
        want = jattn.decode_key_positions(jp, index)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[2] == want[2] is False


@pytest.mark.parametrize("variant", VARIANTS)
def test_tile_summary_marks_exactly_live_tiles(variant):
    """bsum[qb, kb] == 1 iff the (ragged) tile holds an allowed pair."""
    _, tp = patterns(variant, "cub")
    n = tp.seq_len
    mask, bsum = tflash._pattern_blocks(tp, n)
    bq, bk = tflash.BLOCK_Q, tflash.BLOCK_K
    assert bsum.shape == (-(-n // bq), -(-n // bk))
    for qb in range(bsum.shape[0]):
        for kb in range(bsum.shape[1]):
            live = mask[qb * bq:(qb + 1) * bq, kb * bk:(kb + 1) * bk].any()
            assert bsum[qb, kb] == int(live)


def _jax_flash(q, k, v, pattern, bias, block):
    """JAX flash forward in interpret mode -> (o, lse [b, h, n])."""
    b, h, n, dh = q.shape
    o, res = jpallas._flash_fwd(pattern, block, block, True, jnp.asarray(q),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(bias))
    lse = np.asarray(res[-1])[:, 0, :n].reshape(b, h, n)
    return np.asarray(o), lse


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_flash_plain_matches_jax_interpret(variant, with_bias):
    """o and lse of the plain version against the Pallas kernel, f32.
    With the bias, sample 0 drops the first 3 keys, which leaves rows 0-2
    fully masked (o = 0, lse = +inf on both sides).  Tolerance 2e-5: the
    kernel accumulates its online softmax block by block, the plain
    version in one pass; both in f32 over at most 22 keys."""
    jp, tp = patterns(variant, "tiny")
    n = jp.seq_len
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 2, n, 8)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((2, n), np.float32)
    if with_bias:
        bias[0, :3] = -1e30
        bias[1, n - 4:] = -1e30
    o_ref, lse_ref = _jax_flash(q, k, v, jp, bias, block=8)
    o, lse = tflash.flash_pattern_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tp,
        key_pad_bias=torch.from_numpy(bias) if with_bias else None,
        return_lse=True)
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(lse_ref))
    fin = np.isfinite(lse_ref)
    np.testing.assert_allclose(lse.numpy()[fin], lse_ref[fin], rtol=2e-5,
                               atol=2e-5)
    if with_bias:
        assert np.isinf(lse_ref[0, :, :3]).all()
        assert (o.numpy()[0, :, :3] == 0).all()


def test_flash_wrapper_takes_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; any other
    device is checked before a launch and refused."""
    _, tp = patterns("full", "tiny")
    q = torch.randn(1, 2, tp.seq_len, 64)
    tflash.reset_launches()
    out = tflash.flash_pattern_attention(q, q, q, tp)
    assert out.shape == q.shape and tflash.LAUNCHES[tflash.KERNEL] == 0
    meta = q.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_pattern_attention(meta, meta, meta, tp)


def _mha_pair(variant, use_pallas):
    """A JAX attention layer and the port's, with the same weights."""
    jp, tp = patterns(variant, "tiny")
    dim, heads, dh = 32, 2, 8
    rng = np.random.default_rng(2)
    w_qkv = (rng.standard_normal((dim, 3, heads, dh)) / np.sqrt(dim)
             ).astype(np.float32)
    w_out = (rng.standard_normal((heads * dh, dim)) / 4).astype(np.float32)
    b_out = rng.standard_normal((dim,)).astype(np.float32)
    jmha = jattn.MultiHeadAttention(pattern=jp, dim=dim, heads=heads,
                                    dim_head=dh, use_pallas=use_pallas,
                                    pallas_block_q=8, pallas_block_k=8)
    params = {"params": {"to_qkv": {"kernel": jnp.asarray(w_qkv)},
                         "to_out": {"kernel": jnp.asarray(w_out),
                                    "bias": jnp.asarray(b_out)}}}
    tmha = tattn.MultiHeadAttention(tp, dim=dim, heads=heads, dim_head=dh,
                                    use_pallas=use_pallas, device="cpu")
    tmha.load_state_dict({
        "to_qkv.weight": torch.from_numpy(w_qkv.reshape(dim, -1).T.copy()),
        "to_out.weight": torch.from_numpy(w_out.T.copy()),
        "to_out.bias": torch.from_numpy(b_out)})
    x = rng.standard_normal((2, jp.seq_len, dim)).astype(np.float32)
    key_mask = np.ones((2, 7), bool)
    key_mask[1, 2:5] = False
    return jmha, params, tmha, x, key_mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_attention_layer_matches_jax(variant, use_pallas):
    """MultiHeadAttention forward (with return_kv and a key-pad mask)
    against the JAX layer, dense path against dense, flash path against
    the Pallas interpreter.  Tolerance 1e-5: f32 throughout, sums of at
    most 22 terms reduced in different orders."""
    jmha, params, tmha, x, key_mask = _mha_pair(variant, use_pallas)
    j_out, (jk, jv) = jmha.apply(params, jnp.asarray(x),
                                 mask=jnp.asarray(key_mask), return_kv=True)
    t_out, (tk, tv) = tmha(torch.from_numpy(x),
                           mask=torch.from_numpy(key_mask), return_kv=True)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=1e-5, atol=1e-5)
