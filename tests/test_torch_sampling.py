"""The port's sampling filters and sampler against the JAX package's, on
logits and Gumbel noise drawn with numpy or jax and handed to both sides:
the two frameworks' generators draw different numbers, so the sampled
codes are compared under the same injected noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import sample_image_code as j_sample
from dalle_pytorch_tpu.utils import helpers as jh
from dalle_pytorch_tpu_torch.models.dalle import sample_image_code
from dalle_pytorch_tpu_torch.utils import helpers as th


def logits(shape=(4, 64), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k_vocab", [None, 100, 200])
@pytest.mark.parametrize("thres", [0.0, 0.5, 0.9, 0.999])
def test_top_k_filter_matches_jax(thres, k_vocab):
    """Exact: the same entries survive, unchanged, the rest are -inf."""
    x = logits()
    got = th.top_k_filter(torch.from_numpy(x), thres=thres, k_vocab=k_vocab)
    want = jh.top_k_filter(jnp.asarray(x), thres=thres, k_vocab=k_vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.75, 0.95, 1.0])
def test_top_p_filter_matches_jax(p):
    """Same kept set.  The logits are spread wide enough that no token's
    mass-before lands within f32 rounding of p."""
    x = logits(seed=1) * 3
    got = th.top_p_filter(torch.from_numpy(x), p)
    want = jh.top_p_filter(jnp.asarray(x), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_filter_semantics():
    x = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    out = th.top_p_filter(x, 0.75)  # 0.5 + 0.3 crosses 0.75
    assert torch.isfinite(out[0, :2]).all() and torch.isinf(out[0, 2:]).all()
    out1 = th.top_p_filter(x, 0.4)  # the top token is always kept
    assert torch.isfinite(out1[0, 0]) and torch.isinf(out1[0, 1:]).all()
    with pytest.raises(ValueError):
        th.top_p_filter(x, 0.0)


@pytest.mark.parametrize("top_p", [None, 0.8])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sample_image_code_matches_jax_under_same_noise(temperature, top_p):
    """jax.random.categorical draws argmax(logits + gumbel(key)); handing
    the port that gumbel noise must give the same codes."""
    x = logits((8, 32), seed=2) * 2
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_sample(jnp.asarray(x), key, k_vocab=80,
                               filter_thres=0.7, temperature=temperature,
                               top_p=top_p))
    gumbel = np.array(jax.random.gumbel(key, x.shape, jnp.float32))
    got = sample_image_code(torch.from_numpy(x), k_vocab=80, filter_thres=0.7,
                            temperature=temperature, top_p=top_p,
                            gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_image_code_draws_inside_the_filter():
    """With its own generator the sampler only ever picks surviving
    tokens, and the generator's seed fixes the draw."""
    x = torch.from_numpy(logits((256, 40), seed=4))
    kept = torch.isfinite(th.top_k_filter(x, thres=0.9, k_vocab=40))
    codes = sample_image_code(x, torch.Generator().manual_seed(0), k_vocab=40,
                              filter_thres=0.9)
    assert kept.gather(1, codes[:, None]).all()
    again = sample_image_code(x, torch.Generator().manual_seed(0), k_vocab=40,
                              filter_thres=0.9)
    assert torch.equal(codes, again)
