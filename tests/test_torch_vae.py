"""The port's dVAE (dalle_pytorch_tpu_torch.models.vae) against the JAX
package's DiscreteVAE: decode, the encoder's logits and the codebook
indices, with and without resblocks, on the same numpy weights
(weights.init_vae_params)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import DiscreteVAE as JVAE
from dalle_pytorch_tpu import VAEConfig as JVAEConfig
from dalle_pytorch_tpu_torch import DiscreteVAE, VAEConfig, weights


def configs(resblocks):
    kw = dict(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
              hidden_dim=8, num_resnet_blocks=resblocks)
    return JVAEConfig(**kw), VAEConfig(**kw)


@pytest.mark.parametrize("resblocks", [0, 2])
def test_decode_matches_jax(resblocks):
    """Images within 1e-5: f32 convolutions summed in other orders."""
    jcfg, cfg = configs(resblocks)
    params = weights.init_vae_params(cfg, seed=6)
    codes = np.random.default_rng(7).integers(0, cfg.num_tokens,
                                              (2, cfg.image_seq_len))
    want = np.asarray(JVAE(jcfg).apply(params, jnp.asarray(codes),
                                       method=JVAE.decode))
    vae = DiscreteVAE(cfg, device="cpu")
    vae.load_state_dict(weights.vae_state_dict_from_jax(params, cfg))
    got = vae.decode(torch.as_tensor(codes)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("resblocks", [0, 2])
def test_numpy_init_tree_has_the_jax_layout(resblocks):
    """init_vae_params builds exactly flax's tree, encoder included, and
    the bridge consumes every key of it and raises on any other."""
    jcfg, cfg = configs(resblocks)
    img = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(lambda: JVAE(jcfg).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        img))["params"]
    ours = weights.init_vae_params(cfg)["params"]
    assert set(shapes) == set(ours) == {"codebook", "encoder", "decoder"}
    assert (jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, ours))
            == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, shapes)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(shapes)):
        assert a.shape == b.shape

    sd = weights.vae_state_dict_from_jax({"params": ours}, cfg)
    vae = DiscreteVAE(cfg, device="cpu")
    assert set(sd) == set(vae.state_dict())
    vae.load_state_dict(sd)
    for sub in ("decoder", "encoder"):
        bad = dict(ours)
        bad[sub] = dict(bad[sub], Extra_0={"kernel": np.zeros(1)})
        with pytest.raises(ValueError, match=f"{sub}/Extra_0"):
            weights.vae_state_dict_from_jax(bad, cfg)


def _images(seed):
    return np.random.default_rng(seed).random((2, 16, 16, 3)).astype(
        np.float32)


@pytest.mark.parametrize("resblocks", [0, 2])
def test_encoder_and_codebook_indices_match_jax(resblocks):
    """encode_logits (NHWC, f32 head) within 1e-5: f32 convolutions summed
    in other orders.  get_codebook_indices equal: their argmax, with no
    near-tie closer than that in these logits."""
    jcfg, cfg = configs(resblocks)
    params = weights.init_vae_params(cfg, seed=8)
    img = _images(9)
    jvae = JVAE(jcfg)
    want_logits = np.asarray(jvae.apply(params, jnp.asarray(img),
                                        method=JVAE.encode_logits))
    want_codes = np.asarray(jvae.apply(params, jnp.asarray(img),
                                       method=JVAE.get_codebook_indices))
    vae = DiscreteVAE(cfg, device="cpu")
    vae.load_state_dict(weights.vae_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        logits = vae.encode_logits(torch.as_tensor(img))
        codes = vae.get_codebook_indices(torch.as_tensor(img))
    assert logits.shape == want_logits.shape == (2, 4, 4, cfg.num_tokens)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)
    assert codes.shape == (2, cfg.image_seq_len)
    np.testing.assert_array_equal(codes.numpy(), want_codes)


def test_norm_matches_jax():
    jcfg, cfg = configs(0)
    img = _images(10)
    want = JVAE(jcfg).apply(weights.init_vae_params(cfg), jnp.asarray(img),
                            method=JVAE.norm)
    got = DiscreteVAE(cfg, device="cpu").norm(torch.as_tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
