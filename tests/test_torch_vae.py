"""The port's dVAE decode (dalle_pytorch_tpu_torch.models.vae) against the
JAX package's DiscreteVAE.decode, with and without resblocks, on the same
numpy weights (weights.init_vae_params)."""
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
    """init_vae_params builds flax's tree minus the encoder, and the bridge
    drops the encoder of a full tree by name only."""
    jcfg, cfg = configs(resblocks)
    img = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(lambda: JVAE(jcfg).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        img))["params"]
    ours = weights.init_vae_params(cfg)["params"]
    assert set(shapes) == set(ours) | {"encoder"}
    shapes = dict(shapes)
    encoder = shapes.pop("encoder")
    assert (jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, ours))
            == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, shapes)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(shapes)):
        assert a.shape == b.shape

    full = dict(ours, encoder=jax.tree.map(lambda s: np.zeros(s.shape),
                                           encoder))
    sd = weights.vae_state_dict_from_jax({"params": full}, cfg)
    vae = DiscreteVAE(cfg, device="cpu")
    assert set(sd) == set(vae.state_dict())
    vae.load_state_dict(sd)
    full["decoder"] = dict(full["decoder"], Extra_0={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="decoder/Extra_0"):
        weights.vae_state_dict_from_jax(full, cfg)
