"""The port's DALLE training loss and its gradients against the JAX
package's, at the tiny geometry of tests/test_torch_dalle.py, in f32, on
the same numpy weights: every gradient compared leaf by leaf under its JAX
name (weights.jax_params_from_dalle_state_dict).  Also the parameter
precision: every parameter f32 whatever the activation dtype, and an exact
bridge round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import DALLE as JDALLE
from dalle_pytorch_tpu import DALLEConfig as JDALLEConfig
from dalle_pytorch_tpu_torch import DALLE, DALLEConfig, VAEConfig, weights

VCFG = VAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
                 hidden_dim=8)
TYPES = ("full", "axial_row", "axial_col", "conv_like")


def port_cfg(**kw):
    return DALLEConfig.from_vae(VCFG, dim=32, num_text_tokens=50,
                                text_seq_len=6, depth=4, heads=2, dim_head=8,
                                attn_types=TYPES, **kw)


def jax_cfg(cfg: DALLEConfig, **plan) -> JDALLEConfig:
    plan.setdefault("head_phase_sliced", cfg.head_phase_sliced)
    return JDALLEConfig.from_dict(cfg.to_dict(), **plan)


def port_model(cfg, params):
    model = DALLE(cfg, device="cpu")
    model.load_state_dict(weights.dalle_state_dict_from_jax(params, cfg))
    return model


def batch(cfg):
    """Two prompts with pad ids (0), so the unique-pad remap reaches the
    text labels, their key-pad mask, and image codes."""
    rng = np.random.default_rng(11)
    text = rng.integers(1, cfg.num_text_tokens, (2, cfg.text_seq_len))
    text[0, 4:] = 0
    codes = rng.integers(0, cfg.num_image_tokens, (2, cfg.image_seq_len))
    return text, codes, text != 0


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


def port_grads(model, cfg):
    """The model's parameter grads as a JAX-layout tree."""
    return weights.jax_params_from_dalle_state_dict(
        {name: p.grad for name, p in model.named_parameters()}, cfg)


@pytest.fixture(scope="module")
def params():
    return weights.init_dalle_params(port_cfg(), seed=4)


def test_parameters_stay_f32_at_bf16():
    """Every parameter is f32 at dtype=bfloat16, as in the JAX tree, and
    bridge -> port -> jax_params_from_dalle_state_dict is bit-exact."""
    cfg = port_cfg(dtype=torch.bfloat16)
    params = weights.init_dalle_params(cfg, seed=2)
    model = port_model(cfg, params)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    np.testing.assert_array_equal(
        model.state_dict()["transformer.attn_blocks.0.attn.to_qkv.weight"],
        params["params"]["transformer"]["layers_0_attn"]["attn"]["to_qkv"][
            "kernel"].reshape(cfg.dim, -1).T)
    back = weights.jax_params_from_dalle_state_dict(model.state_dict(), cfg)
    want, got = leaves(params), leaves(back)
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_inverse_bridge_raises_on_unconsumed_keys(params):
    cfg = port_cfg()
    sd = weights.dalle_state_dict_from_jax(params, cfg)
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="extra.weight"):
        weights.jax_params_from_dalle_state_dict(sd, cfg)


# Loss within 1e-5 relative and each grad within 1e-5 of its leaf's
# largest entry: f32 throughout, the same sums in other orders (XLA:CPU
# and torch) through 4 layers; errors seen below 1e-6 of the largest entry.
LOSS_RTOL, GRAD_REL = 1e-5, 1e-5

CASES = {
    "dense": {},
    "flash": {"use_pallas": True},
    "full_head": {"head_phase_sliced": False},
    "onehot": {"onehot_embed": True},
    "remat": {"use_remat": True},
    "dense_mask": {"mask": True},
    "flash_mask": {"use_pallas": True, "mask": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(params, case):
    """Loss and every gradient against ``dalle.apply(..., return_loss=True)``
    and ``jax.grad``.  The port's flash path (the plain versions on the
    CPU) is held against the JAX dense path: no row is fully masked (every
    query sees <bos> and itself), so the two attention paths agree."""
    kw = dict(CASES[case])
    with_mask = kw.pop("mask", False)
    cfg = port_cfg(**kw)
    jcfg = jax_cfg(cfg, use_pallas=False)
    text, codes, mask = batch(cfg)
    jmask = jnp.asarray(mask) if with_mask else None
    jdalle = JDALLE(jcfg)

    def jloss(p):
        return jdalle.apply({"params": p}, jnp.asarray(text),
                            jnp.asarray(codes), mask=jmask, return_loss=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        params["params"])
    model = port_model(cfg, params)
    loss = model(torch.as_tensor(text), torch.as_tensor(codes),
                 mask=torch.as_tensor(mask) if with_mask else None,
                 return_loss=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    want, got = leaves({"params": want_grads}), leaves(port_grads(model, cfg))
    assert want.keys() == got.keys()
    for key in want:
        scale = max(np.abs(want[key]).max(), 1e-12)
        err = np.abs(got[key] - want[key]).max() / scale
        assert err <= GRAD_REL, f"{key}: rel err {err:.2e}"


def test_remat_grads_equal_plain_grads(params):
    """torch.utils.checkpoint recomputes each block in the backward: the
    same CPU ops on the same inputs, so the same loss and grads."""
    text, codes, _ = batch(port_cfg())
    got = []
    for remat in (False, True):
        cfg = port_cfg(use_remat=remat, use_pallas=True)
        model = port_model(cfg, params)
        loss = model(torch.as_tensor(text), torch.as_tensor(codes),
                     return_loss=True)
        loss.backward()
        got.append((loss.item(), leaves(port_grads(model, cfg))))
    assert got[0][0] == got[1][0]
    for key, a in got[0][1].items():
        np.testing.assert_allclose(got[1][1][key], a, rtol=1e-6, atol=1e-9,
                                   err_msg=key)


def test_logits_forward_matches_jax(params):
    """forward without the loss: joint logits with the wrong-phase half at
    the most negative f32, within 1e-4 (f32, other sum orders)."""
    cfg = port_cfg()
    text, codes, _ = batch(cfg)
    want = JDALLE(jax_cfg(cfg)).apply(params, jnp.asarray(text),
                                      jnp.asarray(codes))
    got = port_model(cfg, params)(torch.as_tensor(text),
                                  torch.as_tensor(codes))
    assert got.shape == want.shape == (2, cfg.seq_len, cfg.total_tokens)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_dropout_only_in_training_mode():
    """attn/ff dropout changes the training loss of a module in training
    mode and nothing in eval mode or in prefill."""
    cfg = port_cfg(attn_dropout=0.5, ff_dropout=0.5)
    params = weights.init_dalle_params(cfg, seed=5)
    model = port_model(cfg, params)
    ref = port_model(port_cfg(), params)
    text, codes, _ = batch(cfg)
    text, codes = torch.as_tensor(text), torch.as_tensor(codes)
    torch.manual_seed(0)
    assert model(text, codes, return_loss=True) != ref(text, codes,
                                                       return_loss=True)
    model.eval()
    assert model(text, codes, return_loss=True) == ref(text, codes,
                                                       return_loss=True)
    model.train()
    a, _ = model.prefill(text)
    b, _ = ref.prefill(text)
    assert torch.equal(a, b)
