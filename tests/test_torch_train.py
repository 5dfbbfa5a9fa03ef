"""The port's train step (dalle_pytorch_tpu_torch.training) against the JAX
package's make_dalle_train_step: three steps from the same params and
batch, with and without the global-norm clip, the health dict, and a NaN
fault that must leave params and Adam state bitwise untouched.  Also the
images path against the codes path, and the copied schedules against the
JAX ones.  Tiny geometry, f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import DALLE as JDALLE
from dalle_pytorch_tpu import DALLEConfig as JDALLEConfig
from dalle_pytorch_tpu import training as jtraining
from dalle_pytorch_tpu.utils import schedule as jschedule
from dalle_pytorch_tpu_torch import (DALLE, DALLEConfig, DiscreteVAE,
                                     VAEConfig, training, weights)
from dalle_pytorch_tpu_torch.utils import schedule

VCFG = VAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
                 hidden_dim=8)
TYPES = ("full", "axial_row", "axial_col", "conv_like")
LR = 1e-3


def port_cfg(**kw):
    return DALLEConfig.from_vae(VCFG, dim=32, num_text_tokens=50,
                                text_seq_len=6, depth=4, heads=2, dim_head=8,
                                attn_types=TYPES, **kw)


def port_model(cfg, params):
    model = DALLE(cfg, device="cpu")
    model.load_state_dict(weights.dalle_state_dict_from_jax(params, cfg))
    return model


def batch(cfg):
    rng = np.random.default_rng(12)
    text = rng.integers(1, cfg.num_text_tokens, (2, cfg.text_seq_len))
    text[1, 3:] = 0
    codes = rng.integers(0, cfg.num_image_tokens, (2, cfg.image_seq_len))
    return text, codes


def leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


# After each step: losses within 1e-5 relative (f32 forward, other sum
# orders); params within 1e-5 absolute, a hundredth of the lr: Adam moves
# each weight by at most ~lr per step, and the update's own rounding and
# the grads' (errors below 1e-6 relative, tests/test_torch_loss.py) move it
# by far less; the health grad norm within 1e-5 relative.
LOSS_RTOL, PARAM_ATOL, NORM_RTOL = 1e-5, 1e-5, 1e-5


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_three_steps_match_jax(clip, use_pallas):
    """Losses, params after every step and the health dict.  clip 0.5 lies
    below the grads' norm (about 1), so the clip scales every step; the
    fourth step's NaN fault_scale is skipped on both sides."""
    cfg = port_cfg(use_pallas=use_pallas)
    params = weights.init_dalle_params(cfg, seed=7)
    text, codes = batch(cfg)
    jcfg = JDALLEConfig.from_dict(cfg.to_dict(), use_pallas=False)
    tx = jtraining.make_optimizer(LR, grad_clip_norm=clip)
    jstep = jtraining.make_dalle_train_step(JDALLE(jcfg), tx, donate=False,
                                            health=True)
    jparams = jax.tree.map(jnp.asarray, params["params"])
    opt_state = tx.init(jparams)
    model = port_model(cfg, params)
    opt = training.make_optimizer(model.parameters(), LR, grad_clip_norm=clip)
    step = training.make_dalle_train_step(model, opt, health=True)
    rng = jax.random.PRNGKey(0)
    for i, fault in enumerate((1.0, 1.0, 1.0, float("nan"))):
        jparams, opt_state, jloss, jhv = jstep(
            jparams, opt_state, None, jnp.asarray(text), jnp.asarray(codes),
            rng, jnp.float32(fault))
        loss, hv = step(torch.as_tensor(text), torch.as_tensor(codes), fault)
        assert float(hv["applied"]) == float(jhv["applied"]) == (i < 3)
        if i == 3:
            assert np.isnan(float(loss)) and np.isnan(float(jloss))
            assert np.isnan(float(hv["grad_norm"]))
        else:
            np.testing.assert_allclose(float(loss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            np.testing.assert_allclose(float(hv["loss"]), float(loss))
            np.testing.assert_allclose(float(hv["grad_norm"]),
                                       float(jhv["grad_norm"]),
                                       rtol=NORM_RTOL, err_msg=f"step {i}")
        want = leaves(jparams)
        got = leaves(weights.jax_params_from_dalle_state_dict(
            model.state_dict(), cfg)["params"])
        assert want.keys() == got.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"step {i} {key}")
    assert int(opt.count) == 3


@pytest.mark.parametrize("what", ["nan_loss", "inf_grad"])
def test_guard_leaves_state_bitwise_untouched(what):
    """A non-finite step (a NaN fault_scale, or an infinite gradient from a
    finite loss) leaves params, both moments and the step count bitwise as
    they were, and reports applied = 0; guard=False lets it through."""
    cfg = port_cfg()
    params = weights.init_dalle_params(cfg, seed=8)
    text, codes = (torch.as_tensor(a) for a in batch(cfg))
    model = port_model(cfg, params)
    opt = training.make_optimizer(model.parameters(), LR, grad_clip_norm=1.0)
    step = training.make_dalle_train_step(model, opt, health=True)
    step(text, codes)
    before = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
    if what == "nan_loss":
        loss, hv = step(text, codes, float("nan"))
    else:
        # an inf grad on the final norm's bias, finite loss
        hook = model.final_norm.bias.register_hook(
            lambda g: torch.full_like(g, float("inf")))
        loss, hv = step(text, codes)
        hook.remove()
        assert torch.isfinite(loss)
    assert float(hv["applied"]) == 0.0
    for a, b in zip(before, (opt.flat, opt.mu, opt.nu, opt.count)):
        assert torch.equal(a, b)
    params_now = torch.cat([p.detach().reshape(-1)
                            for p in model.parameters()])
    assert torch.equal(params_now, before[0])

    unguarded = training.make_dalle_train_step(model, opt, health=True,
                                               guard=False)
    _, hv = unguarded(text, codes, float("nan"))
    assert float(hv["applied"]) == 0.0
    assert int(opt.count) == 2 and torch.isnan(opt.flat).all()


@pytest.mark.parametrize("clip", [0.0, 5.0, 50.0])
def test_adam_and_clip_match_optax(clip):
    """Five updates of the port's Adam against optax's chain on the same
    gradients, whose norm (about 10) lies above the clip of 5 and below
    that of 50.  The clip is optax's clip_by_global_norm (grads untouched
    below the limit, scaled by limit / norm above; no 1e-6 added to the
    norm as clip_grad_norm_ does).  Params within 1e-7: the same f32
    element-wise ops, one rounding apart at most."""
    rng = np.random.default_rng(14)
    start = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) * 1.25
             for _ in range(5)]
    tx = jtraining.make_optimizer(LR, grad_clip_norm=clip)
    jp = jnp.asarray(start)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = training.make_optimizer([p], LR, grad_clip_norm=clip)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = jp + updates
        opt.update(torch.from_numpy(g))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="float32"):
        training.make_optimizer([torch.nn.Parameter(torch.zeros(2).bfloat16())],
                                1.0)


def test_set_learning_rate_takes_effect():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = training.make_optimizer([p], 1.0)
    assert training.set_learning_rate(opt, 0.25) is opt
    opt.update(torch.tensor([1.0, -2.0]))
    torch.testing.assert_close(p.detach(), torch.tensor([-0.25, 0.25]))


def test_images_path_equals_codes_path():
    """The step fed images encodes them with the frozen VAE: the same loss
    and the same params as the codes step fed get_codebook_indices, and
    the VAE is untouched."""
    cfg = port_cfg()
    params = weights.init_dalle_params(cfg, seed=9)
    vae = DiscreteVAE(VCFG, device="cpu")
    vae.load_state_dict(weights.vae_state_dict_from_jax(
        weights.init_vae_params(VCFG, seed=10), VCFG))
    vae_before = {k: v.clone() for k, v in vae.state_dict().items()}
    text, _ = batch(cfg)
    text = torch.as_tensor(text)
    images = torch.as_tensor(np.random.default_rng(13).random(
        (2, 16, 16, 3)).astype(np.float32))
    runs = []
    for use_vae in (True, False):
        model = port_model(cfg, params)
        opt = training.make_optimizer(model.parameters(), LR)
        step = training.make_dalle_train_step(
            model, opt, vae=vae if use_vae else None)
        data = images if use_vae else vae.get_codebook_indices(images)
        runs.append(([step(text, data) for _ in range(2)], opt.flat.clone()))
    (loss_a, flat_a), (loss_b, flat_b) = runs
    assert [float(x) for x in loss_a] == [float(x) for x in loss_b]
    assert torch.equal(flat_a, flat_b)
    for k, v in vae.state_dict().items():
        assert torch.equal(v, vae_before[k])


def test_schedules_match_jax():
    """The copied schedules step exactly as the JAX package's."""
    metrics = [5.0, 4.0, 4.0, 4.1, 4.0, 3.9996, 4.0, 4.0, 4.0, 4.0, 3.0,
               3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    for kw in ({}, {"patience": 1, "cooldown": 2, "factor": 0.1,
                    "min_lr": 1e-3}):
        ours = schedule.ReduceLROnPlateau(lr=0.01, **kw)
        theirs = jschedule.ReduceLROnPlateau(lr=0.01, **kw)
        assert [ours.step(m) for m in metrics] == [theirs.step(m)
                                                   for m in metrics]
        assert ours.state_dict() == theirs.state_dict()
        fresh = schedule.ReduceLROnPlateau(lr=1.0)
        fresh.load_state_dict(ours.state_dict())
        assert dataclasses.asdict(fresh) == ours.state_dict()
    ours, theirs = schedule.ExponentialDecay(0.1), jschedule.ExponentialDecay(0.1)
    assert [ours.step() for _ in range(50)] == [theirs.step()
                                                for _ in range(50)]
    ours = schedule.GumbelTemperature(anneal_rate=1e-3)
    theirs = jschedule.GumbelTemperature(anneal_rate=1e-3)
    steps = range(0, 5000, 100)
    assert [ours.update(s) for s in steps] == [theirs.update(s)
                                               for s in steps]
