"""The port's DALLE (dalle_pytorch_tpu_torch.models.dalle) against the JAX
package's at the tiny geometry of tests/test_dalle.py: config round trip,
the weight bridge, prefill logits and caches, teacher-forced decode
logits, and the chunked generation entry.  Both sides run the same numpy
weights (weights.init_dalle_params)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import DALLE as JDALLE
from dalle_pytorch_tpu import DALLEConfig as JDALLEConfig
from dalle_pytorch_tpu_torch import DALLE, DALLEConfig, VAEConfig, cli, weights
from dalle_pytorch_tpu_torch.models import dalle as tdalle

VCFG = VAEConfig(image_size=16, num_tokens=32, codebook_dim=16, num_layers=2,
                 hidden_dim=8)
TYPES = ("full", "axial_row", "axial_col", "conv_like")


def port_cfg(**kw):
    return DALLEConfig.from_vae(VCFG, dim=32, num_text_tokens=50,
                                text_seq_len=6, depth=4, heads=2, dim_head=8,
                                attn_types=TYPES, **kw)


def jax_cfg(cfg: DALLEConfig) -> JDALLEConfig:
    plan = {f: getattr(cfg, f) for f in ("sliced_kv_decode", "kv_cache_bf16")}
    return JDALLEConfig.from_dict(cfg.to_dict(), **plan)


def port_model(cfg, params):
    model = DALLE(cfg, device="cpu")
    model.load_state_dict(weights.dalle_state_dict_from_jax(params, cfg))
    return model


def text_tokens():
    """Two prompts with pad ids (0) so the unique-pad remap is exercised."""
    t = np.random.default_rng(3).integers(1, 50, (2, 6))
    t[0, 4:] = 0
    return t


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_bf16_ulp(got, want):
    """The two sides round f32 values that differ in the last f32 bits to
    bf16, so an element may land on the neighbouring bf16 value."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 bf16_ulp(np.maximum(np.abs(got),
                                                     np.abs(want))) * 1.0001)


def to_np(t):
    return t.float().numpy()


def test_config_round_trips_jax_hparams():
    """to_dict/from_dict round-trip the JAX checkpoint hparams both ways."""
    jcfg = JDALLEConfig(dim=256, num_text_tokens=7800, text_seq_len=80,
                        depth=8, attn_types=TYPES, num_image_tokens=8192,
                        image_fmap_size=32, use_pallas=True, loss_img_weight=5)
    d = jcfg.to_dict()
    cfg = DALLEConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert JDALLEConfig.from_dict(cfg.to_dict()).to_dict() == d
    assert set(DALLEConfig._PLAN_FIELDS) == set(JDALLEConfig._PLAN_FIELDS)
    assert ({f.name for f in dataclasses.fields(DALLEConfig)}
            == {f.name for f in dataclasses.fields(JDALLEConfig)})
    assert (cfg.seq_len, cfg.total_tokens) == (jcfg.seq_len, jcfg.total_tokens)


def test_numpy_init_tree_has_the_jax_layout():
    """init_dalle_params builds exactly the tree flax's DALLE.init builds."""
    cfg = port_cfg()
    jdalle = JDALLE(jax_cfg(cfg))
    text = jnp.ones((1, cfg.text_seq_len), jnp.int32)
    codes = jnp.zeros((1, cfg.image_seq_len), jnp.int32)
    shapes = jax.eval_shape(lambda: jdalle.init(jax.random.PRNGKey(0), text,
                                                codes, return_loss=True))
    ours = weights.init_dalle_params(cfg)
    assert (jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, ours))
            == jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, shapes)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_bridge_consumes_every_key():
    cfg = port_cfg()
    params = weights.init_dalle_params(cfg)
    sd = weights.dalle_state_dict_from_jax(params, cfg)
    model = DALLE(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict: no missing or unexpected keys
    params["params"]["transformer"]["layers_0_attn"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="layers_0_attn/extra"):
        weights.dalle_state_dict_from_jax(params, cfg)
    del params["params"]["final_norm"]["scale"]
    with pytest.raises(KeyError, match="final_norm/scale"):
        weights.dalle_state_dict_from_jax(params, cfg)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        DALLE(port_cfg(reversible=True), device="cpu")
    with pytest.raises(NotImplementedError):
        DALLE(port_cfg(kv_cache_int8=True), device="cpu")


@pytest.fixture(scope="module")
def params():
    return weights.init_dalle_params(port_cfg(), seed=4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_jax(params, use_pallas):
    """Last-position logits and every layer's caches.  Logits within 1e-4:
    f32 activations, sums reduced in other orders by XLA:CPU and torch
    (errors seen ~1e-6).  Caches are stored bf16 (kv_cache_bf16), so
    within one bf16 ulp."""
    cfg = port_cfg(use_pallas=use_pallas)
    jdalle = JDALLE(jax_cfg(cfg))
    text = text_tokens()
    j_logits, j_caches = jax.jit(
        lambda p, t: jdalle.apply(p, t, method=JDALLE.prefill))(
            params, jnp.asarray(text))
    t_logits, t_caches = port_model(cfg, params).prefill(
        torch.as_tensor(text))
    np.testing.assert_allclose(to_np(t_logits), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    assert len(t_caches) == len(j_caches) == cfg.depth
    for (tk, tv), (jk, jv) in zip(t_caches, j_caches):
        assert tk.dtype == torch.bfloat16 and jk.dtype == jnp.bfloat16
        assert_within_bf16_ulp(to_np(tk), jk)
        assert_within_bf16_ulp(to_np(tv), jv)


def _jax_decode(jdalle):
    return jax.jit(lambda p, c, caches, i: jdalle.apply(
        p, c, caches, i, method=JDALLE.decode_step))


@pytest.mark.parametrize("kv_cache_bf16", [True, False])
@pytest.mark.parametrize("sliced", [True, False])
def test_teacher_forced_decode_matches_jax(params, sliced, kv_cache_bf16):
    """Decode logits at every image position with the same codes fed on
    both sides, each side running its own prefill and caches.

    f32 caches: logits within 1e-4 (f32 reduction order).  bf16 caches
    (the default): each side rounds its own f32 k/v and q to bf16, so an
    element may differ by one bf16 ulp (2^-8 relative); through softmax
    and the head that moves a logit by well under 2e-3 here, and the
    caches stay within one ulp after every step."""
    cfg = port_cfg(sliced_kv_decode=sliced, kv_cache_bf16=kv_cache_bf16)
    jdalle = JDALLE(jax_cfg(cfg))
    text = text_tokens()
    codes = np.random.default_rng(5).integers(0, cfg.num_image_tokens,
                                              (2, cfg.image_seq_len))
    _, j_caches = jax.jit(lambda p, t: jdalle.apply(
        p, t, method=JDALLE.prefill))(params, jnp.asarray(text))
    model = port_model(cfg, params)
    _, t_caches = model.prefill(torch.as_tensor(text))
    step = _jax_decode(jdalle)
    tol = 2e-3 if kv_cache_bf16 else 1e-4
    n_pre = cfg.text_seq_len + 1
    for pos in range(cfg.image_seq_len - 1):
        index = n_pre + pos
        j_logits, j_caches = step(params, jnp.asarray(codes[:, pos]),
                                  j_caches, index)
        t_logits, t_caches = model.decode_step(
            torch.as_tensor(codes[:, pos]), t_caches, index)
        np.testing.assert_allclose(to_np(t_logits), np.asarray(j_logits),
                                   rtol=tol, atol=tol, err_msg=f"pos {pos}")
    for (tk, tv), (jk, jv) in zip(t_caches, j_caches):
        if kv_cache_bf16:
            assert_within_bf16_ulp(to_np(tk), jk)
            assert_within_bf16_ulp(to_np(tv), jv)
        else:
            np.testing.assert_allclose(to_np(tk), np.asarray(jk), atol=1e-5)


def test_decode_step_on_shared_caches_matches_jax(params):
    """The port's decode step fed the JAX prefill's own bf16 caches, so
    only the step's arithmetic differs: within 1e-4 except where q's bf16
    rounding flips (each side rounds its own f32 q), hence 1e-3."""
    cfg = port_cfg()
    jdalle = JDALLE(jax_cfg(cfg))
    text = text_tokens()
    _, j_caches = jax.jit(lambda p, t: jdalle.apply(
        p, t, method=JDALLE.prefill))(params, jnp.asarray(text))
    t_caches = [(torch.from_numpy(np.asarray(k, np.float32)).bfloat16(),
                 torch.from_numpy(np.asarray(v, np.float32)).bfloat16())
                for k, v in j_caches]
    model = port_model(cfg, params)
    index = cfg.text_seq_len + 1 + 5
    code = np.array([3, 17])
    j_logits, _ = _jax_decode(jdalle)(params, jnp.asarray(code), j_caches,
                                      index)
    t_logits, _ = model.decode_step(torch.as_tensor(code), t_caches, index)
    np.testing.assert_allclose(to_np(t_logits), np.asarray(j_logits),
                               rtol=1e-3, atol=1e-3)


def test_tile_prefill_equals_batched_prefill(params):
    cfg = port_cfg()
    model = port_model(cfg, params)
    text = torch.as_tensor(text_tokens()[:1])
    fl1, c1 = tdalle.prefill_codes(model, text)
    flt, ct = tdalle.tile_prefill(fl1, c1, 3)
    fln, cn = tdalle.prefill_codes(model, text.repeat(3, 1))
    torch.testing.assert_close(flt, fln, rtol=1e-5, atol=1e-5)
    for (kt, vt), (kn, vn) in zip(ct, cn):
        assert_within_bf16_ulp(to_np(kt), to_np(kn))
        assert_within_bf16_ulp(to_np(vt), to_np(vn))
    with pytest.raises(ValueError):
        tdalle.tile_prefill(fln, cn, 2)


def test_decode_codes_leaves_its_input_caches_alone(params):
    cfg = port_cfg()
    model = port_model(cfg, params)
    fl, caches = tdalle.prefill_codes(model, torch.as_tensor(text_tokens()))
    before = [k.clone() for k, _ in caches]
    g = torch.Generator().manual_seed(0)
    codes = tdalle.decode_codes(model, fl, caches, g, filter_thres=0.9)
    assert codes.shape == (2, cfg.image_seq_len)
    for b, (k, _) in zip(before, caches):
        assert torch.equal(b, k)


def test_generate_chunked_shapes_and_shared_prefill(params, monkeypatch):
    """A repeated prompt prefills once and tiles its caches; distinct
    prompts take one generate_codes per (padded) chunk."""
    cfg = port_cfg(use_pallas=True)
    model = port_model(cfg, params)
    calls = {"prefill": 0, "full": 0}
    real_prefill, real_gen = cli.prefill_codes, cli.generate_codes

    def counting_prefill(*a, **k):
        calls["prefill"] += 1
        return real_prefill(*a, **k)

    def counting_gen(*a, **k):
        calls["full"] += 1
        return real_gen(*a, **k)

    monkeypatch.setattr(cli, "prefill_codes", counting_prefill)
    monkeypatch.setattr(cli, "generate_codes", counting_gen)
    seen = []

    def decode(codes):
        seen.append(codes)
        return torch.zeros((codes.shape[0], 4, 4, 3))

    g = torch.Generator().manual_seed(0)
    tokens = np.repeat(text_tokens()[:1], 5, axis=0)
    images = cli.generate_chunked(model, decode, tokens, batch_size=2,
                                  top_k=0.9, generator=g)
    assert images.shape == (5, 4, 4, 3)
    assert calls == {"prefill": 1, "full": 0}
    for codes in seen:
        assert codes.shape == (2, cfg.image_seq_len)
        assert codes.min() >= 0 and codes.max() < cfg.num_image_tokens

    images2 = cli.generate_chunked(model, decode, np.concatenate(
        [text_tokens(), text_tokens()[:1] + 1]), batch_size=2, top_k=0.9,
        generator=g)
    assert images2.shape == (3, 4, 4, 3)
    assert calls["full"] == 2


def test_greedy_generation_matches_jax(params):
    """Greedy sampling (k = 1) leaves no randomness: the port's generated
    codes equal the JAX package's.  f32 caches, so no bf16 rounding flip
    can change an argmax between the two sides."""
    cfg = port_cfg(kv_cache_bf16=False)
    jdalle = JDALLE(jax_cfg(cfg))
    text = text_tokens()
    thres = 1.0 - 1.0 / cfg.total_tokens
    from dalle_pytorch_tpu.models.dalle import generate_codes as jgen
    want = np.asarray(jax.jit(lambda p, t: jgen(
        jdalle, p, t, jax.random.PRNGKey(0), filter_thres=thres))(
            params, jnp.asarray(text)))
    got = tdalle.generate_codes(port_model(cfg, params), torch.as_tensor(text),
                                torch.Generator().manual_seed(0),
                                filter_thres=thres)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bf16_matmul", [False, True])
def test_phase_logits_match_jax(bf16_matmul):
    """The per-phase head, joint and image-only, f32 or bf16 inputs with
    f32 accumulation.  Within 1e-5: dots of 32 terms in other orders."""
    from dalle_pytorch_tpu.models.dalle import PhaseLogits as JPhaseLogits

    rng = np.random.default_rng(8)
    dim, total_text, total = 32, 56, 88
    p = {"text_kernel": rng.standard_normal((dim, total_text)),
         "text_bias": rng.standard_normal((total_text,)),
         "image_kernel": rng.standard_normal((dim, total - total_text)),
         "image_bias": rng.standard_normal((total - total_text,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, dim)).astype(np.float32)
    head = tdalle.PhaseLogits(dim, total_text, total, bf16_matmul=bf16_matmul)
    head.load_state_dict({
        "text.weight": torch.from_numpy(p["text_kernel"].T.copy()),
        "text.bias": torch.from_numpy(p["text_bias"]),
        "image.weight": torch.from_numpy(p["image_kernel"].T.copy()),
        "image.bias": torch.from_numpy(p["image_bias"])})
    jhead = JPhaseLogits(total_text, total, bf16_matmul=bf16_matmul)
    for image_only in (False, True):
        want = jhead.apply({"params": p}, jnp.asarray(x), image_only=image_only)
        got = head(torch.from_numpy(x), image_only=image_only)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
