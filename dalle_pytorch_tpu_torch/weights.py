"""Weight bridge from the JAX package's param trees to this package.

``dalle_state_dict_from_jax`` and ``vae_state_dict_from_jax`` take a flax
param tree as nested dicts of numpy arrays (``{"params": ...}`` or the
tree itself) and return the ``state_dict`` of this package's ``DALLE`` /
``DiscreteVAE``.  Both consume the tree key by key and raise on any key
left over, so a layout change on either side fails loudly.
``jax_params_from_dalle_state_dict`` is the inverse for DALLE: a
``state_dict`` back to the JAX tree, exact on a round trip, so that
trained weights and gradients compare leaf by leaf under JAX names.

``init_dalle_params`` and ``init_vae_params`` make such trees with numpy
from a seed, with the flax initializers' scales: random weights for runs
that need no checkpoint.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .models.dalle import DALLEConfig
from .models.vae import VAEConfig
from .ops.transformer import layerscale_init

class _Tree:
    """A nested param dict whose leaves are taken one by one."""

    def __init__(self, tree: dict):
        self.flat = dict(_flatten(tree.get("params", tree)))

    def take(self, *path: str) -> np.ndarray:
        key = "/".join(path)
        if key not in self.flat:
            raise KeyError(f"param {key} missing from the JAX tree")
        return np.asarray(self.flat.pop(key), dtype=np.float32)

    def finish(self) -> None:
        if self.flat:
            raise ValueError("JAX params not consumed by the bridge: "
                             f"{sorted(self.flat)}")


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, val


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _dense(sd, tree: _Tree, dst: str, *src: str, bias: bool = True):
    """flax Dense ``kernel [in, out]`` -> torch Linear ``weight [out, in]``."""
    sd[f"{dst}.weight"] = _t(tree.take(*src, "kernel").T)
    if bias:
        sd[f"{dst}.bias"] = _t(tree.take(*src, "bias"))


def _norm(sd, tree: _Tree, dst: str, *src: str):
    sd[f"{dst}.weight"] = _t(tree.take(*src, "scale"))
    sd[f"{dst}.bias"] = _t(tree.take(*src, "bias"))


def dalle_state_dict_from_jax(params: dict, cfg: DALLEConfig
                              ) -> Dict[str, torch.Tensor]:
    tree = _Tree(params)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("text_emb", "image_emb", "text_pos_emb"):
        sd[f"{name}.weight"] = _t(tree.take(name, "embedding"))
    sd["image_pos_emb.row"] = _t(tree.take("image_pos_emb", "row"))
    sd["image_pos_emb.col"] = _t(tree.take("image_pos_emb", "col"))
    for i in range(cfg.depth):
        a, f = f"layers_{i}_attn", f"layers_{i}_ff"
        dst_a, dst_f = f"transformer.attn_blocks.{i}", f"transformer.ff_blocks.{i}"
        _norm(sd, tree, f"{dst_a}.norm", "transformer", a, "norm")
        qkv = tree.take("transformer", a, "attn", "to_qkv", "kernel")
        sd[f"{dst_a}.attn.to_qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        _dense(sd, tree, f"{dst_a}.attn.to_out", "transformer", a, "attn",
               "to_out")
        sd[f"{dst_a}.scale"] = _t(tree.take("transformer", a, "scale"))
        _norm(sd, tree, f"{dst_f}.norm", "transformer", f, "norm")
        _dense(sd, tree, f"{dst_f}.dense_in", "transformer", f, "dense_in")
        _dense(sd, tree, f"{dst_f}.dense_out", "transformer", f, "dense_out")
        sd[f"{dst_f}.scale"] = _t(tree.take("transformer", f, "scale"))
    _norm(sd, tree, "final_norm", "final_norm")
    for phase in ("text", "image"):
        sd[f"to_logits_dense.{phase}.weight"] = _t(
            tree.take("to_logits_dense", f"{phase}_kernel").T)
        sd[f"to_logits_dense.{phase}.bias"] = _t(
            tree.take("to_logits_dense", f"{phase}_bias"))
    tree.finish()
    return sd


def jax_params_from_dalle_state_dict(state_dict, cfg: DALLEConfig) -> dict:
    """A DALLE ``state_dict`` (tensors on any device) -> ``{"params":
    tree}`` in the JAX layout, numpy f32 leaves.  Raises on a key it does
    not consume."""
    sd = {k: np.ascontiguousarray(v.detach().float().cpu().numpy())
          for k, v in state_dict.items()}

    def take(key):
        if key not in sd:
            raise KeyError(f"{key} missing from the state_dict")
        return sd.pop(key)

    def dense(src, bias=True):
        out = {"kernel": np.ascontiguousarray(take(f"{src}.weight").T)}
        if bias:
            out["bias"] = take(f"{src}.bias")
        return out

    def norm(src):
        return {"scale": take(f"{src}.weight"), "bias": take(f"{src}.bias")}

    tree = {name: {"embedding": take(f"{name}.weight")}
            for name in ("text_emb", "image_emb", "text_pos_emb")}
    tree["image_pos_emb"] = {"row": take("image_pos_emb.row"),
                             "col": take("image_pos_emb.col")}
    layers = {}
    for i in range(cfg.depth):
        a, f = f"transformer.attn_blocks.{i}", f"transformer.ff_blocks.{i}"
        qkv = take(f"{a}.attn.to_qkv.weight").T
        layers[f"layers_{i}_attn"] = {
            "norm": norm(f"{a}.norm"),
            "attn": {"to_qkv": {"kernel": np.ascontiguousarray(qkv.reshape(
                         qkv.shape[0], 3, cfg.heads, cfg.dim_head))},
                     "to_out": dense(f"{a}.attn.to_out")},
            "scale": take(f"{a}.scale")}
        layers[f"layers_{i}_ff"] = {
            "norm": norm(f"{f}.norm"), "dense_in": dense(f"{f}.dense_in"),
            "dense_out": dense(f"{f}.dense_out"), "scale": take(f"{f}.scale")}
    tree["transformer"] = layers
    tree["final_norm"] = norm("final_norm")
    tree["to_logits_dense"] = {}
    for phase in ("text", "image"):
        head = dense(f"to_logits_dense.{phase}")
        tree["to_logits_dense"][f"{phase}_kernel"] = head["kernel"]
        tree["to_logits_dense"][f"{phase}_bias"] = head["bias"]
    if sd:
        raise ValueError(f"state_dict keys not consumed: {sorted(sd)}")
    return {"params": tree}


def _conv(sd, tree: _Tree, dst: str, *src: str):
    """flax Conv ``kernel [kh, kw, in, out]`` -> torch ``[out, in, kh, kw]``."""
    sd[f"{dst}.weight"] = _t(tree.take(*src, "kernel").transpose(3, 2, 0, 1))
    sd[f"{dst}.bias"] = _t(tree.take(*src, "bias"))


def _conv_transpose(sd, tree: _Tree, dst: str, *src: str):
    """flax ConvTranspose ``kernel [kh, kw, in, out]`` -> torch
    ConvTranspose2d ``[in, out, kh, kw]``, flipped in space: flax does not
    flip its kernel, torch's transposed conv does."""
    k = tree.take(*src, "kernel")[::-1, ::-1]
    sd[f"{dst}.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd[f"{dst}.bias"] = _t(tree.take(*src, "bias"))


def vae_state_dict_from_jax(params: dict, cfg: VAEConfig
                            ) -> Dict[str, torch.Tensor]:
    tree = _Tree(params)
    sd: Dict[str, torch.Tensor] = {
        "codebook.weight": _t(tree.take("codebook", "embedding"))}
    # flax numbers the encoder's plain convs in call order: the downs, then
    # the head after the resblocks
    for i in range(cfg.num_layers):
        _conv(sd, tree, f"encoder.downs.{i}", "encoder", f"Conv_{i}")
    for i in range(cfg.num_resnet_blocks):
        for j in range(3):
            _conv(sd, tree, f"encoder.resblocks.{i}.conv{j}", "encoder",
                  f"ResBlock_{i}", f"Conv_{j}")
    _conv(sd, tree, "encoder.to_logits", "encoder", f"Conv_{cfg.num_layers}")
    conv = 0  # flax numbers the decoder's plain convs in call order
    if cfg.num_resnet_blocks > 0:
        _conv(sd, tree, "decoder.stem", "decoder", f"Conv_{conv}")
        conv += 1
        for i in range(cfg.num_resnet_blocks):
            for j in range(3):
                _conv(sd, tree, f"decoder.resblocks.{i}.conv{j}", "decoder",
                      f"ResBlock_{i}", f"Conv_{j}")
    for i in range(cfg.num_layers):
        _conv_transpose(sd, tree, f"decoder.ups.{i}", "decoder",
                        f"ConvTranspose_{i}")
    _conv(sd, tree, "decoder.to_pixels", "decoder", f"Conv_{conv}")
    tree.finish()
    return sd


# ---------------------------------------------------------------------------
# random params in the JAX layout
# ---------------------------------------------------------------------------


def _lecun(rng, shape, fan_in) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _dense_np(rng, fan_in, out_shape, bias=True) -> dict:
    p = {"kernel": _lecun(rng, (fan_in, *out_shape), fan_in)}
    if bias:
        p["bias"] = np.zeros(out_shape, np.float32)
    return p


def _norm_np(dim) -> dict:
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def init_dalle_params(cfg: DALLEConfig, seed: int = 0) -> dict:
    """A DALLE param tree in the JAX layout, drawn with numpy from
    ``seed``: N(0, 1) embeddings, normal kernels at LeCun scale
    (1/sqrt(fan_in)), zero biases, unit norms, LayerScale at its
    depth-staged init."""
    rng = np.random.default_rng(seed)
    d, inner = cfg.dim, cfg.heads * cfg.dim_head
    normal = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    fmap = cfg.image_fmap_size
    tree = {
        "text_emb": {"embedding": normal(cfg.total_text_tokens, d)},
        "image_emb": {"embedding": normal(cfg.num_image_tokens, d)},
        "text_pos_emb": {"embedding": normal(cfg.text_seq_len + 1, d)},
        "image_pos_emb": {"row": normal(fmap, 1, d), "col": normal(1, fmap, d)},
        "transformer": {},
        "final_norm": _norm_np(d),
    }
    for i in range(cfg.depth):
        scale = np.full((1, 1, d), layerscale_init(i + 1), np.float32)
        tree["transformer"][f"layers_{i}_attn"] = {
            "norm": _norm_np(d),
            "attn": {
                "to_qkv": _dense_np(rng, d, (3, cfg.heads, cfg.dim_head),
                                    bias=False),
                "to_out": _dense_np(rng, inner, (d,)),
            },
            "scale": scale,
        }
        tree["transformer"][f"layers_{i}_ff"] = {
            "norm": _norm_np(d),
            "dense_in": _dense_np(rng, d, (d * 4 * 2,)),
            "dense_out": _dense_np(rng, d * 4, (d,)),
            "scale": scale.copy(),
        }
    num_image = cfg.total_tokens - cfg.total_text_tokens
    tree["to_logits_dense"] = {
        "text_kernel": _lecun(rng, (d, cfg.total_text_tokens), d),
        "text_bias": np.zeros((cfg.total_text_tokens,), np.float32),
        "image_kernel": _lecun(rng, (d, num_image), d),
        "image_bias": np.zeros((num_image,), np.float32),
    }
    return {"params": tree}


def _conv_np(rng, k, cin, cout) -> dict:
    return {"kernel": _lecun(rng, (k, k, cin, cout), k * k * cin),
            "bias": np.zeros((cout,), np.float32)}


def _resblock_np(rng, hid) -> dict:
    return {"Conv_0": _conv_np(rng, 3, hid, hid),
            "Conv_1": _conv_np(rng, 3, hid, hid),
            "Conv_2": _conv_np(rng, 1, hid, hid)}


def init_vae_params(cfg: VAEConfig, seed: int = 0) -> dict:
    """A DiscreteVAE param tree (codebook, encoder, decoder) in the JAX
    layout, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    hid = cfg.hidden_dim
    dec = {}
    chan, conv = cfg.codebook_dim, 0
    if cfg.num_resnet_blocks > 0:
        dec[f"Conv_{conv}"] = _conv_np(rng, 1, chan, hid)
        conv += 1
        chan = hid
        for i in range(cfg.num_resnet_blocks):
            dec[f"ResBlock_{i}"] = _resblock_np(rng, hid)
    for i in range(cfg.num_layers):
        dec[f"ConvTranspose_{i}"] = _conv_np(rng, 4, chan, hid)
        chan = hid
    dec[f"Conv_{conv}"] = _conv_np(rng, 1, chan, cfg.channels)
    codebook = rng.standard_normal(
        (cfg.num_tokens, cfg.codebook_dim)).astype(np.float32)
    enc = {}
    chan = cfg.channels
    for i in range(cfg.num_layers):
        enc[f"Conv_{i}"] = _conv_np(rng, 4, chan, hid)
        chan = hid
    for i in range(cfg.num_resnet_blocks):
        enc[f"ResBlock_{i}"] = _resblock_np(rng, hid)
    enc[f"Conv_{cfg.num_layers}"] = _conv_np(rng, 1, chan, cfg.num_tokens)
    return {"params": {"codebook": {"embedding": codebook}, "encoder": enc,
                       "decoder": dec}}
