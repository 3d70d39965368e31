"""Carry the JAX package's weights into the port.

``from_jax_variables(np_variables)`` takes a flax ``variables`` pytree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables)`` on the JAX side) and returns a state dict that
``TPVSegmentor.load_state_dict(strict=True)`` accepts.

The port's module names follow the reference tree, so for ResNet-50, FPN,
lifter, encoder and field the keys are those of the reference checkpoint
(and of ``selfocc_tpu/utils/ref_export.py``). Transforms: flax Dense kernel
``(in, out)`` -> torch Linear ``(out, in)``; flax conv ``HWIO`` -> ``OIHW``;
LayerNorm ``scale`` -> ``weight``; the ``nn.scan``-stacked encoder layers are
unstacked into ``encoder.layers.{n}``. The ``consts`` collection (geometry
tables) is not carried: the port rebuilds those from the config.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

_PLANES = ("hw", "zh", "wz")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _linear(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _layer_norm(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _batch_norm(sd, key, p, s):
    _layer_norm(sd, key, p)
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])


def _backbone(sd, params, stats):
    if "bn1" not in params:                         # TinyBackbone
        for name in sorted(params):
            _conv(sd, f"img_backbone.{name}", params[name])
        return
    _conv(sd, "img_backbone.conv1", params["conv1"])
    _batch_norm(sd, "img_backbone.bn1", params["bn1"], stats["bn1"])
    for stage, n in enumerate((3, 4, 6, 3)):
        for blk in range(n):
            p, s = params[f"layer{stage + 1}_{blk}"], stats[f"layer{stage + 1}_{blk}"]
            key = f"img_backbone.layer{stage + 1}.{blk}"
            for i in (1, 2, 3):
                _conv(sd, f"{key}.conv{i}", p[f"conv{i}"])
                _batch_norm(sd, f"{key}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            if "ds_conv" in p:
                _conv(sd, f"{key}.downsample.0", p["ds_conv"])
                _batch_norm(sd, f"{key}.downsample.1", p["ds_bn"], s["ds_bn"])


def _deform(sd, key, heads):
    _linear(sd, f"{key}.sampling_offsets", heads["sampling_offsets"])
    _linear(sd, f"{key}.attention_weights", heads["attention_weights"])


def _encoder_layer(sd, key, p):
    sa = p["self_attn"]
    _deform(sd, f"{key}.attentions.0", sa["heads"])
    _linear(sd, f"{key}.attentions.0.value_proj", sa["value_proj"])
    _linear(sd, f"{key}.attentions.0.output_proj", sa["output_proj"])
    for i, plane in enumerate(_PLANES):
        ca = p[f"cross_attn_{i}"]
        ckey = f"{key}.attentions.1.attn_{plane}"
        _deform(sd, f"{ckey}.deformable_attention", ca["heads"])
        _linear(sd, f"{ckey}.deformable_attention.value_proj",
                ca["value_proj"])
        _linear(sd, f"{ckey}.output_proj", ca["output_proj"])
    _linear(sd, f"{key}.ffns.0.layers.0.0", p["ffn"]["fc1"])
    _linear(sd, f"{key}.ffns.0.layers.1", p["ffn"]["fc2"])
    for j in range(3):
        _layer_norm(sd, f"{key}.norms.{j}", p[f"norm{j + 1}"])


def _index(tree, n):
    """Leaf-wise ``x[n]`` over a nested dict (unstack the scan axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, n) for k, v in tree.items()}
    return np.asarray(tree)[n]


def _encoder(sd, p):
    sd["encoder.level_embeds"] = _t(p["level_embeds"])
    sd["encoder.cams_embeds"] = _t(p["cams_embeds"])
    pe = p["positional_encoding"]
    for plane in _PLANES:
        _linear(sd, f"encoder.positional_encoding.position_layer_{plane}",
                pe[f"position_layer_{plane}"])
    layers = p["layers"]
    n_layers = np.asarray(layers["ffn"]["fc1"]["kernel"]).shape[0]
    for n in range(n_layers):
        _encoder_layer(sd, f"encoder.layers.{n}", _index(layers, n))


def _field(sd, p):
    key = "head.model.field"
    hidden = sorted(int(k.split("_")[1]) for k in p
                    if k.startswith("density_") and k != "density_out")
    for i in hidden:
        _linear(sd, f"{key}.density_net.{2 * i + 1}", p[f"density_{i}"])
    _linear(sd, f"{key}.density_net.{2 * len(hidden) + 1}", p["density_out"])
    if "color_proj" in p:
        _linear(sd, f"{key}.color_proj", p["color_proj"])
    sd[f"{key}.deviation_network.variance"] = _t(
        np.asarray(p["deviation"]["variance"]).reshape(1))


def from_jax_variables(np_variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """flax ``{"params", "batch_stats", ...}`` of a ``TPVSegmentor`` (numpy
    leaves) -> the port's state dict."""
    params = np_variables["params"]
    stats = np_variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _backbone(sd, params["img_backbone"], stats.get("img_backbone", {}))
    for name, p in params["img_neck"].items():
        kind, i = name.rsplit("_", 1)
        _conv(sd, f"img_neck.{kind}_convs.{i}.conv", p)
    for plane in _PLANES:
        sd[f"lifter.tpv_{plane}"] = _t(params["lifter"][f"tpv_{plane}"])
    _encoder(sd, params["encoder"])
    _field(sd, params["head"]["field"])
    return sd
