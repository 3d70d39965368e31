"""Carry the JAX package's weights into the port.

``from_jax_variables(np_variables)`` takes a flax ``variables`` pytree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables)`` on the JAX side) and returns a state dict that
``TPVSegmentor.load_state_dict(strict=True)`` accepts.

The port's module names follow the reference tree, so for ResNet-50, FPN,
lifter, encoder and field the keys are those of the reference checkpoint
(and of ``selfocc_tpu/utils/ref_export.py``; for the BEV path those of
``selfocc_tpu/utils/ref_import.py``: ``lifter.bev``, the self-attention as
``attentions.0``, and the image cross-attention, which ``ref_import`` does
not map, as the reference layer's ``attentions.1``; the density head's
field is ``head.radiance_field``). Transforms: flax Dense kernel
``(in, out)`` -> torch Linear ``(out, in)``; flax conv ``HWIO`` -> ``OIHW``;
LayerNorm ``scale`` -> ``weight``; the ``nn.scan``-stacked encoder layers are
unstacked into ``encoder.layers.{n}``. The ``consts`` collection (geometry
tables) is not carried: the port rebuilds those from the config.

The model options: ``TPVPositionLifter``'s ``lifter.position_layer_{hw,zh,wz}``
and the flow head's ``head.flow_net.{0,1,3,4,6}`` (conv, BatchNorm, conv,
BatchNorm, output conv) are the reference's keys (``ref_import.py:11,
161-164, 171-173``). The reference's import map has no keys for
``CameraAwareSE`` or the per-plane norms and FFNs of
``multi_plane_ffn_norm``; the port names the former after the JAX module,
``encoder.camera_se_net.{bn, context_mlp_fc1, context_mlp_fc2,
context_conv, reduce_conv, reduce_bn}``, and the latter
``encoder.layers.{n}.norms.{j}.{i}`` (JAX ``norm{j+1}_{i}``) and
``encoder.layers.{n}.ffns.{i}`` (JAX ``ffn_{i}``), i the plane (hw, zh,
wz). Every BatchNorm's running statistics come from ``batch_stats``.
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
    """Scale and bias, and the running statistics where ``s`` has them (a
    gradient tree has none)."""
    _layer_norm(sd, key, p)
    if s:
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


def _cross_attn(sd, key, ca):
    _deform(sd, f"{key}.deformable_attention", ca["heads"])
    _linear(sd, f"{key}.deformable_attention.value_proj", ca["value_proj"])
    _linear(sd, f"{key}.output_proj", ca["output_proj"])


def _encoder_layer(sd, key, p):
    """One TPV layer, or a BEV layer (one ``cross_attn``)."""
    sa = p["self_attn"]
    _deform(sd, f"{key}.attentions.0", sa["heads"])
    _linear(sd, f"{key}.attentions.0.value_proj", sa["value_proj"])
    _linear(sd, f"{key}.attentions.0.output_proj", sa["output_proj"])
    if "cross_attn" in p:
        _cross_attn(sd, f"{key}.attentions.1", p["cross_attn"])
    for i, plane in enumerate(_PLANES):
        if f"cross_attn_{i}" in p:
            _cross_attn(sd, f"{key}.attentions.1.attn_{plane}",
                        p[f"cross_attn_{i}"])
    if "ffn" not in p:                              # multi_plane_ffn_norm
        for i in range(3):
            _linear(sd, f"{key}.ffns.{i}.layers.0.0", p[f"ffn_{i}"]["fc1"])
            _linear(sd, f"{key}.ffns.{i}.layers.1", p[f"ffn_{i}"]["fc2"])
            for j in range(3):
                _layer_norm(sd, f"{key}.norms.{j}.{i}", p[f"norm{j + 1}_{i}"])
        return
    _linear(sd, f"{key}.ffns.0.layers.0.0", p["ffn"]["fc1"])
    _linear(sd, f"{key}.ffns.0.layers.1", p["ffn"]["fc2"])
    for j in range(3):
        _layer_norm(sd, f"{key}.norms.{j}", p[f"norm{j + 1}"])


def _index(tree, n):
    """Leaf-wise ``x[n]`` over a nested dict (unstack the scan axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, n) for k, v in tree.items()}
    return np.asarray(tree)[n]


def _camera_se(sd, p, s):
    key = "encoder.camera_se_net"
    _batch_norm(sd, f"{key}.bn", p["bn"], s.get("bn"))
    _linear(sd, f"{key}.context_mlp_fc1", p["context_mlp_fc1"])
    _linear(sd, f"{key}.context_mlp_fc2", p["context_mlp_fc2"])
    if "reduce_conv" in p:
        _conv(sd, f"{key}.reduce_conv", p["reduce_conv"])
        _batch_norm(sd, f"{key}.reduce_bn", p["reduce_bn"],
                    s.get("reduce_bn"))
    _conv(sd, f"{key}.context_conv", p["context_conv"])


def _encoder(sd, p, stats):
    sd["encoder.level_embeds"] = _t(p["level_embeds"])
    if "camera_se_net" in p:
        _camera_se(sd, p["camera_se_net"], stats.get("camera_se_net", {}))
    sd["encoder.cams_embeds"] = _t(p["cams_embeds"])
    if "position_layer" in p:                       # BEVFormerEncoder
        _linear(sd, "encoder.positional_encoding.position_layer",
                p["position_layer"])
    else:
        pe = p["positional_encoding"]
        for plane in _PLANES:
            _linear(sd,
                    f"encoder.positional_encoding.position_layer_{plane}",
                    pe[f"position_layer_{plane}"])
    layers = p["layers"]
    n_layers = np.asarray(
        layers["self_attn"]["value_proj"]["kernel"]).shape[0]
    for n in range(n_layers):
        _encoder_layer(sd, f"encoder.layers.{n}", _index(layers, n))


def _field(sd, p, key):
    hidden = sorted(int(k.split("_")[1]) for k in p
                    if k.startswith("density_") and k != "density_out")
    for i in hidden:
        _linear(sd, f"{key}.density_net.{2 * i + 1}", p[f"density_{i}"])
    _linear(sd, f"{key}.density_net.{2 * len(hidden) + 1}", p["density_out"])
    if "color_proj" in p:
        _linear(sd, f"{key}.color_proj", p["color_proj"])
    if "deviation" in p:
        sd[f"{key}.deviation_network.variance"] = _t(
            np.asarray(p["deviation"]["variance"]).reshape(1))


def _head(sd, head, stats):
    """The NeuS head (``head.model.field``, and ``head.flow_net`` with the
    flow head) or the density head (``head.radiance_field``)."""
    if "radiance_field" in head:                    # NeRFAccHead
        _field(sd, head["radiance_field"], "head.radiance_field")
        return
    _field(sd, head["field"], "head.model.field")
    if "flow_net" in head:
        fp, fs = head["flow_net"], stats.get("flow_net", {})
        for i, (conv, norm) in enumerate((("conv0", "norm0"),
                                          ("conv1", "norm1"))):
            _conv(sd, f"head.flow_net.{3 * i}", fp[conv])
            _batch_norm(sd, f"head.flow_net.{3 * i + 1}", fp[norm],
                        fs.get(norm))
        _conv(sd, "head.flow_net.6", fp["out"])


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
    lifter = params["lifter"]
    if "bev" in lifter:
        sd["lifter.bev"] = _t(lifter["bev"])
    elif "position_layer_hw" in lifter:             # TPVPositionLifter
        for plane in _PLANES:
            _linear(sd, f"lifter.position_layer_{plane}",
                    lifter[f"position_layer_{plane}"])
    else:
        for plane in _PLANES:
            sd[f"lifter.tpv_{plane}"] = _t(lifter[f"tpv_{plane}"])
    _encoder(sd, params["encoder"], stats.get("encoder", {}))
    _head(sd, params["head"], stats.get("head", {}))
    return sd
