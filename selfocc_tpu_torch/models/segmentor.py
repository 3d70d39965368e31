"""TPVSegmentor — counterpart of ``selfocc_tpu/models/segmentor.py``:
backbone -> neck -> lifter -> encoder -> NeuS head, eval path
(``extract_img_feat``, ``get_representation``, ``prepare``,
``render_rays``).

Public tensors keep the JAX package's layouts: images (B, N, H, W, 3) NHWC,
features (B, N, h, w, C), the decoded volume (C, H, W, D). Only the exact
tier of the TPV NeuS model is ported; the constructor refuses the options
that would change what it computes.
"""
from __future__ import annotations

import dataclasses

from torch import nn

from selfocc_tpu.configs.base import ModelConfig

from ..geometry.mappings import make_mapping
from .encoder import TPVFormerEncoder
from .fpn import FPN
from .heads import NeuSHead
from .lifter import TPVQueryLifter
from .resnet import ResNet50, TinyBackbone

# (section, option, value the port implements)
_PORTED = (
    ("model", "lifter_type", "TPVQueryLifter"),
    ("model", "neck_type", "fpn"),
    ("model", "use_bev_encoder", False),
    ("model", "compute_dtype", None),
    ("encoder", "shared_locations", False),
    ("encoder", "cross_visible_capacity", 1.0),
    ("encoder", "attn_value_bf16", False),
    ("encoder", "multi_plane_ffn_norm", False),
    ("encoder", "camera_aware", False),
    ("head", "head_type", "neus"),
    ("head", "tpv", True),
    ("head", "use_numerical_gradients", False),
    ("head", "beta_hand_tune", False),
    ("head", "num_samples_importance", 0),
    ("head", "eval_skip_coarse", 0),
    ("head", "eval_skip_fine", 0),
    ("head", "return_max_depth", False),
    ("head", "return_surface_sdf", False),
    ("head", "estimate_flow", False),
)


def check_ported(cfg: ModelConfig):
    """Raise for a config option whose code path is not ported yet."""
    sections = {"model": cfg, "encoder": cfg.encoder, "head": cfg.head}
    for section, name, want in _PORTED:
        obj = sections[section]
        if not any(f.name == name for f in dataclasses.fields(obj)):
            continue
        got = getattr(obj, name)
        if isinstance(want, float) and isinstance(got, (tuple, list)):
            ok = all(g == want for g in got)
        else:
            ok = got == want
        if not ok:
            raise NotImplementedError(
                f"selfocc_tpu_torch: {section}.{name}={got!r} is not ported "
                f"(the port implements {want!r})")
    if cfg.backbone_type not in ("resnet50", "tiny"):
        raise NotImplementedError(f"backbone {cfg.backbone_type!r}")


class TPVSegmentor(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        if cfg.backbone_type == "tiny":
            self.img_backbone = TinyBackbone(tuple(cfg.fpn_in_channels))
        else:
            self.img_backbone = ResNet50()
        self.img_neck = FPN(tuple(cfg.fpn_in_channels), cfg.embed_dims)
        e, h = cfg.encoder, cfg.head
        m = make_mapping(**e.mapping_args)
        self.lifter = TPVQueryLifter(m.size_h, m.size_w, m.size_d,
                                     cfg.embed_dims)
        self.encoder = TPVFormerEncoder(
            mapping_args=e.mapping_args, embed_dims=e.embed_dims,
            num_heads=e.num_heads, num_cams=e.num_cams,
            num_feature_levels=e.num_feature_levels,
            num_points_cross=tuple(e.num_points_cross),
            num_points_self=e.num_points_self, num_layers=e.num_layers,
            feedforward_channels=e.feedforward_channels,
            pos_num_freqs=tuple(e.pos_num_freqs), pc_range=tuple(e.pc_range))
        self.head = NeuSHead(
            roi_aabb=tuple(h.roi_aabb), mapping_args=h.mapping_args,
            near_plane=h.near_plane, far_plane=h.far_plane,
            num_samples=h.num_samples, beta_init=h.beta_init,
            return_sem=h.return_sem, render_bkgd=h.render_bkgd,
            embed_dims=h.embed_dims, color_dims=h.color_dims,
            sem_dims=h.sem_dims, density_layers=h.density_layers,
            sh_deg=h.sh_deg, sh_act=h.sh_act)

    def extract_img_feat(self, imgs):
        """Backbone + neck. imgs (B, N, H, W, 3) -> list of (B, N, h, w, C)."""
        B, N, H, W, _ = imgs.shape
        x = imgs.float().reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        feats = self.img_backbone(x.contiguous())
        feats = self.img_neck([feats[i]
                               for i in self.cfg.img_backbone_out_indices])
        return [f.permute(0, 2, 3, 1).reshape(B, N, *f.shape[2:],
                                              f.shape[1]).float()
                for f in feats]

    def get_representation(self, imgs, lidar2img):
        """backbone -> neck -> lifter -> encoder: the three TPV planes."""
        feats = self.extract_img_feat(imgs)
        rep = self.lifter(feats)
        return self.encoder(rep, feats, lidar2img,
                            (imgs.shape[2], imgs.shape[3]))

    def prepare(self, imgs, lidar2img):
        """Decode the field volume once per frame: (C, H, W, D) fp32."""
        return self.head.prepare(self.get_representation(imgs, lidar2img))

    def render_rays(self, volume, origin, direction, geo_only: bool = False):
        return self.head.render_rays(volume, origin, direction,
                                     geo_only=geo_only)
