"""TPVSegmentor — counterpart of ``selfocc_tpu/models/segmentor.py``:
backbone -> neck -> lifter -> encoder -> NeuS head: the training forward
(``forward``), the eval path (``extract_img_feat``,
``get_representation``, ``prepare``, ``render_rays``) and the occupancy
eval (``forward_occ``, ``occ_from_volume``, ``occ_uniform``).

Public tensors keep the JAX package's layouts: images (B, N, H, W, 3) NHWC,
features (B, N, h, w, C), the decoded volume (C, H, W, D). Only the exact
tier of the TPV NeuS model is ported; the constructor refuses the options
that would change what it computes.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ModelConfig
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
    ("head", "return_surface_sdf", False),
    ("head", "estimate_flow", False),
    ("head", "anneal_aabb", False),
    ("head", "two_split", False),
    ("head", "return_uniform_sdf", False),
    ("head", "return_sample_sdf", False),
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
            pos_num_freqs=tuple(e.pos_num_freqs), pc_range=tuple(e.pc_range),
            dropout_p=e.dropout)
        self.head = NeuSHead(
            roi_aabb=tuple(h.roi_aabb), mapping_args=h.mapping_args,
            near_plane=h.near_plane, far_plane=h.far_plane,
            num_samples=h.num_samples, beta_init=h.beta_init,
            return_sem=h.return_sem, render_bkgd=h.render_bkgd,
            embed_dims=h.embed_dims, color_dims=h.color_dims,
            sem_dims=h.sem_dims, density_layers=h.density_layers,
            sh_deg=h.sh_deg, sh_act=h.sh_act,
            return_second_grad=h.return_second_grad,
            use_compact_2nd_grad=h.use_compact_2nd_grad,
            numerical_gradients_delta=h.numerical_gradients_delta,
            ray_sample_mode=h.ray_sample_mode, ray_number=tuple(h.ray_number),
            ray_img_size=tuple(h.ray_img_size),
            ray_upper_crop=h.ray_upper_crop, ray_x_dsr_max=h.ray_x_dsr_max,
            ray_y_dsr_max=h.ray_y_dsr_max,
            train_ray_chunk=h.train_ray_chunk, resolution=h.resolution,
            return_max_depth=h.return_max_depth)

    def extract_img_feat(self, imgs):
        """Backbone + neck. imgs (B, N, H, W, 3) -> list of (B, N, h, w, C)."""
        B, N, H, W, _ = imgs.shape
        x = imgs.float().reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        feats = self.img_backbone(x.contiguous())
        feats = [feats[i] for i in self.cfg.img_backbone_out_indices]
        if self.cfg.freeze_img_backbone:
            # the reference's requires_grad_(False) (tpv_segmentor.py:29-32);
            # BatchNorm statistics still update
            feats = [f.detach() for f in feats]
        feats = self.img_neck(feats)
        if self.cfg.freeze_img_neck and self.cfg.freeze_img_backbone:
            feats = [f.detach() for f in feats]
        return [f.permute(0, 2, 3, 1).reshape(B, N, *f.shape[2:],
                                              f.shape[1]).float()
                for f in feats]

    def get_representation(self, imgs, lidar2img, generator=None):
        """backbone -> neck -> lifter -> encoder: the three TPV planes
        (``generator`` draws the encoder's train-mode dropout)."""
        feats = self.extract_img_feat(imgs)
        rep = self.lifter(feats)
        return self.encoder(rep, feats, lidar2img,
                            (imgs.shape[2], imgs.shape[3]), generator)

    def forward(self, imgs, lidar2img, img2lidar, train: bool = True,
                generator=None, draws=None):
        """Training forward -> the head's loss inputs
        (``selfocc_tpu/models/segmentor.py:236``). BatchNorm and dropout
        follow the module's mode (``model.train()``); ``train`` selects the
        head's training render. Random numbers come from ``generator`` (a
        ``torch.Generator`` on the model's device) unless ``draws`` fixes
        the head's (see ``NeuSHead``)."""
        rep = self.get_representation(imgs, lidar2img, generator)
        return self.head(rep, img2lidar, train=train, generator=generator,
                         draws=draws)

    def prepare(self, imgs, lidar2img):
        """Decode the field volume once per frame: (C, H, W, D) fp32."""
        return self.head.prepare(self.get_representation(imgs, lidar2img))

    @torch.no_grad()
    def forward_occ(self, imgs, lidar2img, aabb=None, resolution=None):
        """Occupancy eval (``segmentor.py:248-253``): the representation,
        then the head's uniform-grid sdf (+ semantics)."""
        return self.head.forward_occ(self.get_representation(imgs, lidar2img),
                                     aabb=aabb, resolution=resolution)

    def occ_from_volume(self, volume, xyz, outputs=None):
        """The occupancy query against a prepared volume at metric points
        (``outputs``: see ``NeuSHead.occ_from_volume``)."""
        return self.head.occ_from_volume(volume, xyz, outputs=outputs)

    def occ_uniform(self, volume, xs, ys, zs, outputs=None):
        """The separable-grid occupancy query against a prepared volume."""
        return self.head.occ_uniform(volume, xs, ys, zs, outputs=outputs)

    def render_rays(self, volume, origin, direction, geo_only: bool = False,
                    outputs=None):
        """The eval render of rays against a prepared volume; ``outputs``:
        the keys the caller reads (None: all, see ``NeuSHead.render_rays``)."""
        return self.head.render_rays(volume, origin, direction,
                                     geo_only=geo_only, outputs=outputs)
