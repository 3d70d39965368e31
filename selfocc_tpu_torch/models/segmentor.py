"""TPVSegmentor — counterpart of ``selfocc_tpu/models/segmentor.py``:
backbone -> neck -> lifter -> encoder -> NeuS head: the training forward
(``forward``), the eval path (``extract_img_feat``,
``get_representation``, ``prepare``, ``render_rays``) and the occupancy
eval (``forward_occ``, ``occ_from_volume``, ``occ_uniform``).

Public tensors keep the JAX package's layouts: images (B, N, H, W, 3) NHWC,
features (B, N, h, w, C), the decoded volume (C, H, W, D). The TPV NeuS
model is ported with the encoder's recipe options (head-shared locations,
visibility compaction, bf16 attention values, ``multi_plane_ffn_norm``,
``camera_aware``), the three backbones (``resnet50``, ``tiny`` and
``unet2d``: the EfficientNet UNet2D at ``unet_scaling``, emitting
``fpn_in_channels[0]`` channels, ``models/unet2d.py``), both necks
(``fpn``, and ``identity`` for the UNet2D), the three lifters
(``TPVQueryLifter``, ``BEVQueryLifter``, ``TPVPositionLifter``), both
grid mappings (``linear`` and ``linear_upscale``), the BEV path
(``BEVFormerEncoder``, the ``tpv=False`` field), the density head
(``head_type="nerfacc"``), every
option of the NeuS head (the flow head ``estimate_flow`` included: a custom
head config that has the field), and ``compute_dtype``: with
``"bfloat16"`` the ResNet-50 backbone (not ``TinyBackbone``, as in the JAX
package) and the FPN compute in bf16 with fp32 parameters, and the features
return to fp32 for the encoder (the UNet2D computes in fp32, as the JAX
package's does). The constructor refuses a backbone or neck that the JAX
package does not have either. A camera-aware encoder takes the batch's
``intrinsic`` / ``cam2ego`` (``utils/eval_lib.camera_kwargs``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..geometry.mappings import make_mapping
from ..parallel.mesh import ModelShard
from .density_head import NeRFAccHead
from .encoder import BEVFormerEncoder, TPVFormerEncoder
from .efficientnet import EfficientNetConfig
from .fpn import FPN, IdentityNeck
from .heads import NeuSHead
from .lifter import BEVQueryLifter, TPVPositionLifter, TPVQueryLifter
from .resnet import ResNet50, TinyBackbone
from .unet2d import UNet2D

# (section, option, the value or the set of values the port implements)
_PORTED = (
    ("model", "lifter_type", frozenset({"TPVQueryLifter", "BEVQueryLifter",
                                        "TPVPositionLifter"})),
    ("model", "neck_type", frozenset({"fpn", "identity"})),
    ("head", "head_type", frozenset({"neus", "nerfacc"})),
)


def flip_width(f, flip):
    """(..., W) ``f`` mirrored along W where ``flip``: a Python bool, or a
    0-d bool tensor, chosen on the card without a host synchronisation."""
    if torch.is_tensor(flip) and flip.device.type != "cpu":
        return torch.where(flip, f.flip(-1), f)
    return f.flip(-1) if bool(flip) else f


def check_ported(cfg: ModelConfig):
    """Raise for a config option whose code path is not ported yet."""
    sections = {"model": cfg, "encoder": cfg.encoder, "head": cfg.head}
    for section, name, want in _PORTED:
        got = getattr(sections[section], name)
        if not (got in want if isinstance(want, frozenset) else got == want):
            raise NotImplementedError(
                f"selfocc_tpu_torch: {section}.{name}={got!r} is not ported "
                f"(the port implements "
                f"{sorted(want) if isinstance(want, frozenset) else want!r})")
    if cfg.backbone_type not in ("resnet50", "tiny", "unet2d"):
        raise NotImplementedError(f"backbone {cfg.backbone_type!r}")
    if cfg.compute_dtype not in (None, "float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}")


class TPVSegmentor(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.use_bev_encoder and cfg.encoder.camera_aware:
            raise ValueError("camera_aware is a TPVFormer module "
                             "(camera_se_net.py); the BEVFormer encoder "
                             "variant does not support it")
        check_ported(cfg)
        self.cfg = cfg
        dtype = None if cfg.compute_dtype is None else \
            getattr(torch, cfg.compute_dtype)
        if cfg.backbone_type == "tiny":
            self.img_backbone = TinyBackbone(tuple(cfg.fpn_in_channels))
        elif cfg.backbone_type == "unet2d":
            self.img_backbone = UNet2D(
                cfg.fpn_in_channels[0],
                EfficientNetConfig(width_coefficient=cfg.unet_scaling[0],
                                   depth_coefficient=cfg.unet_scaling[1]))
        else:
            self.img_backbone = ResNet50(dtype)
        if cfg.neck_type == "identity":
            self.img_neck = IdentityNeck()
        else:
            self.img_neck = FPN(tuple(cfg.fpn_in_channels), cfg.embed_dims,
                                dtype)
        e, h = cfg.encoder, cfg.head
        m = make_mapping(**e.mapping_args)
        if cfg.lifter_type == "BEVQueryLifter":
            self.lifter = BEVQueryLifter(m.size_h, m.size_w, cfg.embed_dims)
        elif cfg.lifter_type == "TPVPositionLifter":
            self.lifter = TPVPositionLifter(cfg.embed_dims, **cfg.lifter_args)
        else:
            self.lifter = TPVQueryLifter(m.size_h, m.size_w, m.size_d,
                                         cfg.embed_dims)
        common = dict(
            mapping_args=e.mapping_args, embed_dims=e.embed_dims,
            num_heads=e.num_heads, num_cams=e.num_cams,
            num_feature_levels=e.num_feature_levels,
            num_points_self=e.num_points_self, num_layers=e.num_layers,
            feedforward_channels=e.feedforward_channels,
            pos_num_freqs=tuple(e.pos_num_freqs), pc_range=tuple(e.pc_range),
            dropout_p=e.dropout, visible_capacity=e.cross_visible_capacity,
            attn_value_bf16=e.attn_value_bf16)
        if cfg.use_bev_encoder:
            # one pillar depth for the single plane (segmentor.py:80-84)
            self.encoder = BEVFormerEncoder(
                num_points_cross=min(e.num_points_cross), **common)
        else:
            self.encoder = TPVFormerEncoder(
                num_points_cross=tuple(e.num_points_cross),
                shared_locations=e.shared_locations,
                multi_plane_ffn_norm=e.multi_plane_ffn_norm,
                camera_aware=e.camera_aware,
                camera_aware_mid_channels=e.camera_aware_mid_channels,
                **common)
        self.head = self._build_head(h)

    @staticmethod
    def _build_head(h):
        """The NeuS head, or the density head for ``head_type="nerfacc"``
        (``segmentor.py:126-143``)."""
        if h.head_type == "nerfacc":
            return NeRFAccHead(
                roi_aabb=tuple(h.roi_aabb), mapping_args=h.mapping_args,
                resolution=h.resolution, near_plane=h.near_plane,
                far_plane=h.far_plane, num_samples=h.num_samples,
                ray_sample_mode=h.ray_sample_mode,
                ray_number=tuple(h.ray_number),
                ray_img_size=tuple(h.ray_img_size),
                ray_upper_crop=h.ray_upper_crop, render_bkgd=h.render_bkgd,
                embed_dims=h.embed_dims, color_dims=h.color_dims,
                sem_dims=h.sem_dims, density_layers=h.density_layers,
                sh_deg=h.sh_deg, sh_act=h.sh_act, tpv=h.tpv,
                return_sem=h.return_sem)
        return NeuSHead(
            roi_aabb=tuple(h.roi_aabb), mapping_args=h.mapping_args,
            near_plane=h.near_plane, far_plane=h.far_plane,
            num_samples=h.num_samples, beta_init=h.beta_init,
            beta_max=h.beta_max, total_iters=h.total_iters,
            beta_hand_tune=h.beta_hand_tune,
            use_numerical_gradients=h.use_numerical_gradients,
            return_sem=h.return_sem, render_bkgd=h.render_bkgd,
            embed_dims=h.embed_dims, color_dims=h.color_dims,
            sem_dims=h.sem_dims, density_layers=h.density_layers,
            sh_deg=h.sh_deg, sh_act=h.sh_act,
            return_second_grad=h.return_second_grad,
            use_compact_2nd_grad=h.use_compact_2nd_grad,
            numerical_gradients_delta=h.numerical_gradients_delta,
            anneal_aabb=h.anneal_aabb, aabb_every_iters=h.aabb_every_iters,
            aabb_min_near=h.aabb_min_near,
            aabb_min_far_frac=h.aabb_min_far_frac,
            base_variance=h.base_variance,
            num_samples_importance=h.num_samples_importance,
            num_upsample_steps=h.num_upsample_steps,
            eval_skip_coarse=h.eval_skip_coarse,
            eval_skip_fine=h.eval_skip_fine,
            ray_sample_mode=h.ray_sample_mode, ray_number=tuple(h.ray_number),
            ray_img_size=tuple(h.ray_img_size),
            ray_upper_crop=h.ray_upper_crop, ray_x_dsr_max=h.ray_x_dsr_max,
            ray_y_dsr_max=h.ray_y_dsr_max,
            train_ray_chunk=h.train_ray_chunk, resolution=h.resolution,
            return_max_depth=h.return_max_depth,
            return_uniform_sdf=h.return_uniform_sdf,
            return_surface_sdf=h.return_surface_sdf,
            return_sample_sdf=h.return_sample_sdf, two_split=h.two_split,
            tpv=h.tpv, estimate_flow=getattr(h, "estimate_flow", False))

    def extract_img_feat(self, imgs, flip=False):
        """Backbone + neck. imgs (B, N, H, W, 3) -> list of (B, N, h, w, C).
        ``flip`` (a bool or a 0-d bool tensor, the batch's ``flip``) mirrors
        the features along W (``segmentor.py:207-214``, reference
        ``tpv_segmentor.py:53-55``)."""
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
        return [flip_width(f, flip).permute(0, 2, 3, 1).reshape(
            B, N, *f.shape[2:], f.shape[1]).float() for f in feats]

    def model_shard(self, group):
        """This rank's ``ModelShard`` of the TPV encoder's planes in
        ``group`` (the model-parallel step), or None for the BEV encoder,
        which the JAX package does not shard (its BEV encoder carries no
        hint, ``encoder.py:642``)."""
        if self.cfg.use_bev_encoder:
            return None
        return ModelShard(group, self.encoder.plane_sizes)

    def get_representation(self, imgs, lidar2img, generator=None, flip=False,
                           focal_ratios_x=None, focal_ratios_y=None,
                           intrinsic=None, cam2ego=None, feats=None,
                           shard=None):
        """backbone -> neck -> lifter -> encoder: the three TPV planes, or
        the BEV plane (``generator`` draws the encoder's train-mode
        dropout; ``flip`` see ``extract_img_feat``; ``focal_ratios_x/y``
        (N,) scale the projected reference points, see
        ``geometry.projection.point_sampling``; ``intrinsic`` / ``cam2ego``
        (1, N, 4, 4): the camera-aware encoder's inputs, read only
        there; ``feats``: ``extract_img_feat(imgs, flip)`` computed by the
        caller, as the camera-sharded eval prepare does; ``shard``: a
        ``model_shard``, the TPV encoder's share of the model-parallel
        step)."""
        if feats is None:
            feats = self.extract_img_feat(imgs, flip)
        rep = self.lifter(feats)
        kw = dict(intrinsic=intrinsic, cam2ego=cam2ego) \
            if self.cfg.encoder.camera_aware else {}
        if shard is not None:
            kw["shard"] = shard
        return self.encoder(rep, feats, lidar2img,
                            (imgs.shape[2], imgs.shape[3]), generator,
                            focal_ratios_x, focal_ratios_y, **kw)

    def forward(self, imgs, lidar2img, img2lidar, train: bool = True,
                generator=None, draws=None, flip=False, focal_ratios_x=None,
                focal_ratios_y=None, global_iter=None, intrinsic=None,
                cam2ego=None, shard=None):
        """Training forward -> the head's loss inputs
        (``selfocc_tpu/models/segmentor.py:236``). BatchNorm and dropout
        follow the module's mode (``model.train()``); ``train`` selects the
        head's training render. Random numbers come from ``generator`` (a
        ``torch.Generator`` on the model's device) unless ``draws`` fixes
        the head's (see ``NeuSHead``). ``flip`` and ``focal_ratios_x/y``:
        the batch's augmentation record (``get_representation``).
        ``global_iter``: the step count before this step's update, which
        the NeuS head's ``anneal_aabb`` and ``beta_hand_tune`` read (the
        density head takes it and reads nothing). ``intrinsic`` /
        ``cam2ego``, ``shard``: see ``get_representation``."""
        rep = self.get_representation(imgs, lidar2img, generator, flip,
                                      focal_ratios_x, focal_ratios_y,
                                      intrinsic, cam2ego, shard=shard)
        return self.head(rep, img2lidar, train=train, generator=generator,
                         draws=draws, global_iter=global_iter)

    def prepare(self, imgs, lidar2img, flip=False, intrinsic=None,
                cam2ego=None, feats=None):
        """Decode the field volume once per frame: (C, H, W, D) fp32
        (``flip``: the flip-TTA pass on W-mirrored images; ``feats``: see
        ``get_representation``)."""
        return self.head.prepare(self.get_representation(
            imgs, lidar2img, flip=flip, intrinsic=intrinsic, cam2ego=cam2ego,
            feats=feats))

    @torch.no_grad()
    def forward_occ(self, imgs, lidar2img, aabb=None, resolution=None,
                    intrinsic=None, cam2ego=None):
        """Occupancy eval (``segmentor.py:248-253``): the representation,
        then the head's uniform-grid sdf (+ semantics)."""
        return self.head.forward_occ(
            self.get_representation(imgs, lidar2img, intrinsic=intrinsic,
                                    cam2ego=cam2ego),
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
