"""Typed configuration system — the port's copy of
``selfocc_tpu/configs/base.py`` (the port imports nothing of the JAX
package).

Replaces the reference's mmengine python-dict configs with ``_base_``
inheritance (``config/_base_/*``, SURVEY §5.6) by plain frozen dataclasses.
Numeric values in the per-experiment constructors
(``selfocc_tpu/configs/*.py``) are kept verbatim from the corresponding
reference config files so recipes are comparable line-by-line.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    mapping_args: Dict[str, Any]
    embed_dims: int = 96
    num_heads: int = 6
    num_cams: int = 6
    num_feature_levels: int = 4
    num_points_cross: Tuple[int, ...] = (48, 48, 8)
    num_points_self: int = 12
    num_layers: int = 4
    feedforward_channels: int = 192
    dropout: float = 0.1
    pos_num_freqs: Tuple[int, ...] = (12, 12, 12)
    pc_range: Tuple[float, ...] = (-40., -40., -1., 40., 40., 5.4)
    self_query_chunk: int = 0
    cross_query_chunk: int = 0
    # TPU fast attention: heads share sampling locations (6x fewer gather
    # rows; deviates from the reference's per-head deformable attention)
    shared_locations: bool = False
    remat_layers: bool = True   # recompute layers in backward (v5e OOM fix)
    # image cross-attn visibility compaction: per camera only
    # ceil(frac * Q) visible-first queries run deformable attention (the
    # reference's dynamic-rebatch semantics with a static capacity,
    # image_cross_attention.py:84-136). Exact when every camera's visible
    # count fits the capacity; 1.0 = dense. Scalar or per-plane
    # (hw, zh, wz) tuple.
    cross_visible_capacity: Any = 1.0
    # bf16 attention value payloads with fp32 accumulation: halves gather
    # bytes while KEEPING per-head reference semantics (locations, weights
    # and projective math stay fp32; only the gathered payload rounds to
    # bf16 — ~1e-2 relative on the attention output). The exact-recipe
    # prepare-latency lever (docs/PERFORMANCE.md).
    attn_value_bf16: bool = False
    # exact corner-bundled MSDA gathers: "none" | "pairs" (2 rows/point) |
    # "full" (1 row/point). Pure fp reassociation; opt-in pending the
    # remote-TPU-compiler retest (docs/PERFORMANCE.md MSDA section).
    msda_bundle: str = "none"
    # P-axis accumulation chunk for the MSDA gathers (0 = auto:
    # bundled P//fan, unbundled unchunked). The fused train step's HBM
    # peak tracks the per-chunk gather transient (docs/PERFORMANCE.md).
    # Scalar, or one chunk per TPV cross-attn plane (hw, zh, wz) — the
    # planes' point counts differ (48/48/8 flagship), so the HBM-optimal
    # chunk differs per plane; self-attn uses max() of a tuple.
    msda_point_chunk: Any = 0
    # Python-unrolled query-axis split for the TPV cross attns (scalar or
    # per-plane) — scan-safe train-memory lever, unlike the lax.map
    # query_chunk (see ms_deform_attn(query_unroll=)).
    msda_query_unroll: Any = 0
    # per-plane FFN/norm parameter sets (reference MultiPlaneFFN/Norm,
    # modules/split_fpn.py + split_norm.py; off in shipped configs)
    multi_plane_ffn_norm: bool = False
    # CameraAwareSE image-feature gating (camera_se_net.py:52-131; off in
    # shipped configs) — needs intrinsic/cam2ego in the batch
    camera_aware: bool = False
    camera_aware_mid_channels: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    # "neus" (SDF field, reference model/head/neus_head) or "nerfacc"
    # (density field, reference model/head/nerfacc_head) — selects which
    # rendering head TPVSegmentor builds.
    head_type: str = "neus"
    roi_aabb: Tuple[float, ...] = ()
    mapping_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resolution: float = 0.4
    near_plane: float = 0.0
    far_plane: float = 1e10
    num_samples: int = 256
    beta_init: float = 0.1
    beta_max: float = 0.195
    total_iters: int = 3516 * 11
    beta_hand_tune: bool = False
    use_numerical_gradients: bool = False
    numerical_gradients_delta: float = 0.01
    use_compact_2nd_grad: bool = False
    # AABB annealing curriculum (reference neus_head.py:56-59; off in every
    # shipped config) — see models/heads.py for the inferred semantics.
    anneal_aabb: bool = False
    aabb_every_iters: int = 3516
    aabb_min_near: float = 10.0
    aabb_min_far_frac: float = 0.25
    # upsampling base inv_s (reference neus_head.py:33; configs pass 4)
    base_variance: float = 4.0
    return_uniform_sdf: bool = False
    return_max_depth: bool = False
    return_surface_sdf: bool = False
    return_second_grad: bool = False
    return_sample_sdf: bool = False
    return_sem: bool = False
    ray_sample_mode: str = "cellular"
    ray_number: Tuple[int, int] = (48, 100)
    ray_img_size: Tuple[int, int] = (768, 1600)
    ray_upper_crop: int = 0
    ray_x_dsr_max: Optional[float] = None
    ray_y_dsr_max: Optional[float] = None
    trans_kw: str = "img2lidar"          # which matrices feed the renderer
    trans_kw_eval: Optional[str] = None
    render_bkgd: str = "white"
    train_ray_chunk: int = 4096   # remat'd training-render chunk (0 = dense)
    # MXU cumprod kernel (ops/render_pallas): wins 1.4-3x standalone but the
    # opaque pallas_call blocks XLA's fusion of the NeuS elementwise chain
    # into the render gathers (measured 29s -> 45s/step on the flagship
    # training forward), so it is opt-in.
    use_pallas_weights: bool = False
    num_samples_importance: int = 0   # reference neus_head.py:31 (0 shipped)
    bundle_volume: bool = True        # one-fat-gather trilinear (4.7x render)
    # EVAL-only empty-space skipping (deviating fast tier; models/heads.py
    # knob docstring): coarse sdf-only pass -> inverse-CDF fine placement at
    # static capacity. 0/0 = off (every exact tier). Training is unaffected.
    eval_skip_coarse: int = 0
    eval_skip_fine: int = 0
    num_upsample_steps: int = 4
    embed_dims: int = 96
    color_dims: int = 0
    sem_dims: int = 0
    density_layers: int = 2
    sh_deg: int = 0
    sh_act: str = "relu"
    two_split: bool = False
    tpv: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig
    head: HeadConfig
    lifter_type: str = "TPVQueryLifter"          # or BEVQueryLifter / TPVPositionLifter
    lifter_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    backbone_type: str = "resnet50"
    # "fpn" or "identity" (reference model/neck/identity_neck.py — a
    # passthrough for backbones that already emit embed_dims channels)
    neck_type: str = "fpn"
    img_backbone_out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    fpn_in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    # UNet2D encoder (width, depth) EfficientNet coefficients; the
    # reference wraps tf_efficientnet_b7 => (2.0, 3.1)
    # (model/backbone/unet2d.py:166-168)
    unet_scaling: Tuple[float, float] = (2.0, 3.1)
    embed_dims: int = 96
    freeze_img_backbone: bool = False
    freeze_img_neck: bool = False
    # rematerialize the image backbone in the backward: its activations
    # otherwise stay live across the entire encoder+render backward (the
    # backbone grad runs LAST). Memory lever for the 16 GB v5e train fit;
    # costs one extra backbone forward per step (cheap vs the encoder).
    remat_backbone: bool = False
    use_bev_encoder: bool = False                 # BEVFormer variant
    # 'bfloat16' runs backbone/neck compute in bf16 with fp32 params — the
    # analog of the reference's env-var amp mode (train.py:134-136); the
    # encoder/field/renderer fp32 islands are unaffected.
    compute_dtype: object = None


@dataclasses.dataclass(frozen=True)
class Config:
    """Full experiment config (model + data + loss + schedule)."""

    name: str
    model: ModelConfig
    loss_cfgs: List[Dict[str, Any]]
    loss_input_convertion: Dict[str, str]
    img_size: Tuple[int, int] = (768, 1600)       # supervision image size
    input_size: Tuple[int, int] = (384, 800)      # network input (post aug)
    num_rays: Tuple[int, int] = (48, 100)
    num_cams: int = 6
    max_epochs: int = 12
    sem: bool = False
    num_classes: int = 17
    # Semantic supervision class space. "openseed": the field's sem head is
    # trained directly on the 21-class OpenSeeD teacher output and eval
    # applies the openseed->nuscenes LUT on predictions (the reference's
    # behavior, eval_iou.py:249-251 — required for imported-checkpoint
    # parity). "nuscenes": maps are LUT-remapped at data time and the head
    # emits nuScenes classes directly (self-consistent alternative).
    sem_space: str = "nuscenes"
    # optimizer (reference config/_base_/optimizer.py + per-config overrides)
    lr: float = 1e-4
    weight_decay: float = 0.01
    backbone_lr_mult: float = 0.1
    grad_max_norm: float = 35.0
    warmup_iters: int = 1000
    multisteplr: bool = True
    multistep_decay_t: Tuple[int, ...] = (3516 * 9,)
    multistep_decay_rate: float = 0.1
    steps_per_epoch: int = 3516
    # dataset
    dataset_type: str = "nuScenes_One_Frame_Sweeps_Dist"
    train_dataset_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    val_dataset_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wrapper_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scale_rate: float = 0.5
    eval_num_rays: Tuple[int, int] = (450, 800)   # utils/config_tools.py:1-8
