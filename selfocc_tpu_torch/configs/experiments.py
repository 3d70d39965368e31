"""The experiment configs the port runs: copies of ``nuscenes_occ`` and
``tiny`` from ``selfocc_tpu/configs/experiments.py`` (value-for-value mirrors
of the reference ``config/`` files). ``get_config(name)`` replaces
``Config.fromfile``.
"""
from __future__ import annotations

from .base import Config, EncoderConfig, HeadConfig, ModelConfig

_REPROJ_INPUTS = {
    "curr_imgs": "curr_imgs", "prev_imgs": "prev_imgs",
    "next_imgs": "next_imgs", "weights": "weights", "ts": "ts",
    "img2prevImg": "img2prevImg", "img2nextImg": "img2nextImg",
    "ms_rays": "ms_rays"}
_RGB_INPUTS = {"ms_colors": "ms_colors", "ms_rays": "ms_rays",
               "gt_imgs": "color_imgs"}
_SEM_INPUTS = {"sem": "sem", "sem_gt": "sem_gt", "ms_rays": "ms_rays"}
_BASE_CONVERTION = dict(
    ms_depths="ms_depths", ms_rays="ms_rays", ms_colors="ms_colors",
    weights="weights", ts="ts", eik_grad="eik_grad")


def _nusc_dataset_args(min_dist=0.4, max_dist=30.0, train_cur_prob=0.333,
                       ego_centric=True, **extra):
    """nuScenes dataset args, value-for-value from the reference
    ``train_dataset_config``/``val_dataset_config`` blocks
    (``config/nuscenes/nuscenes_occ.py:39-79``). The val block flips
    strict/return_depth/cur_prob — the same values the reference's
    ``modify_for_eval`` enforces (``utils/config_tools.py:10-67``)."""
    common = dict(min_dist=min_dist, max_dist=max_dist, eval_depth=80,
                  prev_prob=0.5, choose_nearest=True, ref_sensor="CAM_FRONT",
                  composite_prev_next=True, sensor_mus=[0.5, 0.5],
                  sensor_sigma=0.5, ego_centric=ego_centric, **extra)
    train = dict(common, strict=True, return_depth=False,
                 cur_prob=train_cur_prob)
    val = dict(common, strict=False, return_depth=True, cur_prob=1.0)
    return train, val


def nuscenes_occ() -> Config:
    """reference ``config/nuscenes/nuscenes_occ.py`` (354 LoC)."""
    img_size = (768, 1600)
    num_rays = (48, 100)
    mapping_args = dict(
        nonlinear_mode="linear",
        h_size=[128, 0], h_range=[40.0, 0], h_half=False,
        w_size=[128, 0], w_range=[40.0, 0], w_half=False,
        d_size=[24, 0], d_range=[-1.0, 5.4, 5.4])
    pc_range = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    num_classes = 17
    # the field's sem head emits the 21 OpenSeeD teacher classes; the
    # openseed->nuscenes LUT is applied at eval (reference trains SemCE
    # directly against OpenSeeD maps, eval_iou.py:249-251 remaps)
    sem_dims = 21
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="RGBLossMS", weight=0.1, img_size=list(img_size),
             no_ssim=False, ray_resize=list(num_rays),
             input_dict=dict(_RGB_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="SecondGradLoss", weight=0.01),
        dict(type="SemCELossMS", weight=0.1, img_size=list(img_size),
             ray_resize=list(num_rays), input_dict=dict(_SEM_INPUTS)),
    ]
    model = ModelConfig(
        encoder=EncoderConfig(
            mapping_args=mapping_args, embed_dims=96, num_heads=6, num_cams=6,
            num_feature_levels=4, num_points_cross=(48, 48, 8),
            num_points_self=12, num_layers=4, feedforward_channels=192,
            pc_range=pc_range),
        head=HeadConfig(
            roi_aabb=pc_range, mapping_args=mapping_args, resolution=0.4,
            near_plane=0.0, far_plane=1e10, num_samples=256,
            beta_init=0.1, beta_max=0.195, total_iters=3516 * 11,
            beta_hand_tune=False, use_numerical_gradients=False,
            return_uniform_sdf=False, return_second_grad=True,
            return_sem=True, return_sample_sdf=False,
            ray_sample_mode="cellular", ray_number=num_rays,
            ray_img_size=img_size, trans_kw="temImg2lidar",
            render_bkgd="random", embed_dims=96, color_dims=24,
            sem_dims=sem_dims, density_layers=2, sh_deg=0, sh_act="relu",
            two_split=False, tpv=True),
        lifter_type="TPVQueryLifter", embed_dims=96)
    convertion = dict(_BASE_CONVERTION, second_grad="second_grad", sem="sem")
    train_ds, val_ds = _nusc_dataset_args()
    return Config(
        name="nuscenes_occ", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=convertion, img_size=img_size,
        input_size=(384, 800), num_rays=num_rays, num_cams=6, max_epochs=12,
        sem=True, num_classes=num_classes, sem_space="openseed",
        lr=1e-4, weight_decay=0.01,
        multisteplr=True, multistep_decay_t=(3516 * 9,), warmup_iters=1000,
        steps_per_epoch=3516, scale_rate=0.5, eval_num_rays=(450, 800),
        train_dataset_args=train_ds, val_dataset_args=val_ds)


def tiny() -> Config:
    """Miniature config (tiny backbone, 17^2x9 TPV grid) for smoke tests and
    multi-chip dry runs — not a reference experiment."""
    mapping = dict(
        nonlinear_mode="linear",
        h_size=[8, 0], h_range=[10.0, 0], h_half=False,
        w_size=[8, 0], w_range=[10.0, 0], w_half=False,
        d_size=[8, 0], d_range=[-1.0, 3.0, 3.0])
    pc = (-10.0, -10.0, -1.0, 10.0, 10.0, 3.0)
    img_size = (64, 96)
    num_rays = (4, 6)
    head = HeadConfig(
        roi_aabb=pc, mapping_args=mapping, resolution=1.0, num_samples=16,
        return_second_grad=True, return_sem=True, ray_sample_mode="cellular",
        ray_number=num_rays, ray_img_size=img_size, trans_kw="temImg2lidar",
        render_bkgd="random", embed_dims=32, color_dims=6, sem_dims=5,
        sh_deg=0, tpv=True)
    enc = EncoderConfig(
        mapping_args=mapping, embed_dims=32, num_heads=4, num_cams=2,
        num_feature_levels=4, num_points_cross=(4, 4, 4), num_points_self=4,
        num_layers=1, feedforward_channels=64, pos_num_freqs=(4, 4, 4),
        pc_range=pc)
    model = ModelConfig(encoder=enc, head=head, lifter_type="TPVQueryLifter",
                        embed_dims=32, backbone_type="tiny",
                        fpn_in_channels=(32, 64, 128, 256))
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="RGBLossMS", weight=0.1, img_size=list(img_size),
             no_ssim=False, ray_resize=list(num_rays),
             input_dict=dict(_RGB_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="SecondGradLoss", weight=0.01),
        dict(type="SemCELossMS", weight=0.1, img_size=list(img_size),
             ray_resize=list(num_rays), input_dict=dict(_SEM_INPUTS)),
    ]
    convertion = dict(_BASE_CONVERTION, second_grad="second_grad", sem="sem")
    return Config(
        name="tiny", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=convertion, img_size=img_size,
        input_size=(32, 48), num_rays=num_rays, num_cams=2, max_epochs=1,
        sem=True, num_classes=5, steps_per_epoch=10, multistep_decay_t=(90,),
        warmup_iters=5, eval_num_rays=(8, 12))


_CONFIGS = {
    "tiny": tiny,
    "nuscenes_occ": nuscenes_occ,
}

def get_config(name: str) -> Config:
    """Resolve a config by name or by reference-style path
    (``config/nuscenes/nuscenes_occ.py`` -> ``nuscenes_occ``)."""
    key = name
    if "/" in key or key.endswith(".py"):
        key = key.rsplit("/", 1)[-1].removesuffix(".py")
    if key not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[key]()
