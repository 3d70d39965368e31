"""The experiment configs the port runs: copies of ``nuscenes_occ``,
``nuscenes_depth``, ``nuscenes_novel_depth``, ``kitti_occ``,
``kitti_novel_depth``, ``kitti_raw_depth`` (with ``_KITTI_IMG_NORM``) and
``tiny`` from
``selfocc_tpu/configs/experiments.py`` (value-for-value mirrors of the
reference ``config/`` files), and of the recipes built on them: the
visibility-compaction (``nuscenes_occ_compact*``), fast-tier
(``*_fast*``: head-shared MSDA locations, bf16 backbone/neck) and bundled
(``*_bundle``, ``*_pairs``: TPU gather layouts that the port's kernels
stand in for) variants; the BEV recipe (``nuscenes_occ_bev``,
``tiny_bev``) and the density-head recipes (``_to_nerfacc``,
``nuscenes_occ_density``, ``tiny_nerfacc``).
``get_config(name)`` replaces ``Config.fromfile``.
"""
from __future__ import annotations

import dataclasses

from .base import Config, EncoderConfig, HeadConfig, ModelConfig

_REPROJ_INPUTS = {
    "curr_imgs": "curr_imgs", "prev_imgs": "prev_imgs",
    "next_imgs": "next_imgs", "weights": "weights", "ts": "ts",
    "img2prevImg": "img2prevImg", "img2nextImg": "img2nextImg",
    "ms_rays": "ms_rays"}
_RGB_INPUTS = {"ms_colors": "ms_colors", "ms_rays": "ms_rays",
               "gt_imgs": "color_imgs"}
_SEM_INPUTS = {"sem": "sem", "sem_gt": "sem_gt", "ms_rays": "ms_rays"}
_EDGE_INPUTS = {"curr_imgs": "curr_imgs", "ms_depths": "ms_depths",
                "ms_rays": "ms_rays"}
_BASE_CONVERTION = dict(
    ms_depths="ms_depths", ms_rays="ms_rays", ms_colors="ms_colors",
    weights="weights", ts="ts", eik_grad="eik_grad")

# KITTI image normalization (reference config/kitti/kitti_occ.py
# train_wrapper_config.img_norm_cfg — differs from the ImageNet default)
_KITTI_IMG_NORM = dict(mean=[124.16, 116.74, 103.94],
                       std=[58.624, 57.344, 57.6], to_rgb=True)


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


def nuscenes_depth() -> Config:
    """reference ``config/nuscenes/nuscenes_depth.py``."""
    cfg = nuscenes_occ()
    img_size = (896, 1600)
    num_rays = (48, 100)
    mapping_args = dict(
        nonlinear_mode="linear",
        h_size=[128, 0], h_range=[51.2, 0], h_half=False,
        w_size=[128, 0], w_range=[51.2, 0], w_half=False,
        d_size=[30, 0], d_range=[-4.0, 5.0, 5.0])
    pc_range = (-51.2, -51.2, -4.0, 51.2, 51.2, 5.0)
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="EdgeLoss3DMS", weight=0.01, img_size=list(img_size),
             ray_resize=list(num_rays), input_dict=dict(_EDGE_INPUTS)),
    ]
    model = ModelConfig(
        encoder=dataclasses.replace(cfg.model.encoder, mapping_args=mapping_args,
                             pc_range=pc_range),
        head=dataclasses.replace(
            cfg.model.head, roi_aabb=pc_range, mapping_args=mapping_args,
            return_second_grad=False, return_sem=False, color_dims=0,
            sem_dims=0, ray_img_size=img_size),
        lifter_type="TPVQueryLifter", embed_dims=96)
    # dataset crop_size is the 900x1600 SUPERVISION size; the 896x1600
    # input crop comes via input_img_crop_size (reference
    # config/nuscenes/nuscenes_depth.py train_dataset_config)
    train_ds, val_ds = _nusc_dataset_args(
        max_dist=6.0, train_cur_prob=1.0, ego_centric=False,
        crop_size=[900, 1600], input_img_crop_size=list(img_size))
    return dataclasses.replace(
        cfg, name="nuscenes_depth", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=dict(_BASE_CONVERTION), img_size=img_size,
        input_size=(448, 800), max_epochs=24, sem=False,
        eval_num_rays=(450, 800),
        train_dataset_args=train_ds, val_dataset_args=val_ds)


def nuscenes_novel_depth() -> Config:
    """reference ``config/nuscenes/nuscenes_novel_depth.py``."""
    cfg = nuscenes_depth()
    img_size = (768, 1600)
    num_rays = (48, 100)
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="RGBLossMS", weight=0.1, img_size=list(img_size),
             no_ssim=False, ray_resize=list(num_rays),
             input_dict=dict(_RGB_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="SecondGradLoss", weight=0.01),
    ]
    model = dataclasses.replace(
        cfg.model,
        head=dataclasses.replace(cfg.model.head, return_second_grad=True,
                          color_dims=3, ray_img_size=img_size))
    convertion = dict(_BASE_CONVERTION, second_grad="second_grad")
    train_ds, val_ds = _nusc_dataset_args(
        max_dist=10.0, train_cur_prob=0.333, ego_centric=False)
    return dataclasses.replace(
        cfg, name="nuscenes_novel_depth", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=convertion, img_size=img_size,
        input_size=(384, 800),
        train_dataset_args=train_ds, val_dataset_args=val_ds)


def kitti_occ() -> Config:
    """reference ``config/kitti/kitti_occ.py``."""
    img_size = (352, 1216)
    num_rays = (55, 190)
    mapping_args = dict(
        nonlinear_mode="linear",
        h_size=[256, 0], h_range=[51.2, 0], h_half=True,
        w_size=[128, 0], w_range=[25.6, 0], w_half=False,
        d_size=[32, 0], d_range=[-2.0, 4.4, 4.4])
    pc_range = (-25.6, 0.0, -2.0, 25.6, 51.2, 4.4)
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNew", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="RGBLossMS", weight=0.1, img_size=list(img_size),
             no_ssim=False, ray_resize=list(num_rays),
             input_dict=dict(_RGB_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="SecondGradLoss", weight=0.1),
        dict(type="SoftSparsityLoss", weight=0.005,
             input_dict={"density": "uniform_sdf"}),
    ]
    model = ModelConfig(
        encoder=EncoderConfig(
            mapping_args=mapping_args, embed_dims=96, num_heads=6, num_cams=1,
            num_feature_levels=4, num_points_cross=(48, 48, 8),
            num_points_self=12, num_layers=4, feedforward_channels=192,
            pc_range=pc_range),
        head=HeadConfig(
            roi_aabb=pc_range, mapping_args=mapping_args, resolution=0.4,
            num_samples=256, beta_init=0.1, beta_max=0.195,
            total_iters=3516 * 11, use_numerical_gradients=False,
            use_compact_2nd_grad=True, return_uniform_sdf=True,
            return_second_grad=True, ray_sample_mode="cellular",
            ray_number=num_rays, ray_img_size=img_size,
            trans_kw="temImg2lidar", render_bkgd="random", embed_dims=96,
            color_dims=3, sem_dims=0, sh_deg=0, two_split=False, tpv=True),
        lifter_type="TPVQueryLifter", embed_dims=96)
    convertion = dict(_BASE_CONVERTION, second_grad="second_grad",
                      uniform_sdf="uniform_sdf")
    # reference config/kitti/kitti_occ.py train/val_dataset_config +
    # the KITTI-specific img_norm in the wrapper blocks
    kitti_common = dict(frames_interval=0.4, sequence_distance=[10, 40],
                        prev_prob=0.2, choose_nearest=True)
    train_ds = dict(kitti_common, split="train", cur_prob=0.333, strict=True)
    val_ds = dict(kitti_common, split="val", cur_prob=1.0, strict=False,
                  return_depth=True)
    return Config(
        name="kitti_occ", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=convertion, img_size=img_size,
        input_size=(176, 608), num_rays=num_rays, num_cams=1, max_epochs=24,
        sem=False, num_classes=20, lr=1e-3, weight_decay=0.01,
        steps_per_epoch=3516, scale_rate=0.5,
        dataset_type="Kitti_One_Frame", eval_num_rays=(176, 608),
        train_dataset_args=train_ds, val_dataset_args=val_ds,
        wrapper_args=dict(img_norm_cfg=dict(_KITTI_IMG_NORM)))


def kitti_novel_depth() -> Config:
    """reference ``config/kitti/kitti_novel_depth.py``."""
    cfg = kitti_occ()
    img_size = (370, 1216)
    loss_cfgs = [c for c in cfg.loss_cfgs if c["type"] != "SoftSparsityLoss"]
    for c in loss_cfgs:
        if c["type"] == "SecondGradLoss":
            c["weight"] = 0.01
        if "img_size" in c:
            c["img_size"] = list(img_size)
    model = dataclasses.replace(
        cfg.model,
        head=dataclasses.replace(cfg.model.head, return_uniform_sdf=False,
                          use_compact_2nd_grad=False, ray_img_size=img_size))
    convertion = dict(_BASE_CONVERTION, second_grad="second_grad")
    # reference config/kitti/kitti_novel_depth.py dataset/wrapper blocks
    train_ds = dict(split="train", cur_prob=0.5, strict=True, prev_prob=0.0,
                    choose_nearest=True)
    val_ds = dict(split="val", cur_prob=1.0, strict=False, prev_prob=0.5,
                  choose_nearest=True, return_depth=True)
    return dataclasses.replace(
        cfg, name="kitti_novel_depth", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=convertion, img_size=img_size,
        input_size=(176, 608),
        train_dataset_args=train_ds, val_dataset_args=val_ds,
        wrapper_args=dict(img_norm_cfg=dict(_KITTI_IMG_NORM),
                          pad_img_size=[384, 1216],
                          pad_scale_rate=[1.038, 1.0]))


def kitti_raw_depth() -> Config:
    """reference ``config/kitti_raw/kitti_raw_depth.py`` — the minimum
    end-to-end slice (SURVEY §7)."""
    img_size = (370, 1216)
    num_rays = (44, 152)
    mapping_args = dict(
        nonlinear_mode="linear",
        h_size=[256, 0], h_range=[51.2, 0], h_half=True,
        w_size=[128, 0], w_range=[25.6, 0], w_half=False,
        d_size=[32, 0], d_range=[-2.0, 4.4, 4.4])
    pc_range = (-25.6, 0.0, -2.0, 25.6, 51.2, 4.4)
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNew", weight=1.0, no_ssim=False,
             img_size=list(img_size), ray_resize=list(num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="EdgeLoss3DMS", weight=0.01, img_size=list(img_size),
             ray_resize=list(num_rays), input_dict=dict(_EDGE_INPUTS)),
    ]
    model = ModelConfig(
        encoder=EncoderConfig(
            mapping_args=mapping_args, embed_dims=96, num_heads=6, num_cams=1,
            num_feature_levels=4, num_points_cross=(48, 48, 8),
            num_points_self=12, num_layers=4, feedforward_channels=192,
            pc_range=pc_range),
        head=HeadConfig(
            roi_aabb=pc_range, mapping_args=mapping_args, resolution=0.4,
            num_samples=256, beta_init=0.1, beta_max=0.195,
            total_iters=3516 * 11, return_second_grad=False,
            ray_sample_mode="cellular", ray_number=num_rays,
            ray_img_size=img_size, trans_kw="temImg2lidar",
            render_bkgd="random", embed_dims=96, color_dims=0, sem_dims=0,
            sh_deg=0, two_split=False, tpv=True),
        lifter_type="TPVQueryLifter", embed_dims=96)
    # reference config/kitti_raw/kitti_raw_depth.py dataset/wrapper blocks
    # (pose/split paths relocated under data/kitti_raw/; the reference ships
    # them inside its repo at dataset/kitti_raw/)
    raw_common = dict(pose_path="data/kitti_raw/orb-slam_poses",
                      frames_interval=1.0, sequence_distance=5.0,
                      cur_prob=1.0, choose_nearest=True, eval_depth=80,
                      include_stereo=True)
    train_ds = dict(raw_common, strict=True, return_depth=False, prev_prob=0,
                    split_path="data/kitti_raw/splits/eigen_zhou/"
                               "train_files.txt")
    val_ds = dict(raw_common, strict=False, return_depth=True, prev_prob=0.5,
                  split_path="data/kitti_raw/splits/eigen_zhou/"
                             "test_files.txt")
    return Config(
        name="kitti_raw_depth", model=model, loss_cfgs=loss_cfgs,
        loss_input_convertion=dict(_BASE_CONVERTION), img_size=img_size,
        input_size=(320, 1024), num_rays=num_rays, num_cams=1, max_epochs=24,
        sem=False, lr=1e-4, weight_decay=0.01, steps_per_epoch=3516,
        scale_rate=0.84, dataset_type="Kitti_Raw_Stereo",
        eval_num_rays=(176, 608),
        train_dataset_args=train_ds, val_dataset_args=val_ds,
        wrapper_args=dict(img_norm_cfg=dict(_KITTI_IMG_NORM),
                          pad_img_size=[320, 1024],
                          pad_scale_rate=[0.8649, 0.8421]))


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


def tiny_fast() -> Config:
    """Tiny config with the fast-tier encoder levers (head-shared MSDA
    locations + full corner bundle + visibility compaction): a CPU-sized
    drive of the ``nuscenes_occ_fast_bundle`` encoder code path."""
    cfg = tiny()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, shared_locations=True, msda_bundle="full",
            cross_visible_capacity=(0.9, 0.9, 0.9)))
    return dataclasses.replace(cfg, name="tiny_fast", model=model)


def nuscenes_occ_bev() -> Config:
    """reference ``config/nuscenes/nuscenes_occ_bev.py``: the BEV
    representation variant (BEVQueryLifter + tpv=False head; the encoder
    runs one plane)."""
    cfg = nuscenes_occ()
    loss_cfgs = [
        dict(type="ReprojLossMonoMultiNewCombine", weight=1.0, no_ssim=False,
             img_size=list(cfg.img_size), ray_resize=list(cfg.num_rays),
             input_dict=dict(_REPROJ_INPUTS)),
        dict(type="RGBLossMS", weight=0.1, img_size=list(cfg.img_size),
             no_ssim=False, ray_resize=list(cfg.num_rays),
             input_dict=dict(_RGB_INPUTS)),
        dict(type="EikonalLoss", weight=0.1),
        dict(type="SecondGradLoss", weight=0.01),
        dict(type="SemLossMS", weight=0.1, img_size=list(cfg.img_size),
             ray_resize=list(cfg.num_rays), input_dict=dict(_SEM_INPUTS)),
        dict(type="SoftSparsityLoss", weight=0.001,
             input_dict={"density": "uniform_sdf"}),
    ]
    model = dataclasses.replace(
        cfg.model, lifter_type="BEVQueryLifter", use_bev_encoder=True,
        head=dataclasses.replace(cfg.model.head, tpv=False,
                                 return_uniform_sdf=True))
    convertion = dict(cfg.loss_input_convertion, uniform_sdf="uniform_sdf")
    return dataclasses.replace(cfg, name="nuscenes_occ_bev", model=model,
                               loss_cfgs=loss_cfgs,
                               loss_input_convertion=convertion)


def _to_nerfacc(cfg: Config, name: str) -> Config:
    """Swap a NeuS config's head for the density NeRFAccHead (reference
    ``model/head/nerfacc_head/nerfacc_head.py:21-475``; no shipped reference
    config uses it, so the recipe keeps the NeuS ray/field values and drops
    the SDF-only regularizers: a density field has no eikonal/2nd-grad)."""
    sdf_only = {"EikonalLoss", "SecondGradLoss", "SparsityLoss",
                "HardSparsityLoss", "SoftSparsityLoss",
                "AdaptiveSparsityLoss"}
    loss_cfgs = [l for l in cfg.loss_cfgs if l["type"] not in sdf_only]
    head = dataclasses.replace(
        cfg.model.head, head_type="nerfacc",
        # density fields composite depth opacity-normalized and need no
        # second-grad/uniform-sdf outputs
        return_second_grad=False, return_uniform_sdf=False,
        return_surface_sdf=False, return_sample_sdf=False)
    convertion = {k: v for k, v in cfg.loss_input_convertion.items()
                  if k not in ("eik_grad", "second_grad", "uniform_sdf",
                               "sample_sdf", "surface_sdf")}
    model = dataclasses.replace(cfg.model, head=head)
    return dataclasses.replace(cfg, name=name, model=model,
                               loss_cfgs=loss_cfgs,
                               loss_input_convertion=convertion)


def tiny_nerfacc() -> Config:
    """Tiny config on the density (NeRFAcc) head: a CPU-sized drive of the
    ``eval_iou --density`` pipeline."""
    return _to_nerfacc(tiny(), "tiny_nerfacc")


def tiny_bev() -> Config:
    """Tiny config on the BEV representation path (BEVQueryLifter +
    BEVFormerEncoder + tpv=False head): a CPU-sized drive of everything
    ``nuscenes_occ_bev`` exercises."""
    cfg = tiny()
    model = dataclasses.replace(
        cfg.model, lifter_type="BEVQueryLifter", use_bev_encoder=True,
        head=dataclasses.replace(cfg.model.head, tpv=False))
    return dataclasses.replace(cfg, name="tiny_bev", model=model)


def nuscenes_occ_density() -> Config:
    """Flagship-scale density-field variant (NeRFAccHead)."""
    return _to_nerfacc(nuscenes_occ(), "nuscenes_occ_density")


def nuscenes_occ_compact() -> Config:
    """Flagship with cross-attn visibility compaction: the dense computation
    minus (camera, query) pairs that are provably zero, so exact as long as
    no camera sees more queries than its capacity. Per-camera visible
    fractions on the synthetic surround rig: hw ~0.18, zh ~0.61, wz ~0.51;
    the capacities leave margin."""
    cfg = nuscenes_occ()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, cross_visible_capacity=(0.3, 0.75, 0.7)))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact", model=model)


def nuscenes_occ_compact_train() -> Config:
    """Training recipe with the math of ``nuscenes_occ``: visibility
    compaction (exact given capacity) + 2048-ray checkpointed chunks
    (chunking changes only the recompute schedule). No shared_locations and
    no bf16 compute, unlike ``nuscenes_occ_fast``."""
    cfg = nuscenes_occ_compact()
    model = dataclasses.replace(
        cfg.model,
        head=dataclasses.replace(cfg.model.head, train_ray_chunk=2048))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_train",
                               model=model)


def nuscenes_occ_compact_bf16() -> Config:
    """``nuscenes_occ_compact`` with bf16 attention value payloads (fp32
    accumulation): sampling locations, attention weights and the projective
    math stay fp32; only the gathered image-feature payload rounds to bf16
    (~1e-2 relative on the attention output)."""
    cfg = nuscenes_occ_compact()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, attn_value_bf16=True))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_bf16",
                               model=model)


def nuscenes_occ_compact_pairs() -> Config:
    """``nuscenes_occ_compact`` with x-pair-bundled MSDA gathers
    (``msda_bundle="pairs"``): a gather layout of the JAX package, an fp
    reassociation that the port's kernel stands in for."""
    cfg = nuscenes_occ_compact()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, msda_bundle="pairs"))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_pairs",
                               model=model)


def nuscenes_occ_compact_bundle() -> Config:
    """``nuscenes_occ_compact`` with full 2x2 corner-bundled MSDA gathers
    (an exact reassociation): the JAX package's reference-exact eval
    recipe."""
    cfg = nuscenes_occ_compact()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, msda_bundle="full"))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_bundle",
                               model=model)


def nuscenes_occ_compact_bf16_pairs() -> Config:
    """bf16 value payloads (fp32 accumulation) + x-pair-bundled gathers
    composed; the JAX package keeps it as a repro of a TPU worker fault."""
    cfg = nuscenes_occ_compact()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(
            cfg.model.encoder, attn_value_bf16=True, msda_bundle="pairs"))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_bf16_pairs",
                               model=model)


def nuscenes_occ_fast() -> Config:
    """Fast recipe: the flagship ``nuscenes_occ`` with head-shared
    deformable sampling locations (deviates from per-head locations) and
    bf16 backbone/neck compute (AMP analog), plus visibility compaction and
    2048-ray checkpointed chunks (memory levers of the training step).
    Losses, schedule, field and renderer are ``nuscenes_occ``'s."""
    cfg = nuscenes_occ()
    model = dataclasses.replace(
        cfg.model,
        compute_dtype="bfloat16",
        head=dataclasses.replace(cfg.model.head, train_ray_chunk=2048),
        encoder=dataclasses.replace(
            cfg.model.encoder, shared_locations=True,
            cross_visible_capacity=(0.3, 0.75, 0.7)))
    return dataclasses.replace(cfg, name="nuscenes_occ_fast", model=model)


def nuscenes_occ_fast_bundle() -> Config:
    """``nuscenes_occ_fast`` + 2x2 corner-bundled shared-location gathers;
    the JAX package keeps bundled shared payloads fp32, closer to per-head
    fp32 than plain ``_fast``'s bf16 payloads."""
    cfg = nuscenes_occ_fast()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, msda_bundle="full"))
    return dataclasses.replace(cfg, name="nuscenes_occ_fast_bundle",
                               model=model)


def nuscenes_occ_compact_train_bundle() -> Config:
    """``nuscenes_occ_compact_train`` + corner-bundled MSDA gathers (an
    exact reassociation in the backward too)."""
    cfg = nuscenes_occ_compact_train()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, msda_bundle="full"))
    return dataclasses.replace(cfg, name="nuscenes_occ_compact_train_bundle",
                               model=model)


def nuscenes_novel_depth_bundle() -> Config:
    """``nuscenes_novel_depth`` with visibility compaction + 2x2
    corner-bundled MSDA gathers: the exact-semantics novel-view eval recipe
    (compaction drops provably-zero attention pairs, bundling is an fp
    reassociation)."""
    cfg = nuscenes_novel_depth()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder,
                                    cross_visible_capacity=(0.3, 0.75, 0.7),
                                    msda_bundle="full"))
    return dataclasses.replace(cfg, name="nuscenes_novel_depth_bundle",
                               model=model)


def nuscenes_novel_depth_fast_bundle() -> Config:
    """Fast-tier novel-view eval recipe (deviates like
    ``nuscenes_occ_fast``): ``nuscenes_novel_depth_bundle`` with head-shared
    sampling locations + bf16 backbone/neck compute."""
    cfg = nuscenes_novel_depth_bundle()
    model = dataclasses.replace(
        cfg.model,
        compute_dtype="bfloat16",
        encoder=dataclasses.replace(cfg.model.encoder, shared_locations=True))
    return dataclasses.replace(cfg, name="nuscenes_novel_depth_fast_bundle",
                               model=model)


def kitti_novel_depth_bundle() -> Config:
    """``kitti_novel_depth`` with 2x2 corner-bundled MSDA gathers (mono rig,
    no compaction to compose)."""
    cfg = kitti_novel_depth()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, msda_bundle="full"))
    return dataclasses.replace(cfg, name="kitti_novel_depth_bundle",
                               model=model)


def kitti_novel_depth_fast_bundle() -> Config:
    """Fast-tier KITTI novel-view recipe: ``kitti_novel_depth_bundle`` +
    head-shared sampling locations + bf16 backbone/neck compute (mono rig,
    no compaction)."""
    cfg = kitti_novel_depth_bundle()
    model = dataclasses.replace(
        cfg.model,
        compute_dtype="bfloat16",
        encoder=dataclasses.replace(cfg.model.encoder, shared_locations=True))
    return dataclasses.replace(cfg, name="kitti_novel_depth_fast_bundle",
                               model=model)


def kitti_occ_bundle() -> Config:
    """``kitti_occ`` with 2x2 corner-bundled MSDA gathers: the
    exact-semantics KITTI eval recipe (mono, no compaction)."""
    cfg = kitti_occ()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, msda_bundle="full"))
    return dataclasses.replace(cfg, name="kitti_occ_bundle", model=model)


_CONFIGS = {
    "tiny": tiny,
    "tiny_fast": tiny_fast,
    "nuscenes_occ": nuscenes_occ,
    "nuscenes_depth": nuscenes_depth,
    "nuscenes_novel_depth": nuscenes_novel_depth,
    "nuscenes_novel_depth_bundle": nuscenes_novel_depth_bundle,
    "nuscenes_novel_depth_fast_bundle": nuscenes_novel_depth_fast_bundle,
    "kitti_occ": kitti_occ,
    "kitti_occ_bundle": kitti_occ_bundle,
    "kitti_novel_depth": kitti_novel_depth,
    "kitti_novel_depth_bundle": kitti_novel_depth_bundle,
    "kitti_novel_depth_fast_bundle": kitti_novel_depth_fast_bundle,
    "kitti_raw_depth": kitti_raw_depth,
    "nuscenes_occ_bev": nuscenes_occ_bev,
    "nuscenes_occ_fast": nuscenes_occ_fast,
    "nuscenes_occ_fast_bundle": nuscenes_occ_fast_bundle,
    "tiny_nerfacc": tiny_nerfacc,
    "tiny_bev": tiny_bev,
    "nuscenes_occ_density": nuscenes_occ_density,
    "nuscenes_occ_compact": nuscenes_occ_compact,
    "nuscenes_occ_compact_train": nuscenes_occ_compact_train,
    "nuscenes_occ_compact_train_bundle": nuscenes_occ_compact_train_bundle,
    "nuscenes_occ_compact_bf16": nuscenes_occ_compact_bf16,
    "nuscenes_occ_compact_pairs": nuscenes_occ_compact_pairs,
    "nuscenes_occ_compact_bundle": nuscenes_occ_compact_bundle,
    "nuscenes_occ_compact_bf16_pairs": nuscenes_occ_compact_bf16_pairs,
}


def register_config(name: str, factory) -> None:
    """Make ``get_config(name)`` (the drivers' ``--py-config``) return
    ``factory()``: a config of one's own, such as a copied recipe with
    other dataset paths, label roots or teacher maps."""
    _CONFIGS[name] = factory


def get_config(name: str) -> Config:
    """Resolve a config by name or by reference-style path
    (``config/nuscenes/nuscenes_occ.py`` -> ``nuscenes_occ``)."""
    key = name
    if "/" in key or key.endswith(".py"):
        key = key.rsplit("/", 1)[-1].removesuffix(".py")
    if key not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[key]()
