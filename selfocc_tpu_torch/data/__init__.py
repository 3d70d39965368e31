"""Data layer — the port's copies of the JAX package's jax-free data modules
(the synthetic scene, the nuScenes loaders, the wrapper, the transforms, the
sampler and the prefetcher) and ``build_dataset``, the counterpart of
``selfocc_tpu/data/__init__.py::build_dataset``.

``build_dataset`` mirrors the reference ``get_dataloader``
(``dataset/__init__.py:20-106``): dataset -> wrapper(aug) -> canonical array
batches. It raises FileNotFoundError, naming the path, when the dataset
index is absent; the port's drivers turn that into an error exit and never
substitute synthetic data. The KITTI datasets are not ported: a KITTI
config raises NotImplementedError.

``phase='val'`` builds the VAL split through the val wrapper pipeline (no
PhotoMetric/flip) with the reference's eval-time dataset overrides applied
(``utils/config_tools.py:10-67``: ``strict=False, cur_prob=1,
return_depth=True``). ``phase='novel_eval'`` returns the raw novel-view
evaluation dataset (``nuScenes_One_Frame_Eval`` over the temporal_v2
infos).
"""
from __future__ import annotations

import os

from .synthetic import SyntheticDataset
from .wrapper import TemporalDatasetWrapper

DEFAULT_PATHS = {
    "nuScenes_One_Frame_Sweeps_Dist": dict(
        data_path="data/nuscenes/",
        train_pkl="data/nuscenes_infos_train_sweeps.pkl",
        val_pkl="data/nuscenes_infos_val_sweeps.pkl",
        # reference modify_for_eval(novel_depth=True) swaps to
        # nuScenes_One_Frame_Eval over the temporal_v2 infos
        # (utils/config_tools.py:93-115)
        novel_pkl="data/nuscenes_infos_val_temporal_v2.pkl"),
    "Kitti_One_Frame": dict(
        data_path="data/kitti/",
        novel_pkl="data/kitti/dataset"),
    "Kitti_Raw_Stereo": dict(data_path="data/kitti_raw/"),
    "Kitti_Raw": dict(data_path="data/kitti_raw/"),
}

# the reference's modify_for_eval dataset-config surgery
# (utils/config_tools.py:10-67) — applied on top of val_dataset_args so any
# config evaluates with the current-frame-only, non-strict,
# depth-returning dataset the reference evaluates with.
EVAL_OVERRIDES = dict(strict=False, cur_prob=1.0, return_depth=True)

KITTI_TYPES = ("Kitti_One_Frame", "Kitti_Raw", "Kitti_Raw_Stereo")


def build_dataset(cfg, phase="train"):
    """Real dataset factory; FileNotFoundError (naming the path) when the
    dataset index is not on disk, NotImplementedError for a dataset type
    the port does not load (KITTI)."""
    if cfg.dataset_type in KITTI_TYPES:
        raise NotImplementedError(
            f"selfocc_tpu_torch: the {cfg.dataset_type} loaders are not "
            "ported (ROADMAP queue 1 item 7, KITTI)")
    if cfg.dataset_type != "nuScenes_One_Frame_Sweeps_Dist":
        raise NotImplementedError(
            f"selfocc_tpu_torch: no loader for dataset type "
            f"{cfg.dataset_type!r}")
    args = dict(cfg.train_dataset_args if phase == "train"
                else cfg.val_dataset_args)
    if phase == "val":
        # the novel_eval dataset has its own eval semantics baked in;
        # the overrides apply to the val-split sweeps dataset only
        args.update(EVAL_OVERRIDES)
    defaults = DEFAULT_PATHS[cfg.dataset_type]
    data_path = args.pop("data_path", defaults["data_path"])
    crop_size = args.pop("crop_size", list(cfg.img_size))

    def probe(path, what="dataset index"):
        if not path or not os.path.exists(path):
            raise FileNotFoundError(f"{what} not found: {path!r}")
        return path

    if phase == "novel_eval":
        imageset = args.pop("imageset", defaults["novel_pkl"])
        probe(imageset)
        from .nuscenes_eval_dataset import nuScenes_One_Frame_Eval
        return nuScenes_One_Frame_Eval(
            data_path=data_path, imageset=imageset,
            crop_size=crop_size, **args)

    pkl_key = "train_pkl" if phase == "train" else "val_pkl"
    imageset = args.pop("imageset", defaults[pkl_key])
    probe(imageset)
    from .nuscenes_dataset import nuScenes_One_Frame_Sweeps_Dist
    raw = nuScenes_One_Frame_Sweeps_Dist(
        data_path=data_path, imageset=imageset,
        crop_size=crop_size, **args)
    return TemporalDatasetWrapper(
        raw, phase=phase, scale_rate=cfg.scale_rate,
        photometric_aug=dict(use_swap_channel=False), **cfg.wrapper_args)


__all__ = ["SyntheticDataset", "TemporalDatasetWrapper", "build_dataset",
           "DEFAULT_PATHS", "EVAL_OVERRIDES"]
