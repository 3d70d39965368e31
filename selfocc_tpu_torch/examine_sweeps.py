"""Offline nuScenes sweep-index generator on the PyTorch port — counterpart
of the repository's ``examine_sweeps.py`` (a rewrite of the reference
``examine_sweeps.py``): walks per-sensor sweeps of every scene,
synchronizes them to the least-frequent sensor's timestamps, and writes the
``*_sweeps.pkl`` index consumed by ``nuScenes_One_Frame_Sweeps_Dist``.

    python -m selfocc_tpu_torch.examine_sweeps --base-pkl \
        nuscenes_infos_val_temporal_v1.pkl --out nuscenes_infos_val_sweeps.pkl \
        [--dataroot data/nuscenes] [--version v1.0-trainval]

Requires the nuScenes devkit + raw dataset on disk (guarded import: without
the devkit it exits non-zero, naming it). Host only: it touches no card.
"""
from __future__ import annotations

import argparse
import pickle
from copy import deepcopy

import numpy as np

SENSOR_TYPES = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT", "LIDAR_TOP"]


def build_sweep_infos(nusc, base_infos):
    """reference ``examine_sweeps.py:15-90``."""

    def gather_sensor(sample_data_token):
        sample_data = nusc.get("sample_data", sample_data_token)
        data = deepcopy(sample_data)
        data.update(dict(
            pose=nusc.get("ego_pose", data["ego_pose_token"]),
            calib=nusc.get("calibrated_sensor",
                           data["calibrated_sensor_token"])))
        return data

    scenes = {}
    for sample in base_infos:
        scene_token = nusc.get("sample", sample["token"])["scene_token"]
        name = nusc.get("scene", scene_token)["name"]
        scenes.setdefault(name, scene_token)

    all_infos, meta_data = {}, []
    for scene_name, scene_token in scenes.items():
        print(f"processing {scene_name}")
        scene_meta = nusc.get("scene", scene_token)
        sample_sweep_list = []
        sample_token = scene_meta["first_sample_token"]
        while sample_token:
            sample = nusc.get("sample", sample_token)
            sample_dict = deepcopy(sample)
            data = {s: gather_sensor(sample["data"][s]) for s in SENSOR_TYPES}
            # scene_name rides along for Occ3D label resolution (Occ3D gts
            # are keyed by scene NAME, reference eval_iou.py:26-32, while
            # this pkl is keyed by scene token)
            sample_dict.update(dict(data=data, is_key_frame=True,
                                    scene_name=scene_name))
            sample_sweep_list.append(sample_dict)
            meta_data.append((scene_token, len(sample_sweep_list) - 1))

            # collect intermediate sweeps per sensor up to the next keyframe
            sweeps = {}
            for s in SENSOR_TYPES:
                chain = []
                tok = data[s]["next"]
                while tok:
                    sd = gather_sensor(tok)
                    if sd["is_key_frame"]:
                        break
                    chain.append(sd)
                    tok = sd["next"]
                sweeps[s] = chain

            least = min(SENSOR_TYPES, key=lambda s: len(sweeps[s]))
            if len(sweeps[least]) > 0:
                for ts in [v["timestamp"] for v in sweeps[least]]:
                    sweep_dict = dict(timestamp=ts, is_key_frame=False)
                    sweep_data = {}
                    for s in SENSOR_TYPES:
                        ivals = [v["timestamp"] - ts for v in sweeps[s]]
                        sweep_data[s] = sweeps[s][int(np.argmin(np.abs(ivals)))]
                    sweep_dict["data"] = sweep_data
                    sample_sweep_list.append(sweep_dict)
            sample_token = sample["next"]
        all_infos[scene_token] = sample_sweep_list
    return {"infos": all_infos, "metadata": meta_data}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--base-pkl", required=True,
                    help="nuscenes_infos_{train,val}_temporal_v1.pkl")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    try:
        from nuscenes import NuScenes
    except ImportError as e:  # the devkit is an optional dependency
        raise SystemExit(
            "nuscenes-devkit is required to build sweep indexes; run this "
            "offline where the devkit + raw data are available") from e

    nusc = NuScenes(dataroot=args.dataroot, version=args.version)
    with open(args.base_pkl, "rb") as f:
        base = pickle.load(f)
    out = build_sweep_infos(nusc, base["infos"])
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {args.out}: {len(out['metadata'])} keyframes")


if __name__ == "__main__":
    main()
