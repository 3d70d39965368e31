"""Index-pkl maintenance helpers — the port's copy of
``selfocc_tpu/utils/temporal_pkl.py``.

Behavioral rewrite of ``utils/temporal_pkl.py``: sort a flat infos pkl by
(scene, timestamp) and record per-scene index ranges — the ``scene_info`` map
consumed by ``nuScenes_One_Frame_Eval``'s ``scene_name`` filter.
"""
from __future__ import annotations

import pickle
from collections import defaultdict


def sort_infos_by_scene(infos, scene_key="scene_token",
                        time_key="timestamp"):
    """Returns (sorted_infos, scene_info) where scene_info maps scene -> the
    inclusive (first, last) index range after sorting."""
    infos = sorted(infos, key=lambda s: (s[scene_key], s[time_key]))
    scene_info = {}
    for i, s in enumerate(infos):
        tok = s[scene_key]
        if tok not in scene_info:
            scene_info[tok] = [i, i]
        else:
            scene_info[tok][1] = i
    return infos, {k: tuple(v) for k, v in scene_info.items()}


def rewrite_pkl(src: str, dst: str, scene_key="scene_token"):
    with open(src, "rb") as f:
        data = pickle.load(f)
    infos, scene_info = sort_infos_by_scene(data["infos"], scene_key)
    data["infos"] = infos
    data["scene_info"] = scene_info
    with open(dst, "wb") as f:
        pickle.dump(data, f)
    return scene_info
