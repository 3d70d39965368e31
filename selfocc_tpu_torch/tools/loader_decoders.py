"""The training loaders' host time with the native image decoder and on
their cv2 path, on any host (no card needed): what ``chip_smoke.py
[data]`` measures where the decoder builds.

It fabricates ``chip_smoke.py``'s full-size nuScenes tree (8 keyframes x 6
cameras of 900 x 1600 JPEGs) and SemanticKITTI tree (1226 x 370 PNGs) in
a temporary directory, then runs ``chip_smoke.decoder_check`` on 24 JPEGs
and 8 PNGs (the native decode against cv2's, and the set's decode seconds
both ways) and ``chip_smoke.loader_rates`` on ``nuscenes_occ``'s train
items (seconds per item, prefetch items/s and a cProfile of two items,
with the native decoder and again on the cv2 path). Where the decoder
does not build it says why and measures the cv2 path alone.

    python3 selfocc_tpu_torch/tools/loader_decoders.py [OUT.json]

Run from the repository root. These are host seconds of the machine it
runs on; report them with its core count, which the log gives.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    root = tempfile.mkdtemp(prefix="selfocc_decoders_")
    try:
        nusc = os.path.join(root, "nuscenes")
        occ_cfg, _ = cs.fabricated_configs(cs.fabricate_nuscenes(nusc))
        kitti = os.path.join(root, "kitti")
        cs.fabricate_kitti(kitti)
        res = {
            "jpeg": cs.decoder_check("nuscenes", sorted(glob.glob(
                os.path.join(nusc, "samples", "*.jpg")))[:24], cs.FAB_IMG),
            "png": cs.decoder_check("kitti", sorted(glob.glob(
                os.path.join(kitti, "dataset", "sequences", "00",
                             "image_2", "*.png")))[:8], cs.KITTI_IMG),
            "loader": cs.loader_rates(occ_cfg)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    text = json.dumps(res)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
