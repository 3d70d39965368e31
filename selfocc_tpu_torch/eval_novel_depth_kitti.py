"""Novel-view depth evaluation on SemanticKITTI on the PyTorch port —
counterpart of the repository's ``eval_novel_depth_kitti.py``: the flow of
``eval_novel_depth`` (``utils/eval_lib.run_novel_depth_eval``), monocular,
with the KITTI neighbours' poses.

    python -m selfocc_tpu_torch.eval_novel_depth_kitti \\
        [--py-config kitti_novel_depth] [--depth-tgt raw|max] \\
        [--num-samples N] [--synthetic] [--device cpu]

Real data: ``data.build_dataset(cfg, "novel_eval")``, the
``Kitti_Novel_View_Eval`` dataset over the odometry tree
``<data_path>/dataset`` (sequence 08); each frame's field is decoded once
and the 176 x 608 ray grid rendered from each following neighbour's camera
pose, its depth scored against that neighbour's lidar by ``ceil(distance)``
bucket. Without the tree it exits non-zero, naming the missing path.
``--synthetic`` (the procedural scene at ``--offsets``), the weights flags
and ``--device`` are ``eval_novel_depth``'s.
"""
from __future__ import annotations

from typing import Dict

from . import eval_novel_depth


def main(argv=None) -> Dict:
    return eval_novel_depth.main(argv, default_config="kitti_novel_depth")


if __name__ == "__main__":
    main()
