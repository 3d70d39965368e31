"""Novel-view depth evaluation driver on the PyTorch port — counterpart of
the repository's ``eval_novel_depth.py`` (the paper's novel-depth table).

    python -m selfocc_tpu_torch.eval_novel_depth \\
        --py-config nuscenes_novel_depth [--depth-tgt raw|max] \\
        [--num-samples N] [--synthetic] [--device cpu]

Per sample: decode the field once (``prepare``), then for each temporal
neighbour render the 450 x 800-per-camera ray grid from the neighbour's
camera poses and bucket the depth errors against its lidar depth by
``ceil(distance)`` (``utils/eval_lib.run_novel_depth_eval``); prints the
bucket table. Real data: ``data.build_dataset(cfg, "novel_eval")``, the
``nuScenes_One_Frame_Eval`` dataset over
``data/nuscenes_infos_val_temporal_v2.pkl`` with images and sweeps under
``data/nuscenes/`` (without them it exits non-zero, naming the missing
path). ``--synthetic``: the procedural scene, whose neighbours are the ego
offsets ``--offsets`` (``SyntheticDataset.novel_view_sample``).
``--depth-tgt max`` scores the argmax-weight render (``max_depth``).
Weights are seeded (``--seed``), or loaded from ``--ckpt-path`` /
``--torch-ckpt``. Runs on the first CUDA device unless ``--device cpu``
asks for the kernels' plain versions on the CPU; with no card and no
``--device cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
from typing import Dict

from .configs.experiments import get_config
from .eval_depth import build_model
from .utils.eval_lib import (ChunkedRenderer, enable_max_depth,
                             novel_eval_first_sample, run_novel_depth_eval)
from .utils.runtime import (add_device_arg, add_weights_args, get_dataset,
                            get_logger, load_weights, resolve_device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--py-config", required=True)
    ap.add_argument("--batch", type=int, default=32768,
                    help="rays per render chunk")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--offsets", type=float, nargs="*",
                    default=[-2.0, -1.0, 1.0, 2.0],
                    help="synthetic ego offsets standing in for neighbours")
    ap.add_argument("--depth-tgt", default="raw", choices=["raw", "max"],
                    help="scored render: raw (expected depth) or max (the "
                         "argmax-weight render)")
    ap.add_argument("--seed", type=int, default=42)
    add_weights_args(ap)
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.py_config)
    depth_key = "depth" if args.depth_tgt == "raw" else "max_depth"
    if args.depth_tgt == "max":
        cfg = enable_max_depth(cfg)
    real = not args.synthetic
    ds = get_dataset(cfg, args.synthetic, phase="novel_eval")
    logger = get_logger()
    sample = novel_eval_first_sample(ds, cfg, real)
    logger.info(f"config {cfg.name} on {device}; {len(ds)} samples, input "
                f"{tuple(sample['imgs'].shape)}")
    model = build_model(cfg, args.seed, device)
    load_weights(model, args.ckpt_path, args.torch_ckpt, logger)
    renderer = ChunkedRenderer(model, chunk=args.batch, outputs=(depth_key,))
    return run_novel_depth_eval(ds, real, cfg, renderer, logger, device,
                                num_samples=args.num_samples,
                                offsets=tuple(args.offsets),
                                depth_key=depth_key)


if __name__ == "__main__":
    main()
