"""Semantic maps precomputed with the port's online teacher — counterpart of
``tools/precompute_sem_jax.py``.

    python3 selfocc_tpu_torch/tools/precompute_sem.py --img-glob 'DIR/*.jpg' \\
        --out-dir SEM_DIR --teacher-ckpt CKPT [--batch 8] [--device cpu]

Loads an HF Swin-UperNet checkpoint (``.pt`` / ``.bin`` / ``.safetensors``)
into ``utils/openseed_utils.TorchSemTeacher`` and writes one
``<img_basename>.npy`` uint8 label map per image, at the image's size:
the maps that ``SemTeacher`` reads (``wrapper_args=dict(sem_from=SEM_DIR)``).
Images are batched while they have the same size. Runs on the first CUDA
device unless ``--device cpu``.
"""
import argparse
import glob
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from selfocc_tpu_torch.utils.openseed_utils import TorchSemTeacher
    from selfocc_tpu_torch.utils.runtime import add_device_arg, resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--img-glob", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--teacher-ckpt", required=True,
                    help="HF UperNet(Swin) checkpoint file")
    ap.add_argument("--batch", type=int, default=8,
                    help="images per batch (same-size images only)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    teacher = TorchSemTeacher.from_checkpoint(args.teacher_ckpt,
                                              device=device)
    try:
        import cv2
        read = lambda p: cv2.imread(p)[..., ::-1].copy()
    except ImportError:
        from PIL import Image
        read = lambda p: np.asarray(Image.open(p).convert("RGB"))

    os.makedirs(args.out_dir, exist_ok=True)
    paths = sorted(glob.glob(args.img_glob))
    if not paths:
        sys.exit(f"no images match {args.img_glob!r}")
    batch, names = [], []

    def flush():
        if not batch:
            return
        maps = teacher(np.stack(batch)).cpu().numpy()
        for name, m in zip(names, maps):
            np.save(os.path.join(args.out_dir, name + ".npy"), m)
            print(name)
        batch.clear()
        names.clear()

    shape = None
    for p in paths:
        img = read(p)
        if shape is not None and img.shape != shape:
            flush()
        shape = img.shape
        batch.append(img)
        names.append(os.path.basename(p))
        if len(batch) >= args.batch:
            flush()
    flush()


if __name__ == "__main__":
    main()
