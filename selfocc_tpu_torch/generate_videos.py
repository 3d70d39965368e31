"""Demo-video assembly on the PyTorch port — counterpart of the
repository's ``generate_videos.py``: tiles the per-camera images that
``vis_pics`` writes (and optional 3D projections from ``vis_3d --png``)
into an mp4 with cv2. Host only: it reads and writes files and touches no
card.

    python -m selfocc_tpu_torch.generate_videos --src-dir DIR \
        [--out demo.mp4] [--pattern depth_{idx:03d}_cam{cam}.png] \
        [--num-cams 6] [--fps 10]

Frame ``idx`` is the ``--num-cams`` images of ``--pattern``, tiled three
to a row; frames are read from 0 until one is incomplete. Unlike the JAX
driver, which prints and returns in both cases, it exits non-zero when no
frame is found or when cv2 cannot open a writer for the ``mp4v`` codec,
instead of leaving no video (or an empty file) behind with exit 0.
"""
from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

FOURCC = "mp4v"


def cat_images(frame_paths, cols=3):
    """Tile camera views into one canvas (reference ``generate_videos.py:6-50``)."""
    imgs = [cv2.imread(p) for p in frame_paths]
    imgs = [i for i in imgs if i is not None]
    if not imgs:
        return None
    h = min(i.shape[0] for i in imgs)
    w = min(i.shape[1] for i in imgs)
    imgs = [cv2.resize(i, (w, h)) for i in imgs]
    rows = -(-len(imgs) // cols)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for k, img in enumerate(imgs):
        r, c = divmod(k, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return canvas


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src-dir", required=True,
                    help="directory of vis_pics outputs")
    ap.add_argument("--out", default="demo.mp4")
    ap.add_argument("--pattern", default="depth_{idx:03d}_cam{cam}.png")
    ap.add_argument("--num-cams", type=int, default=6)
    ap.add_argument("--fps", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the frame count and the video's (height, width)."""
    args = parse_args(argv)
    idx = 0
    frames = []
    while True:
        paths = [os.path.join(args.src_dir,
                              args.pattern.format(idx=idx, cam=c))
                 for c in range(args.num_cams)]
        if not all(os.path.exists(p) for p in paths):
            break
        canvas = cat_images(paths)
        if canvas is None:
            break
        frames.append(canvas)
        idx += 1
    if not frames:
        raise SystemExit(f"generate_videos: no frames found in "
                         f"{args.src_dir} ({args.pattern})")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*FOURCC),
                         args.fps, (w, h))
    if not vw.isOpened():
        raise SystemExit(f"generate_videos: cv2 cannot write {args.out} "
                         f"with the {FOURCC} codec (this cv2 build has no "
                         "encoder for it)")
    for f in frames:
        vw.write(f)
    vw.release()
    print(f"wrote {len(frames)} frames to {args.out}")
    return {"frames": len(frames), "size": (h, w)}


if __name__ == "__main__":
    main()
