"""PyTorch/CUDA port of ``selfocc_tpu``.

The package mirrors the JAX package's layout (``configs/``, ``data/``,
``geometry/``, ``ops/``, ``models/``, ``losses/``, ``utils/``) so each
module's counterpart is easy to find. It imports ``torch`` and never
``jax``/``flax``, and nothing of ``selfocc_tpu``: what it needs of the JAX
package's jax-free modules (configs, the data modules, the metrics) it keeps
as its own copies.

Hand-written Hopper kernels live in ``csrc/`` and are built on first use by
``_build.py``. Every kernel wrapper takes its plain PyTorch version for CPU
tensors and launches the kernel (or raises) for CUDA tensors.

Drivers: ``python -m selfocc_tpu_torch.train``, ``.eval_depth``,
``.eval_iou``, ``.eval_novel_depth``, ``.eval_iou_kitti``,
``.eval_novel_depth_kitti``, ``.vis_pics``, ``.vis_3d`` and
``.vis_3d_scene`` (``--device cuda`` by default); ``.generate_videos`` and
``.examine_sweeps`` run on the host.
"""
