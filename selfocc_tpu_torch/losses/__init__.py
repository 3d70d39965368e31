"""Loss registry — counterpart of ``selfocc_tpu/losses``: the losses of the
``nuscenes_occ``, ``kitti_occ``, ``kitti_raw_depth`` and ``nuscenes_depth``
recipes (``ReprojLossMonoMultiNew`` and its ``Combine`` variant,
``RGBLossMS``, ``EikonalLoss``, ``SecondGradLoss``, ``SemCELossMS``,
``SoftSparsityLoss``, ``EdgeLoss3DMS``) and ``SemLossMS``. The other
sparsity losses (``SparsityLoss``, ``HardSparsityLoss``,
``AdaptiveSparsityLoss``) are not ported yet."""
from .base import OPENOCC_LOSS, BaseLoss, MultiLoss, build_loss, register
from .regularizers import (EdgeLoss3DMS, EikonalLoss, SecondGradLoss,
                           SoftSparsityLoss, get_smooth_loss)
from .reproj import ReprojLossMonoMultiNew, ReprojLossMonoMultiNewCombine
from .rgb import RGBLossMS, SemCELossMS, SemLossMS

__all__ = [
    "OPENOCC_LOSS", "BaseLoss", "MultiLoss", "build_loss", "register",
    "ReprojLossMonoMultiNew", "ReprojLossMonoMultiNewCombine",
    "RGBLossMS", "SemCELossMS", "SemLossMS", "EikonalLoss", "SecondGradLoss",
    "SoftSparsityLoss", "EdgeLoss3DMS", "get_smooth_loss",
]
