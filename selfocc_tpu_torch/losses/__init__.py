"""Loss registry — counterpart of ``selfocc_tpu/losses``: the losses of the
``nuscenes_occ``, ``kitti_occ``, ``kitti_raw_depth`` and ``nuscenes_depth``
recipes (``ReprojLossMonoMultiNew`` and its ``Combine`` variant,
``RGBLossMS``, ``EikonalLoss``, ``SecondGradLoss``, ``SemCELossMS``,
``SoftSparsityLoss``, ``EdgeLoss3DMS``), ``SemLossMS`` and the sparsity
losses that read the NeuS head's optional sdf outputs (``SparsityLoss``,
``HardSparsityLoss``, ``AdaptiveSparsityLoss``): every loss of the JAX
registry."""
from .base import OPENOCC_LOSS, BaseLoss, MultiLoss, build_loss, register
from .regularizers import (AdaptiveSparsityLoss, EdgeLoss3DMS, EikonalLoss,
                           HardSparsityLoss, SecondGradLoss, SoftSparsityLoss,
                           SparsityLoss, get_smooth_loss)
from .reproj import ReprojLossMonoMultiNew, ReprojLossMonoMultiNewCombine
from .rgb import RGBLossMS, SemCELossMS, SemLossMS

__all__ = [
    "OPENOCC_LOSS", "BaseLoss", "MultiLoss", "build_loss", "register",
    "ReprojLossMonoMultiNew", "ReprojLossMonoMultiNewCombine",
    "RGBLossMS", "SemCELossMS", "SemLossMS", "EikonalLoss", "SecondGradLoss",
    "SoftSparsityLoss", "SparsityLoss", "HardSparsityLoss",
    "AdaptiveSparsityLoss", "EdgeLoss3DMS", "get_smooth_loss",
]
