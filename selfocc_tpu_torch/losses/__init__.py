"""Loss registry — counterpart of ``selfocc_tpu/losses``: the losses of the
``nuscenes_occ`` and ``kitti_occ`` recipes (``ReprojLossMonoMultiNew`` and
its ``Combine`` variant, ``RGBLossMS``, ``EikonalLoss``, ``SecondGradLoss``,
``SemCELossMS``, ``SoftSparsityLoss``) and ``SemLossMS``. ``EdgeLoss3DMS``
and the other sparsity losses (``SparsityLoss``, ``HardSparsityLoss``,
``AdaptiveSparsityLoss``) are not ported yet."""
from .base import OPENOCC_LOSS, BaseLoss, MultiLoss, build_loss, register
from .regularizers import EikonalLoss, SecondGradLoss, SoftSparsityLoss
from .reproj import ReprojLossMonoMultiNew, ReprojLossMonoMultiNewCombine
from .rgb import RGBLossMS, SemCELossMS, SemLossMS

__all__ = [
    "OPENOCC_LOSS", "BaseLoss", "MultiLoss", "build_loss", "register",
    "ReprojLossMonoMultiNew", "ReprojLossMonoMultiNewCombine",
    "RGBLossMS", "SemCELossMS", "SemLossMS", "EikonalLoss", "SecondGradLoss",
    "SoftSparsityLoss",
]
