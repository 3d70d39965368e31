"""Loss registry — counterpart of ``selfocc_tpu/losses`` (the five losses of
the ``nuscenes_occ`` recipe and two siblings; ``EdgeLoss3DMS`` and the
sparsity family are not ported yet)."""
from .base import OPENOCC_LOSS, BaseLoss, MultiLoss, build_loss, register
from .regularizers import EikonalLoss, SecondGradLoss
from .reproj import ReprojLossMonoMultiNew, ReprojLossMonoMultiNewCombine
from .rgb import RGBLossMS, SemCELossMS, SemLossMS

__all__ = [
    "OPENOCC_LOSS", "BaseLoss", "MultiLoss", "build_loss", "register",
    "ReprojLossMonoMultiNew", "ReprojLossMonoMultiNewCombine",
    "RGBLossMS", "SemCELossMS", "SemLossMS", "EikonalLoss", "SecondGradLoss",
]
