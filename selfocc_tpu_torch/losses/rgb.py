"""Rendered-RGB and rendered-semantics supervision losses — counterpart of
``selfocc_tpu/losses/rgb.py`` (``RGBLossMS``, ``SemLossMS``,
``SemCELossMS``) on channel-last images and dense sem targets."""
from __future__ import annotations

import torch

from ..ops.interp import bilinear_sample
from ..ops.ssim import ssim
from .base import BaseLoss, register


@register
class RGBLossMS(BaseLoss):
    """L1 (+ SSIM) between rendered colours and GT pixels at the rays
    (reference ``rgb_loss_ms.py:41-99``); GT sampled with zeros padding."""

    def __init__(self, weight=1.0, img_size=None, no_ssim=True,
                 ray_resize=None, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {
                "ms_colors": "ms_colors", "ms_rays": "ms_rays",
                "gt_imgs": "color_imgs"}
        if img_size is None:
            raise ValueError("RGBLossMS needs img_size")
        self.img_size = img_size
        self.no_ssim = no_ssim or ray_resize is None
        self.ray_resize = ray_resize

    def loss_func(self, ms_colors, ms_rays, gt_imgs):
        # ms_colors [(B, N, R, 3)]; gt_imgs (B, N, H, W, 3); rays (R, 2)
        bs, num_cams = gt_imgs.shape[:2]
        # normalise by img_size, then the align_corners=True fractional
        # index (norm + 1) / 2 * (dim - 1)
        xn = ms_rays[:, 0] / self.img_size[1] * 2 - 1
        yn = ms_rays[:, 1] / self.img_size[0] * 2 - 1
        px = (xn + 1) * 0.5 * (gt_imgs.shape[3] - 1)
        py = (yn + 1) * 0.5 * (gt_imgs.shape[2] - 1)
        pix = torch.stack([px, py], dim=-1)                  # (R, 2)
        imgs = gt_imgs.reshape(bs * num_cams, *gt_imgs.shape[2:])
        gt = torch.stack([bilinear_sample(im, pix, "zeros") for im in imgs])
        gt = gt.reshape(bs, num_cams, -1, gt.shape[-1])      # (B, N, R, 3)
        tot = 0.0
        for color in ms_colors:
            loss = (color - gt).abs().mean()
            if not self.no_ssim:
                h, w = self.ray_resize
                c = color.reshape(bs * num_cams, h, w, -1)
                g = gt.reshape(bs * num_cams, h, w, -1)
                loss = 0.15 * loss + 0.85 * ssim(c, g).mean()
            tot = tot + loss
        return tot / len(ms_colors)


class _SemBase(BaseLoss):

    def __init__(self, weight=1.0, img_size=None, ray_resize=None,
                 input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"sem": "sem", "sem_gt": "sem_gt",
                               "ms_rays": "ms_rays"}
        if img_size is None:
            raise ValueError(f"{type(self).__name__} needs img_size")
        self.img_size = img_size
        self.ray_resize = ray_resize

    def _gather_gt(self, sem_gt, ms_rays, num_cls):
        """sem_gt (B, N, H, W) integer labels at the rays' integer pixel
        (reference ``rgb_loss_ms.py:199-202``) -> one-hot (B, N, R, cls)."""
        xi = ms_rays[:, 0].long().clamp(0, sem_gt.shape[3] - 1)
        yi = ms_rays[:, 1].long().clamp(0, sem_gt.shape[2] - 1)
        gt = sem_gt[:, :, yi, xi].long()
        # jax.nn.one_hot: a label outside [0, num_cls) is all zeros
        classes = torch.arange(num_cls, device=gt.device)
        return (gt[..., None] == classes).float()


@register
class SemLossMS(_SemBase):
    """BCE between rendered semantics and the 2D sem map (reference
    ``rgb_loss_ms.py:103-155``)."""

    def loss_func(self, sem, sem_gt, ms_rays):
        gt = self._gather_gt(sem_gt, ms_rays, sem[0].shape[-1])
        tot = 0.0
        for s in sem:
            s = s.clamp(1e-7, 1 - 1e-7)
            bce = -(gt * torch.log(s) + (1 - gt) * torch.log(1 - s))
            tot = tot + bce.mean()
        return tot / len(sem)


@register
class SemCELossMS(_SemBase):
    """CE on already-softmaxed rendered semantics (reference
    ``rgb_loss_ms.py:160-213``): ``mean(sum(-log(s) * onehot))``."""

    def loss_func(self, sem, sem_gt, ms_rays):
        gt = self._gather_gt(sem_gt, ms_rays, sem[0].shape[-1])
        tot = 0.0
        for s in sem:
            s = s.clamp(1e-6, 1.0)
            tot = tot + torch.mean(torch.sum(-torch.log(s) * gt, dim=-1))
        return tot / len(sem)
