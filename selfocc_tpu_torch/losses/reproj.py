"""Multi-frame photometric reprojection losses (monodepth2-style, per camera)
— counterpart of ``selfocc_tpu/losses/reproj.py``.

Per camera: ray sample at depth t -> homogeneous pixel (u*t, v*t, t, 1) ->
project with img2prevImg / img2nextImg -> bilinear-sample the neighbour RGB
-> photometric difference to the current RGB -> render-weight accumulation
per ray -> SSIM blend -> automask min -> mean. Per-sample tensors are dense
(B, N, R, S), as in the JAX package. Quirks kept: the ``_sample_img``
index scaling, the automask failure fill of 1e3, border padding for warped
samples, weight renormalisation by the per-ray valid-weight sum.
"""
from __future__ import annotations

import torch

from ..geometry.projection import cal_pixel
from ..ops.interp import bilinear_sample
from ..ops.ssim import ssim
from .base import BaseLoss, register

_FAIL = 1e3
_EPS = float(torch.finfo(torch.float32).eps)


def _sample_img(img, pix, img_size):
    """img (H, W, 3), pix (..., 2) pixels in the ``img_size`` frame ->
    (..., 3), border padding. The reference normalises by the config
    img_size and samples with ``align_corners=True``, so the fractional
    index is ``pix * (dim_img - 1) / img_size`` (``reproj.py:31-45``)."""
    sx = (img.shape[1] - 1) / img_size[1]
    sy = (img.shape[0] - 1) / img_size[0]
    idx = torch.stack([pix[..., 0] * sx, pix[..., 1] * sy], dim=-1)
    return bilinear_sample(img, idx, padding="border")


def _ssim_ray_grid(pred, target, ray_resize):
    """SSIM over the ray grid -> per-ray (R,) channel-mean map."""
    h, w = ray_resize
    p = pred.reshape(1, h, w, -1)
    t = target.reshape(1, h, w, -1)
    return ssim(p, t).mean(-1).reshape(-1)


class _ReprojBase(BaseLoss):

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {
                "curr_imgs": "curr_imgs", "prev_imgs": "prev_imgs",
                "next_imgs": "next_imgs", "weights": "weights", "ts": "ts",
                "img2prevImg": "img2prevImg", "img2nextImg": "img2nextImg",
                "ms_rays": "ms_rays"}
        self.img_size = kwargs.get("img_size", [768, 1600])
        self.ray_resize = kwargs.get("ray_resize", None)
        self.no_automask = kwargs.get("no_automask", False)
        self.no_ssim = kwargs.get("no_ssim", False) or self.ray_resize is None

    def _project_and_sample(self, rays, t, trans, img):
        """rays (R, 2), t (R, S), trans (4, 4), img (H, W, 3) ->
        rgb (R, S, 3), mask (R, S)."""
        coords = torch.cat([rays[:, None, :] * t[..., None], t[..., None],
                            torch.ones_like(t[..., None])], dim=-1)
        pix, mask = cal_pixel(trans, coords, self.img_size)
        return _sample_img(img, pix, self.img_size), mask

    def _reproj(self, pred, target):
        l1 = (target - pred).abs().mean(-1)
        if self.no_ssim:
            return l1
        return 0.85 * _ssim_ray_grid(pred, target, self.ray_resize) + \
            0.15 * l1


def _delta_weights(w, delta):
    delta = delta.detach()
    return torch.where(delta < _EPS, torch.zeros_like(w), w) / \
        delta.clamp_min(_EPS)


@register
class ReprojLossMonoMultiNewCombine(_ReprojBase):
    """Combined prev + next difference before the automask min (reference
    ``reproj_loss_mono_multi_new_combine.py:41-248``)."""

    def loss_func(self, curr_imgs, prev_imgs, next_imgs, weights, ts,
                  img2prevImg, img2nextImg, ms_rays, deltas=None):
        # imgs (B, N, H, W, 3); weights / ts (B, N, R, S); mats (B, N, 4, 4)
        bs, num_cams = curr_imgs.shape[:2]
        if bs != 1:
            raise ValueError("the reprojection loss takes batch size 1")
        rays = ms_rays
        tot = 0.0
        for cam in range(num_cams):
            w, t = weights[0, cam], ts[0, cam]
            curr, prev, nxt = (curr_imgs[0, cam], prev_imgs[0, cam],
                               next_imgs[0, cam])
            if deltas is not None:
                w = _delta_weights(w, deltas[0, cam])
            rgb_prev, prev_mask = self._project_and_sample(
                rays, t, img2prevImg[0, cam], prev)
            rgb_next, next_mask = self._project_and_sample(
                rays, t, img2nextImg[0, cam], nxt)
            rgb_curr = _sample_img(curr, rays, self.img_size)   # (R, 3)
            zero = torch.zeros_like(w)
            diff_prev = torch.where(
                prev_mask, (rgb_curr[:, None] - rgb_prev).abs().mean(-1), zero)
            diff_next = torch.where(
                next_mask, (rgb_curr[:, None] - rgb_next).abs().mean(-1), zero)
            cnt = prev_mask.float() + next_mask.float()
            general_mask = cnt > 0
            diff = (diff_prev + diff_next) / cnt.clamp_min(1.0)
            w = torch.where(general_mask, w, zero)               # (R, S)
            w_norm = w / w.sum(-1, keepdim=True).clamp_min(_EPS)
            prev_next_loss = (w_norm * diff).sum(-1)             # (R,)
            if not self.no_ssim:
                rgb_p = torch.where(prev_mask[..., None], rgb_prev,
                                    torch.zeros_like(rgb_prev))
                rgb_n = torch.where(next_mask[..., None], rgb_next,
                                    torch.zeros_like(rgb_next))
                rgb_comb = (rgb_p + rgb_n) / cnt.clamp_min(1.0)[..., None]
                rgb_comb = (w_norm[..., None] * rgb_comb).sum(-2)  # (R, 3)
                ssim_l = _ssim_ray_grid(rgb_comb, rgb_curr, self.ray_resize)
                prev_next_loss = 0.15 * prev_next_loss + 0.85 * ssim_l
            if not self.no_automask:
                mask_prev_l = self._reproj(
                    _sample_img(prev, rays, self.img_size), rgb_curr)
                mask_next_l = self._reproj(
                    _sample_img(nxt, rays, self.img_size), rgb_curr)
                prev_next_loss = torch.where(
                    general_mask.any(-1), prev_next_loss,
                    torch.full_like(prev_next_loss, _FAIL))
                proj = torch.stack([prev_next_loss, mask_prev_l, mask_next_l],
                                   dim=-1).amin(-1)
            else:
                proj = prev_next_loss
            tot = tot + proj.mean()
        return tot / num_cams


@register
class ReprojLossMonoMultiNew(_ReprojBase):
    """Per-direction (prev / next separately) reprojection with the automask
    min (reference ``reproj_loss_mono_multi_new.py:72-288``)."""

    def _direction_loss(self, rgb_dir, mask_dir, w, rgb_curr):
        w_dir = torch.where(mask_dir, w, torch.zeros_like(w))
        w_dir = w_dir / w_dir.sum(-1, keepdim=True).clamp_min(_EPS)
        l1 = (w_dir * (rgb_curr[:, None] - rgb_dir).abs().mean(-1)).sum(-1)
        if not self.no_ssim:
            rgb_new = (w_dir[..., None] * rgb_dir).sum(-2)
            s = _ssim_ray_grid(rgb_new, rgb_curr, self.ray_resize)
            loss = 0.85 * s + 0.15 * l1
        else:
            loss = l1
        return torch.where(mask_dir.any(-1), loss, torch.full_like(loss, _FAIL))

    def loss_func(self, curr_imgs, prev_imgs, next_imgs, weights, ts,
                  img2prevImg, img2nextImg, ms_rays, deltas=None):
        bs, num_cams = curr_imgs.shape[:2]
        if bs != 1:
            raise ValueError("the reprojection loss takes batch size 1")
        rays = ms_rays
        tot = 0.0
        for cam in range(num_cams):
            w, t = weights[0, cam], ts[0, cam]
            if deltas is not None:
                w = _delta_weights(w, deltas[0, cam])
            curr, prev, nxt = (curr_imgs[0, cam], prev_imgs[0, cam],
                               next_imgs[0, cam])
            rgb_prev, prev_mask = self._project_and_sample(
                rays, t, img2prevImg[0, cam], prev)
            rgb_next, next_mask = self._project_and_sample(
                rays, t, img2nextImg[0, cam], nxt)
            rgb_curr = _sample_img(curr, rays, self.img_size)
            cands = [self._direction_loss(rgb_prev, prev_mask, w, rgb_curr),
                     self._direction_loss(rgb_next, next_mask, w, rgb_curr)]
            if not self.no_automask:
                cands.append(self._reproj(
                    _sample_img(prev, rays, self.img_size), rgb_curr))
                cands.append(self._reproj(
                    _sample_img(nxt, rays, self.img_size), rgb_curr))
            tot = tot + torch.stack(cands, dim=-1).amin(-1).mean()
        return tot / num_cams
