"""SDF regularizers and the depth smoothness loss — counterpart of
``selfocc_tpu/losses/regularizers.py``: ``EikonalLoss``,
``SecondGradLoss``, ``get_smooth_loss``, ``EdgeLoss3DMS`` and the sparsity
family (``SparsityLoss``, ``HardSparsityLoss``, ``SoftSparsityLoss``,
``AdaptiveSparsityLoss``)."""
from __future__ import annotations

import torch

from ..ops.interp import bilinear_sample
from .base import BaseLoss, register


@register
class EikonalLoss(BaseLoss):
    """``((|grad sdf| - 1)^2).mean()`` (reference ``eikonal_loss.py:19-22``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"eik_grad": "eik_grad"}

    def loss_func(self, eik_grad):
        norm = torch.linalg.norm(eik_grad, dim=-1)
        return torch.mean((norm - 1.0) ** 2)


@register
class SecondGradLoss(BaseLoss):
    """``|second derivative|.mean()`` (reference
    ``second_grad_loss.py:19-20``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"second_grad": "second_grad"}

    def loss_func(self, second_grad):
        return second_grad.abs().mean()


def get_smooth_loss(disp, img):
    """Edge-aware smoothness (monodepth2), channel-last (B, H, W, C)
    (reference ``edge_loss_3d_ms.py:7-21``)."""
    grad_disp_x = (disp[:, :, :-1] - disp[:, :, 1:]).abs()
    grad_disp_y = (disp[:, :-1] - disp[:, 1:]).abs()
    grad_img_x = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True)
    grad_img_y = (img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True)
    return (grad_disp_x * torch.exp(-grad_img_x)).mean() + \
        (grad_disp_y * torch.exp(-grad_img_y)).mean()


@register
class EdgeLoss3DMS(BaseLoss):
    """Edge-aware smoothness of the ray grid's depth, each depth map
    divided by its mean, against the current image sampled at the ray
    pixels (border padding, index ``(x + 1) / 2 (W - 1)`` of the
    normalised coordinate; reference ``edge_loss_3d_ms.py:24-79``).
    ``use_inf_mask`` blends each depth with ``max_depths`` by ``ms_accs``."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {
                "curr_imgs": "curr_imgs", "ms_depths": "ms_depths",
                "ms_rays": "ms_rays"}
        self.img_size = kwargs.get("img_size", [768, 1600])
        self.ray_resize = kwargs.get("ray_resize", None)
        self.use_inf_mask = kwargs.get("use_inf_mask", False)
        assert self.ray_resize is not None

    def loss_func(self, curr_imgs, ms_depths, ms_rays, ms_accs=None,
                  max_depths=None):
        if self.use_inf_mask:
            assert ms_accs is not None and max_depths is not None
        bs, num_cams, _ = ms_depths[0].shape
        h, w = self.ray_resize
        xn = ms_rays[:, 0] / self.img_size[1] * 2 - 1
        yn = ms_rays[:, 1] / self.img_size[0] * 2 - 1
        px = (xn + 1) * 0.5 * (curr_imgs.shape[3] - 1)
        py = (yn + 1) * 0.5 * (curr_imgs.shape[2] - 1)
        pix = torch.stack([px, py], dim=-1)
        imgs = curr_imgs.reshape(bs * num_cams, *curr_imgs.shape[2:])
        rgb = torch.stack([bilinear_sample(im, pix, "border") for im in imgs])
        rgb = rgb.reshape(bs * num_cams, h, w, -1)
        tot = 0.0
        for scale, depth in enumerate(ms_depths):
            if self.use_inf_mask:
                depth = depth * ms_accs[scale] + \
                    max_depths[scale] * (1 - ms_accs[scale])
            d = depth.reshape(bs * num_cams, h, w, 1)
            mean_d = d.mean(dim=(1, 2), keepdim=True)
            tot = tot + get_smooth_loss(d / (mean_d + 1e-6), rgb)
        return tot / len(ms_depths)


@register
class SoftSparsityLoss(BaseLoss):
    """``relu(-sdf).mean()`` on the uniform grid
    (reference ``sparsity_loss.py:65-80``)."""

    def __init__(self, weight=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"density": "density"}

    def loss_func(self, density):
        return torch.relu(-density).mean()


@register
class SparsityLoss(BaseLoss):
    """StreetSurf sech^2 sparsity, ``sech(density / 2 scale)^2`` averaged
    (reference ``sparsity_loss.py:7-28``)."""

    def __init__(self, weight=1.0, scale=1.0, input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"density": "density"}
        self.scale = scale

    def loss_func(self, density):
        return (1.0 / torch.cosh(density / (2.0 * self.scale))) ** 2

    def __call__(self, inputs):
        actual = {k: inputs[v] for k, v in self.input_dict.items()}
        return self.weight * self.loss_func(**actual).mean()


@register
class HardSparsityLoss(BaseLoss):
    """The occupied fraction ``sigmoid(-scale * density).mean()`` beyond
    ``thresh`` (reference ``sparsity_loss.py:31-62``). ``crop`` ((lo, hi)
    per axis) sets that many border voxels of each of the first three axes
    to free space (100) first, out of place as JAX's ``.at[].set``: no
    gradient reaches them."""

    def __init__(self, weight=1.0, scale=1.0, thresh=0.2,
                 crop=((0, 0), (0, 0), (0, 0)), input_dict=None, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"density": "density"}
        self.scale = scale
        self.thresh = thresh
        self.crop = crop

    def loss_func(self, density):
        for axis, (lo, hi) in enumerate(self.crop[:3]):
            for part in ((slice(0, lo),) if lo > 0 else ()) + \
                    ((slice(-hi, None),) if hi > 0 else ()):
                idx = [slice(None)] * density.dim()
                idx[axis] = part
                density = density.clone()
                density[tuple(idx)] = 100.0
        occupied = torch.sigmoid(-self.scale * density).mean()
        return torch.relu(occupied - self.thresh)


@register
class AdaptiveSparsityLoss(BaseLoss):
    """``relu(-sdf)`` of the samples behind ``depth + slack`` along each
    ray, a masked mean (reference ``sparsity_loss.py:83-114``; the JAX
    package's static-shape form): ``sdfs`` and ``ts`` (B, N, R, S), the
    head's ``sample_sdf`` and ``ts``."""

    def __init__(self, weight=1.0, input_dict=None, slack=4.0, **kwargs):
        super().__init__(weight, input_dict)
        if input_dict is None:
            self.input_dict = {"sdfs": "sdfs", "ts": "ts",
                               "ms_depths": "ms_depths"}
        self.slack = slack

    def loss_func(self, sdfs, ts, ms_depths):
        mask = ts > (ms_depths[0] + self.slack)[..., None]
        behind = torch.relu(-sdfs) * mask
        return behind.sum() / mask.sum().clamp_min(1)
