"""Camera projection geometry — counterpart of
``selfocc_tpu/geometry/projection.py`` (``point_sampling``, ``cal_pixel``,
``rays_from_img2lidar``, ``apply_novel_view``). All are fp32 islands: inputs are cast to float32
whatever the caller's dtype, as in the JAX package and the reference
(``@autocast(enabled=False)``)."""
from __future__ import annotations

import torch

EPS = 1e-5


def point_sampling(ref_points, lidar2img, img_shape, focal_ratios_x=None,
                   focal_ratios_y=None):
    """Project 3D reference points into every camera.

    Args:
      ref_points: (P, Q, 3) metric xyz.
      lidar2img: (B, N, 4, 4).
      img_shape: (H, W) of the network input image.
      focal_ratios_x / focal_ratios_y: optional (N,) per-camera factors of
        the normalised x / y, applied after the visibility mask is taken
        (``RandomScaleImageMultiViewImage``'s ``pad_scale_rate``; reference
        ``bevformer/utils.py:198-204``).
    Returns:
      ref_cam (N, B, Q, P, 2) normalized pixel coords; mask (N, B, Q, P) bool.
    """
    ref = ref_points.float()
    l2i = lidar2img.float()
    ref_h = torch.cat([ref, torch.ones_like(ref[..., :1])], dim=-1)  # P,Q,4
    cam = torch.einsum("bnij,pqj->bnpqi", l2i, ref_h)
    mask = cam[..., 2] > EPS
    denom = cam[..., 2:3].clamp_min(EPS)
    xy = cam[..., 0:2] / denom
    x = xy[..., 0] / img_shape[1]
    y = xy[..., 1] / img_shape[0]
    mask = mask & (x > 0.0) & (x < 1.0) & (y > 0.0) & (y < 1.0)
    if focal_ratios_x is not None:
        x = x * focal_ratios_x.float()[None, :, None, None]
    if focal_ratios_y is not None:
        y = y * focal_ratios_y.float()[None, :, None, None]
    ref_cam = torch.stack([x, y], dim=-1).permute(1, 0, 3, 2, 4)
    return ref_cam, mask.permute(1, 0, 3, 2)


def rays_from_img2lidar(img2lidar, rays):
    """(B, N, 4, 4) img->lidar matrices + (R, 2) pixel (x, y) ->
    origin (B, N, 3), direction (B, N, R, 3), not normalized."""
    m = img2lidar.float()
    rays = rays.float()
    origin = m[..., :3, 3]
    rays_pad = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    direction = torch.einsum("bnij,rj->bnri", m[..., :3, :3], rays_pad)
    return origin, direction


def apply_novel_view(img2lidar, novel_view):
    """Offset camera poses for novel-view demo rendering
    (``projection.py:89-100``, reference ``img2lidar.py:51-61``):
    ``novel_view = [dx, dy, dz, yaw_deg]``. (B, N, 4, 4) -> a new fp32
    tensor whose 3x3 blocks are rotated by the yaw about z (from the left)
    and whose translations have ``dx, dy, dz`` added; the rotation is built
    on the matrices' device."""
    dx, dy, dz, z_r = novel_view
    m = img2lidar.float().clone()
    yaw = torch.full((), z_r, dtype=torch.float32, device=m.device)
    c, s = torch.cos(torch.deg2rad(yaw)), torch.sin(torch.deg2rad(yaw))
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                       torch.stack([zero, zero, one])])
    m[..., :3, :3] = torch.einsum("ij,bnjk->bnik", rot, m[..., :3, :3])
    m[..., 0, 3] += dx
    m[..., 1, 3] += dy
    m[..., 2, 3] += dz
    return m


def cal_pixel(trans, coords, img_size):
    """Project homogeneous points through a 4x4: trans (..., 4, 4), coords
    (..., 4) (already scaled by the ray depth t), static img_size (H, W) ->
    pixel (..., 2), in-image mask (...,) (``projection.py:102-122``)."""
    trans = trans.float()
    coords = coords.float()
    pixel = torch.einsum("...ij,...j->...i", trans, coords)
    mask = pixel[..., 2] > 0
    pix = pixel[..., :2] / pixel[..., 2:3].clamp_min(EPS)
    mask = mask & (pix[..., 0] > 0) & (pix[..., 0] < img_size[1]) & \
        (pix[..., 1] > 0) & (pix[..., 1] < img_size[0])
    return pix, mask
