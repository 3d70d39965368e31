"""Swin Transformer backbone — counterpart of ``selfocc_tpu/models/swin.py``,
the backbone of the online semantic teacher (``models/upernet.py``,
``utils/openseed_utils.TorchSemTeacher``).

The module tree is HF ``SwinBackbone``'s
(``embeddings.{patch_embeddings.projection, norm}``,
``encoder.layers.{i}.blocks.{j}.{layernorm_before, attention.self.{query,
key, value, relative_position_bias_table}, attention.output.dense,
layernorm_after, intermediate.dense, output.dense}``,
``encoder.layers.{i}.downsample.{reduction, norm}``,
``hidden_states_norms.stage{i+1}``), so an HF state dict loads by name
(``utils/swin_import.py``). The relative-position index and the shifted
windows' masks are built once from the static shapes (numpy, then kept on
the device per shape); only the bias table is a parameter. The window
products are ``torch.matmul`` (the JAX package computes them with XLA's
einsum, outside any Pallas kernel).

``always_partition=True`` is HF ``SwinBackbone``'s semantics (window and
shift fixed whatever the resolution); ``False`` is ``SwinModel``'s (the
window shrinks to ``min(resolution)`` and the shift drops to 0 where the
map is no larger than a window). The backbone takes NCHW images and
returns NCHW maps; inside, the tokens are channel-last ``(B, H, W, C)``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin-T defaults (HF ``microsoft/swin-tiny-patch4-window7-224``)."""
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5


@functools.lru_cache(maxsize=None)
def _rel_pos_index(window: int) -> np.ndarray:
    """(w*w, w*w) index into the (2w-1)^2 bias table (HF
    ``modeling_swin.py:418-429``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))                  # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]                      # (2, L, L)
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)                                             # (L, L)


@functools.lru_cache(maxsize=None)
def _shift_mask(h_pad: int, w_pad: int, window: int,
                shift: int) -> np.ndarray:
    """(nW, L, L) additive attention mask for shifted windows (HF
    ``get_attn_mask``, ``modeling_swin.py:594-620``): 0 within a region,
    -100 across the region boundaries that the cyclic shift creates."""
    img = np.zeros((h_pad, w_pad), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h_pad // window, window, w_pad // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)     # (nW, L)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _static(fn, *args, device) -> torch.Tensor:
    """``fn(*args)``'s numpy table as a tensor on ``device``, built once."""
    key = (fn.__name__, args, str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(fn(*args)).to(device)
    return _ON_DEVICE[key]


def window_partition(x, window: int):
    """(B, H, W, C) -> (B*nW, window*window, C); H, W multiples of window."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x, window: int, h: int, w: int):
    """Inverse of :func:`window_partition`."""
    c = x.shape[-1]
    x = x.reshape(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=qkv_bias)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))

    def reset_parameters_like_jax(self, generator):
        self.relative_position_bias_table.data.zero_()   # flax zeros init


class _Dense(nn.Module):
    """A named ``dense`` Linear (HF's ``SwinSelfOutput``,
    ``SwinIntermediate``, ``SwinOutput``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x):
        return self.dense(x)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (HF ``SwinAttention``:
    ``SwinSelfAttention`` + ``SwinSelfOutput``)."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.self = _SelfAttention(dim, num_heads, window, qkv_bias)
        self.output = _Dense(dim, dim)

    def forward(self, x, window: int, mask=None):
        """x (B*nW, L, C); ``window`` the window this call partitions with
        (its L = window^2); ``mask`` (nW, L, L) or None."""
        sa = self.self
        bn, L, c = x.shape
        heads = sa.num_heads
        hd = c // heads

        def split(t):
            return t.reshape(bn, L, heads, hd).transpose(1, 2)

        q, k, v = split(sa.query(x)), split(sa.key(x)), split(sa.value(x))
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        idx = _static(_rel_pos_index, window, device=x.device)
        bias = sa.relative_position_bias_table[idx.reshape(-1)].reshape(
            L, L, heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            n_w = mask.shape[0]
            attn = attn.reshape(bn // n_w, n_w, heads, L, L) \
                + mask[None, :, None]
            attn = attn.reshape(bn, heads, L, L)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.output(out.transpose(1, 2).reshape(bn, L, c))


class SwinBlock(nn.Module):
    """Pre-norm Swin layer (HF ``SwinLayer``): LN -> (S)W-MSA -> +res ->
    LN -> MLP -> +res; window and shift resolved from the static shape."""

    def __init__(self, cfg: SwinConfig, dim: int, num_heads: int,
                 shift: int):
        super().__init__()
        self.window, self.shift = cfg.window_size, shift
        eps = cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = WindowAttention(dim, num_heads, cfg.window_size,
                                         cfg.qkv_bias)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = _Dense(dim, int(cfg.mlp_ratio * dim))
        self.output = _Dense(int(cfg.mlp_ratio * dim), dim)

    def forward(self, x, always_partition: bool):
        b, h, w, c = x.shape
        window, shift = self.window, self.shift
        if not always_partition and min(h, w) <= window:
            # SwinModel semantics: the window shrinks, the shift drops (HF
            # set_shift_and_window_size)
            window, shift = min(h, w), 0
            if window < self.window:
                # the bias table is sized by the configured window (HF's
                # own lookup fails here too; the JAX package sizes it at
                # trace time)
                raise NotImplementedError(
                    f"a {h}x{w} map under a {self.window}-window block")
        y = self.layernorm_before(x)
        pad_b = (window - h % window) % window
        pad_r = (window - w % window) % window
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _static(_shift_mask, hp, wp, window, shift,
                           device=x.device)
        y = self.attention(window_partition(y, window), window, mask)
        y = window_reverse(y, window, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        y = F.gelu(self.intermediate(self.layernorm_after(x)))
        return x + self.output(y)


class PatchMerging(nn.Module):
    """2x2 concat -> LN(4C) -> Linear(4C, 2C, no bias) (HF
    ``SwinPatchMerging``; odd sizes padded first)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int):
        super().__init__()
        dim = cfg.embed_dim * 2 ** i
        self.blocks = nn.ModuleList(
            SwinBlock(cfg, dim, cfg.num_heads[i],
                      shift=0 if j % 2 == 0 else cfg.window_size // 2)
            for j in range(cfg.depths[i]))
        self.downsample = PatchMerging(dim, cfg.layer_norm_eps) \
            if i < len(cfg.depths) - 1 else None


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                    stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.patch_embeddings = _PatchEmbeddings(cfg)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Stage(cfg, i)
                                    for i in range(len(cfg.depths)))


class SwinBackbone(nn.Module):
    """Swin encoder returning each stage's map through its own LayerNorm
    (HF ``SwinBackbone`` with every stage in ``out_features``, the
    configuration UperNet reads)."""

    def __init__(self, cfg: SwinConfig = SwinConfig(),
                 always_partition: bool = True):
        super().__init__()
        self.cfg, self.always_partition = cfg, always_partition
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.hidden_states_norms = nn.ModuleDict({
            f"stage{i + 1}": nn.LayerNorm(cfg.embed_dim * 2 ** i,
                                          eps=cfg.layer_norm_eps)
            for i in range(len(cfg.depths))})

    def forward(self, images) -> List[torch.Tensor]:
        """images (B, 3, H, W) -> 4 NCHW maps at strides 4/8/16/32 with
        ``embed_dim * 2**i`` channels."""
        p = self.cfg.patch_size
        h, w = images.shape[-2:]
        images = F.pad(images, (0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.embeddings.patch_embeddings.projection(images)
        x = self.embeddings.norm(x.permute(0, 2, 3, 1))
        feats = []
        for i, stage in enumerate(self.encoder.layers):
            for block in stage.blocks:
                x = block(x, self.always_partition)
            # the stage's feature norm reads the map before the downsample
            f = self.hidden_states_norms[f"stage{i + 1}"](x)
            feats.append(f.permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return feats
