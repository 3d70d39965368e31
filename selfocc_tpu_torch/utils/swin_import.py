"""HF UperNet (Swin) checkpoints into the port's teacher — counterpart of
``selfocc_tpu/utils/swin_import.py``.

The port's ``models/upernet.SwinUperNet`` is named as HF's
``UperNetForSemanticSegmentation`` is (its backbone as ``SwinBackbone``),
and its convolutions and Linears are torch's, so the conversion moves
nothing: it drops what the port does not keep (BatchNorm's
``num_batches_tracked``, the relative-position index that the port rebuilds
from the window, the auxiliary head) and a ``module.`` prefix.

``load_teacher_checkpoint`` reads ``.pt`` / ``.bin`` (``torch.load``) and
``.safetensors`` with the port's own reader (``read_safetensors``: an
8-byte little-endian header length, a JSON header of dtype, shape and
byte offsets, then the raw little-endian buffers), so it needs no
``safetensors`` package; ``write_safetensors`` writes the same format.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DROP = ("num_batches_tracked", "relative_position_index")
_TEACHER_KEYS = ("backbone.", "decode_head.")

# safetensors dtype names -> numpy little-endian dtypes (BF16 read as its
# 16-bit pattern, then viewed as torch.bfloat16)
_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
           "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
           "U8": "u1", "BOOL": "?"}
_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
          torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8",
          torch.bool: "BOOL"}


def _strip(state_dict) -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if not key.endswith(_DROP):
            out[key] = torch.as_tensor(val)
    return out


def convert_hf_upernet(state_dict) -> Dict[str, torch.Tensor]:
    """HF ``UperNetForSemanticSegmentation`` state dict -> the port's
    ``SwinUperNet`` state dict (the auxiliary head left out)."""
    return {k: v for k, v in _strip(state_dict).items()
            if k.startswith(_TEACHER_KEYS)}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors (CPU, in the file's dtypes)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = np.dtype(_DTYPES[info["dtype"]])
        arr = np.frombuffer(data, dtype, (end - begin) // dtype.itemsize,
                            start + begin).reshape(info["shape"])
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]):
    """Write ``tensors`` as a ``.safetensors`` file (the header padded with
    spaces to 8 bytes, the buffers in key order)."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def load_teacher_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` / ``.bin`` (torch) or ``.safetensors`` HF UperNet checkpoint
    -> the port's ``SwinUperNet`` state dict."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return convert_hf_upernet(sd)
