"""JPEG decoding for the data path (the JAX package reads images through
imageio, i.e. Pillow and libjpeg-turbo). `csrc/jpeg.cpp` is a baseline
decoder whose pixels equal libjpeg-turbo's: its islow IDCT, its YCbCr
tables and its fancy upsampling. It is built with g++ at first use into
`_build/libjpeg_decode.so` and bound with ctypes.

Decoded: baseline and extended sequential Huffman (SOF0, SOF1) at 8
bits, grey or YCbCr at 4:4:4, 4:2:2 or 4:2:0, restart markers. Refused,
with the file's name and the reason: progressive, lossless,
hierarchical and arithmetic-coded files, 12-bit samples, CMYK, RGB
stored without YCbCr, other sampling layouts, truncated data. There is
no other reader to fall back on.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from s_volsdf_tpu_torch.ops.build import CSRC_DIR, GXX_FLAGS, build_library, gxx

SOURCE = os.path.join(CSRC_DIR, "jpeg.cpp")
_ERR_CAP = 512

_LIB = None
_LIB_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/jpeg.cpp into _build/libjpeg_decode.so unless an
    up-to-date library exists. Raises RuntimeError naming g++ when it
    cannot."""
    return build_library([gxx()] + GXX_FLAGS, SOURCE, "libjpeg_decode.so",
                         force)


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.jpeg_header.restype = ctypes.c_int
            lib.jpeg_header.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                ctypes.c_int32]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int32]
            _LIB = lib
        return _LIB


def decode_jpeg(data: bytes, name: str) -> np.ndarray:
    """The pixels of the JPEG file `data` as uint8: (H, W) for grey,
    (H, W, 3) RGB for YCbCr. Raises ValueError naming `name` and the
    reason for a file it does not decode."""
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_CAP)
    dims = (ctypes.c_int32 * 3)()
    if lib.jpeg_header(data, len(data), dims, err, _ERR_CAP):
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, c = dims
    out = np.empty(h * w * c, np.uint8)
    if lib.jpeg_decode(data, len(data),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.size, err, _ERR_CAP):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out.reshape((h, w, 3) if c == 3 else (h, w))
