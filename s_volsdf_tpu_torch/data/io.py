"""Host-side file IO: PFM, binary PLY, OBJ meshes, MVS cam files, PNG
images (counterpart of s_volsdf_tpu/data/io.py:23-215). `save_ply`
writes the same bytes as the JAX package's.

The JAX package reads and writes images with imageio; the port carries
its own PNG codec on zlib and numpy, so it needs no image library: 8-bit
gray, gray+alpha, RGB and RGBA, non-interlaced, all five row filters on
read, filter 0 (none) on write. DTU/IDR images and the fixtures are such
PNGs. JPEGs (real BlendedMVS scans) are read by `data.jpeg`'s decoder;
`read_image` picks the reader by the file's signature.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import sys
import zlib
from typing import List, Optional, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.jpeg import decode_jpeg


# --------------------------------------------------------------------------
# PFM
# --------------------------------------------------------------------------

def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        data = np.flipud(data)
    return data, scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    image = np.flipud(image.astype(np.float32))
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("Image must be HxWx3, HxWx1 or HxW.")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


# --------------------------------------------------------------------------
# PLY (binary little-endian, xyz + optional rgb and triangles)
# --------------------------------------------------------------------------

def save_ply(filename: str, xyz: np.ndarray,
             rgb: Optional[np.ndarray] = None,
             faces: Optional[np.ndarray] = None) -> None:
    """xyz: (N, 3) float; rgb: (N, 3) uint8 or None; faces: (M, 3)
    int or None (triangle mesh)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    n = xyz.shape[0]
    with open(filename, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if rgb is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        if faces is not None:
            header += [f"element face {faces.shape[0]}",
                       "property list uchar int vertex_indices"]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if rgb is None:
            xyz.astype("<f4").tofile(f)
        else:
            rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
            rec["r"], rec["g"], rec["b"] = rgb.T.astype(np.uint8)
            rec.tofile(f)
        if faces is not None:
            frec = np.empty(faces.shape[0], dtype=[
                ("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec["n"] = 3
            frec["a"], frec["b"], frec["c"] = faces.T.astype(np.int32)
            frec.tofile(f)


def read_obj(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """The vertices (N, 3) float64 and triangles (M, 3) int64 of a
    Wavefront OBJ: `v x y z` lines and `f` lines in any of the v, v/vt,
    v/vt/vn and v//vn styles (1-based, or negative from the end);
    polygons are fan-triangulated. Enough for the BlendedMVS textured
    meshes."""
    verts: list = []
    faces: list = []
    with open(filename, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(faces, dtype=np.int64).reshape(-1, 3))


_PLY_TYPES = {b"float": "<f4", b"float32": "<f4", b"double": "<f8",
              b"uchar": "u1", b"uint8": "u1", b"int": "<i4"}


def load_ply(filename: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The vertices of a PLY as (xyz (N, 3) float32, rgb (N, 3) uint8 or
    None): the files `save_ply` writes, and ascii or binary vertex-only
    files whose first three properties are x, y, z."""
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{filename}: not a PLY file")
        fmt = f.readline().strip().split()[1]
        n = 0
        props = []
        in_vertex = False   # inside the vertex element's block
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"property") and in_vertex:
                props.append(line.split()[1:])
            elif line == b"end_header":
                break
            elif line.startswith(b"element"):
                in_vertex = False
        if fmt == b"ascii":
            data = np.loadtxt(f, max_rows=n)
            xyz = data[:, :3].astype(np.float32)
            rgb = data[:, 3:6].astype(np.uint8) if data.shape[1] >= 6 else None
            return xyz, rgb
        dtype = np.dtype([(f"p{i}", _PLY_TYPES[p[0]])
                          for i, p in enumerate(props)])
        rec = np.fromfile(f, dtype=dtype, count=n)
        xyz = np.stack([rec["p0"], rec["p1"], rec["p2"]], -1).astype(np.float32)
        rgb = None
        if len(props) >= 6 and props[3][0] in (b"uchar", b"uint8"):
            rgb = np.stack([rec["p3"], rec["p4"], rec["p5"]], -1)
        return xyz, rgb


# --------------------------------------------------------------------------
# MVS cam txt
# --------------------------------------------------------------------------

def read_camera_parameters(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """(intrinsics (3, 3), extrinsics (4, 4)) float32 of a cam file."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                               sep=" ").reshape((4, 4))
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                               sep=" ").reshape((3, 3))
    return intrinsics, extrinsics


def write_cam(filename: str, cam: np.ndarray,
              near_far: Optional[np.ndarray] = None) -> None:
    """cam: (2, 4, 4) [extrinsic, intrinsic]."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + "\n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + "\n")
        if near_far is not None:
            f.write("\n" + " ".join(str(x) for x in near_far) + "\n")


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # PNG color type -> channels


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9). row/prev: uint8."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prev                     # uint8 arithmetic wraps
    if ftype == 1:
        # Each byte adds the reconstructed byte bpp to its left: a
        # running sum per channel, mod 256.
        n = row.shape[0]
        pad = (-n) % bpp
        r = np.concatenate([row, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
        return np.cumsum(r, axis=0, dtype=np.uint8).reshape(-1)[:n]
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(n):
            a = out[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to uint8 (H, W) for gray or
    (H, W, C) with C = 2, 3 or 4."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {color}, interlace {interlace}); "
                         f"8-bit non-interlaced gray/RGB(A) only")
    ch = _CHANNELS[color]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    img = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = img[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, ch)
    return img.reshape(height, width, ch) if ch > 1 else img


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Encode uint8 (H, W), (H, W, 1|2|3|4) as an 8-bit PNG with filter
    0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 only, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {v: k for k, v in _CHANNELS.items()}.get(ch)
    if color is None:
        raise ValueError(f"write_png: shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)],
                          axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(chunk(b"IEND", b""))


_JPEG_SIG = b"\xff\xd8\xff"


def read_image(path: str) -> np.ndarray:
    """The uint8 pixels of a PNG (`read_png`) or a JPEG (`data.jpeg`,
    equal to imageio's), picked by the file's signature, not its name:
    (H, W) for grey, (H, W, C) otherwise. Any other file is refused,
    naming it."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIG:
        return read_png(path)
    if head[:3] == _JPEG_SIG:
        with open(path, "rb") as f:
            return decode_jpeg(f.read(), path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (signature "
                     f"{head[:4]!r})")


def read_img(path: str) -> np.ndarray:
    """Float32 in [0, 1] (the JAX `read_img`: raw 8-bit values / 255)
    of a PNG or a JPEG (`read_image`)."""
    return read_image(path).astype(np.float32) / 255.0


def glob_imgs(path: str) -> List[str]:
    imgs = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG", "*.bmp"):
        imgs.extend(glob.glob(os.path.join(path, ext)))
    return imgs
