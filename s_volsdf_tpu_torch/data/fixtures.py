"""Write a synthetic scene to disk in the DTU or BlendedMVS on-disk
layout (IDR cameras.npz + PNG images, and mvs_data pair.txt or the
BlendedMVS hash directory's cam files), so the whole data path —
scene_dataset, mvs_dataset, runner — reads the formats real data uses
(counterpart of s_volsdf_tpu/data/fixtures.py:18-200).

The files hold the same cameras, pixels and pair lists as the JAX
package's fixture; the PNGs are encoded by the port's own writer. With
`image_format="jpg"` the images are baseline JPEGs instead, as real
BlendedMVS scans ship them, written by `write_jpeg` (a small encoder
for fixtures and tests: the machines the port runs on have no image
library).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.io import write_cam, write_png
from s_volsdf_tpu_torch.data.splits import (get_eval_ids, get_trains_ids,
                                            scan2hash)
from s_volsdf_tpu_torch.data.synthetic import SyntheticScene, make_sphere_scene


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


# --------------------------------------------------------------------------
# A baseline JPEG writer (JFIF, Huffman tables of Annex K.3)
# --------------------------------------------------------------------------

FIXTURE_JPEG_QUALITY, FIXTURE_JPEG_SUBSAMPLING = 95, "4:2:0"

# Annex K.1 and K.2's quantization tables, row-major.
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QUANT_CHROMA = np.full(64, 99)
_QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3's Huffman tables: code counts by length 1-16, then symbols.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _zigzag() -> np.ndarray:
    """The row-major index of each zigzag position."""
    cells = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda c: (c[0] + c[1],
                                  c[0] if (c[0] + c[1]) % 2 else c[1]))
    return np.array([8 * i + j for i, j in cells])


_ZIGZAG = _zigzag()
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """Annex K's tables scaled as libjpeg's jpeg_quality_scaling and
    jpeg_add_quant_table (baseline: 1..255), row-major."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_QUANT_LUMA, _QUANT_CHROMA))


def _huffman_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """The canonical codes of a (counts, symbols) table: code and length
    by symbol (length 0: no code)."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG's size category of each value and its extra bits."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    bits = np.where(v < 0, v + (1 << size) - 1, v)
    return size, bits


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 64) row-major."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
        h // 8, w // 8, 64)


def _entropy_code(coefs: np.ndarray, comp: np.ndarray,
                  tables: List[Dict]) -> bytes:
    """Huffman-code quantized blocks (N, 64) in zigzag order, scan order,
    each block's component `comp` (N,) selecting its tables; stuffed."""
    n = coefs.shape[0]
    dc = coefs[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    keys, syms, tabs, extra, extra_len = [], [], [], [], []

    def add(key, sym, tab, bits, nbits):
        keys.append(key)
        syms.append(sym)
        tabs.append(tab)
        extra.append(bits)
        extra_len.append(nbits)

    size, bits = _magnitude(diff)
    add(np.arange(n) * 256, size, 2 * comp.clip(0, 1), bits, size)
    b, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    first = np.ones(b.size, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    size, bits = _magnitude(coefs[b, k])
    ac_tab = 2 * comp[b].clip(0, 1) + 1
    add(b * 256 + 2 * k + 1, (run % 16) * 16 + size, ac_tab, bits, size)
    zrl = np.repeat(np.arange(b.size), run // 16)
    add(b[zrl] * 256 + 2 * k[zrl], np.full(zrl.size, 0xF0), ac_tab[zrl],
        np.zeros(zrl.size, np.int64), np.zeros(zrl.size, np.int64))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    add(eob * 256 + 255, np.zeros(eob.size, np.int64),
        2 * comp[eob].clip(0, 1) + 1, np.zeros(eob.size, np.int64),
        np.zeros(eob.size, np.int64))

    order = np.argsort(np.concatenate(keys), kind="stable")
    sym, tab = np.concatenate(syms)[order], np.concatenate(tabs)[order]
    ext, ext_len = np.concatenate(extra)[order], np.concatenate(extra_len)[order]
    code = np.zeros_like(sym)
    code_len = np.zeros_like(sym)
    for t, table in enumerate(tables):
        sel = tab == t
        code[sel], code_len[sel] = table["code"][sym[sel]], table["len"][sym[sel]]
    if (code_len == 0).any():
        raise ValueError("write_jpeg: a symbol outside the Annex K tables")
    value = (code << ext_len) | ext
    nbits = code_len + ext_len
    starts = np.cumsum(nbits) - nbits
    tok = np.repeat(np.arange(value.size), nbits)
    shift = nbits[tok] - 1 - (np.arange(tok.size) - starts[tok])
    bitstream = ((value[tok] >> shift) & 1).astype(np.uint8)
    bitstream = np.concatenate(
        [bitstream, np.ones((-bitstream.size) % 8, np.uint8)])
    data = np.packbits(bitstream)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = FIXTURE_JPEG_QUALITY,
                subsampling: str = FIXTURE_JPEG_SUBSAMPLING) -> bytes:
    """A baseline JFIF file of uint8 RGB (H, W, 3): JFIF's YCbCr,
    chroma at 4:2:0 (2x2 means) or 4:4:4, a float DCT, Annex K's tables
    at `quality`. Any baseline decoder reads it; its bytes are not
    Pillow's."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg: uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"write_jpeg: subsampling {subsampling!r}: 4:2:0 "
                         f"or 4:4:4")
    H, W = img.shape[:2]
    f = 2 if subsampling == "4:2:0" else 1
    mh, mw = -(-H // (8 * f)) * 8 * f, -(-W // (8 * f)) * 8 * f
    x = np.pad(img.astype(np.float64), ((0, mh - H), (0, mw - W), (0, 0)),
               mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    planes[1:] = [p.reshape(mh // f, f, mw // f, f).mean(axis=(1, 3))
                  for p in planes[1:]]
    qt = quality_tables(quality)
    my, mx = mh // (8 * f), mw // (8 * f)
    per_mcu, comp = [], []
    for c, plane in enumerate(planes):
        blk = _blocks(plane - 128.0)
        blk = np.einsum("ux,abxy,vy->abuv", _DCT, blk.reshape(
            blk.shape[:2] + (8, 8)), _DCT).reshape(blk.shape)
        q = np.round(blk / qt[min(c, 1)]).astype(np.int64)
        s = f if c == 0 else 1
        q = q.reshape(my, s, mx, s, 64).transpose(0, 2, 1, 3, 4).reshape(
            my * mx, s * s, 64)
        per_mcu.append(q)
        comp += [c] * (s * s)
    coefs = np.concatenate(per_mcu, axis=1).reshape(-1, 64)[:, _ZIGZAG]
    comps = np.tile(np.array(comp), my * mx)
    tables = []
    for spec in (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA):
        code, length = _huffman_codes(spec)
        tables.append({"code": code, "len": length})
    scan = _entropy_code(coefs, comps, tables)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xDB, b"".join(bytes([t]) + bytes(
               qt[t][_ZIGZAG].astype(np.uint8)) for t in range(2)))]
    sof = struct.pack(">BHHB", 8, H, W, 3)
    for c in (1, 2, 3):
        sof += bytes([c, (f * 16 + f) if c == 1 else 0x11, min(c - 1, 1)])
    out.append(_segment(0xC0, sof))
    out.append(_segment(0xC4, b"".join(
        bytes([cls_id]) + bytes(spec[0]) + bytes(spec[1])
        for cls_id, spec in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                             (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)))))
    sos = b"\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00"
    out += [_segment(0xDA, sos), scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray,
               quality: int = FIXTURE_JPEG_QUALITY,
               subsampling: str = FIXTURE_JPEG_SUBSAMPLING) -> None:
    """`encode_jpeg(img, quality, subsampling)` written to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, subsampling))


def _world_mat(c2w: np.ndarray, K: np.ndarray, world_scale: float):
    """K @ w2c of the camera lifted into the scaled world frame."""
    c2w_world = c2w.copy()
    c2w_world[:3, 3] *= world_scale
    w2c = np.linalg.inv(c2w_world)
    world_mat = np.eye(4, dtype=np.float32)
    world_mat[:3, :4] = K[:3, :3] @ w2c[:3, :4]
    return world_mat


class _ImageWriter:
    """Writes a scene's images as <dir>/<id:06d>.png, or .jpg with
    `image_format="jpg"` (`encode_jpeg` at the fixture's quality and
    subsampling, each distinct view encoded once)."""

    def __init__(self, scene: SyntheticScene, image_format: str):
        if image_format not in ("png", "jpg"):
            raise ValueError(f"image_format={image_format!r}: png or jpg")
        self.scene, self.fmt, self.jpegs = scene, image_format, {}

    def __call__(self, img_dir: str, image_id: int, view: int) -> None:
        path = os.path.join(img_dir, f"{image_id:06d}.{self.fmt}")
        img = _to_uint8(self.scene.images[view])
        if self.fmt == "png":
            write_png(path, img)
            return
        if view not in self.jpegs:
            self.jpegs[view] = encode_jpeg(img)
        with open(path, "wb") as f:
            f.write(self.jpegs[view])


def write_idr_scene(root: str, scene: SyntheticScene, scan_id: int = 106,
                    data_dir: str = "DTU", world_scale: float = 200.0,
                    n_pad_views: int = 49, image_format: str = "png") -> str:
    """Write `scene` as <root>/<data_dir>/scan<scan_id>/ in IDR format.

    world_scale maps the unit-sphere scene into a DTU-like metric frame
    (depths land in the hard-coded 425..905 hypothesis range when the
    cameras sit at radius ~2.8): scale_mat = diag(s, s, s, 1),
    world_mat = K @ w2c_world, and P = world_mat @ scale_mat.

    Views beyond the synthetic ones reuse view 0's camera and image, so
    the DTU 49-view id tables resolve. Images are PNGs, or JPEGs with
    image_format="jpg".
    """
    inst = os.path.join(root, data_dir, f"scan{scan_id}")
    img_dir = os.path.join(inst, "image")
    os.makedirs(img_dir, exist_ok=True)
    write_image = _ImageWriter(scene, image_format)

    V = scene.poses.shape[0]
    cams = {}
    scale_mat = np.eye(4, dtype=np.float32)
    scale_mat[0, 0] = scale_mat[1, 1] = scale_mat[2, 2] = world_scale
    for i in range(max(n_pad_views, V)):
        v = i if i < V else 0
        cams[f"world_mat_{i}"] = _world_mat(scene.poses[v],
                                            scene.intrinsics[v], world_scale)
        cams[f"scale_mat_{i}"] = scale_mat
        write_image(img_dir, i, v)
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    return inst


def write_pair_file(root: str, scan: str, train_ids: List[int],
                    n_views: int = 49, data_dir: str = "DTU") -> str:
    """Write mvs_data/<scan>/pair.txt listing every view with the other
    training views as its sources (the runner only reads training
    refs)."""
    mvs_dir = os.path.join(root, data_dir, "mvs_data", scan)
    os.makedirs(mvs_dir, exist_ok=True)
    path = os.path.join(mvs_dir, "pair.txt")
    _write_pairs(path, train_ids, n_views)
    return path


def _write_pairs(path: str, train_ids: List[int], n_views: int) -> None:
    """Every view with the other training views as its sources."""
    with open(path, "w") as f:
        f.write(f"{n_views}\n")
        for ref in range(n_views):
            srcs = [t for t in train_ids if t != ref] or train_ids[:2]
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " +
                    " ".join(f"{s} {100.0 - i}" for i, s in enumerate(srcs))
                    + "\n")


def write_bmvs_cam_files(root: str, scan: str, scene: SyntheticScene,
                         view_map, world_scale: float,
                         depth_min: float, depth_max: float,
                         n_views: int = 64) -> None:
    """Per-view MVS cam txt files and pair.txt under the scan's BlendedMVS
    hash directory, mvs_data/<hash>/cams/. Line 11 of a cam file is
    'depth_min depth_interval 192 depth_max'."""
    cams_dir = os.path.join(root, "BlendedMVS", "mvs_data", scan2hash(scan),
                            "cams")
    os.makedirs(cams_dir, exist_ok=True)
    interval = (depth_max - depth_min) / 192
    for vid in range(n_views):
        sidx = view_map.get(vid, 0)
        c2w = scene.poses[sidx].copy()
        c2w[:3, 3] *= world_scale
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.linalg.inv(c2w)
        cam[1, :3, :3] = scene.intrinsics[sidx][:3, :3]
        write_cam(os.path.join(cams_dir, f"{vid:08d}_cam.txt"), cam,
                  near_far=np.array([depth_min, interval, 192.0, depth_max]))
    _write_pairs(os.path.join(cams_dir, "pair.txt"), list(view_map.keys()),
                 n_views)


def make_bmvs_fixture(root: str, scan_id: int = 1,
                      img_res: Tuple[int, int] = (64, 96),
                      world_scale: float = 200.0,
                      image_format: str = "png") -> str:
    """BlendedMVS-layout fixture for scan_id: its protocol training ids
    mapped onto 3 distinct synthetic views (cameras at radius 2.8), the
    other ids copies of view 0, and cam files whose depth range is the
    camera distance +- 220. image_format="jpg" writes the images as
    JPEGs (quality 95, 4:2:0), as real scans ship them; the default PNGs
    equal the JAX package's fixture."""
    scene = make_sphere_scene(n_views=3, img_res=img_res, cam_radius=2.8)
    train_ids = get_trains_ids("BlendedMVS", f"scan{scan_id}", 3)
    n_views = max(train_ids) + 16
    write_idr_scene(root, scene, scan_id=scan_id, data_dir="BlendedMVS",
                    world_scale=world_scale, n_pad_views=n_views,
                    image_format=image_format)
    inst = os.path.join(root, "BlendedMVS", f"scan{scan_id}")
    cams = dict(np.load(os.path.join(inst, "cameras.npz")))
    view_map = {}
    write_image = _ImageWriter(scene, image_format)
    for v, tid in enumerate(train_ids):
        view_map[tid] = v
        cams[f"world_mat_{tid}"] = _world_mat(scene.poses[v],
                                              scene.intrinsics[v], world_scale)
        write_image(os.path.join(inst, "image"), tid, v)
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    cam_dist = 2.8 * np.sqrt(1 + 0.35 ** 2) * world_scale
    write_bmvs_cam_files(root, f"scan{scan_id}", scene, view_map,
                         world_scale, depth_min=cam_dist - 220,
                         depth_max=cam_dist + 220, n_views=n_views)
    return root


def make_dtu_fixture(root: str, scan_id: int = 106,
                     img_res: Tuple[int, int] = (64, 96),
                     world_scale: float = 200.0,
                     n_eval_views: int = 0) -> str:
    """Full DTU-layout fixture: 49 views (3 distinct), cameras at radius
    2.8 so scaled depths fall inside the DTU 425..905 range.

    n_eval_views > 0 also renders that many distinct held-out views onto
    the first DTU eval ids, with DTU-layout foreground masks under
    eval_mask/; the other padded ids stay copies of view 0."""
    scene = make_sphere_scene(n_views=3 + n_eval_views, img_res=img_res,
                              cam_radius=2.8)
    write_idr_scene(root, scene, scan_id=scan_id, world_scale=world_scale)
    train_ids = [25, 22, 28]
    # Views 0-2 -> train ids, views 3.. -> eval ids.
    inst = os.path.join(root, "DTU", f"scan{scan_id}")
    cams = dict(np.load(os.path.join(inst, "cameras.npz")))
    id_map = list(zip(range(3), train_ids))
    if n_eval_views:
        eval_ids = get_eval_ids("DTU")[:n_eval_views]
        id_map += list(zip(range(3, 3 + n_eval_views), eval_ids))
        mask_dir = os.path.join(root, "DTU", "eval_mask",
                                f"scan{scan_id}", "mask")
        os.makedirs(mask_dir, exist_ok=True)
    for v, tid in id_map:
        cams[f"world_mat_{tid}"] = _world_mat(scene.poses[v],
                                              scene.intrinsics[v], world_scale)
        write_png(os.path.join(inst, "image", f"{tid:06d}.png"),
                  _to_uint8(scene.images[v]))
        if n_eval_views and v >= 3:
            m = (np.isfinite(scene.depths[v])[..., None]
                 * np.ones(3)).astype(np.uint8) * 255
            write_png(os.path.join(mask_dir, f"{tid:03d}.png"), m)
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    write_pair_file(root, f"scan{scan_id}", train_ids)
    return root
