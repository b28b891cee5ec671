"""The port's JPEG decoder (csrc/jpeg.cpp through data/jpeg.py) against
imageio.v2.imread (Pillow on libjpeg-turbo), the port's JPEG fixture
writer, and `read_img`'s choice of reader. Every JPEG is written here at
test time by Pillow or by the writer.

The decode must be bit-equal to imageio's: the decoder repeats
libjpeg-turbo's integer IDCT, colour tables and fancy upsampling. A
file it does not decode raises naming the file and the reason; nothing
falls back to another reader.
"""

import io
import itertools
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image, ImageFile

from s_volsdf_tpu_torch.data import fixtures
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data.jpeg import decode_jpeg

SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}
SIZES = [(1, 1), (7, 9), (8, 8), (16, 16), (17, 33), (37, 53), (576, 768)]


def _image(hw, channels=3, seed=0, noise=20.0):
    """Smooth colour waves plus noise: sharp enough to exercise every
    coefficient, smooth enough for long zero runs."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    waves = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                      for k in range(channels)], -1)
    noise = np.random.default_rng(seed).normal(0, noise, waves.shape)
    img = np.clip(waves + noise, 0, 255).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


def _pillow_jpeg(tmp_path, img, **kwargs) -> bytes:
    """Pillow's JPEG of img. Its optimizing encoder writes the whole file
    in one buffer, which must hold the noisy 576x768 images."""
    path = tmp_path / "img.jpg"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ImageFile, "MAXBLOCK", 1 << 23)
        Image.fromarray(img).save(path, "JPEG", **kwargs)
    return path.read_bytes()


def _assert_decodes_like_imageio(data: bytes):
    want = imageio.imread(io.BytesIO(data))
    got = decode_jpeg(data, "test.jpg")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subsampling,quality", itertools.product(
    sorted(SUBSAMPLING), [50, 75, 95, 100]))
@pytest.mark.parametrize("hw", SIZES)
def test_decode_matches_imageio(tmp_path, hw, subsampling, quality):
    data = _pillow_jpeg(tmp_path, _image(hw), quality=quality,
                        subsampling=subsampling)
    _assert_decodes_like_imageio(data)


@pytest.mark.parametrize("hw", SIZES)
def test_decode_grey_matches_imageio(tmp_path, hw):
    data = _pillow_jpeg(tmp_path, _image(hw, channels=1), quality=90)
    assert decode_jpeg(data, "grey.jpg").ndim == 2
    _assert_decodes_like_imageio(data)


@pytest.mark.parametrize("subsampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("hw", [(37, 53), (576, 768)])
def test_decode_optimized_tables_matches_imageio(tmp_path, hw, subsampling):
    """Pillow's optimize=True: Huffman tables fitted to the image."""
    _assert_decodes_like_imageio(_pillow_jpeg(
        tmp_path, _image(hw), quality=90, subsampling=subsampling,
        optimize=True))


@pytest.mark.parametrize("restart", [{"restart_marker_rows": 1},
                                     {"restart_marker_blocks": 3}])
@pytest.mark.parametrize("subsampling", sorted(SUBSAMPLING))
@pytest.mark.parametrize("hw", [(37, 53), (576, 768)])
def test_decode_restart_markers_matches_imageio(tmp_path, hw, subsampling,
                                                restart):
    data = _pillow_jpeg(tmp_path, _image(hw), quality=90,
                        subsampling=subsampling, **restart)
    assert b"\xff\xdd" in data                      # a DRI segment
    _assert_decodes_like_imageio(data)


@pytest.mark.parametrize("subsampling", [0, 2])
def test_decode_16_bit_tables_matches_imageio(tmp_path, subsampling):
    """Quantization values above 255: Pillow writes 16-bit DQT tables in
    an extended sequential frame (SOF1)."""
    data = _pillow_jpeg(tmp_path, _image((37, 53)), subsampling=subsampling,
                        qtables=[[300] * 64, [1000 + i for i in range(64)]])
    dqt = data.index(b"\xff\xdb")
    assert b"\xff\xc1" in data and data[dqt + 4] >> 4 == 1
    _assert_decodes_like_imageio(data)


def _refused(data: bytes, name: str, *words):
    with pytest.raises(ValueError) as exc:
        decode_jpeg(data, name)
    msg = str(exc.value)
    assert msg.startswith(name + ": "), msg
    for w in words:
        assert w in msg, msg


def test_refuses_progressive(tmp_path):
    data = _pillow_jpeg(tmp_path, _image((37, 53)), progressive=True)
    _refused(data, "scans/progressive.jpg", "progressive", "SOF2")


def test_refuses_cmyk(tmp_path):
    img = Image.fromarray(_image((37, 53))).convert("CMYK")
    path = tmp_path / "cmyk.jpg"
    img.save(path, "JPEG")
    assert imageio.imread(path).shape[-1] == 4
    _refused(path.read_bytes(), "cmyk.jpg", "4 components", "CMYK")


def test_refuses_rgb_without_ycbcr(tmp_path):
    """keep_rgb=True stores RGB with an Adobe transform of 0."""
    data = _pillow_jpeg(tmp_path, _image((37, 53)), keep_rgb=True)
    _refused(data, "rgb.jpg", "RGB", "Adobe transform of 0")


@pytest.mark.parametrize("keep", [0.5, 0.9, -2])
def test_refuses_truncated(tmp_path, keep):
    data = _pillow_jpeg(tmp_path, _image((37, 53)))
    cut = data[:int(len(data) * keep)] if keep > 0 else data[:keep]
    with pytest.raises(OSError, match="truncated"):
        imageio.imread(io.BytesIO(cut))
    _refused(cut, "truncated.jpg", "truncated")


@pytest.mark.parametrize("marker,words", [
    (0xC3, ("lossless", "SOF3")), (0xC9, ("arithmetic", "SOF9")),
    (0xC2, ("progressive", "SOF2"))])
def test_refuses_other_frame_types(tmp_path, marker, words):
    data = bytearray(_pillow_jpeg(tmp_path, _image((16, 16))))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    _refused(bytes(data), "patched.jpg", *words)


def test_refuses_12_bit(tmp_path):
    data = bytearray(_pillow_jpeg(tmp_path, _image((16, 16))))
    sof = data.index(b"\xff\xc0")
    data[sof + 1], data[sof + 4] = 0xC1, 12
    _refused(bytes(data), "deep.jpg", "12-bit")


def test_refuses_other_sampling(tmp_path):
    """4:1:1 (the luma sampled 4x1)."""
    data = bytearray(_pillow_jpeg(tmp_path, _image((16, 32)), subsampling=0))
    sof = data.index(b"\xff\xc0")
    data[sof + 11] = 0x41
    _refused(bytes(data), "411.jpg", "sampling layout 4x1,1x1,1x1")


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
@pytest.mark.parametrize("hw", [(7, 9), (37, 53), (64, 96)])
def test_write_jpeg_decodes_alike(tmp_path, hw, subsampling):
    """The fixture writer's files decode equal in imageio and the port,
    close to their source (quality 95; little noise, which 4:2:0 would
    average away)."""
    img = _image(hw, seed=1, noise=2.0)
    path = str(tmp_path / "w.jpg")
    fixtures.write_jpeg(path, img, 95, subsampling)
    data = open(path, "rb").read()
    _assert_decodes_like_imageio(data)
    got = decode_jpeg(data, path).astype(np.float64)
    assert 10 * np.log10(255 ** 2 / np.mean((got - img) ** 2)) > 30


def test_write_jpeg_tables_match_pillow():
    """Pillow's quantization tables are Annex K's scaled as libjpeg
    does; the writer's equal them at each quality."""
    for q in (10, 50, 95):
        buf = io.BytesIO()
        Image.fromarray(_image((16, 16))).save(buf, "JPEG", quality=q)
        tables = Image.open(io.BytesIO(buf.getvalue())).quantization
        for t, ours in enumerate(fixtures.quality_tables(q)):
            assert list(tables[t]) == list(ours)


def test_read_img_picks_the_reader_by_signature(tmp_path):
    """A PNG named .jpg and a JPEG named .png both read right; a file of
    neither kind is refused by name."""
    img = _image((17, 33))
    png_as_jpg = str(tmp_path / "a.jpg")
    tio.write_png(png_as_jpg, img)
    np.testing.assert_array_equal(tio.read_image(png_as_jpg), img)
    jpg_as_png = str(tmp_path / "b.png")
    fixtures.write_jpeg(jpg_as_png, img)
    want = imageio.imread(jpg_as_png)
    np.testing.assert_array_equal(tio.read_image(jpg_as_png), want)
    np.testing.assert_array_equal(tio.read_img(jpg_as_png),
                                  want.astype(np.float32) / 255.0)
    bmp = str(tmp_path / "c.bmp")
    Image.fromarray(img).save(bmp)
    with pytest.raises(ValueError, match="c.bmp: neither a PNG nor a JPEG"):
        tio.read_img(bmp)
    assert os.path.getsize(bmp) > 0
