"""utils/image_io of the port against the JAX package's: decoded pixels,
encoded files and the f32 quantization, bit for bit. Encoded files are
compared with both packages on one codec: the port builds the native one
(native/ssw_codec.cpp) where the libjpeg and libpng headers exist, and the
JAX package then gets the same one; elsewhere both use PIL."""

import numpy as np
import pytest
from PIL import Image

from spread_spectrum_watermarking_torch.ops import colorspace as tc
from spread_spectrum_watermarking_torch.utils import _codec
from spread_spectrum_watermarking_torch.utils import image_io as ti
from spread_spectrum_watermarking_tpu.ops import colorspace as jc
from spread_spectrum_watermarking_tpu.utils import image_io as ji


def _image(seed=0, h=37, w=59):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _same_codec(monkeypatch):
    """The JAX package's image_io on the codec the port's takes."""
    monkeypatch.setattr(ji, "_codec", _codec if _codec.available() else None)


def test_png_round_trip_bit_equal(tmp_path, monkeypatch):
    _same_codec(monkeypatch)
    img = _image()
    ti.save_rgb(tmp_path / "t.png", img)
    ji.save_rgb(tmp_path / "j.png", img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    t = ti.load_rgb_u8(tmp_path / "j.png")
    np.testing.assert_array_equal(t, img)
    np.testing.assert_array_equal(t, ji.load_rgb_u8(tmp_path / "t.png"))


def test_f32_save_and_load_bit_equal(tmp_path, monkeypatch):
    _same_codec(monkeypatch)
    rng = np.random.default_rng(1)
    # Values on and around the half steps, and outside [0, 1].
    f = (rng.integers(-20, 5120, (16, 24, 3)) / 5100.0).astype(np.float32)
    f[0, :4, 0] = np.float32([0.5 / 255, 1.5 / 255, -0.1, 1.3])
    np.testing.assert_array_equal(tc.np_f32_to_u8(f), jc.np_f32_to_u8(f))
    ti.save_rgb(tmp_path / "t.png", f)
    ji.save_rgb(tmp_path / "j.png", f)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    t = ti.load_rgb_f32(tmp_path / "t.png")
    j = ji.load_rgb_f32(tmp_path / "t.png")
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    u8 = _image(2)
    np.testing.assert_array_equal(tc.np_u8_to_f32(u8).view(np.uint32),
                                  jc.np_u8_to_f32(u8).view(np.uint32))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_jpeg_and_other_modes_decode_alike(tmp_path, mode):
    arr = _image(3, 48, 64)
    im = Image.fromarray(arr, "RGB").convert(mode)
    path = tmp_path / ("x.jpg" if mode != "RGBA" else "x.png")
    im.save(path)
    t = ti.load_rgb_u8(path)
    assert t.shape == (48, 64, 3) and t.dtype == np.uint8
    np.testing.assert_array_equal(t, ji.load_rgb_u8(path))


def test_batch_loader_keeps_order(tmp_path):
    paths = []
    for i in range(5):
        paths.append(tmp_path / f"{i}.png")
        ti.save_rgb(paths[-1], _image(10 + i, 8 + i, 9))
    t = ti.load_batch_u8(paths, num_threads=3)
    j = ji.load_batch_u8(paths, num_threads=3)
    assert len(t) == 5
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_good", [0, 4])
def test_batch_loader_returns_each_paths_own_error(tmp_path, n_good):
    paths = []
    for i in range(n_good):
        paths.append(tmp_path / f"{i}.png")
        ti.save_rgb(paths[-1], _image(20 + i, 8, 9 + i))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    paths.insert(n_good // 2, bad)
    with pytest.raises(Exception):
        ti.load_batch_u8(paths, num_threads=3)
    got = ti.load_batch_u8(paths, num_threads=3, return_errors=True)
    assert len(got) == len(paths)
    for p, g in zip(paths, got):
        if p == bad:
            assert isinstance(g, Exception)
        else:
            np.testing.assert_array_equal(g, ji.load_rgb_u8(p))
