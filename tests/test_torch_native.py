"""The port's builds of native/ssw_native.cpp and native/ssw_codec.cpp.

The RNG and quantization cases of tests/test_native.py against the port's
first-use build (bit-equal to the pure-Python generator and to the
colorspace functions), the codec cases on generated JPEG and PNG files
(skipped where the libjpeg and libpng headers are absent, as the JAX tests
skip an unbuilt codec), and the build itself: cached, raising on a broken
source, skipped without its tools, and whole when two processes build at
once.
"""

import io
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from spread_spectrum_watermarking_torch.bench import _pink_texture
from spread_spectrum_watermarking_torch.ops import colorspace
from spread_spectrum_watermarking_torch.utils import (_codec, _hostbuild,
                                                      _native, image_io,
                                                      rng_compat)
from spread_spectrum_watermarking_tpu.ops import colorspace as jax_colorspace
from spread_spectrum_watermarking_tpu.utils import _native as jax_native

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    if not _native.available():
        pytest.skip(f"RNG not built: {_native.BUILD_INFO['missing']} absent")
    return _native


@pytest.fixture(scope="module")
def codec():
    if not _codec.available():
        pytest.skip(f"codec not built: {_codec.BUILD_INFO['missing']} absent")
    return _codec


def test_chacha8_stream_matches_python(native):
    py = rng_compat.ChaChaRng.seed_from_u64(12345)
    want = np.asarray([py.next_u64() for _ in range(500)], dtype=np.uint64)
    got = native.chacha8_u64s(12345, 500)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2, 0xBAAAAAAD])
def test_normal_sequence_bit_identical_to_python(native, seed):
    rng = rng_compat.ChaChaRng.seed_from_u64(seed)
    want = np.asarray(
        [rng_compat.standard_normal_f64(rng) for _ in range(2000)],
        dtype=np.float32)
    got = native.generate_fixed_normal_sequence(seed, 2000)
    np.testing.assert_array_equal(got, want)


def test_rng_compat_dispatches_to_native(native, monkeypatch):
    seq = rng_compat.generate_fixed_normal_sequence(7, 100)
    assert seq.dtype == np.float32 and seq.shape == (100,)
    assert native.BUILD_INFO["status"] in ("built", "cached")
    monkeypatch.setattr(native, "generate_fixed_normal_sequence",
                        lambda seed, length: "native")
    assert rng_compat.generate_fixed_normal_sequence(7, 100) == "native"


def test_quantize_matches_colorspace(native):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 64, 3)) * 0.7 + 0.5).astype(np.float32)
    got = native.quantize_u8(x)
    np.testing.assert_array_equal(got, colorspace.np_f32_to_u8(x))
    np.testing.assert_array_equal(got, jax_colorspace.np_f32_to_u8(x))


def test_dequantize_matches_colorspace(native):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = native.dequantize_f32(x)
    np.testing.assert_array_equal(got, colorspace.np_u8_to_f32(x))
    np.testing.assert_array_equal(got, jax_colorspace.np_u8_to_f32(x))


def test_build_matches_the_jax_packages_binary(native):
    # The JAX package ships a prebuilt copy of the same source.
    ours, theirs = _native._EXT.module(), jax_native._native_impl
    for seed in (1, 2, 0xBAAAAAAD):
        assert (ours.generate_fixed_normal_sequence_bytes(seed, 1000)
                == theirs.generate_fixed_normal_sequence_bytes(seed, 1000))
        assert ours.chacha8_u64s_bytes(seed, 64) == theirs.chacha8_u64s_bytes(
            seed, 64)
    arr = np.linspace(-0.25, 1.25, 4096, dtype=np.float32).tobytes()
    assert ours.quantize_u8_bytes(arr) == theirs.quantize_u8_bytes(arr)


def _texture(seed, h=96, w=128):
    return _pink_texture(np.random.default_rng(seed), h, w)


@pytest.mark.parametrize("fmt", [
    dict(format="JPEG", quality=95, subsampling=0),  # 4:4:4
    dict(format="JPEG", quality=75, subsampling=2),  # 4:2:0
    dict(format="PNG"),
])
def test_native_decode_is_pil_identical(codec, fmt):
    # The numerics start at decoded pixels: the codec and PIL may not
    # disagree by one code (the same libjpeg, JDCT_ISLOW).
    buf = io.BytesIO()
    Image.fromarray(_texture(4, 90, 131)).save(buf, **fmt)
    data = buf.getvalue()
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(codec.decode_rgb_u8(data), pil)


def test_native_png_encode_lossless_roundtrip(codec, tmp_path):
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
    png = codec.encode_png(arr)
    back = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    np.testing.assert_array_equal(back, arr)
    # and through the image_io save/load path (native encode + decode)
    p = tmp_path / "x.png"
    image_io.save_rgb(p, arr)
    assert p.read_bytes() == png
    np.testing.assert_array_equal(image_io.load_rgb_u8(p), arr)


def test_native_decode_rejects_unknown_and_falls_back(codec, tmp_path):
    with pytest.raises(ValueError):
        codec.decode_rgb_u8(b"not an image at all")
    # image_io falls back to PIL for formats the codec rejects (BMP here).
    arr = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = tmp_path / "x.bmp"
    Image.fromarray(arr, mode="RGB").save(p)
    np.testing.assert_array_equal(image_io.load_rgb_u8(p), arr)


def test_native_png_guard_16bit_and_gamma_fall_back_to_pil(codec, tmp_path):
    # libpng would decode 16-bit and gAMA PNGs with a scaling or a gamma
    # PIL does not apply: the codec rejects them and image_io takes PIL.
    deep = (np.arange(32 * 32, dtype=np.uint16).reshape(32, 32) * 17) % 65535
    buf = io.BytesIO()
    Image.fromarray(deep).save(buf, format="PNG")  # mode I;16 inferred
    with pytest.raises(ValueError, match="16-bit"):
        codec.decode_rgb_u8(buf.getvalue())
    p16 = tmp_path / "deep.png"
    p16.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(
        image_io.load_rgb_u8(p16), np.asarray(Image.open(p16).convert("RGB")))

    # An 8-bit RGB PNG with a gAMA chunk spliced in after IHDR.
    arr = np.random.default_rng(9).integers(0, 256, (24, 31, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="RGB").save(buf, format="PNG")
    plain_png = buf.getvalue()
    gama_body = b"gAMA" + struct.pack(">I", 25000)  # gamma 0.25
    gama = (struct.pack(">I", 4) + gama_body
            + struct.pack(">I", zlib.crc32(gama_body)))
    ihdr_end = 8 + 4 + 4 + 13 + 4  # sig + len + "IHDR" + data + crc
    data = plain_png[:ihdr_end] + gama + plain_png[ihdr_end:]
    p = tmp_path / "gamma.png"
    p.write_bytes(data)
    with pytest.raises(ValueError, match="gAMA"):
        codec.decode_rgb_u8(data)
    np.testing.assert_array_equal(
        image_io.load_rgb_u8(p), np.asarray(Image.open(p).convert("RGB")))
    np.testing.assert_array_equal(codec.decode_rgb_u8(plain_png), arr)


def test_second_build_is_cached(native, tmp_path):
    src = _hostbuild.NATIVE_DIR / "ssw_native.cpp"
    first = _hostbuild.HostExtension("_native_impl", src, build_root=tmp_path)
    second = _hostbuild.HostExtension("_native_impl", src, build_root=tmp_path)
    assert first.available() and second.available()
    assert (first.info["status"], second.info["status"]) == ("built", "cached")
    assert first.info["path"] == second.info["path"]
    assert str(tmp_path) in first.info["path"]


def test_another_compiler_or_machine_builds_anew(native, tmp_path,
                                                 monkeypatch):
    src = _hostbuild.NATIVE_DIR / "ssw_native.cpp"
    first = _hostbuild.HostExtension("_native_impl", src, build_root=tmp_path)
    assert first.available()
    monkeypatch.setattr(_hostbuild, "_compiler_version",
                        lambda gxx: "g++ (another host) 99.0")
    other_gxx = _hostbuild.HostExtension("_native_impl", src,
                                         build_root=tmp_path)
    assert other_gxx.available()
    monkeypatch.setattr(_hostbuild.platform, "machine", lambda: "other-arch")
    other_arch = _hostbuild.HostExtension("_native_impl", src,
                                          build_root=tmp_path)
    assert other_arch.available()
    assert [e.info["status"] for e in (other_gxx, other_arch)] == [
        "built", "built"]
    assert len({e.info["path"] for e in (first, other_gxx, other_arch)}) == 3


def test_failed_build_raises(native, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    ext = _hostbuild.HostExtension("_native_impl", broken,
                                   build_root=tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ext.available()
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [broken]


def test_missing_tools_take_the_plain_version(tmp_path, monkeypatch):
    monkeypatch.setattr(_hostbuild.shutil, "which", lambda name: None)
    ext = _hostbuild.HostExtension(
        "_native_impl", _hostbuild.NATIVE_DIR / "ssw_native.cpp",
        build_root=tmp_path)
    assert not ext.available()
    assert ext.info == {"status": "skipped", "missing": "g++"}
    with pytest.raises(ImportError, match="g\\+\\+ not found"):
        ext.module()
    headers = _hostbuild.HostExtension(
        "_codec_impl", _hostbuild.NATIVE_DIR / "ssw_codec.cpp",
        headers=("no_such_header_here.h",), build_root=tmp_path)
    monkeypatch.undo()
    assert not headers.available()
    assert headers.info["missing"] == "no_such_header_here.h"
    assert list(tmp_path.iterdir()) == []


_BUILD_ONE = """
import sys
from spread_spectrum_watermarking_torch.utils import _hostbuild
ext = _hostbuild.HostExtension(
    "_native_impl", _hostbuild.NATIVE_DIR / "ssw_native.cpp",
    build_root=sys.argv[1])
assert ext.available()
print(ext.info["status"])
"""


def test_two_processes_building_at_once_leave_one_library(native, tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    files = sorted(p for p in tmp_path.rglob("*") if p.is_file())
    assert len(files) == 1 and files[0].name.startswith("_native_impl")
    again = _hostbuild.HostExtension(
        "_native_impl", _hostbuild.NATIVE_DIR / "ssw_native.cpp",
        build_root=tmp_path)
    assert again.available() and again.info["status"] == "cached"
    want = native.generate_fixed_normal_sequence(1, 1000)
    got = np.frombuffer(again.module().generate_fixed_normal_sequence_bytes(
        1, 1000), dtype="<f4")
    np.testing.assert_array_equal(got, want)
