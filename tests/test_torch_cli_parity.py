"""The port's CLI against the JAX package's, in one process on the same files.

Each package's ``watermark`` output is read by the other's ``test``; both
``test`` and both ``detect`` runs over the same files print the same
records (similarities within 0.01 sigma at HIGHEST; at the fast tiers, where
near-tie rank positions order differently in the two packages, the same
``matches`` with both reads above 6 sigma); the port's ``batch`` files load
in the JAX package; and the port's ``detect`` gives the same records in
chunks of 32 as in chunks of one.
"""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from spread_spectrum_watermarking_torch import cli
from spread_spectrum_watermarking_torch.bench import _pink_texture
from spread_spectrum_watermarking_tpu import cli as jax_cli
from spread_spectrum_watermarking_tpu.utils import storage as jax_storage

TIERS = ["highest", "high", "default"]
SIGMA = 6.0


def texture_jpeg(path, seed, h=96, w=128):
    rng = np.random.default_rng(seed)
    Image.fromarray(_pink_texture(rng, h, w)).save(path, quality=95)


def port(*argv):
    return cli.main([*map(str, argv), "--device", "cpu"])


def jax(*argv):
    return jax_cli.main([*map(str, argv)])


def _marked(tmp_path, tier):
    """base.jpg and other.jpg, base marked by the port (in ``port/``) and by
    the JAX package (in ``jax/``) at ``tier``, each with another seed."""
    texture_jpeg(tmp_path / "base.jpg", seed=0)
    texture_jpeg(tmp_path / "other.jpg", seed=1)
    out = {}
    for name, main, seed in (("port", port, 5), ("jax", jax, 6)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(tmp_path / "base.jpg", d / "base.jpg")
        assert main("watermark", d / "base.jpg", "--seed", seed,
                    "--precision", tier) == 0
        out[name] = (d / "base_wm.png", d / "base_wm.json")
    return out


def _blocks(text: str) -> list:
    return [line for line in text.splitlines() if line.strip()]


def _sim(line: str) -> float:
    return float(line.split(":", 1)[1])


@pytest.mark.parametrize("tier", TIERS)
def test_files_cross_both_ways_and_both_tests_agree(tmp_path, tier, capsys):
    marked = _marked(tmp_path, tier)
    base = tmp_path / "base.jpg"
    capsys.readouterr()
    for writer, reader in (("port", jax), ("jax", port)):
        png, own = marked[writer]
        foreign = marked["jax" if writer == "port" else "port"][1]
        assert reader("test", base, png, own) == 0
        assert "Matches: true" in capsys.readouterr().out

        # Both packages' `test` on one trio (and a foreign mark): the same
        # lines but for Similarity.
        assert port("test", base, png, own, foreign) == 0
        ours = _blocks(capsys.readouterr().out)
        assert jax("test", base, png, own, foreign) == 0
        theirs = _blocks(capsys.readouterr().out)
        assert len(ours) == len(theirs) == 12
        for a, b in zip(ours, theirs):
            if a.startswith("  Similarity:"):
                if tier == "highest":
                    assert abs(_sim(a) - _sim(b)) <= 0.01, (a, b)
            else:
                assert a == b
        assert _sim(ours[2]) > SIGMA and _sim(theirs[2]) > SIGMA
        assert ours[7] == "  Matches: false"


def _detect_rows(main, jl, base, marks, derived) -> list:
    rc = main("detect", base, *marks, "--derived", *derived, "--jsonl", jl)
    assert rc == 1  # the corrupt and the resized image
    return [json.loads(s) for s in jl.read_text().splitlines()]


def _derived_set(tmp_path, marked) -> list:
    png = marked["port"][0]
    q90 = tmp_path / "requal.jpg"
    Image.open(png).save(q90, quality=90)
    (tmp_path / "corrupt.png").write_bytes(b"junk")
    Image.open(png).resize((64, 48)).save(tmp_path / "resized.png")
    return [png, q90, tmp_path / "base.jpg", tmp_path / "corrupt.png",
            tmp_path / "other.jpg", tmp_path / "resized.png",
            marked["jax"][0]]


@pytest.mark.parametrize("tier", TIERS)
def test_both_detects_give_the_same_records(tmp_path, tier):
    marked = _marked(tmp_path, tier)
    derived = _derived_set(tmp_path, marked)
    marks = [marked["port"][1], marked["jax"][1]]
    base = tmp_path / "base.jpg"
    ours = _detect_rows(port, tmp_path / "port.jsonl", base, marks, derived)
    theirs = _detect_rows(jax, tmp_path / "jax.jsonl", base, marks, derived)
    assert len(ours) == len(theirs) == 2 * 5 + 2
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if k != "similarity"} == {
            k: v for k, v in b.items() if k != "similarity"}
        if "similarity" in a and tier == "highest":
            assert abs(a["similarity"] - b["similarity"]) <= 0.01
    rows = {(r["derived"], r.get("watermark_file")): r for r in ours}
    own = str(marks[0])
    png, q90, unmarked, corrupt, other, resized, _ = map(str, derived)
    assert rows[(png, own)]["similarity"] > SIGMA
    assert rows[(q90, own)]["similarity"] > SIGMA
    assert rows[(unmarked, own)]["similarity"] == 0.0
    assert rows[(other, own)]["similarity"] < SIGMA
    assert "coefficient length" in rows[(resized, None)]["error"]
    assert "error" in rows[(corrupt, None)]


@pytest.mark.parametrize("tier", ["highest", "default"])
def test_batch_output_read_by_the_jax_package(tmp_path, tier, capsys):
    d = tmp_path / "in"
    d.mkdir()
    texture_jpeg(d / "a.jpg", seed=2)
    texture_jpeg(d / "b.jpg", seed=3)
    out = tmp_path / "out"
    assert port("batch", d, "--output-dir", out, "--seed", 7,
                "--precision", tier) == 0
    for stem in ("a", "b"):
        path = out / f"{stem}_wm.json"
        st = jax_storage.load_watermark_file(path)
        assert st.to_json() == path.read_text()  # byte for byte
        assert len(st.watermarks[0].values) == 1000
        assert st.watermarks[0].description == f"{stem}.jpg"
        capsys.readouterr()
        assert jax("test", d / f"{stem}.jpg", out / f"{stem}_wm.png",
                   path) == 0
        assert "Matches: true" in capsys.readouterr().out


@pytest.mark.parametrize("tier", TIERS)
def test_detect_chunks_change_no_record(tmp_path, tier, monkeypatch):
    marked = _marked(tmp_path, tier)
    derived = _derived_set(tmp_path, marked) * 5  # 35 paths: two chunks
    marks = [marked["port"][1], marked["jax"][1]]
    base = tmp_path / "base.jpg"
    chunked = _detect_rows(port, tmp_path / "32.jsonl", base, marks, derived)
    monkeypatch.setattr(cli, "DETECT_CHUNK", 1)
    single = _detect_rows(port, tmp_path / "1.jsonl", base, marks, derived)
    assert len(chunked) == len(single) == 5 * 12
    for a, b in zip(chunked, single):
        assert {k: v for k, v in a.items() if k != "similarity"} == {
            k: v for k, v in b.items() if k != "similarity"}
        if "similarity" in a:
            assert abs(a["similarity"] - b["similarity"]) <= 1e-5


@pytest.mark.parametrize("tier", ["highest", "default"])
def test_detect_chunk_that_raises_is_read_image_by_image(tmp_path, tier,
                                                         monkeypatch):
    # A chunk's read that fails as a whole (the card's memory, say) leaves
    # each image its own record: the images are read again one at a time.
    marked = _marked(tmp_path, tier)
    derived = _derived_set(tmp_path, marked)
    marks = [marked["port"][1], marked["jax"][1]]
    base = tmp_path / "base.jpg"
    single_read = cli.Reader._extract_stack
    calls = []

    def fails_on_stacks(self, images, n):
        calls.append(len(images))
        if len(images) > 1:
            raise RuntimeError("CUDA out of memory")
        return single_read(self, images, n)

    monkeypatch.setattr(cli.Reader, "_extract_stack", fails_on_stacks)
    chunked = _detect_rows(port, tmp_path / "32.jsonl", base, marks, derived)
    assert max(calls) == 5  # the five images of the base's shape, at once
    monkeypatch.setattr(cli, "DETECT_CHUNK", 1)
    single = _detect_rows(port, tmp_path / "1.jsonl", base, marks, derived)
    assert chunked == single
    assert sum("error" in r for r in chunked) == 2
