"""utils/storage of the port against the JAX package's: the same bytes for
the same content, each package reading the other's files (Version1 JSON
and the legacy ``.wm``), and the same errors for unknown spellings."""

import json

import numpy as np
import pytest

from spread_spectrum_watermarking_torch import config as tc
from spread_spectrum_watermarking_torch.utils import storage as ts
from spread_spectrum_watermarking_tpu import config as jc
from spread_spectrum_watermarking_tpu.utils import storage as js

METHODS = ["option1", "option2", "option3"]
ORDERINGS = ["energy", "energy-orthogonal", "legacy"]
# Every (precision, rank_version) pair a file can name, and none.
PRECISIONS = [(None, 2), ("highest", 1), ("highest", 2), ("high", 1),
              ("high", 2), ("default", 1), ("default", 2)]


def _storage(pkg, cfg, method, ordering, precision, version, seed=0):
    """The same content as one package's ``WatermarkStorage``."""
    rng = np.random.default_rng(seed)
    marks = rng.standard_normal((2, 5)).astype(np.float32)
    return pkg.WatermarkStorage(
        config=pkg.Configuration(
            insert_extract=cfg.InsertExtract(alpha=0.25,
                                             method=cfg.Method(method)),
            ordering=cfg.Ordering(ordering)),
        watermarks=[pkg.DescribedWatermark(values=list(m), description=d)
                    for m, d in zip(marks, ["first mark", "zwei é"])],
        precision=None if precision is None else cfg.Precision(precision),
        rank_version=version)


def _same(a, b):
    """Two packages' storages hold the same content (compared by value)."""
    assert a.config.insert_extract.alpha == b.config.insert_extract.alpha
    assert a.config.insert_extract.method.value == \
        b.config.insert_extract.method.value
    assert a.config.ordering.value == b.config.ordering.value
    assert (a.precision is None) == (b.precision is None)
    if a.precision is not None:
        assert a.precision.value == b.precision.value
    assert a.rank_version == b.rank_version
    assert [(list(map(float, w.values)), w.description) for w in a.watermarks] \
        == [(list(map(float, w.values)), w.description) for w in b.watermarks]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_same_bytes_and_cross_reads(tmp_path, method, ordering):
    for precision, version in PRECISIONS:
        j = _storage(js, jc, method, ordering, precision, version)
        t = _storage(ts, tc, method, ordering, precision, version)
        jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
        js.save_watermark_file(jpath, j)
        ts.save_watermark_file(tpath, t)
        assert tpath.read_bytes() == jpath.read_bytes()
        # Each package reads the other's file; the port's enums come back.
        t_from_j = ts.load_watermark_file(jpath)
        j_from_t = js.load_watermark_file(tpath)
        _same(t_from_j, j_from_t)
        # "Highest" (and no precision) names no generation: it reads back
        # as the current one.
        if precision in (None, "highest"):
            t = _storage(ts, tc, method, ordering, precision, tc.RANK_VERSION)
        _same(t_from_j, t)
        assert isinstance(t_from_j.config.ordering, tc.Ordering)
        if precision is not None:
            assert isinstance(t_from_j.precision, tc.Precision)


def test_port_writes_only_the_jax_spellings():
    written = set()
    for precision, version in PRECISIONS[1:]:
        t = _storage(ts, tc, "option2", "energy", precision, version)
        written.add(json.loads(t.to_json())["Version1"]["precision"])
    assert written == set(js._JSON_TO_PRECISION)
    assert ts._PRECISION_TO_JSON.keys() == {
        (tc.Precision(p.value), v) for p, v in js._PRECISION_TO_JSON}
    assert ts._JSON_TO_METHOD.keys() == js._JSON_TO_METHOD.keys()
    assert ts._JSON_TO_ORDERING.keys() == js._JSON_TO_ORDERING.keys()


def test_reference_file_without_precision_reads_as_highest(tmp_path):
    text = json.dumps({"Version1": {
        "config": {"insert_extract": {"alpha": 0.1, "method": "Option2"},
                   "ordering": "Energy"},
        "watermarks": [{"values": [1.5, -2.0], "description": "d"}]}})
    path = tmp_path / "ref.json"
    path.write_text(text)
    t, j = ts.load_watermark_file(path), js.load_watermark_file(path)
    _same(t, j)
    assert t.precision is None and t.rank_version == tc.RANK_VERSION
    assert t.to_json() == j.to_json()


def test_legacy_wm_reads_alike(tmp_path):
    legacy = {"alpha": 0.3, "length": 3, "version": "legacy",
              "wm": [0.1, -0.2, 0.3]}
    path = tmp_path / "old.wm"
    path.write_text(json.dumps(legacy))
    t, j = ts.load_watermark_file(path), js.load_watermark_file(path)
    _same(t, j)
    assert t.config.insert_extract.method == tc.Method.OPTION2
    assert t.config.ordering == tc.Ordering.LEGACY
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("where,value", [
    ("precision", "Default3"), ("precision", 7), ("method", "Option9"),
    ("ordering", "Energetic")])
def test_unknown_spellings_raise_the_same_error(tmp_path, where, value):
    v1 = {"config": {"insert_extract": {"alpha": 0.1, "method": "Option2"},
                     "ordering": "Energy"},
          "watermarks": [{"values": [1.0], "description": ""}],
          "precision": "Default2"}
    if where == "precision":
        v1["precision"] = value
    elif where == "method":
        v1["config"]["insert_extract"]["method"] = value
    else:
        v1["config"]["ordering"] = value
    text = json.dumps({"Version1": v1})
    with pytest.raises(ValueError) as j:
        js.WatermarkStorage.from_json(text)
    with pytest.raises(ValueError) as t:
        ts.WatermarkStorage.from_json(text)
    assert str(t.value) == str(j.value)
    assert "supported spellings" in str(t.value)


def test_unknown_version_raises_the_same_error():
    text = json.dumps({"Version9": {}})
    with pytest.raises(ValueError) as j:
        js.WatermarkStorage.from_json(text)
    with pytest.raises(ValueError) as t:
        ts.WatermarkStorage.from_json(text)
    assert str(t.value) == str(j.value)
