"""The port's public surface keeps the JAX package's parameters.

For every name the port exports, and every public function of a port
module that has a namesake in the JAX module it mirrors, the JAX
function's parameters begin with the port's, in the same order and of the
same kind: a call written for the port means the same to the JAX package.
The one extra the port may add is a trailing keyword ``device`` on the
object wrappers (``api``). Enums carry the same members and values.
"""

import enum
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spread_spectrum_watermarking_torch as tw
from spread_spectrum_watermarking_tpu.bench import _pink_texture
from spread_spectrum_watermarking_tpu.models import pipeline as jp

PORT, JAX = "spread_spectrum_watermarking_torch", "spread_spectrum_watermarking_tpu"
MODULES = ["api", "marks", "models.pipeline", "ops.colorspace", "ops.dct",
           "ops.modulation", "ops.ranking"]


def _twin_module(name: str):
    return importlib.import_module(name.replace(PORT, JAX, 1))


def _params(fn):
    return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]


def _assert_begins_like(port_fn, jax_fn, wrapper: bool):
    port, ref = _params(port_fn), _params(jax_fn)
    if wrapper and port and port[-1] == ("device", inspect.Parameter.KEYWORD_ONLY):
        port = port[:-1]
    assert ref[:len(port)] == port, (port, ref)


def _public_methods(cls):
    return ["__init__"] + sorted(n for n, v in vars(cls).items()
                                 if not n.startswith("_")
                                 and callable(getattr(cls, n)))


@pytest.mark.parametrize("name", [n for n in tw.__all__
                                  if callable(getattr(tw, n))])
def test_exported_names_take_jax_parameters(name):
    obj = getattr(tw, name)
    twin = getattr(_twin_module(obj.__module__), obj.__name__)
    if inspect.isclass(obj) and issubclass(obj, enum.Enum):
        assert [(m.name, m.value) for m in obj] == \
            [(m.name, m.value) for m in twin]
    elif inspect.isclass(obj):
        for m in _public_methods(obj):
            _assert_begins_like(getattr(obj, m), getattr(twin, m),
                                wrapper=obj.__module__.endswith(".api"))
    else:
        _assert_begins_like(obj, twin, wrapper=False)


def _module_functions():
    out = []
    for mod in MODULES:
        port = importlib.import_module(f"{PORT}.{mod}")
        ref = _twin_module(port.__name__)
        for name, fn in vars(port).items():
            if (inspect.isfunction(fn) and not name.startswith("_")
                    and fn.__module__ == port.__name__ and hasattr(ref, name)):
                out.append(f"{mod}:{name}")
    return out


@pytest.mark.parametrize("where", _module_functions())
def test_module_functions_take_jax_parameters(where):
    mod, name = where.split(":")
    port = importlib.import_module(f"{PORT}.{mod}")
    _assert_begins_like(getattr(port, name),
                        getattr(_twin_module(port.__name__), name),
                        wrapper=False)


def test_the_covered_surface_is_the_slice():
    covered = set(_module_functions())
    for where in ("models.pipeline:embed", "models.pipeline:embed_verified",
                  "models.pipeline:extract", "ops.dct:dct2_2d",
                  "ops.dct:idct2_2d", "ops.ranking:top_indices",
                  "ops.colorspace:rgb_to_yiq", "ops.colorspace:yiq_to_rgb"):
        assert where in covered


def test_positional_quantize_means_float_output_in_both():
    # The fault this repairs: embed(x, m, cfg, False) asked JAX for float
    # output and the port for the full inverse.
    rng = np.random.default_rng(0)
    rgb = _pink_texture(rng, 37, 59)
    mark = rng.standard_normal(100).astype(np.float32)
    j = np.asarray(jp.embed(jnp.asarray(rgb), jnp.asarray(mark),
                            jp.WriteConfig(), False))
    t = tw.embed(torch.from_numpy(rgb), torch.from_numpy(mark),
                 tw.WriteConfig(), False)
    assert j.dtype == np.float32 and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
