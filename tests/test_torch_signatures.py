"""Every public callable of the JAX package takes no parameter the port's
counterpart lacks: the top level, ``core``, ``ops``, ``models``,
``parallel``, ``utils`` and ``core.conv``, and every public method of the
four facades.  The only exceptions are the PyTorch idioms of
:data:`IDIOMS`, each with the port's parameter that takes its place."""
import importlib
import inspect

import pytest

import pdwt_tpu
import pdwt_tpu_torch

#: (namespace, name) -> {JAX parameter: (the port's parameters in its place, why)}
IDIOMS = {
    ("ops", "random_shift"): {"key": (("generator",), "a torch.Generator draws the shifts "
                                                      "where JAX splits a PRNG key")},
    ("models", "denoise_step"): {"key": (("generator",), "the same, for the cycle-spinning "
                                                         "shift")},
    ("models", "denoise_step_3d"): {"key": (("generator",), "the same, for the volume's "
                                                            "three shifts")},
    ("models", "cycle_spin_denoise"): {"key": (("generator",), "the same, for every spin")},
    ("parallel", "make_mesh"): {"devices": (("device_type",), "init_device_mesh places ranks "
                                                              "by device type, not by a "
                                                              "device list")},
    ("parallel", "make_pad_fn"): {"mesh_shape": (("mesh",), "the ring exchange needs the "
                                                            "DeviceMesh's process groups, "
                                                            "not only its shape")},
    ("parallel", "ring_wrap_pad"): {"n_shards": (("mesh", "axis_name"), "the ring's size and "
                                                                        "group come from the "
                                                                        "mesh axis")},
}

NAMESPACES = ("top", "core", "ops", "models", "parallel", "utils", "core.conv")
FACADES = ("Wavelets", "WaveletPackets", "Starlet", "DualTree")


def _module(pkg, ns):
    return pkg if ns == "top" else importlib.import_module(f"{pkg.__name__}.{ns}")


def _public(ns):
    mod = _module(pdwt_tpu, ns)
    if ns == "core.conv":  # the functions the module defines
        return sorted(n for n, v in vars(mod).items() if not n.startswith("_")
                      and inspect.isfunction(v) and v.__module__ == mod.__name__)
    return sorted(n for n in mod.__all__ if callable(getattr(mod, n))
                  and not inspect.ismodule(getattr(mod, n)))


CASES = [(ns, name) for ns in NAMESPACES for name in _public(ns)]
METHODS = [(cls, name) for cls in FACADES
           for name in sorted(n for n in dir(getattr(pdwt_tpu, cls))
                              if (not n.startswith("_") or n == "__init__")
                              and inspect.isfunction(getattr(getattr(pdwt_tpu, cls), n)))]


def _missing(theirs, mine):
    return [p for p in inspect.signature(theirs).parameters
            if p not in inspect.signature(mine).parameters]


@pytest.mark.parametrize("ns,name", CASES, ids=[f"{ns}.{n}" for ns, n in CASES])
def test_port_takes_every_jax_parameter(ns, name):
    theirs = getattr(_module(pdwt_tpu, ns), name)
    mine = getattr(_module(pdwt_tpu_torch, ns), name)
    try:
        inspect.signature(theirs)
    except (TypeError, ValueError):
        pytest.fail(f"{ns}.{name} has no signature")
    idioms = IDIOMS.get((ns, name), {})
    assert _missing(theirs, mine) == list(idioms)
    for port_params, _ in idioms.values():
        assert set(port_params) <= set(inspect.signature(mine).parameters)


@pytest.mark.parametrize("cls,name", METHODS, ids=[f"{c}.{n}" for c, n in METHODS])
def test_facade_methods_take_every_jax_parameter(cls, name):
    theirs = getattr(getattr(pdwt_tpu, cls), name)
    mine = getattr(getattr(pdwt_tpu_torch, cls), name, None)
    assert mine is not None, f"{cls}.{name}"
    assert _missing(theirs, mine) == []


def test_idiom_table_names_only_real_gaps():
    """Every row of the table is a JAX parameter of a public callable."""
    for (ns, name), rows in IDIOMS.items():
        params = inspect.signature(getattr(_module(pdwt_tpu, ns), name)).parameters
        assert set(rows) <= set(params), (ns, name)
