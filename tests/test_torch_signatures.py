"""The port's public surface against the JAX package's, by ``inspect``
only (no JAX code runs).

Every module of ``lightplane_tpu`` has a counterpart of the same path in
``lightplane_tpu_torch``; the TPU kernel modules' counterparts are the CUDA
kernels' wrappers (``KERNEL_MODULES``), whose interfaces are their own.
Outside ``ops/kernels``, every public function and class of a JAX module
exists in its counterpart, every class has every public method, and the
port's parameter names begin with the JAX ones, so a call by position or
by keyword in the JAX order means the same in both packages.

The idioms that differ by design (``IDIOMS``, ``NO_COUNTERPART``): a
``torch.Generator`` where JAX takes a PRNG key, a device where JAX takes a
dtype (and where ``utils.profiling.Timer`` takes a pytree to block on: the
port brackets the block with CUDA events), Flax's ``setup`` and the
``parent`` and ``name`` fields of every Flax module (the port's modules
build in ``__init__``), and the ``shard_map`` helpers ``zeros_with_vma`` /
``zero_cotangent`` of ``ops/renderer.py``, which have nothing to do in
PyTorch's autograd.
"""

import importlib
import inspect
from pathlib import Path

import pytest

pytest.importorskip("jax")
flax_linen = pytest.importorskip("flax.linen")  # the JAX package imports it

# parameter renames, JAX name -> port name
IDIOMS = {"key": "generator", "dtype": "device", "fence": "device"}
FLAX_FIELDS = ("parent", "name")
# (module, name) of JAX functions and methods with no counterpart
NO_COUNTERPART = {
    ("models.renderer_module", "LightplaneRenderer.setup"),
    ("models.splatter_module", "LightplaneMLPSplatter.setup"),
    ("ops.renderer", "zeros_with_vma"),
    ("ops.renderer", "zero_cotangent"),
}
# TPU kernel modules -> the port's kernel wrappers that stand in for them
# (ROADMAP.md, queue 2)
KERNEL_MODULES = {
    "ops.kernels.renderer_pallas": ("ops.kernels.renderer_fw",
                                    "ops.kernels.renderer_bw"),
    "ops.kernels.renderer_w3": ("ops.kernels.renderer_fw",
                                "ops.kernels.renderer_bw"),
    "ops.kernels.splatter_pallas": ("ops.kernels.splatter_fw",
                                    "ops.kernels.splatter_bw"),
    "ops.kernels.splatter_big": ("ops.kernels.splatter_fw",
                                 "ops.kernels.splatter_bw"),
    "ops.kernels.splatter_sorted": ("ops.kernels.splatter_fw",
                                    "ops.kernels.splatter_bw"),
}


def module_paths(package):
    root = Path(importlib.import_module(package).__file__).parent
    return sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in root.rglob("*.py"))


def load(package, path):
    path = path.removesuffix("__init__").rstrip(".")
    return importlib.import_module(f"{package}.{path}" if path else package)


def public(module):
    """The public functions and classes that ``module`` defines."""
    return {n: o for n, o in vars(module).items()
            if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == module.__name__}


def methods(cls):
    return {n: getattr(cls, n) for n, o in vars(cls).items()
            if not n.startswith("_")
            and (inspect.isfunction(o)
                 or isinstance(o, (staticmethod, classmethod)))}


def param_names(fn):
    names = list(inspect.signature(fn).parameters)
    if inspect.isclass(fn) and issubclass(fn, flax_linen.Module):
        names = [p for p in names if p not in FLAX_FIELDS]
    return [IDIOMS.get(p, p) for p in names]


JAX_MODULES = module_paths("lightplane_tpu")
COMPARED = [m for m in JAX_MODULES if m not in KERNEL_MODULES]


def test_every_jax_module_has_a_counterpart():
    port = set(module_paths("lightplane_tpu_torch"))
    missing = [m for m in COMPARED if m not in port]
    missing += [f"{m} -> {c}" for m, cs in KERNEL_MODULES.items()
                for c in cs if c not in port]
    assert not missing, missing
    assert set(KERNEL_MODULES) == {
        m for m in JAX_MODULES if m.startswith("ops.kernels.")
        and not m.endswith("__init__")}


@pytest.mark.parametrize("path", COMPARED)
def test_public_signatures_match(path):
    jax_mod = load("lightplane_tpu", path)
    port_mod = load("lightplane_tpu_torch", path)
    faults = []

    def check(qualname, jax_fn, port_fn):
        if (path, qualname) in NO_COUNTERPART:
            return
        if port_fn is None:
            faults.append(f"{qualname}: missing")
            return
        want, got = param_names(jax_fn), param_names(port_fn)
        if got[:len(want)] != want:
            faults.append(f"{qualname}: {got} does not begin with {want}")

    for name, obj in public(jax_mod).items():
        port_obj = getattr(port_mod, name, None)
        check(name, obj, port_obj)
        if inspect.isclass(obj) and port_obj is not None:
            for m, fn in methods(obj).items():
                check(f"{name}.{m}", fn, getattr(port_obj, m, None))
    assert not faults, faults
