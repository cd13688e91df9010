"""Every public name of mapmerge_tpu has its counterpart in mapmerge_torch.

For each module of the JAX package (`pkgutil.walk_packages`, Python sources
only), the module of the same path under `mapmerge_torch` must import and
must define each of its public names: a function or class whose
`__module__` is that module (a jitted function counts as a function), an
upper-case constant assigned at the module's top level (read with `ast`), or
a name in the module's `__all__`. The only names that need no counterpart
are the entries of `EXEMPT`, each with its reason; a key names a module (and
its submodules) or `module.name`, and must exist in mapmerge_tpu.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import pathlib
import pkgutil

import pytest

import mapmerge_tpu
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

EXEMPT = {
    "mapmerge_tpu.pallas": (
        "the TPU kernels; their counterparts are mapmerge_torch/kernels and "
        "csrc/, held by tests/test_torch_kernels.py and chip_smoke.py"
    ),
    "mapmerge_tpu.oracle": "a numpy test reference, not a path",
    "mapmerge_tpu.parallel.mesh.pair_sharding": "a JAX NamedSharding",
    "mapmerge_tpu.parallel.mesh.replicated": "a JAX NamedSharding",
    "mapmerge_tpu.pipeline.features.STAGED_THRESHOLD": (
        "the size from which the features run as separately jitted stages; "
        "the port runs its stages eagerly"
    ),
    "mapmerge_tpu.pipeline.features.extract_features_staged": (
        "separately jitted stages; the port runs its stages eagerly"
    ),
    "mapmerge_tpu.parallel.pair_shard.extract_features_staged_parallel": (
        "separately jitted stages over the mesh; the port runs its stages "
        "eagerly"
    ),
}


def _source_modules() -> list[str]:
    """The JAX package's modules that are Python sources (not the native
    library that package builds in place)."""
    names = [mapmerge_tpu.__name__]
    for info in pkgutil.walk_packages(mapmerge_tpu.__path__, "mapmerge_tpu."):
        if importlib.util.find_spec(info.name).origin.endswith(".py"):
            names.append(info.name)
    return names


def _exempt(name: str) -> bool:
    return any(name == key or name.startswith(key + ".") for key in EXEMPT)


MODULES = [m for m in _source_modules() if not _exempt(m)]


def _constants(module) -> set[str]:
    """Upper-case names assigned at the top level of the module's source."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    names = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        for target in targets:
            for leaf in ast.walk(target):
                if isinstance(leaf, ast.Name) and leaf.id.isupper() \
                        and not leaf.id.startswith("_"):
                    names.add(leaf.id)
    return names


def public_names(module) -> set[str]:
    """The module's public functions and classes, its upper-case constants
    and its `__all__`."""
    defined = {
        name for name, obj in vars(module).items()
        if not name.startswith("_") and callable(obj)
        and getattr(obj, "__module__", None) == module.__name__
    }
    return defined | _constants(module) | set(getattr(module, "__all__", ()))


def counterpart(name: str) -> str:
    return "mapmerge_torch" + name[len("mapmerge_tpu"):]


@pytest.mark.parametrize("name", MODULES)
def test_module_has_its_counterpart(name):
    module = importlib.import_module(name)
    port = importlib.import_module(counterpart(name))
    missing = sorted(
        n for n in public_names(module)
        if not _exempt(f"{name}.{n}") and not hasattr(port, n)
    )
    assert not missing, f"{counterpart(name)} lacks {missing}"


def test_exemptions_name_what_exists():
    """Every key of EXEMPT is a module of mapmerge_tpu or a name one defines,
    so the list cannot go stale."""
    modules = set(_source_modules())
    for key in EXEMPT:
        if key in modules:
            continue
        mod, _, attr = key.rpartition(".")
        assert mod in modules, f"{key}: no such module"
        assert hasattr(importlib.import_module(mod), attr), f"{key}: no such name"
