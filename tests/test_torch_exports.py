"""The port's packages export the reference's public names.

Each of ``core``, ``optim``, ``train``, ``models``, ``data`` and
``parallel`` has the reference package's ``__all__`` less the JAX
sharding machinery the per-rank port has no counterpart for
(``JAX_ONLY``), and every name imports from the package.  The packages
import in any order: each package first in a fresh interpreter.
"""

import importlib
import subprocess
import sys

import pytest

from repro_torch.parallel import pad_to_multiple, padded

PACKAGES = ["core", "optim", "train", "models", "data", "parallel"]
#: the reference's names that are jax.sharding / shard_map machinery
JAX_ONLY = {"parallel": {"smap", "shard_map_compat", "spec_pspecs",
                         "infer_shardings", "global_shape_dtypes"}}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_is_the_references_less_jax_only_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    want = set(ref.__all__) - JAX_ONLY.get(pkg, set())
    assert JAX_ONLY.get(pkg, set()) <= set(ref.__all__)
    assert sorted(port.__all__) == sorted(want)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
        exec(f"from repro_torch.{pkg} import {name}", {})


@pytest.mark.parametrize("pkg", PACKAGES + ["core.halo", "kernels.counters"])
def test_package_imports_first(pkg):
    """The package (or module) imported first in a fresh interpreter,
    then every exported name: no import cycle."""
    code = (f"import repro_torch.{pkg} as m\n"
            f"for n in getattr(m, '__all__', []): getattr(m, n)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_pad_to_multiple_matches_reference():
    from repro.parallel import sharding as ref_sharding

    for n in range(0, 40):
        for m in (1, 3, 8, 128):
            assert pad_to_multiple(n, m) == ref_sharding.pad_to_multiple(n, m)
            assert padded(n, m) == ref_sharding.padded(n, m)
