"""Test harness config: force CPU with an 8-device virtual mesh.

Must run before jax initializes a backend. Tests run on a virtual 8-device
CPU mesh (fast, and exercises the multi-device sharding paths per
SURVEY.md §4).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ["KRUST_PLATFORM"] = "cpu"
# engine selection must come from each test, not the developer's shell
# (CLI tests set KRUST_ENGINE per subprocess; in-process tests construct
# engines explicitly or rely on auto-dispatch)
os.environ.pop("KRUST_ENGINE", None)

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from krust.utils.jaxcache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the suite's wall-clock is dominated by
# XLA-CPU compiles, and the per-module clear below (crash workaround)
# forces recompiles of shared executables; with a disk cache those
# deserialize in milliseconds instead.
enable_compile_cache(min_compile_secs=0.0)


import pytest as _pytest  # noqa: E402


# Modules whose tests compile large numbers of DISTINCT executables
# (compaction/merge shape sweeps, all-k differential sweeps,
# hypothesis-generated shapes). Only these push the live-executable
# population toward the XLA-CPU JIT crash threshold; the api/builder/cli
# cluster reuses a handful of count-path executables and benefits from
# keeping them compiled.
_HEAVY_COMPILE_MODULES = {
    "test_compact",
    "test_codec_paths",
    "test_flat",
    "test_table",
    "test_epoch_table",
    "test_sharded",
    "test_properties",
    "test_api",
    "test_codec",
}


@_pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module(request):
    """Drop compiled executables after heavy-compile test modules.

    The full suite compiles many hundreds of CPU executables in one
    process; past ~450 tests the XLA CPU JIT segfaults inside a fresh
    compile (observed deterministically at the same test, which passes in
    any smaller run). Clearing after each module in _HEAVY_COMPILE_MODULES
    keeps the live-executable population bounded; light modules keep their
    (shared) executables to avoid the recompilation tax of a blanket
    per-module clear.
    """
    yield
    if request.module.__name__.rpartition(".")[2] in _HEAVY_COMPILE_MODULES:
        jax.clear_caches()

import gzip
import shutil

import pytest

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="session")
def fixtures_dir(tmp_path_factory):
    """Fixture dir containing the plain files plus generated .gz twins."""
    d = tmp_path_factory.mktemp("fixtures")
    for name in os.listdir(FIXTURES):
        src = os.path.join(FIXTURES, name)
        shutil.copy(src, d / name)
        if name in ("simple.fa", "simple.fq"):
            with open(src, "rb") as f_in, gzip.open(d / (name + ".gz"), "wb") as f_out:
                f_out.write(f_in.read())
    return d


@pytest.fixture()
def simple_fa(fixtures_dir):
    return str(fixtures_dir / "simple.fa")


@pytest.fixture()
def simple_fq(fixtures_dir):
    return str(fixtures_dir / "simple.fq")
