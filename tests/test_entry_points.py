"""Entry points around the engine: compile-cache location, the GPU smoke
run and the benchmark refusing a CPU device, and the smoke run's inputs."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_env_honoured(monkeypatch, tmp_path):
    import jax

    from krust.utils.jaxcache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other path is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_checkout(monkeypatch):
    import jax

    from krust.utils.jaxcache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_written_where_env_says(tmp_path):
    """A fresh process compiles into JAX_COMPILATION_CACHE_DIR and nowhere
    in the checkout."""
    cache = tmp_path / "cache"
    code = (
        "from krust.utils.jaxcache import enable_compile_cache;"
        "enable_compile_cache(min_compile_secs=0.0);"
        "import jax, jax.numpy as jnp;"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert any(cache.iterdir())


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_four_cards_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main(["--four-cards"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails, printing no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main() != 0
    assert capsys.readouterr().out == ""


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DATA_DIR", str(tmp_path))
    return chip_smoke


def test_smoke_fasta_parses_to_reads(smoke, tmp_path):
    from krust.io.format import SequenceFormat
    from krust.io.reader import parse_to_streams, read_input_bytes
    from krust.kmer import INVALID_CODE

    reads = np.random.default_rng(1).integers(0, 4, (50, 30), dtype=np.uint8)
    path = str(tmp_path / "r.fa")
    smoke.write_fasta(path, reads)
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.FASTA)
    rows = np.full((50, 31), INVALID_CODE, np.uint8)
    rows[:, :30] = reads
    assert streams.n_records == 50
    assert np.array_equal(streams.codes, rows.reshape(-1)[:-1])


def test_smoke_fastq_takes_both_feed_paths(smoke, tmp_path):
    """The smoke FASTQ stays on the flat feed as is and falls to the dense
    one under -Q 20, so its sweep covers both device feed paths."""
    from krust.io.format import SequenceFormat
    from krust.io.packer import flat_batches
    from krust.io.reader import parse_to_streams, read_input_bytes

    path = str(tmp_path / "r.fq")
    smoke.write_fastq(path, np.random.default_rng(2), 200_000)
    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.FASTQ)
    assert streams.qual is not None
    assert flat_batches(streams.codes, None, 21, None, 4096, 64) is not None
    assert flat_batches(streams.codes, streams.qual, 21, 20 + 33, 4096, 64) is None


def _former_names():
    """Top-level packages of the checkout kept as aliases of krust."""
    return [m.name for m in pkgutil.iter_modules([REPO])
            if m.ispkg and m.name.startswith("krust") and m.name != "krust"]


def test_former_package_name_aliases_krust():
    import importlib
    import warnings

    import krust
    import krust.ops.count
    import krust.utils.config

    (old,) = _former_names()
    sys.modules.pop(old, None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod = importlib.import_module(old)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert mod.count_kmers is krust.count_kmers
    assert mod.__version__ == krust.__version__
    # one module object per file, whichever name imports it
    assert importlib.import_module(old + ".ops.count") is krust.ops.count
    assert krust.ops.count.__spec__.name == "krust.ops.count"
    cfg = importlib.import_module(old + ".utils.config")
    assert cfg.EngineConfig is krust.utils.config.EngineConfig
    assert importlib.import_module(old + ".parallel.mesh").__name__ == (
        "krust.parallel.mesh")


def test_former_package_name_runs_cli(tmp_path):
    (old,) = _former_names()
    fa = tmp_path / "s.fa"
    fa.write_bytes(b">s\nACGTACGT\n")
    env = dict(os.environ, KRUST_ENGINE="native", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", old, "3", str(fa), "-f", "tsv", "-q"],
                       env=env, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [b"ACG", b"4", b"GTA", b"2"]
