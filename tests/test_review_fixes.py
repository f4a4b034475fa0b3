"""Regression tests for error-surface and config-threading review fixes."""

import gzip
import subprocess
import sys

import pytest

from krust import KmerCounter, count_kmers, load_index
from krust.errors import FormatError, IndexReadError, ReadError
from krust.io.format import SequenceFormat
from krust.io.reader import parse_records
from krust.utils.config import EngineConfig


def _truncated_gz(tmp_path, name, payload):
    blob = gzip.compress(payload)
    p = tmp_path / name
    p.write_bytes(blob[: len(blob) - 6])  # cut the gzip trailer
    return p


def test_truncated_gzip_fasta_raises_read_error(tmp_path):
    p = _truncated_gz(tmp_path, "x.fa.gz", b">a\n" + b"ACGT" * 500 + b"\n")
    with pytest.raises(ReadError):
        count_kmers(p, 3)


def test_truncated_gzip_index_raises_index_error(tmp_path):
    from krust import KmerIndex, save_index

    idx = KmerIndex(3, {5: 7})
    p = tmp_path / "x.kmix.gz"
    save_index(idx, p)
    blob = p.read_bytes()
    p.write_bytes(blob[: len(blob) - 5])
    with pytest.raises(IndexReadError):
        load_index(p)


def test_truncated_gzip_cli_exit_code(tmp_path):
    p = _truncated_gz(tmp_path, "x.fa.gz", b">a\n" + b"ACGT" * 500 + b"\n")
    r = subprocess.run(
        [sys.executable, "-m", "krust", "3", str(p), "-q"],
        capture_output=True,
        text=True,
        env={"KRUST_PLATFORM": "cpu", "KRUST_ENGINE": "native",
             "PATH": "/usr/bin:/bin", "PYTHONPATH": "."},
    )
    assert r.returncode == 1
    assert "Traceback" not in r.stderr


def test_fastq_empty_final_quality_line_parses():
    recs = parse_records(b"@a\nACGT\n+\nIIII\n@b\n\n+\n\n", SequenceFormat.FASTQ)
    assert len(recs) == 2
    assert recs[1].seq == b""


def test_fastq_stray_trailing_blank_lines_rejected():
    with pytest.raises(FormatError):
        parse_records(b"@a\nACGT\n+\nIIII\n\n\n", SequenceFormat.FASTQ)


def test_quiet_suppresses_min_quality_warning(tmp_path):
    p = tmp_path / "g.fa"
    p.write_text(">a\nACGTACGT\n")
    r = subprocess.run(
        [sys.executable, "-m", "krust", "3", str(p), "-q", "-Q", "20"],
        capture_output=True,
        text=True,
        env={"KRUST_PLATFORM": "cpu", "KRUST_ENGINE": "native",
             "PATH": "/usr/bin:/bin", "PYTHONPATH": "."},
    )
    assert r.returncode == 0
    assert r.stderr == ""  # the quiet contract: zero stderr


def test_builder_engine_config_reaches_engine(tmp_path, monkeypatch):
    """engine_config() must actually steer the engine in count()."""
    import krust.models.engines as eng

    p = tmp_path / "g.fa"
    p.write_text(">a\nACGTACGTACGT\n")
    seen = {}
    orig = eng.count_streams

    def spy(streams, k, min_quality=None, config=None, progress=None, tracker=None):
        seen["config"] = config
        return orig(streams, k, min_quality, config, progress, tracker)

    monkeypatch.setattr(eng, "count_streams", spy)
    import krust.api as api_mod

    monkeypatch.setattr(api_mod, "count_streams", spy)
    cfg = EngineConfig(block_windows=64, batch_rows=8)
    KmerCounter.new().k(3).engine_config(cfg).count(p)
    assert seen["config"] is cfg


class TestEngineOverridePrecedence:
    """KRUST_ENGINE contracts: explicit config beats the env override, and
    a forced device without a GPU is an error, not a silent CPU run."""

    def test_explicit_numpy_beats_env(self, monkeypatch):
        from krust.models import engines as eng

        monkeypatch.setenv("KRUST_ENGINE", "native")
        engine = eng.select_engine(EngineConfig(use_numpy_backend=True))
        assert isinstance(engine, eng.NumpyEngine)

    def test_forced_device_raises_without_gpu(self, monkeypatch):
        from krust.models import engines as eng

        monkeypatch.setenv("KRUST_ENGINE", "device")
        with pytest.raises(RuntimeError, match="KRUST_ENGINE=device"):
            eng.select_engine(EngineConfig())

    def test_forced_device_alias_raises_without_gpu(self, monkeypatch):
        from krust.models import engines as eng

        monkeypatch.setenv("KRUST_ENGINE", "jax")
        with pytest.raises(RuntimeError, match="GPU"):
            eng.select_engine(EngineConfig())

    def test_bogus_value_rejected(self, monkeypatch):
        from krust.models import engines as eng

        monkeypatch.setenv("KRUST_ENGINE", "gpu")
        with pytest.raises(ValueError, match="KRUST_ENGINE"):
            eng.select_engine(EngineConfig())
