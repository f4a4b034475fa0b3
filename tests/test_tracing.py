"""Tracing + error-display tests (mirrors reference: tests/tracing_tests.rs,
src/error.rs:197-249)."""

import logging

import pytest

import krust as kt
from krust.errors import InvalidBaseError, KmerLengthError
from krust.utils import tracing


class _CollectingHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_tracing_emits_span_events(simple_fa):
    # reference asserts >0 INFO events during a count (tracing_tests.rs:29-62)
    handler = _CollectingHandler()
    tracing.logger.addHandler(handler)
    old_level = tracing.logger.level
    tracing.logger.setLevel(logging.INFO)
    try:
        kt.count_kmers(simple_fa, 3)
    finally:
        tracing.logger.setLevel(old_level)
        tracing.logger.removeHandler(handler)
    infos = [r for r in handler.records if r.levelno == logging.INFO]
    assert len(infos) > 0
    messages = " ".join(r.getMessage() for r in infos)
    assert "read_sequences" in messages


def test_init_tracing_respects_env(monkeypatch):
    monkeypatch.setenv("KRUST_LOG", "debug")
    tracing.init_tracing()
    assert tracing.logger.level == logging.DEBUG
    tracing.logger.setLevel(logging.WARNING)


def test_span_times_and_yields():
    with tracing.span("test_phase", foo=1):
        x = 2 + 2
    assert x == 4


class TestErrorDisplay:
    def test_kmer_length_error_message(self):
        e = KmerLengthError(33)
        assert "33" in str(e)
        assert "between 1 and 32" in str(e)

    def test_invalid_base_printable(self):
        e = InvalidBaseError(ord("N"), 4)
        assert "'N'" in str(e)
        assert "position 4" in str(e)

    def test_invalid_base_nonprintable_hex(self):
        # reference prints hex for non-printable bytes (error.rs Display)
        e = InvalidBaseError(0x07, 2)
        assert "0x07" in str(e)

    def test_hierarchy(self):
        assert issubclass(KmerLengthError, kt.KrustError)
        assert issubclass(KmerLengthError, ValueError)
        assert issubclass(kt.InvalidIndexError, kt.KrustError)


def test_jellyfish_compat(simple_fa):
    """Differential vs real jellyfish when installed
    (reference: tests/jellyfish_compat.rs — ignored unless present)."""
    import shutil

    if shutil.which("jellyfish") is None:
        pytest.skip("jellyfish not installed")
    import subprocess, tempfile

    for k in (3, 5, 7):
        ours = kt.count_kmers(simple_fa, k)
        with tempfile.NamedTemporaryFile(suffix=".jf") as tmp:
            subprocess.run(
                ["jellyfish", "count", "-m", str(k), "-s", "1M", "-C",
                 "-o", tmp.name, simple_fa],
                check=True,
            )
            dump = subprocess.run(
                ["jellyfish", "dump", "-c", tmp.name],
                check=True, capture_output=True, text=True,
            )
        theirs = {}
        for line in dump.stdout.splitlines():
            kmer, count = line.split()
            theirs[kmer] = int(count)
        assert ours == theirs
