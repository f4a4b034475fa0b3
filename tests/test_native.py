"""Native C++ parser vs numpy parser: exact differential equality."""

import random

import numpy as np
import pytest

from krust.errors import FormatError
from krust.io import native
from krust.io.format import SequenceFormat
from krust.io import reader as reader_mod

import oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native parser unavailable (no g++?)"
)


def numpy_streams(data: bytes, fmt):
    """Run the pure-numpy parser path regardless of native availability."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if fmt.is_fastq:
        seq, qual, lens = reader_mod._parse_fastq(arr)
        if lens.shape[0] == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0, 0
        from krust.kmer import BASE_LUT

        codes = reader_mod._with_separators(BASE_LUT[seq], lens, 4)
        q = reader_mod._with_separators(qual, lens, 0xFF)
        return codes, q, lens.shape[0], int(lens.sum())
    seq, lens = reader_mod._parse_fasta(arr)
    if lens.shape[0] == 0:
        return np.zeros(0, np.uint8), None, 0, 0
    from krust.kmer import BASE_LUT

    codes = reader_mod._with_separators(BASE_LUT[seq], lens, 4)
    return codes, None, lens.shape[0], int(lens.sum())


def random_fasta(rng: random.Random) -> bytes:
    parts = []
    for _ in range(rng.randint(0, 12)):
        parts.append(f">{oracle.random_dna(rng, rng.randint(0, 8), 'abcXYZ_ ')}")
        for _ in range(rng.randint(0, 4)):
            parts.append(oracle.random_dna(rng, rng.randint(0, 40), "ACGTacgtNnx"))
    text = "\n".join(parts)
    if parts and rng.random() < 0.7:
        text += "\n"
    if rng.random() < 0.3:
        text = text.replace("\n", "\r\n")
    return text.encode()


def random_fastq(rng: random.Random) -> bytes:
    parts = []
    for i in range(rng.randint(0, 10)):
        n = rng.randint(0, 50)
        seq = oracle.random_dna(rng, n, "ACGTacgtNn")
        qual = "".join(chr(rng.randint(33, 104)) for _ in range(n))
        parts += [f"@read{i}", seq, "+", qual]
    text = "\n".join(parts)
    if parts and rng.random() < 0.7:
        text += "\n"
    if rng.random() < 0.3:
        text = text.replace("\n", "\r\n")
    return text.encode()


@pytest.mark.parametrize("seed", range(30))
def test_fasta_differential(seed):
    rng = random.Random(seed)
    data = random_fasta(rng)
    exp = numpy_streams(data, SequenceFormat.FASTA)
    got = native.parse_fasta_native(data)
    assert got is not None
    np.testing.assert_array_equal(got[0], exp[0])
    assert got[1] == exp[2]
    assert got[2] == exp[3]


@pytest.mark.parametrize("seed", range(30))
def test_fastq_differential(seed):
    rng = random.Random(1000 + seed)
    data = random_fastq(rng)
    exp = numpy_streams(data, SequenceFormat.FASTQ)
    got = native.parse_fastq_native(data)
    assert got is not None
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert got[2] == exp[2]
    assert got[3] == exp[3]


def test_fasta_error_parity():
    bad = b"ACGT\n>a\nACGT\n"
    with pytest.raises(FormatError):
        native.parse_fasta_native(bad)
    with pytest.raises(FormatError):
        numpy_streams(bad, SequenceFormat.FASTA)


@pytest.mark.parametrize(
    "bad",
    [
        b"@a\nACGT\n+\n",  # truncated record
        b">a\nACGT\n+\nIIII\n",  # bad header char
        b"@a\nACGT\n-\nIIII\n",  # bad plus line
        b"@a\nACGT\n+\nIII\n",  # qual length mismatch
    ],
)
def test_fastq_error_parity(bad):
    with pytest.raises(FormatError):
        native.parse_fastq_native(bad)
    with pytest.raises(FormatError):
        numpy_streams(bad, SequenceFormat.FASTQ)


def test_empty_inputs():
    assert native.parse_fasta_native(b"")[1] == 0
    assert native.parse_fastq_native(b"")[2] == 0


def test_fixture_files(fixtures_dir):
    for name in ("simple.fa", "with_n.fa", "soft_masked.fa"):
        data = (fixtures_dir / name).read_bytes()
        exp = numpy_streams(data, SequenceFormat.FASTA)
        got = native.parse_fasta_native(data)
        np.testing.assert_array_equal(got[0], exp[0])
    for name in ("simple.fq", "low_quality.fq", "with_n.fq"):
        data = (fixtures_dir / name).read_bytes()
        exp = numpy_streams(data, SequenceFormat.FASTQ)
        got = native.parse_fastq_native(data)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])


def test_scan_stream_matches_numpy():
    from krust.io.packer import invalid_positions, pack2_full

    rng = np.random.default_rng(31)
    for n in (0, 1, 5, 8, 1000, 4099):
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        if n:
            codes[rng.random(n) < 0.01] = 4
        res = native.scan_stream_native(codes, None, None, max(n, 8))
        if res is None:
            pytest.skip("native lib unavailable")
        packed2, inv, n_inv = res
        np.testing.assert_array_equal(inv, invalid_positions(codes))
        np.testing.assert_array_equal(packed2, pack2_full(codes))


def test_scan_stream_quality_fold():
    codes = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3], np.uint8)
    qual = np.array([70, 33, 70, 70, 0xFF, 70, 34, 70, 70], np.uint8)
    res = native.scan_stream_native(codes, qual, 53, 8)
    if res is None:
        pytest.skip("native lib unavailable")
    _, inv, n_inv = res
    assert inv.tolist() == [1, 4, 6]


def test_scan_stream_early_exit_dirty():
    codes = np.full(1000, 4, np.uint8)
    res = native.scan_stream_native(codes, None, None, 10)
    if res is None:
        pytest.skip("native lib unavailable")
    _, _, n_inv = res
    assert n_inv == 11  # max_inv + 1 sentinel


class TestThreadedScan:
    """Forced multi-thread scan (KRUST_NATIVE_THREADS) vs the oracles.

    This rig has one core, so auto mode never parallelizes; the env
    override forces the chunked scan + per-thread invpos stitch so its
    ordering/overflow logic is covered everywhere (the threshold drops to
    64 bases when forced, reference for the pack analog: krust_pack2).
    """

    def _forced(self, monkeypatch, n_threads=4):
        monkeypatch.setenv("KRUST_NATIVE_THREADS", str(n_threads))

    def test_matches_single_thread(self, monkeypatch):
        rng = np.random.default_rng(77)
        for n in (64, 257, 1000, 4099, 65537):
            codes = rng.integers(0, 4, size=n, dtype=np.uint8)
            codes[rng.random(n) < 0.02] = 4
            monkeypatch.delenv("KRUST_NATIVE_THREADS", raising=False)
            single = native.scan_stream_native(codes, None, None, n)
            if single is None:
                pytest.skip("native lib unavailable")
            self._forced(monkeypatch)
            threaded = native.scan_stream_native(codes, None, None, n)
            np.testing.assert_array_equal(threaded[0], single[0])
            np.testing.assert_array_equal(threaded[1], single[1])
            assert threaded[2] == single[2]

    def test_invpos_ascending_across_chunks(self, monkeypatch):
        self._forced(monkeypatch, 8)
        codes = np.zeros(8192, np.uint8)
        codes[::97] = 4  # invalids span every chunk
        res = native.scan_stream_native(codes, None, None, 8192)
        if res is None:
            pytest.skip("native lib unavailable")
        _, inv, n_inv = res
        assert n_inv == len(range(0, 8192, 97))
        assert (np.diff(inv) > 0).all()
        np.testing.assert_array_equal(inv, np.arange(0, 8192, 97))

    def test_overflow_sentinel(self, monkeypatch):
        self._forced(monkeypatch)
        codes = np.full(4096, 4, np.uint8)
        res = native.scan_stream_native(codes, None, None, 10)
        if res is None:
            pytest.skip("native lib unavailable")
        assert res[2] == 11  # max_inv + 1

    def test_exactly_max_inv_is_clean(self, monkeypatch):
        self._forced(monkeypatch)
        codes = np.zeros(4096, np.uint8)
        pos = np.array([5, 600, 1500, 2500, 3500], np.int64)
        codes[pos] = 4
        res = native.scan_stream_native(codes, None, None, 5)
        if res is None:
            pytest.skip("native lib unavailable")
        packed2, inv, n_inv = res
        assert n_inv == 5
        np.testing.assert_array_equal(inv, pos)
        from krust.io.packer import pack2_full
        np.testing.assert_array_equal(packed2, pack2_full(codes))

    def test_overflow_split_across_threads(self, monkeypatch):
        # each thread stays under max_inv but the total exceeds it
        self._forced(monkeypatch, 4)
        codes = np.zeros(4096, np.uint8)
        codes[np.linspace(0, 4095, 12).astype(np.int64)] = 4
        res = native.scan_stream_native(codes, None, None, 10)
        if res is None:
            pytest.skip("native lib unavailable")
        assert res[2] == 11

    def test_quality_fold_threaded(self, monkeypatch):
        self._forced(monkeypatch)
        rng = np.random.default_rng(13)
        n = 2048
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        qual = rng.integers(30, 80, size=n, dtype=np.uint8)
        monkeypatch.delenv("KRUST_NATIVE_THREADS", raising=False)
        single = native.scan_stream_native(codes, qual, 53, n)
        if single is None:
            pytest.skip("native lib unavailable")
        self._forced(monkeypatch)
        threaded = native.scan_stream_native(codes, qual, 53, n)
        np.testing.assert_array_equal(threaded[1], single[1])
        assert threaded[2] == single[2]

    def test_tail_bases_threaded(self, monkeypatch):
        self._forced(monkeypatch)
        codes = np.array([0, 1, 2, 3] * 40 + [3, 4, 1], np.uint8)
        from krust.io.packer import invalid_positions, pack2_full
        res = native.scan_stream_native(codes, None, None, 16)
        if res is None:
            pytest.skip("native lib unavailable")
        packed2, inv, n_inv = res
        np.testing.assert_array_equal(inv, invalid_positions(codes))
        np.testing.assert_array_equal(packed2, pack2_full(codes))


class TestNativeCountStream:
    """Native host counting core vs the numpy oracle (io/native.py
    count_stream_native; the no-accelerator production path)."""

    def test_differential_all_k_regimes(self):
        rng = np.random.default_rng(3)
        from krust.models.engines import count_stream_numpy

        for k in (1, 2, 15, 16, 21, 31, 32):
            for n in (0, k - 1, k, 100, 5000):
                codes = rng.integers(0, 4, size=max(n, 0), dtype=np.uint8)
                if n > 10:
                    codes[rng.random(n) < 0.05] = 4
                exp = count_stream_numpy(codes, None, k)
                got = native.count_stream_native(codes, None, None, k)
                if got is None:
                    pytest.skip("native lib unavailable")
                np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
                np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))

    def test_differential_large_m_radix_paths(self):
        """m >= 2^20 windows engage the radix-sort paths (u32 inner sort
        for 13<=k<=21, u64 MSD+LSD for k>=22) instead of std::sort; pin
        both regimes against the numpy oracle on a duplication-heavy
        read-shaped stream (small genome sampled at high coverage, sprinkled
        invalids), matching the counting semantics of the reference hot loop
        (reference: src/run.rs:489-583)."""
        rng = np.random.default_rng(17)
        from krust.models.engines import count_stream_numpy

        genome = rng.integers(0, 4, size=40_000, dtype=np.uint8)
        parts = []
        for _ in range(6000):
            s = int(rng.integers(0, 40_000 - 250))
            parts.append(genome[s : s + 250])
            parts.append(np.array([4], np.uint8))
        codes = np.concatenate(parts)[:-1]
        codes[rng.random(codes.size) < 0.001] = 4
        # k >= 13: radix regimes; k = 8, 11: the large-n counting-sort path
        # (4^k histogram), which fixture-scale tests never reach
        for k in (8, 11, 13, 16, 21, 22, 31):
            exp = count_stream_numpy(codes, None, k)
            got = native.count_stream_native(codes, None, None, k)
            if got is None:
                pytest.skip("native lib unavailable")
            assert int(got[1].sum()) >= (1 << 20)  # really at engine scale
            np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
            np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))
        # quality filtering through the same radix regimes (u32 and u64):
        # mostly-high quality with sparse low spots keeps m >= 2^20 while
        # still exercising the filter inside the rolling scan
        qual = rng.integers(41, 80, size=codes.size, dtype=np.uint8)
        qual[rng.random(codes.size) < 0.002] = 10
        for k in (21, 31):
            exp = count_stream_numpy(codes, qual, k, 40)
            got = native.count_stream_native(codes, qual, 40, k)
            assert int(got[1].sum()) >= (1 << 20)
            np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
            np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))

    def test_forced_threads_match_single_thread(self, monkeypatch):
        """KRUST_NATIVE_THREADS forces the range-parallel counting core on
        this single-core host: (k-1)-halo roll ranges, per-thread scatter
        cursors, bucket-span sorts, and the stitch must be bit-identical to
        the sequential pipeline. Covers both the threaded radix path
        (m >= 2^20) and the threaded-roll + compaction + std::sort path
        (m < 2^20), with invalids planted exactly at the range boundaries."""
        rng = np.random.default_rng(23)
        for n, k, with_qual in (
            (1_400_000, 21, False),
            (1_400_000, 31, False),
            (1_400_000, 21, True),  # quality mask straddling range boundaries
            (120_000, 17, False),
        ):
            codes = rng.integers(0, 4, size=n, dtype=np.uint8)
            codes[rng.random(n) < 0.002] = 4
            for t in range(4):  # invalids at/astride forced-range boundaries
                codes[(n * t) // 4] = 4
                codes[min((n * t) // 4 + 1, n - 1)] = 4
            qual = thr = None
            if with_qual:
                qual = rng.integers(41, 80, size=n, dtype=np.uint8)
                qual[rng.random(n) < 0.002] = 10
                for t in range(1, 4):  # low quality right at the boundary
                    qual[(n * t) // 4 - 1] = 0
                thr = 40
            monkeypatch.delenv("KRUST_NATIVE_THREADS", raising=False)
            seq = native.count_stream_native(codes, qual, thr, k)
            if seq is None:
                pytest.skip("native lib unavailable")
            for forced in ("2", "5"):
                monkeypatch.setenv("KRUST_NATIVE_THREADS", forced)
                par = native.count_stream_native(codes, qual, thr, k)
                np.testing.assert_array_equal(par[0], seq[0])
                np.testing.assert_array_equal(par[1], seq[1])

    def test_quality_threshold(self):
        rng = np.random.default_rng(9)
        from krust.models.engines import count_stream_numpy

        n = 3000
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        qual = rng.integers(0, 80, size=n, dtype=np.uint8)
        for k in (3, 16, 32):
            exp = count_stream_numpy(codes, qual, k, 40)
            got = native.count_stream_native(codes, qual, 40, k)
            if got is None:
                pytest.skip("native lib unavailable")
            np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
            np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))

    def test_separator_resets_window(self):
        # ACG | T ACG: separator kills windows spanning it (k=3)
        codes = np.array([0, 1, 2, 4, 3, 0, 1, 2], np.uint8)
        got = native.count_stream_native(codes, None, None, 3)
        if got is None:
            pytest.skip("native lib unavailable")
        # windows: ACG (twice: once before sep, once after TAC->...):
        # before sep: ACG; after: TAC, ACG -> canonical {ACG:2, TAC->GTA:1}
        from krust.models.engines import count_stream_numpy
        exp = count_stream_numpy(codes, None, 3)
        np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
        np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))

    def test_native_engine_matches_numpy_engine(self):
        from krust.io.reader import ParsedStreams
        from krust.models.engines import NativeEngine, NumpyEngine

        rng = np.random.default_rng(21)
        codes = rng.integers(0, 5, size=20000, dtype=np.uint8).astype(np.uint8)
        streams = ParsedStreams(codes, None, 1, int((codes < 4).sum()))
        for k in (5, 21):
            a = NativeEngine().count(streams, k)
            b = NumpyEngine().count(streams, k)
            np.testing.assert_array_equal(a.codes, b.codes)
            np.testing.assert_array_equal(a.counts, b.counts)


class TestEngineDispatch:
    """select_engine routing: ``gpu`` runs the device engine; any other
    backend runs the native host core (numpy without it), the product mode
    of an accelerator-less machine; a forced device needs a GPU."""

    def test_cpu_backend_unforced_routes_native(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_cpu_platform_env_routes_native(self, monkeypatch):
        """Asking JAX for the CPU platform does not make XLA-CPU the
        product engine: the backend is still no accelerator."""
        from krust.models import engines as eng

        monkeypatch.setenv("KRUST_PLATFORM", "cpu")
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_accelerator_routes_batch(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.BatchEngine)

    def test_forced_device_on_gpu_routes_batch(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv("KRUST_ENGINE", "device")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.BatchEngine)

    def test_forced_native_on_gpu(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv("KRUST_ENGINE", "native")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)

    def test_no_jax_routes_native_then_numpy(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
        assert isinstance(eng.select_engine(eng.EngineConfig()), eng.NativeEngine)
        cfg = eng.EngineConfig(use_native_host=False)
        assert isinstance(eng.select_engine(cfg), eng.NumpyEngine)

    def test_numpy_request_wins(self, monkeypatch):
        import jax

        from krust.models import engines as eng

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        cfg = eng.EngineConfig(use_numpy_backend=True)
        assert isinstance(eng.select_engine(cfg), eng.NumpyEngine)
