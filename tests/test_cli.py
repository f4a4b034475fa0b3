"""CLI black-box tests (mirrors reference: tests/integration_tests.rs).

Spawns the real CLI as a subprocess (``python -m krust``), asserting on
stdout/stderr/exit codes exactly like the reference's integration suite.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: the CLI with the device engine pinned: ``KRUST_ENGINE=device`` needs a
#: GPU, so a fresh process patches the selection instead
_DEVICE_CLI = (
    "import sys\n"
    "from krust import cli\n"
    "from krust.models import engines\n"
    "engines.select_engine = lambda cfg: engines.BatchEngine(cfg)\n"
    "sys.exit(cli.main(sys.argv[1:]))\n"
)


def kmix(*args, stdin: bytes | None = None, engine: str = "native"):
    env = dict(os.environ)
    env["KRUST_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if engine == "device":
        env.pop("KRUST_ENGINE", None)
        cmd = [sys.executable, "-c", _DEVICE_CLI, *args]
    else:
        # black-box tests assert CLI semantics, not the XLA pipeline (the
        # library suites cover that differentially); the native engine
        # skips the XLA-CPU compile of every process
        env["KRUST_ENGINE"] = engine
        cmd = [sys.executable, "-m", "krust", *args]
    return subprocess.run(
        cmd,
        input=stdin,
        capture_output=True,
        env=env,
        timeout=300,
    )


def parse_tsv(out: bytes) -> dict[str, int]:
    res = {}
    for line in out.decode().strip().splitlines():
        kmer, count = line.split("\t")
        res[kmer] = int(count)
    return res


SIMPLE_EXPECTED_K3 = {
    # oracle counts for ACGTACGT + GATTACA at k=3
    "ACG": 4,  # ACG x2 + CGT x2 (canonical ACG)
    "GTA": 3,  # GTA x2 + TAC x1
    "AAT": 1,  # ATT -> AAT
    "ATC": 1,  # GAT -> ATC
    "TAA": 1,  # TTA -> TAA
    "ACA": 1,
}


class TestArgValidation:
    def test_no_args_shows_error(self):
        r = kmix()
        assert r.returncode == 2

    def test_k_zero_rejected(self, simple_fa):
        r = kmix("0", simple_fa)
        assert r.returncode != 0
        assert b"at least 1" in r.stderr

    def test_k_33_rejected(self, simple_fa):
        r = kmix("33", simple_fa)
        assert r.returncode != 0
        assert b"at most 32" in r.stderr

    def test_k_not_a_number(self, simple_fa):
        r = kmix("abc", simple_fa)
        assert r.returncode != 0
        assert b"not a valid number" in r.stderr

    def test_missing_file(self):
        r = kmix("3", "/nonexistent/file.fa")
        assert r.returncode == 1
        assert b"File not found" in r.stderr

    def test_help(self):
        r = kmix("--help")
        assert r.returncode == 0
        assert b"k-mer" in r.stdout.lower() or b"K-mer" in r.stdout

    def test_version(self):
        r = kmix("--version")
        assert r.returncode == 0
        assert b"kmix" in r.stdout


class TestCounting:
    def test_tsv_exact(self, simple_fa):
        r = kmix("3", simple_fa, "-f", "tsv", "-q")
        assert r.returncode == 0
        assert parse_tsv(r.stdout) == SIMPLE_EXPECTED_K3

    def test_fasta_format(self, simple_fa):
        r = kmix("3", simple_fa, "-q")
        assert r.returncode == 0
        lines = r.stdout.decode().strip().splitlines()
        assert len(lines) == 2 * len(SIMPLE_EXPECTED_K3)
        got = {}
        for i in range(0, len(lines), 2):
            assert lines[i].startswith(">")
            got[lines[i + 1]] = int(lines[i][1:])
        assert got == SIMPLE_EXPECTED_K3

    def test_json_format(self, simple_fa):
        r = kmix("3", simple_fa, "-f", "json", "-q")
        data = json.loads(r.stdout)
        assert {d["kmer"]: d["count"] for d in data} == SIMPLE_EXPECTED_K3

    def test_histogram_format(self, simple_fa):
        r = kmix("3", simple_fa, "-f", "histogram", "-q")
        hist = parse_tsv(r.stdout)
        # sum of frequencies == number of distinct k-mers
        assert sum(hist.values()) == len(SIMPLE_EXPECTED_K3)
        # ascending by count
        keys = [int(l.split("\t")[0]) for l in r.stdout.decode().strip().splitlines()]
        assert keys == sorted(keys)

    def test_histogram_homopolymer(self, tmp_path):
        # reference: integration_tests.rs:768-799 — AAAAAAAA k=3 -> "6\t1"
        p = tmp_path / "homo.fa"
        p.write_bytes(b">s\nAAAAAAAA\n")
        r = kmix("3", str(p), "-f", "histogram", "-q")
        assert r.stdout.decode().strip() == "6\t1"

    def test_min_count(self, simple_fa):
        r = kmix("3", simple_fa, "-f", "tsv", "-m", "2", "-q")
        got = parse_tsv(r.stdout)
        assert got == {k: c for k, c in SIMPLE_EXPECTED_K3.items() if c >= 2}

    def test_n_handling(self, fixtures_dir):
        r = kmix("3", str(fixtures_dir / "with_n.fa"), "-f", "tsv", "-q")
        got = parse_tsv(r.stdout)
        import oracle

        assert got == oracle.count_sequences(["ACGTNACGT", "NNNGATTACANNN"], 3)

    def test_soft_mask_exact(self, fixtures_dir):
        # reference: integration_tests.rs:263-281 — exactly "AAA\t2"
        r = kmix("3", str(fixtures_dir / "soft_masked.fa"), "-f", "tsv", "-q")
        assert r.stdout.decode().strip() == "AAA\t2"


class TestQuietAndBanner:
    def test_quiet_stderr_empty(self, simple_fa):
        # reference: integration_tests.rs:233-261 — quiet = zero stderr
        r = kmix("3", simple_fa, "-q")
        assert r.returncode == 0
        assert r.stderr == b""

    def test_banner_on_stderr(self, simple_fa):
        r = kmix("3", simple_fa)
        assert b"k-length" in r.stderr
        assert b"auto-detected" in r.stderr


class TestStdin:
    def test_stdin_fasta(self):
        r = kmix("3", "-f", "tsv", "-q", stdin=b">s\nACGT\n")
        assert parse_tsv(r.stdout) == {"ACG": 2}

    def test_stdin_dash(self):
        r = kmix("3", "-", "-f", "tsv", "-q", stdin=b">s\nACGT\n")
        assert parse_tsv(r.stdout) == {"ACG": 2}

    def test_stdin_fastq_explicit(self):
        r = kmix("3", "-i", "fastq", "-f", "tsv", "-q", stdin=b"@s\nACGT\n+\nIIII\n")
        assert parse_tsv(r.stdout) == {"ACG": 2}

    def test_fasta_equals_fastq(self, simple_fa, simple_fq):
        ra = kmix("3", simple_fa, "-f", "tsv", "-q")
        rq = kmix("3", simple_fq, "-f", "tsv", "-q")
        assert parse_tsv(ra.stdout) == parse_tsv(rq.stdout)

    def test_gzip_equals_plain(self, fixtures_dir):
        ra = kmix("3", str(fixtures_dir / "simple.fa"), "-f", "tsv", "-q")
        rz = kmix("3", str(fixtures_dir / "simple.fa.gz"), "-f", "tsv", "-q")
        assert parse_tsv(ra.stdout) == parse_tsv(rz.stdout)


class TestQualityFlags:
    def test_min_quality_fasta_warning(self, simple_fa):
        r = kmix("3", simple_fa, "-Q", "20")
        assert b"ignored for FASTA" in r.stderr

    def test_min_quality_stdin_warning(self):
        r = kmix("3", "-Q", "20", "-i", "fastq", stdin=b"@s\nACGT\n+\nIIII\n")
        assert b"not yet supported for stdin" in r.stderr

    def test_min_quality_filters(self, fixtures_dir):
        p = str(fixtures_dir / "low_quality.fq")
        r_all = kmix("4", p, "-f", "tsv", "-q")
        r_q = kmix("4", p, "-f", "tsv", "-q", "-Q", "20")
        assert sum(parse_tsv(r_q.stdout).values()) < sum(
            parse_tsv(r_all.stdout).values()
        )


class TestSaveAndQuery:
    def test_save_creates_kmix(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        r = kmix("3", simple_fa, "--save", out, "-q")
        assert r.returncode == 0
        with open(out, "rb") as f:
            assert f.read(4) == b"KMIX"
        # counting output still goes to stdout
        assert r.stdout

    def test_query_roundtrip(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        r = kmix("query", out, "ACG")
        assert r.returncode == 0
        assert r.stdout.decode().strip() == "4"

    def test_query_missing_kmer_prints_zero(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        r = kmix("query", out, "GGG")
        assert r.stdout.decode().strip() == "0"

    def test_query_case_insensitive(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        r = kmix("query", out, "acg")
        assert r.stdout.decode().strip() == "4"

    def test_query_rc_equivalence(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        # CGT revcomp = ACG
        r = kmix("query", out, "CGT")
        assert r.stdout.decode().strip() == "4"

    def test_query_wrong_length(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        r = kmix("query", out, "ACGT")
        assert r.returncode == 1
        assert b"length mismatch" in r.stderr

    def test_query_invalid_base(self, simple_fa, tmp_path):
        out = str(tmp_path / "c.kmix")
        kmix("3", simple_fa, "--save", out, "-q")
        r = kmix("query", out, "ANG")
        assert r.returncode == 1

    def test_query_corrupt_index(self, tmp_path):
        p = tmp_path / "bad.kmix"
        p.write_bytes(b"KMIXgarbagegarbagegarbage")
        r = kmix("query", str(p), "ACG")
        assert r.returncode == 1
        assert b"Failed to load index" in r.stderr


class TestRound3Parity:
    """Combos from the reference integration suite added in round 3
    (reference: tests/integration_tests.rs)."""

    def test_negative_min_count_rejected(self, simple_fa):
        # reference clap u64 rejects negatives (reference: src/cli.rs:50)
        r = kmix("3", simple_fa, "-m", "-1")
        assert r.returncode == 2
        assert b"not a valid number" in r.stderr

    def test_histogram_exact_values(self, simple_fa):
        # counts {ACG:4, GTA:3, four singletons} -> exact spectrum rows
        r = kmix("3", simple_fa, "-f", "histogram", "-q")
        assert r.stdout.decode() == "1\t4\n3\t1\n4\t1\n"

    def test_quiet_save_combo(self, simple_fa, tmp_path):
        # --save with --quiet: stderr stays empty, counts still print to
        # stdout, and the index is queryable (reference: main.rs:155-212 +
        # the stderr-empty contract, integration_tests.rs:233-261)
        out = str(tmp_path / "qs.kmix")
        r = kmix("3", simple_fa, "--save", out, "-q", "-f", "tsv")
        assert r.returncode == 0
        assert r.stderr == b""
        assert parse_tsv(r.stdout) == SIMPLE_EXPECTED_K3
        assert open(out, "rb").read(4) == b"KMIX"
        q = kmix("query", out, "ACG")
        assert q.stdout.decode().strip() == "4"

    def test_fasta_fastq_equal_counts(self, simple_fa, simple_fq):
        # reference: integration_tests.rs FASTA == FASTQ count equality
        ra = kmix("5", simple_fa, "-f", "tsv", "-q")
        rq = kmix("5", simple_fq, "-f", "tsv", "-q")
        assert parse_tsv(ra.stdout) == parse_tsv(rq.stdout)

    def test_gzip_equals_plain(self, fixtures_dir):
        rp = kmix("5", str(fixtures_dir / "simple.fa"), "-f", "tsv", "-q")
        rg = kmix("5", str(fixtures_dir / "simple.fa.gz"), "-f", "tsv", "-q")
        assert parse_tsv(rp.stdout) == parse_tsv(rg.stdout)

    def test_min_quality_bounds(self, simple_fq):
        r = kmix("3", simple_fq, "-Q", "94")
        assert r.returncode == 1
        assert b"between 0 and 93" in r.stderr


class TestReferenceIntegrationParity2:
    """Remaining integration combos (reference: tests/integration_tests.rs,
    cli_kmer_length_1/32, cli_stdin_*, cli_histogram_*, cli_save_flag_*,
    cli_gzip_fastq_counting, cli_query_help) — asserted exactly where the
    reference only asserts shape."""

    def test_k1_exact(self, simple_fa):
        # ACGTACGT + GATTACA at k=1: A/T->A (9), C/G->C (6)
        r = kmix("1", simple_fa, "-f", "tsv", "-q")
        assert r.returncode == 0
        assert parse_tsv(r.stdout) == {"A": 9, "C": 6}

    def test_k32_no_windows_succeeds(self, simple_fa):
        # no record reaches 32 bases; empty output, still exit 0
        r = kmix("32", simple_fa, "-f", "tsv", "-q")
        assert r.returncode == 0
        assert r.stdout == b""

    def test_stdin_multiple_sequences_json(self):
        data = b">s1\nAAAA\n>s2\nTTTT\n>s3\nAAAA\n"
        r = kmix("3", "-", "-f", "json", "-q", stdin=data)
        assert r.returncode == 0
        assert json.loads(r.stdout) == [{"kmer": "AAA", "count": 6}]

    def test_histogram_sums_to_distinct(self, simple_fa):
        tsv = kmix("3", simple_fa, "-f", "tsv", "-q")
        hist = kmix("3", simple_fa, "-f", "histogram", "-q")
        distinct = len(tsv.stdout.decode().strip().splitlines())
        freq_sum = sum(
            int(line.split("\t")[1])
            for line in hist.stdout.decode().strip().splitlines()
        )
        assert distinct == freq_sum

    def test_histogram_with_min_count(self, simple_fa):
        # counts {ACG:4, GTA:3, 4 singletons}; -m 2 drops the singleton row
        r = kmix("3", simple_fa, "-f", "histogram", "-m", "2", "-q")
        assert r.returncode == 0
        assert r.stdout.decode() == "3\t1\n4\t1\n"

    def test_histogram_sorted_ascending(self, simple_fa):
        r = kmix("3", simple_fa, "-f", "histogram", "-q")
        counts = [
            int(line.split("\t")[0])
            for line in r.stdout.decode().strip().splitlines()
        ]
        assert counts == sorted(counts)

    def test_histogram_stdin(self):
        # AAAAAAAA: six AAA windows, one distinct k-mer -> row "6\t1"
        r = kmix("3", "-", "-f", "histogram", "-q", stdin=b">seq1\nAAAAAAAA\n")
        assert r.returncode == 0
        assert r.stdout.decode() == "6\t1\n"

    def test_gzip_fastq_equals_plain(self, fixtures_dir):
        rp = kmix("5", str(fixtures_dir / "simple.fq"), "-f", "tsv", "-q")
        rg = kmix("5", str(fixtures_dir / "simple.fq.gz"), "-f", "tsv", "-q")
        assert rg.returncode == 0
        assert parse_tsv(rg.stdout) == parse_tsv(rp.stdout)

    def test_save_prints_counts_and_saves(self, simple_fa, tmp_path):
        # non-quiet --save: banner on stderr, counts on stdout, index written
        out = str(tmp_path / "both.kmix")
        r = kmix("3", simple_fa, "--save", out, "-f", "tsv")
        assert r.returncode == 0
        assert parse_tsv(r.stdout) == SIMPLE_EXPECTED_K3
        assert b"k-length" in r.stderr
        assert open(out, "rb").read(4) == b"KMIX"

    def test_query_help(self):
        r = kmix("query", "-h")
        assert r.returncode == 0
        assert b"usage" in r.stdout.lower() or b"usage" in r.stderr.lower()


@pytest.mark.slow
class TestDevicePipelineCLI:
    """One black-box pass through the full jax/XLA pipeline (the other CLI
    tests use the native engine for speed; library suites cover the device
    engine differentially). Costs one XLA-CPU compile per subprocess."""

    def test_device_engine_counts_match(self, simple_fa):
        rn = kmix("3", simple_fa, "-f", "tsv", "-q")
        rd = kmix("3", simple_fa, "-f", "tsv", "-q", engine="device")
        assert rd.returncode == 0, rd.stderr
        assert parse_tsv(rd.stdout) == parse_tsv(rn.stdout) == SIMPLE_EXPECTED_K3

    def test_device_engine_quiet_contract(self, simple_fa):
        # --quiet must stay byte-silent on stderr (fd 2, C++ logs and
        # warnings included) through the jax pipeline too
        rd = kmix("21", simple_fa, "-f", "tsv", "-q", engine="device")
        assert rd.returncode == 0
        assert rd.stderr == b""


def test_quiet_fd2_silenced_and_restored(capfd):
    """What the engine writes to fd 2 under --quiet is dropped, and fd 2
    comes back before an error is reported."""
    from krust.cli import _fd2_silenced

    with pytest.raises(RuntimeError):
        with _fd2_silenced(True):
            os.write(2, b"runtime log line\n")
            raise RuntimeError("engine failed")
    os.write(2, b"error shown\n")
    assert capfd.readouterr().err == "error shown\n"
