"""Property-based tests (reference: tests/property_tests.rs:246-330).

Hypothesis-driven invariants over the host codec plus vectorized/seeded
sweeps over the engines, covering the reference's proptest surface:

- pack/unpack identity (incl. lowercase), canonical idempotence,
  RC-equivalence, lexicographic minimality (reference:
  tests/property_tests.rs early cases; also fuzz targets)
- arbitrary-u64 unpack always yields valid length-k ACGT (reference:
  tests/property_tests.rs "unpack always valid")
- pack injectivity under 1-base mutation (reference:
  tests/property_tests.rs "mutation changes pack")
- sum(counts) <= window count on arbitrary dirty streams (reference:
  tests/property_tests.rs:265-286)
- a k-mer and its RC as two records -> one entry with count 2 (reference:
  tests/property_tests.rs:293-330)
- random index save/load roundtrips (reference:
  tests/property_tests.rs:246-261)

The standalone fuzz harness (fuzz/fuzz_targets.py) is folded in as a pytest
case so every CI pass exercises it.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from krust.kmer import (
    canonical_packed,
    pack,
    revcomp_packed,
    unpack_to_string,
)

_DNA = st.text(alphabet="ACGTacgt", min_size=1, max_size=32)
_DNA_UPPER = st.text(alphabet="ACGT", min_size=1, max_size=32)


@settings(max_examples=300, deadline=None)
@given(_DNA)
def test_pack_unpack_identity(s):
    assert unpack_to_string(pack(s), len(s)) == s.upper()


@settings(max_examples=300, deadline=None)
@given(_DNA)
def test_softmask_equals_upper(s):
    assert pack(s) == pack(s.upper())


@settings(max_examples=300, deadline=None)
@given(_DNA_UPPER)
def test_canonical_idempotent_rc_equivalent_minimal(s):
    k = len(s)
    bits = pack(s)
    canon, _ = canonical_packed(bits, k)
    again, again_rc = canonical_packed(canon, k)
    assert again == canon and not again_rc  # idempotence; fwd kept on ties
    rc_bits = revcomp_packed(bits, k)
    canon_rc, _ = canonical_packed(rc_bits, k)
    assert canon_rc == canon  # RC-equivalence
    assert canon <= bits and canon <= rc_bits  # minimality


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=(1 << 64) - 1), st.integers(1, 32))
def test_unpack_arbitrary_u64_valid(bits, k):
    s = unpack_to_string(bits, k)
    assert len(s) == k
    assert set(s) <= set("ACGT")


@settings(max_examples=200, deadline=None)
@given(_DNA_UPPER, st.data())
def test_pack_injective_under_mutation(s, data):
    k = len(s)
    pos = data.draw(st.integers(0, k - 1))
    others = [b for b in "ACGT" if b != s[pos]]
    repl = data.draw(st.sampled_from(others))
    mutated = s[:pos] + repl + s[pos + 1 :]
    assert pack(mutated) != pack(s)


class TestEngineProperties:
    """Engine-level invariants on seeded random dirty streams."""

    @pytest.mark.parametrize("seed", range(6))
    def test_total_counts_bounded_by_windows(self, seed):
        from krust.io.reader import ParsedStreams
        from krust.models.engines import NumpyEngine, count_streams

        rng = np.random.default_rng(seed)
        k = int(rng.integers(1, 33))
        n = int(rng.integers(k, 5000))
        codes = rng.integers(0, 5, size=n, dtype=np.uint8)  # 4 = invalid
        streams = ParsedStreams(codes, None, 1, n)
        result = count_streams(streams, k)
        windows = n - k + 1
        assert result.total <= windows
        # exact equality when no invalid bases land in any window
        oracle = NumpyEngine().count(streams, k)
        assert np.array_equal(result.codes, oracle.codes)
        assert np.array_equal(result.counts, oracle.counts)

    @pytest.mark.parametrize("seed", range(4))
    def test_kmer_plus_rc_merge_to_count_2(self, seed):
        from krust.api import count_kmers_from_sequences

        rng = np.random.default_rng(100 + seed)
        k = int(rng.integers(1, 33))
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, k))
        rc = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        counts = count_kmers_from_sequences([s, rc], k)
        canon = unpack_to_string(canonical_packed(pack(s), k)[0], k)
        if s == rc:  # palindrome: both records are the same k-mer
            assert counts == {canon: 2}
        else:
            assert counts == {canon: 2}


@settings(max_examples=50, deadline=None)
@given(
    st.dictionaries(
        st.integers(0, (1 << 16) - 1),
        st.integers(1, (1 << 63)),
        min_size=0,
        max_size=64,
    )
)
def test_index_roundtrip_random_maps(counts):
    from krust.index import KmerIndex, deserialize_index, serialize_index

    idx = KmerIndex(8, counts)
    loaded = deserialize_index(serialize_index(idx))
    assert loaded.k.get() == 8
    assert loaded.counts == counts


def test_fuzz_targets_in_suite():
    """Run the seeded fuzz harness (reference: fuzz/fuzz_targets/*.rs) as
    part of every test pass."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "fuzz", "fuzz_targets.py")
    spec = importlib.util.spec_from_file_location("fuzz_targets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(10_000)


@settings(max_examples=150, deadline=None)
@given(
    codes_list=st.lists(
        st.integers(min_value=0, max_value=5),  # 4/5 both mean invalid
        min_size=1,
        max_size=400,
    ),
    k=st.integers(1, 32),
    threads=st.sampled_from([None, 1, 2, 3]),
)
def test_native_count_matches_numpy_oracle(codes_list, k, threads):
    """The native host counting core (all k regimes, optional forced
    threading) agrees with the numpy oracle on arbitrary dirty streams —
    the property analog of the seeded differentials in test_native.py
    (reference semantics: src/run.rs:526-571 window scan)."""
    import os

    from krust.io import native
    from krust.models.engines import count_stream_numpy

    codes = np.array([min(c, 4) for c in codes_list], dtype=np.uint8)
    saved = os.environ.pop("KRUST_NATIVE_THREADS", None)
    try:
        if threads is not None:
            os.environ["KRUST_NATIVE_THREADS"] = str(threads)
        got = native.count_stream_native(codes, None, None, k)
        if got is None:
            pytest.skip("native lib unavailable")
        exp = count_stream_numpy(codes, None, k)
        np.testing.assert_array_equal(got[0], exp[0].astype(np.uint64))
        np.testing.assert_array_equal(got[1], exp[1].astype(np.uint64))
    finally:
        os.environ.pop("KRUST_NATIVE_THREADS", None)
        if saved is not None:
            os.environ["KRUST_NATIVE_THREADS"] = saved
