"""L0 scalar core tests (mirrors reference: src/kmer.rs:626-854 suite)."""

import numpy as np
import pytest

from krust import kmer
from krust.errors import InvalidBaseError, KmerLengthError

from oracle import canonical as oracle_canonical


class TestKmerLength:
    def test_valid_bounds(self):
        assert kmer.KmerLength(1).get() == 1
        assert kmer.KmerLength(32).get() == 32
        assert kmer.KmerLength(21).get() == 21

    @pytest.mark.parametrize("k", [0, 33, -1, 1000])
    def test_invalid(self, k):
        with pytest.raises(KmerLengthError):
            kmer.KmerLength(k)

    def test_non_integer(self):
        with pytest.raises(KmerLengthError):
            kmer.KmerLength("21")

    def test_equality_and_int(self):
        assert kmer.KmerLength(5) == kmer.KmerLength(5)
        assert kmer.KmerLength(5) == 5
        assert int(kmer.KmerLength(7)) == 7


class TestPackUnpack:
    def test_acgt(self):
        # ACGT = 00 01 10 11 (reference: src/kmer.rs doc test)
        assert kmer.pack("ACGT") == 0b00_01_10_11

    def test_lowercase_normalized(self):
        assert kmer.pack("acgt") == kmer.pack("ACGT")
        assert kmer.normalize(b"aCgT") == b"ACGT"

    def test_invalid_base_position(self):
        with pytest.raises(InvalidBaseError) as ei:
            kmer.pack("GANTACA")
        assert ei.value.position == 2
        assert ei.value.base == ord("N")

    @pytest.mark.parametrize("k", range(1, 33))
    def test_roundtrip_all_k(self, k):
        import random

        rng = random.Random(k)
        s = "".join(rng.choice("ACGT") for _ in range(k))
        assert kmer.unpack_to_string(kmer.pack(s), k) == s
        assert kmer.unpack_to_bytes(kmer.pack(s), k) == s.encode()

    def test_unpack_arbitrary_bits_valid(self):
        # any u64 unpacks to a valid ACGT string of length k
        for bits in (0, 2**64 - 1, 0xDEADBEEFCAFEBABE):
            for k in (1, 16, 32):
                s = kmer.unpack_to_string(bits, k)
                assert len(s) == k
                assert set(s) <= set("ACGT")

    def test_k32_uses_all_bits(self):
        s = "T" * 32
        assert kmer.pack(s) == 2**64 - 1
        assert kmer.unpack_to_string(2**64 - 1, 32) == s


class TestCanonical:
    def test_ttt_becomes_aaa(self):
        bits, is_rc = kmer.canonical_packed(kmer.pack("TTT"), 3)
        assert bits == kmer.pack("AAA")
        assert is_rc

    def test_aaa_stays(self):
        bits, is_rc = kmer.canonical_packed(kmer.pack("AAA"), 3)
        assert bits == kmer.pack("AAA")
        assert not is_rc

    def test_palindrome_keeps_forward(self):
        # ACGT is its own reverse complement
        bits, is_rc = kmer.canonical_packed(kmer.pack("ACGT"), 4)
        assert bits == kmer.pack("ACGT")
        assert not is_rc

    @pytest.mark.parametrize("k", [1, 2, 3, 5, 11, 16, 17, 21, 31, 32])
    def test_matches_oracle(self, k):
        import random

        rng = random.Random(1000 + k)
        for _ in range(50):
            s = "".join(rng.choice("ACGT") for _ in range(k))
            assert kmer.canonical_string(s) == oracle_canonical(s)

    def test_idempotent(self):
        import random

        rng = random.Random(7)
        for _ in range(100):
            k = rng.randint(1, 32)
            s = "".join(rng.choice("ACGT") for _ in range(k))
            c1 = kmer.canonical_string(s)
            assert kmer.canonical_string(c1) == c1

    def test_rc_equivalence(self):
        import random

        from oracle import revcomp

        rng = random.Random(8)
        for _ in range(100):
            k = rng.randint(1, 32)
            s = "".join(rng.choice("ACGT") for _ in range(k))
            assert kmer.canonical_string(s) == kmer.canonical_string(revcomp(s))

    def test_canonical_le_both(self):
        import random

        from oracle import revcomp

        rng = random.Random(9)
        for _ in range(100):
            k = rng.randint(1, 32)
            s = "".join(rng.choice("ACGT") for _ in range(k))
            c = kmer.canonical_string(s)
            assert c <= s and c <= revcomp(s)


class TestVectorizedHelpers:
    def test_unpack_many(self):
        codes = np.array([kmer.pack("ACG"), kmer.pack("TTT")], dtype=np.uint64)
        assert kmer.unpack_many(codes, 3) == ["ACG", "TTT"]

    def test_pack_many_roundtrip(self):
        strs = ["ACGTA", "TTTTT", "GATTA"]
        packed = kmer.pack_many(strs)
        assert kmer.unpack_many(packed, 5) == strs

    def test_encode_bytes(self):
        codes = kmer.encode_bytes(b"ACGTNacgtn")
        assert codes.tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]
