""".kmix index tests (mirrors reference: src/index.rs:471-609)."""

import gzip
import random
import struct
import zlib

import pytest

import krust as kt
from krust.errors import InvalidIndexError
from krust.index import deserialize_index, serialize_index


def test_crc32_known_vector():
    # reference: src/index.rs:588-592 — crc32(b"123456789") == 0xCBF43926
    assert zlib.crc32(b"123456789") == 0xCBF43926


def test_roundtrip(tmp_path):
    counts = {0b00_01_10_11: 42, 7: 1, 2**64 - 1: 3}
    idx = kt.KmerIndex(kt.KmerLength(4), counts)
    p = str(tmp_path / "x.kmix")
    kt.save_index(idx, p)
    loaded = kt.load_index(p)
    assert loaded.k == kt.KmerLength(4)
    assert loaded.counts == counts


def test_roundtrip_gzip(tmp_path):
    counts = {1: 2, 3: 4}
    idx = kt.KmerIndex(5, counts)
    p = str(tmp_path / "x.kmix.gz")
    kt.save_index(idx, p)
    # file is real gzip
    with open(p, "rb") as f:
        assert f.read(2) == b"\x1f\x8b"
    assert kt.load_index(p).counts == counts


def test_empty_index_roundtrip(tmp_path):
    idx = kt.KmerIndex(8, {})
    p = str(tmp_path / "e.kmix")
    kt.save_index(idx, p)
    loaded = kt.load_index(p)
    assert len(loaded) == 0 and loaded.is_empty()


def test_byte_layout():
    # header: "KMIX" + version 1 + k + count(le u64); entry pairs; crc32
    idx = kt.KmerIndex(4, {0b00011011: 42})
    raw = serialize_index(idx)
    assert raw[:4] == b"KMIX"
    assert raw[4] == 1
    assert raw[5] == 4
    assert struct.unpack_from("<Q", raw, 6)[0] == 1
    assert struct.unpack_from("<Q", raw, 14)[0] == 0b00011011
    assert struct.unpack_from("<Q", raw, 22)[0] == 42
    assert len(raw) == 14 + 16 + 4
    crc = struct.unpack_from("<I", raw, 30)[0]
    assert crc == zlib.crc32(raw[:-4])


def test_corrupted_crc_rejected(tmp_path):
    idx = kt.KmerIndex(4, {1: 2})
    raw = bytearray(serialize_index(idx))
    raw[16] ^= 0xFF  # flip a data byte
    with pytest.raises(InvalidIndexError, match="CRC32"):
        deserialize_index(bytes(raw))


def test_bad_magic_rejected():
    idx = kt.KmerIndex(4, {1: 2})
    raw = bytearray(serialize_index(idx))
    raw[0:4] = b"NOPE"
    with pytest.raises(InvalidIndexError, match="magic"):
        deserialize_index(bytes(raw))


def test_too_small_rejected():
    with pytest.raises(InvalidIndexError, match="too small"):
        deserialize_index(b"KMIX")


def test_truncated_rejected():
    idx = kt.KmerIndex(4, {1: 2, 3: 4})
    raw = serialize_index(idx)
    # recompute CRC over a truncated body so only size check can catch it
    body = raw[:-20]
    crc = struct.pack("<I", zlib.crc32(body))
    with pytest.raises(InvalidIndexError, match="size"):
        deserialize_index(body + crc)


def test_bad_version_rejected():
    idx = kt.KmerIndex(4, {1: 2})
    raw = bytearray(serialize_index(idx))
    raw[4] = 99
    raw[-4:] = struct.pack("<I", zlib.crc32(bytes(raw[:-4])))
    with pytest.raises(InvalidIndexError, match="version"):
        deserialize_index(bytes(raw))


def test_random_roundtrip():
    # reference: property_tests.rs:246-261
    rng = random.Random(3)
    for _ in range(10):
        k = rng.randint(1, 32)
        counts = {
            rng.getrandbits(2 * k): rng.randint(1, 2**40)
            for _ in range(rng.randint(0, 200))
        }
        idx = kt.KmerIndex(k, counts)
        assert deserialize_index(serialize_index(idx)).counts == counts


def test_index_get_and_strings():
    counts = {kt.pack("ACG"): 7}
    idx = kt.KmerIndex(3, counts)
    assert idx.get(kt.pack("ACG")) == 7
    assert idx.get(kt.pack("TTT")) is None
    assert idx.to_string_counts() == {"ACG": 7}


class TestArrayBackedIndex:
    """Round-2 KmerIndex internals: sorted arrays + binary-search lookups."""

    def test_from_arrays_and_get(self):
        import numpy as np

        codes = np.array([5, 1, 9], np.uint64)
        values = np.array([50, 10, 90], np.uint64)
        idx = kt.KmerIndex.from_arrays(4, codes, values)
        assert list(idx.codes) == [1, 5, 9]  # sorted on construction
        assert idx.get(5) == 50 and idx.get(1) == 10 and idx.get(9) == 90
        assert idx.get(2) is None
        assert len(idx) == 3 and not idx.is_empty()

    def test_counts_property_is_lazy_dict_view(self):
        import numpy as np

        idx = kt.KmerIndex.from_arrays(
            4, np.array([3, 7], np.uint64), np.array([1, 2], np.uint64)
        )
        assert idx._dict is None  # not materialized yet
        assert idx.counts == {3: 1, 7: 2}
        assert idx._dict is not None  # cached after first read

    def test_duplicate_keys_last_wins_on_load(self):
        # hand-built file with a duplicated key: reference HashMap semantics
        import struct
        import zlib

        import numpy as np

        pairs = np.array([[1, 10], [1, 20], [2, 5]], dtype="<u8")
        body = b"KMIX" + bytes([1, 4]) + struct.pack("<Q", 3) + pairs.tobytes()
        body += struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
        idx = deserialize_index(body)
        assert idx.get(1) == 20 and idx.get(2) == 5
        assert len(idx) == 2

    def test_roundtrip_via_arrays(self, tmp_path):
        import numpy as np

        codes = np.arange(100, dtype=np.uint64) * np.uint64(7)
        values = np.arange(100, dtype=np.uint64) + np.uint64(1)
        idx = kt.KmerIndex.from_arrays(8, codes, values)
        p = tmp_path / "arr.kmix"
        kt.save_index(idx, p)
        loaded = kt.load_index(p)
        assert np.array_equal(loaded.codes, codes)
        assert np.array_equal(loaded.values, values)

    def test_from_arrays_duplicate_codes_last_wins(self):
        # duplicate keys in the array path dedup last-wins, matching the
        # dict-built path and the deserialize fallback exactly
        import numpy as np

        codes = np.array([7, 3, 7, 5, 3], dtype=np.uint64)
        values = np.array([1, 2, 9, 4, 8], dtype=np.uint64)
        idx = kt.KmerIndex.from_arrays(4, codes, values)
        assert len(idx) == 3
        assert idx.get(7) == 9 and idx.get(3) == 8 and idx.get(5) == 4
        rt = deserialize_index(serialize_index(idx))
        assert rt.counts == {7: 9, 3: 8, 5: 4}
