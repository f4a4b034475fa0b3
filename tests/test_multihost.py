"""Multi-process (multi-host simulation) distributed counting test.

Spawns 2 OS processes, each with 4 virtual CPU devices, joined via
jax.distributed into one 8-device mesh. Each process parses only its half of
the input (per-host input sharding via make_array_from_process_local_data);
the hash-sharded all-to-all exchange produces disjoint per-device table
shards, and their union must exactly equal the single-process oracle.

SURVEY.md §4's implication (multi-host simulation standing in for a pod
slice); the reference has no distributed layer to compare against.
"""

import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

import oracle

pytestmark = pytest.mark.slow


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize(
    "k,alphabet",
    [
        (5, "ACGTN"),   # dirty input: dense lockstep path
        (21, "ACGT"),   # clean input: flat lockstep path (metadata widths)
    ],
)
def test_two_process_count_matches_oracle(tmp_path, k, alphabet):
    port = _free_port()
    env = dict(os.environ)
    env.update(
        KRUST_PLATFORM="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="",
    )
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    procs = [
        subprocess.Popen(
            [
                sys.executable, worker, str(p), "2",
                f"127.0.0.1:{port}", str(tmp_path), str(k), alphabet,
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for p in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"

    # union of the disjoint hash-range shards == oracle over ALL records
    codes, counts = [], []
    for p in range(2):
        z = np.load(tmp_path / f"shard_{p}.npz")
        codes.append(z["codes"])
        counts.append(z["counts"])
    codes = np.concatenate(codes)
    counts = np.concatenate(counts)
    assert np.unique(codes).shape[0] == codes.shape[0], "shards overlap"
    order = np.argsort(codes)
    codes, counts = codes[order], counts[order]

    rng = random.Random(1234)
    seqs = [oracle.random_dna(rng, rng.randint(0, 300), alphabet) for _ in range(40)]
    expected = oracle.count_sequences(seqs, k)

    from krust.kmer import unpack_many

    got = dict(zip(unpack_many(codes, k), counts.tolist()))
    assert got == expected
