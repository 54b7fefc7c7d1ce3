"""The device engine (engine="tpu"): bit-exactness vs the oracle payloads
and full API round-trips through the sqzt container. Runs on the virtual
CPU backend (conftest) through the coders' CPU target; chip_smoke.py runs
the same code path on a GPU."""

import numpy as np
import pytest

import sqz_tpu
from sqz_tpu.oracle.bitstream import BitWriter
from sqz_tpu.oracle.match import greedy_tokens
from sqz_tpu.oracle.squeeze import squeeze_encode_payload
from sqz_tpu.oracle.sqz4 import sqz4_encode_payload
from sqz_tpu.utils import corpus

CASES = [
    corpus.hello(),
    corpus.zeros(1024),
    corpus.rle4(1024),
    corpus.texty(2048, seed=4),
    corpus.random_bytes(512, seed=9),
]


def test_sqz4_device_bit_exact():
    from sqz_tpu.ops import sqz4_jax
    rej = lambda l, d: l <= 3 and d.bit_length() > 3
    tokens = [greedy_tokens(d, 1 << 10, 2, 254, reject=rej) for d in CASES]
    payloads = sqz4_jax.encode_blocks(tokens, blk_bits=11)
    for d, p in zip(CASES, payloads):
        assert p == sqz4_encode_payload(d, 1 << 10, lz=True)
    blocks = sqz4_jax.decode_blocks(payloads, [len(d) for d in CASES],
                                    blk_bits=11)
    for d, b in zip(CASES, blocks):
        assert b == d


def test_squeeze_device_bit_exact():
    from sqz_tpu.ops import squeeze_jax
    tokens = [greedy_tokens(d, 1 << 10, 3, 257) for d in CASES]
    payloads = squeeze_jax.encode_blocks(tokens, blk_bits=11)
    for d, p in zip(CASES, payloads):
        bw = BitWriter()
        squeeze_encode_payload(d, 10, bw)
        assert p == bw.getvalue()
    blocks = squeeze_jax.decode_blocks(payloads, [len(d) for d in CASES],
                                       blk_bits=11)
    for d, b in zip(CASES, blocks):
        assert b == d


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_api_tpu_engine_roundtrip(fmt):
    data = corpus.texty(6000, seed=6)
    blob = sqz_tpu.compress(data, fmt=fmt, engine="tpu", win_bits=10,
                            blocks=True, blk_bits=11)
    assert sqz_tpu.decompress(blob, engine="tpu") == data
    # cross-engine: oracle decodes the device-encoded container
    assert sqz_tpu.decompress(blob, engine="oracle") == data


def test_tpu_matches_native_container_bytes():
    from sqz_tpu import native
    if not native.available():
        pytest.skip("native unavailable")
    data = corpus.texty(6000, seed=8)
    tpu_blob = sqz_tpu.compress(data, fmt="sqz4", engine="tpu", win_bits=10,
                                blocks=True, blk_bits=11)
    nat_blob = sqz_tpu.compress(data, fmt="sqz4", engine="native", win_bits=10,
                                blocks=True, blk_bits=11)
    assert tpu_blob == nat_blob


def test_corrupt_device_stream_rejected():
    data = corpus.texty(3000, seed=10)
    blob = bytearray(sqz_tpu.compress(data, fmt="sqz4", engine="tpu",
                                      win_bits=10, blocks=True, blk_bits=11))
    blob[len(blob) // 2] ^= 0xFF
    with pytest.raises((ValueError, Exception)):
        out = sqz_tpu.decompress(bytes(blob), engine="tpu")
        assert out != data  # if it decodes, it must not silently match
