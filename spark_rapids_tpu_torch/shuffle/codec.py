"""Shuffle compression codecs — port of ``spark_rapids_tpu/shuffle/codec.py``
(``TableCompressionCodec``).

Only the pass-through codec is ported (``none``, also spelled ``copy``),
and the exchange always writes with it; a block names its codec, which
the read side looks up here. The reference's lz4, zstd, snappy and gzip
come from pyarrow, which the port does not import; asking for one
raises.
"""

from __future__ import annotations


class TableCompressionCodec:
    name = "none"

    def compress(self, payload: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, payload: bytes, uncompressed_size: int) -> bytes:
        raise NotImplementedError


class CopyCodec(TableCompressionCodec):
    """Pass-through (the reference's ``CopyCodec``)."""

    name = "none"

    def compress(self, payload: bytes) -> bytes:
        return payload

    def decompress(self, payload: bytes, uncompressed_size: int) -> bytes:
        return payload


def get_codec(name: str) -> TableCompressionCodec:
    name = (name or "none").lower()
    if name in ("none", "copy"):
        return CopyCodec()
    if name in ("lz4", "zstd", "snappy", "gzip"):
        raise NotImplementedError(
            f"shuffle compression codec '{name}' is not ported; use 'none'")
    raise ValueError(f"unknown shuffle compression codec '{name}'")
