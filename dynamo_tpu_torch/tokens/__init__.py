"""Token block sequences and content hashing — the port's copy of
``dynamo_tpu/tokens``.

Fixed-size token blocks with XXH3-64 *block hashes* (local content) and
chained *sequence hashes* (prefix identity). The values are the JAX
package's exactly — a block of tokens has one identity in both engines:

  block_hash(block)    = xxh3_64(le_u32_bytes(tokens in block))
  seq_hash(block_0)    = block_hash(block_0)
  seq_hash(block_i)    = xxh3_64(le_u64(seq_hash(block_{i-1})) || le_u64(block_hash(block_i)))

The card's machine has no ``xxhash`` package, so XXH3-64 (seed 0, default
secret) is written out here in Python from the public specification, for
every input length — the same algorithm as ``dynamo_tpu/native/tokens.cc``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Sequence

Token = int
BlockHash = int
SequenceHash = int

__all__ = [
    "Token",
    "BlockHash",
    "SequenceHash",
    "xxh3_64",
    "compute_block_hash",
    "compute_seq_hashes",
    "compute_block_hashes_for_tokens",
    "TokenBlock",
    "TokenBlockSequence",
]

# ---- XXH3-64 (public specification) ----------------------------------------

_M64 = (1 << 64) - 1
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_SECRET_LEN = 192


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _mix16(data: bytes, i: int, s: int) -> int:
    return _mul128_fold64(_r64(data, i) ^ _r64(_SECRET, s),
                          _r64(data, i + 8) ^ _r64(_SECRET, s + 8))


def _hash_long(data: bytes, n: int) -> int:
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]

    def accumulate(off: int, s: int) -> None:
        for i in range(8):
            val = _r64(data, off + 8 * i)
            key = val ^ _r64(_SECRET, s + 8 * i)
            acc[i ^ 1] = (acc[i ^ 1] + val) & _M64
            acc[i] = (acc[i] + (key & 0xFFFFFFFF) * (key >> 32)) & _M64

    stripes = (_SECRET_LEN - 64) // 8           # 16 stripes per block
    block_len = 64 * stripes                    # 1024 bytes
    n_blocks = (n - 1) // block_len
    for blk in range(n_blocks):
        for s in range(stripes):
            accumulate(blk * block_len + s * 64, s * 8)
        for i in range(8):                      # scramble
            a = acc[i] ^ (acc[i] >> 47) ^ _r64(_SECRET, _SECRET_LEN - 64 + 8 * i)
            acc[i] = (a * _P32_1) & _M64
    for s in range(((n - 1) - block_len * n_blocks) // 64):
        accumulate(n_blocks * block_len + s * 64, s * 8)
    accumulate(n - 64, _SECRET_LEN - 64 - 7)    # last, unaligned stripe
    result = (n * _P64_1) & _M64
    for i in range(4):
        result += _mul128_fold64(acc[2 * i] ^ _r64(_SECRET, 11 + 16 * i),
                                 acc[2 * i + 1] ^ _r64(_SECRET, 11 + 16 * i + 8))
    return _avalanche(result & _M64)


def xxh3_64(data: bytes) -> int:
    """XXH3-64 of ``data`` with seed 0 and the default secret."""
    n = len(data)
    if n == 0:
        return _xxh64_avalanche(_r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        combined = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                    | (n << 8))
        return _xxh64_avalanche(combined ^ (_r32(_SECRET, 0) ^ _r32(_SECRET, 4)))
    if n <= 8:
        bitflip = _r64(_SECRET, 8) ^ _r64(_SECRET, 16)
        in64 = _r32(data, n - 4) + (_r32(data, 0) << 32)
        h = in64 ^ bitflip
        h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
        h = (h * _PMX2) & _M64
        h ^= (h >> 35) + n
        h = (h * _PMX2) & _M64
        return h ^ (h >> 28)
    if n <= 16:
        lo = _r64(data, 0) ^ (_r64(_SECRET, 24) ^ _r64(_SECRET, 32))
        hi = _r64(data, n - 8) ^ (_r64(_SECRET, 40) ^ _r64(_SECRET, 48))
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        return _avalanche((n + swapped + hi + _mul128_fold64(lo, hi)) & _M64)
    if n <= 128:
        acc = n * _P64_1
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96) + _mix16(data, n - 64, 112)
                acc += _mix16(data, 32, 64) + _mix16(data, n - 48, 80)
            acc += _mix16(data, 16, 32) + _mix16(data, n - 32, 48)
        acc += _mix16(data, 0, 0) + _mix16(data, n - 16, 16)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = n * _P64_1
        for i in range(8):
            acc += _mix16(data, 16 * i, 16 * i)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            acc += _mix16(data, 16 * i, 16 * (i - 8) + 3)
        acc += _mix16(data, n - 16, 136 - 17)
        return _avalanche(acc & _M64)
    return _hash_long(data, n)


# ---- block / sequence hashes ------------------------------------------------

def compute_block_hash(tokens: Sequence[int]) -> BlockHash:
    """Hash the raw token contents of one block (no chaining)."""
    return xxh3_64(struct.pack(f"<{len(tokens)}I", *tokens))


def _chain(parent: SequenceHash, block_hash: BlockHash) -> SequenceHash:
    return xxh3_64(struct.pack("<QQ", parent, block_hash))


def compute_seq_hashes(block_hashes: Sequence[BlockHash]) -> list[SequenceHash]:
    """Chain block hashes into prefix-identifying sequence hashes."""
    out: list[SequenceHash] = []
    parent: SequenceHash | None = None
    for bh in block_hashes:
        parent = bh if parent is None else _chain(parent, bh)
        out.append(parent)
    return out


def compute_block_hashes_for_tokens(tokens: Sequence[int], block_size: int) -> list[SequenceHash]:
    """Sequence hashes for every *complete* block of ``tokens``."""
    n_full = len(tokens) // block_size
    hashes = [compute_block_hash(tokens[i * block_size : (i + 1) * block_size])
              for i in range(n_full)]
    return compute_seq_hashes(hashes)


@dataclass(frozen=True)
class TokenBlock:
    tokens: tuple[int, ...]
    block_hash: BlockHash
    sequence_hash: SequenceHash
    position: int  # block index within the sequence


@dataclass
class TokenBlockSequence:
    """A token sequence chunked into fixed-size blocks with incremental
    hashing: complete blocks are frozen with their hashes, the partial
    tail stays mutable."""

    block_size: int
    blocks: list[TokenBlock] = field(default_factory=list)
    partial: list[int] = field(default_factory=list)

    @classmethod
    def from_tokens(cls, tokens: Iterable[int], block_size: int) -> "TokenBlockSequence":
        seq = cls(block_size=block_size)
        seq.extend(tokens)
        return seq

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial)

    @property
    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial)
        return out

    def append(self, token: int) -> TokenBlock | None:
        """Append one token; returns the newly-completed block, if any."""
        self.partial.append(token)
        if len(self.partial) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        sealed = []
        for t in tokens:
            blk = self.append(t)
            if blk is not None:
                sealed.append(blk)
        return sealed

    def _seal(self) -> TokenBlock:
        bh = compute_block_hash(self.partial)
        parent = self.blocks[-1].sequence_hash if self.blocks else None
        sh = bh if parent is None else _chain(parent, bh)
        blk = TokenBlock(
            tokens=tuple(self.partial), block_hash=bh, sequence_hash=sh, position=len(self.blocks)
        )
        self.blocks.append(blk)
        self.partial.clear()
        return blk

    def sequence_hashes(self) -> list[SequenceHash]:
        return [b.sequence_hash for b in self.blocks]

    def truncate_blocks(self, n_blocks: int) -> None:
        """Drop blocks beyond ``n_blocks`` and any partial tail."""
        del self.blocks[n_blocks:]
        self.partial.clear()
