"""Block-parallel Snappy encoder as an XLA array program.

The data-parallel replacement for the reference's sequential greedy scan
(reference src/internal.jl:127-250). The scalar loop carries three
dependence chains — the hash table (most-recent previous occurrence), the
greedy parse cursor, and the output cursor. Each is replaced by a parallel
construct (SURVEY.md §7 step 4):

  match finding   exact most-recent previous occurrence of each 4-byte
                  group via a stable sort on the raw 32-bit values —
                  strictly better than the reference's 14-bit hash table
                  (no collisions, no skip-heuristic misses), so parse
                  density >= libsnappy's.

  match length    vectorized 4-byte-stride extension over all positions at
                  once (masked while_loop; exact, never reads past the
                  block). Lengths are capped at config.max_match_scan: a
                  longer match simply re-matches at the next parse position
                  at the same offset, producing the same 64-byte chunk tags
                  the reference's emit_copy! chunking yields
                  (reference src/internal.jl:306-329), so density is
                  unchanged.

  greedy parse    next[p] = p + matchlen[p] (match) or p + 1 (literal byte);
                  the parse positions are the orbit of 0 under next,
                  computed by pointer doubling. Literal runs = maximal
                  reached ranges without matches, grouped into single
                  literal tags.

  emission        per-tag output sizes -> masked prefix sum -> output
                  offsets; tag bytes are then materialized position-wise
                  (segment gather + arithmetic on the tag record), exactly
                  inverse to the decoder's mapping.

Blocks are independent (hash window resets per 64 KiB, offsets never cross
blocks — reference src/Snappy.jl:29-33) and vmapped; that axis is what
shards across devices.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import varint
from ..core.config import DEFAULT_CONFIG
from ..core.constants import BLOCK_SIZE, max_compressed_length
from .primitives import exclusive_cumsum, le32_at_every_position, reach_from

# Slack past the block so u32 loads at any position < BLOCK_SIZE stay in
# bounds during match extension.
ENC_PAD = 8
# Worst-case tag-stream bytes for one 64 KiB block (no varint header).
BLOCK_MAX_OUT = max_compressed_length(BLOCK_SIZE)

_MATCH_CAP = DEFAULT_CONFIG.max_match_scan


def _tz_bytes_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Number of trailing zero BYTES of a uint32 xor (0 -> 4)."""
    tz = jnp.where(x == 0, 32, 31 - jax.lax.clz(x & (~x + 1)))
    return (tz >> 3).astype(jnp.int32)


def _find_candidates(u32: jnp.ndarray, blen) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two most recent previous positions with an identical 4-byte group.

    Returns (cand1, cand2)[p] (int32, -1 if none). Exact: sorts the raw
    values, so unlike the reference's 16K-entry table there are no hash
    collisions and no positions skipped
    (reference src/internal.jl:94,107-113,162-191). The second candidate
    matters because the most recent occurrence is not always the longest
    continuation; extending both and keeping the more profitable one
    recovers matches the reference finds only by accident of its table.
    """
    n = u32.shape[-1]
    order = jnp.argsort(u32, stable=True).astype(jnp.int32)
    sv = u32[order]

    def prev_k(k: int) -> jnp.ndarray:
        same = jnp.concatenate([jnp.zeros(k, jnp.int32), (sv[k:] == sv[:-k]).astype(jnp.int32)])
        prev = jnp.where(same > 0, jnp.concatenate([jnp.zeros(k, jnp.int32), order[:-k]]), -1)
        cand = jnp.zeros(n, jnp.int32).at[order].set(prev)
        # Candidates whose 4-byte group straddles the block end are unusable
        # (their tail is padding).
        return jnp.where((cand >= 0) & (cand <= blen - 4), cand, -1)

    return prev_k(1), prev_k(2)


def _match_lengths(u32: jnp.ndarray, cand: jnp.ndarray, blen, cap: int) -> jnp.ndarray:
    """Exact match length (>=4 where cand valid, else 0), capped at ``cap``
    and clamped to the block end. Vectorized 4-byte strides; the while_loop
    exits as soon as every lane has terminated, so cost tracks the longest
    live match, not the cap."""
    n = cand.shape[-1]
    pos = jnp.arange(n, dtype=jnp.int32)
    valid = (cand >= 0) & (u32[jnp.clip(cand, 0, n - 1)] == u32) & (pos <= blen - 4)
    ml0 = jnp.where(valid, 4, 0)

    def cond(state):
        i, _, active = state
        return (i < cap // 4) & jnp.any(active)

    def body(state):
        i, ml, active = state
        a = u32[jnp.clip(pos + ml, 0, n - 1)]
        b = u32[jnp.clip(cand + ml, 0, n - 1)]
        raw = jnp.where(a == b, 4, _tz_bytes_u32(a ^ b))
        add = jnp.minimum(raw, jnp.minimum(blen - (pos + ml), cap - ml))
        add = jnp.maximum(add, 0)
        ml = ml + jnp.where(active, add, 0)
        active = active & (add == 4)
        return i + 1, ml, active

    _, ml, _ = jax.lax.while_loop(cond, body, (0, ml0, valid))
    return jnp.where(valid, ml, 0)


def _copy_nbytes(m: jnp.ndarray, d: jnp.ndarray):
    """Emitted byte count for a copy of length m at offset d, plus the chunk
    split (k64 full-64 chunks, optional 60 chunk, remainder) mirroring the
    reference's chunking loop (reference src/internal.jl:306-329)."""
    k64 = jnp.where(m >= 68, (m - 4) // 64, 0)
    m2 = m - 64 * k64
    has60 = (m2 > 64).astype(jnp.int32)
    rem = m2 - 60 * has60
    rem2 = (rem < 12) & (d < 2048)
    nbytes = 3 * (k64 + has60) + jnp.where(rem2, 2, 3)
    return nbytes, k64, has60, rem, rem2


def _literal_header_len(length: jnp.ndarray) -> jnp.ndarray:
    nm1 = length - 1
    return jnp.where(nm1 < 60, 1, jnp.where(nm1 < 256, 2, 3))


def encode_block(
    block_padded: jnp.ndarray,
    blen,
    cap: int = _MATCH_CAP,
    min_profit: int = 0,
    min_profit_incompressible: int = 2,
):
    """Encode one block: uint8[BLOCK_SIZE + ENC_PAD] -> tag stream.

    Returns (out: uint8[BLOCK_MAX_OUT], olen: int32).
    """
    n = block_padded.shape[-1] - ENC_PAD
    pos = jnp.arange(n, dtype=jnp.int32)
    u32 = le32_at_every_position(block_padded)[:n]

    cand1, cand2 = _find_candidates(u32, blen)
    ml1 = _match_lengths(u32, cand1, blen, cap)
    ml2 = _match_lengths(u32, cand2, blen, cap)
    cb1, _, _, _, _ = _copy_nbytes(jnp.maximum(ml1, 4), jnp.maximum(pos - cand1, 1))
    cb2, _, _, _, _ = _copy_nbytes(jnp.maximum(ml2, 4), jnp.maximum(pos - cand2, 1))
    p1 = jnp.where(ml1 >= 4, ml1 - cb1, -1)
    p2 = jnp.where(ml2 >= 4, ml2 - cb2, -1)
    use2 = p2 > p1  # older candidate only when strictly more profitable
    cand = jnp.where(use2, cand2, cand1)
    ml = jnp.where(use2, ml2, ml1)
    offset = jnp.where(ml >= 4, pos - cand, 0)
    cbytes_all, _, _, _, _ = _copy_nbytes(jnp.maximum(ml, 4), jnp.maximum(offset, 1))
    profit = ml - cbytes_all
    found = ml >= 4
    # Lazy matching (zlib-style, vectorized): a match is demoted to a
    # literal byte when the very next position holds a strictly more
    # profitable match — greedy-at-every-position otherwise fragments
    # coverage into short copies the reference's sparser probe never takes.
    profit_next = jnp.concatenate([profit[1:], jnp.zeros(1, profit.dtype)])
    ml_next = jnp.concatenate([ml[1:], jnp.zeros(1, ml.dtype)])
    lazy_demote = (ml_next >= 4) & (profit_next > profit)

    def parse(min_p: int):
        """Greedy parse (orbit of 0 under next) for one profit threshold.

        The threshold trades marginal matches against literal-split
        overhead: 0 is best on compressible data, higher wins on
        near-incompressible data where every spare copy splits a long
        literal. Returns the full tag layout + its output size.
        """
        is_match = found & (profit >= min_p) & ~lazy_demote
        nxt = jnp.where(is_match, pos + ml, pos + 1)
        nxt = jnp.minimum(nxt, n)
        reached = reach_from(jnp.int32(0), nxt, n) & (pos < blen)

        is_copy_tag = reached & is_match
        reached_i = reached.astype(jnp.int32)
        reached_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), reached_i[:-1]])
        is_lit_start = reached & (~is_match) & (reached_prev == 0)

        # Literal run length: distance to the next copy tag (or block end).
        INF = jnp.int32(n + 1)
        copy_pos = jnp.where(is_copy_tag, pos, INF)
        # (cummax of the negated, reversed array is miscompiled by XLA:GPU
        # once vmapped over 32 or more blocks; the reverse cummin is not.)
        next_copy = jax.lax.cummin(copy_pos, reverse=True)
        lit_len = jnp.minimum(next_copy, blen) - pos  # valid at lit starts

        cbytes, _, _, _, _ = _copy_nbytes(ml, offset)
        hl = _literal_header_len(jnp.maximum(lit_len, 1))
        size = jnp.where(is_copy_tag, cbytes, 0) + jnp.where(is_lit_start, hl + lit_len, 0)
        olen = jnp.sum(size)
        return olen, (is_copy_tag, is_lit_start, lit_len, size)

    # Dual parse, keep the smaller stream per block (both are valid Snappy).
    olen_a, parse_a = parse(min_profit)
    olen_b, parse_b = parse(min_profit_incompressible)
    use_b = olen_b < olen_a
    olen = jnp.where(use_b, olen_b, olen_a)
    is_copy_tag, is_lit_start, lit_len, size = jax.tree_util.tree_map(
        lambda a, b: jnp.where(use_b, b, a), parse_a, parse_b
    )
    out_off = exclusive_cumsum(size)
    _, k64, has60, rem, rem2 = _copy_nbytes(ml, offset)

    # --- materialize bytes: scatter tag records at their output offsets,
    # then compute each output byte from its segment record.
    is_tag = is_copy_tag | is_lit_start
    t_off = jnp.where(is_tag, out_off, BLOCK_MAX_OUT)
    mo = BLOCK_MAX_OUT
    out_iota = jnp.arange(mo, dtype=jnp.int32)
    mark = jnp.zeros(mo, jnp.int32).at[t_off].set(1, mode="drop") > 0
    seg_p = jnp.zeros(mo, jnp.int32).at[t_off].set(pos, mode="drop")
    seg_copy = jnp.zeros(mo, jnp.int32).at[t_off].set(is_copy_tag.astype(jnp.int32), mode="drop")

    spos = jax.lax.cummax(jnp.where(mark, out_iota, 0))
    delta = out_iota - spos
    p = seg_p[spos]  # input position of my tag
    seg_is_copy = seg_copy[spos] > 0

    # Copy record fields (gathered per output byte).
    d = offset[p]
    k64_s, has60_s, rem_s, rem2_s = k64[p], has60[p], rem[p], rem2[p]
    nfull = k64_s + has60_s
    in_full = delta < 3 * nfull
    chunk_len = jnp.where(delta // 3 < k64_s, 64, 60)
    bytepos_f = delta % 3
    full_byte = jnp.where(
        bytepos_f == 0,
        0x02 | ((chunk_len - 1) << 2),
        jnp.where(bytepos_f == 1, d & 0xFF, d >> 8),
    )
    rd = delta - 3 * nfull
    byte2 = jnp.where(rd == 0, 0x01 | ((rem_s - 4) << 2) | ((d >> 8) << 5), d & 0xFF)
    byte3 = jnp.where(rd == 0, 0x02 | ((rem_s - 1) << 2), jnp.where(rd == 1, d & 0xFF, d >> 8))
    copy_byte = jnp.where(in_full, full_byte, jnp.where(rem2_s, byte2, byte3))

    # Literal record fields.
    L = lit_len[p]
    nm1 = L - 1
    hl_s = _literal_header_len(jnp.maximum(L, 1))
    hdr = jnp.where(
        delta == 0,
        jnp.where(hl_s == 1, nm1 << 2, jnp.where(hl_s == 2, 60 << 2, 61 << 2)),
        jnp.where(delta == 1, nm1 & 0xFF, nm1 >> 8),
    )
    body_idx = jnp.clip(p + delta - hl_s, 0, n + ENC_PAD - 1)
    lit_byte = jnp.where(delta < hl_s, hdr, block_padded.astype(jnp.int32)[body_idx])

    out = jnp.where(seg_is_copy, copy_byte, lit_byte).astype(jnp.uint8)
    return out, olen


@functools.lru_cache(maxsize=8)
def encode_blocks_jit(n_blocks: int, cap: int = _MATCH_CAP):
    """jit-compiled batched block encoder: uint8[B, BS+PAD], int32[B] ->
    (uint8[B, BLOCK_MAX_OUT], int32[B])."""

    @jax.jit
    def fn(blocks, blens):
        return jax.vmap(lambda b, l: encode_block(b, l, cap))(blocks, blens)

    assert n_blocks >= 1
    return fn


# Largest block batch dispatched at once: bounds the set of compiled shapes
# to {1,2,4,...,MAX_BATCH_BLOCKS} and device scratch memory for huge streams.
MAX_BATCH_BLOCKS = 16


def compress_host(inp: np.ndarray) -> bytes:
    """Full host-side compress: split into blocks, run the batched device
    encoder, trim and concatenate under the varint header
    (structure of reference src/Snappy.jl:20-36)."""
    n = len(inp)
    header = varint.encode32(n)
    if n == 0:
        return header
    n_blocks = -(-n // BLOCK_SIZE)
    parts = [header]
    from . import route, select

    for chunk_start in range(0, n_blocks, MAX_BATCH_BLOCKS):
        chunk_blocks = min(MAX_BATCH_BLOCKS, n_blocks - chunk_start)
        buf = np.zeros((chunk_blocks, BLOCK_SIZE + ENC_PAD), np.uint8)
        blens = np.zeros(chunk_blocks, np.int32)
        for i in range(chunk_blocks):
            b = chunk_start + i
            chunk = inp[b * BLOCK_SIZE : (b + 1) * BLOCK_SIZE]
            buf[i, : len(chunk)] = chunk
            blens[i] = len(chunk)
        # content-routed: incompressible blocks take the host-native
        # skip-heuristic path while the device works (ops/route.py)
        parts.extend(route.compress_blocks_routed(buf, blens, chunk_blocks, select.block_encoder))
    return b"".join(parts)
