"""Array-program building blocks shared by the XLA codec kernels.

These primitives are what replaces the reference's scalar control flow in
the data-parallel codecs (SURVEY.md §7): sequential dependence chains (tag
boundaries, LZ77 back-references, greedy parse) become pointer-doubling
fixpoints; byte cursors become prefix sums; per-byte branches become masked
vector selects. Everything here is pure jnp on fixed shapes, safe under
jit/vmap/shard_map.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.constants import CHAR_TABLE, WORDMASK

# Device-resident LUTs (uint16 entry -> int32 for cheap arithmetic).
CHAR_TABLE_I32 = jnp.asarray(CHAR_TABLE.astype(np.int32))
WORDMASK_U32 = jnp.asarray(WORDMASK)


def ceil_log2(n: int) -> int:
    """Static ceil(log2(n)) for n >= 1."""
    return max(1, int(n - 1).bit_length())


def le32_at_every_position(padded_u8: jnp.ndarray) -> jnp.ndarray:
    """uint32 little-endian load at every byte position.

    ``padded_u8`` must have >= 4 bytes of slack past the last meaningful
    position (the caller zero-pads, mirroring the reference's blind 4-byte
    trailer load, reference src/internal.jl:421-430). Returns
    uint32[len-3] so result[i] = LE32(padded[i:i+4]) for i in [0, len-4].

    Word-based: bitcast to uint32 words, then combine each word with its
    successor per byte phase.
    """
    n = padded_u8.shape[-1]
    nw = n // 4
    words = jax.lax.bitcast_convert_type(
        padded_u8[..., : nw * 4].reshape(*padded_u8.shape[:-1], nw, 4), jnp.uint32
    )
    nxt = jnp.concatenate([words[..., 1:], jnp.zeros_like(words[..., :1])], axis=-1)
    # result for byte position 4*w + ph: (words[w] >> 8*ph) | (nxt[w] << (32-8*ph))
    phases = []
    for ph in range(4):
        if ph == 0:
            phases.append(words)
        else:
            phases.append((words >> (8 * ph)) | (nxt << (32 - 8 * ph)))
    stacked = jnp.stack(phases, axis=-1)  # [..., nw, 4]
    out = stacked.reshape(*padded_u8.shape[:-1], nw * 4)
    return out[..., : n - 3]


def reach_from(start: jnp.ndarray, nxt: jnp.ndarray, n: int, rounds: int | None = None) -> jnp.ndarray:
    """Positions reachable from ``start`` by iterating i -> nxt[i].

    ``nxt`` must be strictly increasing (nxt[i] > i) with values in [0, n]
    where n acts as the absorbing sentinel. Returns bool[n].

    Pointer-doubling: after round k, ``reach`` holds all chain positions at
    distance < 2**k and ``jump`` is the 2**k-step map, so ceil(log2(n))
    rounds cover any chain. This is the parallel replacement for the
    sequential tag-boundary walk (reference src/internal.jl:416-464).
    """
    if rounds is None:
        rounds = ceil_log2(n + 1)
    # Extend with the absorbing sentinel slot at index n.
    jump = jnp.concatenate([nxt.astype(jnp.int32), jnp.array([n], jnp.int32)])
    # One-hot(start), derived from `jump` so it inherits its varying-axis
    # type under shard_map (a constant-built carry would mismatch the loop
    # output's manual axes).
    reach = ((jnp.arange(n + 1, dtype=jnp.int32) + jump * 0) == start).astype(jnp.int32)

    def body(_, state):
        reach, jump = state
        reach = reach.at[jump].max(reach, mode="drop")
        jump = jump[jump]
        return reach, jump

    reach, _ = jax.lax.fori_loop(0, rounds, body, (reach, jump))
    return reach[:n] > 0


def resolve_sources(src: jnp.ndarray, rounds: int | None = None) -> jnp.ndarray:
    """Chase src chains to their fixpoint: result[i] = src^k[i] for large k.

    ``src[i] <= i`` with fixpoints src[i] == i (e.g. literal positions).
    This resolves LZ77 back-reference chains — including self-overlapping
    RLE copies (reference src/internal.jl:469-509) — in log rounds instead
    of a sequential byte loop.
    """
    n = src.shape[-1]
    if rounds is None:
        rounds = ceil_log2(n + 1)

    def body(_, s):
        return jnp.take_along_axis(s, s, axis=-1) if s.ndim > 1 else s[s]

    return jax.lax.fori_loop(0, rounds, body, src.astype(jnp.int32))


def exclusive_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    c = jnp.cumsum(x, axis=axis)
    return c - x


def segment_spread(values_at_starts: jnp.ndarray, is_start: jnp.ndarray) -> jnp.ndarray:
    """Propagate the value at each segment start across its segment.

    ``is_start`` marks segment boundaries; positions before the first start
    get the value scattered at index 0 (callers guarantee a segment starts
    at 0 for valid streams). Implemented as seg-id gather: O(n) + cumsum.
    """
    n = values_at_starts.shape[-1]
    seg_id = jnp.cumsum(is_start.astype(jnp.int32), axis=-1) - 1
    seg_id = jnp.clip(seg_id, 0, n - 1)
    ord_idx = exclusive_cumsum(is_start.astype(jnp.int32), axis=-1)
    # per-ordinal table: scatter value of each start to its ordinal slot
    table = jnp.zeros(n, values_at_starts.dtype).at[jnp.where(is_start, ord_idx, n)].set(
        values_at_starts, mode="drop"
    )
    return table[seg_id]
