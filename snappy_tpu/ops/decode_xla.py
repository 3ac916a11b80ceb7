"""Two-pass parallel Snappy decoder as an XLA array program.

This is the data-parallel replacement for the reference's sequential tag loop
(reference src/internal.jl:411-466), which is fundamentally serial: each
tag's position depends on the previous tag's length, and each copy reads
output produced by earlier tags. Both chains are broken here (SURVEY.md §7
step 3):

  pass 1  parse a candidate tag at EVERY byte position (vectorized LUT
          decode), giving a strictly-increasing successor map ``next``;
          the true tag boundaries are the ORBIT of the header end under
          ``next``, enumerated by pointer-doubling list growth
          (L <- L ++ J(L); J <- J∘J) and then sorted into tag order.

  pass 2  per-tag output offsets via a prefix sum over the sorted tag
          list; each output byte finds its producing tag by binary search
          (searchsorted) over the tag output offsets; literals resolve to
          input gathers; copy positions form a source chain
          src[o] = o - offset chased to its literal fixpoint in O(log n)
          gather rounds — overlapping RLE copies resolve naturally since
          the chain unrolls the sequential byte-by-byte semantics.

All corruption checks of the reference are enforced branch-free and reduced
to a per-block ``ok`` flag (offset==0, out-of-range offsets/lengths,
literal overruns, truncated tags, output-length mismatch: reference
src/internal.jl:493-518, src/Snappy.jl:50).

The program is written natively batched (B, N) and scatter-free: batched
``take_along_axis``, ``sort``, ``cumsum`` and ``searchsorted`` only. The
single-stream raw path is the B=1 case. It is the plain reference the
CUDA block decoder (decode_cuda) reproduces bit for bit, and the decoder
on every platform that kernel does not cover.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .primitives import (
    CHAR_TABLE_I32,
    WORDMASK_U32,
    ceil_log2,
    exclusive_cumsum,
    le32_at_every_position,
)

# Slack bytes appended to the compressed buffer so the blind 4-byte trailer
# load at the last positions stays in bounds (reference src/internal.jl:421-430).
COMP_PAD = 4


def _take(x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Batched gather along the last axis."""
    return jnp.take_along_axis(x, idx, axis=-1)


def parse_all_positions(comp_padded: jnp.ndarray, limit: int):
    """Decode a candidate tag at every byte position (batched).

    comp_padded: uint8[B, Nc + COMP_PAD]. Returns per-position arrays over
    [B, Nc): entry fields, output length, bytes consumed, copy offset.
    ``limit`` is a static clamp (> any valid length) keeping corrupt-stream
    arithmetic in int32 without losing the corruptness of the values.
    """
    nc = comp_padded.shape[-1] - COMP_PAD
    b = comp_padded.shape[0]
    c = comp_padded[..., :nc].astype(jnp.int32)
    entry = _take(jnp.broadcast_to(CHAR_TABLE_I32, (b, 256)), c)
    taglen = entry >> 11
    tag32 = le32_at_every_position(comp_padded)
    trailer_u = tag32[..., 1 : nc + 1] & _take(jnp.broadcast_to(WORDMASK_U32, (b, 5)), taglen)
    trailer = jnp.minimum(trailer_u, jnp.uint32(limit)).astype(jnp.int32)
    is_copy = (c & 3) != 0
    length = entry & 0xFF
    lit_len = length + trailer
    out_len = jnp.where(is_copy, length, lit_len)
    consumed = 1 + taglen + jnp.where(is_copy, 0, lit_len)
    offset = (entry & 0x700) + trailer
    return {
        "is_copy": is_copy,
        "taglen": taglen,
        "out_len": out_len,
        "consumed": consumed,
        "offset": offset,
        "lit_len": lit_len,
    }


def tag_orbit(starts: jnp.ndarray, nxt: jnp.ndarray, max_tags: int) -> jnp.ndarray:
    """Sorted tag positions: the orbit of starts[b] under i -> nxt[b, i].

    nxt: int32[B, N], strictly increasing per row, values in [0, N] with N
    the absorbing sentinel. Returns int32[B, CAP] ascending, where CAP is
    max_tags rounded up to a power of two; slots past the orbit hold N.

    Doubling list growth: L holds the first len(L) chain elements and J is
    the len(L)-step map, so L ++ J(L) doubles coverage per round — gathers
    only, no scatter.
    """
    b, n = nxt.shape
    jump = jnp.concatenate([nxt.astype(jnp.int32), jnp.full((b, 1), n, jnp.int32)], axis=-1)
    orbit = starts.astype(jnp.int32)[:, None]
    rounds = ceil_log2(max_tags)
    for _ in range(rounds):
        orbit = jnp.concatenate([orbit, _take(jump, orbit)], axis=-1)
        jump = _take(jump, jump)
    # Entries at/past the sentinel are not tags; sort pushes them to the end.
    orbit = jnp.where(orbit >= n, n, orbit)
    return jnp.sort(orbit, axis=-1)


def decode_blocks_impl(comp: jnp.ndarray, clens, ulens, starts, out_size: int):
    """Decode B independent tag streams.

    comp: uint8[B, Nc + COMP_PAD] (zero slack past each clen)
    clens, ulens, starts: int32[B] — compressed lengths, claimed output
        lengths (<= out_size), first tag positions (0 for headerless
        framed blocks, the varint header length for raw streams).
    Returns (out: uint8[B, out_size], ok: bool[B], total: int32[B]).
    """
    b = comp.shape[0]
    nc = comp.shape[-1] - COMP_PAD
    nu = out_size
    limit = nc + nu + 16
    pos = jnp.arange(nc, dtype=jnp.int32)[None, :]
    clens_c = clens[:, None]

    t = parse_all_positions(comp, limit)

    # --- pass 1: tag boundaries = sorted orbit of the successor map.
    nxt = jnp.minimum(pos + t["consumed"], nc)
    # Every tag consumes >= 2 bytes, so a chain holds at most nc/2+2 tags.
    tags = tag_orbit(starts, nxt, nc // 2 + 2)  # int32[B, CAP] ascending
    # A tag never starts at the final byte (needs >= 2 bytes;
    # reference src/internal.jl:416).
    valid = (tags < clens_c - 1) & (tags >= starts[:, None])
    tags_c = jnp.minimum(tags, nc - 1)

    def tag_field(arr, fill=0):
        v = _take(arr, tags_c)
        return jnp.where(valid, v, fill)

    t_out_len = tag_field(t["out_len"])
    t_is_copy = tag_field(t["is_copy"].astype(jnp.int32)) > 0
    t_offset = tag_field(t["offset"])
    t_taglen = tag_field(t["taglen"])
    t_lit_len = tag_field(t["lit_len"])

    # --- pass 2: output offsets per tag.
    topos = exclusive_cumsum(t_out_len)
    total = jnp.sum(t_out_len, axis=-1)
    ulens_c = ulens[:, None]

    # --- corruption checks (reference src/internal.jl:493-518, Snappy.jl:50).
    bad_copy = (
        (t_offset == 0)
        | (topos < t_offset)
        | (topos + t_out_len > ulens_c)
        | (tags + 1 + t_taglen > clens_c)  # copy tag truncated by the stream end
    )
    bad_lit = (tags + 1 + t_taglen + t_lit_len > clens_c) | (topos + t_lit_len > ulens_c)
    bad = valid & jnp.where(t_is_copy, bad_copy, bad_lit)
    ok = jnp.logical_not(jnp.any(bad, axis=-1)) & (total == ulens)

    # --- materialize: each output byte finds its tag by binary search over
    # the tag output offsets (no scatter).
    big = jnp.int32(nu + nc + 32)
    topos_key = jnp.where(valid, topos, big)
    out_iota = jnp.arange(nu, dtype=jnp.int32)[None, :]
    tagidx = jax.vmap(lambda k, q: jnp.searchsorted(k, q, side="right"))(
        topos_key, jnp.broadcast_to(out_iota, (b, nu))
    ).astype(jnp.int32)
    tagidx = jnp.clip(tagidx - 1, 0, tags.shape[-1] - 1)

    o_tag = _take(tags_c, tagidx)  # input position of my tag
    o_opos = _take(topos, tagidx)
    o_iscopy = _take(t_is_copy.astype(jnp.int32), tagidx) > 0
    o_off = _take(t_offset, tagidx)
    o_litsrc = _take(tags_c + 1 + t_taglen, tagidx)
    delta = out_iota - o_opos

    lit_idx = jnp.clip(o_litsrc + delta, 0, nc + COMP_PAD - 1)
    comp_i32 = comp.astype(jnp.int32)
    lit_val = _take(comp_i32, lit_idx)
    src = jnp.where(o_iscopy, out_iota - o_off, out_iota)
    src = jnp.clip(src, 0, nu - 1)

    # --- resolve LZ back-reference chains to literal fixpoints
    # (gather-only pointer chasing; RLE-correct).
    def body(_, s):
        return _take(s, s)

    src_fix = jax.lax.fori_loop(0, ceil_log2(nu + 1), body, src)
    out = _take(lit_val, src_fix).astype(jnp.uint8)
    return out, ok, total


# Most blocks decoded in one vectorized step. The program's temporaries grow
# with the batch (about 1.8 MB per 64 KiB block on the CPU, 5 MB on the
# GPU), so larger batches run as a loop of steps of this many blocks and
# temporaries stay bounded whatever the stream size.
MAX_BATCH_BLOCKS = 64


def decode_blocks(comp_blocks: jnp.ndarray, clens: jnp.ndarray, ulens: jnp.ndarray, out_size: int):
    """Decode a batch of independent headerless block tag streams
    (the framed fast path; this axis is what shards across devices)."""
    b = comp_blocks.shape[0]
    if b <= MAX_BATCH_BLOCKS:
        return decode_blocks_impl(comp_blocks, clens, ulens, jnp.zeros_like(clens), out_size)
    steps = -(-b // MAX_BATCH_BLOCKS)
    pad = steps * MAX_BATCH_BLOCKS - b
    rows = [jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)) for x in (comp_blocks, clens, ulens)]
    rows = [x.reshape(steps, MAX_BATCH_BLOCKS, *x.shape[1:]) for x in rows]
    out, ok, total = jax.lax.map(lambda r: decode_blocks(*r, out_size), rows)
    return out.reshape(-1, out_size)[:b], ok.reshape(-1)[:b], total.reshape(-1)[:b]


def decode_padded(comp_padded: jnp.ndarray, clen, ulen, start, out_size: int):
    """Decode one raw tag stream (B=1 case of decode_blocks_impl)."""
    out, ok, total = decode_blocks_impl(
        comp_padded[None, :],
        jnp.asarray(clen, jnp.int32)[None],
        jnp.asarray(ulen, jnp.int32)[None],
        jnp.asarray(start, jnp.int32)[None],
        out_size,
    )
    return out[0], ok[0], total[0]


@functools.lru_cache(maxsize=64)
def decode_padded_jit(nc_padded: int, out_size: int):
    """jit-compiled decoder for a (compressed-bucket, output-bucket) pair."""

    @jax.jit
    def fn(comp_padded, clen, ulen, start):
        return decode_padded(comp_padded, clen, ulen, start, out_size)

    assert nc_padded >= COMP_PAD + 1
    return fn


@functools.lru_cache(maxsize=32)
def decode_blocks_jit(cmax_padded: int, out_size: int):
    @jax.jit
    def fn(comp_blocks, clens, ulens):
        return decode_blocks(comp_blocks, clens, ulens, out_size)

    return fn


# ---------------------------------------------------------------------------
# Windowed raw-stream fallback: bounded memory for arbitrarily large streams.
# ---------------------------------------------------------------------------

# Whole-stream decode above this compressed size would build orbit/searchsorted
# intermediates proportional to the stream (the B=1 arrays above); beyond it
# the host driver decodes fixed windows sequentially with carried output.
RAW_WHOLE_LIMIT = 4 << 20
WINDOW_C = 1 << 20  # compressed bytes scanned per window
WINDOW_U = (1 << 20) + (1 << 17)  # output bytes materialized per window


def _window_pass(comp_w: jnp.ndarray, wc, obase, window_u: int):
    """Decode one window of a raw tag stream (B=1, bounded shapes).

    comp_w: uint8[WINDOW_C + COMP_PAD] — the stream's bytes from the
    current tag position; wc: valid bytes of that slice; obase: absolute
    output position of the window's first tag. Decodes every tag that
    BOTH ends within the window and keeps cumulative output <= window_u.

    Returns (vals, srcs, hist, produced, consumed, ok):
      vals  int32[window_u]: literal bytes for in-window literal output
      srcs  int32[window_u]: ABSOLUTE source position after chasing the
            in-window copy chains; entries < obase point into already-
            materialized output (the host resolves them with one fancy
            index); entries >= obase are literal self-fixpoints.
      hist  bool[window_u]: srcs points into history
      produced, consumed: bytes of output / input this window covers
      ok: corruption flag for the decoded prefix
    """
    nc = WINDOW_C
    comp2 = comp_w[None, :]
    pos = jnp.arange(nc, dtype=jnp.int32)[None, :]
    t = parse_all_positions(comp2, nc + window_u + 16)

    nxt = jnp.minimum(pos + t["consumed"], nc)
    tags = tag_orbit(jnp.zeros(1, jnp.int32), nxt, nc // 2 + 2)
    tags_c = jnp.minimum(tags, nc - 1)

    def tf(arr, fill=0):
        return jnp.where(tags < nc, _take(arr, tags_c), fill)

    t_out = tf(t["out_len"])
    t_cons = tf(t["consumed"])
    t_copy = tf(t["is_copy"].astype(jnp.int32)) > 0
    t_off = tf(t["offset"])
    t_taglen = tf(t["taglen"])
    t_lit = tf(t["lit_len"])

    # keep tags fully inside [0, wc) whose cumulative output fits window_u
    topos = exclusive_cumsum(t_out)
    keep = (tags + t_cons <= wc) & (tags < wc - 1) & (topos + t_out <= window_u)
    # the kept set must be a prefix of the chain: cummin of keep
    keep = jnp.cumprod(keep.astype(jnp.int32), axis=-1) > 0
    produced = jnp.sum(jnp.where(keep, t_out, 0), axis=-1)[0]
    consumed = jnp.max(jnp.where(keep, tags + t_cons, 0), axis=-1)[0]

    # corruption checks on the kept prefix (absolute output coordinates)
    abs_topos = topos + obase
    bad_copy = (t_off == 0) | (abs_topos < t_off)
    bad_lit = tags + 1 + t_taglen + t_lit > wc
    bad = keep & jnp.where(t_copy, bad_copy, bad_lit)
    ok = jnp.logical_not(jnp.any(bad, axis=-1))[0]

    # materialize window output positions
    big = jnp.int32(window_u + nc + 32)
    key = jnp.where(keep, topos, big)
    oi = jnp.arange(window_u, dtype=jnp.int32)[None, :]
    tagidx = jax.vmap(lambda k, q: jnp.searchsorted(k, q, side="right"))(key, oi).astype(jnp.int32)
    tagidx = jnp.clip(tagidx - 1, 0, tags.shape[-1] - 1)
    o_opos = _take(topos, tagidx)
    o_copy = _take(t_copy.astype(jnp.int32), tagidx) > 0
    o_off = _take(t_off, tagidx)
    o_litsrc = _take(tags_c + 1 + t_taglen, tagidx)
    delta = oi - o_opos
    lit_idx = jnp.clip(o_litsrc + delta, 0, nc + COMP_PAD - 1)
    vals = _take(comp2.astype(jnp.int32), lit_idx)

    # absolute source positions; in-window chase with history absorbing
    src = jnp.where(o_copy, oi + obase - o_off, oi + obase)

    def body(_, s):
        rel = s - obase
        hist = rel < 0
        chased = _take(s, jnp.clip(rel, 0, window_u - 1))
        return jnp.where(hist, s, chased)

    src_fix = jax.lax.fori_loop(0, ceil_log2(window_u + 1), body, src)
    hist = src_fix < obase
    return vals[0], src_fix[0], hist[0], produced, consumed, ok


@functools.lru_cache(maxsize=2)
def _window_pass_jit(window_u: int):
    return jax.jit(functools.partial(_window_pass, window_u=window_u))


def decode_raw_windowed(comp, ulen: int, start: int) -> bytes:
    """Sequential windowed decode of one raw stream with bounded memory.

    The whole-stream program above builds O(stream) orbit/searchsorted
    intermediates — fine to ~RAW_WHOLE_LIMIT, ruinous at hundreds of MB.
    This driver scans WINDOW_C-byte windows of the tag stream, carries the
    materialized output (copies may reference arbitrarily far back:
    reference src/internal.jl:28-30), and handles the one tag shape a
    window cannot (a literal whose body exceeds the window) as a direct
    host copy. Memory: O(WINDOW_C + WINDOW_U + ulen).
    """
    import numpy as np

    from ..core.errors import CorruptInputError

    comp = np.asarray(comp, np.uint8)
    out = np.empty(ulen, np.uint8)
    fn = _window_pass_jit(WINDOW_U)
    p, o = start, 0
    clen = len(comp)
    while p < clen and o < ulen:
        wc = min(WINDOW_C, clen - p)
        win = np.zeros(WINDOW_C + COMP_PAD, np.uint8)
        win[:wc] = comp[p : p + wc]
        vals, srcs, hist, produced, consumed, ok = fn(
            jnp.asarray(win), jnp.int32(wc), jnp.int32(o)
        )
        produced = int(produced)
        consumed = int(consumed)
        if not bool(ok):
            raise CorruptInputError("corrupt snappy stream")
        if consumed == 0 or produced == 0:
            # No tag fit the window: either a giant literal (stream its
            # body host-side) or corruption.
            c = int(comp[p])
            if (c & 3) != 0:
                raise CorruptInputError("corrupt snappy stream")
            extra = max((c >> 2) - 59, 0)
            if extra == 0 or p + 1 + extra > clen:
                raise CorruptInputError("corrupt snappy stream")
            lit = int.from_bytes(comp[p + 1 : p + 1 + extra].tobytes(), "little") + 1
            body = p + 1 + extra
            if body + lit > clen or o + lit > ulen:
                raise CorruptInputError("corrupt snappy stream")
            out[o : o + lit] = comp[body : body + lit]
            p = body + lit
            o += lit
            continue
        if o + produced > ulen:
            raise CorruptInputError("corrupt snappy stream")
        vals = np.asarray(vals)
        srcs = np.asarray(srcs)[:produced]
        hist = np.asarray(hist)[:produced]
        # history entries index finalized output; in-window entries resolve
        # to the literal byte at their chased fixpoint position
        hidx = np.clip(srcs, 0, max(o - 1, 0))
        widx = np.clip(srcs - o, 0, WINDOW_U - 1)
        winout = np.where(hist, out[hidx], vals[widx]).astype(np.uint8)
        out[o : o + produced] = winout
        p += consumed
        o += produced
    if o != ulen or p != clen:
        raise CorruptInputError("corrupt snappy stream")
    return out.tobytes()
