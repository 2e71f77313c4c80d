"""JAX spaced-seed ntHash kernels (device-side, position-parallel).

The reference computes hashes with a sequential rolling iterator per seed
(multiLensfrHashIterator.hpp + btllib SeedNtHash, driven by a 6-thread host
producer pool, read_hashing.cpp:78-117).  A rolling recurrence is the wrong
shape for a data-parallel device; instead we use an algebraic identity
that makes every
position independent:

  fwd(p) = XOR_{j in care} rol64(TAB[s[p+j]], span-1-j)
         = rol64( XOR_{j in care} ror64(TAB[s[p+j]], (p+j) mod 64),
                  (span-1+p) mod 64 )

i.e. per-base values U[i] = ror64(TAB[s[i]], i mod 64) are position-local
(one small-table gather per base), the inner XOR is a spaced correlation
computed from statically-shifted slices, and the per-position rotation is a
single vectorized rotate.  The reverse-strand hash factors the same way with
U'[i] = rol64(TABC[s[i]], i mod 64) and rotation (-p) mod 64.  The
multi-length seed family (left + i*'0' + right) lets all seeds share the two
half-correlations: V_s[p] = VL[p] ^ VR[p + half + s].

Output parity is tested against the NumPy oracle (ops/nthash_np.py), which in
turn mirrors the reference iterator semantics.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .nthash_np import NT_TAB, NT_TABC


def _ror64_np(x: np.ndarray, r: int) -> np.ndarray:
    r %= 64
    if r == 0:
        return x.astype(np.uint64)
    with np.errstate(over="ignore"):
        return ((x >> np.uint64(r)) | (x << np.uint64(64 - r))).astype(np.uint64)


def _rol64_np(x: np.ndarray, r: int) -> np.ndarray:
    return _ror64_np(x, (64 - r) % 64)


@dataclasses.dataclass(frozen=True)
class SeedFamily:
    """Precomputed device tables for one multi-length seed family."""

    seeds: tuple[str, ...]
    half: int                      # length of the shared left half
    spans: tuple[int, ...]         # span of each seed (k, k+1, ..)
    care_left: tuple[int, ...]     # care offsets within the left half
    care_right: tuple[int, ...]    # care offsets relative to right-half start
    # constant tables derived from `seeds`; excluded from eq/hash so the
    # dataclass stays usable as a jit static argument
    rot_f: np.ndarray = dataclasses.field(repr=False, compare=False)
    rot_r: np.ndarray = dataclasses.field(repr=False, compare=False)

    @property
    def h(self) -> int:
        return len(self.seeds)

    @property
    def k(self) -> int:
        return self.spans[0]

    @property
    def pad_needed(self) -> int:
        """Extra positions beyond P frames that the correlations read."""
        mx = max(self.care_right, default=0)
        return self.half + (self.h - 1) + mx + 1


def build_seed_family(seeds: list[str]) -> SeedFamily:
    left = seeds[0][: len(seeds[0]) // 2]
    right = seeds[0][len(left):]
    for i, s in enumerate(seeds):
        assert s == left + "0" * i + right, (
            "seed list is not a left+zeros+right family from make_seed_pattern")
    care_left = tuple(j for j, c in enumerate(left) if c == "1")
    care_right = tuple(j for j, c in enumerate(right) if c == "1")
    rot_f = np.zeros((64, 4), dtype=np.uint64)
    rot_r = np.zeros((64, 4), dtype=np.uint64)
    for r in range(64):
        rot_f[r] = _ror64_np(NT_TAB, r)
        rot_r[r] = _rol64_np(NT_TABC, r)
    # tables stay numpy: they become jit-time constants wherever used, so a
    # family may safely be constructed (or lru-cached) inside a trace
    return SeedFamily(
        seeds=tuple(seeds),
        half=len(left),
        spans=tuple(len(s) for s in seeds),
        care_left=care_left,
        care_right=care_right,
        rot_f=rot_f.reshape(-1),
        rot_r=rot_r.reshape(-1),
    )


def _rol64_var(x: jax.Array, r: jax.Array) -> jax.Array:
    """Vectorized uint64 rotate-left by per-element amounts in [0, 64)."""
    r = r.astype(jnp.uint64)
    shifted = (x << r) | (x >> (jnp.uint64(64) - r))
    return jnp.where(r == 0, x, shifted)


def _rol64_pair(hi: jax.Array, lo: jax.Array, r: jax.Array):
    """Rotate-left of a (hi, lo) uint32 pair by per-element r in [0, 64).

    Explicit 32-bit formulation: a few u32 selects/shifts in place of
    XLA's emulated uint64 variable shifts."""
    r = r.astype(jnp.uint32)
    r32 = r & 31
    big = (r & 32) != 0
    inv = (jnp.uint32(32) - r32) & 31
    h1 = jnp.where(r32 == 0, hi, (hi << r32) | (lo >> inv))
    l1 = jnp.where(r32 == 0, lo, (lo << r32) | (hi >> inv))
    return jnp.where(big, l1, h1), jnp.where(big, h1, l1)


def _min64_pair(ah, al, bh, bl):
    a_lt = (ah < bh) | ((ah == bh) & (al < bl))
    return jnp.where(a_lt, ah, bh), jnp.where(a_lt, al, bl)


@partial(jax.jit, static_argnames=("fam", "num_frames", "stride"))
def hash_positions(codes: jax.Array, fam: SeedFamily, num_frames: int,
                   stride: int = 1) -> jax.Array:
    """Canonical hashes for every position of a padded batch of sequences.

    codes: uint8/int32 [B, L] base codes 0..3 (padding may be any value in
    0..3; caller masks invalid frames).  Returns uint64 [B, h, num_frames]
    where entry [b, s, p] is the canonical spaced-seed hash of
    codes[b, p : p+span_s].  Frames past a read's valid range contain garbage
    the caller must mask/clamp (see mibf.query).

    With stride S > 1 only positions 0, S, 2S, ... are computed (returns
    [B, h, num_frames // S]) — the sampled-query fast path: the correlation
    and rotation work drops by ~S while staying bit-identical to the dense
    hashes at those positions.  Use hash_at for the data-dependent per-tile
    clamp positions the sampled grid also needs.

    Internals run on explicit (hi, lo) uint32 pairs — u64 exists only at the
    table-gather and final assembly, sidestepping XLA's emulated u64
    variable shifts.
    """
    B, L = codes.shape
    need = num_frames + fam.pad_needed
    if L < need:
        codes = jnp.pad(codes, ((0, 0), (0, need - L)))
        L = need
    codes = codes.astype(jnp.int32)
    # Per-base rotated constants along the position axis: ROT[b][i] is a
    # function of (b, i mod 64) only, so build [4, L] constant rows once and
    # select by the 2 base bits — three elementwise selects instead of a
    # small-table gather.
    pos_np = np.arange(L)
    rowf = jnp.asarray(fam.rot_f.reshape(64, 4).T[:, pos_np % 64])  # [4,L] u64
    rowr = jnp.asarray(fam.rot_r.reshape(64, 4).T[:, pos_np % 64])

    def split(x):
        return (x >> jnp.uint64(32)).astype(jnp.uint32), \
               (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)

    b0 = (codes & 1) == 1
    b1 = (codes & 2) == 2

    def sel(rows):
        hi_rows, lo_rows = split(rows)          # [4, L] u32 each
        lo_pair = jnp.where(b0, lo_rows[1][None, :], lo_rows[0][None, :])
        lo_pair2 = jnp.where(b0, lo_rows[3][None, :], lo_rows[2][None, :])
        lo = jnp.where(b1, lo_pair2, lo_pair)
        hi_pair = jnp.where(b0, hi_rows[1][None, :], hi_rows[0][None, :])
        hi_pair2 = jnp.where(b0, hi_rows[3][None, :], hi_rows[2][None, :])
        hi = jnp.where(b1, hi_pair2, hi_pair)
        return hi, lo

    uf_hi, uf_lo = sel(rowf)
    ur_hi, ur_lo = sel(rowr)

    def corr(hi, lo, offsets, width):
        ah = jnp.zeros((B, width), dtype=jnp.uint32)
        al = jnp.zeros((B, width), dtype=jnp.uint32)
        for c in offsets:
            ah = ah ^ jax.lax.dynamic_slice_in_dim(hi, c, width, axis=1)
            al = al ^ jax.lax.dynamic_slice_in_dim(lo, c, width, axis=1)
        return ah, al

    P = num_frames
    if stride > 1:
        if P % stride:
            raise ValueError("num_frames must be a multiple of stride")
        Q = P // stride

        def corr_s(hi, lo, offsets, base):
            # out[q] = XOR_c x[base + q*stride + c]; base/c static -> static
            # strided slices
            ah = jnp.zeros((B, Q), dtype=jnp.uint32)
            al = jnp.zeros((B, Q), dtype=jnp.uint32)
            for c in offsets:
                s0 = base + c
                end = s0 + (Q - 1) * stride + 1
                ah = ah ^ hi[:, s0:end:stride]
                al = al ^ lo[:, s0:end:stride]
            return ah, al

        q_pos = jnp.arange(Q, dtype=jnp.int32) * stride
        vlh, vll = corr_s(uf_hi, uf_lo, fam.care_left, 0)
        wlh, wll = corr_s(ur_hi, ur_lo, fam.care_left, 0)
        outs = []
        for s in range(fam.h):
            off = fam.half + s
            vrh, vrl = corr_s(uf_hi, uf_lo, fam.care_right, off)
            wrh, wrl = corr_s(ur_hi, ur_lo, fam.care_right, off)
            fh, fl = _rol64_pair(vlh ^ vrh, vll ^ vrl,
                                 (fam.spans[s] - 1 + q_pos) % 64)
            rh, rl = _rol64_pair(wlh ^ wrh, wll ^ wrl,
                                 (64 - q_pos % 64) % 64)
            mh, ml = _min64_pair(fh, fl, rh, rl)
            outs.append((mh.astype(jnp.uint64) << jnp.uint64(32))
                        | ml.astype(jnp.uint64))
        return jnp.stack(outs, axis=1)    # [B, h, Q]

    span_extra = fam.half + (fam.h - 1)   # widest right-half start offset
    vlh, vll = corr(uf_hi, uf_lo, fam.care_left, P)
    vrh, vrl = corr(uf_hi, uf_lo, fam.care_right, P + span_extra)
    wlh, wll = corr(ur_hi, ur_lo, fam.care_left, P)
    wrh, wrl = corr(ur_hi, ur_lo, fam.care_right, P + span_extra)

    p_idx = jnp.arange(P, dtype=jnp.int32)
    outs = []
    for s in range(fam.h):
        off = fam.half + s
        sl = partial(jax.lax.dynamic_slice_in_dim, start_index=off,
                     slice_size=P, axis=1)
        vh, vl_ = vlh ^ sl(vrh), vll ^ sl(vrl)
        wh, wl_ = wlh ^ sl(wrh), wll ^ sl(wrl)
        fh, fl = _rol64_pair(vh, vl_, (fam.spans[s] - 1 + p_idx) % 64)
        rh, rl = _rol64_pair(wh, wl_, (64 - p_idx % 64) % 64)
        mh, ml = _min64_pair(fh, fl, rh, rl)
        outs.append((mh.astype(jnp.uint64) << jnp.uint64(32))
                    | ml.astype(jnp.uint64))
    return jnp.stack(outs, axis=1)    # [B, h, P]


def _prep_u(codes: jax.Array, fam: SeedFamily):
    """Per-base rotated constants for both strands as (hi, lo) u32 pairs."""
    _, L = codes.shape
    codes = codes.astype(jnp.int32)
    pos_np = np.arange(L)
    rowf = jnp.asarray(fam.rot_f.reshape(64, 4).T[:, pos_np % 64])
    rowr = jnp.asarray(fam.rot_r.reshape(64, 4).T[:, pos_np % 64])

    def split(x):
        return (x >> jnp.uint64(32)).astype(jnp.uint32), \
               (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)

    b0 = (codes & 1) == 1
    b1 = (codes & 2) == 2

    def sel(rows):
        hi_rows, lo_rows = split(rows)
        lo = jnp.where(b1, jnp.where(b0, lo_rows[3], lo_rows[2]),
                       jnp.where(b0, lo_rows[1], lo_rows[0]))
        hi = jnp.where(b1, jnp.where(b0, hi_rows[3], hi_rows[2]),
                       jnp.where(b0, hi_rows[1], hi_rows[0]))
        return hi, lo

    return sel(rowf) + sel(rowr)    # (uf_hi, uf_lo, ur_hi, ur_lo)


def _hash_at_prepped(u, fam: SeedFamily, pos: jax.Array, L_valid: int
                     ) -> jax.Array:
    uf_hi, uf_lo, ur_hi, ur_lo = u
    B = uf_hi.shape[0]
    _, h, N = pos.shape
    assert h == fam.h
    pos = jnp.clip(pos, 0, L_valid - 1).astype(jnp.int32)
    flat = pos.reshape(B, h * N)
    # per-seed right-half start offset folded into the gather index
    s_off = jnp.repeat(jnp.arange(fam.h, dtype=jnp.int32) + fam.half, N)

    def corr_at(hi, lo, offsets, base):
        ah = jnp.zeros((B, h * N), dtype=jnp.uint32)
        al = jnp.zeros((B, h * N), dtype=jnp.uint32)
        for c in offsets:
            idx = flat + (base + c)
            ah = ah ^ jnp.take_along_axis(hi, idx, axis=1)
            al = al ^ jnp.take_along_axis(lo, idx, axis=1)
        return ah, al

    zero = jnp.zeros((h * N,), dtype=jnp.int32)
    vlh, vll = corr_at(uf_hi, uf_lo, fam.care_left, zero)
    vrh, vrl = corr_at(uf_hi, uf_lo, fam.care_right, s_off)
    wlh, wll = corr_at(ur_hi, ur_lo, fam.care_left, zero)
    wrh, wrl = corr_at(ur_hi, ur_lo, fam.care_right, s_off)
    spans = jnp.repeat(jnp.asarray(fam.spans, dtype=jnp.int32), N)
    fh, fl = _rol64_pair(vlh ^ vrh, vll ^ vrl, (spans - 1 + flat) % 64)
    rh, rl = _rol64_pair(wlh ^ wrh, wll ^ wrl, (64 - flat % 64) % 64)
    mh, ml = _min64_pair(fh, fl, rh, rl)
    out = (mh.astype(jnp.uint64) << jnp.uint64(32)) | ml.astype(jnp.uint64)
    return out.reshape(B, h, N)


@partial(jax.jit, static_argnames=("fam",))
def hash_at(codes: jax.Array, fam: SeedFamily, pos: jax.Array) -> jax.Array:
    """Canonical hashes at arbitrary per-seed positions.

    codes: [B, L] base codes; pos: int32 [B, h, N] frame positions (seed s
    row holds positions for seed s).  Returns uint64 [B, h, N], bit-identical
    to hash_positions(...)[b, s, pos[b, s, n]].  Point-gather evaluation —
    meant for small N (e.g. the per-tile clamp frames of the sampled grid).
    """
    B, L = codes.shape
    u = _prep_u(jnp.pad(codes, ((0, 0), (0, fam.pad_needed))), fam)
    return _hash_at_prepped(u, fam, pos, L)


@partial(jax.jit, static_argnames=("fam", "num_frames", "stride"))
def hash_sampled(codes: jax.Array, fam: SeedFamily, num_frames: int,
                 stride: int, clamp_pos: jax.Array
                 ) -> tuple[jax.Array, jax.Array]:
    """Strided hashes + clamp-point hashes sharing one per-base table pass.

    Equivalent to (hash_positions(codes, fam, num_frames, stride),
    hash_at(codes, fam, clamp_pos)) but computes the [B, L] per-base rotated
    constants once — the point evaluation otherwise re-pays the whole-read
    table pass, which dominates its cost for small N.
    """
    B, L = codes.shape
    if num_frames % stride:
        raise ValueError("num_frames must be a multiple of stride")
    need = num_frames + fam.pad_needed
    if L < need:
        codes = jnp.pad(codes, ((0, 0), (0, need - L)))
        L = need
    u = _prep_u(codes, fam)
    uf_hi, uf_lo, ur_hi, ur_lo = u
    Q = num_frames // stride

    def corr_s(hi, lo, offsets, base):
        ah = jnp.zeros((B, Q), dtype=jnp.uint32)
        al = jnp.zeros((B, Q), dtype=jnp.uint32)
        for c in offsets:
            s0 = base + c
            end = s0 + (Q - 1) * stride + 1
            ah = ah ^ hi[:, s0:end:stride]
            al = al ^ lo[:, s0:end:stride]
        return ah, al

    q_pos = jnp.arange(Q, dtype=jnp.int32) * stride
    vlh, vll = corr_s(uf_hi, uf_lo, fam.care_left, 0)
    wlh, wll = corr_s(ur_hi, ur_lo, fam.care_left, 0)
    outs = []
    for s in range(fam.h):
        off = fam.half + s
        vrh, vrl = corr_s(uf_hi, uf_lo, fam.care_right, off)
        wrh, wrl = corr_s(ur_hi, ur_lo, fam.care_right, off)
        fh, fl = _rol64_pair(vlh ^ vrh, vll ^ vrl,
                             (fam.spans[s] - 1 + q_pos) % 64)
        rh, rl = _rol64_pair(wlh ^ wrh, wll ^ wrl,
                             (64 - q_pos % 64) % 64)
        mh, ml = _min64_pair(fh, fl, rh, rl)
        outs.append((mh.astype(jnp.uint64) << jnp.uint64(32))
                    | ml.astype(jnp.uint64))
    h_strided = jnp.stack(outs, axis=1)
    h_clamp = _hash_at_prepped(u, fam, clamp_pos,
                               L - fam.pad_needed)
    return h_strided, h_clamp
