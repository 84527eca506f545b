"""Rolling mer-hash framework (reference ``hash.h``/``hash.cc``).

Vectorized emulation of the reference's ``contigshift`` and
``shiftspaced`` hashes, used by the allvall family and ``pairscan``.
Instead of a per-character virtual-call loop, the whole code array is
hashed in one numpy pass: the 64-bit shift register
``h0[p] = OR_j codes[p-j] << 2j`` is materialized for every position,
then the template's mask/shift folds compact the sampled groups
(``shiftspaced::update``, ``hash.cc``).

Faithful quirk notes (all deterministic in the reference on x86):

* ``update`` ORs the raw producer code into the register without any
  alphabet check — EOS/N codes >= 4 bleed into neighbouring 2-bit
  slots (``hash.cc`` shiftspaced::update).
* Templates are truncated to 64 positions (``tobv64``); a gap pushing
  the second 1-run past bit 63 silently drops sampled positions.
* ``mask64`` and the fold shifts use x86 shift-count semantics
  (count mod 64) when a long template's bit positions exceed 63.
* ``hash_t`` is uint32 — every fold result truncates to 32 bits, and
  ``1 << (4*mersize)`` wraps mod 32 for the table size.

The port's copy of ``sequence_alignment_tools_tpu/ops/merhash.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
MASK64 = (1 << 64) - 1


def template_params(tstr: str, asize: int = 4):
    """(runs, weight, span) from the 64-bit-truncated template
    (bits.cc tobv64/runs; trailing zero-runs are dropped)."""
    templ = 0
    for i, ch in enumerate(tstr[:64]):
        if ch == "1":
            templ |= 1 << i
    bounds = [i for i in range(1, 64)
              if ((templ >> (i - 1)) & 1) != ((templ >> i) & 1)]
    if bounds:
        if (templ >> bounds[-1]) & 1:
            bounds.append(64)
    elif templ & 1:
        # contiguous all-ones template (hashselect's contigshift path)
        bounds = [min(len(tstr), 64)]
    runs = [bounds[0]] + [bounds[i] - bounds[i - 1]
                          for i in range(1, len(bounds))]
    weight = bin(templ).count("1")
    span = max(i + 1 for i in range(64) if (templ >> i) & 1) if templ else 0
    return runs, weight, span


def _mask64(st: int, ed: int) -> int:
    """bits.cc mask64 with x86 shift-count wrap for out-of-range bits."""
    return (((1 << (ed % 64)) - 1) - ((1 << (st % 64)) - 1)) & MASK64


def fold_params(tstr: str, asize: int = 4):
    """(masks, shifts) of the shiftspaced fold (hash.cc ctor)."""
    a = max(1, (asize - 1).bit_length())
    runs, weight, span = template_params(tstr, asize)
    nrun = len(runs)
    pos = [0] * nrun
    pos[nrun - 1] = runs[nrun - 1]
    for i in range(nrun - 2, -1, -1):
        pos[i] = runs[i] + pos[i + 1]
    nshift = (nrun + 1) // 2
    masks = [((1 << ((pos[nrun - 1] * a) % 64)) - 1) & MASK64]
    shifts = [0]
    for i in range(1, nshift):
        masks.append(_mask64(pos[nrun - 1 - (2 * i - 1)] * a,
                             pos[nrun - 1 - (2 * i)] * a))
        shifts.append(runs[nrun - 1 - (2 * i - 1)] * a + shifts[i - 1])
    return masks, shifts, weight, span, a


def hash_values(codes: np.ndarray, tstr: str, asize: int = 4) -> tuple[
        np.ndarray, np.ndarray, int, int]:
    """(values, rcvalues, weight, span) for every window end position.

    ``values[p]`` is the hash after consuming ``codes[p]`` — valid full
    windows start at ``p = span-1`` (``reset()`` pre-feeds span-1 chars,
    hash.cc shiftspaced::reset); earlier entries reflect the zero-filled
    warm-up exactly as a fresh register would.
    """
    masks, shifts, weight, span, a = fold_params(tstr, asize)
    n = len(codes)
    c = codes.astype(U64)
    h0 = np.zeros(n, dtype=U64)
    # register holds 64/a chars of history
    for j in range(min(64 // a, n)):
        if j == 0:
            h0 |= c
        else:
            h0[j:] |= c[:n - j] << U64(a * j)
    h = np.zeros(n, dtype=U64)
    for m, s in zip(masks, shifts):
        h |= (h0 & U64(m)) >> U64(s % 64)
    h &= U64(0xFFFFFFFF)  # hash_t truncation
    return h.astype(np.uint32), rc32(h.astype(np.uint32), weight), \
        weight, span


def rc32(h: np.ndarray, weight: int) -> np.ndarray:
    """bits.cc rc(uint32, w): reverse 2-bit groups, complement, shift."""
    y = h.astype(np.uint32)
    y = ((y >> np.uint32(2)) & np.uint32(0x33333333)) \
        | ((y << np.uint32(2)) & np.uint32(0xCCCCCCCC))
    y = ((y >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) \
        | ((y << np.uint32(4)) & np.uint32(0xF0F0F0F0))
    y = ((y >> np.uint32(8)) & np.uint32(0x00FF00FF)) \
        | ((y << np.uint32(8)) & np.uint32(0xFF00FF00))
    y = ((y >> np.uint32(16)) & np.uint32(0x0000FFFF)) \
        | ((y << np.uint32(16)) & np.uint32(0xFFFF0000))
    y ^= np.uint32(0xFFFFFFFF)
    sh = 32 - weight * 2
    if sh > 0:
        y >>= np.uint32(sh)
    return y
