"""The plain reference's occurrence scan, shared by its searches.

It reads the database's codes and the query's pattern strings, as the
harness made them, and works out everything else itself.  It imports
torch and numpy only, nothing of the program under test.  Ends are
exclusive (one past the last matched position) and pattern ids 1-based
in the suite's order: forward patterns 1..n, their reverse complements
n+1..2n.  The occurrence scan runs on whichever device the codes tensor
is on (the card in a benchmark run, the CPU in the tests).
"""

from __future__ import annotations

import numpy as np
import torch

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def reverse_complement(s: str) -> str:
    return "".join(COMPLEMENT[c] for c in reversed(s))


def pattern_codes(pats, table: bytes, fold=None) -> list[np.ndarray]:
    """Each pattern string as codes of ``table`` (``fold`` maps a code to
    the code it is searched as, e.g. I to L)."""
    c2c = {chr(b): i for i, b in enumerate(table)}
    out = []
    for p in pats:
        a = np.fromiter((c2c[ch] for ch in p), np.int64, len(p))
        out.append(fold[a] if fold is not None else a)
    return out


# the most window starts a block of the occurrence scan holds: its int64
# keys and their temporaries take about 33 bytes a position on the device
# (8.9 GB a block on an H100), so the reference's peak is bounded by the
# block and the codes, not by the database
BLOCK = 1 << 28


def _window_keys(block: torch.Tensor, n: int, width: int,
                 bits: int) -> torch.Tensor:
    """int64 key of the ``width`` codes starting at each of the first
    ``n`` positions of ``block`` (which holds ``n + width - 1`` codes),
    the first code in the highest bits."""
    c = block.to(torch.int64)
    key = torch.zeros(n, dtype=torch.int64, device=block.device)
    for j in range(width):
        key = (key << bits) | c[j:j + n]
    return key


def _blocks(codes_t: torch.Tensor, width: int, eos: int, fold=None):
    """(first position, windows, codes) of each block of at most
    ``BLOCK`` window starts: the block's codes and a right halo of
    ``width - 1``, ``eos`` past the end of the text, each code mapped by
    ``fold`` (code -> code searched as) where given."""
    n = codes_t.shape[0]
    lut = None if fold is None else torch.as_tensor(
        fold, dtype=torch.uint8, device=codes_t.device)
    for b0 in range(0, n, BLOCK):
        m = min(BLOCK, n - b0)
        block = codes_t[b0:b0 + m + width - 1]
        short = m + width - 1 - block.shape[0]
        if short:
            block = torch.cat([block, torch.full(
                (short,), eos, dtype=block.dtype, device=block.device)])
        if lut is not None:
            block = lut[block.to(torch.int64)]
        yield b0, m, block


def occurrences(codes_t: torch.Tensor, codes_np: np.ndarray,
                pats: list[np.ndarray], alpha: int, eos: int, fold=None):
    """(ends, pattern index) of every exact occurrence of each code
    pattern in the text: int64 arrays, in no order.

    Windows are compared by an exact int64 key of up to ``63 // bits``
    codes; a longer pattern matches on that prefix and has its rest
    compared on the host.  ``eos`` (never in a pattern) pads the text, so
    no occurrence runs past the end or across an end of sequence.  The
    text is scanned in blocks of at most ``BLOCK`` window starts, each
    with the halo its windows read; a window belongs to the block that
    holds its start.  ``fold`` maps each text code to the code it is
    searched as (the patterns come folded already)."""
    if not pats:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bits = max(1, int(alpha - 1).bit_length())
    lengths = np.array([len(p) for p in pats])
    width = int(min(63 // bits, lengths.max()))
    groups = []
    for L in np.unique(lengths):
        L = int(L)
        idx = np.flatnonzero(lengths == L)
        w = min(L, width)
        pk = np.array([int(sum(int(c) << (bits * (w - 1 - j))
                               for j, c in enumerate(pats[i][:w])))
                       for i in idx], np.int64)
        uniq, inv = np.unique(pk, return_inverse=True)
        groups.append((L, idx, w, uniq, inv))
    ends_out, pid_out = [], []
    for b0, m, block in _blocks(codes_t, width, eos, fold):
        key = _window_keys(block, m, width, bits)
        for L, idx, w, uniq, inv in groups:
            s_rep, p_rep = _matches(key, width, w, bits, uniq, inv, idx)
            s_rep += b0
            if L > width:
                rest = np.stack([pats[i][width:] for i in p_rep]) \
                    if len(p_rep) else np.zeros((0, L - width), np.int64)
                text = gather(codes_np, s_rep + width, L - width, eos)
                if fold is not None:
                    text = fold[text]
                ok = (text == rest).all(axis=1)
                s_rep, p_rep = s_rep[ok], p_rep[ok]
            ends_out.append(s_rep + L)
            pid_out.append(p_rep)
        del key
    return np.concatenate(ends_out), np.concatenate(pid_out)


def _matches(key, width: int, w: int, bits: int, uniq, inv, idx):
    """(starts in the block, pattern index) of the windows whose first
    ``w`` codes are a pattern's key: every pattern of one length."""
    kl = key >> (bits * (width - w)) if w < width else key
    u = torch.as_tensor(uniq, device=key.device)
    pos = torch.searchsorted(u, kl).clamp_(max=len(uniq) - 1)
    hit = u[pos] == kl
    starts = torch.nonzero(hit).flatten()
    slot = pos[starts].cpu().numpy()
    starts = starts.cpu().numpy().astype(np.int64)
    del kl, pos, hit
    # every pattern of this length whose key is the window's
    order = np.argsort(inv, kind="stable")
    first = np.searchsorted(inv[order], np.arange(len(uniq)))
    count = np.bincount(inv, minlength=len(uniq))
    reps = count[slot]
    s_rep = np.repeat(starts, reps)
    within = np.arange(len(s_rep)) - np.repeat(np.cumsum(reps) - reps,
                                               reps)
    p_rep = idx[order[np.repeat(first[slot], reps) + within]]
    return s_rep, p_rep


def rows(ends, pids, edits) -> np.ndarray:
    out = np.stack([np.asarray(ends, np.int64), np.asarray(pids, np.int64),
                    np.asarray(edits, np.int64)], axis=1) \
        if len(ends) else np.zeros((0, 3), np.int64)
    return out[np.lexsort((out[:, 2], out[:, 1], out[:, 0]))]


def gather(codes_np: np.ndarray, starts: np.ndarray, width: int,
            eos: int) -> np.ndarray:
    """[C, width] codes from each start, ``eos`` past either end."""
    pos = starts[:, None] + np.arange(width)
    inside = (pos >= 0) & (pos < len(codes_np))
    return np.where(inside, codes_np[np.clip(pos, 0, len(codes_np) - 1)],
                    eos).astype(np.int64)
