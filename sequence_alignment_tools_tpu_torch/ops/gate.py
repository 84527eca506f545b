"""The seed-extension gate of the pigeonhole (k > 0) engines.

Port of ``sequence_alignment_tools_tpu/ops/gate.py``.  For each seed hit
(anchor = seed end position, sid = seed index) the gate decides whether
the extension COULD succeed:

    gate(c) = [ min banded edit distance of the extension pattern
                anchored at the seed hit <= k ]   (constraints/EOS ignored)

It is a superset filter of the exact extension (``engine/extend.py``;
proof in the JAX module's docstring): its accept set per pattern position
equals the extension's, and every cost it charges is at most the
extension's, so it can only add candidates.  The host re-extends the
survivors exactly, so engine output does not depend on it.

:func:`gate_ok_ref` is the plain PyTorch version of the JAX ``_gate_ok``,
edge rules included; the CUDA kernel ``cuda/csrc/seed_gate.cu`` runs the
same DP per seed hit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .tables import GATE_ALPHA


class GateTables:
    """Per-seed gate metadata (built once per engine run).

    ``bits[s, p]`` bit c: extension-pattern position p of seed s accepts
    text code c (for rmatch seeds the extension pattern is REVERSED so the
    DP walks the backward window forward); bit 30 is never set and is the
    sentinel that out-of-range window slots read.  ``glen[s]``: extension
    length.  ``dir_np[s]``: +1 lmatch (the window reads forward from the
    anchor) / -1 rmatch.  ``gdir[s]``: the direction with the seed offset
    folded in, +1 or -(1 + goff[s]); an rmatch window reads backward from
    ``anchor - goff - 1``, just left of the seed.  ``bits``, ``glen`` and
    ``gdir`` are int32 tensors on one device (:meth:`to` moves them)."""

    def __init__(self, accept: np.ndarray, glen: np.ndarray,
                 gdir: np.ndarray, goff: np.ndarray, k: int, band: int):
        S, Lg, alpha = accept.shape
        if alpha >= GATE_ALPHA:
            raise NotImplementedError(
                f"gate accept alphabet {alpha} exceeds the int32 bit pack")
        bits = np.zeros((S, Lg), np.int32)
        for c in range(alpha):
            bits |= accept[:, :, c].astype(np.int32) << c
        self.bits_np = bits
        self.glen_np = np.asarray(glen, np.int32)
        self.dir_np = np.asarray(gdir, np.int32)
        self.gdir_np = np.where(self.dir_np > 0, 1,
                                -(1 + np.asarray(goff))).astype(np.int32)
        self.Lg = Lg
        self.alpha = alpha
        self.k = k
        self.band = band
        self.bits = torch.from_numpy(self.bits_np)
        self.glen = torch.from_numpy(self.glen_np)
        self.gdir = torch.from_numpy(self.gdir_np)

    @property
    def device(self) -> torch.device:
        return self.bits.device

    def to(self, device) -> GateTables:
        """A copy whose tensors lie on ``device``."""
        out = object.__new__(GateTables)
        out.__dict__.update(self.__dict__)
        out.bits = self.bits.to(device)
        out.glen = self.glen.to(device)
        out.gdir = self.gdir.to(device)
        trace.count("upload.bytes", self.bits.nbytes + self.glen.nbytes
                    + self.gdir.nbytes)
        return out

    @classmethod
    def from_seed_meta(cls, db, ext_pats, dirs, offs, k: int, band: int,
                       wc: bool, textn: bool):
        """Accept tables from extension pattern STRINGS, with the true
        DP's accept test (equal, or IUPAC-compatible in wc mode with the
        text-N rule) over the database alphabet.  ``offs[s]`` is the
        matched seed's length for rmatch seeds (0 for lmatch)."""
        from ..utils.iupac import compat_matrix

        alpha = db.alphabet_size
        S = len(ext_pats)
        Lg = max((len(p) for p in ext_pats), default=1) or 1
        accept = np.zeros((S, Lg, alpha), dtype=bool)
        compat = compat_matrix() if wc else None
        chars = [db.ch(c) for c in range(alpha)]
        # the accept row of each distinct pattern character, built once
        # (the seed loop below then costs one row copy per position)
        rows: dict[str, np.ndarray] = {}

        def accept_row(pc: str) -> np.ndarray:
            row = rows.get(pc)
            if row is None:
                row = np.fromiter(
                    (tc == pc or bool(wc and compat[ord(tc), ord(pc)]
                                      and (textn or tc != "N"))
                     for tc in chars), bool, alpha)
                rows[pc] = row
            return row

        for s, pat in enumerate(ext_pats):
            p = pat if dirs[s] > 0 else pat[::-1]
            for j, pc in enumerate(p):
                accept[s, j] = accept_row(pc)
        glen = np.fromiter((len(p) for p in ext_pats), np.int32, S)
        return cls(accept, glen, np.asarray(dirs, np.int32),
                   np.asarray(offs, np.int32), k, band)


def gate_ok_ref(codes: torch.Tensor, anchors: torch.Tensor,
                sids: torch.Tensor, gt: GateTables, indels: bool,
                n: int) -> torch.Tensor:
    """ok [C] bool: the banded anchored edit distance of each candidate's
    extension pattern is <= k.  ``codes`` [>= n] uint8, ``anchors`` [C]
    and ``sids`` [C] integer tensors on ``gt``'s device.

    Edge rules (those of the JAX ``_gate_ok``): window slot j reads
    ``anchor + j`` (lmatch) or ``anchor + gdir - j`` (rmatch); slots
    outside [0, n) read the sentinel bit 30; an empty extension passes;
    with indels the first row is dp[0][t] = t and the leading-deletion
    column dp[p][0] = p; every value saturates at k + 1."""
    k, band, Lg = gt.k, gt.band, gt.Lg
    C = anchors.shape[0]
    dev = codes.device
    if C == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    Wg = Lg + band
    W = 2 * band + 1
    INF = k + 1
    sids = sids.long()
    j = torch.arange(Wg, device=dev)[None, :]
    dirc = gt.gdir[sids].long()[:, None]
    idx = anchors.long()[:, None] + torch.where(dirc > 0, j, dirc - j)
    inrange = (idx >= 0) & (idx < n)
    w = codes[idx.clamp(0, max(n - 1, 0))].long()
    w = torch.where(inrange, w, 30)
    bits_c = gt.bits[sids].long()  # [C, Lg]
    acc = ((bits_c[:, :, None] >> w[:, None, :]) & 1) > 0  # [C, Lg, Wg]
    glen_c = gt.glen[sids].long()
    res = torch.where(glen_c == 0, 0, INF)
    if indels:
        init = [min(d - band, INF) if d >= band else INF for d in range(W)]
    else:
        init = [0 if d == band else INF for d in range(W)]
    D = torch.tensor(init, dtype=torch.long, device=dev).expand(C, W)
    inf_col = torch.full((C,), INF, dtype=torch.long, device=dev)
    for p in range(1, Lg + 1):
        cols = []
        prev = None
        for d in range(W):
            tpos = p + d - band
            if tpos == 0 and indels and d + 1 < W:
                # leading-deletion column: dp[p][0] = p (text untouched)
                v = torch.clamp(D[:, d + 1] + 1, max=INF)
            elif tpos < 1 or tpos > Wg:
                v = inf_col
            else:
                v = D[:, d] + (~acc[:, p - 1, tpos - 1]).long()
                if indels:
                    if d + 1 < W:
                        v = torch.minimum(v, D[:, d + 1] + 1)  # deletion
                    if prev is not None:
                        v = torch.minimum(v, prev + 1)  # insertion
                v = torch.clamp(v, max=INF)
            cols.append(v)
            prev = v
        D = torch.stack(cols, dim=1)
        res = torch.where(glen_c == p, D.min(dim=1).values, res)
    return res <= k


class ExtendGate:
    """Callable gate over candidate tensors: ``gate(codes, anchors, sids)
    -> ok`` with ``codes`` the flat code array on ``tables``' device."""

    def __init__(self, tables: GateTables, indels: bool):
        self.t = tables
        self.indels = indels

    def __call__(self, codes, anchors, sids):
        return gate_ok_ref(codes, torch.as_tensor(anchors, device=codes.device),
                           torch.as_tensor(sids, device=codes.device),
                           self.t, self.indels, int(codes.shape[0]))
