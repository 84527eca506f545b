"""The pcr_match (e-PCR / STS) pair-join model.

Port of ``sequence_alignment_tools_tpu/models/pcr_match.py`` over the
port's ``PrimerMatchModel``: it needs no kernel of its own.  It scans all
2n primer orientations with the shared engine layer (the device scan and
host verify pipeline primer_match uses), then joins partner hits within
the amplicon window exactly like the reference's streaming pathitmap join
(pcr_match.cc:937-1265):

- per-batch position map pid -> sorted (end, index) lists,
- deferral of primaries whose partner window extends past the scan cursor
  (pcr_match.cc:1055-1059),
- processed hits are key-zeroed and excluded as partners
  (pcr_match.cc:1070-1097, :1228),
- re-verification of BOTH ends with ``editdist_alignment`` at the hit end
  (pcr_match.cc:1106-1130),
- same-entry / amplicon-length / STS-deviation gating and amplicon text
  extraction with N-count (pcr_match.cc:1184-1219).

The join runs on the host over the inner engine's hit stream.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Iterator

from ..engine.verify import Alignment, EditDistAligner
from ..io.database import SeqDB
from ..io.patterns import PatternSet, STSEntry
from ..utils.introsort import introsort
from .primer_match import PrimerMatchModel

_NULL_STS = STSEntry()


@dataclass
class PairHit:
    """One verified primer pair occurrence (all alignformat inputs)."""

    pa: Alignment
    pa1: Alignment
    pid: int
    pid1: int
    ind: int
    ind1: int
    pind: int
    rc: bool
    rc1: bool
    amplicon: str
    ncount: int
    header: str
    entry_index: int
    sps: int
    sps1: int
    spe: int
    spe1: int
    ps: int
    ps1: int
    pe: int
    pe1: int
    sts: STSEntry = field(default_factory=STSEntry)
    patdef: str = ""
    patdef1: str = ""
    # %p/%q inputs: patarray[ind] (original primer) and patarray[pid]
    # (registered orientation) for each side (pcr_match.cc:1203-1207)
    pat_ind: str = ""
    pat_ind1: str = ""
    pat_pid: str = ""
    pat_pid1: str = ""


class PcrMatchModel:
    def __init__(
        self,
        db: SeqDB,
        ps: PatternSet,
        k: int = 0,
        indels: bool = True,
        wc: bool = False,
        textn: bool = False,
        seedlen: int = 0,
        node: int = 0,
        report_interval: int = 1000,
        mindist: int = 0,
        maxdist: int = 2000,
        deviation: int = -1,
        betweenlen: bool = False,
        allorient: bool = False,
        rev_comp: bool = False,
        sts_mode: bool = False,
        fasta_mode: bool = False,
        device=None,
    ):
        self.db = db
        self.ps = ps
        self.k = k
        self.indels = indels
        self.mindist = mindist
        self.maxdist = maxdist
        self.deviation = deviation
        self.betweenlen = betweenlen
        self.allorient = allorient
        self.rev_comp = rev_comp
        self.sts_mode = sts_mode
        self.fasta_mode = fasta_mode
        self.report_interval = report_interval
        self.inner = PrimerMatchModel(
            db, ps, k=k, indels=indels, wc=wc, textn=textn, dna_mut=False,
            seedlen=seedlen, node=node, report_interval=report_interval,
            device=device,
        )
        self._aligner = EditDistAligner(
            k, chr(db.eos_char), wc, textn, indels, False, yesno=False
        )

    def _verify(self, pid: int, pos: int) -> Alignment:
        ps = self.ps
        return self._aligner.align(
            self.inner._text_at, ps.pattern(pid), pos, pos,
            esb=ps.esb[pid], eeb=ps.eeb[pid],
        )

    def pairs(self) -> Iterator[PairHit]:
        return self.pairs_from(self.inner.engine_hits())

    def pairs_stream(self, reps: int):
        """Serving posture: ``reps`` full pair-join runs with the inner
        engine's device scans queued across runs
        (``PrimerMatchModel.engine_hits_stream``); per-run output
        identical to :meth:`pairs`."""
        for hits in self.inner.engine_hits_stream(reps):
            yield list(self.pairs_from(iter(hits)))

    def pairs_from(self, stream) -> Iterator[PairHit]:
        db, ps, k = self.db, self.ps, self.k
        n = ps.n_forward
        patlen = [0] + [len(ps.pattern(i)) for i in range(1, ps.n_total + 1)]
        minka = self.report_interval
        slack = k if self.indels else 1
        total_len = len(db)
        exhausted = False
        l: list[list] = []  # [end, pid]; key 0 == processed
        while True:
            # -- one pm->find_patterns batch (engines return once >= minka
            #    candidates accumulate; true at EOF while hits remain) -------
            new: list[list] = []
            last_end = 0
            if not exhausted:
                for end, pid, _ in stream:
                    new.append([end, pid])
                    last_end = end
                    if len(new) >= minka:
                        break
                else:
                    exhausted = True
            more = bool(new)
            oldcharspos = total_len if exhausted else last_end + 1
            l.extend(new)
            if not l:
                return
            introsort(l, lambda a, b: a[0] < b[0])
            m: dict[int, list] = {}
            for idx, ent in enumerate(l):
                m.setdefault(ent[1], []).append((ent[0], idx))
            for i in range(len(l)):
                pos, pid = l[i][0], l[i][1]
                pid1 = pid2 = 0
                if pid <= n and pid % 2 == 1:
                    pid1 = pid + 1
                elif pid > n and (pid - n) % 2 == 0:
                    pid1 = pid - 1
                if self.allorient:
                    if pid <= n:
                        if pid % 2 == 1:
                            pid2 = pid + n + 1
                        else:
                            pid1 = pid - 1
                            pid2 = pid + n - 1
                    else:
                        if pid % 2 == 0:
                            pid2 = pid - n - 1
                        else:
                            pid1 = pid + 1
                            pid2 = pid - n + 1
                pair = (pid - (n if pid > n else 0) + 1) // 2
                stretch_max = self.maxdist
                stretch_min = self.mindist
                if self.betweenlen:
                    plen = 0
                    if pid1:
                        plen = patlen[pid1]
                    if pid2 and patlen[pid2] > plen:
                        plen = patlen[pid2]
                    stretch_max += plen + patlen[pid]
                if self.sts_mode and self.deviation >= 0:
                    sts = ps.sts[pair - 1]
                    if stretch_max > sts.sizeub + self.deviation:
                        stretch_max = sts.sizeub + self.deviation
                    if stretch_min < sts.sizelb - self.deviation:
                        stretch_min = sts.sizelb - self.deviation
                stretch_max += pos - patlen[pid] + slack
                stretch_min += pos - patlen[pid] - slack
                if oldcharspos < stretch_max and more:
                    continue  # deferred: partner window still growing
                partners: list[int] = []
                for pp in (pid1, pid2):
                    lst = m.get(pp)
                    if pp and lst:
                        j = bisect_left(lst, (stretch_min,))
                        while j < len(lst) and lst[j][0] <= stretch_max:
                            if l[lst[j][1]][0] != 0:
                                partners.append(lst[j][1])
                            j += 1
                for pidx in partners:
                    hit = self._join_one(pid, pos, l[pidx][1], l[pidx][0], n)
                    if hit is not None:
                        yield hit
                l[i][0] = 0
            l = [e for e in l if e[0] != 0]
            if exhausted and not more and not l:
                return

    def _join_one(self, pid, pos, ppid, pos1, n) -> PairHit | None:
        db, ps, k = self.db, self.ps, self.k
        pa = self._verify(pid, pos)
        pa1 = self._verify(ppid, pos1)
        if pa.editdist() > k or pa1.editdist() > k:
            return None
        spe = int(db.get_seq_pos(pa.end))
        spe1 = int(db.get_seq_pos(pa1.end))
        sps = spe - pa.length + 1
        sps1 = spe1 - pa1.length + 1
        pe, pe1 = pa.end, pa1.end
        psf = pe - pa.length + 1
        psf1 = pe1 - pa1.length + 1
        rc, rc1 = pid > n, ppid > n
        ind = pid - (n if rc else 0)
        ind1 = ppid - (n if rc1 else 0)
        pind = (ind if ind < ind1 else ind1) // 2 + 1
        stsref = ps.sts[pind - 1] if self.sts_mode else _NULL_STS
        patdef = ps.deflines[ind - 1] if self.fasta_mode else ""
        patdef1 = ps.deflines[ind1 - 1] if self.fasta_mode else ""
        if self.rev_comp:
            if ind % 2 == 0:
                rc = not rc
            elif ind1 % 2 == 0:
                rc1 = not rc1
        if not self.betweenlen:
            amplicon_len = pe1 - psf
        else:
            amplicon_len = psf1 - pe
        if not (
            db.is_subseq(psf, pe1)
            and self.mindist <= amplicon_len <= self.maxdist
            and (
                not self.sts_mode
                or self.deviation < 0
                or (
                    amplicon_len + self.deviation >= stsref.sizelb
                    and amplicon_len <= stsref.sizeub + self.deviation
                )
            )
        ):
            return None
        amplicon = db.decode(psf, psf + max(amplicon_len, 0))
        ncount = amplicon.count("N") + amplicon.count("n")
        return PairHit(
            pa=pa, pa1=pa1, pid=pid, pid1=ppid, ind=ind, ind1=ind1,
            pind=pind, rc=rc, rc1=rc1, amplicon=amplicon, ncount=ncount,
            header=db.get_header_data(pa.end),
            entry_index=int(db.entry_of(pa.end)) + 1,
            sps=sps, sps1=sps1, spe=spe, spe1=spe1,
            ps=psf, ps1=psf1, pe=pe, pe1=pe1,
            sts=stsref, patdef=patdef, patdef1=patdef1,
            pat_ind=ps.pattern(ind), pat_ind1=ps.pattern(ind1),
            pat_pid=ps.pattern(pid), pat_pid1=ps.pattern(ppid),
        )
