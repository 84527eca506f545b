"""primer_match CLI on the port's model.

Port of ``sequence_alignment_tools_tpu/apps/primer_match.py``: the same
options (``parse_args``, ``load_patterns`` and ``USAGE`` are imported
from it), the same verbose protocol and the same output bytes, for exact
search and for ``-k``/``-K`` through the pigeonhole engines (halves,
bases).  ``-T`` (translated search) and the engines the model does not
port yet (filter, hash, gs) exit 1 with a message naming their ROADMAP
item.
"""

from __future__ import annotations

import sys

from sequence_alignment_tools_tpu.apps.primer_match import (  # noqa: F401
    USAGE,
    load_patterns,
    parse_args,
)
from sequence_alignment_tools_tpu.io.compress import load_db
from sequence_alignment_tools_tpu.io.patterns import (
    STSEntry,
    build_pattern_set,
)
from sequence_alignment_tools_tpu.utils.format import (
    AlignRecord,
    alignformat,
    countformat,
)

from ..models.primer_match import PrimerMatchModel


def _not_ported(why: str):
    sys.stderr.write("primer_match: " + why + "\n")
    raise SystemExit(1)


def run(opts, out) -> None:
    """The JAX app's main loop (reference primer_match.cc structure,
    verbose stderr protocol included) over the port's model."""
    from sequence_alignment_tools_tpu.models.primer_match import (
        db_pick_report,
        select_report,
    )
    from sequence_alignment_tools_tpu.utils.log import (
        ProgressReporter,
        timestamp,
    )

    if opts["translate"]:
        _not_ported("-T (peptide patterns against the 6-frame translation) "
                    "is not ported yet (ROADMAP queue 1 item 9)")
    v = opts["verbose"]
    if v:
        timestamp("Release Tag: $Name:  $")
    if not opts["patterns"] or not opts["database"]:
        return  # verbose-mode early exit 0 (primer_match.cc:274,927-929)
    pats, deflines, sts = load_patterns(opts)
    if not pats:
        return
    if v:
        timestamp("Read primers")
        if opts["ucdict"]:
            timestamp("Uppercase primers")
    ps = build_pattern_set(
        pats,
        rev_comp=opts["rev_comp"],
        translate=opts["translate"],
        uppercase=opts["ucdict"],
        stlen=opts["stlen"],
        edlen=opts["edlen"],
        fplen=opts["fplen"],
        tplen=opts["tplen"],
        deflines=deflines,
        sts=sts,
    )
    if v:
        if ps.n_forward < 100:
            for i in range(1, ps.n_forward + 1):
                timestamp("Pattern %3d > %s" % (i, ps.pattern(i)))
                if opts["rev_comp"]:
                    timestamp("Pattern %3d < %s"
                              % (i, ps.pattern(i + ps.n_forward)))
        timestamp("Put primers in an array")
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    if v:
        for line in db_pick_report(db, opts["memmap"]):
            timestamp(line)
    try:
        model = PrimerMatchModel(
            db,
            ps,
            k=opts["k"],
            indels=opts["indels"],
            wc=opts["wc"],
            textn=opts["tn"],
            dna_mut=opts["dna_mut"],
            seedlen=opts["seedlen"],
            node=opts["node"],
            report_interval=opts["report_interval"],
        )
    except NotImplementedError as e:
        _not_ported(str(e))
    if v:
        for line in select_report(db, ps, k=opts["k"], wc=opts["wc"],
                                  textn=opts["tn"], seedlen=opts["seedlen"],
                                  node=opts["node"], indels=opts["indels"],
                                  dna_mut=opts["dna_mut"]):
            timestamp(line)
        # kt->progress_interval(*ff, 1.0) (primer_match.cc:1109-1111)
        model.progress = ProgressReporter(0.01)

    n = ps.n_forward
    k = opts["k"]
    counts = opts["counts"]
    maxcount = opts["maxcount"]
    patcount = [[0] * (k + 1) for _ in range(ps.n_total + 1)]
    maxpatcount = [False] * (ps.n_total + 1)
    null_sts = STSEntry()

    for hit in model.hits():
        pid = hit.pid
        if maxcount > 0 and maxpatcount[pid]:
            continue
        a = hit.alignment
        ed = a.editdist()
        if ed > k:
            continue
        rc = pid > n
        ind = pid - (n if rc else 0)
        if opts["alignments"]:
            p = a.end
            spe = int(model.db.get_seq_pos(p))
            sps = spe - a.length + 1
            pe = a.end
            pstart = pe - a.length + 1
            pat = ps.pattern(pid)
            header = model.db.get_header_data(p)
            entry_idx = int(model.db.entry_of(p)) + 1
            rec = AlignRecord(
                s=sps,
                e=spe,
                five=spe if rc else sps,
                three=sps if rc else spe,
                S=pstart,
                E=pe,
                i=ind,
                d=ed,
                p=ps.pattern(ind),
                P=deflines[ind - 1] if deflines else "",
                q=pat,
                Q=a.alignment_pattern(pat),
                r="R" if rc else "F",
                R=" REVCOMP" if rc else "",
                t=a.matching_text,
                T=a.alignment_text(),
                A=a.alignment_string(),
                h=header,
                H=header.split()[0] if header.split() else "",
                f=entry_idx,
                sts=sts[(ind + 1) // 2 - 1] if sts else null_sts,
            )
            out.write(alignformat(opts["alignformat"], rec))
        if counts:
            patcount[pid][ed] += 1
            if maxcount > 0 and sum(patcount[pid]) >= maxcount:
                maxpatcount[pid] = True

    if counts:
        for i in range(1, n + 1):
            c = list(patcount[i])
            total = sum(c)
            gtmax = maxpatcount[i] if maxcount > 0 else False
            patdef = deflines[i - 1] if deflines else ""
            stsref = sts[(i + 1) // 2 - 1] if sts else null_sts
            if not opts["aggregate"]:
                out.write(
                    countformat(opts["countformat"], i, ps.pattern(i), patdef,
                                ps.pattern(i), "F", "", total, c, k, gtmax,
                                stsref)
                )
            if opts["rev_comp"] or opts["translate"]:
                # translate also carries reversed patterns
                # (primer_match.cc:1296: rev_comp || translate)
                if not opts["aggregate"]:
                    c = [0] * (k + 1)
                    total = 0
                    gtmax = False
                for kk in range(k + 1):
                    c[kk] += patcount[i + n][kk]
                    total += patcount[i + n][kk]
                if maxcount > 0:
                    gtmax = gtmax or maxpatcount[i + n]
                if not opts["aggregate"]:
                    out.write(
                        countformat(opts["countformat"], i, ps.pattern(i),
                                    patdef, ps.pattern(i + n), "R", " REVCOMP",
                                    total, c, k, gtmax, stsref)
                    )
            if opts["aggregate"]:
                out.write(
                    countformat(opts["countformat"], i, ps.pattern(i), patdef,
                                "", "", "", total, c, k, gtmax, stsref)
                )

    if v:
        timestamp("Done.")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        with open(opts["out"], "a") as f:
            run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
