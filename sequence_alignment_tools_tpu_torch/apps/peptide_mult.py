"""peptide_mult CLI, the port's copy of
``sequence_alignment_tools_tpu/apps/peptide_mult.py`` (host code only):
byte-compatible tryptic-peptide multiplicity counter (peptide_mult.cc): for each protein entry and each (query, rank, molwt)
triple, counts tryptic digest peptides (with missed cleavages, optional
X/B/Z wildcard expansion, N-terminal Met handling) whose mass falls within
the absolute/relative tolerance window."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..utils.introsort import introsort

USAGE = """Usage: peptide_mult [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -I <query-file>        Lines: <entry-index> (<query> <rank> <molwt>)*.
  -m <mass-file>         File of masses (n/c = terminal adjustments).
  -e <float>             Mass tolerance. Default: 2.
  -r                     Relative (fractional) tolerance.
  -C <int>               Missed cleavages. Default: 1.
  -X                     Expand X/B/Z wildcards.
  -o <output-file>       Output file. Defaults to standard out.
  -B / -D (0|1|2|3|4)    I/O and indexing hints.
  -v                     Verbose output.
  -h                     Command line option help.
"""


def parse_args(argv):
    opts = {"database": None, "indfile": None, "massfile": None,
            "out": None, "eos_char": ord("\n"), "dbind": 0,
            "verbose": False, "tol": 2.0, "reltol": False, "miscl": 1,
            "xwild": False}
    try:
        parsed, _ = getopt.getopt(argv, "i:o:hm:I:BD:e:rC:Xv")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-m":
            opts["massfile"] = val
        elif flag == "-I":
            opts["indfile"] = val
        elif flag == "-D":
            opts["dbind"] = int(val)
        elif flag == "-e":
            opts["tol"] = float(val)
        elif flag == "-r":
            opts["reltol"] = True
        elif flag == "-C":
            opts["miscl"] = int(val)
        elif flag == "-X":
            opts["xwild"] = True
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-B":
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not (opts["database"] and opts["indfile"] and opts["massfile"]):
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    db = load_db(opts["database"], eos_char=opts["eos_char"])
    tol, reltol, miscl, xwild = (opts["tol"], opts["reltol"], opts["miscl"],
                                 opts["xwild"])

    def min_obs(m):
        return m * (1 - tol) if reltol else m - tol

    def max_obs(m):
        return m * (1 + tol) if reltol else m + tol

    size = db.alphabet_size
    masses = [0.0] * size
    nterm = cterm = 0.0
    toks = open(opts["massfile"]).read().split()
    for i in range(0, len(toks) - 1, 2):
        sym = toks[i]
        try:
            mass = float(toks[i + 1])
        except ValueError:
            break
        if sym == "n":
            nterm = mass
        elif sym == "c":
            cterm = mass
        elif "A" <= sym[0] <= "Z":
            code = db.nch(sym[0])
            if code >= 0:
                masses[code] = mass

    def nch(c):
        return db.nch(c)

    neos, nx, nb, nz, nm_ = (db.eos_code, nch("X"), nch("B"), nch("Z"),
                             nch("M"))
    if xwild:
        for c in (nx, nb, nz):
            if c >= 0:
                masses[c] = 0.0

    # tryptic cleavage pairs (peptide_mult.cc:304-315)
    trpair = [[False] * size for _ in range(size)]
    for i in range(size):
        trpair[neos][i] = True
        trpair[i][neos] = True
        if nch("K") >= 0:
            trpair[nch("K")][i] = True
        if nch("R") >= 0:
            trpair[nch("R")][i] = True
    if nch("K") >= 0 and nch("P") >= 0:
        trpair[nch("K")][nch("P")] = False
    if nch("R") >= 0 and nch("P") >= 0:
        trpair[nch("R")][nch("P")] = False

    def tryptic(c1, c2):
        return trpair[c1][c2]

    data = sys.stdin.read() if opts["indfile"] == "-" else \
        open(opts["indfile"]).read()
    lines = data.split("\n")
    if data.endswith("\n"):
        lines = lines[:-1]
    AAS_X = "ACDEFGHIKLMNPQRSTVWY"
    AAS_B = "ND"
    AAS_Z = "EQ"
    for line in lines:
        toks = line.split()
        if not toks:
            break
        try:
            index = int(toks[0])
        except ValueError:
            break
        if index == 0:
            break
        mws = []  # (molwt, query, rank)
        ti = 1
        while ti + 2 < len(toks) + 1 and ti + 2 <= len(toks):
            try:
                molwt = float(toks[ti + 2])
            except (ValueError, IndexError):
                break
            if molwt <= 0:
                break
            mws.append([molwt, toks[ti], toks[ti + 1]])
            ti += 3
        if not mws:
            out.write(f"{index}\n")
            continue
        mws_sorted = list(mws)
        introsort(mws_sorted, lambda a, b: a[0] < b[0])
        lo_gate = min_obs(mws_sorted[0][0])
        hi_gate = max_obs(mws_sorted[-1][0])

        # buffer1 = [eos, entry codes..., eos]
        if 1 <= index <= db.n_entries:
            s0 = int(db.entry_starts[index - 1])
            length = int(db.entry_lengths[index - 1])
            ent = list(db.codes[s0 : s0 + length])
        else:
            ent = []
        buffer1 = [neos] + ent + [neos, 0]

        pepmw = []  # (mass, spos, epos, miscl, sub)
        spos = 1
        while True:
            epos = spos - 1
            mcl = -1
            if spos == 1:
                mcl -= 1
            mass = nterm
            numx = numb = numz = 0
            wcpos = -1
            while True:
                epos += 1
                if buffer1[epos] == neos:
                    break
                mass += masses[buffer1[epos]]
                if buffer1[epos] == nx:
                    numx += 1
                    wcpos = epos
                if buffer1[epos] == nb:
                    numb += 1
                    wcpos = epos
                if buffer1[epos] == nz:
                    numz += 1
                    wcpos = epos
                while (epos > 1 and not tryptic(buffer1[epos],
                                                buffer1[epos + 1])
                       and buffer1[epos + 1] != neos):
                    epos += 1
                    mass += masses[buffer1[epos]]
                    if buffer1[epos] == nx:
                        numx += 1
                        wcpos = epos
                    if buffer1[epos] == nb:
                        numb += 1
                        wcpos = epos
                    if buffer1[epos] == nz:
                        numz += 1
                        wcpos = epos
                mcl += 1
                if mcl > miscl:
                    break
                if not xwild or numx + numb + numz == 0:
                    if mass + cterm > hi_gate:
                        break
                    if mass + cterm < lo_gate:
                        continue
                    pepmw.append([mass + cterm, spos, epos, mcl, None])
                elif numx + numb + numz == 1:
                    limit = 20 if numx else 2
                    for i in range(limit):
                        m = mass + cterm
                        if numx > 0:
                            m += masses[nch(AAS_X[i])]
                        if numb > 0:
                            m += masses[nch(AAS_B[i])]
                        if numz > 0:
                            m += masses[nch(AAS_Z[i])]
                        if m > hi_gate or m < lo_gate:
                            continue
                        if (numx > 0 and AAS_X[i] in "KR"
                                and buffer1[wcpos + 1] != nch("P")
                                and mcl + 1 > miscl):
                            continue
                        sub = ("X", AAS_X[i]) if numx else \
                            ("B", AAS_B[i]) if numb else ("Z", AAS_Z[i])
                        pepmw.append([m, spos, epos, mcl, sub])
            spos += 1
            while (((spos == 2 and buffer1[spos - 1] != nm_) or spos > 2)
                   and not tryptic(buffer1[spos - 1], buffer1[spos])
                   and buffer1[spos] != neos):
                spos += 1
            if buffer1[spos] == neos:
                break
        introsort(pepmw, lambda a, b: a[0] < b[0])
        keys = [p[0] for p in pepmw]

        out.write(str(index))
        from bisect import bisect_left, bisect_right

        for molwt, query, rank in mws_sorted:
            lo = bisect_left(keys, min_obs(molwt))
            hi = bisect_right(keys, max_obs(molwt))
            mult = hi - lo
            out.write(f"\t{query}\t{rank}\t{mult}")
        out.write("\n")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts["out"]:
        with open(opts["out"], "w") as f:
            run(opts, f)
    else:
        run(opts, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
