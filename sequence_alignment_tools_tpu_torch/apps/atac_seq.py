"""atac_seq CLI — byte-compatible ATAC-format interval extractor
(atac_seq.cc): reads ``id fe start length sense_seq sense_comp`` alignment
records (-A), sorts/merges them, and emits the covered (or, with -n, the
between) sequence regions with /run annotations and N statistics.  The
native-ATAC (-a) parser in the reference is commented out and produces no
records — same here.

The port's copy of ``sequence_alignment_tools_tpu/apps/atac_seq.py``, kept
byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db
from ..utils.iupac import reverse_comp

USAGE = """Usage: atac_seq [options]

Options:
  -i <sequence-file>
  -o <output-fasta>
  -A <pos-file>   Records: <id> <fasta-index> <start> <length> <ss> <sc>.
  -n              Output sequence between matches or runs.
  -I              Include sequence ends for between runs.
  -O              Permit overlap in runs or matches.
  -m / -r / -t <type>   Match/run/custom record type word.
  -e              Basic extract.  -H headers only.
  -E <int>        End-of-sequence character.
  -v              Verbose.
  -h              This help.
"""


def parse_args(argv):
    o = {"seq_file": None, "atac_file": None, "atac_format": True,
         "notin": False, "includeends": False, "nooverlap": True,
         "type": "", "headersonly": False, "eos_char": ord("\n"),
         "extract": False, "out": None, "verbose": False}
    try:
        parsed, _ = getopt.getopt(
            sys.argv[1:] if argv is None else argv, "E:A:i:s:o:Omrt:nHeIvh"
        )
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-A":
            o["atac_file"], o["atac_format"] = val, False
        elif flag == "-i":
            o["seq_file"] = val
        elif flag == "-n":
            o["notin"] = True
        elif flag == "-I":
            # reference quirk: case 'I' has no break and falls through
            # into case 'm' (atac_seq.cc:117-122)
            o["includeends"] = False
            o["type"] = "u"
        elif flag == "-m":
            o["includeends"] = False
            o["type"] = "u"
        elif flag == "-r":
            o["includeends"] = True
            o["type"] = "r"
        elif flag == "-t":
            o["type"] = val
        elif flag == "-e":
            o["extract"] = True
            o["nooverlap"] = False
        elif flag == "-O":
            o["nooverlap"] = False
        elif flag == "-H":
            o["headersonly"] = True
        elif flag == "-E":
            o["eos_char"] = int(val, 0)
        elif flag == "-o":
            o["out"] = val
        elif flag in ("-s", "-v"):
            pass
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    return o


def run(o, out) -> None:
    if not o["atac_file"] or not o["seq_file"]:
        raise SystemExit(1)
    db = load_db(o["seq_file"], eos_char=o["eos_char"])
    matches = []  # [id, fe, run, start, length, ss, sc]
    if not o["atac_format"]:
        data = sys.stdin.read() if o["atac_file"] == "-" else \
            open(o["atac_file"]).read()
        toks = data.split()
        i = 0
        while i < len(toks):
            rec = toks[i : i + 6]
            mid = rec[0] if rec else ""
            if mid == "":
                break
            vals = [int(x) for x in rec[1:]] + [0] * (5 - len(rec[1:]))
            fe, s, ln, ss, sc = vals
            i += 6
            if fe >= 0:
                if ln != 0:
                    matches.append([mid, fe, "", s, ln, ss, sc])
            else:
                s2 = int(db.get_seq_pos(s + 1)) - 1
                fe2 = int(db.entry_of(s + 1))
                matches.append([mid, fe2, "", s2, ln, ss, sc])
    if not o["extract"]:
        matches.sort(key=lambda m: (m[1], m[3], m[4], m[5], m[6]))
    if o["nooverlap"]:
        # merge overlapping intervals (atac_seq.cc:389-422)
        merged = []
        i = 0
        while i < len(matches):
            cur = matches[i]
            j = i + 1
            while (j < len(matches) and matches[j][1] == cur[1]
                   and matches[j][3] < cur[3] + cur[4]):
                if matches[j][3] + matches[j][4] > cur[3] + cur[4]:
                    cur[4] = matches[j][3] + matches[j][4] - cur[3]
                cur[0] += ":" + matches[j][0]
                j += 1
            merged.append(cur)
            i = j
        matches = merged
        matches.sort(key=lambda m: (m[1], m[3], m[4], m[5], m[6]))

    runword = {"r": "run", "u": "match", "s": "signature"}.get(
        o["type"], "alignment"
    )

    def in_entry(fe, start, length):
        if fe < 0 or fe >= db.n_entries:
            return None
        abspos = int(db.entry_starts[fe]) + start
        if not db.is_subseq(abspos, abspos + length):
            return None
        return abspos

    def n_stats(text):
        ncount = maxrun = cur = 0
        for c in text:
            if c == "N":
                ncount += 1
                cur += 1
            else:
                maxrun = max(maxrun, cur)
                cur = 0
        return ncount, max(maxrun, cur)

    if not o["notin"]:
        for mid, fe, _run, start, length, ss, sc in matches:
            abspos = in_entry(fe, start, length)
            if abspos is None:
                continue
            text = db.decode(abspos, abspos + length)
            if not o["extract"]:
                header = db.get_header_data(abspos + 1)
                short = header.split()[0] if header.split() else header
                st = int(db.get_seq_pos(abspos + 1)) - 1
                out.write(f">{short} /{runword}={{{mid}}} /start={st} "
                          f"/end={st + length} /length={length}")
                ncount, maxn = n_stats(text)
                if ncount > 0:
                    out.write(f" /Ns={ncount} /nonNs={length - ncount} "
                              f"/maxContigN={maxn}")
                out.write("\n")
            if not o["headersonly"]:
                if ss and sc:
                    text = reverse_comp(text)
                if o["extract"]:
                    out.write(text + chr(o["eos_char"]))
                else:
                    for i in range(0, len(text), 60):
                        out.write(text[i : i + 60] + "\n")
    else:
        # between-regions mode (atac_seq.cc:468-620)
        if not matches:
            return
        cur_fe = 0
        idx = 0
        current_run = matches[0][2]
        while True:
            start_pos = 0
            prev = None
            while idx < len(matches) and matches[idx][1] == cur_fe:
                m = matches[idx]
                end_pos = m[3]
                skip = (not o["includeends"]
                        and (m[2] != current_run or start_pos == 0))
                length = end_pos - start_pos
                abspos = in_entry(cur_fe, start_pos, max(length, 0))
                if not skip and abspos is not None and length >= 0:
                    # header lookup at the region's FIRST char: resolves the
                    # previous entry for later entries and clamps to entry 0
                    # below the first key (observed reference behavior)
                    header = db.headers[max(int(db.entry_of(abspos)), 0)]
                    out.write(f">{header}")
                    if start_pos > 0 and prev is not None:
                        out.write(
                            f" /{runword}_before={{{prev[0]}}}{prev[1]}:"
                            f"{prev[3]}-{prev[3] + prev[4]}"
                            f"({prev[5]},{prev[6]})"
                        )
                    out.write(
                        f" /{runword}_after={{{m[0]}}}{m[1]}:"
                        f"{m[3]}-{m[3] + m[4]}({m[5]},{m[6]})"
                    )
                    if start_pos > 0 and prev is not None:
                        a, b = sorted([prev[0], m[0]])
                        out.write(f" /cannonical_pair_id={{{a},{b}}}")
                    out.write(f" /between_{runword}={cur_fe}:"
                              f"{start_pos}-{end_pos} /length={length}")
                    text = db.decode(abspos, abspos + length)
                    ncount, maxn = n_stats(text)
                    out.write(f" /Ns={ncount} /nonNs={length - ncount} "
                              f"/maxContigN={maxn}\n")
                    if not o["headersonly"]:
                        for i in range(0, len(text), 60):
                            out.write(text[i : i + 60] + "\n")
                start_pos = m[3] + m[4]
                prev = m
                current_run = m[2]
                idx += 1
            # tail region to the entry end (skipped for the LAST entry:
            # fasta_pos(fe+1, 0) fails there, atac_seq.cc:556-562)
            if (o["includeends"] and 0 <= cur_fe < db.n_entries - 1):
                ent_len = int(db.entry_lengths[cur_fe])
                length = ent_len - start_pos
                if length > 0:
                    abspos = int(db.entry_starts[cur_fe]) + start_pos
                    header = db.headers[max(int(db.entry_of(abspos)), 0)]
                    out.write(f">{header}")
                    if start_pos > 0 and prev is not None:
                        out.write(
                            f" /{runword}_before={{{prev[0]}}}{prev[1]}:"
                            f"{prev[3]}-{prev[3] + prev[4]}"
                            f"({prev[5]},{prev[6]})"
                        )
                    out.write(f" /between_{runword}={cur_fe}:"
                              f"{start_pos}-{start_pos + length} "
                              f"/length={length}")
                    text = db.decode(abspos, abspos + length)
                    ncount, maxn = n_stats(text)
                    out.write(f" /Ns={ncount} /nonNs={length - ncount} "
                              f"/maxContigN={maxn}\n")
                    if not o["headersonly"]:
                        for i in range(0, len(text), 60):
                            out.write(text[i : i + 60] + "\n")
            if idx < len(matches):
                cur_fe += 1
            else:
                break


def main(argv=None) -> int:
    o = parse_args(argv)
    if o["out"]:
        with open(o["out"], "a") as f:
            run(o, f)
    else:
        run(o, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
