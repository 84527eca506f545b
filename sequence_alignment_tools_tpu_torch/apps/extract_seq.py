"""extract_seq CLI — byte-compatible subsequence extractor (extract_seq.cc).

Reads ``<fasta-index> <start> <length>`` records (index -1 = absolute flat
position) and writes each subsequence followed by the EOS char.  Reference
quirks reproduced: the parsed match persists across records with length <= 0
(re-extracting the previous one), including one extra re-extraction when the
record stream hits EOF (the while(ifs) body runs once more on the stale
match).

The port's copy of ``sequence_alignment_tools_tpu/apps/extract_seq.py``,
kept byte-compatible with it (the port imports nothing of the JAX package)."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import load_db

USAGE = """Usage: extract_seq [options]

Options:
  -i <sequence-file>
  -o <output-fasta>
  -A <pos-file>   Line-based records: <fasta-index> <start-pos> <length>.
                  index -1 uses <start-pos> as an absolute flat position.
                  "-" indicates standard input.
  -E <int>        End-of-sequence character.
  -v              Verbose.
  -h              This help.
"""


def parse_args(argv):
    opts = {"seq_file": None, "atac_file": "-", "out": None,
            "eos_char": ord("\n"), "notin": False, "includeends": False,
            "verbose": False}
    try:
        parsed, _ = getopt.getopt(argv, "E:A:i:o:nIvh")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["seq_file"] = val
        elif flag == "-o":
            opts["out"] = val
        elif flag == "-A":
            opts["atac_file"] = val
        elif flag == "-E":
            opts["eos_char"] = int(val, 0)
        elif flag == "-n":
            opts["notin"] = True
        elif flag == "-I":
            opts["includeends"] = True
        elif flag == "-v":
            opts["verbose"] = True
        else:
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["seq_file"]:
        sys.stderr.write(USAGE)
        raise SystemExit(1)
    return opts


def run(opts, out) -> None:
    db = load_db(opts["seq_file"], eos_char=opts["eos_char"])
    if opts["notin"]:
        # the reference's between-alignments branch is entirely commented
        # out (extract_seq.cc:199-283) — it produces no output
        return
    data = sys.stdin.read() if opts["atac_file"] == "-" else \
        open(opts["atac_file"]).read()
    lines = data.split("\n")
    m_fe, m_start, m_len = 0, 0, 0

    def emit():
        if m_fe >= 0:
            # fasta_pos validity check (fasta_io.t:244-254): note the
            # reference compares the NEXT entry's absolute key against the
            # relative offset
            ok = m_fe < db.n_entries and not (
                m_fe + 1 < db.n_entries
                and int(db.entry_starts[m_fe + 1]) <= m_start
            )
            if not ok:
                return
            abspos = int(db.entry_starts[m_fe]) + m_start
        else:
            abspos = m_start
        if db.is_subseq(abspos, abspos + m_len):
            out.write(db.decode(abspos, abspos + m_len))
            out.write(chr(opts["eos_char"]))

    toks_stream = data.split()
    i = 0
    n = len(toks_stream)
    while True:
        if i + 3 <= n:
            try:
                fe = int(toks_stream[i])
                s = int(toks_stream[i + 1])
                ln = int(toks_stream[i + 2])
            except ValueError:
                break
            i += 3
            if ln > 0:
                if fe >= 0:
                    m_fe, m_start, m_len = fe, s, ln
                else:
                    hidx = int(db.entry_of(s)) + 1  # Lazy index, 0 if null
                    if int(db.entry_of(s)) < 0:
                        hidx = 0
                    m_start = int(db.get_seq_pos(s + 1)) - 1
                    m_fe = hidx - 1
                    m_len = ln
            emit()
        else:
            # EOF: the reference's while(ifs) body runs once more with the
            # stale match before the stream fails
            emit()
            break


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
