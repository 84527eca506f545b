"""compress_seq CLI on the port's ``io.compress``.

Port of ``sequence_alignment_tools_tpu/apps/compress_seq.py``, byte-
compatible with the reference preprocessor (compress_seq.cc:139-300
options, :306-1007 pipeline); host code only.

The artifacts (.seq/.hdr/.idb/.idx/.tbl/.sqn/.tbz/.sqz) are written by
:mod:`..io.compress`; this CLI reproduces the option surface, the
make-style timestamp-driven incremental rebuild and the ``-c`` check-only
exit status."""

from __future__ import annotations

import getopt
import sys

from ..io.compress import compress

USAGE = """Usage: compress_seq [options]

Options:
  -i <sequence-database> Input sequence database. Required.
  -e [true|false]        Insert end-of-sequence marker. Default: true.
  -S [true|false]        Insert initial end-of-sequence marker. Default: true.
  -E <char>              End-of-sequence marker char (int). Default: '\\n'.
  -u [true|false]        Uppercase sequence characters. Default: true.
  -n [true|false]        Normalize sequence information. Default: false.
  -D [true|false]        Optimize normalized table for DNA. Default: true.
  -R [true|false]        Include reverse complement chars in table.
  -z [true|false]        Bit-compress normalized sequence. Default: false.
  -I [true|false]        Binary (vs ASCII) index. Default: true.
  -c [true|false]        Check-only: nonzero exit if rebuild needed.
  -F [true|false]        Force rebuild. Default: false.
  -C [true|false]        Cleanup unnecessary files. Default: true.
  -B                     Buffered I/O hint (accepted for compatibility).
  -v                     Version information.
  -h                     This help.
"""


def _bool(val: str) -> bool:
    return val.strip().lower() in ("true", "t", "1", "yes")


def parse_args(argv):
    opts = {
        "database": None,
        "eos": True,
        "init_eos": True,
        "eos_char": ord("\n"),
        "uppercase": True,
        "normalize": False,
        "dna_optimized": True,
        "add_revcomp": False,
        "compress_bits": False,
        "binindex": True,
        "suffix_tree": False,
        "check_only": False,
        "tableonly": False,
        "guard": False,
        "force": False,
        "cleanup": True,
        "verbose": False,
    }
    try:
        parsed, _ = getopt.getopt(argv, "i:e:S:z:u:D:E:3:n:F:C:I:T:BR:hvG:c:t:")
    except getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n" + USAGE)
        raise SystemExit(1)
    for flag, val in parsed:
        if flag == "-i":
            opts["database"] = val
        elif flag == "-e":
            opts["eos"] = _bool(val)
        elif flag == "-S":
            opts["init_eos"] = _bool(val)
        elif flag in ("-E", "-3"):
            opts["eos_char"] = int(val, 0)
        elif flag == "-u":
            opts["uppercase"] = _bool(val)
        elif flag == "-n":
            opts["normalize"] = _bool(val)
        elif flag == "-D":
            opts["dna_optimized"] = _bool(val)
        elif flag == "-R":
            opts["add_revcomp"] = _bool(val)
        elif flag == "-z":
            opts["compress_bits"] = _bool(val)
        elif flag == "-I":
            opts["binindex"] = _bool(val)
        elif flag == "-c":
            opts["check_only"] = _bool(val)
        elif flag == "-F":
            opts["force"] = _bool(val)
        elif flag == "-C":
            opts["cleanup"] = _bool(val)
        elif flag == "-t":
            opts["suffix_tree"] = _bool(val)
        elif flag == "-T":
            opts["tableonly"] = _bool(val)
        elif flag == "-G":
            opts["guard"] = _bool(val)
        elif flag == "-B":
            pass  # buffered-I/O hint
        elif flag == "-v":
            opts["verbose"] = True
        elif flag == "-h":
            sys.stderr.write(USAGE)
            raise SystemExit(1)
    if not opts["database"]:
        sys.stderr.write("No sequence database supplied.\n\n" + USAGE)
        raise SystemExit(1)
    return opts


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    changed = compress(
        opts["database"],
        eos=opts["eos"],
        init_eos=opts["init_eos"],
        eos_char=opts["eos_char"],
        uppercase=opts["uppercase"],
        normalize=opts["normalize"],
        suffix_tree=opts["suffix_tree"],
        dna_optimized=opts["dna_optimized"],
        add_revcomp_chars=opts["add_revcomp"],
        compress_bits=opts["compress_bits"],
        binindex=opts["binindex"],
        cleanup=opts["cleanup"],
        force=opts["force"],
        check_only=opts["check_only"],
        tableonly=opts["tableonly"],
        guard=opts["guard"],
        verbose=opts["verbose"],
    )
    if opts["check_only"]:
        return 1 if changed else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
