"""CLI dispatcher: ``python -m sequence_alignment_tools_tpu_torch <tool>
[args...]``, with the JAX package's tool names and flags.  Only the
ported tools are listed; any other tool name exits 1."""

from __future__ import annotations

import sys

_TOOLS = {
    "primer_match": ("primer_match", "main"),
    "compress_seq": ("compress_seq", "main"),
    "exact_match": ("exact_match", "main"),
    "inexact_match": ("inexact_match", "main"),
    "pcr_match": ("pcr_match", "main"),
    "peptide_scan": ("peptide_scan", "main"),
    "protein_mw": ("protein_mw", "main"),
    "peptide_mult": ("peptide_mult", "main"),
    "nrdb": ("nrdb", "main"),
    "tandem_match": ("tandem_match", "main"),
    "xmers": ("xmers", "main"),
    "merstream": ("xmers", "merstream_main"),
    "allvall": ("allvall", "allvall_main"),
    "allvall_merge": ("allvall", "merge_main"),
    "allvall_dump": ("allvall", "dump_main"),
    "allvall_tobm": ("allvall", "tobm_main"),
}


def main() -> int:
    argv = sys.argv[1:]
    if argv and argv[0] in _TOOLS:
        mod_name, fn_name = _TOOLS[argv[0]]
        import importlib

        mod = importlib.import_module(f".apps.{mod_name}", __package__)
        return getattr(mod, fn_name)(argv[1:])
    names = " ".join(sorted(_TOOLS))
    if argv and argv[0] not in ("-h", "--help"):
        sys.stderr.write(
            f"{argv[0]}: not ported to the torch package yet (see "
            "ROADMAP.md); use python -m sequence_alignment_tools_tpu\n")
        return 1
    sys.stderr.write(
        "Usage: python -m sequence_alignment_tools_tpu_torch <tool> "
        f"[args...]\n\nTools: {names}\n")
    return 0 if argv else 1


if __name__ == "__main__":
    raise SystemExit(main())
