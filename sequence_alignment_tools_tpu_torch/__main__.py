"""CLI dispatcher: ``python -m sequence_alignment_tools_tpu_torch <tool>
[args...]``, with the JAX package's tool names and flags.

Every reference PROG maps to an app entry point; tool names are
case-sensitive where the reference's were (Indexer, Xspace, WordGraph).
"""

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
    "aacomp": ("aacomp", "aacomp_main"),
    "aacomplookup": ("aacomp", "aacomplookup_main"),
    "kmer_count": ("kmer_count", "main"),
    "kmer_annotate": ("kmer_annotate", "main"),
    "polyrun": ("polyrun", "main"),
    "nrdb": ("nrdb", "main"),
    "extract_seq": ("extract_seq", "main"),
    "tandem_match": ("tandem_match", "main"),
    "atac_seq": ("atac_seq", "main"),
    "xmers": ("xmers", "main"),
    "merstream": ("xmers", "merstream_main"),
    "allvall": ("allvall", "allvall_main"),
    "allvall_merge": ("allvall", "merge_main"),
    "allvall_dump": ("allvall", "dump_main"),
    "allvall_tobm": ("allvall", "tobm_main"),
    "pairscan": ("pairscan", "main"),
    "genome_simulation": ("genome_simulation", "main"),
    "solid_simulation": ("solid_simulation", "main"),
    "solid_assembly": ("solid_assembly", "main"),
    "Indexer": ("indexer", "main"),
    "IndexerAA": ("indexer", "main_aa"),
    "Xspace": ("xspace", "xspace_main"),
    "XspaceLo": ("xspace", "xspacelo_main"),
    "WordGraph": ("wordgraph_build", "wordgraph_main"),
    "chario": ("chario", "main"),
    "walk_graph": ("walk_graph", "walk_main"),
    "build_graph": ("walk_graph", "build_main"),
    "cannon_csbh_graph": ("walk_graph", "cannon_main"),
    "csbh_annotate": ("walk_graph", "annotate_main"),
}


def main() -> int:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in _TOOLS:
        names = " ".join(sorted(_TOOLS))
        sys.stderr.write(
            "Usage: python -m sequence_alignment_tools_tpu_torch <tool> "
            f"[args...]\n\nTools: {names}\n")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    mod_name, fn_name = _TOOLS[argv[0]]
    import importlib

    mod = importlib.import_module(f".apps.{mod_name}", __package__)
    return getattr(mod, fn_name)(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
