// FASTA pass-1: one sweep over the raw multi-FASTA bytes producing the flat
// sequence space with EOS sentinels, entry start positions/lengths, and
// header byte spans.  This is the data-loader hot loop — the native
// equivalent of the reference's compress_seq pass 1 (compress_seq.cc:438-630)
// and streamed FASTA readers (fasta_io.t:448-751); the Python
// io.fasta.iter_fasta / io.compress._read_raw implementations remain as the
// portable fallback and the conformance oracle for this file.
//
// Line semantics replicate iter_fasta exactly:
//   - lines split on '\n'; trailing '\r' runs stripped
//   - a line starting with '>' begins a new entry; header = rest of line
//   - sequence bytes before any '>' open an unnamed entry when the
//     (\r-stripped) line is non-empty
// filter_mode 0 drops ' ' and '\t' anywhere in sequence lines (iter_fasta's
// translate) — mode 1 keeps only bytes 33..126 (compress_seq.cc:544-575).
//
// C ABI, bound via ctypes (no pybind11 on this image).

#include <cstdint>

extern "C" int64_t sat_fasta_pass1(
    const uint8_t *data, int64_t n,
    int32_t filter_mode, int32_t uppercase,
    int32_t eos_between, int32_t init_eos, uint8_t eos_char,
    uint8_t *out_seq,                     // cap >= n + count('>') + 2
    int64_t *entry_starts,                // cap max_entries
    int64_t *entry_lengths,               // cap max_entries
    int64_t *hdr_start, int64_t *hdr_end, // spans into data; cap max_entries
    int64_t max_entries,
    int64_t *out_meta)                    // [0]=seq_len, [1]=n_entries
{
    int64_t pos = 0, nent = 0;
    bool have_entry = false;
    if (init_eos && eos_between) out_seq[pos++] = eos_char;

    int64_t i = 0;
    while (i < n) {
        int64_t ls = i;
        while (i < n && data[i] != '\n') i++;
        int64_t le = i;
        if (i < n) i++;  // consume the '\n'
        while (le > ls && data[le - 1] == '\r') le--;

        if (le > ls && data[ls] == '>') {
            if (have_entry) {
                entry_lengths[nent - 1] = pos - entry_starts[nent - 1];
                if (eos_between) out_seq[pos++] = eos_char;
            }
            if (nent >= max_entries) return -1;
            entry_starts[nent] = pos;
            hdr_start[nent] = ls + 1;
            hdr_end[nent] = le;
            nent++;
            have_entry = true;
            continue;
        }
        if (!have_entry) {
            if (le == ls) continue;  // blank line before any header
            // sequence data before any '>': unnamed entry
            if (nent >= max_entries) return -1;
            entry_starts[nent] = pos;
            hdr_start[nent] = 0;
            hdr_end[nent] = 0;
            nent++;
            have_entry = true;
        }
        if (filter_mode == 0) {
            for (int64_t j = ls; j < le; j++) {
                uint8_t c = data[j];
                if (c == ' ' || c == '\t') continue;
                if (uppercase && c >= 'a' && c <= 'z') c -= 32;
                out_seq[pos++] = c;
            }
        } else {
            for (int64_t j = ls; j < le; j++) {
                uint8_t c = data[j];
                if (c < 33 || c > 126) continue;
                if (uppercase && c >= 'a' && c <= 'z') c -= 32;
                out_seq[pos++] = c;
            }
        }
    }
    if (have_entry) {
        entry_lengths[nent - 1] = pos - entry_starts[nent - 1];
        if (eos_between) out_seq[pos++] = eos_char;
    }
    out_meta[0] = pos;
    out_meta[1] = nent;
    return 0;
}
