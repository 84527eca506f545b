"""chario — character-stream exerciser/dump over a 6-frame translated file.

Reference: ``chario.cc`` (the ad-hoc CharacterProducer benchmark driver in
PROGS, Makefile:172).  As shipped it is hard-wired to
``Translated<MapFileChars> cp(file, '$')`` (chario.cc:66) and performs:

1. full scan printing every translated char, with ``" pos basepos"`` +
   a ``pos(pos())`` roundtrip + ``" pos basepos"`` every 50 chars
   (chario.cc:76-92) — the roundtrip goes through ``getbasepos``
   (char_io.t:442-457) whose frame resolution uses the not-yet-recorded
   frame-end table, so near frame boundaries the second basepos can
   differ from the first (e.g. ``150 224 150 226``): a pinned quirk;
2. file size + scan rate report (integer-second timing, so sub-second
   scans print ``inf``, chario.cc:95-125);
3. first/middle/last 50 chars to stderr (chario.cc:127-165);
4. 1000 wall-seeded random seeks + 50 random chars (chario.cc:167-198)
   — nondeterministic by construction (``srand48(time(NULL))``).

This is a byte-level simulation of ``Translated`` (char_io.t:337-482) over
the mmap'd raw byte stream (``MapFileChars``, char_io.h:150-170): getch()
consumes up to three base chars per call, checking base-eof before each
(mapFile.h:25-56), emits EOS when codon[2] is missing/EOS or codon[0] is
EOS, else ``trans_codon(frame, codon)`` (util.cc:714-765 — reverse frames
revcomp the codon in place, the stream itself is never reversed), and
advances frames 0..5 by ``reset(); skip frame%3`` at base EOF
(char_io.t:392-404).  Perf is irrelevant here — the real scan path is the
vectorized ``io/translate.py``; chario's value is pinning the streaming
coordinate semantics those vectorized tables must reproduce.

The port's copy of ``sequence_alignment_tools_tpu/apps/chario.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..utils.log import timestamp
from ..io.translate import _MAPTABLE, _RCMAPTABLE, _codon_tables

_EXTRA = 1  # translated alphabet handled via trans tables below


class _MapChars:
    """MapFileChars: raw byte mmap stream (char_io.h:150-170)."""

    def __init__(self, path: str):
        self.data = np.fromfile(path, dtype=np.uint8)
        self._pos = 0

    def eof(self) -> bool:
        return self._pos >= self.data.shape[0]

    def getch(self) -> int:
        ch = int(self.data[self._pos]) if self._pos < self.data.shape[0] else 0
        self._pos += 1
        return ch

    def pos(self) -> int:
        return self._pos

    def setpos(self, p: int) -> None:
        self._pos = p

    def reset(self) -> None:
        self._pos = 0


_TRANS, _ = _codon_tables()


def _trans_codon(frame: int, codon: list[int]) -> int:
    """util.cc:714-765 — forward frames index (c0,c1,c2) via maptable,
    reverse frames index (c2,c1,c0) via rcmaptable."""
    if frame < 3:
        a, b, c = (_MAPTABLE[codon[0]], _MAPTABLE[codon[1]],
                   _MAPTABLE[codon[2]])
    else:
        a, b, c = (_RCMAPTABLE[codon[2]], _RCMAPTABLE[codon[1]],
                   _RCMAPTABLE[codon[0]])
    return int(_TRANS[a, b, c])


class _Translated:
    """Translated<T> streaming state machine (char_io.t:337-482)."""

    def __init__(self, base: _MapChars, eos_char: int):
        self.T = base
        self.frame_in = 0
        self.frame = 0
        self.eof_ = False
        self.fep = [0] * 6  # frame_end_pos_
        self.pos_ = 0
        self.eos = eos_char

    def eof(self) -> bool:
        return self.eof_

    def getch(self) -> int:
        if self.T.eof():
            self.fep[self.frame] = self.pos_
            if self.frame == 5:
                self.eof_ = True
            else:
                self.T.reset()
                self.frame += 1
                for _ in range(self.frame % 3):
                    self.T.getch()
        codon = [0, 0, 0]
        for i in range(3):
            if self.T.eof():
                break
            codon[i] = self.T.getch()
        self.pos_ += 1
        if codon[2] == self.eos or codon[2] == 0:
            return self.eos
        if codon[0] == self.eos:
            return self.eos
        return _trans_codon(self.frame, codon)

    def pos(self) -> int:
        return self.pos_

    def basepos(self) -> int:
        return self.T.pos()

    def getbasepos(self, p: int) -> tuple[int, int]:
        # char_io.t:442-457 — first frame whose end table entry is ahead
        # of p or still unrecorded (0); last frame accepts p == end+1.
        f = -1
        for i in range(6):
            if (p < self.fep[i] or self.fep[i] == 0
                    or (i == 5 and p == self.fep[i] + 1)):
                f = i
                break
        assert f >= 0
        p1 = (p - (0 if f == 0 else self.fep[f - 1])) * 3 + f % 3
        return p1, f

    def setpos(self, p: int) -> None:
        bpos, self.frame = self.getbasepos(p)
        self.pos_ = p
        self.T.setpos(bpos)
        self.eof_ = False


def _size_report(size: int, out) -> None:
    # chario.cc:97-110
    if size > 1024 * 1024 * 1024:
        out.write("File size: %.2f GB\n" % (size / (1024 * 1024 * 1024)))
    elif size > 1024 * 1024:
        out.write("File size: %.2f MB\n" % (size / (1024 * 1024)))
    elif size > 1024:
        out.write("File size: %.2f kB\n" % (size / 1024))
    else:
        out.write("File size: %.2f bytes\n" % float(size))


def _rate_report(size: int, tsec: int, out) -> None:
    # chario.cc:111-124 — integer seconds; 0 elapsed divides to inf
    cps = (size / tsec) if tsec else float("inf")
    if cps > 1024 * 1024 * 1024:
        cps /= 1024 * 1024 * 1024
        out.write("Scan rate: %.2f GB/s, %.2f Gb/s\n" % (cps, cps * 8))
    elif cps > 1024 * 1024:
        cps /= 1024 * 1024
        out.write("Scan rate: %.2f MB/s, %.2f Mb/s\n" % (cps, cps * 8))
    elif cps > 1024:
        cps /= 1024
        out.write("Scan rate: %.2f kB/s, %.2f kb/s\n" % (cps, cps * 8))
    else:
        out.write("Scan rate: %.2f B/s, %.2f b/s\n" % (cps, cps * 8))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    char_file = ""
    i = 0
    while i < len(argv):
        if argv[i] == "-i" and i + 1 < len(argv):
            char_file = argv[i + 1]
            i += 2
        elif argv[i] == "-h":
            char_file = ""
            break
        else:
            i += 1
    if not char_file:
        sys.stderr.write(
            "Usage: chario [options] \n\nOptions: \n"
            "  -i <character-file>    Input file.\n"
            "  -h                     Command line option help.\n\n")
        return 1

    err = sys.stderr
    timestamp("File open")
    cp = _Translated(_MapChars(char_file), ord("$"))
    timestamp("Translated<MapFileChars>")

    out = []
    timestamp("Start scan")
    t0 = time.time()
    size = 0
    while not cp.eof():
        ch = cp.getch()
        size += 1
        out.append(chr(ch))
        if size % 50 == 0:
            out.append(" %d %d" % (cp.pos(), cp.basepos()))
            cp.setpos(cp.pos())
            out.append(" %d %d\n" % (cp.pos(), cp.basepos()))
    out.append(" %d %d" % (cp.pos(), cp.basepos()))
    cp.setpos(cp.pos())
    out.append(" %d %d\n" % (cp.pos(), cp.basepos()))
    out.append("\n")
    sys.stdout.write("".join(out))
    timestamp("End scan")
    tsec = int(time.time() - t0)
    err.write("Elapsed time: %d:%02d:%02d\n"
              % (tsec // 3600, (tsec % 3600) // 60, tsec % 60))
    _size_report(size, err)
    _rate_report(size, tsec, err)

    timestamp("First 50 chars")
    cp.setpos(0)
    count = 0
    while not cp.eof() and count < 50:
        err.write(chr(cp.getch()))
        count += 1
    err.write("\n")

    timestamp("Middle 50 chars")
    newpos = size // 2
    newpos = newpos - 25 if newpos > 25 else 0
    cp.setpos(newpos)
    count = 0
    while not cp.eof() and count < 50:
        err.write(chr(cp.getch()))
        count += 1
    err.write("\n")

    timestamp("Last 50 chars")
    cp.setpos(0 if size <= 50 else size - 50)
    while not cp.eof():
        err.write(chr(cp.getch()))
    err.write("\n")

    # chario.cc:167-198 — wall-seeded drand48; inherently nondeterministic
    seed = int(time.time())
    state = (seed << 16) + 0x330E
    def drand48():
        nonlocal state
        state = (0x5DEECE66D * state + 0xB) & ((1 << 48) - 1)
        return state / float(1 << 48)

    nseek = 1000
    timestamp("Start random seeks")
    t0 = time.time()
    for _ in range(nseek):
        try:
            cp.setpos(int(drand48() * size))
        except AssertionError:
            # chario aborts here too: a seek to p == frame_end_pos_[5]
            # (possible — size == fep[5]+1 counts the trailing EOS) falls
            # through getbasepos's frame search (char_io.t:453 assert).
            err.write("chario: getbasepos: Assertion `f >= 0' failed.\n")
            return 134
        cp.getch()
    timestamp("End random seeks")
    tsec = int(time.time() - t0)
    err.write("Elapsed time: %d:%02d:%02d\n"
              % (tsec // 3600, (tsec % 3600) // 60, tsec % 60))
    err.write("Seeks per second: %.2f\n"
              % ((nseek / tsec) if tsec else float("inf")))

    timestamp("50 random seeks")
    for _ in range(50):
        try:
            cp.setpos(int(drand48() * size))
        except AssertionError:
            err.write("chario: getbasepos: Assertion `f >= 0' failed.\n")
            return 134
        err.write(chr(cp.getch()))
    err.write("\n")
    return 0
