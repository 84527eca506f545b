"""Ways of driving the program under test, one module each.

A traffic file names its ``entry``; the module ``entries/<entry>.py``
holds ``Program(db, search, devices)``, which takes the database once
onto the cell's cards (``devices``, one entry a card; uploads included)
and answers one query a call: ``query(patterns,
phases)`` returns the hits as the client holds them, ``rows(hits)`` their
sorted (end, pattern id, edits) rows for the comparison, and the
attributes ``engine`` (the route the program chose) and ``uploads`` (the
program's count of database uploads)."""
