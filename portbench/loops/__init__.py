"""One module per request loop a traffic mix names (its ``"loop"`` key).
Each defines ``Loop(session)`` with ``setup()``, which builds and warms up
what the cell's requests use, and ``request()``, which issues one request
and returns the particle-iterations it completed."""
