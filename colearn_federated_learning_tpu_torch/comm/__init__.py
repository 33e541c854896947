"""Server-side folding of client updates (``aggregation.py``); the socket
planes of the JAX package's ``comm/`` are not ported yet (ROADMAP.md
Queue A item 8)."""
