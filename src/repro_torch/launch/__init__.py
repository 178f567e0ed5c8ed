"""Command-line entry points of the port: ``drill`` (the fault drills),
``train`` (the LM trainer) and ``serve`` (the serving engine)."""
