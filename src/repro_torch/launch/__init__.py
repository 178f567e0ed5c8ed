"""Command-line entry points of the port: ``drill`` (the fault drills)."""
