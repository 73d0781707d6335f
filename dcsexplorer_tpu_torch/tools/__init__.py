"""Command-line tools of the port: the explorer CLI (``explorer``)."""
