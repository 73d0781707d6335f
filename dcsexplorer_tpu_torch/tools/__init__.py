"""Command-line tools of the port: the explorer CLI (``explorer``) and the
encoder CLI and ROM compiler front end (``encoder_cli``)."""
