"""Command-line tools of the port: the explorer CLI (``explorer``), the
encoder CLI and ROM compiler front end (``encoder_cli``), the encoder's
audition and corpus tools (``encoder_tester``, ``encoder_corpus``), the
corpus validator (``test_all``) and the bench-asset generator
(``make_bench_assets``)."""
