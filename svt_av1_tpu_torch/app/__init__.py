"""Command-line front end of the port (SvtAv1EncApp): app/cli.py."""
