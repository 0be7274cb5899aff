"""The examples' shared command line and printing."""
from __future__ import annotations

import argparse


class Out:
    """Prints lines and keeps them, so an example's `main` can return
    what it printed."""

    def __init__(self):
        self.lines = []

    def __call__(self, text: str = ""):
        print(text, flush=True)
        self.lines.extend(text.split("\n"))


def device_arg(doc: str, argv=None):
    """The `--device` of an example's command line (default: CUDA; it
    raises without a card unless given "cpu")."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; \"cpu\" to run "
                         "without a card)")
    return ap.parse_args(argv).device
