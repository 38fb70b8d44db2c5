"""CLI entry point: ``python -m repro_torch.obs report out.json out.jsonl``."""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .report import report_lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Readers for repro_torch observability artifacts.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report",
        help="summarize --trace JSON and/or --metrics JSONL files")
    rep.add_argument("paths", nargs="+",
                     help="Chrome trace JSON and/or metrics JSONL files "
                          "(auto-detected)")
    args = parser.parse_args(argv)
    for line in report_lines(args.paths):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
