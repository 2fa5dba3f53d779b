"""CLI dispatcher: ``beer <group> <subcommand>`` (reference ``beer/cli``)."""

from __future__ import annotations

import argparse
import importlib
import sys

from beer_tpu.utils import runtime

GROUPS = {
    "dataset": ["create"],
    "features": ["extract"],
    "hmm": ["mkphones", "mkphoneloop", "align", "train", "decode",
            "accumulate", "update"],
    "shmm": ["train"],
}

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="beer",
        description="Bayesian speech modeling in JAX (beer_tpu)",
    )
    groups = parser.add_subparsers(dest="group", required=True)
    for group, cmds in GROUPS.items():
        gparser = groups.add_parser(group)
        subs = gparser.add_subparsers(dest="command", required=True)
        for cmd in cmds:
            mod = importlib.import_module(f"beer_tpu.cli.subcommands.{group}_{cmd}")
            sparser = subs.add_parser(cmd, help=mod.__doc__)
            sparser.add_argument(
                "--device", choices=["auto", "cpu", "gpu"], default="auto",
                help="compute device (auto: JAX's default platform; gpu "
                     "fails when JAX finds no GPU)",
            )
            mod.setup(sparser)
            sparser.set_defaults(_main=mod.main)
    args = parser.parse_args(argv)
    runtime.select_device(args.device)
    runtime.setup_compile_cache()
    return args._main(args) or 0


if __name__ == "__main__":
    sys.exit(main())
