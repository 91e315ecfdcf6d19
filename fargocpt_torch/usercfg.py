"""Per-user tool preferences for the CLI.

Analog of the reference's ``fargocpt config`` subcommand
(python_module/fargocpt/config.py): a tiny JSON store under the user's
config directory with show/get/set/remove verbs.  The reference's only
key is ``exe_path`` (it must locate a compiled binary); this rebuild is
a pure package, so the keys are launcher defaults instead.
"""

from __future__ import annotations

import json
import os

PROGRAM_NAME = "fargocpt_tpu"
CONFIG_VERSION = "1.0"
# reference python_module/fargocpt/config.py:8 ``information_types``
INFORMATION_TYPES = ["default_dtype", "default_outdir", "exe_path"]


def config_dir() -> str:
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, PROGRAM_NAME)


class UserConfig:
    """JSON-backed key/value store (reference config.py:67-150)."""

    def __init__(self, path: str | None = None):
        if path is None:
            os.makedirs(config_dir(), exist_ok=True)
            path = os.path.join(config_dir(), "config.json")
        self.config_file = path
        self.load()

    def load(self) -> None:
        if os.path.exists(self.config_file):
            with open(self.config_file) as fh:
                self.data = json.load(fh)
        else:
            self.data = {"config_version": CONFIG_VERSION}

    def save(self) -> None:
        with open(self.config_file, "w") as fh:
            json.dump(self.data, fh, indent=2)
            fh.write("\n")

    def set(self, key: str, value: str) -> None:
        self._check(key)
        self.data[key] = value
        self.save()

    def remove(self, key: str, value: str | None = None) -> None:
        self._check(key)
        # the reference's remove takes (key, value) and clears the key;
        # value is accepted for CLI parity and ignored likewise
        self.data.pop(key, None)
        self.save()

    def get(self, key: str, default=None):
        return self.data.get(key, default)

    def print(self) -> None:
        print(f"config file: {self.config_file}")
        for k, v in sorted(self.data.items()):
            print(f"  {k}: {v}")

    def print_value(self, key: str) -> None:
        print(self.data.get(key, ""))

    @staticmethod
    def _check(key: str) -> None:
        if key not in INFORMATION_TYPES:
            raise SystemExit(
                f"unknown config key {key!r} (choose from "
                f"{', '.join(INFORMATION_TYPES)})")


def main(args) -> int:
    """``fargocpt_tpu config [show|get KEY|set KEY VALUE|remove KEY]``
    (reference python_module/fargocpt/config.py:12-52)."""
    import argparse

    parser = argparse.ArgumentParser(prog="fargocpt_tpu config")
    sub = parser.add_subparsers(dest="verb")
    p_set = sub.add_parser("set", help="set a config item")
    p_set.add_argument("key", choices=INFORMATION_TYPES)
    p_set.add_argument("value")
    p_rm = sub.add_parser("remove", help="remove a config item")
    p_rm.add_argument("key", choices=INFORMATION_TYPES)
    p_rm.add_argument("value", nargs="?")
    sub.add_parser("show", help="show the config")
    p_get = sub.add_parser("get", help="print one config value")
    p_get.add_argument("key")
    opts = parser.parse_args(args)

    cfg = UserConfig()
    if opts.verb in (None, "show"):
        cfg.print()
    elif opts.verb == "get":
        cfg.print_value(opts.key)
    elif opts.verb == "set":
        cfg.set(opts.key, opts.value)
    elif opts.verb == "remove":
        cfg.remove(opts.key, opts.value)
    return 0
