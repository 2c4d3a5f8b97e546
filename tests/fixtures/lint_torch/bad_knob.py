"""Known-bad fixture: env-knob contract violations, through the port's
helpers. Never imported."""

import argparse
import os

from veles_tpu_torch.envknob import env_knob


def undocumented():
    # KNOB001: no catalog documents this knob (helper use is fine, the
    # name itself is the drift)
    return env_knob("VELES_FIXTURE_UNDOCUMENTED_KNOB", 1, parse=int)


def raw_read():
    # KNOB002: raw os.environ read outside envknob.py (and KNOB001)
    depth = os.environ.get("VELES_FIXTURE_RAW_KNOB", "2")
    shard = os.environ["VELES_FIXTURE_RAW_SUBSCRIPT"]   # KNOB002 too
    return float(depth), shard


def build_parser():
    parser = argparse.ArgumentParser()
    # KNOB003: knob frozen into an argparse default at build time
    parser.add_argument(
        "--workers",
        default=env_knob("VELES_FIXTURE_ARGPARSE_KNOB", 1, parse=int))
    return parser
