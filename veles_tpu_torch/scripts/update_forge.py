#!/usr/bin/env python3
"""Upload every model package under a directory to a forge server
(``veles_tpu/scripts/update_forge.py``).

A package is any directory holding ``manifest.json`` (the forge client's
contract); the scan does not descend into one. A package that fails (a
bad manifest, a refused upload) is reported on stderr and the sweep goes
on; the exit code is 1 when any failed or none was found.

Usage::

    python -m veles_tpu_torch.scripts.update_forge SCAN_DIR \
        --server http://forge-host:8080 [--token TOKEN] [--dry-run]
"""

import argparse
import json
import os
import sys


def find_packages(scan_root):
    """Yield directories under ``scan_root`` containing manifest.json."""
    for dirpath, dirnames, filenames in os.walk(scan_root):
        if "manifest.json" in filenames:
            yield dirpath
            # a package is a leaf: never descend into its subtrees
            # (plots/, data/ ride inside the upload tar)
            dirnames[:] = []


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scan_dir", help="tree to scan for packages")
    parser.add_argument("--server", default=os.getenv("FORGE_SERVER"),
                        help="forge base URL (or $FORGE_SERVER)")
    parser.add_argument("--token", default=os.getenv("FORGE_TOKEN"))
    parser.add_argument("--dry-run", action="store_true",
                        help="list what would upload, upload nothing")
    args = parser.parse_args(argv)
    if not args.server:
        parser.error("no forge server: pass --server or set "
                     "FORGE_SERVER")

    from veles_tpu_torch.forge.client import ForgeClient

    client = ForgeClient(args.server, token=args.token)
    found = failed = 0
    for package in find_packages(args.scan_dir):
        found += 1
        try:
            if args.dry_run:
                with open(os.path.join(package, "manifest.json")) as f:
                    name = json.load(f).get("name",
                                            os.path.basename(package))
                print("would upload %s (%s)" % (name, package))
                continue
            # client.upload parses the manifest itself (fail fast)
            reply = client.upload(package)
            print("uploaded %s version %s" % (reply["name"],
                                              reply["version"]))
        except (RuntimeError, OSError, ValueError, KeyError) as e:
            # one broken package (bad manifest, rejected upload) must
            # not abort the sweep
            failed += 1
            print("FAILED %s: %s" % (package, e), file=sys.stderr)
    if not found:
        print("no packages (manifest.json) under %s" % args.scan_dir,
              file=sys.stderr)
        return 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
