"""Forge client (``veles_tpu/forge/client.py``).

The API and the command line: ``python -m veles_tpu_torch.forge.client
list|details|fetch|upload|delete -s HOST:PORT [-n NAME] [-v VERSION]
[-d DIR] [--token TOKEN]``. A package is a directory holding a
``manifest.json`` that names the model and its version (and its
workflow and config files); it goes up as a tar of the directory, and a
fetch unpacks a version's tar into a directory, refusing members that
would land outside it.
"""

import argparse
import io
import json
import os
import tarfile
import urllib.error
import urllib.parse
import urllib.request

from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger


class ForgeClient(Logger):
    def __init__(self, base, token=None):
        super(ForgeClient, self).__init__()
        if "://" not in base:
            base = "http://" + base
        self.base = base.rstrip("/")
        self.token = token

    # -- helpers -----------------------------------------------------------

    @property
    def _service(self):
        return "%s/%s" % (self.base,
                          root.common.forge.get("service_name", "forge"))

    def _get_json(self, url):
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(self._http_error(e))

    @staticmethod
    def _http_error(e):
        try:
            return json.loads(e.read()).get("error", str(e))
        except Exception:
            return str(e)

    # -- operations --------------------------------------------------------

    def list(self):
        return self._get_json(self._service + "?query=list")

    def details(self, name):
        return self._get_json(
            "%s?query=details&name=%s" %
            (self._service, urllib.parse.quote(name)))

    def delete(self, name, version=None):
        url = "%s?query=delete&name=%s" % (self._service,
                                           urllib.parse.quote(name))
        if version:
            url += "&version=" + urllib.parse.quote(version)
        # state-changing → POST; token in a header, never the URL
        request = urllib.request.Request(
            url, data=b"", headers=self._auth_headers())
        try:
            with urllib.request.urlopen(request, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(self._http_error(e))

    def _auth_headers(self):
        return {"X-Forge-Token": self.token} if self.token else {}

    def upload(self, path):
        """Upload a package directory (must contain manifest.json)."""
        manifest_path = os.path.join(path, "manifest.json")
        with open(manifest_path) as f:
            manifest = json.load(f)  # fail fast on bad packages
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            for fn in sorted(os.listdir(path)):
                # recursive: packages may carry plots/, data/ subtrees
                tar.add(os.path.join(path, fn), arcname=fn)
        url = self.base + "/upload"
        headers = {"Content-Type": "application/x-tar"}
        headers.update(self._auth_headers())
        request = urllib.request.Request(
            url, data=buf.getvalue(), headers=headers)
        try:
            with urllib.request.urlopen(request, timeout=60) as resp:
                reply = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(self._http_error(e))
        self.info("uploaded %s version %s", reply["name"],
                  reply["version"])
        return reply

    def fetch(self, name, dest, version=None):
        """Download + unpack a model into ``dest``; returns version."""
        url = "%s/fetch?name=%s" % (self.base, urllib.parse.quote(name))
        if version:
            url += "&version=" + urllib.parse.quote(version)
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                got_version = resp.headers.get("X-Forge-Version")
                blob = resp.read()
        except urllib.error.HTTPError as e:
            raise RuntimeError(self._http_error(e))
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            for member in tar.getmembers():
                if member.name.startswith(("/", "..")) or \
                        ".." in member.name.split("/"):
                    raise ValueError("unsafe member: %s" % member.name)
            tar.extractall(dest, filter="data")
        self.info("fetched %s version %s into %s", name, got_version,
                  dest)
        return got_version


def main(argv=None):
    parser = argparse.ArgumentParser(description="veles_tpu_torch forge client")
    parser.add_argument("action",
                        choices=("list", "details", "fetch", "upload",
                                 "delete"))
    parser.add_argument("-s", "--server", required=True,
                        help="forge server, host:port or URL")
    parser.add_argument("-n", "--name", default=None)
    parser.add_argument("-v", "--version", default=None)
    parser.add_argument("-d", "--directory", default=".",
                        help="package dir (upload) / destination (fetch)")
    parser.add_argument("--token", default=None)
    args = parser.parse_args(argv)
    client = ForgeClient(args.server, token=args.token)
    if args.action == "list":
        print(json.dumps(client.list(), indent=2))
    elif args.action == "details":
        print(json.dumps(client.details(args.name), indent=2))
    elif args.action == "fetch":
        client.fetch(args.name, args.directory, version=args.version)
    elif args.action == "upload":
        client.upload(args.directory)
    elif args.action == "delete":
        client.delete(args.name, version=args.version)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
