"""Forge server (``veles_tpu/forge/server.py``).

Stores versioned model packages under a storage directory
(``<storage>/<model>/<version>/*`` and a per-model ``meta.json``: the
version journal, newest last) and answers the JAX package's endpoints:
``GET /<service>?query=list|details``, ``GET /fetch?name=&version=``
(a tar of the version's files, its version in ``X-Forge-Version``),
``POST /upload`` (a tar holding ``manifest.json``), ``POST
/<service>?query=delete&name=[&version=]`` and the browse page at ``/``.
Uploads and deletes need the server's token in ``X-Forge-Token`` when it
holds one (a server without one binds loopback only, unless told
otherwise); a delete through GET is refused. Names and versions must
match ``[A-Za-z0-9][A-Za-z0-9._-]*``; an upload's tar members must be
regular files or directories with relative paths that never climb out
(no absolute path, no ``..``, no links). ``<service>`` is
``root.common.forge.service_name``.
"""

import io
import json
import os
import re
import shutil
import tarfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger

#: model and version names: they must stay inside the storage tree
_SAFE_NAME = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


def validate_name(name):
    if not name or not _SAFE_NAME.match(name) or ".." in name:
        raise ValueError("invalid name: %r" % (name,))
    return name


#: the repository's browse page: the models from the JSON API, a click
#: for a model's versions and manifest, /fetch links. Everything is
#: rendered through createElement/textContent: names and descriptions
#: come from uploaders and must never reach innerHTML.
_BROWSE_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch forge</title><style>
body { font-family: sans-serif; margin: 2em; background: #fafafa;
       max-width: 75em; }
table { border-collapse: collapse; width: 98em; max-width: 100em;
        background: #fff; }
td, th { border: 1px solid #ccc; padding: 0.4em 0.7em; text-align:
left; }
tr.model { cursor: pointer; } tr.model:hover { background: #eef3fa; }
#details { background: #fff; border: 1px solid #ccc; padding: 1em;
           margin-top: 1.5em; display: none; }
pre { background: #f4f4f4; padding: 0.6em; overflow-x: auto; }
a.dl { margin-right: 1em; }
.muted { color: #666; font-size: 0.9em; }
</style></head><body>
<h1>forge model repository</h1>
<p class="muted">versioned trained-model packages; click a row for
version history and the manifest. Uploads go through
<code>veles_tpu_torch.forge.client</code> (token-authenticated).</p>
<table id="models"><thead><tr><th>model</th><th>version</th>
<th>author</th><th>description</th><th>updated</th></tr></thead>
<tbody></tbody></table>
<div id="details"></div>
<script>
const service = "__SERVICE__";
function cell(tr, text) {
  const td = document.createElement("td");
  td.textContent = text == null ? "" : String(text);
  tr.appendChild(td);
  return td;
}
async function showDetails(name) {
  const resp = await fetch(service + "?query=details&name=" +
                           encodeURIComponent(name));
  const d = await resp.json();
  const box = document.getElementById("details");
  box.textContent = "";
  const h = document.createElement("h2");
  h.textContent = d.name;
  box.appendChild(h);
  const vt = document.createElement("table");
  const head = document.createElement("tr");
  for (const t of ["version", "author", "uploaded", "download"])
    { const th = document.createElement("th"); th.textContent = t;
      head.appendChild(th); }
  vt.appendChild(head);
  for (const v of (d.versions || []).slice().reverse()) {
    const tr = document.createElement("tr");
    cell(tr, v.version); cell(tr, v.author); cell(tr, v.uploaded);
    const td = document.createElement("td");
    const a = document.createElement("a");
    a.className = "dl";
    a.href = "/fetch?name=" + encodeURIComponent(d.name) +
             "&version=" + encodeURIComponent(v.version);
    a.textContent = "package.tar";
    td.appendChild(a); tr.appendChild(td);
    vt.appendChild(tr);
  }
  box.appendChild(vt);
  const mh = document.createElement("h3");
  mh.textContent = "manifest (latest)";
  box.appendChild(mh);
  const pre = document.createElement("pre");
  pre.textContent = JSON.stringify(d.manifest, null, 2);
  box.appendChild(pre);
  box.style.display = "block";
}
async function load() {
  const resp = await fetch(service + "?query=list");
  const models = await resp.json();
  const tbody = document.querySelector("#models tbody");
  tbody.textContent = "";
  if (!models.length) {
    const tr = document.createElement("tr");
    cell(tr, "(no models uploaded yet)");
    tbody.appendChild(tr);
    return;
  }
  for (const m of models) {
    const tr = document.createElement("tr");
    tr.className = "model";
    cell(tr, m.name); cell(tr, m.version); cell(tr, m.author);
    cell(tr, m.description); cell(tr, m.updated);
    tr.addEventListener("click", () => showDetails(m.name));
    tbody.appendChild(tr);
  }
}
load();
</script></body></html>"""


class ForgeServer(Logger):
    """Stores versioned packages under ``storage_dir``.

    Layout: ``<storage>/<model>/<version>/*`` + per-model
    ``meta.json`` (version journal, latest pointer).
    """

    def __init__(self, storage_dir, host="127.0.0.1", port=0, token=None,
                 allow_insecure=False):
        super(ForgeServer, self).__init__()
        self.storage_dir = os.path.abspath(storage_dir)
        os.makedirs(self.storage_dir, exist_ok=True)
        self.token = token
        if token is None:
            if host not in ("127.0.0.1", "localhost", "::1") \
                    and not allow_insecure:
                # tokenless means anyone who reaches the port can upload
                # or delete models — never expose that beyond loopback
                # without an explicit opt-in
                raise ValueError(
                    "refusing to bind %s without --token; pass "
                    "--allow-insecure (allow_insecure=True) to "
                    "override" % host)
            self.warning("no --token configured: uploads and deletes "
                         "are unauthenticated")
        self._lock = threading.RLock()
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.owner = self
        self._server.daemon_threads = True
        self.address = self._server.server_address
        self._thread = None

    @property
    def port(self):
        return self.address[1]

    # -- storage -----------------------------------------------------------

    def _meta_path(self, name):
        return os.path.join(self.storage_dir, name, "meta.json")

    def _read_meta(self, name):
        try:
            with open(self._meta_path(name)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _write_meta(self, name, meta):
        with open(self._meta_path(name), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)

    def list_models(self):
        with self._lock:
            models = []
            for name in sorted(os.listdir(self.storage_dir)):
                meta = self._read_meta(name)
                if meta is None:
                    continue
                latest = meta["versions"][-1]
                models.append({
                    "name": name,
                    "author": latest.get("author", ""),
                    "description": latest.get("short_description", ""),
                    "version": latest["version"],
                    "updated": latest["uploaded"],
                })
            return models

    def details(self, name):
        validate_name(name)
        with self._lock:
            meta = self._read_meta(name)
            if meta is None:
                raise KeyError("no such model: %s" % name)
            latest = meta["versions"][-1]
            manifest_path = os.path.join(
                self.storage_dir, name, latest["version"], "manifest.json")
            with open(manifest_path) as f:
                manifest = json.load(f)
            return {"name": name, "manifest": manifest,
                    "versions": meta["versions"]}

    def upload(self, blob, token=None):
        self._check_token(token)
        try:
            tar = tarfile.open(fileobj=io.BytesIO(blob))
        except tarfile.TarError as e:
            raise ValueError("not a tar package: %s" % e)
        with tar:
            names = tar.getnames()
            if "manifest.json" not in names:
                raise ValueError("package has no manifest.json")
            manifest = json.loads(
                tar.extractfile("manifest.json").read())
            name = validate_name(manifest.get("name"))
            version = validate_name(str(manifest.get("version", "1.0")))
            for member in tar.getmembers():
                # refuse path traversal / links before extraction
                if member.name.startswith(("/", "..")) or \
                        ".." in member.name.split("/") or \
                        not (member.isreg() or member.isdir()):
                    raise ValueError("unsafe member: %s" % member.name)
            with self._lock:
                meta = self._read_meta(name) or {"versions": []}
                if any(v["version"] == version
                       for v in meta["versions"]):
                    raise ValueError(
                        "%s version %s already exists" % (name, version))
                target = os.path.join(self.storage_dir, name, version)
                os.makedirs(target, exist_ok=True)
                tar.extractall(target, filter="data")
                meta["versions"].append({
                    "version": version,
                    "author": manifest.get("author", ""),
                    "short_description":
                        manifest.get("short_description", ""),
                    "uploaded": time.time(),
                })
                self._write_meta(name, meta)
        self.info("uploaded %s version %s", name, version)
        return {"name": name, "version": version}

    def fetch(self, name, version=None):
        validate_name(name)
        with self._lock:
            meta = self._read_meta(name)
            if meta is None:
                raise KeyError("no such model: %s" % name)
            if version is None or version == "latest":
                version = meta["versions"][-1]["version"]
            else:
                validate_name(version)
                if not any(v["version"] == version
                           for v in meta["versions"]):
                    raise KeyError("no version %s of %s" % (version, name))
            source = os.path.join(self.storage_dir, name, version)
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tar:
                for fn in sorted(os.listdir(source)):
                    tar.add(os.path.join(source, fn), arcname=fn)
            return buf.getvalue(), version

    def delete(self, name, token=None, version=None):
        self._check_token(token)
        validate_name(name)
        with self._lock:
            meta = self._read_meta(name)
            if meta is None:
                raise KeyError("no such model: %s" % name)
            if version is None:
                shutil.rmtree(os.path.join(self.storage_dir, name))
                self.info("deleted %s (all versions)", name)
                return {"deleted": name}
            validate_name(version)
            kept = [v for v in meta["versions"] if v["version"] != version]
            if len(kept) == len(meta["versions"]):
                raise KeyError("no version %s of %s" % (version, name))
            shutil.rmtree(os.path.join(self.storage_dir, name, version))
            if kept:
                meta["versions"] = kept
                self._write_meta(name, meta)
            else:
                shutil.rmtree(os.path.join(self.storage_dir, name))
            return {"deleted": name, "version": version}

    def _check_token(self, token):
        import hmac
        if self.token is not None and (
                not isinstance(token, str) or
                not hmac.compare_digest(token, self.token)):
            raise PermissionError("bad or missing token")

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="forge")
        self._thread.start()
        self.info("forge serving %s on %s:%d", self.storage_dir,
                  *self.address)
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        self.server.owner.debug("http: " + fmt, *args)

    def _reply(self, body, code=200, ctype="application/json"):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, e):
        code = {KeyError: 404, PermissionError: 403}.get(type(e), 400)
        message = str(e).strip("'") or type(e).__name__
        self._reply({"error": message}, code=code)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        owner = self.server.owner
        service = "/" + root.common.forge.get("service_name", "forge")
        try:
            if parsed.path in ("/", "/browse.html"):
                self._reply(
                    _BROWSE_PAGE.replace("__SERVICE__",
                                         service).encode(),
                    ctype="text/html; charset=utf-8")
            elif parsed.path == service:
                q = query.get("query")
                if q == "list":
                    self._reply(owner.list_models())
                elif q == "details":
                    self._reply(owner.details(query.get("name", "")))
                else:
                    raise ValueError("unknown query %r" % q)
            elif parsed.path == "/fetch":
                blob, version = owner.fetch(query.get("name", ""),
                                            query.get("version"))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-tar")
                self.send_header("X-Forge-Version", version)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            else:
                self._reply({"error": "not found"}, code=404)
        except Exception as e:
            self._error(e)

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        query = dict(urllib.parse.parse_qsl(parsed.query))
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = 0
        blob = self.rfile.read(length)
        # token rides a header, not the URL: query strings end up in
        # access logs, browser history and proxy caches
        token = self.headers.get("X-Forge-Token")
        owner = self.server.owner
        service = "/" + root.common.forge.get("service_name", "forge")
        try:
            if parsed.path == "/upload":
                self._reply(owner.upload(blob, token=token))
            elif parsed.path == service and \
                    query.get("query") == "delete":
                # state-changing: POST only (a GET delete is cacheable
                # and prefetchable)
                self._reply(owner.delete(query.get("name", ""),
                                         token=token,
                                         version=query.get("version")))
            else:
                self._reply({"error": "not found"}, code=404)
        except Exception as e:
            self._error(e)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="veles_tpu_torch forge server")
    parser.add_argument("-r", "--root", required=True,
                        help="storage directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-p", "--port", type=int, default=8080)
    parser.add_argument("--token", default=None,
                        help="shared secret required for upload/delete")
    parser.add_argument("--allow-insecure", action="store_true",
                        help="bind a non-loopback host WITHOUT a token "
                             "(anyone reaching the port can upload or "
                             "delete models)")
    args = parser.parse_args(argv)
    server = ForgeServer(args.root, host=args.host, port=args.port,
                         token=args.token,
                         allow_insecure=args.allow_insecure)
    server.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
