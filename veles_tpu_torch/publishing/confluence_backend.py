"""The Confluence publishing backend
(``veles_tpu/publishing/confluence_backend.py``).

Posts the rendered report to a Confluence server through the storage
REST API (``/rest/api/content``). Gated: without a ``server`` URL the
backend refuses at construction; network failures surface as warnings
with the payload preserved on ``last_payload`` for inspection/retry.
The page body is the Markdown report wrapped in a preformatted
storage-format block — the reference's XML template amounted to the
same "typed-up report on a page" outcome.
"""

import base64
import json
import urllib.error
import urllib.request

from veles_tpu_torch.publishing.markdown_backend import MarkdownBackend


class ConfluenceBackend(MarkdownBackend):
    MAPPING = "confluence"
    requires_file = False    # publishes to the server, not a path
    image_formats = ()       # report text only

    def __init__(self, **kwargs):
        kwargs.setdefault("file", None)
        super(ConfluenceBackend, self).__init__(**kwargs)
        self.server = kwargs.get("server")
        if not self.server:
            raise ValueError(
                "ConfluenceBackend needs server=https://confluence... "
                "(this backend is gated on a reachable server)")
        self.space = kwargs.get("space")
        self.parent = kwargs.get("parent")
        self.username = kwargs.get("username")
        self.password = kwargs.get("password")
        self.last_payload = None

    def render(self, info):
        content = self.render_content(info)
        title = "%s run %s" % (info.get("name", "veles_tpu_torch"),
                               str(info.get("id", ""))[:8])
        storage = "<ac:structured-macro ac:name=\"code\">" \
                  "<ac:parameter ac:name=\"language\">text</ac:parameter>" \
                  "<ac:plain-text-body><![CDATA[%s]]></ac:plain-text-body>" \
                  "</ac:structured-macro>" % content.replace("]]>", "]] >")
        payload = {
            "type": "page",
            "title": title,  # JSON field, plain text — no XML escaping
            "space": {"key": self.space},
            "body": {"storage": {"value": storage,
                                 "representation": "storage"}},
        }
        if self.parent:
            payload["ancestors"] = [{"id": self.parent}]
        self.last_payload = payload
        url = self.server.rstrip("/") + "/rest/api/content"
        headers = {"Content-Type": "application/json"}
        if self.username:
            token = base64.b64encode(
                ("%s:%s" % (self.username, self.password or "")
                 ).encode()).decode()
            headers["Authorization"] = "Basic " + token
        request = urllib.request.Request(
            url, data=json.dumps(payload).encode(), headers=headers)
        try:
            with urllib.request.urlopen(request, timeout=30) as resp:
                reply = json.loads(resp.read())
            self.info("published to Confluence page id %s",
                      reply.get("id"))
            return reply
        except (urllib.error.URLError, OSError, ValueError) as e:
            self.warning("Confluence publish failed: %s "
                         "(payload kept on last_payload)", e)
            return None
