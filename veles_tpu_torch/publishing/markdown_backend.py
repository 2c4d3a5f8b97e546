"""The Markdown publishing backend
(``veles_tpu/publishing/markdown_backend.py``)."""

from veles_tpu_torch.publishing.jinja2_template_backend import \
    Jinja2TemplateBackend

_HTML_WRAPPER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s</title>
<style>body { font-family: sans-serif; max-width: 60em; margin: 2em auto; }
table { border-collapse: collapse; } td, th { border: 1px solid #ccc;
padding: 0.3em 0.8em; } pre { background: #f5f5f5; padding: 1em;
overflow-x: auto; }</style></head><body>
%(body)s
</body></html>"""


class MarkdownBackend(Jinja2TemplateBackend):
    """Writes the report as Markdown; optional HTML rendering when the
    ``markdown`` package is installed."""

    MAPPING = "markdown"

    def __init__(self, **kwargs):
        super(MarkdownBackend, self).__init__(**kwargs)
        self.html = kwargs.get("html", False)
        self.html_file = kwargs.get("html_file")

    @staticmethod
    def _alternate_output(kwargs):
        # html_file-only configuration is a valid output target
        return bool(kwargs.get("html_file"))

    def render(self, info):
        content = super(MarkdownBackend, self).render(info)
        if self.html or self.html_file:
            try:
                import markdown
            except ImportError:
                self.warning("the 'markdown' package is not installed; "
                             "skipping the HTML rendering")
                return content
            body = markdown.markdown(content,
                                     extensions=["tables", "fenced_code"])
            html = _HTML_WRAPPER % {"title": info.get("name", "report"),
                                    "body": body}
            if self.html_file:
                self._write(self.html_file, html)
            return html
        return content
