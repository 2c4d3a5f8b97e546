"""Publishing: a training run's report through pluggable backends
(``veles_tpu/publishing/``).

The :class:`Publisher` unit gathers everything knowable
about the run — workflow identity, config text, loader statistics,
per-unit run times, metric results, rendered plots, the DOT graph —
into one ``info`` dict and hands it to each configured backend:
Markdown and any jinja2 template (jinja2 imported when one renders), a
multi-page PDF (matplotlib, likewise) and a Confluence page. The
package imports without jinja2 and matplotlib.
"""

from veles_tpu_torch.publishing.backend import (  # noqa: F401
    Backend, PublishingBackendRegistry)
from veles_tpu_torch.publishing.confluence_backend import \
    ConfluenceBackend  # noqa: F401
from veles_tpu_torch.publishing.jinja2_template_backend import \
    Jinja2TemplateBackend  # noqa: F401
from veles_tpu_torch.publishing.markdown_backend import \
    MarkdownBackend  # noqa: F401
from veles_tpu_torch.publishing.pdf_backend import PdfBackend  # noqa: F401
from veles_tpu_torch.publishing.publisher import Publisher  # noqa: F401
