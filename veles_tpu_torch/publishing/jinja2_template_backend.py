"""The template-driven publishing backend
(``veles_tpu/publishing/jinja2_template_backend.py``)."""

import os

from veles_tpu_torch.publishing.backend import Backend

#: the default report template — Markdown text, jinja2 syntax
DEFAULT_TEMPLATE = """\
# {{ name }} — training report

{{ description or "" }}

| | |
|---|---|
| run id | {{ id }} |
| log id | {{ logid }} |
| python | {{ python }} |
| pid | {{ pid }} |
| elapsed | {{ "%dd %02d:%02d:%02d"|format(days, hours, mins, secs) }} |

## Results

{% if results %}| metric | value |
|---|---|
{% for key in results | sort %}| {{ key }} | {{ results[key] }} |
{% endfor %}{% else %}_no result providers in the workflow_
{% endif %}

## Data

{% if class_lengths is defined %}\
- class lengths (test/validation/train): {{ class_lengths }}
- total samples: {{ total_samples }}
- epochs served: {{ epochs }}
- normalization: {{ normalization }} {{ normalization_parameters }}
{% if labels is defined %}- labels: {{ labels }}
{% endif %}{% else %}_no loader attached_
{% endif %}

## Unit run times

| unit | seconds | calls |
|---|---|---|
{% for name in unit_run_times_by_name | sort %}\
| {{ name }} | {{ "%.3f"|format(unit_run_times_by_name[name][0]) }} \
| {{ unit_run_times_by_name[name][1] }} |
{% endfor %}

{% if plots %}## Plots

{% for plot_name in plots | sort %}![{{ plot_name }}]({{ plot_name }}.{{ image_format }})
{% endfor %}{% endif %}

## Configuration

```
{{ config_text }}```

## Workflow graph

```dot
{{ workflow_graph }}```
"""


class Jinja2TemplateBackend(Backend):
    """Renders ``info`` through a jinja2 template."""

    MAPPING = "jinja2"
    #: subclasses that publish elsewhere (Confluence) may opt out
    requires_file = True

    def __init__(self, **kwargs):
        super(Jinja2TemplateBackend, self).__init__(**kwargs)
        self.template_text = kwargs.get("template", DEFAULT_TEMPLATE)
        template_file = kwargs.get("template_file")
        if template_file:
            with open(template_file) as fin:
                self.template_text = fin.read()
        self.file = kwargs.get("file")
        if self.file is None and self.requires_file \
                and not self._alternate_output(kwargs):
            # a misspelled kwarg must not silently render to nowhere
            raise ValueError("%s needs a file=... path (got kwargs %s)"
                             % (type(self).__name__, sorted(kwargs)))
        self.image_format = kwargs.get("image_format", "png")
        self.content = None

    @property
    def image_formats(self):
        return (self.image_format,)

    @staticmethod
    def _alternate_output(kwargs):
        """Subclasses with other output channels override this."""
        return False

    def render_content(self, info):
        import jinja2
        env = jinja2.Environment(
            undefined=jinja2.ChainableUndefined,
            trim_blocks=False, autoescape=False)
        template = env.from_string(self.template_text)
        ctx = dict(info)
        ctx.setdefault("image_format", self.image_format)
        self.content = template.render(**ctx)
        return self.content

    def _write(self, path, content):
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        mode = "wb" if isinstance(content, bytes) else "w"
        with open(path, mode) as fout:
            fout.write(content)
        self.info("wrote %s", path)

    def _write_plots(self, info, directory):
        for name, formats in (info.get("plots") or {}).items():
            data = formats.get(self.image_format)
            if data is None:
                continue
            self._write(os.path.join(
                directory, "%s.%s" % (name, self.image_format)), data)

    def render(self, info):
        content = self.render_content(info)
        if hasattr(self.file, "write"):
            self.file.write(content)
        elif self.file:
            self._write(self.file, content)
            self._write_plots(info, os.path.dirname(
                os.path.abspath(self.file)))
        return content
