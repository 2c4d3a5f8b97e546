"""The PDF publishing backend (``veles_tpu/publishing/pdf_backend.py``).

matplotlib authors the multi-page PDF directly, so the report becomes: a text
summary page rendered with ``figure.text`` + one page per gathered
plot (PNG bytes re-imported). No external toolchain needed.
"""

import io

from veles_tpu_torch.publishing.backend import Backend


class PdfBackend(Backend):
    MAPPING = "pdf"
    image_formats = ("png",)

    def __init__(self, **kwargs):
        super(PdfBackend, self).__init__(**kwargs)
        self.file = kwargs.get("file")
        if not self.file:
            raise ValueError("PdfBackend needs a file=... path")

    def _summary_lines(self, info):
        lines = ["%s - training report" % info.get("name", "?"), ""]
        desc = (info.get("description") or "").strip()
        if desc:
            lines.extend(desc.split("\n") + [""])
        lines.append("run id: %s    python: %s    pid: %s" % (
            info.get("id"), info.get("python"), info.get("pid")))
        lines.append("elapsed: %dd %02d:%02d:%02d" % (
            info.get("days", 0), info.get("hours", 0),
            info.get("mins", 0), info.get("secs", 0)))
        lines.append("")
        results = info.get("results") or {}
        if results:
            lines.append("Results:")
            for key in sorted(results):
                lines.append("  %s: %s" % (key, results[key]))
        if "class_lengths" in info:
            lines.append("")
            lines.append("Data: class lengths %s, %s total samples, "
                         "%s epochs" % (info["class_lengths"],
                                        info.get("total_samples"),
                                        info.get("epochs")))
        stats = info.get("unit_run_times_by_name") or {}
        if stats:
            lines.append("")
            lines.append("Slowest units:")
            top = sorted(stats.items(), key=lambda kv: -kv[1][0])[:8]
            for name, (secs, calls) in top:
                lines.append("  %-30s %8.3f s in %d calls"
                             % (name, secs, calls))
        return lines

    def render(self, info):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.image as mpimg
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_pdf import PdfPages

        with PdfPages(self.file) as pdf:
            figure = plt.figure(figsize=(8.27, 11.69))  # A4 portrait
            text = "\n".join(self._summary_lines(info))
            figure.text(0.06, 0.97, text, va="top", family="monospace",
                        fontsize=9, wrap=True)
            pdf.savefig(figure)
            plt.close(figure)
            for name in sorted(info.get("plots") or {}):
                png = info["plots"][name].get("png")
                if png is None:
                    continue
                img = mpimg.imread(io.BytesIO(png), format="png")
                figure = plt.figure(figsize=(8.27, 6.2))
                axes = figure.add_subplot(111)
                axes.imshow(img)
                axes.axis("off")
                figure.suptitle(name)
                pdf.savefig(figure)
                plt.close(figure)
        self.info("wrote %s", self.file)
        return self.file
