"""The Publisher unit (``veles_tpu/publishing/publisher.py``)."""

import io
import os
import platform
import time

from veles_tpu_torch.config import root
from veles_tpu_torch.publishing.backend import PublishingBackendRegistry
from veles_tpu_torch.units import Unit


class Publisher(Unit):
    """Gathers run info and renders it through configured backends.

    ``backends`` maps registry names to kwargs, e.g.::

        Publisher(wf, backends={
            "markdown": {"file": "report.md"},
            "pdf": {"file": "report.pdf"},
        })

    Typically linked from the decision so it fires once at the end
    (gate it with ``~decision.complete`` like the end point), or left
    unlinked and invoked manually via :meth:`run`.
    """

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("view_group", "SERVICE")
        super(Publisher, self).__init__(workflow, **kwargs)
        self.backends = dict(kwargs.get("backends", {}))
        self.include_plots = kwargs.get("include_plots", True)
        self.loader_unit = kwargs.get("loader_unit")
        self._backend_instances = {}

    def initialize(self, **kwargs):
        for name, backend_kwargs in self.backends.items():
            cls = PublishingBackendRegistry.backends.get(name)
            if cls is None:
                raise ValueError(
                    "unknown publishing backend %r (have %s)" %
                    (name, sorted(PublishingBackendRegistry.backends)))
            self._backend_instances[name] = cls(**(backend_kwargs or {}))
        if self.loader_unit is None:
            self.loader_unit = getattr(self.workflow, "loader", None)

    def run(self):
        if self.is_slave or root.common.disable.get("publishing", False):
            return
        info = self.gather_info()
        self.info("publishing the results through %s",
                  sorted(self._backend_instances) or "no backends")
        for name, backend in self._backend_instances.items():
            self.debug("rendering %s...", name)
            try:
                backend.render(info)
            except Exception as e:
                # a broken template must not lose the other reports (or
                # crash the workflow at the very end of training)
                self.warning("backend %s failed: %s", name, e)

    # -- info gathering ----------------------------------------------------

    def gather_info(self):
        """Everything knowable about the run, in one dict
        (``publisher.py:167-235``)."""
        workflow = self.workflow
        launcher = self.launcher
        info = {
            "name": workflow.name,
            "description": workflow.__doc__,
            "id": getattr(launcher, "id", None),
            "logid": getattr(launcher, "log_id", None),
            "python": "%s %s" % (platform.python_implementation(),
                                 platform.python_version()),
            "pid": os.getpid(),
            "workflow_graph": workflow.generate_graph(),
            "unit_run_times_by_name": self._run_times_by_unit(),
            "unit_run_times_by_class": self._run_times_by_class(),
            "results": workflow.gather_results(),
            "plots": self._gather_plots() if self.include_plots else {},
        }
        sio = io.StringIO()
        root.print_(file=sio)
        info["config_text"] = sio.getvalue()
        start = getattr(launcher, "start_time", None)
        mins, secs = divmod(time.time() - (start or time.time()), 60)
        hours, mins = divmod(mins, 60)
        days, hours = divmod(hours, 24)
        info.update({"days": int(days), "hours": int(hours),
                     "mins": int(mins), "secs": int(secs)})
        loader = self.loader_unit
        if loader is not None:
            info.update({
                "class_lengths": tuple(loader.class_lengths),
                "total_samples": sum(loader.class_lengths),
                "epochs": getattr(loader, "epoch_number", None),
                "normalization": getattr(loader, "normalization_type",
                                         "none"),
                "normalization_parameters": getattr(
                    loader, "normalization_parameters", {}),
            })
            mapping = getattr(loader, "labels_mapping", None)
            if mapping:
                info["labels"] = tuple(mapping)
        return info

    @staticmethod
    def _uniquify(name, seen):
        """Unit names are not unique; reports must not lose rows."""
        if name not in seen:
            seen[name] = 1
            return name
        seen[name] += 1
        return "%s#%d" % (name, seen[name])

    def _run_times_by_unit(self):
        seen, stats = {}, {}
        for unit in self.workflow.units:
            stats[self._uniquify(unit.name, seen)] = (unit.run_time,
                                                      unit.run_calls)
        return stats

    def _run_times_by_class(self):
        stats = {}
        for unit in self.workflow.units:
            key = type(unit).__name__
            secs, calls = stats.get(key, (0.0, 0))
            stats[key] = (secs + unit.run_time, calls + unit.run_calls)
        return stats

    def _image_formats(self):
        """Only render what the configured backends will read."""
        formats = set()
        for backend in self._backend_instances.values():
            formats.update(getattr(backend, "image_formats", ("png",)))
        return sorted(formats) or ["png"]

    def _gather_plots(self):
        """Render every plotter in the workflow (``publisher.py:237-254``)."""
        from veles_tpu_torch.plotter import Plotter
        plots = {}
        try:
            import matplotlib
            matplotlib.use("Agg", force=False)
            from matplotlib.figure import Figure
        except ImportError:
            self.warning("matplotlib unavailable; skipping plots")
            return plots
        formats = self._image_formats()
        seen = {}
        for unit in self.workflow.units_in_dependency_order:
            if not isinstance(unit, Plotter) or not unit.redraw_plot:
                continue
            figure = Figure()
            try:
                # a plotter that filled during the run already holds its
                # accumulated state — calling fill() again would append
                # a duplicate point (or, with clear_plot, erase the
                # curve). Only never-filled plotters need one fill() to
                # capture the current linked-attribute state.
                if not getattr(unit, "has_filled", False):
                    unit.fill()
                unit.redraw(figure)
            except Exception as e:
                self.warning("plotter %s failed to render: %s",
                             unit.name, e)
                continue
            rendered_formats = {}
            for fmt in formats:
                rendered = io.BytesIO()
                figure.savefig(rendered, format=fmt)
                rendered_formats[fmt] = rendered.getvalue()
            plots[self._uniquify(unit.name, seen)] = rendered_formats
        return plots
